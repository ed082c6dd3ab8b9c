"""The port's host modules against the JAX package: ``io_exr`` (the four
cases of tests/test_io.py on the port), ``vis`` (each output equal to the
JAX package's ``vis`` on the same arrays, torch tensors accepted),
``log``, ``version``, and the small ``core/math.py`` and ``core/warp.py``
functions (within 1e-6 relative, atol 1e-6: XLA:CPU's FMA and its float32
cos / sin, which the port takes through float64)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitransient_tpu as mitr
import mitransient_tpu_torch as mt
from mitransient_tpu import vis as jvis
from mitransient_tpu.core import math as jmath
from mitransient_tpu.core import warp as jwarp
from mitransient_tpu_torch import vis as tvis
from mitransient_tpu_torch.core import math as tmath
from mitransient_tpu_torch.core import warp as twarp
from mitransient_tpu_torch.io_exr import read_exr, write_exr


def test_exr_roundtrip_float(tmp_path):
    img = np.random.RandomState(0).rand(13, 7, 3).astype(np.float32) * 20.0
    p = str(tmp_path / "t.exr")
    write_exr(p, img)
    back, names = read_exr(p)
    assert names == ["B", "G", "R"]  # alphabetical channel order
    np.testing.assert_array_equal(back[..., 2], img[..., 0])
    np.testing.assert_array_equal(back[..., 1], img[..., 1])
    np.testing.assert_array_equal(back[..., 0], img[..., 2])


def test_exr_roundtrip_half_and_mono(tmp_path):
    img = np.random.RandomState(1).rand(5, 9).astype(np.float32)
    p = str(tmp_path / "m.exr")
    write_exr(p, img, half=True)
    back, names = read_exr(p)
    assert names == ["Y"]
    np.testing.assert_allclose(back[..., 0], img, rtol=1e-3)


def test_exr_header_is_standard(tmp_path):
    p = str(tmp_path / "h.exr")
    write_exr(p, np.zeros((2, 2, 4), np.float32))
    buf = open(p, "rb").read()
    assert buf[:4] == bytes([0x76, 0x2F, 0x31, 0x01])
    for attr in (b"channels", b"compression", b"dataWindow",
                 b"displayWindow", b"lineOrder", b"pixelAspectRatio"):
        assert attr in buf


def test_save_frames_exr(tmp_path):
    """tests/test_io.py's frame export, given a torch tensor; the files are
    byte for byte the JAX package's."""
    tr = np.random.RandomState(2).rand(4, 6, 3, 1).astype(np.float32)
    tvis.save_frames(torch.from_numpy(tr), str(tmp_path / "t"), fmt="exr")
    jvis.save_frames(tr, str(tmp_path / "j"), fmt="exr")
    files = sorted((tmp_path / "t").iterdir())
    assert [f.name for f in files] == [
        "frame_0000.exr", "frame_0001.exr", "frame_0002.exr"]
    back, _ = read_exr(str(files[1]))
    np.testing.assert_array_equal(back[..., 0], tr[:, :, 1, 0])
    for f in files:
        assert f.read_bytes() == (tmp_path / "j" / f.name).read_bytes()


def test_vis_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    tr = rng.random((6, 5, 20, 3)).astype(np.float32)
    grad = rng.normal(size=(6, 5, 20, 3)).astype(np.float32)
    for name, args in (("tonemap_transient", (tr,)),
                       ("tonemap_grad_transient", (grad,)),
                       ("rainbow_visualization", (tr,)),
                       ("rainbow_visualization", (tr, 7))):
        want = getattr(jvis, name)(*args)
        got = getattr(tvis, name)(*(torch.from_numpy(a)
                                    if isinstance(a, np.ndarray) else a
                                    for a in args))
        np.testing.assert_array_equal(got, want, err_msg=name)
    tvis.save_frames(tr, str(tmp_path / "t"), fmt="npy")
    jvis.save_frames(tr, str(tmp_path / "j"), fmt="npy")
    for f in sorted((tmp_path / "t").iterdir()):
        np.testing.assert_array_equal(np.load(f),
                                      np.load(tmp_path / "j" / f.name))
    with pytest.raises(ValueError, match="format"):
        tvis.save_frames(tr, str(tmp_path), fmt="png")


def test_exports_and_log():
    """The JAX package's ``__init__`` exports (vis, LogLevel, log,
    set_log_level, __version__) on the port, and the leveled logger."""
    for name in ("vis", "LogLevel", "log", "set_log_level", "__version__"):
        assert hasattr(mt, name) and hasattr(mitr, name), name
    assert mt.__version__ == mitr.__version__
    assert ({m.name: int(m) for m in mt.LogLevel}
            == {m.name: int(m) for m in mitr.LogLevel})
    # the package's ``log`` is the function; the module is imported by name
    tlog = importlib.import_module("mitransient_tpu_torch.log")
    old = tlog.log_level()
    try:
        mt.set_log_level(mt.LogLevel.Error)
        assert tlog.log_level() == int(mt.LogLevel.Error)
        mt.set_log_level(mt.LogLevel.Trace)
        assert tlog.log_level() == 1
        for lvl in mt.LogLevel:
            mt.log(lvl, "level %s", lvl.name)
        tlog.warn("w")
        tlog.info("i")
        tlog.debug("d")
    finally:
        mt.set_log_level(old)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_math_and_warps_match_jax():
    rng = np.random.default_rng(6)
    a, b = (rng.normal(size=(512, 3)).astype(np.float32) for _ in range(2))
    t = rng.random((512, 1)).astype(np.float32)
    m = rng.normal(size=(512, 3, 3)).astype(np.float32)
    w = rng.normal(size=(512, 3)).astype(np.float32)
    w[:4] = [[0, 0, 0], [1e-7, 0, 0], [0, 2e-6, -1e-6], [0, 0, 3.0]]
    T = torch.from_numpy
    _close(tmath.lerp(T(a), T(b), T(t)), jmath.lerp(a, b, t))
    _close(tmath.squared_norm(T(a)), jmath.squared_norm(jnp.asarray(a)))
    _close(tmath.matvec3(T(m), T(a)), jmath.matvec3(jnp.asarray(m),
                                                    jnp.asarray(a)))
    R = tmath.rodrigues(T(w))
    _close(R, jmath.rodrigues(jnp.asarray(w)))
    assert torch.equal(R[0], torch.eye(3))
    # rotations: orthonormal
    eye = torch.eye(3).expand(512, 3, 3)
    np.testing.assert_allclose((R @ R.transpose(1, 2)).numpy(), eye.numpy(),
                               atol=1e-5)
    u = rng.random((512, 2)).astype(np.float32)
    for name in ("square_to_uniform_sphere", "square_to_uniform_hemisphere"):
        got = getattr(twarp, name)(T(u))
        _close(got, getattr(jwarp, name)(jnp.asarray(u)))
        np.testing.assert_allclose(tmath.norm(got).numpy(), 1.0, atol=1e-6)
    assert twarp.square_to_uniform_hemisphere(T(u))[:, 2].min() >= 0.0
    assert twarp.square_to_uniform_sphere_pdf() == pytest.approx(
        float(jwarp.square_to_uniform_sphere_pdf()), rel=1e-7)
