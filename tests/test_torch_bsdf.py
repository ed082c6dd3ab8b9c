"""The port's diffuse lobe (``eval_pdf``, ``sample``) and its warps against
``mitransient_tpu/bsdf/api.py`` on the CPU.

Tolerance: rtol 1e-6, with atol 1e-6 for values near zero (direction
components come out of sin/cos, which XLA and PyTorch round by different
ulps).  The hemisphere's z = sqrt(1 - x^2 - y^2), and the pdf z / pi, turn
an ulp of x^2 near the horizon into an error of about 1e-7 / z, so they
are held to the same tolerance on their squares.  Masks, deltas and kinds
exact.
"""
import jax.numpy as jnp
import numpy as np
import torch

import mitransient_tpu as mitr
import mitransient_tpu_torch as mt
from mitransient_tpu.bsdf import api as jb
from mitransient_tpu.core import warp as jw
from mitransient_tpu_torch.bsdf import api as tb
from mitransient_tpu_torch.core import warp as tw

torch.set_num_threads(1)

N = 20000


def _close(got, want, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6, err_msg=name)


def _close_z(got, want, name):
    """z = sqrt(1 - x^2 - y^2): compare z^2, and the signs, exactly as
    sensitive as x and y."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.sign(got), np.sign(want), err_msg=name)
    _close(got * got, want * want, name)


def _close_hemi(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    _close(got[:, :2], want[:, :2], name + ".xy")
    _close_z(got[:, 2], want[:, 2], name + ".z")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, 3, N).astype(np.int32)  # -1 = no hit
    wi = rng.normal(size=(N, 3))
    wo = rng.normal(size=(N, 3))
    wi = (wi / np.linalg.norm(wi, axis=1, keepdims=True)).astype(np.float32)
    wo = (wo / np.linalg.norm(wo, axis=1, keepdims=True)).astype(np.float32)
    u1 = rng.random(N).astype(np.float32)
    u2 = rng.random((N, 2)).astype(np.float32)
    u2[:4] = [[0.5, 0.5], [0.5, 0.9], [0.1, 0.5], [0.0, 0.0]]  # disk edge cases
    active = rng.random(N) > 0.1
    return ids, wi, wo, u1, u2, active


def _lanes(ids):
    jbp = mitr.load_dict(mitr.cornell_box()).data.bsdf
    tbp = mt.load_dict(mt.cornell_box()).data.bsdf
    return (jb.gather_lane_bsdf(jbp, jnp.asarray(ids)),
            tb.gather_lane_bsdf(tbp, torch.from_numpy(ids)))


def test_gather_and_is_smooth_match_jax():
    ids = _inputs()[0]
    jl, tl = _lanes(ids)
    np.testing.assert_array_equal(tl.kind.numpy(), np.asarray(jl.kind))
    np.testing.assert_array_equal(tl.reflectance.numpy(),
                                  np.asarray(jl.reflectance))
    np.testing.assert_array_equal(tb.is_smooth(tl).numpy(),
                                  np.asarray(jb.is_smooth(jl)))


def test_eval_pdf_matches_jax():
    ids, wi, wo, _, _, active = _inputs(1)
    jl, tl = _lanes(ids)
    jf, jpdf = jb.eval_pdf(jl, jnp.asarray(wi), jnp.asarray(wo),
                           jnp.asarray(active))
    f, pdf = tb.eval_pdf(tl, torch.from_numpy(wi), torch.from_numpy(wo),
                         torch.from_numpy(active))
    _close(f, jf, "f")
    _close(pdf, jpdf, "pdf")
    np.testing.assert_array_equal(pdf.numpy() > 0, np.asarray(jpdf) > 0)
    assert (pdf.numpy() > 0).mean() > 0.1


def test_sample_matches_jax():
    ids, wi, _, u1, u2, active = _inputs(2)
    jl, tl = _lanes(ids)
    js = jb.sample(jl, jnp.asarray(wi), jnp.asarray(u1), jnp.asarray(u2),
                   jnp.asarray(active))
    ts = tb.sample(tl, torch.from_numpy(wi), torch.from_numpy(u1),
                   torch.from_numpy(u2), torch.from_numpy(active))
    _close_hemi(ts.wo, js.wo, "wo")
    _close_z(ts.pdf.numpy() * np.pi, np.asarray(js.pdf) * np.pi, "pdf")
    for f in ("eta", "weight"):
        _close(getattr(ts, f), getattr(js, f), f)
    np.testing.assert_array_equal(ts.delta.numpy(), np.asarray(js.delta))
    np.testing.assert_array_equal(ts.pdf.numpy() > 0, np.asarray(js.pdf) > 0)
    assert (ts.pdf.numpy() > 0).mean() > 0.3


def test_warps_match_jax():
    u2 = _inputs(3)[4]
    _close(tw.square_to_uniform_disk_concentric(torch.from_numpy(u2)),
           jw.square_to_uniform_disk_concentric(jnp.asarray(u2)), "disk")
    hemi = tw.square_to_cosine_hemisphere(torch.from_numpy(u2))
    _close_hemi(hemi, jw.square_to_cosine_hemisphere(jnp.asarray(u2)), "hemi")
    _close(tw.square_to_cosine_hemisphere_pdf(hemi),
           jw.square_to_cosine_hemisphere_pdf(jnp.asarray(hemi.numpy())),
           "pdf")
    np.testing.assert_array_equal(hemi[0].numpy(), [0.0, 0.0, 1.0])
