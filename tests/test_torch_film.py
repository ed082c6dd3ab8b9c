"""The port's transient film (time binning, the plain version of kernel
K3, develop) against ``mitransient_tpu/film/transient_film.py`` on the CPU,
where the JAX package splats with its XLA scatter (``_scatter_layout``).

Tolerance: rtol 1e-6.  Both sides add each film cell's events in lane
order, set a before set b.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitransient_tpu.film import transient_film as jf
from mitransient_tpu.scene.schema import FilmConfig as JFilmConfig
from mitransient_tpu_torch.film import transient_film as tf
from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts
from mitransient_tpu_torch.scene.schema import FilmConfig

torch.set_num_threads(1)

W, H, T, LANES, C = 6, 5, 40, 4, 3


def _cfgs(**kw):
    kw = dict(width=W, height=H, temporal_bins=T, start_opl=1.0,
              bin_width_opl=0.05, **kw)
    return JFilmConfig(**kw), FilmConfig(**kw)


def _events(seed):
    """Distances spanning below, inside and beyond the film's range, with
    a few exact bin edges, nan and inf."""
    rng = np.random.default_rng(seed)
    n = LANES * W * H
    dist = rng.uniform(0.8, 3.4, n).astype(np.float32)
    dist[:6] = [1.0, 1.05, 3.0, 2.9999, np.inf, np.nan]
    vals = rng.random((n, C)).astype(np.float32)
    active = rng.random(n) > 0.2
    return dist, vals, active


def test_time_bin_matches_jax():
    jcfg, tcfg = _cfgs()
    dist = _events(0)[0]
    jb, jok = jf.time_bin(jcfg, jnp.asarray(dist))
    tb, tok = tf.time_bin(tcfg, torch.from_numpy(dist))
    assert tb.dtype == torch.int32
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert tb.numpy()[4] == T and tb.numpy()[5] == T  # inf, nan -> overflow


@pytest.mark.parametrize("two_events", [False, True])
def test_splat_and_develop_match_jax(two_events):
    jcfg, tcfg = _cfgs()
    da, va, act = _events(1)
    db, vb, _ = _events(2)
    jst = jf.film_init(jcfg, C)
    tst = tf.film_init(tcfg, C)
    for step in range(2):  # accumulate over two bounces
        args = (da + step * 0.3, va, db if two_events else None,
                vb if two_events else None, act)
        jst = jf.splat_transient_pair(
            jst, jcfg, LANES, *(None if a is None else jnp.asarray(a)
                                for a in args))
        tst = tf.splat_transient_pair(
            tst, tcfg, LANES, *(None if a is None else torch.from_numpy(a)
                                for a in args))
    # the overflow bin (kept by both, dropped by develop)
    np.testing.assert_allclose(tst.transient[:, T, :].numpy(),
                               np.asarray(jst.transient)[:, T, :W * H],
                               rtol=1e-6)
    rng = np.random.default_rng(3)
    steady = rng.random((W * H, C)).astype(np.float32)
    weight = rng.integers(0, 3, W * H).astype(np.float32)
    jst = jst._replace(steady=jnp.asarray(steady),
                       steady_weight=jnp.asarray(weight))
    tst = tst._replace(steady=torch.from_numpy(steady),
                       steady_weight=torch.from_numpy(weight))
    (js, jt), (ts, tt) = jf.develop(jst, jcfg), tf.develop(tst, tcfg)
    assert tt.shape == (H, W, T, C) and ts.shape == (H, W, C)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    assert float(tt.sum()) > 0


def test_sample_validation_counters_match_jax():
    jcfg, tcfg = _cfgs(warn_negative=True, warn_invalid=True)
    da, va, act = _events(4)
    va[:10] = -1.0
    va[10:13, 1] = np.nan
    jst = jf.splat_transient_pair(jf.film_init(jcfg, C), jcfg, LANES,
                                  jnp.asarray(da), jnp.asarray(va), None, None,
                                  jnp.asarray(act))
    tst = tf.splat_transient_pair(tf.film_init(tcfg, C), tcfg, LANES,
                                  torch.from_numpy(da), torch.from_numpy(va),
                                  None, None, torch.from_numpy(act))
    assert float(tst.n_negative) == float(jst.n_negative) > 0
    assert float(tst.n_invalid) == float(jst.n_invalid) > 0


def test_plain_splat_is_in_place_and_on_cpu():
    """splat_accumulate on CPU tensors is the plain scatter, updates the
    film in place, drops bins outside the film and launches nothing."""
    film = torch.zeros((2, 4, 3))
    bins = torch.tensor([0, 3, 1, 7, -1, 3], dtype=torch.int32)  # 2 lanes x 3 px
    vals = torch.arange(12, dtype=torch.float32).reshape(6, 2) + 1.0
    reset_launch_counts()
    tf.splat_accumulate(film, bins, vals, None, None, spp=2)
    assert launch_counts() == {}
    want = torch.zeros((2, 4, 3))
    for lane, b in enumerate(bins.tolist()):
        if 0 <= b < 4:
            want[:, b, lane % 3] += vals[lane]
    assert torch.equal(film, want)
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        tf.splat_accumulate(film.to("meta"), bins.to("meta"), vals.to("meta"),
                            None, None, spp=2)


@pytest.mark.parametrize("sigma", [0.3, 2.0])
def test_gaussian_temporal_filter_matches_jax(sigma):
    """The gaussian temporal filter against the JAX
    package's ``_splat_gaussian`` (its XLA scatter on every backend), both
    event sets, windows reaching past both ends of the film (rtol 1e-5:
    the weights go through exp, whose ulps differ between the two)."""
    jcfg, tcfg = _cfgs()
    da, va, act = _events(5)
    db, vb, _ = _events(6)
    args = (da, va, db, vb, act)
    jst = jf.splat_transient_pair(jf.film_init(jcfg, C), jcfg, LANES,
                                  *map(jnp.asarray, args),
                                  temporal_filter="gaussian",
                                  gaussian_stddev=sigma)
    tst = tf.splat_transient_pair(tf.film_init(tcfg, C), tcfg, LANES,
                                  *map(torch.from_numpy, args),
                                  temporal_filter="gaussian",
                                  gaussian_stddev=sigma)
    want = np.asarray(jst.transient)[:, :T + 1, :W * H]
    # the nan and inf distances of _events put nan into overflow bins
    np.testing.assert_allclose(tst.transient.numpy(), want, rtol=1e-5,
                               atol=1e-6 * float(np.nanmax(np.abs(want))))
    assert float(tst.transient[:, :T].sum()) > 0
    assert float(tst.transient[:, T].nansum()) > 0  # the overflow bin


def test_splat_steady_and_develop_crop_match_jax():
    """The dense spp reduction of the steady image, the gaussian rfilter's
    shifted adds, a crop window's film (scan_pixels) and develop's
    shape_hw.  rtol 1e-5 (exp, and the order of the spp sums)."""
    jcfg, tcfg = _cfgs(crop_width=4, crop_height=3, crop_offset_x=1)
    h, w, spp = 3, 4, LANES
    rng = np.random.default_rng(8)
    value = rng.random((spp * h * w, C)).astype(np.float32)
    weight = rng.random(spp * h * w).astype(np.float32)
    jitter = rng.random((spp * h * w, 2)).astype(np.float32)
    jst = jf.film_init(jcfg, C, scan_pixels=h * w)
    tst = tf.film_init(tcfg, C, scan_pixels=h * w)
    assert tuple(tst.transient.shape) == (C, T + 1, h * w)
    jst = jf.splat_steady(jst, spp, jnp.asarray(value), jnp.asarray(weight))
    tst = tf.splat_steady(tst, spp, torch.from_numpy(value),
                          torch.from_numpy(weight))
    jst = jf.splat_steady_gaussian(jst, h, w, spp, jnp.asarray(value),
                                   jnp.asarray(weight), jnp.asarray(jitter),
                                   stddev=0.6)
    tst = tf.splat_steady_gaussian(tst, h, w, spp, torch.from_numpy(value),
                                   torch.from_numpy(weight),
                                   torch.from_numpy(jitter), stddev=0.6)
    for f in ("steady", "steady_weight"):
        np.testing.assert_allclose(getattr(tst, f).numpy(),
                                   np.asarray(getattr(jst, f)), rtol=1e-5)
    (js, jt), (ts, tt) = (jf.develop(jst, jcfg, shape_hw=(h, w)),
                          tf.develop(tst, tcfg, shape_hw=(h, w)))
    assert ts.shape == (h, w, C) and tt.shape == (h, w, T, C)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)


def test_splat_tile_fits_shared_memory():
    """K3 takes films whose single pixel's slab fits in a block's shared
    memory (227 KB: up to 3 x 19370 bins) and refuses a larger one."""
    for c, t in ((1, 2), (3, 301), (2, 1000), (3, 12001), (3, 19370),
                 (1, 58112)):
        tf.check_pixel_slab(c, t)
    for c, t in ((3, 19371), (3, 20000), (1, 58113)):
        with pytest.raises(ValueError, match="shared memory"):
            tf.check_pixel_slab(c, t)
