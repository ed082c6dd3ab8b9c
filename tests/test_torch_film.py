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


def test_gaussian_temporal_filter_is_refused():
    _, tcfg = _cfgs()
    da, va, act = _events(5)
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        tf.splat_transient_pair(tf.film_init(tcfg, C), tcfg, LANES,
                                torch.from_numpy(da), torch.from_numpy(va),
                                None, None, torch.from_numpy(act),
                                temporal_filter="gaussian")
