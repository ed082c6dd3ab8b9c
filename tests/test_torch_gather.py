"""The port's differentiable row gather (``ops/gather.py``: ``gather_rows``
and the plain version of kernel K8, ``reduce_rows``) and the gaussian
temporal filter's splat (``gaussian_taps`` through K3's ``SplatEvents``)
on the CPU.

* ``gather_rows``' forward is ``index_select`` bit for bit.
* Its backward is bit-equal to a numpy emulator of K8's order (a warp's
  ``__shfl_down_sync`` tree, lane by lane; the tiles' sum and the runs'
  levels level by level), and in regime (b) to a second emulator of the
  way ``csrc/gather.cu`` reaches it (runs found by comparing neighbours,
  chunks of 1024 lanes from a run's start, a long run's chunk sums level
  by level).
* Against the JAX package's ``jax.vjp`` of ``table_lookup`` on the CPU
  (an XLA scatter that adds one lane at a time): rtol 1e-6 beyond the
  JAX side's own measured distance from a float64 sum.  K8's tree is
  held to rtol 1e-6 of the float64 sum on its own.
* The gaussian splat against the JAX package's ``_splat_gaussian`` at
  ``test_torch_film.py``'s rtol 1e-5 (the weights go through exp, whose
  ulps differ between the two), and its autograd rules bit-equal to
  autograd through the plain ``index_add_`` of the taps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad as fwAD

from mitransient_tpu.film import transient_film as jf
from mitransient_tpu.ops.gather import table_lookup
from mitransient_tpu.scene.schema import FilmConfig as JFilmConfig
from mitransient_tpu_torch.film import transient_film as tf
from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts
from mitransient_tpu_torch.ops import gather as G
from mitransient_tpu_torch.scene.schema import FilmConfig

torch.set_num_threads(1)

TILE = G.TILE
ROWS = (1, 3, 27, 128, 129, 4096)
LANES = (1, TILE - 1, TILE, 3 * TILE + 5)
CHANNELS = (1, 3, 4, 12)


def _shfl_tree(x):
    """Lane 0 of a warp's ``x += __shfl_down_sync(x, o)`` for o = 16, 8,
    4, 2, 1 over the last axis (32 lanes); a lane whose source lies past
    lane 31 reads its own value."""
    x = x.astype(np.float32)
    for o in (16, 8, 4, 2, 1):
        x = x + np.concatenate([x[..., o:], x[..., 32 - o:]], axis=-1)
    return x[..., 0]


def _emulate_tiles(g, idx, rows):
    """K8 regime (a): tile_partials_kernel, then sum_rows' levels."""
    n, C = g.shape
    tiles = -(-n // TILE)
    gp = np.zeros((tiles * TILE, C), np.float32)
    gp[:n] = g
    ip = np.full(tiles * TILE, -1)
    ip[:n] = idx
    gp, ip = gp.reshape(tiles, 32, 32, C), ip.reshape(tiles, 32, 32)
    part = np.zeros((tiles, rows, C), np.float32)
    for r in range(rows):
        mine = ip == r
        v = np.where(mine[..., None], gp, np.float32(0.0))
        group = _shfl_tree(np.moveaxis(v, 2, -1))  # (tiles, warps, C)
        tile = _shfl_tree(np.moveaxis(group, 1, -1))  # (tiles, C)
        part[:, r] = np.where(mine.any(axis=(1, 2))[:, None], tile,
                              np.float32(0.0))
    x = part.reshape(tiles, rows * C)
    while x.shape[0] > 1:
        m, h = x.shape[0], x.shape[0] // 2
        y = x[:h] + x[h:2 * h]
        x = np.concatenate([y, x[2 * h:]]) if m % 2 else y
    return x[0].reshape(rows, C)


def _emulate_runs(g, idx, rows):
    """K8 regime (b): a stable sort, then each run's levels of tree32,
    level by level (run_tree_kernel walks them depth first)."""
    n, C = g.shape
    perm = np.argsort(idx, kind="stable")
    start = np.searchsorted(idx[perm], np.arange(rows + 1), side="left")
    levels, cap = 1, 32
    while cap < n:
        levels, cap = levels + 1, cap * 32
    src = g
    for level in range(levels):
        glen = (np.diff(start) + 31) // 32
        gstart = np.concatenate([[0], np.cumsum(glen)])
        gid = np.arange(gstart[-1])
        r = np.searchsorted(gstart, gid, side="right") - 1
        i = (start[r] + (gid - gstart[r]) * 32)[:, None] + np.arange(32)
        valid = i < start[r + 1][:, None]
        at = np.where(valid, i, 0)
        if level == 0:
            at = perm[at]
        vals = np.where(valid[..., None], src[at], np.float32(0.0))
        sums = _shfl_tree(np.moveaxis(vals, 1, -1))  # (groups, C)
        if level == levels - 1:
            out = np.zeros((rows, C), np.float32)
            out[r] = sums
            return out
        src, start = sums, gstart


def _emulate_runs_chunked(g, idx, rows):
    """K8 regime (b) as run_chunks_kernel and run_levels_kernel reach it:
    the runs found by comparing sorted neighbours; a run of at most 32 by
    one thread's tree; a longer run cut into chunks of 1024 from its start,
    each by two levels of tree32; a long run's chunk sums by tree32 level
    by level; + 0 where a run ends as one value before the last level."""
    n, C = g.shape
    perm = np.argsort(idx, kind="stable")
    sidx, x = idx[perm], g[perm]
    levels = G.run_levels(n)
    starts = np.flatnonzero(np.r_[True, sidx[1:] != sidx[:-1]])
    out = np.zeros((rows, C), np.float32)
    for s, e in zip(starts, np.r_[starts[1:], n]):
        length = e - s
        if length <= 32:
            v = np.zeros((32, C), np.float32)
            v[:length] = x[s:e]
            val, own = _shfl_tree(v.T), 1
        else:
            m = -(-length // TILE)
            buf = np.zeros((m * TILE, C), np.float32)
            buf[:length] = x[s:e]
            group = _shfl_tree(np.moveaxis(buf.reshape(m, 32, 32, C), 2, -1))
            val, own = _shfl_tree(np.moveaxis(group, 1, -1)), 2
            while val.shape[0] > 1:
                k = -(-val.shape[0] // 32)
                pad = np.zeros((k * 32, C), np.float32)
                pad[:val.shape[0]] = val
                val = _shfl_tree(np.moveaxis(pad.reshape(k, 32, C), 1, -1))
                own += 1
            val = val[0]
        out[sidx[s]] = val + np.float32(0.0) if levels > own else val
    return out


def emulate_k8(g, idx, rows):
    if rows <= G.TILE_MAX_ROWS:
        return _emulate_tiles(g, idx, rows)
    return _emulate_runs(g, idx, rows)


def _case(rows, lanes, channels, one_row=False):
    rng = np.random.default_rng(rows * 100003 + lanes * 17 + channels)
    g = rng.random((lanes, channels), dtype=np.float32)
    idx = (np.full(lanes, rows // 2) if one_row
           else rng.integers(0, rows, lanes)).astype(np.int32)
    table = rng.normal(size=(rows, channels)).astype(np.float32)
    return table, idx, g


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _grad(table, idx, g):
    t = torch.from_numpy(table).requires_grad_()
    out = G.gather_rows(t, torch.from_numpy(idx))
    (grad,) = torch.autograd.grad(out, t, torch.from_numpy(g))
    return out, grad


@pytest.mark.parametrize("channels", CHANNELS)
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("rows", ROWS)
def test_gather_rows_backward_is_k8s_order(rows, lanes, channels):
    table, idx, g = _case(rows, lanes, channels)
    out, grad = _grad(table, idx, g)
    # forward: index_select bit for bit
    want = torch.from_numpy(table).index_select(0, torch.from_numpy(idx))
    np.testing.assert_array_equal(_bits(out.detach().numpy()),
                                  _bits(want.numpy()))
    # backward: the emulator of K8's order bit for bit
    grad = grad.numpy()
    np.testing.assert_array_equal(_bits(grad),
                                  _bits(emulate_k8(g, idx, rows)))
    # a float64 sum, rtol 1e-6
    exact = np.zeros((rows, channels))
    np.add.at(exact, idx, g.astype(np.float64))
    np.testing.assert_allclose(grad, exact, rtol=1e-6, atol=0)
    # the JAX package's vjp of table_lookup: rtol 1e-6 beyond its own
    # one-lane-at-a-time sum's distance from the float64 sum
    _, vjp = jax.vjp(lambda t: table_lookup(t, jnp.asarray(idx)),
                     jnp.asarray(table))
    (g_jax,) = vjp(jnp.asarray(g))
    g_jax = np.asarray(g_jax)
    own = np.abs(g_jax - exact)
    assert np.all(np.abs(grad - g_jax) <= 1e-6 * np.abs(g_jax) + own)


@pytest.mark.parametrize("rows", [27, 4096])
def test_gather_rows_backward_all_lanes_on_one_row(rows):
    table, idx, g = _case(rows, 3 * TILE + 5, 3, one_row=True)
    _, grad = _grad(table, idx, g)
    np.testing.assert_array_equal(_bits(grad.numpy()),
                                  _bits(emulate_k8(g, idx, rows)))
    assert not grad.numpy()[np.arange(rows) != rows // 2].any()
    np.testing.assert_allclose(grad.numpy()[rows // 2],
                               g.astype(np.float64).sum(0), rtol=1e-6)


def _hold_long_runs(g, idx, rows):
    """reduce_rows of ``g`` onto ``rows`` rows (regime (b)) bit-equal to
    both emulators, within rtol 1e-6 of a float64 sum, and within rtol
    1e-6 of the JAX package's vjp beyond that sum's own distance."""
    table = np.zeros((rows, g.shape[1]), np.float32)
    _, grad = _grad(table, idx, g)
    grad = grad.numpy()
    np.testing.assert_array_equal(_bits(grad),
                                  _bits(emulate_k8(g, idx, rows)))
    np.testing.assert_array_equal(_bits(grad),
                                  _bits(_emulate_runs_chunked(g, idx, rows)))
    exact = np.zeros((rows, g.shape[1]))
    np.add.at(exact, idx, g.astype(np.float64))
    np.testing.assert_allclose(grad, exact, rtol=1e-6, atol=0)
    _, vjp = jax.vjp(lambda t: table_lookup(t, jnp.asarray(idx)),
                     jnp.asarray(table))
    g_jax = np.asarray(vjp(jnp.asarray(g))[0])
    own = np.abs(g_jax - exact)
    assert np.all(np.abs(grad - g_jax) <= 1e-6 * np.abs(g_jax) + own)


@pytest.mark.parametrize("channels", [1, 3, 4, 12])
def test_reduce_rows_long_run_in_regime_b(channels):
    """40,000 lanes (four levels) onto 4,096 rows, 3/4 of them on one row
    in random lane order, the rest uniform: the run of ~30,000 lanes is
    cut into 30 chunks of 1024 whose sums take two more levels."""
    rng = np.random.default_rng(40000 + channels)
    n, rows = 40000, 4096
    g = rng.random((n, channels), dtype=np.float32)
    idx = rng.integers(0, rows, n).astype(np.int32)
    idx[rng.random(n) < 0.75] = 17
    assert G.run_levels(n) == 4 and (idx == 17).sum() > 29000
    _hold_long_runs(g, idx, rows)


@pytest.mark.parametrize("length", [1023, 1024, 1025, 32 * 1024 + 1])
def test_reduce_rows_runs_across_chunks(length):
    """A run whose length straddles the 1024-lane chunks (one chunk just
    short, exactly full, one lane over; 32 chunks and one lane, so that
    the chunk sums take a level of their own and a second one), beside
    runs of a few lanes; cotangents in [0, 1) with -0 among them (a run
    of -0 only must end as +0, as the plain version's trees give)."""
    rng = np.random.default_rng(length)
    rows, others = 4096, 3000
    n = length + others
    g = rng.random((n, 3), dtype=np.float32)
    g[rng.random(n) < 0.05] = -0.0
    idx = np.concatenate([np.full(length, 1000),
                          rng.integers(0, rows, others)]).astype(np.int32)
    idx[length:][idx[length:] == 1000] = 1001
    order = rng.permutation(n)
    g, idx = g[order], idx[order]
    _hold_long_runs(g, idx, rows)


@pytest.mark.parametrize("runs, want", [((32,), 0x80000000),
                                         ((32, 1024, 2048), 0)])
def test_reduce_rows_runs_of_negative_zero(runs, want):
    """Runs of -0 only (onto 200 rows, regime (b)): a run that ends as one
    value at the last level keeps -0; one that ends before it takes the
    further levels' + 0 and gives +0, in both emulators and the plain
    version alike."""
    idx = np.concatenate([np.full(k, 5 + i) for i, k in enumerate(runs)])
    idx = idx.astype(np.int32)
    g = np.full((idx.size, 2), -0.0, np.float32)
    table = np.zeros((200, 2), np.float32)
    _, grad = _grad(table, idx, g)
    bits = _bits(grad.numpy())
    for emulate in (emulate_k8, _emulate_runs_chunked):
        np.testing.assert_array_equal(bits, _bits(emulate(g, idx, 200)))
    assert np.all(bits[5:5 + len(runs)] == want)


def test_atlas_lookup_backward_with_untextured_lanes():
    """The texture atlas' gradient when most lanes are untextured (tid -1:
    slot 0, a 1 x 1 texture, so all four taps of such a lane land on row
    0 with a +0 cotangent): each tap's reduction bit-equal to both
    emulators, and the atlas gradient against the JAX package's vjp of
    ``gather_lane_bsdf``'s reflectance, rtol 1e-6 beyond the JAX side's own
    distance from a float64 sum of the same taps."""
    from mitransient_tpu.bsdf import api as jb
    from mitransient_tpu.scene import scene as jscene
    from mitransient_tpu_torch.bsdf import api as tb
    from mitransient_tpu_torch.scene import scene as tscene

    rng = np.random.default_rng(64)
    n = 20000
    atlas = rng.uniform(0.0, 1.0, (1, 64, 64, 3)).astype(np.float32)
    table = dict(kind=np.zeros(3, np.int32), two_sided=np.zeros(3, bool),
                 reflectance=np.full((3, 3), 0.5, np.float32),
                 eta_re=np.zeros((3, 3), np.float32),
                 eta_im=np.zeros((3, 3), np.float32),
                 alpha=np.zeros(3, np.float32),
                 eta_ratio=np.full(3, 1.5, np.float32),
                 alpha_v=np.zeros(3, np.float32),
                 tex_id=np.array([0, -1, -1], np.int32),
                 tex_hw=np.array([[64, 64], [1, 1], [1, 1]], np.float32),
                 tex_uv=np.array([[1, 1, 0, 0]] * 3, np.float32),
                 textures=atlas)
    ids = np.where(rng.random(n) < 0.2, 0, rng.integers(1, 3, n))
    ids = ids.astype(np.int32)
    uv = rng.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    cot = rng.random((n, 3), dtype=np.float32)
    tbp = tscene.BSDFParams(**{k: torch.from_numpy(v)
                               for k, v in table.items()})
    tex = tbp.textures.clone().requires_grad_()
    taps, reduce_rows = [], G.reduce_rows

    def capture(g, idx, rows):
        taps.append((g.numpy().copy(), idx.numpy().copy(), rows))
        return reduce_rows(g, idx, rows)

    G.reduce_rows = capture
    try:
        refl = tb.gather_lane_bsdf(tbp._replace(textures=tex),
                                   torch.from_numpy(ids),
                                   torch.from_numpy(uv)).reflectance
        (grad,) = torch.autograd.grad(refl, tex, torch.from_numpy(cot))
    finally:
        G.reduce_rows = reduce_rows
    assert len(taps) == 4
    exact = np.zeros((64 * 64, 3))
    for g, idx, rows in taps:
        assert rows == 64 * 64 and (idx == 0).mean() > 0.75
        assert not g[ids != 0].any()  # the untextured lanes' +0
        got = G.reduce_rows(torch.from_numpy(g), torch.from_numpy(idx), rows)
        for emulate in (emulate_k8, _emulate_runs_chunked):
            np.testing.assert_array_equal(_bits(got.numpy()),
                                          _bits(emulate(g, idx, rows)))
        np.add.at(exact, idx, g.astype(np.float64))
    jbp = jscene.BSDFParams(**{k: jnp.asarray(v) for k, v in table.items()})
    _, vjp = jax.vjp(lambda t: jb.gather_lane_bsdf(
        jbp._replace(textures=t), jnp.asarray(ids),
        jnp.asarray(uv)).reflectance, jnp.asarray(atlas))
    g_jax = np.asarray(vjp(jnp.asarray(cot))[0]).reshape(-1, 3)
    grad = grad.numpy().reshape(-1, 3)
    own = np.abs(g_jax - exact)
    assert np.all(np.abs(grad - g_jax) <= 1e-6 * np.abs(g_jax) + own)
    np.testing.assert_allclose(grad, exact, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("rows", [3, 4096])
def test_gather_rows_empty_index(rows):
    table = torch.ones((rows, 3), requires_grad=True)
    out = G.gather_rows(table, torch.zeros((0,), dtype=torch.int64))
    assert out.shape == (0, 3)
    (grad,) = torch.autograd.grad(out, table, torch.zeros((0, 3)))
    assert grad.shape == (rows, 3) and not grad.any()


def test_gather_rows_one_dimensional_and_int64_tables():
    """A 1-D table (roughness, extinction) and an int64 index, as the
    atlas taps pass: the gradient keeps the table's shape."""
    table = torch.arange(5.0, requires_grad=True)
    idx = torch.tensor([4, 0, 4, 2], dtype=torch.int64)
    out = G.gather_rows(table, idx)
    assert torch.equal(out, torch.tensor([4.0, 0.0, 4.0, 2.0]))
    (grad,) = torch.autograd.grad(out, table, torch.tensor([1., 2., 3., 4.]))
    assert torch.equal(grad, torch.tensor([2.0, 0.0, 4.0, 0.0, 4.0]))


def test_reduce_rows_launches_nothing_on_the_cpu():
    reset_launch_counts()
    G.reduce_rows(torch.ones((10, 2)), torch.zeros(10, dtype=torch.int32), 3)
    assert launch_counts() == {}
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        G.reduce_rows(torch.ones((10, 2), device="meta"),
                      torch.zeros(10, dtype=torch.int32, device="meta"), 3)


@pytest.mark.parametrize("rows", [5, 300])
def test_gather_rows_jvp_under_func_jvp_and_forward_ad(rows):
    """The tangent of a gather is the gather of the tangent, under
    ``torch.func.jvp`` (the PRB forward replay) and under
    ``torch.autograd.forward_ad`` (forward mode through the primal)."""
    table, idx, _ = _case(rows, 700, 3)
    tan = np.random.default_rng(1).normal(size=table.shape).astype(np.float32)
    t, dt, i = map(torch.from_numpy, (table, tan, idx))
    want = dt.index_select(0, i) * 2.0
    out, t_out = torch.func.jvp(lambda x: G.gather_rows(x, i) * 2.0, (t,),
                                (dt,))
    assert torch.equal(out, t.index_select(0, i) * 2.0)
    assert torch.equal(t_out, want)
    with fwAD.dual_level():
        y = G.gather_rows(fwAD.make_dual(t, dt), i) * 2.0
        assert torch.equal(fwAD.unpack_dual(y).tangent, want)


def test_sum_rows_keeps_its_pairwise_order():
    """``sum_rows``, the tiles' last stage: ((x0 + x2) + (x1 + x3)) + x4,
    where a sum in index order gives 4."""
    x = torch.tensor([[1e8], [1.0], [-1e8], [1.0], [3.0]])
    assert float(G.sum_rows(x)[0]) == 5.0


# --------------------------------------------------------------------------
# The gaussian temporal filter's splat
# --------------------------------------------------------------------------

W, H, T, SPP = 6, 5, 40, 3


def _gaussian_events(seed, channels):
    rng = np.random.default_rng(seed)
    n = SPP * W * H
    dist = rng.uniform(0.8, 3.4, n).astype(np.float32)
    dist[:3] = [1.0, 1.05, 2.9999]
    vals = rng.random((n, channels)).astype(np.float32)
    active = rng.random(n) > 0.2
    return dist, vals, active


@pytest.mark.parametrize("sigma, channels", [(1.5, 4), (0.7, 1)])
def test_gaussian_splat_matches_jax(sigma, channels):
    """The plain gaussian splat (``gaussian_taps`` through ``SplatEvents``)
    against the JAX package's ``_splat_gaussian``, both event sets, at
    rtol 1e-5 (exp's ulps, as test_torch_film.py)."""
    kw = dict(width=W, height=H, temporal_bins=T, start_opl=1.0,
              bin_width_opl=0.05)
    jcfg, tcfg = JFilmConfig(**kw), FilmConfig(**kw)
    da, va, act = _gaussian_events(7, channels)
    db, vb, _ = _gaussian_events(8, channels)
    args = (da, va, db, vb, act)
    jst = jf.splat_transient_pair(jf.film_init(jcfg, channels), jcfg, SPP,
                                  *map(jnp.asarray, args),
                                  temporal_filter="gaussian",
                                  gaussian_stddev=sigma)
    reset_launch_counts()
    tst = tf.splat_transient_pair(tf.film_init(tcfg, channels), tcfg, SPP,
                                  *map(torch.from_numpy, args),
                                  temporal_filter="gaussian",
                                  gaussian_stddev=sigma)
    assert launch_counts() == {}
    want = np.asarray(jst.transient)[:, :T + 1, :W * H]
    np.testing.assert_allclose(tst.transient.numpy(), want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))
    assert float(tst.transient[:, :T].sum()) > 0


def test_gaussian_taps_weights_sum_to_one_in_a_fixed_order():
    """The taps come out as K3's events, lane (s * K + k) * HW + p tap k of
    lane s of pixel p; each lane's K weights sum to one."""
    kw = dict(width=W, height=H, temporal_bins=T, start_opl=1.0,
              bin_width_opl=0.05)
    dist, vals, act = _gaussian_events(9, 3)
    n, hw = dist.size, W * H
    bins, taps = tf.gaussian_taps(FilmConfig(**kw), torch.from_numpy(dist),
                                  torch.ones((n, 1)),
                                  torch.ones(n, dtype=torch.bool), 2.0, SPP)
    assert bins.dtype == torch.int32 and bins.shape == (n * 13,)
    assert taps.shape == (n * 13, 1)
    np.testing.assert_allclose(taps.reshape(SPP, 13, hw).sum(1).numpy(), 1.0,
                               rtol=1e-6)
    assert int(bins.max()) == T and int(bins.min()) >= 0
    # tap k of an event lies k - 6 bins from its own (where in the film)
    own = np.floor((dist - np.float32(1.0)) / np.float32(0.05))
    tap = own.reshape(SPP, 1, hw) + np.arange(-6, 7)[None, :, None]
    inside = (tap >= 0) & (tap < T)
    assert np.array_equal(bins.reshape(SPP, 13, hw).numpy()[inside],
                          tap[inside])


def test_splat_taps_function_matches_plain_autograd():
    """The gaussian filter's splat, K3's ``SplatEvents`` at spp * K lanes
    on ``gaussian_taps``' layout: its backward (a gather of the film's
    cotangent at each tap's cell) and jvp (the splat of the tangents)
    bit-equal to autograd and forward AD through the plain ``index_add_``
    of every event's K taps, event by event, an event's taps in order."""
    cfg = FilmConfig(width=W, height=H, temporal_bins=T, start_opl=1.0,
                     bin_width_opl=0.05)
    dist, vals, act = _gaussian_events(10, 3)
    n, hw, C, t_pad = dist.size, W * H, 3, T + 1
    bins, taps = tf.gaussian_taps(cfg, *map(torch.from_numpy,
                                            (dist, vals, act)), 1.5, SPP)
    K = bins.shape[0] // n
    rng = np.random.default_rng(10)
    w = torch.from_numpy(rng.normal(size=(C, t_pad, hw)).astype(np.float32))

    def plain(v):
        """index_add_ of the taps as (N, K): event-major, then tap."""
        b = bins.reshape(SPP, K, hw).transpose(1, 2).reshape(-1)
        v = v.reshape(SPP, K, hw, C).transpose(1, 2).reshape(-1, C)
        pix = (torch.arange(n) % hw)[:, None].expand(n, K).reshape(-1)
        film = torch.zeros((C, t_pad, hw))
        tf._scatter_cells(film, pix, b, v)
        return film

    def fn(v):
        return tf.SplatEvents.apply(torch.zeros((C, t_pad, hw)), bins, v,
                                    None, None, SPP * K)

    v1 = taps.clone().requires_grad_()
    film = fn(v1 * 1.0)
    assert torch.equal(film, plain(taps))
    (g_fn,) = torch.autograd.grad((film * w).sum(), v1)
    v2 = taps.clone().requires_grad_()
    (g_plain,) = torch.autograd.grad((plain(v2 * 1.0) * w).sum(), v2)
    assert torch.equal(g_fn, g_plain)
    tan = torch.from_numpy(rng.normal(size=taps.shape).astype(np.float32))
    with fwAD.dual_level():
        out = fn(fwAD.make_dual(taps, tan))
        ref = plain(fwAD.make_dual(taps, tan))
        assert torch.equal(fwAD.unpack_dual(out).tangent,
                           fwAD.unpack_dual(ref).tangent)
        assert torch.equal(fwAD.unpack_dual(out).primal,
                           fwAD.unpack_dual(ref).primal)
