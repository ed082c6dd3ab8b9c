"""CUDA kernels of the PyTorch port (K1-K3, the BVH kernel, K8, the
gaussian temporal filter's splat and the threefry draw) against their
plain versions.

Every test is marked ``cuda`` and skips without an NVIDIA GPU.  This file
imports neither jax nor the JAX package, so on a machine with only PyTorch
it runs with ``python -m pytest tests/test_torch_cuda.py -m cuda
--noconftest`` (the repo's conftest.py imports jax).

Tolerances: the kernels are built with ``--fmad=false`` and follow the
plain versions' operation order, so ``prim``, ``occluded`` and ``t`` must
be equal (K1 also at the edges: inactive rays, NaN and negative maxt,
ragged n, several staging chunks, duplicated triangles) (for the BVH kernel: all rays of a 2^14-ray set, on soups whose
rays overflow the queue in either mode, and on an Accel with more chunks
than super mode once staged in shared memory).  The plain splat adds with
atomics on the card (order varies), so against it the film is held to
1e-6 of its maximum; against the plain version on the host CPU, which adds
in lane order as K3 does, it must be bit-equal.  K8 (the table-gradient
reduction) and the gaussian splat follow their plain versions' order, so
against them run on the host CPU they must be bit-equal too, and two
``render_backward`` calls on the card must give the same tables bit for
bit.  The threefry kernel's draws are integers turned into floats
exactly: bit-equal to the plain path on the host CPU, one launch a draw.
The multi-pass render's pass graph (``passgraph.py``) replays the eager
pass body's kernels with its arguments, so its films must be bit-equal to
that body's called directly; the regen loop's block graph
(``regengraph.py``) likewise to the plain loop's.
"""
import copy
import gc
import importlib
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import mitransient_tpu_torch as mt
from mitransient_tpu_torch import passgraph, regengraph, trace
from mitransient_tpu_torch.core import rng as trng
from mitransient_tpu_torch.convert import scene_data_from_numpy, scene_data_to_numpy
from mitransient_tpu_torch.film import transient_film as tf
from mitransient_tpu_torch.integrators import path_regen
from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts
from mitransient_tpu_torch.ops import bvh
from mitransient_tpu_torch.ops import intersect as isect
from mitransient_tpu_torch.ops import accel as TA
from mitransient_tpu_torch.ops.accel import build_accel
from mitransient_tpu_torch.integrators.nlos_path import film_channels
from mitransient_tpu_torch.scene.scene import primal_sd
from mitransient_tpu_torch.sensors.perspective import build_camera
from torch_cases import (
    box_rays,
    golden_mismatch,
    material_case,
    materials_cbox,
    overlapping_rays,
    overlapping_soup,
    random_rays,
    random_soup,
    small_cbox,
    small_sphere_cbox,
    splat_events,
    VARIANT_CASES,
    VARIANT_REGEN,
    run_variant_case,
    variant_case,
    variant_render,
    with_variant,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _soups(dev):
    rng = np.random.default_rng(1)
    sd = mt.load_dict(mt.cornell_box(), device=dev).data
    yield "cbox", (sd.tri.v0, sd.tri.e1, sd.tri.e2)
    # 2100 triangles: more than one shared-memory chunk of 1024
    for m in (200, 2100):
        yield f"random{m}", tuple(torch.from_numpy(a).to(dev)
                                  for a in random_soup(rng, m))


def _rays(dev, soup, n=20000, seed=2):
    rng = np.random.default_rng(seed)
    host = tuple(a.cpu().numpy() for a in soup)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in random_rays(rng, n, host))


@pytest.mark.cuda
def test_closest_hit_kernel_matches_plain(cuda):
    for name, soup in _soups(cuda):
        o, d, maxt, active = _rays(cuda, soup)
        t_k, prim_k = isect.closest_hit(*soup, o, d, maxt, active,
                                        table=isect.tri_table(*soup))
        t_p, prim_p, _, _ = isect.intersect_soup(*soup, o, d, maxt, active)
        torch.cuda.synchronize()
        assert torch.equal(prim_k, prim_p), name
        assert torch.equal(t_k, t_p), name
        assert (prim_k >= 0).any() and (prim_k < 0).any(), name


@pytest.mark.cuda
def test_ray_test_kernel_matches_plain(cuda):
    for name, soup in _soups(cuda):
        o, d, maxt, active = _rays(cuda, soup, seed=3)
        maxt = torch.where(torch.isinf(maxt), 1.0, maxt)
        occ_k = isect.ray_test(*soup, o, d, maxt, active,
                               table=isect.tri_table(*soup))
        occ_p = isect.ray_test_soup(*soup, o, d, maxt, active)
        torch.cuda.synchronize()
        assert torch.equal(occ_k, occ_p), name
        assert occ_k.any() and (~occ_k & active).any(), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all_inactive", "ragged", "one_ray",
                                  "three_chunks"])
def test_ray_test_kernel_edge_cases(cuda, case):
    """K2 bit-equal to ray_test_soup with every ray inactive, with n not a
    multiple of the 256-ray block, with one ray, and on a 3000-triangle
    soup (six staging chunks of 512); NaN and negative maxt among the
    rays."""
    rng = np.random.default_rng(8)
    m = 3000 if case == "three_chunks" else 200
    soup = random_soup(rng, m)
    n = {"all_inactive": 5000, "ragged": 3 * 1024 + 511, "one_ray": 1,
         "three_chunks": 4099}[case]
    o, d, maxt, active = random_rays(rng, n, soup)
    maxt = np.where(np.isinf(maxt), np.float32(1.2), maxt).astype(np.float32)
    maxt[::17] = np.nan
    maxt[5::23] = -1.0
    if case == "all_inactive":
        active[:] = False
    if case == "one_ray":
        active[:] = True
    args = tuple(torch.from_numpy(a).to(cuda)
                 for a in (*soup, o, d, maxt, active))
    occ_k = isect.ray_test(*args, table=isect.tri_table(*args[:3]))
    occ_p = isect.ray_test_soup(*args)
    torch.cuda.synchronize()
    assert torch.equal(occ_k, occ_p)
    if case in ("ragged", "three_chunks"):
        assert occ_k.any() and (~occ_k & args[-1]).any()
    if case == "all_inactive":
        assert not occ_k.any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all_inactive", "ragged", "one_ray",
                                  "three_chunks", "ties"])
def test_closest_hit_kernel_edge_cases(cuda, case):
    """K1 equal to intersect_soup (``t`` bit for bit) with every ray
    inactive, with n not a multiple of a block's rays, with one ray, on a
    3000-triangle soup (six staging chunks of 512), and on a soup of
    duplicated triangles (every tie must keep the lower index); NaN and
    negative maxt among the rays, and rays aimed at the tied pair."""
    rng = np.random.default_rng(9)
    m = 3000 if case == "three_chunks" else 200
    soup = random_soup(rng, m)
    if case == "ties":  # triangle k + 100 repeats triangle k
        soup = tuple(np.concatenate([a[:100], a[:100]]) for a in soup)
    n = {"all_inactive": 5000, "ragged": 5 * 1024 + 511, "one_ray": 1,
         "three_chunks": 4099, "ties": 3000}[case]
    o, d, maxt, active = random_rays(rng, n, soup)
    maxt[::17] = np.nan
    maxt[5::23] = -1.0
    if case == "all_inactive":
        active[:] = False
    if case == "one_ray":
        active[:] = True
        maxt[:] = np.inf
    args = tuple(torch.from_numpy(a).to(cuda)
                 for a in (*soup, o, d, maxt, active))
    t_k, prim_k = isect.closest_hit(*args, table=isect.tri_table(*args[:3]))
    t_p, prim_p, _, _ = isect.intersect_soup(*args)
    torch.cuda.synchronize()
    assert torch.equal(prim_k, prim_p)
    assert torch.equal(t_k, t_p)
    if case == "all_inactive":
        assert (prim_k < 0).all() and torch.isinf(t_k).all()
    elif case == "ties":
        assert (prim_k >= 0).any() and not (prim_k >= 100).any()
    elif case != "one_ray":
        assert (prim_k >= 0).any() and (prim_k < 0).any()


@pytest.mark.cuda
def test_soup_kernels_take_the_scene_table(cuda):
    """The triangle table a scene keeps for the kernels equals tri_table of
    its soup, for a scene loaded on the card and for one carried across by
    convert.py; the kernels raise without it and on a table of another
    soup."""
    desc = mt.cornell_box()
    loaded = mt.load_dict(desc, device=cuda).data.tri
    carried = scene_data_from_numpy(scene_data_to_numpy(
        mt.load_dict(desc, device="cpu").data), device=cuda).tri
    for tri in (loaded, carried):
        assert tri.table.device.type == "cuda"
        assert torch.equal(tri.table, isect.tri_table(tri.v0, tri.e1, tri.e2))
    soup = (loaded.v0, loaded.e1, loaded.e2)
    o, d, maxt, active = _rays(cuda, soup, n=64)
    for fn in (isect.closest_hit, isect.ray_test):
        with pytest.raises(ValueError, match="tri_table"):
            fn(*soup, o, d, maxt, active)
        with pytest.raises(ValueError, match="shape"):
            fn(*soup, o, d, maxt, active, table=loaded.table[:-1])


@pytest.mark.cuda
@pytest.mark.parametrize("two_events", [False, True])
def test_splat_kernel_matches_plain(cuda, two_events):
    rng = np.random.default_rng(4)
    lanes, hw, bins = 6, 300, 50
    sets = [splat_events(rng, lanes, hw, bins) for _ in range(2)]
    sets = [tuple(torch.from_numpy(a).to(cuda) for a in s) for s in sets]
    (ba, va), (bb, vb) = sets if two_events else (sets[0], (None, None))
    init = torch.from_numpy(rng.random((3, bins + 1, hw)).astype(np.float32))
    film_k, film_p = init.to(cuda), init.to(cuda)
    tf.splat_accumulate(film_k, ba, va, bb, vb, spp=lanes)
    tf._scatter_layout(film_p, hw, ba, va)
    if two_events:
        tf._scatter_layout(film_p, hw, bb, vb)
    torch.cuda.synchronize()
    scale = float(film_p.abs().max())
    assert float((film_k - film_p).abs().max()) <= 1e-6 * scale
    # the kernel is deterministic: the same adds give the same bits
    film_k2 = init.to(cuda)
    tf.splat_accumulate(film_k2, ba, va, bb, vb, spp=lanes)
    assert torch.equal(film_k, film_k2)


@pytest.mark.cuda
@pytest.mark.parametrize("channels, hw, lanes, bins, two_events", [
    (3, 300, 6, 50, True),  # hw not a multiple of the 32-pixel tile
    (1, 301, 5, 40, False),  # rows not 16-byte aligned: no float4
    (3, 4096, 1, 300, True),  # one lane
    (3, 100, 3, 12000, True),  # a 144 KB pixel slab: one pixel a block
    (4, 1000, 4, 400, True),  # mono_polarized Stokes: 16 pixels a block
    (12, 1000, 4, 400, True),  # rgb_polarized: a 19,248-byte pixel slab
])
def test_splat_kernel_is_bit_equal_to_cpu_plain(cuda, channels, hw, lanes,
                                                bins, two_events):
    rng = np.random.default_rng(7)
    sets = []
    for _ in range(2):
        b, v = splat_events(rng, lanes, hw, bins, channels)
        b[rng.random(b.shape[0]) < 0.05] = -3  # dropped below the film
        b[rng.random(b.shape[0]) < 0.05] = bins + 5  # and beyond it
        sets.append((torch.from_numpy(b), torch.from_numpy(v)))
    if not two_events:
        sets[1] = (None, None)
    init = torch.from_numpy(
        rng.random((channels, bins + 1, hw)).astype(np.float32))
    film_k = init.to(cuda)
    tf.splat_accumulate(film_k, *(None if a is None else a.to(cuda)
                                  for s in sets for a in s), spp=lanes)
    film_c = init.clone()
    tf.splat_accumulate(film_c, *(a for s in sets for a in s), spp=lanes)
    torch.cuda.synchronize()
    assert torch.equal(film_k.cpu(), film_c)
    assert not torch.equal(film_c, init)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", bvh.MODES)
@pytest.mark.parametrize("query", ["closest", "any", "mixed"])
def test_bvh_chunk_kernel_matches_plain_when_queues_overflow(cuda, query,
                                                             mode):
    """Large random triangles whose chunk boxes all overlap, rays from
    outside: many queues fill, and those rays finish with the linear pick,
    still equal to query_plain.  Super mode's tree has 8x fewer leaves, so
    its soup has 10x the triangles (about 70 super-chunks); the kernel's
    triangle tests equal query_plain's."""
    m = 20000 if mode == "chunk" else 200000
    acc = build_accel(*overlapping_soup(np.random.default_rng(5), m),
                      device=cuda)
    n = 4096
    rays = tuple(torch.from_numpy(a).to(cuda) for a in
                 overlapping_rays(np.random.default_rng(6), n))
    n_closest = {"closest": n, "any": 0, "mixed": n // 2 + 13}[query]
    stats = torch.zeros(len(bvh.STATS), dtype=torch.int64, device=cuda)
    t_k, p_k = bvh.query_kernel(acc, *rays, n_closest, mode, stats=stats)
    counts = {"slab": 0, "woop": 0, "box_once": 0}
    t_p, p_p = bvh.query_plain(acc, *rays, n_closest, mode, counts=counts)
    torch.cuda.synchronize()
    assert torch.equal(p_k, p_p)
    assert torch.equal(t_k, t_p)
    assert (p_k >= 0).any() and (p_k < 0).any()
    box_tests, tri_tests, overflowed = stats.tolist()
    assert 0 < overflowed < n and box_tests > n and tri_tests > n
    assert tri_tests == int(counts["woop"])


@pytest.mark.cuda
def test_kernels_check_their_arguments(cuda):
    soup = next(_soups(cuda))[1]
    table = isect.tri_table(*soup)
    o, d, maxt, active = _rays(cuda, soup, n=64)
    with pytest.raises(TypeError):
        isect.closest_hit(*soup, o.double(), d, maxt, active, table=table)
    with pytest.raises(ValueError):
        isect.ray_test(*soup, o[:, :2], d, maxt, active, table=table)
    with pytest.raises(ValueError):
        isect.closest_hit(*soup, o.T.contiguous().T, d, maxt, active,
                          table=table)
    with pytest.raises(ValueError):
        isect.closest_hit(*soup, o, d.cpu(), maxt, active, table=table)
    shifted = table.new_zeros(table.numel() + 1)[1:].view(table.shape)
    shifted.copy_(table)  # contiguous, 4 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        isect.closest_hit(*soup, o, d, maxt, active, table=shifted)


@pytest.mark.cuda
def test_small_render_on_cuda_goes_through_the_kernels(cuda):
    """The cbox_rgb config on the card: each kernel launches once per loop
    iteration and the images agree with the port on the CPU under the
    golden rule (rtol 5e-4, atol 5e-5 * max, no element out)."""
    out = {}
    for dev in ("cpu", cuda):
        scene = mt.load_dict(small_cbox(mt), device=dev)
        reset_launch_counts()
        s, t, stats = mt.render(scene, spp=8, seed=0, return_stats=True)
        out[str(dev)] = (s.cpu().numpy(), t.cpu().numpy(), stats,
                         launch_counts())
    s_c, t_c, stats_c, counts_c = out["cpu"]
    s_g, t_g, stats_g, counts_g = out[str(cuda)]
    assert counts_c == {}
    n = stats_g["loop_iters"]
    assert n > 0 and counts_g == {"closest_hit": n, "ray_test": n,
                                  "splat_accumulate": n}
    assert np.isfinite(s_g).all() and np.isfinite(t_g).all()
    for got, want in ((s_g, s_c), (t_g, t_c)):
        m = golden_mismatch(got, want)
        assert m["shape_ok"] and m["n_bad"] == 0, m


@pytest.mark.cuda
def test_multipass_render_on_cuda_goes_through_the_kernels(cuda):
    """The cbox_rgb config through the multi-pass accumulator (3 passes):
    each kernel launches once per bounce of each pass and the threefry
    kernel once for each draw the CPU's render makes (passes replayed in
    the pass graph included), the images agree
    with the CPU under the golden rule, and a resumed render is bit for
    bit the uninterrupted one; the threefry draw is bit-equal to the
    CPU's."""
    kw = dict(spp=12, seed=1, max_lanes=4 * 256, regenerate=False)
    out = {}
    for dev in ("cpu", cuda):
        scene = mt.load_dict(small_cbox(mt), device=dev)
        states = []
        reset_launch_counts()
        (s, t, stats), draws = _with_draws(lambda: mt.render(
            scene, return_stats=True, checkpoint_callback=states.append,
            **kw))
        counts = launch_counts()
        if dev == "cpu":
            cpu_draws = draws
        s2, t2 = mt.render(scene, film_state=states[1], **kw)
        assert torch.equal(s2, s) and torch.equal(t2, t)
        out[str(dev)] = (s.cpu().numpy(), t.cpu().numpy(), stats, counts)
    s_c, t_c, _, counts_c = out["cpu"]
    s_g, t_g, stats_g, counts_g = out[str(cuda)]
    n = stats_g["loop_iters"]
    assert counts_c == {} and n == 3 * 6
    # a bounce block a bounce and the camera's two draws a pass
    assert cpu_draws == n + 3 * 2
    draws_g = counts_g.pop("threefry_uniform", 0)
    assert counts_g == {"closest_hit": n, "ray_test": n, "splat_accumulate": n}
    assert draws_g == cpu_draws
    for got, want in ((s_g, s_c), (t_g, t_c)):
        m = golden_mismatch(got, want)
        assert m["shape_ok"] and m["n_bad"] == 0, m
    assert torch.equal(
        trng.draw_bounce_block(trng.Sampler(3, 1, 2, device=cuda).key, 5,
                               4099, 6).cpu(),
        trng.draw_bounce_block(trng.Sampler(3, 1, 2).key, 5, 4099, 6))


def _with_draws(fn):
    """``fn()`` and the threefry draws it made: the ``rng.draws`` counter
    of a profiler session of its own."""
    with trace.span("mitr:render"):  # no profiler: the next span starts anew
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, trace.summary()["counters"].get("rng.draws", 0)


def _same_draw(got, want, launches):
    """A draw on the card bit-equal to the host CPU's, made in
    ``launches`` launches of the threefry kernel."""
    assert got.device.type == "cuda" and want.device.type == "cpu"
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert launch_counts().get("threefry_uniform", 0) == launches


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 4099, 1 << 21])
@pytest.mark.parametrize("dims", [1, 6, 8, 10])
def test_threefry_kernel_bounce_blocks_are_bit_equal_to_cpu_plain(cuda, n,
                                                                   dims):
    key = trng.Sampler(2**32 - 1, 1, 3).key
    reset_launch_counts()
    got = trng.draw_bounce_block(key.to(cuda), 5, n, dims)
    _same_draw(got, trng.draw_bounce_block(key, 5, n, dims), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 4099])
def test_threefry_kernel_sampler_draws_are_bit_equal_to_cpu_plain(cuda, n):
    """eval_1d, eval_2d (two draws) and next_2d."""
    for seed, stream in ((0, 0), (7, 2), (2**32 - 1, 5)):
        card = trng.Sampler(seed, n, stream, device=cuda)
        host = trng.Sampler(seed, n, stream)
        reset_launch_counts()
        _same_draw(card.eval_1d(3), host.eval_1d(3), 1)
        _same_draw(card.eval_2d(4), host.eval_2d(4), 3)
        _same_draw(card.next_2d(), host.next_2d(), 5)
        assert card.dim == host.dim == 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape, rows, dim", [
    # an unaligned r0 and a partial last vector
    ((4099, 6), (1, 4098), 0x6D50),
    ((1000, 3), (7, 8), 0x6D50),
    ((1 << 21, 32, 2), (3, 70003), 0x6D50),  # a tracking draw's slice
    # counters 2^32 - 8 .. 2^32 + 2039: the high word turns from 0 to 1
    ((2**31, 4), (2**30 - 2, 2**30 + 510), 0x6D50),
    ((10, 6), (4, 4), 0x6D50),  # no rows: no launch
    ((0, 6), None, 0x6D50),
    ((), None, 0x6D50),
    ((5,), None, 0x6D50),
    # a bounce block's size at dimensions past the sampler's and the
    # bounce blocks': the wavelength tag and the last uint32
    ((1 << 21, 6), None, 0x57AC),
    ((1 << 21, 6), (5, 4099), 2**32 - 1),
])
def test_threefry_kernel_rows_slices_are_bit_equal_to_cpu_plain(cuda, shape,
                                                                rows, dim):
    """The key is row 1 of a pass key table: the kernel reads it 8 bytes
    into the table, as a render's passes read theirs."""
    key = trng.pass_keys(12345, [0, 3])[1]
    reset_launch_counts()
    got = trng.uniform(trng.pass_keys(12345, [0, 3], cuda)[1], dim, shape,
                       rows=rows)
    want = trng.uniform(key, dim, shape, rows=rows)
    _same_draw(got, want, 1 if want.numel() else 0)


def _sphere_rays(scene, dev, n=1 << 14, seed=5):
    cam = build_camera(scene.sensors[0], device="cpu")
    rays = box_rays(np.random.default_rng(seed), n,
                    cam.R.numpy().astype(np.float64), cam.origin.numpy(),
                    cam.tan_half.numpy())
    return tuple(torch.from_numpy(a).to(dev) for a in rays)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", bvh.MODES)
@pytest.mark.parametrize("query", ["closest", "any", "mixed",
                                   "mixed_in_warp"])
def test_bvh_kernel_matches_plain(cuda, mode, query):
    """``mixed_in_warp``: n_closest inside a warp, so one warp's sweeps mix
    closest-hit and any-hit rays."""
    scene = mt.load_dict(small_sphere_cbox(mt), device=cuda)
    acc = scene.data.accel
    assert acc is not None
    rays = _sphere_rays(scene, cuda)
    n = rays[0].shape[0]
    n_closest = {"closest": n, "any": 0, "mixed": n // 2,
                 "mixed_in_warp": n // 2 + 13}[query]
    reset_launch_counts()
    t_k, p_k = bvh.query_kernel(acc, *rays, n_closest, mode)
    assert launch_counts() == {f"bvh_query_{mode}": 1}
    t_p, p_p = bvh.query_plain(acc, *rays, n_closest, mode)
    torch.cuda.synchronize()
    assert torch.equal(p_k, p_p)
    assert torch.equal(t_k, t_p)
    assert (p_k >= 0).any() and (p_k < 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", bvh.MODES)
def test_bvh_kernel_counts_only_the_rays_it_is_given(cuda, mode):
    """The counters are sums over the rays: a launch on n rays (n not a
    multiple of the 64-ray block) counts what launches on two parts of them
    count, whose blocks hold another number of lanes past the end, so such
    lanes count nothing; its triangle tests equal query_plain's."""
    scene = mt.load_dict(small_sphere_cbox(mt), device=cuda)
    acc = scene.data.accel
    rays = _sphere_rays(scene, cuda, n=4096 + 13, seed=7)
    n = rays[0].shape[0]
    n_closest = n // 2 + 13

    def count(lo, hi):
        buf = torch.zeros(len(bvh.STATS), dtype=torch.int64, device=cuda)
        part = tuple(a[lo:hi].contiguous() for a in rays)
        bvh.query_kernel(acc, *part, min(max(n_closest - lo, 0), hi - lo),
                         mode, stats=buf)
        return buf.tolist()

    whole = count(0, n)
    parts = [a + b for a, b in zip(count(0, 5), count(5, n))]
    counts = {"slab": 0, "woop": 0, "box_once": 0}
    bvh.query_plain(acc, *rays, n_closest, mode, counts=counts)
    assert whole == parts
    assert whole[0] >= n and whole[1] == int(counts["woop"]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("query", ["closest", "mixed"])
def test_bvh_super_kernel_takes_more_chunks_than_shared_memory_held(
        cuda, monkeypatch, query):
    """An Accel of about 11,000 one-row chunks (60,000 random triangles cut
    at 8 a chunk): its bounds (4 * (7 C + 6 S) bytes) exceed the 227 KB that
    super mode once staged in shared memory, and the kernel still equals
    query_plain, n not a multiple of the block."""
    monkeypatch.setattr(TA, "CHUNK_TRIS", 4)
    rng = np.random.default_rng(9)
    soup = random_soup(rng, 60000)
    acc = build_accel(*soup, device=cuda)
    c, s = acc.pages.shape[0], acc.sup_min.shape[0]
    assert 4 * (7 * c + 6 * s) > 232448
    n = 3001
    rays = tuple(torch.from_numpy(a).to(cuda)
                 for a in random_rays(rng, n, soup))
    n_closest = n if query == "closest" else n // 2 + 5
    t_k, p_k = bvh.query_kernel(acc, *rays, n_closest, "super")
    t_p, p_p = bvh.query_plain(acc, *rays, n_closest, "super")
    torch.cuda.synchronize()
    assert torch.equal(p_k, p_p)
    assert torch.equal(t_k, t_p)
    assert (p_k >= 0).any() and (p_k < 0).any()


@pytest.mark.cuda
def test_bvh_kernel_agrees_with_k1(cuda):
    """Woop (BVH) against Moller-Trumbore (K1) brute force: the same hits
    up to rounding at triangle edges (at most 1e-4 of the rays), and ``t``
    under tests/test_accel.py's ``_same_hits`` rule (rtol 1e-3, atol 1e-4):
    the two tests round ``t`` differently."""
    scene = mt.load_dict(small_sphere_cbox(mt), device=cuda)
    sd = scene.data
    rays = _sphere_rays(scene, cuda, seed=6)
    t_b, p_b = isect.closest_hit(sd.tri.v0, sd.tri.e1, sd.tri.e2, *rays,
                                 accel=sd.accel)
    t_1, p_1 = isect.closest_hit(sd.tri.v0, sd.tri.e1, sd.tri.e2, *rays,
                                 table=sd.tri.table)
    torch.cuda.synchronize()
    assert float((p_b != p_1).float().mean()) <= 1e-4
    both = (p_b == p_1) & (p_b >= 0)
    assert torch.allclose(t_b[both], t_1[both], rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", bvh.MODES)
def test_small_sphere_render_on_cuda_goes_through_the_bvh_kernel(cuda, mode):
    """The small sphere config on the card, in each traversal mode: the
    BVH kernel launches twice per loop iteration (closest hit, shadow
    rays), K1/K2 never, and the images agree with the port on the CPU
    under the golden rule."""
    out = {}
    for dev in ("cpu", cuda):
        scene = mt.load_dict(small_sphere_cbox(mt), device=dev)
        reset_launch_counts()
        s, t, stats = mt.render(scene, spp=8, seed=0, return_stats=True,
                                bvh_mode=mode)
        out[str(dev)] = (s.cpu().numpy(), t.cpu().numpy(), stats,
                         launch_counts())
    s_c, t_c, _, counts_c = out["cpu"]
    s_g, t_g, stats_g, counts_g = out[str(cuda)]
    assert counts_c == {}
    n = stats_g["loop_iters"]
    assert n > 0 and counts_g == {f"bvh_query_{mode}": 2 * n,
                                  "splat_accumulate": n}
    for got, want in ((s_g, s_c), (t_g, t_c)):
        m = golden_mismatch(got, want)
        assert m["shape_ok"] and m["n_bad"] == 0, m


@pytest.mark.cuda
def test_math_rounds_alike_on_card_and_cpu(cuda):
    """``core/math.py``'s sqrt, cos_sin and divide give the same bits on
    the card as on the CPU."""
    from mitransient_tpu_torch.core import math as tm

    g = torch.Generator().manual_seed(3)
    x = torch.rand(1 << 20, generator=g) * 8.0 - 4.0
    for name, f in (("sqrt", lambda a: tm.sqrt(a.abs())),
                    ("cos", lambda a: tm.cos_sin(a)[0]),
                    ("sin", lambda a: tm.cos_sin(a)[1]),
                    ("divide", lambda a: tm.divide(a, 0.02))):
        assert torch.equal(f(x.to(cuda)).cpu(), f(x)), name


@pytest.mark.cuda
@pytest.mark.parametrize("multipass", [False, True])
@pytest.mark.parametrize("name", ["dielectric", "flagship"])
def test_material_render_is_bit_identical_on_card_and_cpu(cuda, name,
                                                           multipass):
    """A glass cube standing on the floor sends rays to its bottom, coplanar
    with the floor, where an ulp decides which triangle a ray hits: the
    card renders it bit for bit as the CPU does."""
    out = []
    for dev in (cuda, "cpu"):
        desc, run = material_case(mt, name)
        s, t, stats = run(mt.load_dict(desc, device=dev), multipass)
        out.append((s.cpu(), t.cpu(), int(stats["rays"])))
    assert out[0][2] == out[1][2]
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1],
                                                              out[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("multipass", [False, True])
@pytest.mark.parametrize("name", VARIANT_CASES)
def test_variant_render_on_cuda_matches_cpu(cuda, name, multipass):
    """The polarized and spectral variants (``torch_cases.variant_case``,
    a gold GGX box) on the card through the kernels against the CPU:
    test_golden's rule with no element out, the same ray count, and K3
    launched once a loop iteration or bounce."""
    if not multipass and name not in VARIANT_REGEN:
        pytest.skip("the spectral variants render multi-pass only")
    out = []
    for dev in (cuda, "cpu"):
        reset_launch_counts()
        s, t, stats = variant_render(mt, name, multipass, device=dev)
        if dev == cuda:
            counts, n = launch_counts(), stats["loop_iters"]
        out.append((s.cpu().numpy(), t.cpu().numpy(), int(stats["rays"])))
    assert counts.get("splat_accumulate") == n
    assert counts.get("closest_hit", 0) >= n and counts.get("ray_test", 0) > 0
    assert out[0][2] == out[1][2]
    for got, want in zip(out[0][:2], out[1][:2]):
        m = golden_mismatch(got, want)
        assert m["shape_ok"] and m["n_bad"] == 0, m


@pytest.mark.cuda
def test_splat_function_keeps_k3_under_autograd(cuda):
    """K3's autograd Function on the card: its forward and its jvp launch
    K3; the backward (a gather) equals the plain version's index_add_
    autograd bit for bit, and the jvp's tangent film equals the plain
    version's forward AD on the host CPU (lane order) bit for bit."""
    from torch.autograd import forward_ad as fwAD

    rng = np.random.default_rng(9)
    lanes, hw, bins = 5, 700, 60
    host = [torch.from_numpy(a) for _ in range(2)
            for a in splat_events(rng, lanes, hw, bins)]
    host[0][::11] = bins + 4  # beyond the film: dropped
    ev = [a.to(cuda) for a in host]
    shape = (3, bins + 1, hw)
    w = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
    va, vb = ev[1].clone().requires_grad_(), ev[3].clone().requires_grad_()
    reset_launch_counts()
    film = tf.SplatEvents.apply(torch.zeros(shape, device=cuda), ev[0],
                                va * 1.0, ev[2], vb * 1.0, lanes)
    assert launch_counts() == {"splat_accumulate": 1}
    got = torch.autograd.grad((film * w).sum(), (va, vb))
    pa, pb = ev[1].clone().requires_grad_(), ev[3].clone().requires_grad_()
    plain = torch.zeros(shape, device=cuda)
    tf._scatter_layout(plain, hw, ev[0], pa * 1.0)
    tf._scatter_layout(plain, hw, ev[2], pb * 1.0)
    want = torch.autograd.grad((plain * w).sum(), (pa, pb))
    assert all(torch.equal(g, x) for g, x in zip(got, want))
    ta, tb = (torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
              for v in (host[1], host[3]))
    with fwAD.dual_level():
        reset_launch_counts()
        out = tf.SplatEvents.apply(
            torch.zeros(shape, device=cuda), ev[0],
            fwAD.make_dual(ev[1], ta.to(cuda)), ev[2],
            fwAD.make_dual(ev[3], tb.to(cuda)), lanes)
        t_card = fwAD.unpack_dual(out).tangent.cpu()
        assert launch_counts() == {"splat_accumulate": 2}
        ref = torch.zeros(shape)
        tf._scatter_layout(ref, hw, host[0], fwAD.make_dual(host[1], ta))
        tf._scatter_layout(ref, hw, host[2], fwAD.make_dual(host[3], tb))
        t_cpu = fwAD.unpack_dual(ref).tangent
    assert torch.equal(t_card, t_cpu)


def _tables_close(got, want, what):
    for f in got._fields:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), (what, f)
        if g is not None:
            scale = max(float(w.abs().max()), 1e-30)
            assert float((g.cpu() - w).abs().max()) <= 1e-4 * scale, (what, f)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["prb", "fullad", "forward"])
def test_differentiation_on_cuda_matches_cpu(cuda, method):
    """render_backward (PRB and full AD) and render_forward of the test_grad
    box on the card against the CPU: the table gradients within 1e-4 of
    their largest value (the card and the CPU may round a sweep apart),
    the derivative video under the golden rule; K1 and K2 run
    in both sweeps, and K3 wherever a film is splatted (full AD's film,
    the forward replay's derivative film)."""
    from torch_cases import grad_cbox

    # a transient adjoint that varies over the bins, so that the bin each
    # vertex or splat reads it at matters
    adjoint = np.random.default_rng(3).uniform(
        0.0, 1.0, (8, 8, 100, 3)).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        scene = mt.load_dict(grad_cbox(mt, 8, 8, 100, 3), device=dev)
        reset_launch_counts()
        if method == "forward":
            out[str(dev)] = mt.render_forward(
                scene, {"white.reflectance.value": [1.0, 0.5, 0.25]}, spp=8,
                seed=0)
        else:
            out[str(dev)] = mt.render_backward(
                scene, (None, adjoint), spp=8, seed=0,
                method="fullad" if method == "fullad" else None)
        counts = launch_counts()
    sweeps = 1 if method == "fullad" else 2
    assert counts["closest_hit"] == sweeps * 3 == counts["ray_test"]
    assert counts.get("splat_accumulate", 0) == (0 if method == "prb" else 3)
    if method == "forward":
        for g, w in zip(out[str(cuda)], out["cpu"]):
            m = golden_mismatch(g.cpu().numpy(), w.numpy())
            assert m["shape_ok"] and m["n_bad"] == 0, m
    else:
        _tables_close(out[str(cuda)]["__tables__"], out["cpu"]["__tables__"],
                      method)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fog", "grid_random"])
def test_volumetric_render_and_gradients_on_cuda_match_cpu(cuda, name):
    """A volumetric render (homogeneous fog, and the random 8^3 grid with a
    to_world) on the card is the CPU's bit for bit; each bounce launches K1
    five times (the path ray and the shadow walk), K3 once and K2 never.
    The PRB gradients and the forward-mode derivative video (through K3's
    Function) of the fog box (vol_grad_case) on the card against the CPU
    within 1e-4 of each table's or video's largest value."""
    from torch_cases import vol_case, vol_grad_case

    desc, kw = vol_case(mt, name)
    out = {}
    for dev in ("cpu", cuda):
        reset_launch_counts()
        out[str(dev)], draws = _with_draws(
            lambda: mt.render(mt.load_dict(desc, device=dev), **kw))
        counts = launch_counts()
        if dev == "cpu":
            cpu_draws = draws
    depth = desc["integrator"]["max_depth"]
    assert cpu_draws >= depth + 2  # bounce blocks, the camera's two draws
    assert counts == {"closest_hit": 5 * depth, "splat_accumulate": depth,
                      "threefry_uniform": cpu_draws}
    for g, w in zip(out[str(cuda)], out["cpu"]):
        assert torch.equal(g.cpu(), w)
    adjoint = (None, np.random.default_rng(5).uniform(
        0.0, 1.0, (8, 8, 100, 3)).astype(np.float32))
    grads = {str(dev): mt.render_backward(
        mt.load_dict(vol_grad_case(mt, "fog"), device=dev), adjoint, spp=4,
        seed=3)["__tables__"] for dev in ("cpu", cuda)}
    _tables_close(grads[str(cuda)], grads["cpu"], "volumetric prb")
    videos = {str(dev): mt.render_forward(
        mt.load_dict(vol_grad_case(mt, "fog"), device=dev),
        {"small-box.medium.albedo.value": [1.0, 1.0, 1.0]}, spp=4, seed=3)
        for dev in ("cpu", cuda)}
    for g, w in zip(videos[str(cuda)], videos["cpu"]):
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(
            w.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("kind, name", [("nlos", "pol_gold"),
                                        ("nlos", "spectral_polarized"),
                                        ("vol", "rgb_polarized"),
                                        ("vol", "spectral_grid")])
def test_variant_nlos_and_volumetric_on_cuda_match_cpu(cuda, kind, name):
    """A polarized and a spectral NLOS capture and volumetric render
    (``torch_cases.variant_nlos_case`` / ``variant_vol_case``) on the card
    are the CPU's bit for bit, with the same ray count; K3 launches once a
    bounce (the volumetric bounce launches K1 five times, K2 never)."""
    out = []
    for dev in (cuda, "cpu"):
        reset_launch_counts()
        s, t, stats = run_variant_case(mt, kind, name, device=dev)
        if dev == cuda:
            counts = launch_counts()
        out.append((s.cpu(), t.cpu(), int(stats["rays"])))
    assert counts.get("splat_accumulate", 0) > 0
    if kind == "vol":
        assert counts["closest_hit"] == 5 * counts["splat_accumulate"]
        assert "ray_test" not in counts
    else:
        assert counts["ray_test"] >= counts["splat_accumulate"]
    assert out[0][2] == out[1][2]
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pol_nlos", "pol_fog", "spectral_fog"])
def test_variant_gradients_on_cuda_match_cpu(cuda, name):
    """Variant gradients (``torch_cases.variant_grad_case``: polarized NLOS
    and fog through full AD, the spectral fog through the PRB replay) on
    the card against the CPU, within 1e-4 of each table's largest value
    (the card and the CPU may round a sweep apart)."""
    grads = {str(dev): run_variant_case(mt, "grad", name, device=dev)
             for dev in ("cpu", cuda)}
    _tables_close(grads[str(cuda)]["__tables__"], grads["cpu"]["__tables__"],
                  name)


def _bit_equal(a, b):
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("rows, lanes, channels, one_row", [
    (1, 5, 3, False), (8, 1 << 20, 3, False), (27, 200003, 1, True),
    (128, 3 * 1024 + 5, 12, False), (129, 100000, 4, False),
    (4096, 1 << 20, 3, False), (65536, 1 << 22, 3, False),
    (4096, 300000, 3, True),
    (2, 13_000_000, 1, False)])  # more tiles than one block sums at once
def test_reduce_rows_kernel_is_bit_equal_to_cpu_plain(cuda, rows, lanes,
                                                       channels, one_row):
    """K8 in both regimes (up to 128 rows: tiles; above: sorted runs) is
    bit-equal to its plain version on the host CPU; one launch a call."""
    from mitransient_tpu_torch.ops import gather as G

    rng = np.random.default_rng(rows + lanes + channels)
    g = torch.from_numpy(rng.normal(size=(lanes, channels)).astype(np.float32))
    idx = torch.from_numpy((np.full(lanes, rows // 2) if one_row else
                            rng.integers(0, rows, lanes)).astype(np.int64))
    reset_launch_counts()
    got = G.reduce_rows(g.to(cuda), idx.to(cuda), rows)
    torch.cuda.synchronize()
    assert launch_counts() == {"reduce_rows": 1}
    assert _bit_equal(got.cpu(), G.reduce_rows(g, idx, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("rows, others, run, channels", [
    (4096, 1 << 18, 3 << 19, 3), (4096, 10000, 30000, 12),
    (200, 500, 1023, 2), (200, 500, 1024, 5), (200, 500, 1025, 1),
    (4096, 3000, 32 * 1024 + 1, 3), (1310720, 1 << 18, 0, 3)])
def test_reduce_rows_kernel_long_runs(cuda, rows, others, run, channels):
    """K8's sorted runs with one run of ``run`` lanes (at random lanes)
    beside ``others`` uniform lanes: runs across the 1024-lane chunks, a
    run of millions, 5 and 12 channels (blocks of 4), -0 cotangents among
    them; bit-equal to the plain version on the host CPU, one launch a
    call, and the same bits on a second call."""
    from mitransient_tpu_torch.ops import gather as G

    rng = np.random.default_rng(rows + others + run + channels)
    n = others + run
    g = rng.random((n, channels), dtype=np.float32)
    g[rng.random(n) < 0.05] = -0.0
    idx = rng.integers(0, rows, n)
    idx[rng.permutation(n)[:run]] = 7
    g, idx = torch.from_numpy(g), torch.from_numpy(idx)
    reset_launch_counts()
    got = [G.reduce_rows(g.to(cuda), idx.to(cuda), rows) for _ in range(2)]
    torch.cuda.synchronize()
    assert launch_counts() == {"reduce_rows": 2}
    assert _bit_equal(got[0].cpu(), G.reduce_rows(g, idx, rows))
    assert _bit_equal(got[1].cpu(), got[0].cpu())


@pytest.mark.cuda
def test_gather_rows_backward_launches_k8(cuda):
    """gather_rows' backward on the card goes through K8 and equals the
    CPU's bit for bit; its forward and jvp launch nothing."""
    from mitransient_tpu_torch.ops import gather as G

    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.normal(size=(6, 3)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 6, 5000))
    g = torch.from_numpy(rng.normal(size=(5000, 3)).astype(np.float32))
    grads = []
    for dev in ("cpu", cuda):
        t = table.to(dev).requires_grad_()
        reset_launch_counts()
        out = G.gather_rows(t, idx.to(dev))
        assert launch_counts() == {}
        grads.append(torch.autograd.grad(out, t, g.to(dev))[0].cpu())
    assert launch_counts() == {"reduce_rows": 1}
    assert _bit_equal(grads[1], grads[0])


@pytest.mark.cuda
def test_render_backward_on_cuda_is_reproducible(cuda):
    """Two render_backward calls on the card give the same tables bit for
    bit (PRB, full AD) and forward mode the same video; the PRB backward
    launches K8 and no table gradient reaches index_add_."""
    from torch_cases import grad_cbox

    adjoint = (None, np.random.default_rng(3).uniform(
        0.0, 1.0, (8, 8, 100, 3)).astype(np.float32))
    scene = mt.load_dict(grad_cbox(mt, 8, 8, 100, 3), device=cuda)
    for method in (None, "fullad"):
        runs = []
        for _ in range(2):
            reset_launch_counts()
            runs.append(mt.render_backward(scene, adjoint, spp=8, seed=0,
                                           method=method)["__tables__"])
            assert launch_counts().get("reduce_rows", 0) > 0, method
        for f in runs[0]._fields:
            a, b = getattr(runs[0], f), getattr(runs[1], f)
            assert (a is None) == (b is None)
            if a is not None:
                assert _bit_equal(a, b), (method, f)
    videos = [mt.render_forward(scene, {"white.reflectance.value":
                                        [1.0, 0.5, 0.25]}, spp=8, seed=0)
              for _ in range(2)]
    for a, b in zip(*videos):
        assert _bit_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma, channels, two_sets", [
    (2.0, 3, True), (0.5, 1, False), (1.5, 4, True)])
def test_gaussian_splat_kernel_is_bit_equal_to_cpu_plain(cuda, sigma,
                                                         channels, two_sets):
    """The gaussian temporal filter's splat (``gaussian_taps`` through K3 at
    spp * K lanes, one launch for both tap sets) is bit-equal to its plain
    version on the host CPU, taps made on the card included; SplatEvents'
    backward and jvp on the card equal the CPU's."""
    from torch.autograd import forward_ad as fwAD

    from mitransient_tpu_torch.scene.schema import FilmConfig

    rng = np.random.default_rng(int(sigma * 10) + channels)
    spp, hw, T = 6, 1000, 120
    cfg = FilmConfig(width=hw, height=1, temporal_bins=T, start_opl=1.0,
                     bin_width_opl=0.02)
    n = spp * hw
    taps, dev_taps = [], []
    for _ in range(2 if two_sets else 1):
        dist = torch.from_numpy(rng.uniform(0.9, 3.6, n).astype(np.float32))
        val = torch.from_numpy(rng.random((n, channels)).astype(np.float32))
        act = torch.from_numpy(rng.random(n) > 0.1)
        taps += list(tf.gaussian_taps(cfg, dist, val, act, sigma, spp))
        dev_taps += list(tf.gaussian_taps(
            cfg, dist.to(cuda), val.to(cuda), act.to(cuda), sigma, spp))
    assert all(_bit_equal(a.cpu(), b) for a, b in zip(dev_taps, taps))
    taps += [None] * (4 - len(taps))
    dev_taps += [None] * (4 - len(dev_taps))
    lanes = taps[0].shape[0] // hw
    shape = (channels, T + 1, hw)
    ref = torch.zeros(shape)
    tf.splat_accumulate(ref, *taps, spp=lanes)
    reset_launch_counts()
    film = torch.zeros(shape, device=cuda)
    tf.splat_accumulate(film, *dev_taps, spp=lanes)
    torch.cuda.synchronize()
    assert launch_counts() == {"splat_accumulate": 1}
    assert _bit_equal(film.cpu(), ref)
    # the Function's rules, card against CPU
    w = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    grads = []
    for dev, tp in (("cpu", taps), (cuda, dev_taps)):
        v = tp[1].clone().requires_grad_()
        out = tf.SplatEvents.apply(torch.zeros(shape, device=dev), tp[0],
                                   v * 1.0, tp[2], tp[3], lanes)
        grads.append(torch.autograd.grad((out * w.to(dev)).sum(), v)[0].cpu())
    assert _bit_equal(grads[1], grads[0])
    tan = torch.from_numpy(rng.normal(size=taps[1].shape).astype(np.float32))
    tangents = []
    with fwAD.dual_level():
        for dev, tp in (("cpu", taps), (cuda, dev_taps)):
            out = tf.SplatEvents.apply(
                torch.zeros(shape, device=dev), tp[0],
                fwAD.make_dual(tp[1], tan.to(dev)), tp[2], tp[3], lanes)
            tangents.append(fwAD.unpack_dual(out).tangent.cpu())
    assert _bit_equal(tangents[1], tangents[0])


# --------------------------------------------------------------------------
# The multi-pass render's pass graph (passgraph.py)
# --------------------------------------------------------------------------

_render_mod = importlib.import_module("mitransient_tpu_torch.render")


@pytest.fixture
def graphs(cuda):
    """No pass graph before the test; -> the graph counts made since."""
    passgraph.clear()
    before = dict(passgraph.STATS)
    yield lambda: {k: passgraph.STATS[k] - before[k] for k in before}
    passgraph.clear()


def _eager_render(scene, spp, seed, max_lanes, film_state=None,
                  checkpoint_callback=None):
    """``render(regenerate=False)`` with the pass body called directly and
    eagerly, as ``_multipass_render`` runs it without a graph ->
    (steady, transient, rays)."""
    cfg, icfg, var = scene.sensors[0], scene.integrator, scene.variant
    fc = cfg.film
    dw, dh = fc.data_width, fc.data_height
    chunk = max(1, min(spp, max_lanes // (dw * dh)))
    n_passes = -(-spp // chunk)
    chunk = -(-spp // n_passes)
    total = chunk * n_passes
    dev = scene.device
    sd, cam = primal_sd(scene.data), build_camera(cfg, device=dev)
    if film_state is None:
        film = tf.film_init_any(
            fc, film_channels(var),
            scan_pixels=dw * dh if fc.is_cropped else None, device=dev)
        done, rays = 0, 0
    else:
        film, done, rays = film_state
        film = type(film)(*(torch.as_tensor(a).to(dev, copy=True)
                            for a in film))
    keys = trng.pass_keys(seed, range(n_passes), dev)
    for p in range(done, n_passes):
        film, n = _render_mod._perspective_pass(
            sd, cam, film, keys[p], 1.0 / total, film_cfg=fc, icfg=icfg,
            width=dw, height=dh, spp_chunk=chunk, bvh_mode=bvh.BVH_MODE,
            variant=var)
        rays = rays + n
        if checkpoint_callback is not None:
            checkpoint_callback((type(film)(*(a.cpu().numpy().copy()
                                              for a in film)),
                                 p + 1, int(rays)))
    s, t = tf.develop_any(film, fc, shape_hw=(dh, dw))
    return s, t, int(rays)


def _graph_render(scene, **kw):
    """``render(regenerate=False)`` -> (steady, transient, rays)."""
    s, t, stats = mt.render(scene, regenerate=False, return_stats=True, **kw)
    return s, t, int(stats["rays"])


def _same_render(got, want):
    for a, b in zip(got[:2], want[:2]):
        assert a.device == b.device and a.shape == b.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert got[2] == want[2]


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["tiny", "full"])
def test_pass_graph_renders_two_seeds_bit_for_bit_like_the_eager_body(
        cuda, graphs, size):
    """Two seeds in a row through one graph: 3 passes each, of 4 samples
    on the 16x16 cbox_rgb config, of 32 on the 256x256 cbox (2^21 lanes,
    depth 8, 300 bins).  The first pass runs eagerly; the replays launch
    the same kernels, the threefry kernel on the graph's key."""
    desc, kw = ((small_cbox(mt), dict(spp=12, max_lanes=4 * 256))
                if size == "tiny" else
                (mt.cornell_box(), dict(spp=96, max_lanes=1 << 21)))
    scene = mt.load_dict(desc, device=cuda)
    depth = scene.integrator.max_depth
    for seed in (3, 2**32 - 1):
        reset_launch_counts()
        got = _graph_render(scene, seed=seed, **kw)
        counts = launch_counts()
        _same_render(got, _eager_render(scene, seed=seed, **kw))
        # each kernel launched once a bounce, replays included; a draw a
        # bounce and the camera's two draws a pass
        n = 3 * depth
        assert counts == {
            "closest_hit": n, "ray_test": n, "splat_accumulate": n,
            "threefry_uniform": 3 * (depth + 2)}
    assert graphs() == {"captures": 1, "replays": 2 + 3, "eager_passes": 1,
                        "refusals": 0, "eager_blocks": 0}


@pytest.mark.cuda
def test_pass_graph_takes_a_new_reflectance_without_a_capture(cuda, graphs):
    """A ``white.reflectance`` update between renders reaches the graph
    through its copy of the scene, as in an optimisation loop."""
    scene = mt.load_dict(small_cbox(mt), device=cuda)
    params = mt.traverse(scene)
    kw = dict(spp=12, seed=7, max_lanes=4 * 256)
    for value in ([0.15, 0.6, 0.25], [0.9, 0.1, 0.3]):
        params["white.reflectance.value"] = torch.tensor(value, device=cuda)
        params.update()
        _same_render(_graph_render(scene, **kw), _eager_render(scene, **kw))
    assert graphs()["captures"] == 1


@pytest.mark.cuda
def test_pass_graph_checkpoints_and_resumes_like_the_eager_body(cuda,
                                                                 graphs):
    """``checkpoint_callback`` gets each replayed pass's film; a render
    resumed from ``film_state`` through the graph is the uninterrupted
    one, and the eager resume."""
    scene = mt.load_dict(small_cbox(mt), device=cuda)
    kw = dict(spp=12, seed=4, max_lanes=4 * 256)
    states, eager_states = [], []
    got = _graph_render(scene, checkpoint_callback=states.append, **kw)
    _same_render(got, _eager_render(scene, checkpoint_callback=eager_states
                                  .append, **kw))
    assert [s[1:] for s in states] == [s[1:] for s in eager_states]
    for (film, _, _), (want, _, _) in zip(states, eager_states):
        for a, b in zip(film, want):
            assert np.array_equal(a.view(np.int32), b.view(np.int32))
    resumed = _graph_render(scene, film_state=states[1], **kw)
    _same_render(resumed, got)
    _same_render(resumed, _eager_render(scene, film_state=states[1], **kw))
    assert graphs() == {"captures": 1, "replays": 2 + 1, "eager_passes": 1,
                        "refusals": 0, "eager_blocks": 0}


@pytest.mark.cuda
def test_pass_graph_captures_again_for_a_new_spp_chunk(cuda, graphs):
    """A new spp chunk changes the lanes: a new capture."""
    scene = mt.load_dict(small_cbox(mt), device=cuda)
    for lanes in (4 * 256, 2 * 256):
        kw = dict(spp=12, seed=5, max_lanes=lanes)
        _same_render(_graph_render(scene, **kw), _eager_render(scene, **kw))
    assert graphs()["captures"] == 2


@pytest.mark.cuda
def test_pass_graph_leaves_a_kept_output_as_it_was(cuda, graphs):
    """Every render splats into a film of its own: outputs kept across
    the next renders (``s, t = render(...)`` in a loop) stay as they were,
    through one capture."""
    scene = mt.load_dict(small_cbox(mt), device=cuda)
    kw = dict(spp=12, max_lanes=2 * 256)
    kept = {seed: _graph_render(scene, seed=seed, **kw) for seed in (8, 9, 10)}
    for seed, got in kept.items():
        _same_render(got, _eager_render(scene, seed=seed, **kw))
    assert graphs() == {"captures": 1, "replays": 3 * 6 - 1,
                        "eager_passes": 1, "refusals": 0, "eager_blocks": 0}


def _graph_case(name):
    if name == "rgb_polarized":
        with with_variant(mt, name):
            return mt.load_dict(variant_case(mt, name), device="cuda")
    desc = small_cbox(mt)
    if name == "filters":  # chip_smoke.py phase 14's
        desc["integrator"].update(camera_unwarp=True,
                                  temporal_filter="gaussian",
                                  gaussian_stddev=1.5)
        desc["sensor"]["film"].update(
            rfilter={"type": "gaussian", "stddev": 0.6}, crop_offset_x=3,
            crop_offset_y=2, crop_width=10, crop_height=12)
    elif name == "warn":
        desc["sensor"]["film"].update(warn_negative=True, warn_invalid=True)
    elif name == "sphere":
        desc = small_sphere_cbox(mt)
    elif name == "materials":
        desc = materials_cbox(mt, 16, 16, 120, 6)
    return mt.load_dict(copy.deepcopy(desc), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rgb_polarized", "filters", "warn",
                                  "sphere", "materials"])
def test_pass_graph_takes_the_other_multipass_configs(cuda, graphs, name):
    """The polarized variant (a gold GGX box), camera_unwarp with both
    gaussian filters and a crop, the opt-in sample validation, a scene with
    an accel (the BVH kernel) and the materials flagship's gold GGX and
    glass boxes take the graph, bit for bit the eager body."""
    scene = _graph_case(name)
    fc = scene.sensors[0].film
    kw = dict(spp=6, max_lanes=2 * fc.data_width * fc.data_height)
    for seed in (1, 2):
        _same_render(_graph_render(scene, seed=seed, **kw),
                   _eager_render(scene, seed=seed, **kw))
    assert graphs()["captures"] == 1 and graphs()["replays"] > 0
    assert graphs()["refusals"] == 0


@pytest.mark.cuda
def test_pass_graph_refusal_is_counted_and_other_errors_are_raised(
        cuda, graphs, monkeypatch):
    """A capture refused (here: a body that makes a new transient film
    while it is captured) leaves the structure to the eager body, bit for
    bit, and is counted; an error that is no refusal, raised in the
    capture by the draw wrapper, reaches the caller, on the stream it
    called on."""
    scene = mt.load_dict(small_cbox(mt), device=cuda)
    kw = dict(spp=12, seed=6, max_lanes=4 * 256)
    body = _render_mod._perspective_pass

    def new_film(*a, **k):
        film, n_rays = body(*a, **k)
        if torch.cuda.is_current_stream_capturing():
            film = film._replace(transient=film.transient.clone())
        return film, n_rays

    monkeypatch.setattr(_render_mod, "_perspective_pass", new_film)
    for _ in range(2):
        _same_render(_graph_render(scene, **kw), _eager_render(scene, **kw))
    assert graphs() == {"captures": 0, "replays": 0, "eager_passes": 6,
                        "refusals": 1, "eager_blocks": 0}
    monkeypatch.undo()
    passgraph.clear()
    draw = trng._uniform_kernel

    def fail(*a):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a wrapper's error")
        return draw(*a)

    monkeypatch.setattr(trng, "_uniform_kernel", fail)
    stream = torch.cuda.current_stream()
    with pytest.raises(RuntimeError, match="a wrapper's error"):
        _graph_render(scene, **kw)
    assert torch.cuda.current_stream() == stream
    assert graphs()["refusals"] == 1 and graphs()["captures"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("channels, hw, lanes, bins", [
    (3, 256 * 256, 32, 300),  # the flagship's film and a pass's lanes
    (1, 301, 5, 40),  # rows not 16-byte aligned: no float4
    (12, 1000, 4, 400)])  # rgb_polarized
def test_splat_through_a_film_slot_matches_the_direct_launch(
        cuda, channels, hw, lanes, bins):
    """K3 reading the film's address from a device slot (as the pass
    graph's replays splat) is bit-equal to the launch that takes it as an
    argument, one ``splat_accumulate`` launch; a launch on another film
    inside ``splatting_at`` takes its own address."""
    rng = np.random.default_rng(channels + hw)
    ev = [torch.from_numpy(a).to(cuda) for _ in range(2)
          for a in splat_events(rng, lanes, hw, bins, channels)]
    init = torch.from_numpy(
        rng.random((channels, bins + 1, hw)).astype(np.float32)).to(cuda)
    want, got, other = init.clone(), init.clone(), init.clone()
    tf.splat_accumulate(want, *ev, spp=lanes)
    slot = torch.tensor([got.data_ptr()], dtype=torch.int64, device=cuda)
    placeholder = torch.full_like(got, float("nan"))  # what a capture names
    reset_launch_counts()
    with tf.splatting_at(placeholder, slot):
        tf.splat_accumulate(placeholder, *ev, spp=lanes)
        tf.splat_accumulate(other, *ev, spp=lanes)
    assert launch_counts() == {"splat_accumulate": 2}
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(other.view(torch.int32), want.view(torch.int32))
    assert bool(placeholder.isnan().all())


# --------------------------------------------------------------------------
# The regen loop's block graph (regengraph.py)
# --------------------------------------------------------------------------

def _regen_render(scene, graph=True, **kw):
    """``render(regenerate=True)`` through the graph route, or with the
    route closed (the plain loop on the render's own tensors) -> (steady,
    transient, rays, iters, loop_iters, launch counts)."""
    eligible = regengraph.eligible
    if not graph:
        regengraph.eligible = lambda *a: False
    reset_launch_counts()
    try:
        s, t, stats = mt.render(scene, regenerate=True, return_stats=True,
                                **kw)
    finally:
        regengraph.eligible = eligible
    return (s, t, int(stats["rays"]), int(stats["iters"]),
            stats["loop_iters"], launch_counts())


def _same_regen(got, want):
    _same_render(got[:3], want[:3])
    assert got[3:] == want[3:]


def _kernels(fn):
    """The CUDA kernels ``fn()`` runs, from the profiler's device trace."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower())


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["tiny", "full"])
def test_regen_graph_renders_two_seeds_bit_for_bit_like_the_eager_loop(
        cuda, graphs, size):
    """Two seeds in a row through one graph at 1024 spp: the 16x16
    cbox_rgb config at 4 lanes a pixel, and the 256x256 cbox (2^21 lanes,
    depth 8, 300 bins: 216 iterations, 27 blocks).  The first render runs
    its first block eagerly, captures, and replays the rest; the second
    replays every block.  K1-K3 are counted once an iteration, replays
    included, and the device runs the eager loop's kernels (the block's
    copy-backs are copies, not kernels)."""
    desc, kw = ((small_cbox(mt), dict(spp=1024, max_lanes=4 * 256))
                if size == "tiny" else (mt.cornell_box(), dict(spp=1024)))
    scene = mt.load_dict(desc, device=cuda)
    counts = []
    for seed in (3, 2**32 + 7):
        before = graphs()
        got = _regen_render(scene, seed=seed, **kw)
        counts.append({k: v - before[k] for k, v in graphs().items()})
        want = _regen_render(scene, graph=False, seed=seed, **kw)
        _same_regen(got, want)
        n = got[4]
        assert got[5] == {"closest_hit": n, "ray_test": n,
                          "splat_accumulate": n}
    whole, tail = divmod(got[4], path_regen.LIVE_CHECK_EVERY)
    assert counts[1] == {"captures": 0, "replays": whole, "eager_passes": 0,
                         "refusals": 0, "eager_blocks": int(tail > 0)}
    assert counts[0]["captures"] == 1 and counts[0]["refusals"] == 0
    assert counts[0]["eager_blocks"] == 1 + int(tail > 0)
    if size == "full":
        assert got[4] == 216 and counts[1]["replays"] == 27
        assert counts[0]["replays"] == 26
        graph_kernels = _kernels(lambda: _regen_render(scene, seed=5, **kw))
        eager_kernels = _kernels(lambda: _regen_render(scene, graph=False,
                                                       seed=5, **kw))
        print(f"kernels a render: graph {graph_kernels}, eager "
              f"{eager_kernels}")
        assert eager_kernels <= graph_kernels <= 1.01 * eager_kernels


def _regen_graph_case(name):
    if name == "mono_polarized":
        with with_variant(mt, name):
            return mt.load_dict(polarized_regen_cbox(), device="cuda")
    if name == "sphere":
        return mt.load_dict(small_sphere_cbox(mt), device="cuda")
    return mt.load_dict(copy.deepcopy(small_cbox(mt)), device="cuda")


def polarized_regen_cbox():
    from torch_cases import polarized_cbox

    return polarized_cbox(mt, 32, 120, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("name, period", [("mono_polarized", 8),
                                          ("sphere", 8), ("rgb", 1)])
def test_regen_graph_takes_the_other_regen_configs(cuda, graphs, monkeypatch,
                                                   name, period):
    """The polarized variant (a gold GGX box, the Mueller carry and its
    pending rotator), a scene with an accel (the BVH kernel) and a block of
    one iteration (``LIVE_CHECK_EVERY`` = 1) take the graph, bit for bit
    the eager loop."""
    monkeypatch.setattr(path_regen, "LIVE_CHECK_EVERY", period)
    scene = _regen_graph_case(name)
    kw = dict(spp=64, max_lanes=4 * scene.sensors[0].film.width
              * scene.sensors[0].film.height)
    for seed in (1, 2):
        _same_regen(_regen_render(scene, seed=seed, **kw),
                    _regen_render(scene, graph=False, seed=seed, **kw))
    assert graphs()["captures"] == 1 and graphs()["replays"] > 0
    assert graphs()["refusals"] == 0


@pytest.mark.cuda
def test_regen_graph_leaves_a_kept_output_as_it_was(cuda, graphs):
    """Every render splats into a film of its own and returns copies of
    its ray and iteration counts: outputs kept across the next renders stay
    as they were."""
    scene = mt.load_dict(small_cbox(mt), device=cuda)
    kw = dict(spp=64, max_lanes=4 * 256)
    kept = {seed: _regen_render(scene, seed=seed, **kw) for seed in (8, 9, 10)}
    for seed, got in kept.items():
        _same_regen(got, _regen_render(scene, graph=False, seed=seed, **kw))
    assert graphs()["captures"] == 1


@pytest.mark.cuda
def test_regen_graph_refusal_is_counted_and_other_errors_are_raised(
        cuda, graphs, monkeypatch):
    """A capture refused (here: a splat that makes a new transient film
    while it is captured) leaves the structure to eager blocks on the
    graph's buffers, bit for bit, and is counted; an error that is no
    refusal, raised in the capture, reaches the caller on the stream it
    called on."""
    scene = mt.load_dict(small_cbox(mt), device=cuda)
    kw = dict(spp=64, seed=6, max_lanes=4 * 256)
    splat = path_regen.splat_pair_any

    def new_film(*a, **k):
        film = splat(*a, **k)
        if torch.cuda.is_current_stream_capturing():
            film = film._replace(transient=film.transient.clone())
        return film

    monkeypatch.setattr(path_regen, "splat_pair_any", new_film)
    want = _regen_render(scene, graph=False, **kw)
    before = graphs()
    for _ in range(2):
        _same_regen(_regen_render(scene, **kw), want)
    counted = {k: v - before[k] for k, v in graphs().items()}
    blocks = -(-want[4] // path_regen.LIVE_CHECK_EVERY)
    assert counted == {"captures": 0, "replays": 0, "eager_passes": 0,
                       "refusals": 1, "eager_blocks": 2 * blocks}

    def fail(*a, **k):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a wrapper's error")
        return splat(*a, **k)

    monkeypatch.setattr(path_regen, "splat_pair_any", fail)
    passgraph.clear()
    stream = torch.cuda.current_stream()
    with pytest.raises(RuntimeError, match="a wrapper's error"):
        _regen_render(scene, **kw)
    assert torch.cuda.current_stream() == stream
    assert graphs()["refusals"] == 1 and graphs()["captures"] == 0


@pytest.mark.cuda
def test_a_multipass_render_frees_the_regen_graph(cuda, graphs):
    """One graph a device: a multi-pass render after a regen render
    replaces the regen graph (its buffers freed), so the memory allocated
    comes back to its level before the regen render; and a regen render
    replaces the pass graph."""
    scene = mt.load_dict(mt.cornell_box(), device=cuda)
    regen = dict(spp=128, seed=1)
    multipass = dict(spp=64, seed=2, regenerate=False)

    def render(kw):
        out = mt.render(scene, **kw)
        del out
        torch.cuda.synchronize()
        return next(iter(passgraph._GRAPHS.values()))

    for kw in (multipass, regen, multipass):  # every cache warm
        render(kw)
    before = torch.cuda.memory_allocated()
    g = render(regen)
    assert isinstance(g, regengraph.RegenGraph) and g.graph is not None
    ref = weakref.ref(g)
    del g
    assert isinstance(render(multipass), passgraph.PassGraph)
    gc.collect()
    assert ref() is None
    assert torch.cuda.memory_allocated() == before
    assert graphs()["captures"] == 5
