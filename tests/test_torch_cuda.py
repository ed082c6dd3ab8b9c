"""CUDA kernels of the PyTorch port (K1-K3, the BVH kernel, K8 and the
gaussian temporal filter's splat) against their plain versions.

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
bit.
"""
import numpy as np
import pytest
import torch

import mitransient_tpu_torch as mt
from mitransient_tpu_torch.convert import scene_data_from_numpy, scene_data_to_numpy
from mitransient_tpu_torch.film import transient_film as tf
from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts
from mitransient_tpu_torch.ops import bvh
from mitransient_tpu_torch.ops import intersect as isect
from mitransient_tpu_torch.ops import accel as TA
from mitransient_tpu_torch.ops.accel import build_accel
from mitransient_tpu_torch.sensors.perspective import build_camera
from torch_cases import (
    box_rays,
    golden_mismatch,
    material_case,
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
    variant_render,
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
    each kernel launches once per bounce of each pass, the images agree
    with the CPU under the golden rule, and a resumed render is bit for
    bit the uninterrupted one; the threefry draw is bit-equal to the
    CPU's."""
    from mitransient_tpu_torch.core import rng

    kw = dict(spp=12, seed=1, max_lanes=4 * 256, regenerate=False)
    out = {}
    for dev in ("cpu", cuda):
        scene = mt.load_dict(small_cbox(mt), device=dev)
        states = []
        reset_launch_counts()
        s, t, stats = mt.render(scene, return_stats=True,
                                checkpoint_callback=states.append, **kw)
        counts = launch_counts()
        s2, t2 = mt.render(scene, film_state=states[1], **kw)
        assert torch.equal(s2, s) and torch.equal(t2, t)
        out[str(dev)] = (s.cpu().numpy(), t.cpu().numpy(), stats, counts)
    s_c, t_c, _, counts_c = out["cpu"]
    s_g, t_g, stats_g, counts_g = out[str(cuda)]
    n = stats_g["loop_iters"]
    assert counts_c == {} and n == 3 * 6
    assert counts_g == {"closest_hit": n, "ray_test": n, "splat_accumulate": n}
    for got, want in ((s_g, s_c), (t_g, t_c)):
        m = golden_mismatch(got, want)
        assert m["shape_ok"] and m["n_bad"] == 0, m
    key = rng.Sampler(3, 1, 2).key
    assert torch.equal(rng.draw_bounce_block(key, 5, 4099, 6, cuda).cpu(),
                       rng.draw_bounce_block(key, 5, 4099, 6))


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
        out[str(dev)] = mt.render(mt.load_dict(desc, device=dev), **kw)
        counts = launch_counts()
    depth = desc["integrator"]["max_depth"]
    assert counts == {"closest_hit": 5 * depth, "splat_accumulate": depth}
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
