"""The port's acceleration structure and BVH queries against the JAX
package on the CPU.

- ``build_accel`` builds the very tables of ``mitransient_tpu.ops.accel``
  (``np.array_equal`` on every field): same native SAH builder, same numpy;
  the port's own trees are the ones built from the JAX chunk and
  super-chunk bounds.
- ``query_plain`` (the plain version of the BVH kernel) against the JAX
  package's Pallas BVH kernels in interpret mode, on ``_soup``-sized inputs
  (tests/test_accel.py:18-26; interpret mode takes seconds per query).
  Equal ``prim`` (occlusion for any-hit rays); ``t`` within rtol 3e-5:
  XLA:CPU contracts ``a*b + c`` into FMA and the port does not (ROADMAP
  queue 3), and the Woop ``s_z = a2 . o - c_z`` cancels by up to ~350x on
  this soup (origins and triangles up to 10 units from the origin), so
  the two roundings of ``t`` part by up to 1.7e-5 relative while each
  stays within 1e-5 of the float64 value.
- ``query_plain`` against the port's brute-force ``intersect_soup`` on the
  4,512-triangle sphere: the rule of ``_same_hits(rel=1e-3)`` of
  tests/test_accel.py plus equal ``prim``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitransient_tpu.ops import accel as JA
from mitransient_tpu.ops import bvh_pallas as BP
from mitransient_tpu_torch import native
from test_accel import _same_hits, _soup
from mitransient_tpu_torch.ops import accel as TA
from mitransient_tpu_torch.ops import bvh
from mitransient_tpu_torch.ops.intersect import intersect_soup, ray_test_soup
from torch_cases import SPHERE_CENTER, SPHERE_RADIUS, uv_sphere

torch.set_num_threads(1)


def _sphere_soup():
    verts, faces = uv_sphere(48, 48, SPHERE_RADIUS, SPHERE_CENTER)
    p = verts.astype(np.float32)[faces]
    return p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]


def _pad_chunk_soup():
    """tests/test_accel.py:test_phantom_pad_chunks_near_origin: about 3
    chunks of geometry near x = 10, so the last super-chunk is padded."""
    rng = np.random.RandomState(7)
    v0 = (np.array([10.0, 0.0, 0.0])
          + rng.uniform(-2, 2, (3 * JA.CHUNK_TRIS, 3))).astype(np.float32)
    e1 = rng.uniform(-0.3, 0.3, v0.shape).astype(np.float32)
    e2 = rng.uniform(-0.3, 0.3, v0.shape).astype(np.float32)
    return v0, e1, e2


def _rays(soup, n, seed):
    """Rays from around the soup: half aimed at random triangles' centroids
    (so that most hit), half in random directions; a tenth inactive, a
    quarter with a finite maxt."""
    v0, e1, e2 = soup
    rng = np.random.RandomState(seed)
    lo, hi = v0.min(0) - 1.0, v0.max(0) + 1.0
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    k = n // 2
    tgt = rng.randint(0, v0.shape[0], k)
    d[:k] = v0[tgt] + (e1[tgt] + e2[tgt]) / 3.0 - o[:k]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    maxt = np.full(n, np.inf, np.float32)
    short = rng.rand(n) < 0.25
    maxt[short] = rng.uniform(0.5, 8.0, short.sum()).astype(np.float32)
    active = rng.rand(n) >= 0.1
    return o, d, maxt, active


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("case", ["soup", "sphere", "pad_chunks"])
def test_build_accel_equals_jax(case):
    soup = {"soup": _soup, "sphere": _sphere_soup,
            "pad_chunks": _pad_chunk_soup}[case]()
    assert native.available()
    want = JA.build_accel(*soup)
    got = TA.build_accel(*soup, device="cpu")
    assert got._fields == want._fields + TA.TREE_FIELDS
    tree = TA.accel_trees(*(np.asarray(getattr(want, f)) for f in
                            ("aabb_min", "aabb_max", "sup_min", "sup_max")))
    for f in got._fields:
        w = tree[f] if f in tree else np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    if case == "pad_chunks":
        assert got.pages.shape[0] % TA.SUPER_CHUNKS != 0


def test_native_bvh_builders_match_python_contract():
    """Both native builders and the Python fallback cover every triangle
    once, in subtree-contiguous ranges that _subtree_ranges can cut."""
    v0, e1, e2 = _soup(2, 100)
    for method in ("sah", "median"):
        glob = native.build_bvh(v0, e1, e2, leaf_size=8, method=method)
        assert sorted(glob["prim_order"]) == list(range(v0.shape[0]))
        TA._subtree_ranges(glob, v0.shape[0], 2 * TA.CHUNK_TRIS)
    py = native._build_bvh_py(v0, e1, e2, leaf_size=8)
    assert sorted(py["prim_order"]) == list(range(v0.shape[0]))
    ranges = TA._subtree_ranges(py, v0.shape[0], 64)
    assert max(b - a for a, b in ranges) <= 64


def _compare(t_got, p_got, t_want, p_want, n_closest):
    p_got, t_got = p_got.numpy(), t_got.numpy()
    p_want, t_want = np.asarray(p_want), np.asarray(t_want)
    closest = np.arange(p_got.shape[0]) < n_closest
    np.testing.assert_array_equal(p_got[closest], p_want[closest])
    np.testing.assert_array_equal(p_got[~closest] >= 0, p_want[~closest] >= 0)
    hit = closest & (p_got >= 0)
    np.testing.assert_allclose(t_got[hit], t_want[hit], rtol=3e-5, atol=0)
    np.testing.assert_array_equal(np.isinf(t_got[closest]),
                                  np.isinf(t_want[closest]))
    assert (p_got >= 0).sum() > 50 and (p_got < 0).any()


@pytest.mark.parametrize("query", ["closest", "any", "mixed"])
def test_chunk_query_matches_jax_interpret(query):
    soup = _soup(4, 150)
    acc_j = JA.build_accel(*soup)
    acc_t = TA.build_accel(*soup, device="cpu")
    n = 384
    o, d, maxt, act = _rays(soup, n, seed=5)
    if query == "closest":
        t_w, p_w = BP.closest_hit_bvh(acc_j, *_j(o, d, maxt, act),
                                      interpret=True)
        n_closest = n
    elif query == "any":
        occ = np.asarray(BP.ray_test_bvh(acc_j, *_j(o, d, maxt, act),
                                         interpret=True))
        t_w, p_w = np.zeros(n, np.float32), np.where(occ, 0, -1)
        n_closest = 0
    else:
        n_closest = n // 2
        t_w, p_w = BP.mixed_query_bvh(acc_j, *_j(o, d, maxt, act),
                                      n_closest=n_closest, interpret=True)
    t_g, p_g = bvh.query_plain(acc_t, *_t(o, d, maxt, act), n_closest, "chunk")
    _compare(t_g, p_g, t_w, p_w, n_closest)
    if query != "closest":  # any-hit rays collapse t, as the JAX package's
        anyhit = (np.arange(n) >= n_closest) & (p_g.numpy() >= 0)
        assert anyhit.any() and (t_g.numpy()[anyhit] == -bvh.BIG).all()


@pytest.mark.parametrize("occlusion", [False, True])
def test_super_query_matches_jax_interpret(occlusion):
    """``_query_super`` is called directly: the JAX package's jitted entry
    points read its module-wide BVH_MODE at trace time."""
    soup = _soup(4, 150)
    acc_j = JA.build_accel(*soup)
    acc_t = TA.build_accel(*soup, device="cpu")
    n = 256
    o, d, maxt, act = _rays(soup, n, seed=6)
    t_w, p_w = BP._query_super(acc_j, *_j(o, d, maxt, act),
                               occlusion=occlusion, interpret=True)
    n_closest = 0 if occlusion else n
    t_g, p_g = bvh.query_plain(acc_t, *_t(o, d, maxt, act), n_closest, "super")
    _compare(t_g, p_g, t_w, p_w, n_closest)


@pytest.mark.parametrize("mode", bvh.MODES)
def test_query_plain_matches_brute_force_on_the_sphere(mode):
    soup = _sphere_soup()
    acc = TA.build_accel(*soup, device="cpu")
    assert acc.pages.shape[0] > 8  # more than one super-chunk
    n = 1500
    o, d, maxt, act = _rays(soup, n, seed=8)
    args = _t(*soup, o, d, maxt, act)
    t_b, p_b, _, _ = intersect_soup(*args)
    t_q, p_q = bvh.query_plain(acc, *_t(o, d, maxt, act), n, mode)
    assert _same_hits(t_b.numpy(), t_q.numpy())
    np.testing.assert_array_equal(p_q.numpy(), p_b.numpy())
    assert (p_q >= 0).float().mean() > 0.3
    occ = ray_test_soup(*args)
    _, p_o = bvh.query_plain(acc, *_t(o, d, maxt, act), 0, mode)
    np.testing.assert_array_equal((p_o >= 0).numpy(), occ.numpy())
    # the public queries take the plain version for CPU tensors
    t_c, p_c = bvh.closest_hit_bvh(acc, *_t(o, d, maxt, act), mode)
    occ_c = bvh.ray_test_bvh(acc, *_t(o, d, maxt, act), mode=mode)
    assert torch.equal(t_c, t_q) and torch.equal(p_c, p_q)
    assert torch.equal(occ_c, occ)


def test_reference_walk_matches_query_plain():
    soup = _soup()
    acc = TA.build_accel(*soup, device="cpu")
    o, d, maxt, act = _rays(soup, 200, seed=3)
    maxt = np.where(act, maxt, -np.inf).astype(np.float32)
    rt, rp = TA.closest_hit_reference(acc, o, d, maxt)
    t, p = bvh.query_plain(acc, *_t(o, d, maxt, np.ones(200, bool)), 200)
    np.testing.assert_array_equal(rp, p.numpy())
    assert _same_hits(rt, t.numpy())


def test_query_kernel_refuses_cpu_tensors_and_bad_modes():
    soup = _soup(2, 100)
    acc = TA.build_accel(*soup, device="cpu")
    rays = _t(*_rays(soup, 8, seed=1))
    with pytest.raises(ValueError, match="expected cuda"):
        bvh.query_kernel(acc, *rays, 8)
    with pytest.raises(ValueError, match="mode"):
        bvh.query_plain(acc, *rays, 8, "tree")
