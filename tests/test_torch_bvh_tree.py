"""The trees of the port's Accel (``ops/accel.py:chunk_tree`` over the
chunk boxes and over the super-chunk boxes), the best-first order in which
the BVH kernel walks them, and the kernels' other loops, on the CPU.

- Tree invariants: preorder numbering, every node a contiguous range of
  leaf ids, leaves the boxes 0..K-1 in order, and each inner node's box
  the exact float32 min/max of its children's; for the chunk tree and for
  the super tree.
- The loader's trees (``build_accel_numpy``) equal the trees of the JAX
  package's Accel carried across by ``convert.py`` (small sphere config,
  4,512 triangles).
- A scalar emulator of the kernel's traversal (``csrc/bvh.cu:BestFirst``:
  the queue of (tn, node) keys, the nearer child kept out of the queue, a
  full queue handing the ray to the linear pick from its gate) visits the
  same leaves in the same order as the linear pick of
  ``ops/bvh.py:query_plain``: chunks (chunk mode) and super-chunks whose
  <= 8 chunks are slab-tested and swept in id order (super mode); on a few
  hundred random rays, on hand-made ties (duplicate and face-sharing
  boxes, equal entries), on slivers whose rays overflow the kernel's
  16-entry queue, and with queues small enough to overflow everywhere.
  Slab and Woop tests are float32 numpy in the kernel's order of
  operations, so the comparisons are exact.
- A scalar emulator of super mode's page sweep shared by the warp
  (``csrc/bvh.cu:warp_sweep``: 32 triangles a step, the least (t bits,
  position), the first lane of a ballot for any-hit rays) against the
  sequential sweep, of K2's loop (``csrc/intersect.cu:any_hit_kernel``: a
  block lists its rays that need tests, one a thread, staged chunks)
  against ``ray_test_soup``, and of K1's (``closest_hit_kernel``: the
  block's list, one ray a thread, staged chunks, a strict '<' per ray)
  against ``intersect_soup``.
"""
import numpy as np
import pytest
import torch

import mitransient_tpu as mitr
import mitransient_tpu_torch as mt
from mitransient_tpu_torch.convert import scene_data_from_numpy
from mitransient_tpu_torch.ops import accel as TA
from mitransient_tpu_torch.ops import bvh
from mitransient_tpu_torch.ops import intersect as isect
from mitransient_tpu_torch.ops.intersect import intersect_soup
from test_torch_scene import jax_leaves
from torch_cases import (
    SPHERE_CENTER,
    SPHERE_RADIUS,
    overlapping_rays,
    overlapping_soup,
    random_rays,
    random_soup,
    small_sphere_cbox,
    uv_sphere,
)

torch.set_num_threads(1)

F32 = np.float32
EPS = F32(bvh.RAY_EPS)


def _sphere_soup(rings=48):
    verts, faces = uv_sphere(rings, rings, SPHERE_RADIUS, SPHERE_CENTER)
    p = verts.astype(F32)[faces]
    return p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]


def _random_boxes(rng, c):
    lo = rng.uniform(-1, 1, (c, 3)).astype(F32)
    return lo, lo + rng.uniform(0, 0.6, (c, 3)).astype(F32)


def _tie_boxes():
    """Duplicate boxes, boxes that share a face and boxes of equal entry
    along the axes, on a grid, so that equal (tn) keys are common."""
    lo, hi = [], []
    for x in range(3):
        for y in range(2):
            lo.append([x, y, 0.0])
            hi.append([x + 1, y + 1, 1.0])  # face-sharing neighbours
    lo += [lo[0], lo[4], lo[0]]  # duplicates
    hi += [hi[0], hi[4], hi[0]]
    lo.append([0.0, 0.0, 0.0])
    hi.append([3.0, 2.0, 0.5])  # same entry as the grid from -z
    return np.array(lo, F32), np.array(hi, F32)


def _ranges(link):
    """(first chunk, end chunk) of every node, from the preorder links."""
    n = link.shape[0]
    first = np.zeros(n, np.int64)
    end = np.zeros(n, np.int64)
    for i in range(n - 1, -1, -1):
        if link[i] < 0:
            first[i] = end[i] = -1 - link[i]
            end[i] += 1
        else:
            first[i], end[i] = first[i + 1], end[link[i]]
    return first, end


@pytest.mark.parametrize("case", ["sphere", "random", "ties", "one", "two",
                                  "super", "super_slivers"])
def test_tree_invariants(case):
    rng = np.random.default_rng(0)
    if case == "sphere":
        host = TA.build_accel_numpy(*_sphere_soup())
        lo, hi = host["aabb_min"], host["aabb_max"]
        assert host["tree_box"].shape == (2 * lo.shape[0] - 1, 6)
    elif case.startswith("super"):  # the super tree over the super boxes
        soup = (_sphere_soup(80) if case == "super"
                else overlapping_soup(np.random.default_rng(5), 100000))
        host = TA.build_accel_numpy(*soup)
        lo, hi = host["sup_min"], host["sup_max"]
        assert lo.shape[0] >= 4
        tree = TA.chunk_tree(lo, hi)
        for f in ("tree_box", "tree_link"):
            np.testing.assert_array_equal(host["sup_" + f], tree[f])
    else:
        lo, hi = {"random": lambda: _random_boxes(rng, 57),
                  "ties": _tie_boxes,
                  "one": lambda: _random_boxes(rng, 1),
                  "two": lambda: _random_boxes(rng, 2)}[case]()
    tree = TA.chunk_tree(lo, hi)
    box, link = tree["tree_box"], tree["tree_link"]
    c = lo.shape[0]
    assert box.dtype == np.float32 and link.dtype == np.int32
    assert box.shape == (2 * c - 1, 6) and link.shape == (2 * c - 1,)
    leaves = np.nonzero(link < 0)[0]
    # preorder: leaves appear as chunks 0..C-1 in order
    np.testing.assert_array_equal(-1 - link[leaves], np.arange(c))
    np.testing.assert_array_equal(box[leaves, :3], lo)
    np.testing.assert_array_equal(box[leaves, 3:], hi)
    first, end = _ranges(link)
    assert first[0] == 0 and end[0] == c
    for i in np.nonzero(link >= 0)[0]:
        a, b = i + 1, link[i]
        assert i < a < b < 2 * c - 1
        # contiguous: the left range ends where the right one starts
        assert first[a] == first[i] and end[a] == first[b] and end[b] == end[i]
        assert b == i + 2 * (end[a] - first[a])  # after the left subtree
        np.testing.assert_array_equal(box[i, :3],
                                      np.minimum(box[a, :3], box[b, :3]))
        np.testing.assert_array_equal(box[i, 3:],
                                      np.maximum(box[a, 3:], box[b, 3:]))


def test_tree_from_loader_equals_tree_carried_across_from_jax():
    """Both trees, the chunk tree and the super tree."""
    desc = small_sphere_cbox(mt)
    tsc = mt.load_dict(desc, device="cpu")
    carried = scene_data_from_numpy(jax_leaves(mitr.load_dict(desc).data),
                                    device="cpu")
    assert tsc.data.tri.v0.shape[0] == 4512 + 24
    assert set(TA.TREE_FIELDS) <= set(TA.Accel._fields)
    assert tsc.data.accel.sup_tree_link.shape == (
        2 * tsc.data.accel.sup_min.shape[0] - 1,)
    for f in TA.Accel._fields:
        assert torch.equal(getattr(carried.accel, f),
                           getattr(tsc.data.accel, f)), f


# --------------------------------------------------------------------------
# Scalar emulator of the kernel's chunk-mode traversal
# --------------------------------------------------------------------------

def _inv(d):
    d = np.asarray(d, F32)
    tiny = np.where(d < 0, F32(-1e-12), F32(1e-12))
    return F32(1.0) / np.where(np.abs(d) < F32(1e-12), tiny, d)


def _slab(box, o, inv):
    """(tn, tf) of rows of a (K, 6) box table, in the kernel's float32
    order: (b - o) * inv, then min/max."""
    t0 = (box[:, :3] - o) * inv
    t1 = (box[:, 3:] - o) * inv
    lo, hi = np.minimum(t0, t1), np.maximum(t0, t1)
    tn = np.maximum(np.maximum(lo[:, 0], lo[:, 1]), np.maximum(lo[:, 2], EPS))
    tf = np.minimum(np.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    return tn, tf


def linear_order(tn, tf, sweep, best_t, gate=(-np.inf, -1)):
    """The linear pick of query_plain over chunk entries tn, tf (C,), from
    the gate (tn, chunk) on: -> (swept chunks, best_t)."""
    swept = []
    while True:
        cand = [(tn[k], k) for k in range(tn.shape[0])
                if tn[k] <= tf[k] and tn[k] < best_t and (tn[k], k) > gate]
        if not cand:
            return swept, best_t
        gate = min(cand)
        swept.append(gate[1])
        best_t, stop = sweep(gate[1], best_t)
        if stop:
            return swept, best_t


def best_first_order(tn, tf, link, sweep, best_t, queue_size):
    """bvh_tree_kernel's traversal over node entries tn, tf (2C-1,): ->
    (swept chunks, best_t, whether the queue overflowed)."""
    leaf = link < 0  # leaves are the chunks in order
    swept, queue, gate = [], [], (-np.inf, -1)  # queue: sorted keys
    cur = (tn[0], 0) if tn[0] <= tf[0] and tn[0] < best_t else None
    overflow = False

    def push(key):  # False when the queue is full
        if len(queue) == queue_size:
            return False
        queue.append(key)
        queue.sort()
        return True

    while cur is not None:
        if not cur[0] < best_t:
            break
        node = cur[1]
        if link[node] < 0:
            chunk = -1 - int(link[node])
            gate = (cur[0], chunk)
            swept.append(chunk)
            best_t, stop = sweep(chunk, best_t)
            if stop:
                return swept, best_t, overflow
        else:
            kids = sorted((tn[k], k) for k in (node + 1, int(link[node]))
                          if tn[k] <= tf[k] and tn[k] < best_t)
            if len(kids) == 2 and not push(kids[1]):
                overflow = True
                break
            if kids and (not queue or kids[0] < queue[0]):
                cur = kids[0]
                continue
            if kids and not push(kids[0]):
                overflow = True
                break
        cur = queue.pop(0) if queue else None
    if overflow:
        more, best_t = linear_order(tn[leaf], tf[leaf], sweep, best_t, gate)
        swept += more
    return swept, best_t, overflow


def _woop_sweep(acc, o, d, any_hit):
    """sweep(chunk, best_t) through query_plain's own Woop test."""
    c, rows, width = acc.pages.shape
    pages16 = acc.pages.reshape(c, rows * width // 16, 16)
    o_t, d_t = torch.from_numpy(o[None]), torch.from_numpy(d[None])
    ah = torch.tensor([any_hit])
    prim = [-1]

    def sweep(chunk, best_t):
        bt, bp, hit = bvh._sweep(pages16, torch.tensor([chunk]), o_t, d_t,
                                 torch.tensor([best_t], dtype=torch.float32),
                                 torch.tensor([prim[0]], dtype=torch.int32),
                                 ah)
        prim[0] = int(bp[0])
        return F32(bt[0]), bool(hit[0]) and any_hit

    return sweep, prim


def _box_rays(rng, lo, hi, n):
    """Rays from around the boxes' hull, half aimed into it."""
    a, b = lo.min(0) - 1.0, hi.max(0) + 1.0
    o = rng.uniform(a, b, (n, 3)).astype(F32)
    d = rng.normal(size=(n, 3))
    k = n // 2
    d[:k] = rng.uniform(lo.min(0), hi.max(0), (k, 3)) - o[:k]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(F32)
    return o, d


@pytest.mark.parametrize("query", ["closest", "any"])
@pytest.mark.parametrize("scene", ["sphere", "slivers"])
def test_best_first_sweeps_the_linear_picks_chunks(scene, query):
    """Real chunks and Woop sweeps: the emulated kernel and the linear pick
    sweep the same chunks in the same order, and end with query_plain's
    t and prim.  On ``overlapping_soup``'s slivers some rays fill the
    kernel's 16-entry queue and finish with the linear pick."""
    rng = np.random.default_rng(11)
    n = 300 if scene == "sphere" else 400
    if scene == "sphere":
        acc = TA.build_accel(*_sphere_soup(), device="cpu")
        o, d = _box_rays(rng, acc.aabb_min.numpy(), acc.aabb_max.numpy(), n)
        maxt = np.where(rng.random(n) < 0.2, rng.uniform(0.1, 1.0, n),
                        np.inf).astype(F32)
    else:
        acc = TA.build_accel(*overlapping_soup(np.random.default_rng(5)),
                             device="cpu")
        o, d, maxt, _ = overlapping_rays(np.random.default_rng(6), n)
    box, link = acc.tree_box.numpy(), acc.tree_link.numpy()
    any_hit = query == "any"
    t_p, p_p = bvh.query_plain(acc, *map(torch.from_numpy, (o, d, maxt)),
                               torch.ones(n, dtype=torch.bool),
                               0 if any_hit else n)
    visits = overflows = 0
    for i in range(n):
        tn, tf = _slab(box, o[i], _inv(d[i]))
        leaf = link < 0
        best0 = min(maxt[i], F32(bvh.BIG))
        sweep, prim = _woop_sweep(acc, o[i], d[i], any_hit)
        want, _ = linear_order(tn[leaf], tf[leaf], sweep, best0)
        sweep, prim = _woop_sweep(acc, o[i], d[i], any_hit)
        got, best_t, over = best_first_order(tn, tf, link, sweep, best0, 16)
        assert got == want, i
        assert prim[0] == int(p_p[i]), i
        if prim[0] >= 0:
            assert best_t == (F32(-bvh.BIG) if any_hit else t_p[i].item()), i
        visits += len(got)
        overflows += over
    assert visits > n // 2 and (p_p >= 0).sum() > n // 5
    assert (overflows > 0) == (scene == "slivers")


def _synthetic_sweep(hit_t):
    """sweep(chunk, best_t) with one hit per chunk at hit_t[chunk] (inf:
    none), some of them below the chunk's entry."""
    def sweep(chunk, best_t):
        return (hit_t[chunk] if hit_t[chunk] < best_t else best_t), False
    return sweep


@pytest.mark.parametrize("case", ["ties", "random", "overlap"])
@pytest.mark.parametrize("queue_size", [1, 2, 16])
def test_best_first_order_equals_linear_pick(case, queue_size):
    """Hand-made ties, random boxes and boxes that all overlap (so that
    the queue of every ray from outside fills): the emulated kernel sweeps
    the linear pick's chunks in its order, whatever the queue size, and
    small queues do overflow."""
    rng = np.random.default_rng({"ties": 1, "random": 2, "overlap": 3}[case])
    if case == "ties":
        lo, hi = _tie_boxes()
    elif case == "random":
        lo, hi = _random_boxes(rng, 40)
    else:
        lo = rng.uniform(-1.0, -0.8, (40, 3)).astype(F32)
        hi = rng.uniform(0.8, 1.0, (40, 3)).astype(F32)
    tree = TA.chunk_tree(lo, hi)
    box, link = tree["tree_box"], tree["tree_link"]
    o, d = _box_rays(rng, lo, hi, 200)
    if case == "ties":  # axis-aligned rays: equal entries into the grid
        d[:60] = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]],
                          F32)[np.arange(60) % 3]
        o[:60] = np.where(d[:60] > 0, -1.0, o[:60]).astype(F32)
    overflows = ties = 0
    for i in range(o.shape[0]):
        tn, tf = _slab(box, o[i], _inv(d[i]))
        leaf = link < 0
        valid = tn[leaf][tn[leaf] <= tf[leaf]]
        ties += len(np.unique(valid)) < len(valid)
        # a hit per chunk near its entry, some below it (as a Woop t can
        # round below its chunk's tn), a few chunks without one
        jitter = rng.choice(np.array([0.0, -1e-7, 1e-7, 0.5], F32),
                            leaf.sum())
        hit_t = np.where(rng.random(leaf.sum()) < 0.3, np.inf,
                         tn[leaf] + jitter).astype(F32)
        best0 = F32(np.inf) if i % 2 else F32(2.5)
        want, t_want = linear_order(tn[leaf], tf[leaf],
                                    _synthetic_sweep(hit_t), best0)
        got, t_got, over = best_first_order(tn, tf, link,
                                            _synthetic_sweep(hit_t), best0,
                                            queue_size)
        assert got == want and t_got == t_want, i
        overflows += over
    if queue_size < 16 or case == "overlap":
        assert overflows > 0
    if case == "ties":
        assert ties >= 60


def test_query_plain_matches_brute_force_on_overlapping_chunks():
    """``torch_cases.overlapping_soup``, slivers whose chunk boxes all
    overlap, on which tests/test_torch_cuda.py overflows the
    kernel's queues: query_plain, the kernel's reference there, against
    brute force under tests/test_accel.py's ``_same_hits`` rule (rtol 1e-3,
    atol 1e-4; Woop and Moller-Trumbore round t differently) and equal
    prim on all but 1 % of the rays (triangle edges)."""
    soup = overlapping_soup(np.random.default_rng(5))
    acc = TA.build_accel(*soup, device="cpu")
    assert acc.pages.shape[0] >= 8
    rays = tuple(map(torch.from_numpy, overlapping_rays(
        np.random.default_rng(6), 400)))
    t_q, p_q = bvh.query_plain(acc, *rays, 400)
    t_b, p_b, _, _ = intersect_soup(*map(torch.from_numpy, soup), *rays)
    same = (p_q == p_b) & (p_q >= 0)
    assert float((p_q != p_b).float().mean()) <= 0.01 and same.sum() > 100
    assert torch.allclose(t_q[same], t_b[same], rtol=1e-3, atol=1e-4)


# --------------------------------------------------------------------------
# Super mode: the leaves of the super tree are super-chunks
# --------------------------------------------------------------------------

def _super_boxes(lo, hi):
    """Super-chunk boxes over groups of SUPER_CHUNKS chunk boxes, the last
    group padded with empty boxes, as the Accel's sup_min / sup_max."""
    pad = (-lo.shape[0]) % TA.SUPER_CHUNKS
    smin = np.concatenate([lo, np.full((pad, 3), 1.0, F32)])
    smax = np.concatenate([hi, np.full((pad, 3), -1.0, F32)])
    return (smin.reshape(-1, TA.SUPER_CHUNKS, 3).min(axis=1),
            smax.reshape(-1, TA.SUPER_CHUNKS, 3).max(axis=1))


def _super_sweep(chunk_tn, chunk_tf, chunk_sweep, swept):
    """sweep(super, best_t) of super mode: the super-chunk's chunks in id
    order, each slab-tested against the current best_t and swept when it
    passes (appended to ``swept``), until an any-hit ray stops."""
    c = chunk_tn.shape[0]

    def sweep(sup, best_t):
        for k in range(sup * TA.SUPER_CHUNKS,
                       min((sup + 1) * TA.SUPER_CHUNKS, c)):
            if chunk_tn[k] <= chunk_tf[k] and chunk_tn[k] < best_t:
                swept.append(k)
                best_t, stop = chunk_sweep(k, best_t)
                if stop:
                    return best_t, True
        return best_t, False

    return sweep


def _grid_boxes(rng):
    """Unit cells of a 4x4x2 grid in shuffled order, plus duplicates: super
    boxes that overlap and chunk boxes of equal entries."""
    cells = np.array([[x, y, z] for x in range(4) for y in range(4)
                      for z in range(2)], F32)
    cells = np.concatenate([cells, cells[:12]])[rng.permutation(44)]
    return cells, cells + F32(1.0)


@pytest.mark.parametrize("case", ["ties", "random", "overlap"])
@pytest.mark.parametrize("queue_size", [1, 2, 16])
def test_best_first_over_super_chunks_equals_linear_pick(case, queue_size):
    """The emulated kernel walking the super tree visits the linear pick's
    super-chunks in its order and sweeps the same chunks, whatever the
    queue size; small queues do overflow.  Chunk sweeps are synthetic (a
    hit near each chunk's entry, some below it)."""
    rng = np.random.default_rng({"ties": 4, "random": 5, "overlap": 6}[case])
    if case == "ties":
        lo, hi = _grid_boxes(rng)
    elif case == "random":
        lo, hi = _random_boxes(rng, 120)
    else:
        lo = rng.uniform(-1.0, -0.8, (300, 3)).astype(F32)
        hi = rng.uniform(0.8, 1.0, (300, 3)).astype(F32)
    s_lo, s_hi = _super_boxes(lo, hi)
    tree = TA.chunk_tree(s_lo, s_hi)
    box, link = tree["tree_box"], tree["tree_link"]
    leaf = link < 0
    chunks = np.concatenate([lo, hi], axis=1)
    o, d = _box_rays(rng, lo, hi, 200)
    if case == "ties":  # axis-aligned rays: equal entries into the grid
        d[:60] = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]],
                          F32)[np.arange(60) % 3]
        o[:60] = np.where(d[:60] > 0, -1.0, o[:60]).astype(F32)
    overflows = visits = 0
    for i in range(o.shape[0]):
        inv = _inv(d[i])
        tn, tf = _slab(box, o[i], inv)
        c_tn, c_tf = _slab(chunks, o[i], inv)
        jitter = rng.choice(np.array([0.0, -1e-7, 1e-7, 0.5], F32),
                            lo.shape[0])
        hit_t = np.where(rng.random(lo.shape[0]) < 0.3, np.inf,
                         c_tn + jitter).astype(F32)
        best0 = F32(np.inf) if i % 2 else F32(2.5)
        want_chunks, got_chunks = [], []
        want, t_want = linear_order(
            tn[leaf], tf[leaf],
            _super_sweep(c_tn, c_tf, _synthetic_sweep(hit_t), want_chunks),
            best0)
        got, t_got, over = best_first_order(
            tn, tf, link,
            _super_sweep(c_tn, c_tf, _synthetic_sweep(hit_t), got_chunks),
            best0, queue_size)
        assert got == want and got_chunks == want_chunks, i
        assert t_got == t_want, i
        overflows += over
        visits += len(got)
    assert visits > o.shape[0]
    if queue_size < 16 or case == "overlap":
        assert overflows > 0


@pytest.mark.parametrize("query", ["closest", "any"])
@pytest.mark.parametrize("scene", ["sphere", "slivers"])
def test_best_first_over_super_chunks_sweeps_query_plains_chunks(scene,
                                                                 query):
    """Real chunks and Woop sweeps: the emulated kernel walking the super
    tree ends with query_plain(mode="super")'s t and prim, and sweeps the
    chunks the linear pick over the super boxes sweeps.  On slivers a
    4-entry queue overflows and the ray finishes with the linear pick."""
    rng = np.random.default_rng(12)
    n = 200
    if scene == "sphere":
        acc = TA.build_accel(*_sphere_soup(80), device="cpu")
        o, d = _box_rays(rng, acc.aabb_min.numpy(), acc.aabb_max.numpy(), n)
        maxt = np.where(rng.random(n) < 0.2, rng.uniform(0.1, 1.0, n),
                        np.inf).astype(F32)
        queue_size = 16
    else:
        acc = TA.build_accel(*overlapping_soup(np.random.default_rng(5)),
                             device="cpu")
        o, d, maxt, _ = overlapping_rays(np.random.default_rng(6), n)
        queue_size = 4
    box, link = acc.sup_tree_box.numpy(), acc.sup_tree_link.numpy()
    leaf = link < 0
    chunks = torch.cat([acc.aabb_min, acc.aabb_max], 1).numpy()
    any_hit = query == "any"
    t_p, p_p = bvh.query_plain(acc, *map(torch.from_numpy, (o, d, maxt)),
                               torch.ones(n, dtype=torch.bool),
                               0 if any_hit else n, "super")
    visits = overflows = 0
    for i in range(n):
        inv = _inv(d[i])
        tn, tf = _slab(box, o[i], inv)
        c_tn, c_tf = _slab(chunks, o[i], inv)
        best0 = min(maxt[i], F32(bvh.BIG))
        want_chunks, got_chunks = [], []
        sweep, _ = _woop_sweep(acc, o[i], d[i], any_hit)
        want, _ = linear_order(tn[leaf], tf[leaf],
                               _super_sweep(c_tn, c_tf, sweep, want_chunks),
                               best0)
        sweep, prim = _woop_sweep(acc, o[i], d[i], any_hit)
        got, best_t, over = best_first_order(
            tn, tf, link, _super_sweep(c_tn, c_tf, sweep, got_chunks), best0,
            queue_size)
        assert got == want and got_chunks == want_chunks, i
        assert prim[0] == int(p_p[i]), i
        if prim[0] >= 0:
            assert best_t == (F32(-bvh.BIG) if any_hit else t_p[i].item()), i
        visits += len(got_chunks)
        overflows += over
    assert visits > n // 2 and (p_p >= 0).sum() > n // 5
    assert (overflows > 0) == (scene == "slivers")


# --------------------------------------------------------------------------
# Super mode's page sweep, shared by the warp
# --------------------------------------------------------------------------

INT_MAX = 0x7FFFFFFF


def _woop_page(page, o, d):
    """csrc/bvh.cu:woop of one ray against (T, 16) records, float32 numpy
    in the kernel's order of operations -> (hit without the far limit
    (T,), t (T,))."""
    f = [page[:, q].astype(F32) for q in range(13)]
    a0x, a0y, a0z, a1x, a1y, a1z, a2x, a2y, a2z, _prim, cx, cy, cz = f
    ox, oy, oz = (F32(x) for x in o)
    dx, dy, dz = (F32(x) for x in d)
    rz = a2x * dx + a2y * dy + a2z * dz
    rz_ok = np.abs(rz) > F32(1e-12)
    sz = a2x * ox + a2y * oy + a2z * oz - cz
    tt = -sz / np.where(rz_ok, rz, F32(1.0))
    u = (a0x * ox + a0y * oy + a0z * oz - cx) + tt * (a0x * dx + a0y * dy
                                                       + a0z * dz)
    v = (a1x * ox + a1y * oy + a1z * oz - cy) + tt * (a1x * dx + a1y * dy
                                                       + a1z * dz)
    ok = rz_ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (tt > EPS)
    return ok, tt


def _sequential_sweep(ok, tt, prim, t0, any_hit):
    """sweep_page's loop: -> (t, prim, found)."""
    bt, bp = t0, -1
    for k in range(ok.shape[0]):
        if ok[k] and tt[k] < bt:
            bt, bp = tt[k], int(prim[k])
            if any_hit:
                return F32(-bvh.BIG), bp, True
    return bt, bp, bp >= 0


def _warp_sweep(ok, tt, prim, t0, any_hit):
    """warp_sweep: lane l tests positions l, l + 32, ... against its own
    running best (from t0); an any-hit ray takes the lowest hitting lane of
    the first step with a hit, a closest-hit ray the least t bits, then the
    least position among the lanes holding them.  -> (t, prim, found)."""
    lane_t = np.full(32, t0, F32)
    lane_k = np.full(32, INT_MAX, np.int64)
    lane_p = np.full(32, -1, np.int64)
    for base in range(0, ok.shape[0], 32):
        hit = np.zeros(32, bool)
        for lane in range(32):
            k = base + lane
            if k < ok.shape[0] and ok[k] and tt[k] < lane_t[lane]:
                hit[lane] = True
                lane_t[lane], lane_k[lane], lane_p[lane] = tt[k], k, prim[k]
        if any_hit and hit.any():
            return F32(-bvh.BIG), int(lane_p[np.argmax(hit)]), True
    if any_hit:
        return t0, -1, False
    bits = np.where(lane_k == INT_MAX, np.uint32(0xFFFFFFFF),
                    lane_t.view(np.uint32))
    t_min = bits.min()
    if t_min == 0xFFFFFFFF:
        return t0, -1, False
    k_min = np.where(bits == t_min, lane_k, INT_MAX).min()
    return np.uint32(t_min).view(F32), int(lane_p[k_min % 32]), True


@pytest.mark.parametrize("query", ["closest", "any"])
@pytest.mark.parametrize("case", ["pages", "equal_t", "at_best_t",
                                  "nan_maxt"])
def test_warp_sweep_equals_sequential_sweep(case, query):
    """On the pages of the sphere's chunks that a ray hits: as they are;
    with copies of the nearest hit at other positions (equal t: the first
    position must win, in the same lane or another, in the same 32-triangle
    step or another); with best_t exactly at that t (no candidate) and just
    above it; and with best_t NaN (no hit).  The warp's result is the
    sequential sweep's, bit for bit, and the plain version's."""
    acc = TA.build_accel(*_sphere_soup(), device="cpu")
    c, rows, width = acc.pages.shape
    pages16 = acc.pages.numpy().reshape(c, rows * width // 16, 16)
    used = acc.rows.numpy().astype(int) * 8
    rng = np.random.default_rng(13)
    o, d = _box_rays(rng, acc.aabb_min.numpy(), acc.aabb_max.numpy(), 120)
    any_hit = query == "any"
    checked = found = 0
    for i in range(o.shape[0]):
        for ch in range(c):
            page = pages16[ch, :used[ch]].copy()
            ok, tt = _woop_page(page, o[i], d[i])
            if not ok.any():
                continue
            k = int(np.argmin(np.where(ok, tt, np.inf)))
            if case != "pages":  # copies of the nearest hit, new prim ids
                for j in (k - 3, k + 1, k + 31, k + 32, k + 33,
                          page.shape[0] - 1):
                    if 0 <= j < page.shape[0] and j != k:
                        page[j] = page[k]
                        page[j, 9] = 100000 + j
                ok, tt = _woop_page(page, o[i], d[i])
            t0s = {"pages": [F32(bvh.BIG)], "equal_t": [F32(bvh.BIG)],
                   "at_best_t": [tt[k], np.nextafter(tt[k], F32(np.inf))],
                   "nan_maxt": [F32(np.nan)]}[case]
            prim = page[:, 9].astype(np.int64)
            for t0 in t0s:
                want = _sequential_sweep(ok, tt, prim, t0, any_hit)
                got = _warp_sweep(ok, tt, prim, t0, any_hit)
                bt, bp, hit = bvh._sweep(
                    torch.from_numpy(page[None]), torch.tensor([0]),
                    torch.from_numpy(o[i:i + 1]), torch.from_numpy(d[i:i + 1]),
                    torch.tensor([t0]), torch.tensor([-1], dtype=torch.int32),
                    torch.tensor([any_hit]))
                plain = (F32(bt[0]), int(bp[0]), bool(hit[0]))
                for res in (got, plain):
                    assert (np.asarray(res[0], F32).view(np.uint32)
                            == np.asarray(want[0], F32).view(np.uint32)), i
                    assert res[1:] == want[1:], (i, ch, res, want)
                if case == "equal_t" and not any_hit:  # the first copy
                    assert want[1] == prim[k - 3 if k >= 3 else k]
                checked += 1
                found += want[2]
    assert checked > 50
    if case == "nan_maxt":
        assert found == 0
    else:
        assert found > 20


# --------------------------------------------------------------------------
# K2: a block's list of the rays that need tests, one a thread
# --------------------------------------------------------------------------

def _k2_loop(soup, o, d, maxt, active, block=256, chunk=512):
    """csrc/intersect.cu:any_hit_kernel's loop, vectorised over a block's
    threads: block b owns rays [b * block, (b + 1) * block) and lists those
    that are active with a limit above RAY_EPS (in an order of its own:
    here shuffled); thread t tests list entry t against the triangles,
    staged in chunks, up to its ray's first hit.  -> (occluded (N,), tests
    per ray (N,))."""
    n, m = o.shape[0], soup[0].shape[0]
    hit, tt, _u, _v = isect._moller_trumbore(o, d, *soup)
    limit = torch.where(active, torch.clamp_max(maxt, bvh.BIG), -bvh.BIG)
    passes = (hit & (tt < limit[:, None])).numpy()
    opened = (limit > bvh.RAY_EPS).numpy()
    occ = np.zeros(n, bool)
    tests = np.zeros(n, np.int64)
    shuffle = np.random.default_rng(0).permutation
    for b in range(-(-n // block)):
        own = np.arange(b * block, min((b + 1) * block, n))
        ray = shuffle(own[opened[own]])  # thread t's ray is ray[t]
        open_ = np.ones(ray.shape[0], bool)
        for base in range(0, m, chunk):
            for k in range(base, min(base + chunk, m)):
                if not open_.any():
                    break
                tests[ray[open_]] += 1
                h = open_ & passes[ray, k]
                occ[ray[h]] = True
                open_ &= ~h
    return occ, tests


@pytest.mark.parametrize("active_share", ["most", "a_third"])
@pytest.mark.parametrize("soup_kind", ["cbox", "random3000"])
def test_k2_loop_equals_ray_test_soup(soup_kind, active_share):
    """K2's loop with a ragged tail (n not a multiple of the block),
    inactive rays (most rays active, or a third as among a render's shadow
    rays, so that a block's list ends early), NaN and negative maxt, and
    (3000 triangles) more than one staging chunk: occlusion equals
    ray_test_soup, and each ray takes the tests the bound counts
    (chip_smoke.py:any_hit_tests): up to its first hit, all M when it
    misses, none when it is inactive or its maxt leaves no room for a
    hit."""
    rng = np.random.default_rng(14)
    if soup_kind == "cbox":
        sd = mt.load_dict(mt.cornell_box(), device="cpu").data
        soup = (sd.tri.v0, sd.tri.e1, sd.tri.e2)
        n = 5 * 256 + 77
    else:
        soup = tuple(map(torch.from_numpy, random_soup(rng, 3000)))
        n = 1300
    o, d, maxt, act = random_rays(rng, n, tuple(a.numpy() for a in soup))
    maxt = np.where(np.isinf(maxt), F32(1.2), maxt).astype(F32)
    maxt[::17] = np.nan
    maxt[5::23] = -1.0
    if active_share == "a_third":
        act &= rng.random(n) < 0.35
    o, d, maxt, act = map(torch.from_numpy, (o, d, maxt, act))
    occ, tests = _k2_loop(soup, o, d, maxt, act)
    want = isect.ray_test_soup(*soup, o, d, maxt, act).numpy()
    np.testing.assert_array_equal(occ, want)
    assert 0.1 < want.mean() < 0.9
    m = soup[0].shape[0]
    hit, tt, _u, _v = isect._moller_trumbore(o, d, *soup)
    first = (hit & (tt < maxt[:, None])).numpy()
    need = np.where(first.any(1), first.argmax(1) + 1, m)
    need = np.where(act.numpy() & (maxt.numpy() > bvh.RAY_EPS), need, 0)
    np.testing.assert_array_equal(tests, need)
    assert (need == 0).sum() > n // 20 and (need == m).any()


# --------------------------------------------------------------------------
# K1: a block's list of the rays that need tests, one a thread
# --------------------------------------------------------------------------

def _k1_loop(soup, o, d, maxt, active, block=256, chunk=512):
    """csrc/intersect.cu:closest_hit_kernel's loop, vectorised over a
    block's threads: block b owns rays [b * block, (b + 1) * block) and
    lists those that are active with a limit above RAY_EPS (in an order of
    its own: here shuffled), answering the others as misses; thread t tests
    list entry t against each staged triangle, in index order and chunk by
    chunk, keeping a hit strictly nearer than its best.  -> (t (N,), prim
    (N,), tests per ray (N,))."""
    n, m = o.shape[0], soup[0].shape[0]
    hit, tt, _u, _v = isect._moller_trumbore(o, d, *soup)
    hit, tt = hit.numpy(), tt.numpy()
    best_t = torch.where(active, torch.clamp_max(maxt, bvh.BIG),
                         -bvh.BIG).numpy().copy()
    best_i = np.full(n, -1, np.int32)
    tests = np.zeros(n, np.int64)
    opened = best_t > EPS  # NaN is not
    shuffle = np.random.default_rng(0).permutation
    for b in range(-(-n // block)):
        own = np.arange(b * block, min((b + 1) * block, n))
        ray = shuffle(own[opened[own]])  # thread t's ray is ray[t]
        for base in range(0, m, chunk):
            for k in range(base, min(base + chunk, m)):
                tests[ray] += 1
                take = ray[hit[ray, k] & (tt[ray, k] < best_t[ray])]
                best_t[take] = tt[take, k]
                best_i[take] = k
    t = np.where(best_i >= 0, best_t, F32(np.inf)).astype(F32)
    return t, best_i, tests


@pytest.mark.parametrize("active_share", ["most", "a_third"])
@pytest.mark.parametrize("soup_kind", ["cbox", "random3000"])
def test_k1_loop_equals_intersect_soup(soup_kind, active_share):
    """K1's loop with a ragged tail (n not a multiple of the block),
    inactive rays (most rays active, or a third), NaN and negative maxt,
    coplanar ties (the soup's last ``dup`` triangles repeat its first ones;
    a fifth of the rays aim at triangle 0) and (3000 triangles) more than
    one staging chunk:
    ``t`` bit-equal to intersect_soup and ``prim`` equal; each listed ray
    tests all M triangles, the others none."""
    rng = np.random.default_rng(15)
    if soup_kind == "cbox":
        sd = mt.load_dict(mt.cornell_box(), device="cpu").data
        dup, n = 1, 5 * 256 + 77
        soup = tuple(torch.cat([a, a[:dup]]) for a in (sd.tri.v0, sd.tri.e1,
                                                       sd.tri.e2))
    else:
        dup, n = 500, 1300
        soup = tuple(torch.from_numpy(np.concatenate([a[:-dup], a[:dup]]))
                     for a in random_soup(rng, 3000))
    o, d, maxt, act = random_rays(rng, n, tuple(a.numpy() for a in soup))
    maxt[::17] = np.nan
    maxt[5::23] = -1.0
    if active_share == "a_third":
        act &= rng.random(n) < 0.35
    o, d, maxt, act = map(torch.from_numpy, (o, d, maxt, act))
    t, prim, tests = _k1_loop(soup, o, d, maxt, act)
    t_p, prim_p, _u, _v = intersect_soup(*soup, o, d, maxt, act)
    np.testing.assert_array_equal(prim, prim_p.numpy())
    np.testing.assert_array_equal(t.view(np.uint32), t_p.numpy().view(np.uint32))
    m = soup[0].shape[0]
    assert (prim >= 0).any() and (prim < 0).any()
    assert (prim < dup).any() and not (prim >= m - dup).any()  # the ties
    listed = act.numpy() & (maxt.numpy() > bvh.RAY_EPS)
    np.testing.assert_array_equal(tests, np.where(listed, m, 0))
    assert (~listed).sum() > n // 20
