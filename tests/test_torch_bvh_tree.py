"""The chunk tree of the port's Accel (``ops/accel.py:chunk_tree``) and the
best-first order in which the chunk-mode BVH kernel walks it, on the CPU.

- Tree invariants: preorder numbering, every node a contiguous range of
  chunk ids, leaves the chunks 0..C-1 in order, and each inner node's box
  the exact float32 min/max of its children's.
- The loader's tree (``build_accel_numpy``) equals the tree of the JAX
  package's Accel carried across by ``convert.py`` (small sphere config,
  4,512 triangles).
- A scalar emulator of the kernel's traversal (``csrc/bvh.cu:
  bvh_tree_kernel``: the queue of (tn, node) keys, the nearer child kept
  out of the queue, a full queue handing the ray to the linear pick from
  its gate) sweeps the same chunks in the same order as the linear pick of
  ``ops/bvh.py:query_plain``, on a few hundred random rays, on hand-made
  ties (duplicate and face-sharing boxes, equal entries), on slivers whose
  rays overflow the kernel's 16-entry queue, and with queues small enough
  to overflow everywhere.  Slab tests are float32 numpy in the kernel's
  order of operations, so the comparisons are exact.
"""
import numpy as np
import pytest
import torch

import mitransient_tpu as mitr
import mitransient_tpu_torch as mt
from mitransient_tpu_torch.convert import scene_data_from_numpy
from mitransient_tpu_torch.ops import accel as TA
from mitransient_tpu_torch.ops import bvh
from mitransient_tpu_torch.ops.intersect import intersect_soup
from test_torch_scene import jax_leaves
from torch_cases import (
    SPHERE_CENTER,
    SPHERE_RADIUS,
    overlapping_rays,
    overlapping_soup,
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


@pytest.mark.parametrize("case", ["sphere", "random", "ties", "one", "two"])
def test_tree_invariants(case):
    rng = np.random.default_rng(0)
    if case == "sphere":
        host = TA.build_accel_numpy(*_sphere_soup())
        lo, hi = host["aabb_min"], host["aabb_max"]
        assert host["tree_box"].shape == (2 * lo.shape[0] - 1, 6)
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
    desc = small_sphere_cbox(mt)
    tsc = mt.load_dict(desc, device="cpu")
    carried = scene_data_from_numpy(jax_leaves(mitr.load_dict(desc).data),
                                    device="cpu")
    assert tsc.data.tri.v0.shape[0] == 4512 + 24
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
