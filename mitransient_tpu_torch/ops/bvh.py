"""Ray queries through the chunked acceleration structure: the BVH kernel
of ``csrc/bvh.cu`` and its plain PyTorch version.

Counterpart of ``mitransient_tpu/ops/bvh_pallas.py``.  On the TPU each
query is a loop of passes: select each ray's next chunk (K5, or K7 per
super-chunk), sort the rays by it, sweep the chunk pages (K4, or K6), with
a candidate cache and an alive-compaction cascade.  That design exists
because a TPU lane has no control flow of its own; a Hopper thread does.
So the port traverses per ray, over the same :class:`~.accel.Accel`
tables, in one launch per query.  What a query computes, the contract of
both versions:

1. ``best_t = min(maxt, BIG)`` for active rays, ``-BIG`` for inactive ones.
2. The boxes (chunks in ``"chunk"`` mode, super-chunks in ``"super"``
   mode) whose slab test passes (``tn <= tf``) are visited by increasing
   ``(tn, id)``; the first one with ``tn >= best_t`` ends the query.
3. A visited chunk's used page rows are swept (in super mode: each of the
   super-chunk's 8 chunks whose slab test passes against the current
   ``best_t``) with the Woop test of ``bvh_pallas._woop_update``, in
   triangle order; a hit must be strictly nearer, so on equal ``t`` the
   first visited triangle wins.
4. Rays at or above ``n_closest`` are any-hit rays: they stop at their
   first hit, and report it as ``prim >= 0`` with ``t = -BIG`` (the JAX
   package's collapsed ``t``).

Outputs are ``t`` (inf on a miss) and ``prim`` in the scene's original
triangle numbering (-1 on a miss).  Every pick that the TPU's pass loop
makes is one this order makes, so ``t`` is the same closest hit; only the
order in which chunks are visited differs, which can change ``prim`` on an
exact tie between triangles of different chunks.

How each version finds the next box:

* :func:`query_plain`, the plain version, picks it linearly: of all boxes
  after the ray's gate (the last visited ``(tn, id)``) with ``tn < best_t``
  the smallest ``(tn, id)``, by an (R, K) slab test over blocks of rays in
  lockstep.
* :func:`query_kernel` launches the CUDA kernel.  In both modes it walks
  a tree over the boxes (``ops/accel.py:chunk_tree``: the chunk tree, or
  the super tree over the super-chunk boxes) best first, with a per-ray
  priority queue of tree nodes keyed by ``(tn, node)``; node boxes are
  exact unions and the slab test is monotone, so it visits the same boxes
  in the same order as the linear pick, bit for bit (the argument is in
  ``csrc/bvh.cu``).  A ray whose queue fills goes on with the linear pick
  from its gate.  Chunk mode sweeps a page one thread per ray; super mode
  sweeps each page with the whole warp, 32 triangles a step, and reduces
  to the sequential sweep's result.

The public queries take the plain version for CPU tensors and the kernel
for CUDA tensors.
"""
from __future__ import annotations

import torch

from .. import trace
from ..kernels import _build
from .accel import SUPER_CHUNKS, Accel

RAY_EPS = 1e-4
BIG = 3.0e38
# The default traversal mode: "chunk" picks chunks front to back, "super"
# picks super-chunks and sweeps their 8 chunks (bvh_pallas.py:72-84).
# Callers choose per query with ``mode``; nothing here changes it.
BVH_MODE = "chunk"
MODES = ("chunk", "super")
# query_plain works on blocks of rays whose gathered pages take about this
PLAIN_BLOCK_BYTES = 128 << 20
# the kernel's optional counts (query_kernel(stats=...)), in this order
STATS = ("box_tests", "triangle_tests", "overflow_rays")


def closest_hit_bvh(accel: Accel, ray_o, ray_d, maxt, active,
                    mode: str = BVH_MODE):
    """Closest hit -> (t (N,) f32, +inf on a miss; prim (N,) int32, -1)."""
    return _query(accel, ray_o, ray_d, maxt, active, ray_o.shape[0], mode)


def ray_test_bvh(accel: Accel, ray_o, ray_d, maxt, active,
                 mode: str = BVH_MODE):
    """Any hit (occlusion) -> (N,) bool."""
    _, prim = _query(accel, ray_o, ray_d, maxt, active, 0, mode)
    return prim >= 0


def mixed_query_bvh(accel: Accel, ray_o, ray_d, maxt, active,
                    n_closest: int, mode: str = BVH_MODE):
    """Rays [0, n_closest) closest hit, [n_closest, N) any hit, in one
    query -> (t, prim); any-hit rays report a hit as prim >= 0."""
    return _query(accel, ray_o, ray_d, maxt, active, n_closest, mode)


def _query(accel, ray_o, ray_d, maxt, active, n_closest, mode):
    if ray_o.device.type == "cpu":
        return query_plain(accel, ray_o, ray_d, maxt, active, n_closest,
                           mode)
    return query_kernel(accel, ray_o, ray_d, maxt, active, n_closest, mode)


# --------------------------------------------------------------------------
# Plain version
# --------------------------------------------------------------------------

def _safe_inv(d):
    tiny = torch.where(d < 0.0, torch.full_like(d, -1e-12),
                       torch.full_like(d, 1e-12))
    return 1.0 / torch.where(torch.abs(d) < 1e-12, tiny, d)


def _slab(bmin, bmax, o, inv):
    """Slab test of rays against boxes, broadcast over leading dims:
    (entry tn, exit tf), in the TPU kernels' order of min/max."""
    t0 = (bmin - o) * inv
    t1 = (bmax - o) * inv
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    tn = torch.maximum(torch.maximum(lo[..., 0], lo[..., 1]),
                       torch.clamp_min(lo[..., 2], RAY_EPS))
    tf = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]), hi[..., 2])
    return tn, tf


def _pick(bmin, bmax, o, inv, best_t, gate_e, gate_k):
    """Lexicographically smallest (tn, k) over K boxes, after the gate and
    with tn < best_t.  -> (found (R,), tn (R,), k (R,) int64)."""
    tn, tf = _slab(bmin[None], bmax[None], o[:, None], inv[:, None])
    k = torch.arange(bmin.shape[0], device=o.device)[None]
    after = (tn > gate_e[:, None]) | ((tn == gate_e[:, None])
                                      & (k > gate_k[:, None]))
    valid = (tn <= tf) & (tn < best_t[:, None]) & after
    e = torch.where(valid, tn, float("inf"))
    j = torch.argmin(e, dim=1)  # first minimum: the smallest id on ties
    e_j = torch.gather(e, 1, j[:, None])[:, 0]
    return torch.isfinite(e_j), e_j, j


def _sweep(pages16, cid, o, d, best_t, best_p, any_hit):
    """Woop test of rays (R,) against their pages ``cid`` (R,), all rows;
    pad triangles have A = 0 and never hit.  ``any_hit`` (R,) bool.
    -> (best_t, best_p, hit)."""
    tri = pages16.index_select(0, cid)  # (R, cap, 16)
    f = [tri[..., q] for q in range(13)]
    a0x, a0y, a0z, a1x, a1y, a1z, a2x, a2y, a2z, prim, cx, cy, cz = f
    rox, roy, roz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    rdx, rdy, rdz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    rz = a2x * rdx + a2y * rdy + a2z * rdz
    rz_ok = torch.abs(rz) > 1e-12
    sz = a2x * rox + a2y * roy + a2z * roz - cz
    tt = -sz / torch.where(rz_ok, rz, 1.0)
    rx = a0x * rdx + a0y * rdy + a0z * rdz
    sx = a0x * rox + a0y * roy + a0z * roz - cx
    u = sx + tt * rx
    ry = a1x * rdx + a1y * rdy + a1z * rdz
    sy = a1x * rox + a1y * roy + a1z * roz - cy
    v = sy + tt * ry
    hit = (rz_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (tt > RAY_EPS) & (tt < best_t[:, None]))
    t_m = torch.where(hit, tt, float("inf"))
    # closest-hit rays: the first minimum; any-hit rays: the first hit
    j = torch.where(any_hit, torch.argmax(hit.to(torch.int8), dim=1),
                    torch.argmin(t_m, dim=1))[:, None]
    found = torch.gather(hit, 1, j)[:, 0]
    t_j = torch.gather(tt, 1, j)[:, 0]
    p_j = torch.gather(prim, 1, j)[:, 0].to(torch.int32)
    best_p = torch.where(found, p_j, best_p)
    best_t = torch.where(found, torch.where(any_hit, -BIG, t_j), best_t)
    return best_t, best_p, found


def _query_block(accel, pages16, o, d, maxt, active, any_hit, mode,
                 counts):
    n = o.shape[0]
    dev = o.device
    inv = _safe_inv(d)
    best_t = torch.where(active, torch.clamp_max(maxt, BIG), -BIG)
    best_p = torch.full((n,), -1, dtype=torch.int32, device=dev)
    gate_e = torch.full((n,), float("-inf"), device=dev)
    gate_k = torch.full((n,), -1, dtype=torch.int64, device=dev)
    if mode == "chunk":
        bmin, bmax = accel.aabb_min, accel.aabb_max
    else:
        bmin, bmax = accel.sup_min, accel.sup_max
    n_chunks = accel.aabb_min.shape[0]
    if counts is not None:
        counts["box_once"] += int(active.sum()) * bmin.shape[0]
    live = torch.arange(n, device=dev)
    while live.numel() > 0:
        o_l, inv_l = o[live], inv[live]
        found, e, k = _pick(bmin, bmax, o_l, inv_l, best_t[live],
                            gate_e[live], gate_k[live])
        if counts is not None:
            counts["slab"] += live.numel() * bmin.shape[0]
        live, e, k = live[found], e[found], k[found]
        gate_e[live] = e
        gate_k[live] = k
        if mode == "chunk":
            bt, bp, hit = _sweep(pages16, k, o[live], d[live], best_t[live],
                                 best_p[live], any_hit[live])
            best_t[live], best_p[live] = bt, bp
            stop = hit & any_hit[live]
            if counts is not None:
                counts["woop"] += 8 * accel.rows[k].sum()
        else:
            stop = torch.zeros(live.numel(), dtype=torch.bool, device=dev)
            for cc in range(SUPER_CHUNKS):
                cid = k * SUPER_CHUNKS + cc
                sel = (cid < n_chunks) & ~stop
                if counts is not None:
                    counts["slab"] += sel.sum()
                    counts["box_once"] += sel.sum()
                c_s = torch.clamp_max(cid, n_chunks - 1)
                tn, tf = _slab(accel.aabb_min[c_s], accel.aabb_max[c_s],
                               o[live], inv[live])
                sel = sel & (tn <= tf) & (tn < best_t[live])
                rays = live[sel]
                bt, bp, hit = _sweep(pages16, c_s[sel], o[rays], d[rays],
                                     best_t[rays], best_p[rays],
                                     any_hit[rays])
                best_t[rays], best_p[rays] = bt, bp
                stop[sel] = hit & any_hit[rays]
                if counts is not None:
                    counts["woop"] += 8 * accel.rows[c_s[sel]].sum()
        live = live[~stop]
    return torch.where(best_p < 0, float("inf"), best_t), best_p


def query_plain(accel: Accel, ray_o, ray_d, maxt, active, n_closest: int,
                mode: str = "chunk", counts: dict | None = None):
    """The traversal of the module docstring in plain PyTorch, in lockstep
    steps over blocks of rays: each step picks every live ray's next box
    with an (R, C) or (R, S) slab test, gathers the picked pages and runs
    the Woop test on them.  -> (t (N,) f32, prim (N,) int32).

    With ``counts`` (a dict) it adds the work the kernel does for these
    rays: ``"slab"`` box tests and ``"woop"`` triangle tests (the used rows
    of each visited page); and ``"box_once"``, the box tests left when each
    active ray tests each box at most once (a box's slab test gives the
    same answer on every visit)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: expected one of {MODES}")
    n = ray_o.shape[0]
    if n == 0:
        return (torch.empty(0, device=ray_o.device),
                torch.empty(0, dtype=torch.int32, device=ray_o.device))
    c, rows, width = accel.pages.shape
    pages16 = accel.pages.reshape(c, rows * width // 16, 16)
    page_bytes = pages16[0].numel() * 4
    block = max(1, min(n, PLAIN_BLOCK_BYTES // page_bytes))
    any_hit = torch.arange(n, device=ray_o.device) >= n_closest
    t_out, p_out = [], []
    for s in range(0, n, block):
        sl = slice(s, s + block)
        t, p = _query_block(accel, pages16, ray_o[sl], ray_d[sl], maxt[sl],
                            active[sl], any_hit[sl], mode, counts)
        t_out.append(t)
        p_out.append(p)
    return torch.cat(t_out), torch.cat(p_out)


# --------------------------------------------------------------------------
# Kernel wrapper
# --------------------------------------------------------------------------

def query_kernel(accel: Accel, ray_o, ray_d, maxt, active, n_closest: int,
                 mode: str = "chunk", stats=None):
    """Launch the BVH kernel of ``csrc/bvh.cu`` on CUDA tensors.

    ``stats``: None, or a zeroed (3,) int64 CUDA tensor into which either
    mode adds the slab tests of tree nodes and boxes, the triangle tests
    and the rays whose queue overflowed (names in :data:`STATS`)."""
    kernel = f"bvh_query_{mode}"
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: expected one of {MODES}")
    dev = ray_o.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: rays on {dev}; expected cuda")
    n = ray_o.shape[0]
    c, page_rows, width = accel.pages.shape
    s = accel.sup_min.shape[0]
    f32 = torch.float32
    if width != 128 or c < 1 or s != -(-c // SUPER_CHUNKS):
        raise ValueError(f"{kernel}: malformed accel (pages "
                         f"{tuple(accel.pages.shape)}, {s} supers)")
    if not 0 <= n_closest <= n:
        raise ValueError(f"{kernel}: n_closest {n_closest} not in [0, {n}]")
    for name, t, shape in (
            ("aabb_min", accel.aabb_min, (c, 3)),
            ("aabb_max", accel.aabb_max, (c, 3)),
            ("rows", accel.rows, (c,)),
            ("sup_min", accel.sup_min, (s, 3)),
            ("sup_max", accel.sup_max, (s, 3)),
            ("tree_box", accel.tree_box, (2 * c - 1, 6)),
            ("sup_tree_box", accel.sup_tree_box, (2 * s - 1, 6)),
            ("pages", accel.pages, (c, page_rows, 128)),
            ("ray_o", ray_o, (n, 3)), ("ray_d", ray_d, (n, 3)),
            ("maxt", maxt, (n,))):
        _build.require(kernel, name, t, f32, shape, dev)
    for name, t, shape in (("tree_link", accel.tree_link, (2 * c - 1,)),
                           ("sup_tree_link", accel.sup_tree_link,
                            (2 * s - 1,))):
        _build.require(kernel, name, t, torch.int32, shape, dev)
    _build.require(kernel, "active", active, torch.bool, (n,), dev)
    if stats is not None:
        _build.require(kernel, "stats", stats, torch.int64, (len(STATS),),
                       dev)
    lib = _build.library()
    t_out = torch.empty((n,), dtype=f32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.mitr_bvh_query(
            accel.aabb_min.data_ptr(), accel.aabb_max.data_ptr(),
            accel.rows.data_ptr(), accel.sup_min.data_ptr(),
            accel.sup_max.data_ptr(), accel.tree_box.data_ptr(),
            accel.tree_link.data_ptr(), accel.sup_tree_box.data_ptr(),
            accel.sup_tree_link.data_ptr(), accel.pages.data_ptr(), c, s,
            page_rows, ray_o.data_ptr(), ray_d.data_ptr(), maxt.data_ptr(),
            active.data_ptr(), n, n_closest, int(mode == "super"),
            t_out.data_ptr(), prim.data_ptr(),
            None if stats is None else stats.data_ptr(),
            _build.stream_of(dev))
    _build.check(err, kernel)
    trace.count_launch(kernel)
    return t_out, prim
