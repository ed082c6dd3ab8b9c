"""Chunked acceleration structure for large scenes (host-side build).

Counterpart of ``mitransient_tpu/ops/accel.py``, on numpy, building the same
tables bit for bit; the tensors move to the scene's device once.

Triangles are ordered by the native SAH builder (``native.build_bvh``),
then cut into subtree-aligned chunks of at most ``2 * CHUNK_TRIS``
triangles.  Each chunk is a page of Woop triangle records plus one AABB;
groups of ``SUPER_CHUNKS`` consecutive chunks share a super-chunk AABB.
Binary trees over the chunk boxes and over the super-chunk boxes
(:func:`chunk_tree`, :func:`accel_trees`: the port's own tables; the JAX
package has none) let the BVH kernel of ``ops/bvh.py`` visit the chunks
(chunk mode) or the super-chunks (super mode) front to back without
scanning them all.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import native

CHUNK_TRIS = 256  # target triangles per chunk; subtree cuts are <= 2x this
ACCEL_MIN_TRIS = 4096  # scenes above this triangle count get an Accel
SUPER_CHUNKS = 8  # chunks per super-chunk
# Accel fields that accel_trees derives from the chunk and super-chunk
# bounds; the JAX package's Accel has the others
TREE_FIELDS = ("tree_box", "tree_link", "sup_tree_box", "sup_tree_link")


class Accel(NamedTuple):
    """Device tables; the field layout of the JAX package's ``Accel``."""

    aabb_min: torch.Tensor  # (C, 3) f32 chunk bounds
    aabb_max: torch.Tensor  # (C, 3) f32
    sup_min: torch.Tensor  # (ceil(C/8), 3) f32 super-chunk bounds
    sup_max: torch.Tensor  # (ceil(C/8), 3) f32
    pages: torch.Tensor  # (C, cap // 8, 128) f32: 8 triangles x 16 fields
    #   per row: A = [e1 e2 n]^-1 row-major (fields 0:9), original prim id
    #   (-1 pad, field 9), c = A @ v0 (fields 10:13), 3 spare
    rows: torch.Tensor  # (C,) f32 rows of 8 triangles used per page
    tree_box: torch.Tensor  # (2C-1, 6) f32 chunk-tree node bounds, min | max
    tree_link: torch.Tensor  # (2C-1,) int32: right child, or -1 - chunk
    sup_tree_box: torch.Tensor  # (2S-1, 6) f32 super-tree node bounds
    sup_tree_link: torch.Tensor  # (2S-1,) int32: right child, or -1 - super


def woop_records(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray):
    """Per-triangle Woop transforms (f64 build -> f32): A = [e1 e2 n]^-1,
    c = A @ v0.  For a ray (o, d): s = A@o - c, r = A@d, t = -s_z/r_z,
    u = s_x + t*r_x, v = s_y + t*r_y.  Degenerate triangles get A = 0, so
    r_z = 0 and they never hit."""
    v0 = np.asarray(v0, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    n = np.cross(e1, e2)
    m = np.stack([e1, e2, n], axis=-1)  # (M, 3, 3) columns e1 e2 n
    det = np.linalg.det(m)
    # scale-invariant degeneracy test: det = |n|^2 = (|e1||e2| sin a)^2
    l1 = np.linalg.norm(e1, axis=-1)
    l2 = np.linalg.norm(e2, axis=-1)
    ok = np.sqrt(np.abs(det)) > 1e-6 * l1 * l2
    m_safe = np.where(ok[:, None, None], m, np.eye(3)[None])
    a = np.linalg.inv(m_safe)
    a = np.where(ok[:, None, None], a, 0.0)  # (M, 3, 3) rows a0 a1 a2
    c = np.einsum("mij,mj->mi", a, v0)
    return a.astype(np.float32), c.astype(np.float32)


def _subtree_ranges(glob, m: int, max_tris: int):
    """Cut the builder's tree into subtree-aligned contiguous prim ranges
    of at most ``max_tris`` each.  Builder nodes: leaves have left=-1,
    right=offset into prim_order, count=#prims; children are numbered after
    their parent, so one reverse pass gives every node's range."""
    left = np.asarray(glob["left"])
    right = np.asarray(glob["right"])
    count = np.asarray(glob["count"])
    n_nodes = left.shape[0]
    lo_r = np.zeros(n_nodes, np.int64)
    hi_r = np.zeros(n_nodes, np.int64)
    for nid in range(n_nodes - 1, -1, -1):
        if left[nid] < 0:
            lo_r[nid] = right[nid]
            hi_r[nid] = right[nid] + count[nid]
        else:
            lo_r[nid] = min(lo_r[left[nid]], lo_r[right[nid]])
            hi_r[nid] = max(hi_r[left[nid]], hi_r[right[nid]])

    ranges = []
    stack = [0]
    while stack:
        nid = stack.pop()
        a, b = int(lo_r[nid]), int(hi_r[nid])
        if b - a <= max_tris or left[nid] < 0:
            ranges.append((a, b))
        else:
            stack.append(int(right[nid]))
            stack.append(int(left[nid]))
    ranges.sort()
    end = 0
    for a, b in ranges:
        assert a == end, (a, end)
        end = b
    assert end == m, (end, m)
    return ranges


def chunk_tree(aabb_min: np.ndarray,
               aabb_max: np.ndarray) -> dict[str, np.ndarray]:
    """Binary tree over the C chunk boxes, as the Accel's ``tree_*`` tables.

    Every node covers a contiguous range of chunk ids and its leaves are
    chunks 0..C-1 in order.  Nodes are numbered in preorder: node i's left
    child is i + 1, ``tree_link[i]`` its right child; a leaf has
    ``tree_link = -1 - chunk``.  So for two nodes of which neither contains
    the other, the lower number covers the lower chunk ids.  A node's box
    ``tree_box[i] = [min xyz, max xyz]`` is the exact float32 min/max of its
    chunks' boxes, hence of its children's.  Ranges are split where the
    surface-area heuristic (box area times chunk count, both sides) is
    least, the first such split on ties.  Built from the bounds alone, so
    an Accel carried across from the JAX package gets the same tree."""
    lo_b = np.asarray(aabb_min, np.float32)
    hi_b = np.asarray(aabb_max, np.float32)
    c = lo_b.shape[0]
    box = np.zeros((2 * c - 1, 6), np.float32)
    link = np.zeros(2 * c - 1, np.int32)

    def half_area(lo, hi):
        e = (hi - lo).astype(np.float64)
        return (e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2]
                + e[..., 2] * e[..., 0])

    stack = [(0, 0, c)]  # (node, first chunk, end chunk)
    while stack:
        node, a, b = stack.pop()
        box[node, :3] = lo_b[a:b].min(axis=0)
        box[node, 3:] = hi_b[a:b].max(axis=0)
        if b - a == 1:
            link[node] = -1 - a
            continue
        # left part [a, a+k), right part [a+k, b) for k = 1 .. b-a-1
        left = half_area(np.minimum.accumulate(lo_b[a:b - 1]),
                         np.maximum.accumulate(hi_b[a:b - 1]))
        right = half_area(np.minimum.accumulate(lo_b[b - 1:a:-1])[::-1],
                          np.maximum.accumulate(hi_b[b - 1:a:-1])[::-1])
        k = np.arange(1, b - a)
        m = a + 1 + int(np.argmin(left * k + right * (b - a - k)))
        link[node] = node + 2 * (m - a)  # after the left subtree's nodes
        stack.append((link[node], m, b))
        stack.append((node + 1, a, m))
    return {"tree_box": box, "tree_link": link}


def accel_trees(aabb_min, aabb_max, sup_min,
                sup_max) -> dict[str, np.ndarray]:
    """The Accel's :data:`TREE_FIELDS`: :func:`chunk_tree` over the chunk
    boxes, and over the super-chunk boxes as ``sup_tree_*``."""
    sup = chunk_tree(sup_min, sup_max)
    return {**chunk_tree(aabb_min, aabb_max),
            "sup_tree_box": sup["tree_box"],
            "sup_tree_link": sup["tree_link"]}


def build_accel_numpy(v0: np.ndarray, e1: np.ndarray,
                      e2: np.ndarray) -> dict[str, np.ndarray]:
    """The Accel tables as host arrays, keyed by field."""
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    m = v0.shape[0]
    glob = native.build_bvh(v0, e1, e2, leaf_size=8)
    order = np.asarray(glob["prim_order"], np.int64)
    gv0, ge1, ge2 = v0[order], e1[order], e2[order]
    ga, gc = woop_records(gv0, ge1, ge2)

    ranges = _subtree_ranges(glob, m, 2 * CHUNK_TRIS)
    c = len(ranges)
    cap = max(8, -(-max(b - a for a, b in ranges) // 8) * 8)
    tri16 = np.zeros((c, cap, 16), np.float32)
    tri16[:, :, 9] = -1.0
    aabb_min = np.zeros((c, 3), np.float32)
    aabb_max = np.zeros((c, 3), np.float32)
    used_rows = np.zeros((c,), np.float32)
    for ci, (lo, hi) in enumerate(ranges):
        n_i = hi - lo
        used_rows[ci] = -(-n_i // 8)
        tri16[ci, :n_i, 0:9] = ga[lo:hi].reshape(n_i, 9)
        tri16[ci, :n_i, 9] = order[lo:hi].astype(np.float32)
        tri16[ci, :n_i, 10:13] = gc[lo:hi]
        pts = np.concatenate([
            gv0[lo:hi], gv0[lo:hi] + ge1[lo:hi], gv0[lo:hi] + ge2[lo:hi]])
        aabb_min[ci] = pts.min(axis=0)
        aabb_max[ci] = pts.max(axis=0)

    spad = (-c) % SUPER_CHUNKS
    smin = np.concatenate([aabb_min, np.full((spad, 3), 1.0, np.float32)])
    smax = np.concatenate([aabb_max, np.full((spad, 3), -1.0, np.float32)])
    sup_min = smin.reshape(-1, SUPER_CHUNKS, 3).min(axis=1)
    sup_max = smax.reshape(-1, SUPER_CHUNKS, 3).max(axis=1)
    return {
        "aabb_min": aabb_min,
        "aabb_max": aabb_max,
        "sup_min": sup_min,
        "sup_max": sup_max,
        "pages": tri16.reshape(c, cap // 8, 128),
        "rows": used_rows,
        **accel_trees(aabb_min, aabb_max, sup_min, sup_max),
    }


def build_accel(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                device="cuda") -> Accel:
    """Build chunk pages + AABBs from a triangle soup on the host, then move
    each table to ``device`` once."""
    host = build_accel_numpy(v0, e1, e2)
    return Accel(**{k: torch.from_numpy(a).to(device) for k, a in host.items()})


def closest_hit_reference(accel: Accel, ray_o, ray_d, maxt):
    """Scalar numpy walk of the chunks front to back in float64: checks the
    chunk structure independently of the brute-force sweep and of
    ``ops/bvh.py``."""
    amin = accel.aabb_min.cpu().numpy()
    amax = accel.aabb_max.cpu().numpy()
    pages = accel.pages.cpu().numpy()
    c = amin.shape[0]
    n_rays = ray_o.shape[0]
    out_t = np.full(n_rays, np.inf, np.float32)
    out_prim = np.full(n_rays, -1, np.int32)
    cap = pages.shape[1] * 8

    for r in range(n_rays):
        o = np.asarray(ray_o[r], np.float64)
        d = np.asarray(ray_d[r], np.float64)
        inv_d = 1.0 / np.where(np.abs(d) < 1e-12,
                               np.where(d < 0, -1e-12, 1e-12), d)
        best_t = float(maxt[r])
        best_p = -1
        t0 = (amin - o) * inv_d
        t1 = (amax - o) * inv_d
        tn = np.maximum(np.minimum(t0, t1).max(axis=1), 1e-4)
        tf = np.minimum(np.maximum(t0, t1).min(axis=1), best_t)
        hits = [(tn[ci], ci) for ci in range(c) if tn[ci] <= tf[ci]]
        for entry, ci in sorted(hits):
            if entry >= best_t:
                break
            tris = pages[ci].reshape(cap, 16)
            for k in range(cap):
                a = tris[k, 0:9].astype(np.float64).reshape(3, 3)
                cc = tris[k, 10:13].astype(np.float64)
                rv = a @ d
                if abs(rv[2]) < 1e-12:
                    continue
                s = a @ o - cc
                tt = -s[2] / rv[2]
                u = s[0] + tt * rv[0]
                v = s[1] + tt * rv[1]
                if (u >= 0.0 and v >= 0.0 and u + v <= 1.0
                        and tt > 1e-4 and tt < best_t):
                    best_t = tt
                    best_p = int(tris[k, 9])
        if best_p >= 0:
            out_t[r] = best_t
            out_prim[r] = best_p
    return out_t, out_prim
