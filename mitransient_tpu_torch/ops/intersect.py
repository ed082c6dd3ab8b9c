"""Ray / triangle-soup intersection: kernels K1 (closest hit) and K2 (any
hit) and their plain PyTorch versions.

Counterpart of ``mitransient_tpu/ops/intersect.py`` (the contract) and
``ops/intersect_pallas.py`` (the TPU kernels).  :func:`closest_hit` and
:func:`ray_test` dispatch on where the rays lie: a CPU tensor takes the
plain version (:func:`intersect_soup`, :func:`ray_test_soup`), with or
without an acceleration structure, as the JAX package does on the CPU; a
CUDA tensor launches the BVH kernel of ``ops/bvh.py`` when the scene has
an accel, else the kernel of ``csrc/intersect.cu``, or raises.  The soup
kernels read the triangles as packed records (:func:`tri_table`), which a
scene builds once (``Triangles.table``) and the caller passes as
``table``.

The plain versions run Moller-Trumbore for all rays against chunks of
``TRI_CHUNK`` triangles at once, with each cross and dot product written
out in the TPU kernel's order, so that they round exactly like the CUDA
kernel (built with ``--fmad=false``).  Inside a chunk the first minimum
wins and across chunks a hit must be strictly nearer, so ties keep the
lowest triangle index, like the kernels' sequential sweep.
"""
from __future__ import annotations

import torch

from .. import trace
from ..kernels import _build
from . import bvh

TRI_CHUNK = 32
RAY_EPS = 1e-4
TABLE_WIDTH = 12  # floats of one packed triangle record (tri_table)


def _moller_trumbore(o, d, v0, e1, e2):
    """Rays (N, 3) against triangles (M, 3) -> (hit (N, M) bool without the
    far limit, t, u, v (N, M))."""
    rox, roy, roz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    rdx, rdy, rdz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    cv0x, cv0y, cv0z = v0[None, :, 0], v0[None, :, 1], v0[None, :, 2]
    ce1x, ce1y, ce1z = e1[None, :, 0], e1[None, :, 1], e1[None, :, 2]
    ce2x, ce2y, ce2z = e2[None, :, 0], e2[None, :, 1], e2[None, :, 2]
    px = rdy * ce2z - rdz * ce2y
    py = rdz * ce2x - rdx * ce2z
    pz = rdx * ce2y - rdy * ce2x
    det = ce1x * px + ce1y * py + ce1z * pz
    det_ok = torch.abs(det) > 1e-12
    inv_det = 1.0 / torch.where(det_ok, det, 1.0)
    tvx = rox - cv0x
    tvy = roy - cv0y
    tvz = roz - cv0z
    u = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * ce1z - tvz * ce1y
    qy = tvz * ce1x - tvx * ce1z
    qz = tvx * ce1y - tvy * ce1x
    v = (rdx * qx + rdy * qy + rdz * qz) * inv_det
    tt = (ce2x * qx + ce2y * qy + ce2z * qz) * inv_det
    hit = det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (tt > RAY_EPS)
    return hit, tt, u, v


def intersect_soup(v0, e1, e2, ray_o, ray_d, maxt, active):
    """Closest-hit query, plain version.

    Args:
      v0, e1, e2: (M, 3) triangle origin + edge vectors (world space).
      ray_o, ray_d: (N, 3); maxt: (N,); active: (N,) bool.
    Returns:
      t: (N,) hit distance (inf on miss), prim: (N,) int32 (-1 on miss),
      u, v: (N,) barycentrics of the hit.
    """
    n = ray_o.shape[0]
    best_t = torch.where(active, maxt, float("-inf"))
    best_i = torch.full((n,), -1, dtype=torch.int32, device=ray_o.device)
    best_u = torch.zeros((n,), dtype=torch.float32, device=ray_o.device)
    best_v = torch.zeros_like(best_u)
    for base in range(0, v0.shape[0], TRI_CHUNK):
        sl = slice(base, base + TRI_CHUNK)
        hit, tt, u, v = _moller_trumbore(ray_o, ray_d, v0[sl], e1[sl], e2[sl])
        t_masked = torch.where(hit & (tt < best_t[:, None]), tt, float("inf"))
        j = torch.argmin(t_masked, dim=1, keepdim=True)  # first minimum
        tj = torch.gather(t_masked, 1, j)[:, 0]
        found = torch.isfinite(tj)
        best_i = torch.where(found, base + j[:, 0].to(torch.int32), best_i)
        best_u = torch.where(found, torch.gather(u, 1, j)[:, 0], best_u)
        best_v = torch.where(found, torch.gather(v, 1, j)[:, 0], best_v)
        best_t = torch.where(found, tj, best_t)
    best_t = torch.where(best_i < 0, float("inf"), best_t)
    return best_t, best_i, best_u, best_v


def ray_test_soup(v0, e1, e2, ray_o, ray_d, maxt, active):
    """Any-hit (shadow ray) query, plain version -> (N,) bool occluded."""
    limit = torch.where(active, maxt, float("-inf"))
    occluded = torch.zeros(ray_o.shape[0], dtype=torch.bool,
                           device=ray_o.device)
    for base in range(0, v0.shape[0], TRI_CHUNK):
        sl = slice(base, base + TRI_CHUNK)
        hit, tt, _u, _v = _moller_trumbore(ray_o, ray_d, v0[sl], e1[sl],
                                           e2[sl])
        occluded = occluded | (hit & (tt < limit[:, None])).any(dim=1)
    return occluded & active


def closest_hit(v0, e1, e2, ray_o, ray_d, maxt, active, accel=None,
                bvh_mode=bvh.BVH_MODE, table=None):
    """Closest hit returning (t (N,) f32, prim (N,) int32): the plain
    version for CPU tensors; for CUDA tensors the BVH kernel in
    ``bvh_mode`` when ``accel`` is given, else kernel K1 on ``table``, the
    soup's :func:`tri_table` (a scene keeps it as ``Triangles.table``)."""
    if ray_o.device.type == "cpu":
        t, prim, _u, _v = intersect_soup(v0, e1, e2, ray_o, ray_d, maxt,
                                         active)
        return t, prim
    if accel is not None:
        return bvh.closest_hit_bvh(accel, ray_o, ray_d, maxt, active,
                                   bvh_mode)
    return _soup_kernel("closest_hit", table, v0.shape[0], ray_o, ray_d,
                        maxt, active)


def ray_test(v0, e1, e2, ray_o, ray_d, maxt, active, accel=None,
             bvh_mode=bvh.BVH_MODE, table=None):
    """Occlusion (N,) bool: the plain version for CPU tensors; for CUDA
    tensors the BVH kernel in ``bvh_mode`` when ``accel`` is given, else
    kernel K2 on ``table`` (as for :func:`closest_hit`)."""
    if ray_o.device.type == "cpu":
        return ray_test_soup(v0, e1, e2, ray_o, ray_d, maxt, active)
    if accel is not None:
        return bvh.ray_test_bvh(accel, ray_o, ray_d, maxt, active, bvh_mode)
    return _soup_kernel("ray_test", table, v0.shape[0], ray_o, ray_d, maxt,
                        active)


def tri_table(v0, e1, e2) -> torch.Tensor:
    """(M, 12) f32 packed 48-byte records (v0x v0y v0z e1x | e1y e1z e2x e2y
    | e2z 0 0 0): the kernels' triangle layout, three 16-byte loads a
    triangle.  Built once per scene (``Triangles.table``), not per launch."""
    pad = v0.new_zeros((v0.shape[0], TABLE_WIDTH - 9))
    return torch.cat([v0, e1, e2, pad], dim=1).contiguous()


def _soup_kernel(kernel, table, m, ray_o, ray_d, maxt, active):
    dev = ray_o.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: rays on {dev}; expected cpu or cuda")
    if table is None:
        raise ValueError(f"{kernel}: pass table=tri_table(v0, e1, e2) (a "
                         "scene's Triangles.table), built once per scene")
    n = ray_o.shape[0]
    f32 = torch.float32
    for name, t, shape in (("table", table, (m, TABLE_WIDTH)),
                           ("ray_o", ray_o, (n, 3)), ("ray_d", ray_d, (n, 3)),
                           ("maxt", maxt, (n,))):
        _build.require(kernel, name, t, f32, shape, dev)
    _build.require(kernel, "active", active, torch.bool, (n,), dev)
    if table.data_ptr() % 16:
        raise ValueError(f"{kernel}: table must be 16-byte aligned")
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = _build.stream_of(dev)
        if kernel == "closest_hit":
            t = torch.empty((n,), dtype=f32, device=dev)
            prim = torch.empty((n,), dtype=torch.int32, device=dev)
            err = lib.mitr_closest_hit(
                table.data_ptr(), m, ray_o.data_ptr(), ray_d.data_ptr(),
                maxt.data_ptr(), active.data_ptr(), n, t.data_ptr(),
                prim.data_ptr(), stream)
            out = (t, prim)
        else:
            occ = torch.empty((n,), dtype=torch.bool, device=dev)
            err = lib.mitr_ray_test(
                table.data_ptr(), m, ray_o.data_ptr(), ray_d.data_ptr(),
                maxt.data_ptr(), active.data_ptr(), n, occ.data_ptr(), stream)
            out = occ
    _build.check(err, kernel)
    trace.count_launch(kernel)
    return out
