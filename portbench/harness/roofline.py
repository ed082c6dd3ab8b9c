"""Roofline arithmetic of the benchmark, frozen from ``chip_smoke.py``
(``HBM_BYTES_PER_S``, ``FP32_OPS_PER_S``, ``MT_OPS``, ``_bound``,
``ray_bytes``), so that a later change to the program's own script cannot
move the yardstick.

Peaks: NVIDIA's H100 SXM data sheet, dense rates: 3.35 TB/s of HBM and
67 TFLOP/s of float32 outside the tensor cores, at the 700 W power limit.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations of one Moller-Trumbore ray / triangle test: 2 crosses,
# 3 dots, 4 subtractions, 1 division, u + v
MT_OPS = 46
# bytes of one ray a soup query must read: origin, direction, maxt
RAY_INPUT_BYTES = 12 + 12 + 4


def bound_s(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least seconds, what bounds them): the larger of the bytes over the
    HBM rate and the float32 operations over the float32 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / FP32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ray_bytes(n_rays: int, n_active: int, out_bytes: int) -> int:
    """Bytes a soup query must move: every ray's active flag and result,
    and the origin, direction and maxt of the active rays only."""
    return n_rays * (1 + out_bytes) + n_active * RAY_INPUT_BYTES


def film_sectors(transient) -> int:
    """32-byte sectors (8 pixels of one channel and bin) of a transient
    film (H, W, T, C) that hold a nonzero value: what a splat of its events
    must at least read and write once."""
    import torch

    h, w, t, c = transient.shape
    nz = transient.reshape(h * w, t, c) != 0
    pad = (-h * w) % 8
    if pad:
        nz = torch.cat([nz, nz.new_zeros((pad, t, c))])
    return int(nz.reshape(-1, 8, t, c).any(dim=1).sum())
