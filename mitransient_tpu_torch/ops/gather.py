"""Differentiable table lookups with a reproducible backward: kernel K8.

Counterpart of ``mitransient_tpu/ops/gather.py``, whose ``table_lookup``
and ``columns_lookup`` read every parameter table of a render (one-hot
matmuls on the TPU, so that the parameter gradient there is a dense matmul
and not a scatter).  Here :func:`gather_rows` reads the tables that carry
a gradient (the ``DiffParams`` fields: BSDF reflectance and roughness,
texels, emitter radiance and position, shape poses, media albedo and
extinction):

* forward: ``table.index_select(0, idx)``;
* backward: :func:`reduce_rows`, the sum of the lanes' cotangents onto
  each row in a fixed order, the same on every device and every run (the
  backward of ``index_select`` is an ``index_add_``, whose atomics on the
  card add in an order that changes from run to run);
* jvp: the gather of the tangent.

The order of :func:`reduce_rows` (``g`` (N, C) onto ``rows`` rows;
``tree32`` is the halving tree over 32 values, ``x[i] + x[i + 16]``, then
``+ 8``, ``+ 4``, ``+ 2``, ``+ 1``, the order of a warp's
``__shfl_down_sync`` reduction):

(a) at most :data:`TILE_MAX_ROWS` rows (the BSDF, emitter, shape and
    medium tables): the lanes are cut into tiles of :data:`TILE` = 1024
    (the last one padded with +0).  In a tile, each (row, channel) sums
    each group of 32 consecutive lanes by ``tree32``, lanes of other rows
    counting as +0, then the tile's 32 group sums by ``tree32``.  The
    tiles' partials are summed by :func:`sum_rows`.
(b) more rows (the texel atlas, through ``atlas_lookup``'s four taps):
    the lanes are put in row order by a stable sort of ``idx`` (its
    permutation is unique, so the same on every device).  Then
    :func:`run_levels` levels: each row's run is cut into groups of 32
    from its start (the last padded with +0), each group summed by
    ``tree32``, and the group sums form the row's run of the next level.
    After the last level a row holds one value, +0 for a row no lane
    reads.

On the CPU (and in the tests) the plain PyTorch version below computes
that order; on the card the wrapper launches K8 (``csrc/gather.cu``),
which adds in exactly the same order, so that the two are bit-equal.
There is no fallback: a K8 build or launch failure raises.

How the card reaches that order, in work proportional to the lanes:
(a) a block a tile stages its lanes in shared memory, every channel of a
block of up to 4 in one pass, and one thread a (group, row, channel)
evaluates ``tree32`` in registers (the other rows' lanes as +0), so a
group's cost grows by one tree a row.  (b) after the sort (on int16 keys
up to :data:`SHORT_KEY_ROWS` rows: the same permutation), one pass finds
each nonempty run by comparing sorted neighbours (no search over the
rows); a run of at most 32 lanes is summed by its first lane in
registers; a longer one is cut into chunks of 1024 lanes from its start
(a chunk's two levels of ``tree32`` are one tile's), a block a chunk, so
a run of millions spreads over the card; a block a long run then sums
its chunk sums level by level.  No host sync: the workspaces are sized by
``n`` alone.
"""
from __future__ import annotations

import math

import torch

from .. import trace
from ..kernels import _build

# the JAX package's ONEHOT_MAX_ROWS: above it the tiles' partials, one per
# (tile, row, channel), would outweigh the cotangents
TILE_MAX_ROWS = 128
TILE = 1024  # lanes of a tile in regime (a): 32 groups of 32
GROUP = 32  # a warp: the tree32 width
SHORT_KEY_ROWS = 1 << 15  # regime (b) sorts int16 keys up to this many rows


def sum_rows(x: torch.Tensor) -> torch.Tensor:
    """The sum over the leading axis of ``x`` in a fixed pairwise order,
    the same on every device: ``y[j] = x[j] + x[j + h]`` for ``h = n //
    2``, an odd row carried to ``y[h]``, until one row is left.
    ``torch.sum``'s order depends on the device and the shape, which parts
    the card's results from the CPU's in the last bits."""
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        y = x[:h] + x[h:2 * h]
        x = torch.cat([y, x[2 * h:]]) if x.shape[0] % 2 else y
    return x[0]


def tree32(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The halving tree over ``dim`` (of size 32), the dimension dropped."""
    for h in (16, 8, 4, 2, 1):
        x = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
    return x.squeeze(dim)


def run_levels(n: int) -> int:
    """Regime (b)'s levels for ``n`` lanes: the least L >= 1 with 32^L >=
    n, so that every row's run ends as one value."""
    levels, cap = 1, GROUP
    while cap < n:
        levels, cap = levels + 1, cap * GROUP
    return levels


def _reduce_tiles_plain(g: torch.Tensor, idx: torch.Tensor,
                        rows: int) -> torch.Tensor:
    """Regime (a) of :func:`reduce_rows` in PyTorch."""
    n, C = g.shape
    tiles = -(-n // TILE)
    part = g.new_zeros((tiles, rows, C))
    for r in torch.unique(idx).tolist():  # a row no lane reads stays +0
        v = torch.where((idx == r)[:, None], g, 0.0)
        v = torch.cat([v, v.new_zeros((tiles * TILE - n, C))])
        part[:, r] = tree32(tree32(v.reshape(tiles, GROUP, GROUP, C), 2), 1)
    return sum_rows(part)


def _reduce_runs_plain(g: torch.Tensor, idx: torch.Tensor,
                       rows: int) -> torch.Tensor:
    """Regime (b) of :func:`reduce_rows` in PyTorch."""
    n, C = g.shape
    dev = g.device
    sidx, perm = torch.sort(idx.to(torch.int32), stable=True)
    start = torch.searchsorted(
        sidx, torch.arange(rows + 1, dtype=torch.int32, device=dev))
    src, row = g.index_select(0, perm), sidx.to(torch.int64)
    for _ in range(run_levels(n)):
        length = start[1:] - start[:-1]
        glen = torch.div(length + GROUP - 1, GROUP, rounding_mode="floor")
        gstart = torch.cat([start.new_zeros(1), torch.cumsum(glen, 0)])
        pos = torch.arange(src.shape[0], device=dev) - start[row]
        gid = gstart[row] + torch.div(pos, GROUP, rounding_mode="floor")
        buf = g.new_zeros((int(gstart[-1]), GROUP, C))
        buf[gid, pos % GROUP] = src
        src, start = tree32(buf, 1), gstart
        row = torch.repeat_interleave(
            torch.arange(rows, device=dev), glen, output_size=src.shape[0])
    length = start[1:] - start[:-1]
    first = torch.clamp_max(start[:-1], max(src.shape[0] - 1, 0))
    return torch.where((length > 0)[:, None], src[first], 0.0)


def reduce_rows_plain(g: torch.Tensor, idx: torch.Tensor,
                      rows: int) -> torch.Tensor:
    """The plain version of K8: ``out[r] = sum of g[i] over idx[i] == r``
    in the order of the module docstring.  g: (N, C) f32; idx: (N,) ints
    in [0, rows) -> (rows, C)."""
    if g.shape[0] == 0:
        return g.new_zeros((rows, g.shape[1]))
    if rows <= TILE_MAX_ROWS:
        return _reduce_tiles_plain(g, idx, rows)
    return _reduce_runs_plain(g, idx, rows)


def reduce_rows(g: torch.Tensor, idx: torch.Tensor,
                rows: int) -> torch.Tensor:
    """The cotangents ``g`` (N, C) of a row gather summed onto the table's
    ``rows`` rows (``idx`` (N,) int32 or int64) -> (rows, C), in the fixed
    order of the module docstring.  CPU tensors take the plain version;
    CUDA tensors launch K8."""
    dev = g.device
    if dev.type == "cpu":
        return reduce_rows_plain(g, idx, rows)
    if dev.type != "cuda":
        raise ValueError(f"reduce_rows: cotangent on {dev}; expected cpu or "
                         "cuda")
    kernel = "reduce_rows"
    n, C = g.shape
    _build.require(kernel, "g", g, torch.float32, (n, C), dev)
    if idx.shape != (n,) or idx.device != dev:
        raise ValueError(f"reduce_rows: idx of shape {tuple(idx.shape)} on "
                         f"{idx.device}, expected ({n},) on {dev}")
    out = torch.zeros((rows, C), dtype=torch.float32, device=dev)
    if n == 0 or rows == 0 or C == 0:
        return out
    lib = _build.library()
    stream = _build.stream_of(dev)
    with torch.cuda.device(dev):
        if rows <= TILE_MAX_ROWS:
            idx32 = idx.to(torch.int32).contiguous()
            tiles = -(-n // TILE)
            part = torch.empty((tiles, rows * C), dtype=torch.float32,
                               device=dev)
            scratch = torch.empty(((tiles + 1) // 2, rows * C),
                                  dtype=torch.float32, device=dev)
            err = lib.mitr_reduce_rows_tiles(
                g.data_ptr(), idx32.data_ptr(), n, C, rows, part.data_ptr(),
                scratch.data_ptr(), out.data_ptr(), stream)
            _build.check(err, kernel)
        else:
            # the same permutation on int16 keys where the rows fit: half
            # the radix passes
            key = torch.int16 if rows <= SHORT_KEY_ROWS else torch.int32
            sidx, perm = torch.sort(idx.to(key), stable=True)
            # one workspace the kernel fills before it reads it: each run's
            # bounds, the long runs' rows, their chunk sums (two buffers)
            slots = 3 * -(-n // TILE) + 2
            runs = n // (TILE + 1) + 2
            work = torch.empty(2 * rows + runs + slots * C, dtype=torch.int64,
                               device=dev)
            level = work[2 * rows + runs:].view(torch.float32)
            err = lib.mitr_reduce_rows_runs(
                g.data_ptr(), sidx.data_ptr(), sidx.element_size(),
                perm.data_ptr(), n, C, rows, run_levels(n), work.data_ptr(),
                level.data_ptr(), work[2 * rows:].data_ptr(), out.data_ptr(),
                stream)
            _build.check(err, kernel)
    trace.count_launch(kernel)
    return out


class _GatherRows(torch.autograd.Function):
    """``table.index_select(0, idx)`` whose backward is :func:`reduce_rows`
    and whose jvp is the gather of the tangent."""

    @staticmethod
    def forward(table, idx):
        return table.index_select(0, idx)

    @staticmethod
    def setup_context(ctx, inputs, output):
        table, idx = inputs
        ctx.shape = table.shape
        ctx.save_for_backward(idx)
        ctx.save_for_forward(idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        rows, cols = ctx.shape[0], math.prod(ctx.shape[1:])
        flat = g.reshape(g.shape[0], cols).contiguous()
        return reduce_rows(flat, idx, rows).reshape(ctx.shape), None

    @staticmethod
    def jvp(ctx, t_table, _t_idx):
        (idx,) = ctx.saved_tensors
        return t_table.index_select(0, idx)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` along the leading axis for a parameter table that may
    carry a gradient: its backward adds the lanes onto the rows in the
    fixed order of :func:`reduce_rows` (K8 on the card)."""
    return _GatherRows.apply(table, idx)
