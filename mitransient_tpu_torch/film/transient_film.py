"""Transient film: time-binned radiance accumulation, with kernel K3.

Counterpart of ``mitransient_tpu/film/transient_film.py`` and of the splat
kernel ``ops/splat_pallas.py``.

* The transient film's spatial filter is a box, so the pixel of every lane
  is fixed: lanes are spp-major (lane = s*HW + p) and a splat is a
  per-pixel histogram over time only.
* The transient buffer is ``(C, T + 1, HW)``: bin T is the overflow slot
  for out-of-range samples, which ``develop`` drops.  The JAX package pads
  T and HW further for its Pallas tiles; the port has no such padding.
  With a crop window HW is the window's pixel count.
* OPL -> bin: ``bin = floor((distance - start_opl) / bin_width_opl)``.
* :func:`splat_accumulate` adds one or two event sets into the film in
  place: the plain :func:`_scatter_layout` for CPU tensors, the kernel of
  ``csrc/splat.cu`` for CUDA tensors.  The splats of a render go through
  :class:`SplatEvents`, its autograd Function, so that a differentiated
  render keeps K3 on the card: its backward is a gather of the film's
  cotangent at each event's cell, its jvp K3 on the tangent values (the
  JAX package instead reroutes AD through XLA's scatter,
  ``xla_splat_scope``, because its Pallas kernel has no AD rules).  :func:`splat_transient_flat` splats
  into a film whose pixel axis is any flat layout of slots (the exhaustive
  NLOS capture's laser x scan-pixel slots).
* ``temporal_filter='gaussian'`` spreads each event over a +-3 sigma window
  of K bins with normalized Gaussian weights (:func:`gaussian_taps`), laid
  out as spp * K lanes of K3's events, and adds them through
  :class:`SplatEvents`: every film cell adds its taps in lane order, a
  lane's in tap order, as the JAX package's XLA scatter and the plain
  version's ``index_add_`` on the CPU do; so this film too is the same on
  every run and on both devices.
* The steady image accumulates the per-lane total L once per pass as a
  dense spp-axis reduction (:func:`splat_steady`), or under a gaussian
  spatial filter (:func:`splat_steady_gaussian`), both in the fixed order
  of :func:`sum_rows`.
* ``*_any`` dispatch on the film kind: the transient histogram here, the
  phasor film of ``film/phasor_film.py``.
* Inside :func:`splatting_at` (a pass captured into a CUDA graph,
  ``passgraph.py``) K3's launches on the film named there read the film's
  address from a device slot when they run, so that every render replays
  the graph into a film of its own.
"""
from __future__ import annotations

import contextlib
import logging
import math
import threading
from typing import NamedTuple

import torch
from torch.autograd.graph import increment_version

from .. import trace
from ..core.math import divide, exp
from ..kernels import _build
from ..ops.gather import sum_rows
from ..scene.schema import FilmConfig

_local = threading.local()  # .film_at: (film, its address slot), or None


class TransientFilmState(NamedTuple):
    steady: torch.Tensor  # (HW, C) accumulated radiance * filter weight
    steady_weight: torch.Tensor  # (HW,) accumulated filter weight
    transient: torch.Tensor  # (C, T + 1, HW); bin T = overflow (dropped)
    n_negative: torch.Tensor  # () f32 - splats with a value < -1e-5
    n_invalid: torch.Tensor  # () f32 - splats with a non-finite value


def film_init(cfg: FilmConfig, channels: int, scan_pixels: int | None = None,
              device="cpu") -> TransientFilmState:
    """A zeroed film of ``scan_pixels`` pixels (a crop window's), by default
    the whole film's."""
    hw = scan_pixels if scan_pixels is not None else cfg.width * cfg.height
    f32 = torch.float32
    return TransientFilmState(
        steady=torch.zeros((hw, channels), dtype=f32, device=device),
        steady_weight=torch.zeros((hw,), dtype=f32, device=device),
        transient=torch.zeros((channels, cfg.temporal_bins + 1, hw),
                              dtype=f32, device=device),
        n_negative=torch.zeros((), dtype=f32, device=device),
        n_invalid=torch.zeros((), dtype=f32, device=device),
    )


def time_bin(cfg: FilmConfig, distance: torch.Tensor):
    """OPL -> (bin index int32, in-range mask); out of range -> bin T.

    The mask is applied to the float before the cast: casting inf or nan
    to int32 is unspecified."""
    pos = divide(distance - cfg.start_opl, cfg.bin_width_opl)
    ok = (pos >= 0.0) & (pos < cfg.temporal_bins)
    b = torch.where(ok, torch.floor(pos), float(cfg.temporal_bins))
    return b.to(torch.int32), ok


def splat_transient_pair(
    state: TransientFilmState,
    cfg: FilmConfig,
    spp: int,
    dist_a: torch.Tensor,  # (N,) OPL of event set A (emitter hits)
    val_a: torch.Tensor,  # (N, C) scaled values
    dist_b: torch.Tensor | None,  # (N,) OPL of event set B (NEE) or None
    val_b: torch.Tensor | None,
    active: torch.Tensor,  # (N,) bool
    temporal_filter: str = "",
    gaussian_stddev: float = 2.0,
) -> TransientFilmState:
    """Accumulate one bounce's transient contributions (emitter hit + NEE
    in one call).  Lanes are spp-major; ``spp`` is the lane rows per pixel.
    The film tensor is updated in place and returned in the new state."""
    if cfg.warn_negative or cfg.warn_invalid:
        state = _count_suspect(state, cfg, val_a, val_b, active)
    if temporal_filter == "gaussian":
        taps = [gaussian_taps(cfg, dist, val, active, gaussian_stddev, spp)
                for dist, val in ((dist_a, val_a), (dist_b, val_b))
                if dist is not None]
        (bins_a, vals_a), (bins_b, vals_b) = (taps + [(None, None)])[:2]
        lanes = bins_a.shape[0] // state.transient.shape[-1]  # spp * K
        film = SplatEvents.apply(state.transient, bins_a, vals_a, bins_b,
                                 vals_b, lanes)
        return state._replace(transient=film)
    bins_a, _ = time_bin(cfg, dist_a)
    va = torch.where(active[:, None], val_a, 0.0)
    bins_b = vb = None
    if dist_b is not None:
        bins_b, _ = time_bin(cfg, dist_b)
        vb = torch.where(active[:, None], val_b, 0.0)
    film = SplatEvents.apply(state.transient, bins_a, va, bins_b, vb, spp)
    return state._replace(transient=film)


def splat_transient_flat(
    state: TransientFilmState,
    cfg: FilmConfig,
    spp: int,
    dist: torch.Tensor,  # (N,) OPL, N = spp * slots, spp-major
    val: torch.Tensor,  # (N, C) scaled values
    active: torch.Tensor,  # (N,) bool
) -> TransientFilmState:
    """Splat one event set into a film whose pixel axis is a flat layout of
    ``slots = state.transient.shape[-1]`` slots, through K3: the exhaustive
    NLOS capture, where slot = laser * scan_pixels + scan_pixel.  The
    steady image is not touched."""
    if cfg.warn_negative or cfg.warn_invalid:
        state = _count_suspect(state, cfg, val, None, active)
    bins, _ = time_bin(cfg, dist)
    v = torch.where(active[:, None], val, 0.0)
    film = SplatEvents.apply(state.transient, bins, v, None, None, spp)
    return state._replace(transient=film)


def gaussian_taps(cfg: FilmConfig, distance, value, active, sigma,
                  spp: int):
    """One event set (N = spp * HW spp-major lanes) under the gaussian
    temporal filter, as K3's events: each event spread over the K = 2
    ceil(3 sigma) + 1 bins around its own with normalized Gaussian
    weights, bins outside the film sent to the overflow bin T -> (bins
    (spp * K * HW,) int32, values (spp * K * HW, C)), where lane (s * K +
    k) * HW + p holds tap k of lane s of pixel p.  K3 at spp * K lanes
    therefore adds each film cell's taps in lane order and a lane's in tap
    order, the order of the JAX package's scatter.  The weights go through
    ``core.math.exp`` and are normalized by a :func:`sum_rows` over the
    taps, so that they round alike on the card and on the CPU."""
    n, C = value.shape
    hw = n // spp
    value = torch.where(active[:, None], value, 0.0).reshape(spp, 1, hw, C)
    radius = max(1, int(math.ceil(3.0 * sigma)))
    pos = divide(distance - cfg.start_opl, cfg.bin_width_opl).reshape(
        spp, 1, hw)
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32,
                        device=value.device)
    b = torch.floor(pos) + offs[None, :, None]  # (spp, K, HW)
    x = divide(b + 0.5 - pos, sigma)
    w = exp(-0.5 * (x * x))
    w = w / torch.clamp_min(sum_rows(w.transpose(0, 1)), 1e-20)[:, None]
    ok = (b >= 0) & (b < cfg.temporal_bins)
    bins = torch.where(ok, b, float(cfg.temporal_bins)).to(torch.int32)
    return bins.reshape(-1), (value * w[..., None]).reshape(-1, C)


def splat_pair_any(state, cfg: FilmConfig, spp, dist_a, val_a, dist_b, val_b,
                   active, temporal_filter="", gaussian_stddev=2.0):
    """Film-kind dispatch: the phasor film or the transient histogram."""
    if cfg.kind == "phasor_hdr_film":
        from .phasor_film import splat_phasor_pair

        return splat_phasor_pair(state, cfg, spp, dist_a, val_a, dist_b,
                                 val_b, active)
    return splat_transient_pair(state, cfg, spp, dist_a, val_a, dist_b,
                                val_b, active, temporal_filter,
                                gaussian_stddev)


def film_init_any(cfg: FilmConfig, channels: int,
                  scan_pixels: int | None = None, device="cpu"):
    if cfg.kind == "phasor_hdr_film":
        from .phasor_film import phasor_film_init

        return phasor_film_init(cfg, channels, device=device)
    return film_init(cfg, channels, scan_pixels, device=device)


def develop_any(state, cfg: FilmConfig, shape_hw=None):
    if cfg.kind == "phasor_hdr_film":
        from .phasor_film import develop_phasor

        return develop_phasor(state, cfg)
    return develop(state, cfg, shape_hw)


def _count_suspect(state: TransientFilmState, cfg: FilmConfig,
                   val_a, val_b, active) -> TransientFilmState:
    """Count offending *samples* (any channel) among active lanes for the
    opt-in warn_negative / warn_invalid validation."""
    neg = state.n_negative
    inv = state.n_invalid
    for v in (val_a, val_b):
        if v is None:
            continue
        if cfg.warn_negative:
            bad = (v < -1e-5).any(dim=-1) & active
            neg = neg + bad.sum(dtype=torch.float32)
        if cfg.warn_invalid:
            bad = (~torch.isfinite(v)).any(dim=-1) & active
            inv = inv + bad.sum(dtype=torch.float32)
    return state._replace(n_negative=neg, n_invalid=inv)


def _scatter_layout(film: torch.Tensor, hw: int, bins: torch.Tensor,
                    vals: torch.Tensor) -> None:
    """Plain version of one event set of K3: ``film[c, bins[i], i % hw] +=
    vals[i, c]`` in place, bins outside the film dropped.

    On the CPU ``index_add_`` on a 1-D view adds in index order, so every
    film cell sums its lanes in lane order, like the kernel.  On the card
    it uses atomics, whose order varies from run to run."""
    pix = torch.arange(bins.shape[0], device=bins.device) % hw
    _scatter_cells(film, pix, bins, vals)


def _cell_index(t_pad: int, hw: int, pix: torch.Tensor, bins: torch.Tensor):
    """The flat (T_pad * HW) cell of ``film[:, bins[i], pix[i]]`` in a (C,
    T_pad, HW) film for every lane, and the in-film mask (N,); a lane whose
    bin lies outside the film points at cell 0."""
    keep = (bins >= 0) & (bins < t_pad)
    return torch.where(keep, bins.to(torch.int64) * hw + pix, 0), keep


def _scatter_cells(film: torch.Tensor, pix: torch.Tensor, bins: torch.Tensor,
                   vals: torch.Tensor) -> None:
    """``film[c, bins[i], pix[i]] += vals[i, c]`` in place, in the order of
    i, then c; bins outside the film dropped (a dropped lane adds 0.0 to
    cell 0)."""
    C, t_pad, hw = film.shape
    cell, keep = _cell_index(t_pad, hw, pix, bins)
    chan = torch.arange(C, device=bins.device) * (t_pad * hw)
    idx = cell[:, None] + chan[None, :]  # (N, C) lane-major
    src = torch.where(keep[:, None], vals, 0.0).reshape(-1)
    film.view(-1).index_add_(0, idx.reshape(-1), src)


def gather_index(bins: torch.Tensor, shape):
    """The cells that :func:`gather_cells` reads for one event set into a
    (C, T_pad, HW) film: (the flat (T_pad * HW) cell of every lane, 0 where
    the bin lies outside the film; the in-film mask (N,))."""
    _C, t_pad, hw = shape
    pix = torch.arange(bins.shape[0], device=bins.device) % hw
    return _cell_index(t_pad, hw, pix, bins)


def gather_cells(g_film: torch.Tensor, cell: torch.Tensor,
                 keep: torch.Tensor) -> torch.Tensor:
    """``g_film[c, bins[i], i % hw]`` for every lane and channel, 0 where
    the bin lies outside the film (``cell, keep = gather_index(bins,
    g_film.shape)``): the cotangent (N, C) of one event set's values under
    :func:`splat_accumulate`."""
    g = g_film.reshape(g_film.shape[0], -1).index_select(1, cell)
    return torch.where(keep[:, None], g.T, 0.0)


def splat_accumulate(film: torch.Tensor, bins_a: torch.Tensor,
                     vals_a: torch.Tensor, bins_b: torch.Tensor | None,
                     vals_b: torch.Tensor | None, *, spp: int) -> None:
    """Add one or two event sets into ``film`` (C, T_pad, HW) in place.

    bins: (N,) int32 with N = spp * HW, spp-major lanes; vals: (N, C) f32,
    already masked and scaled.  Set a is added before set b, each in lane
    order.  CPU tensors take the plain version; CUDA tensors launch K3."""
    C, t_pad, hw = film.shape
    if film.device.type == "cpu":
        _scatter_layout(film, hw, bins_a, vals_a)
        if bins_b is not None:
            _scatter_layout(film, hw, bins_b, vals_b)
        return
    dev = film.device
    if dev.type != "cuda":
        raise ValueError(f"splat_accumulate: film on {dev}; expected cpu or cuda")
    n = spp * hw
    kernel = "splat_accumulate"
    _build.require(kernel, "film", film, torch.float32, (C, t_pad, hw), dev)
    sets = [(bins_a, vals_a)] + ([(bins_b, vals_b)] if bins_b is not None
                                 else [])
    for k, (b, v) in enumerate(sets):
        _build.require(kernel, f"bins[{k}]", b, torch.int32, (n,), dev)
        _build.require(kernel, f"vals[{k}]", v, torch.float32, (n, C), dev)
    check_pixel_slab(C, t_pad)
    lib = _build.library()
    at = getattr(_local, "film_at", None)
    if at is not None and at[0].data_ptr() == film.data_ptr():
        entry, where = lib.mitr_splat_accumulate_at, at[1].data_ptr()
    else:
        entry, where = lib.mitr_splat_accumulate, film.data_ptr()
    with torch.cuda.device(dev):
        err = entry(
            where, C, t_pad, hw, spp,
            bins_a.data_ptr(), vals_a.data_ptr(),
            bins_b.data_ptr() if bins_b is not None else None,
            vals_b.data_ptr() if vals_b is not None else None,
            _build.stream_of(dev))
    _build.check(err, kernel)
    trace.count_launch(kernel)
    # the kernel wrote through a raw pointer: bump the film's version as an
    # in-place torch op would, which forward-mode AD checks for in
    # SplatEvents.jvp's in-place update of the film's tangent
    increment_version(film)


@contextlib.contextmanager
def splatting_at(film: torch.Tensor, slot: torch.Tensor):
    """Inside, K3's launches on ``film`` (a (C, T + 1, HW) CUDA tensor)
    splat into the film whose address the one int64 of ``slot`` holds when
    they run, which must have ``film``'s shape and layout."""
    _local.film_at = (film, slot)
    try:
        yield
    finally:
        _local.film_at = None


class SplatEvents(torch.autograd.Function):
    """K3 (:func:`splat_accumulate`) with autograd rules; it adds one or
    two event sets into ``film`` (C, T + 1, HW) in place and returns it.

    * backward: the film's cotangent passes through, and each event value's
      cotangent is :func:`gather_cells` of it (a plain gather: the JAX
      package's transpose is XLA's gather, and no Pallas backward exists);
    * jvp: the film's tangent plus K3 applied to the values' tangents, in
      the same lane order, in place on the film's tangent.

    On CPU tensors both take the plain versions, as the primal does."""

    @staticmethod
    def forward(ctx, film, bins_a, vals_a, bins_b, vals_b, spp):
        splat_accumulate(film, bins_a, vals_a, bins_b, vals_b, spp=spp)
        ctx.mark_dirty(film)
        # the bins are integer inputs, never modified: kept as they are for
        # the jvp; the backward's gather indices are made here, once
        ctx.bins, ctx.spp = (bins_a, bins_b), spp
        ctx.cells = [
            gather_index(b, film.shape) if b is not None and needs else None
            for b, needs in zip((bins_a, bins_b),
                                ctx.needs_input_grad[2::2])]
        return film

    @staticmethod
    def backward(ctx, g_film):
        g_a, g_b = (None if c is None else gather_cells(g_film, *c)
                    for c in ctx.cells)
        return g_film, None, g_a, None, g_b, None

    @staticmethod
    def jvp(ctx, t_film, _t_bins_a, t_vals_a, _t_bins_b, t_vals_b, _t_spp):
        sets = [(b, t.contiguous()) for b, t in zip(ctx.bins, (t_vals_a,
                                                               t_vals_b))
                if b is not None and t is not None]
        if sets:
            (b_a, t_a), (b_b, t_b) = (sets + [(None, None)])[:2]
            splat_accumulate(t_film, b_a, t_a, b_b, t_b, spp=ctx.spp)
        return t_film


def check_pixel_slab(channels: int, t_pad: int) -> None:
    """K3 stages the film of a few consecutive pixels in a block's shared
    memory (``csrc/splat.cu`` picks how many): raise when one pixel's slab
    does not fit."""
    pixel_bytes = 4 * channels * t_pad
    if pixel_bytes > _build.MAX_SHARED_BYTES:
        raise ValueError(
            f"splat_accumulate: one pixel's film slab ({channels} x {t_pad} "
            f"floats, {pixel_bytes} bytes) exceeds {_build.MAX_SHARED_BYTES} "
            "bytes of shared memory")


def splat_steady(state, spp: int, value: torch.Tensor, weight: torch.Tensor):
    """Add a pass's per-lane radiance ``value`` (N, C), spp-major, with
    filter weights ``weight`` (N,) (box: 1) into the steady image: a dense
    reduction over the spp axis (:func:`sum_rows`)."""
    hw = state.steady.shape[0]
    v = sum_rows((value * weight[:, None]).reshape(spp, hw, -1))
    w = sum_rows(weight.reshape(spp, hw))
    return state._replace(steady=state.steady + v,
                          steady_weight=state.steady_weight + w)


def splat_steady_gaussian(state, h: int, w: int, spp: int,
                          value: torch.Tensor, weight: torch.Tensor,
                          jitter: torch.Tensor, stddev: float = 0.5):
    """Steady-image accumulation under a truncated gaussian spatial filter
    (Mitsuba's ``gaussian`` rfilter: exp(-x^2/2s^2) - exp(-r^2/2s^2), radius
    r = 4s).  ``jitter`` (N, 2) is each lane's position inside its pixel.
    For each integer pixel offset the pass's weighted contributions are
    reduced over the spp axis (:func:`sum_rows`), then added into the
    image shifted by that offset.  The weights go through
    ``core.math.exp``, so that they round alike on the card and the CPU."""
    radius = max(1, int(math.ceil(4.0 * stddev)))
    C = value.shape[-1]
    v = (value * weight[:, None]).reshape(spp, h, w, C)
    wg = weight.reshape(spp, h, w)
    jx = jitter[:, 0].reshape(spp, h, w)
    jy = jitter[:, 1].reshape(spp, h, w)
    cut = math.exp(-(radius * radius) / (2.0 * stddev * stddev))
    two_s2 = 2.0 * stddev * stddev
    acc = torch.zeros((h, w, C), dtype=torch.float32, device=value.device)
    wacc = torch.zeros((h, w), dtype=torch.float32, device=value.device)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            # from the sample (px + jx) to the centre of pixel px + dx
            ox = (dx + 0.5) - jx
            oy = (dy + 0.5) - jy
            fx = torch.clamp_min(exp(divide(-ox * ox, two_s2)) - cut, 0.0)
            fy = torch.clamp_min(exp(divide(-oy * oy, two_s2)) - cut, 0.0)
            f = fx * fy
            contrib = sum_rows(v * f[..., None])  # (h, w, C)
            wsum = sum_rows(wg * f)
            ys = slice(max(dy, 0), h + min(dy, 0))
            yd = slice(max(-dy, 0), h + min(-dy, 0))
            xs = slice(max(dx, 0), w + min(dx, 0))
            xd = slice(max(-dx, 0), w + min(-dx, 0))
            acc[ys, xs] += contrib[yd, xd]
            wacc[ys, xs] += wsum[yd, xd]
    return state._replace(steady=state.steady + acc.reshape(h * w, C),
                          steady_weight=state.steady_weight
                          + wacc.reshape(h * w))


def surface_sample_validation(film, film_cfg) -> dict:
    """Host-side half of the opt-in splat validation: read the counters
    accumulated by ``splat_transient_pair`` and log one warning per render."""
    if not (film_cfg.warn_negative or film_cfg.warn_invalid):
        return {}
    if not hasattr(film, "n_negative"):  # the phasor film has no counters
        return {}
    with trace.span("mitr:sync"):
        neg = float(film.n_negative)
        inv = float(film.n_invalid)
    log = logging.getLogger("mitransient_tpu_torch")
    if neg > 0:
        log.warning("Negative sample values: %d splats below -1e-5 "
                    "(warn_negative)", int(neg))
    if inv > 0:
        log.warning("Invalid sample values: %d non-finite splats "
                    "(warn_invalid)", int(inv))
    return {"n_negative": neg, "n_invalid": inv}


def develop(state: TransientFilmState, cfg: FilmConfig,
            shape_hw: tuple[int, int] | None = None):
    """Returns (steady (H, W, C), transient (H, W, T, C)): weight-normalized
    steady; the transient was scaled at splat time.  ``shape_hw`` is the
    film's data size (a crop window's), by default the whole film's."""
    h, w = shape_hw if shape_hw is not None else (cfg.height, cfg.width)
    C = state.steady.shape[-1]
    wgt = torch.where(state.steady_weight == 0.0, 1.0, state.steady_weight)
    steady = (state.steady / wgt[:, None]).reshape(h, w, C)
    T = cfg.temporal_bins
    transient = state.transient[:, :T, :].permute(2, 1, 0).reshape(h, w, T, C)
    return steady, transient
