"""Transient film: time-binned radiance accumulation, with kernel K3.

Counterpart of ``mitransient_tpu/film/transient_film.py`` (box temporal
filter) and of the splat kernel ``ops/splat_pallas.py``.

* The spatial filter is a box, so the pixel of every lane is fixed: lanes
  are spp-major (lane = s*HW + p) and a splat is a per-pixel histogram over
  time only.
* The transient buffer is ``(C, T + 1, HW)``: bin T is the overflow slot
  for out-of-range samples, which ``develop`` drops.  The JAX package pads
  T and HW further for its Pallas tiles; the port has no such padding.
* OPL -> bin: ``bin = floor((distance - start_opl) / bin_width_opl)``.
* :func:`splat_accumulate` adds one or two event sets into the film in
  place: the plain :func:`_scatter_layout` for CPU tensors, the kernel of
  ``csrc/splat.cu`` for CUDA tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import _build
from ..scene.schema import FilmConfig


class TransientFilmState(NamedTuple):
    steady: torch.Tensor  # (HW, C) accumulated radiance * filter weight
    steady_weight: torch.Tensor  # (HW,) accumulated filter weight
    transient: torch.Tensor  # (C, T + 1, HW); bin T = overflow (dropped)
    n_negative: torch.Tensor  # () f32 - splats with a value < -1e-5
    n_invalid: torch.Tensor  # () f32 - splats with a non-finite value


def film_init(cfg: FilmConfig, channels: int, device="cpu") -> TransientFilmState:
    hw = cfg.width * cfg.height
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
    pos = (distance - cfg.start_opl) / cfg.bin_width_opl
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
    if temporal_filter == "gaussian":
        raise NotImplementedError(
            "the gaussian temporal filter is not ported yet (ROADMAP item 10)")
    if cfg.warn_negative or cfg.warn_invalid:
        state = _count_suspect(state, cfg, val_a, val_b, active)
    bins_a, _ = time_bin(cfg, dist_a)
    va = torch.where(active[:, None], val_a, 0.0)
    bins_b = vb = None
    if dist_b is not None:
        bins_b, _ = time_bin(cfg, dist_b)
        vb = torch.where(active[:, None], val_b, 0.0)
    splat_accumulate(state.transient, bins_a, va, bins_b, vb, spp=spp)
    return state


def splat_pair_any(state, cfg: FilmConfig, spp, dist_a, val_a, dist_b, val_b,
                   active, temporal_filter="", gaussian_stddev=2.0):
    """Film-kind dispatch; only the transient histogram film is ported
    (the phasor film is ROADMAP item 12 and is refused at load)."""
    return splat_transient_pair(state, cfg, spp, dist_a, val_a, dist_b,
                                val_b, active, temporal_filter,
                                gaussian_stddev)


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
    C, t_pad, _ = film.shape
    n = bins.shape[0]
    pix = torch.arange(n, device=bins.device) % hw
    keep = (bins >= 0) & (bins < t_pad)
    # offset inside one channel; a dropped lane adds 0.0 to cell 0
    cell = torch.where(keep, bins.to(torch.int64) * hw + pix, 0)
    chan = torch.arange(C, device=bins.device) * (t_pad * hw)
    idx = (cell[:, None] + chan[None, :]).reshape(-1)  # lane-major, then c
    src = torch.where(keep[:, None], vals, 0.0).reshape(-1)
    film.view(-1).index_add_(0, idx, src)


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
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.mitr_splat_accumulate(
            film.data_ptr(), C, t_pad, hw, spp,
            bins_a.data_ptr(), vals_a.data_ptr(),
            bins_b.data_ptr() if bins_b is not None else None,
            vals_b.data_ptr() if vals_b is not None else None,
            _build.stream_of(dev))
    _build.check(err, kernel)
    _build.count_launch(kernel)


def develop(state: TransientFilmState, cfg: FilmConfig):
    """Returns (steady (H, W, C), transient (H, W, T, C)): weight-normalized
    steady; the transient was scaled at splat time."""
    h, w = cfg.height, cfg.width
    C = state.steady.shape[-1]
    wgt = torch.where(state.steady_weight == 0.0, 1.0, state.steady_weight)
    steady = (state.steady / wgt[:, None]).reshape(h, w, C)
    T = cfg.temporal_bins
    transient = state.transient[:, :T, :].permute(2, 1, 0).reshape(h, w, T, C)
    return steady, transient
