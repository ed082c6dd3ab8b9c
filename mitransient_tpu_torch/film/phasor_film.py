"""Phasor-field (frequency-domain) film (counterpart of
``mitransient_tpu/film/phasor_film.py``).

Instead of binning by time, every path contribution accumulates ``value *
exp(-i 2 pi f * opl)`` for a band of frequencies: a sparse DFT of the
transient signal taken on the fly.  The band is a +-3 sigma window around
``wl_mean`` out of ``fftfreq(temporal_bins, bin_width_opl)``, clipped to
[0, T/2].  With spp-major lanes the pixel is the lane index, so a splat is
a dense reduction over the spp axis per frequency, no scatter.
Monochromatic only, like the reference's film.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..scene.schema import FilmConfig


class PhasorFilmState(NamedTuple):
    steady: torch.Tensor  # (HW, C)
    steady_weight: torch.Tensor  # (HW,)
    phasor: torch.Tensor  # (F, 2, HW) accumulated real / imaginary parts


def phasor_frequencies(cfg: FilmConfig) -> np.ndarray:
    """The tracked frequency band, float32 (F,)."""
    nt = cfg.temporal_bins
    bw = cfg.bin_width_opl
    mean_idx = (nt * bw) / cfg.wl_mean
    sigma_idx = (nt * bw) / (cfg.wl_sigma * 6.0)
    fmin = max(0, int(np.floor(mean_idx - 3 * sigma_idx)))
    fmax = min(nt // 2, int(np.ceil(mean_idx + 3 * sigma_idx)))
    return np.fft.fftfreq(nt, d=bw)[fmin : fmax + 1].astype(np.float32)


def phasor_film_init(cfg: FilmConfig, channels: int,
                     device="cpu") -> PhasorFilmState:
    if channels != 1:
        raise ValueError(
            "phasor_hdr_film supports only monochromatic rendering "
            "(phasor_hdr_film.py:118-123); set_variant('mono')")
    hw = cfg.width * cfg.height
    F = phasor_frequencies(cfg).shape[0]
    f32 = torch.float32
    return PhasorFilmState(
        steady=torch.zeros((hw, channels), dtype=f32, device=device),
        steady_weight=torch.zeros((hw,), dtype=f32, device=device),
        phasor=torch.zeros((F, 2, hw), dtype=f32, device=device),
    )


def splat_phasor_pair(state: PhasorFilmState, cfg: FilmConfig, spp: int,
                      dist_a: torch.Tensor, val_a: torch.Tensor,
                      dist_b: torch.Tensor | None, val_b: torch.Tensor | None,
                      active: torch.Tensor) -> PhasorFilmState:
    """Accumulate the phasors of one bounce's splat events (opl = distance
    - start_opl, no binning); values are (N, 1), already scaled."""
    hw = state.steady.shape[0]
    freqs = torch.from_numpy(phasor_frequencies(cfg)).to(dist_a.device)
    ph = state.phasor
    for dist, val in ((dist_a, val_a), (dist_b, val_b)):
        if dist is None:
            continue
        opl = dist - cfg.start_opl
        finite = torch.isfinite(opl)
        v = torch.where(active & finite, val[:, 0], 0.0).reshape(spp, hw)
        opl = torch.where(finite, opl, 0.0).reshape(spp, hw)
        # (F, spp, HW) phases reduced over spp -> (F, HW)
        phase = (-2.0 * math.pi) * freqs[:, None, None] * opl[None]
        re = (torch.cos(phase) * v[None]).sum(dim=1)
        im = (torch.sin(phase) * v[None]).sum(dim=1)
        ph = ph + torch.stack([re, im], dim=1)
    return state._replace(phasor=ph)


def develop_phasor(state: PhasorFilmState, cfg: FilmConfig):
    """Returns (steady (H, W, 1), phasors (H, W, F, 2))."""
    h, w = cfg.height, cfg.width
    wgt = torch.where(state.steady_weight == 0.0, 1.0, state.steady_weight)
    steady = (state.steady / wgt[:, None]).reshape(h, w, -1)
    F = state.phasor.shape[0]
    return steady, state.phasor.permute(2, 0, 1).reshape(h, w, F, 2)
