"""Spectral rendering: CIE colorimetry and hero-wavelength sampling
(counterpart of ``mitransient_tpu/core/spectra.py``).

Each lane carries ``N_WL`` hero wavelengths that share one path.  RGB
scene colors are uplifted to smooth reflectance spectra with the Smits
(1999) basis, emission is shaped by CIE D65, and radiance samples convert
to linear sRGB at splat time, so films stay 3-channel (12 with the Stokes
rows of ``spectral_polarized``).

The tables are public standard data: the CIE 1931 multi-Gaussian fits of
Wyman, Sloan and Shirley (2013), Smits' basis and CIE D65; they are copies
of the JAX package's.  Exponentials, ``atanh`` and ``cosh`` go through
``core/math.py``, so the card and the CPU round alike; against the JAX
package (float32 transcendentals of XLA:CPU, FMA-contracted sums) the
values agree to a few ulp.
"""
from __future__ import annotations

import numpy as np
import torch

from . import rng
from .math import atanh, cosh, divide, exp

N_WL = 4  # hero wavelengths per lane
WL_MIN, WL_MAX = 360.0, 830.0
SPECTRAL_STREAM_TAG = 0x57AC  # fold_in tag of the wavelength draw


# --------------------------------------------------------------------------
# CIE 1931 color matching (multi-Gaussian fits, Wyman/Sloan/Shirley 2013)
# --------------------------------------------------------------------------

def _g(x, alpha, mu, s1, s2):
    s = torch.where(x < mu, s1, s2)
    t = (x - mu) / s
    return alpha * exp(-0.5 * t * t)


def cie_xyz(wl: torch.Tensor) -> torch.Tensor:
    """CIE 1931 2-degree color matching functions at wavelengths in nm ->
    (..., 3)."""
    x = (_g(wl, 0.362, 442.0, 16.0, 26.7)
         + _g(wl, 1.056, 599.8, 37.9, 31.0)
         + _g(wl, -0.065, 501.1, 20.4, 26.2))
    y = (_g(wl, 0.821, 568.8, 46.9, 40.5)
         + _g(wl, 0.286, 530.9, 16.3, 31.1))
    z = (_g(wl, 1.217, 437.0, 11.8, 36.0)
         + _g(wl, 0.681, 459.0, 26.0, 13.8))
    return torch.stack([x, y, z], dim=-1)


# CIE standard illuminant D65, 360-830 nm at 10 nm (relative SPD, 560=100)
_D65 = np.array([
    46.64, 49.36, 52.09, 51.03, 49.98, 52.31, 54.65, 68.70, 82.75, 87.12,
    91.49, 92.46, 93.43, 90.06, 86.68, 95.77, 104.86, 110.94, 117.01,
    117.41, 117.81, 116.34, 114.86, 115.39, 115.92, 112.37, 108.81, 109.08,
    109.35, 108.58, 107.80, 106.30, 104.79, 106.24, 107.69, 106.05, 104.41,
    104.23, 104.05, 102.02, 100.00, 98.17, 96.33, 96.06, 95.79, 92.24,
    88.69, 89.35, 90.01, 89.80, 89.60, 88.65, 87.70, 85.49, 83.29, 83.49,
    83.70, 81.86, 80.03, 80.12, 80.21, 81.25, 82.28, 80.28, 78.28, 74.00,
    69.72, 70.67, 71.61, 72.98, 74.35, 67.98, 61.60, 65.74, 69.89, 72.49,
    75.09, 69.34, 63.59, 55.01, 46.42, 56.61, 66.81, 65.09, 63.38, 63.84,
    64.30, 61.88, 59.45, 55.71, 51.96, 54.70, 57.44, 58.88, 60.31,
], np.float32)
_D65_WL = np.linspace(360.0, 830.0, len(_D65)).astype(np.float32)


def _ybar_np(wl: np.ndarray) -> np.ndarray:
    """Numpy twin of cie_xyz's ybar fit, for the import-time constants."""

    def g(x, a, mu, s1, s2):
        s = np.where(x < mu, s1, s2)
        return a * np.exp(-0.5 * ((x - mu) / s) ** 2)

    return g(wl, 0.821, 568.8, 46.9, 40.5) + g(wl, 0.286, 530.9, 16.3, 31.1)


def _trapezoid(y: np.ndarray, x: np.ndarray) -> float:
    """``np.trapezoid(y, x)``, written out as numpy computes it."""
    return float((np.diff(x) * (y[1:] + y[:-1]) / 2.0).sum())


# normalize so that a unit-RGB (1, 1, 1) emitter keeps its photometric
# scale: integral(D65 * ybar) == integral(ybar)
_D65_NORM = _trapezoid(_D65 * _ybar_np(_D65_WL), _D65_WL)
_Y_INT = _trapezoid(_ybar_np(_D65_WL), _D65_WL)


def _table(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def interp(x: torch.Tensor, xp: np.ndarray, fp: np.ndarray, left=None,
           right=None) -> torch.Tensor:
    """``jnp.interp(x, xp, fp, left, right)`` for increasing ``xp``, with
    its operations: ``fp[i - 1] + (x - xp[i - 1]) / (xp[i] - xp[i - 1]) *
    (fp[i] - fp[i - 1])``, i the right insertion index clipped to
    [1, len - 1], and the end values outside [xp[0], xp[-1]]."""
    xpt, fpt = _table(xp, x.device), _table(fp, x.device)
    i = torch.clamp(torch.searchsorted(xpt, x.contiguous(), right=True), 1,
                    len(xp) - 1)
    x0, x1 = xpt[i - 1], xpt[i]
    f0, f1 = fpt[i - 1], fpt[i]
    f = f0 + ((x - x0) / (x1 - x0)) * (f1 - f0)
    f = torch.where(x < float(xp[0]), float(fp[0] if left is None else left),
                    f)
    return torch.where(x > float(xp[-1]),
                       float(fp[-1] if right is None else right), f)


def d65(wl: torch.Tensor) -> torch.Tensor:
    """D65 normalized so that integral(D65 * ybar) == integral(ybar): an
    rgb (1, 1, 1) emitter has the same luminance in every variant."""
    return interp(wl, _D65_WL, _D65) * (_Y_INT / _D65_NORM)


# --------------------------------------------------------------------------
# Smits (1999) RGB -> smooth reflectance basis (10 bins, 380-720 nm)
# --------------------------------------------------------------------------

_SMITS_WL = np.linspace(380.0, 720.0, 10).astype(np.float32)
_SMITS = {
    "white":   [1.0000, 1.0000, 0.9999, 0.9993, 0.9992, 0.9998, 1.0000,
                1.0000, 1.0000, 1.0000],
    "cyan":    [0.9710, 0.9426, 1.0007, 1.0007, 1.0007, 1.0007, 0.1564,
                0.0000, 0.0000, 0.0000],
    "magenta": [1.0000, 1.0000, 0.9685, 0.2229, 0.0000, 0.0458, 0.8369,
                1.0000, 1.0000, 0.9959],
    "yellow":  [0.0001, 0.0000, 0.1088, 0.6651, 1.0000, 1.0000, 0.9996,
                0.9586, 0.9685, 0.9840],
    "red":     [0.1012, 0.0515, 0.0000, 0.0000, 0.0000, 0.0000, 0.8325,
                1.0149, 1.0149, 1.0149],
    "green":   [0.0000, 0.0000, 0.0273, 0.7937, 1.0000, 0.9418, 0.1719,
                0.0000, 0.0000, 0.0025],
    "blue":    [1.0000, 1.0000, 0.8916, 0.3323, 0.0000, 0.0000, 0.0003,
                0.0369, 0.0483, 0.0496],
}
_SMITS_ARR = {k: np.array(v, np.float32) for k, v in _SMITS.items()}


def _smits_eval(name: str, wl: torch.Tensor) -> torch.Tensor:
    a = _SMITS_ARR[name]
    return interp(wl, _SMITS_WL, a, left=float(a[0]), right=float(a[-1]))


def srgb_uplift(rgb: torch.Tensor, wl: torch.Tensor) -> torch.Tensor:
    """Smits' RGB -> reflectance uplift at ``wl``: rgb (..., 3), wl (...,
    K) -> (..., K)."""
    r, g, b = rgb[..., 0:1], rgb[..., 1:2], rgb[..., 2:3]
    w = _smits_eval("white", wl)
    c = _smits_eval("cyan", wl)
    m = _smits_eval("magenta", wl)
    y = _smits_eval("yellow", wl)
    re = _smits_eval("red", wl)
    gr = _smits_eval("green", wl)
    bl = _smits_eval("blue", wl)
    # the white part (the channel minimum), the secondary color (middle -
    # min) and the primary color (max - middle), by the channels' order
    r_min = (r <= g) & (r <= b)
    g_min = ~r_min & (g <= b)
    case_r = r * w + torch.where(g <= b, (g - r) * c + (b - g) * bl,
                                 (b - r) * c + (g - b) * gr)
    case_g = g * w + torch.where(r <= b, (r - g) * m + (b - r) * bl,
                                 (b - g) * m + (r - b) * re)
    case_b = b * w + torch.where(r <= g, (r - b) * y + (g - r) * gr,
                                 (g - b) * y + (r - g) * re)
    out = torch.where(r_min, case_r, torch.where(g_min, case_g, case_b))
    return torch.clamp_min(out, 0.0)


# --------------------------------------------------------------------------
# Wavelength sampling (mi.sample_rgb_spectrum / pdf_rgb_spectrum)
# --------------------------------------------------------------------------

def sample_rgb_spectrum(u: torch.Tensor) -> torch.Tensor:
    """Mitsuba's cosh^-2 proposal over the visible range."""
    wl = 538.0 - 138.888889 * atanh(0.85691062 - 1.82750197 * u)
    return torch.clamp(wl, WL_MIN, WL_MAX)


def pdf_rgb_spectrum(wl: torch.Tensor) -> torch.Tensor:
    c = cosh(0.0072 * (wl - 538.0))
    pdf = 0.003939804 / (c * c)
    return torch.where((wl >= WL_MIN) & (wl <= WL_MAX), pdf, 0.0)


def sample_shifted(u: torch.Tensor):
    """One uniform draw -> N_WL stratified hero wavelengths and their pdf
    (mi.sample_shifted)."""
    shifts = torch.arange(N_WL, dtype=torch.float32, device=u.device) / N_WL
    uu = torch.fmod(u[..., None] + shifts, 1.0)
    wl = sample_rgb_spectrum(uu)
    return wl, pdf_rgb_spectrum(wl)


# --------------------------------------------------------------------------
# Spectral sample -> sRGB (mi.spectrum_to_srgb at splat time)
# --------------------------------------------------------------------------

_XYZ_TO_SRGB = np.array([
    [3.240479, -1.537150, -0.498535],
    [-0.969256, 1.875991, 0.041556],
    [0.055648, -0.204043, 1.057311],
], np.float32)


def spectrum_to_srgb(values: torch.Tensor, wl: torch.Tensor,
                     pdf: torch.Tensor) -> torch.Tensor:
    """Monte Carlo estimate of the linear sRGB tristimulus of a spectral
    sample set, values / pdf averaged over the hero wavelengths against
    the CIE matching functions: (..., N_WL) each -> (..., 3).  Sums are
    written out in wavelength and column order, so both devices round
    them alike."""
    w = torch.where(pdf > 0.0, 1.0 / (torch.clamp_min(pdf, 1e-12) * N_WL),
                    0.0)
    terms = cie_xyz(wl) * (values * w)[..., None]  # (..., N_WL, 3)
    xyz = terms[..., 0, :]
    for k in range(1, terms.shape[-2]):
        xyz = xyz + terms[..., k, :]
    xyz = divide(xyz, _Y_INT)
    m = _XYZ_TO_SRGB
    return torch.stack([
        xyz[..., 0] * float(m[i, 0]) + xyz[..., 1] * float(m[i, 1])
        + xyz[..., 2] * float(m[i, 2]) for i in range(3)], dim=-1)


# --------------------------------------------------------------------------
# The per-wavefront spectral context
# --------------------------------------------------------------------------

# ascending-wavelength anchors of the B/G/R channels, to interpolate
# per-RGB-channel data (conductor IORs) to any wavelength
_ANCHORS = (465.0, 549.0, 611.0)


def _interp_rgb(vals3: torch.Tensor, wl: torch.Tensor) -> torch.Tensor:
    """Per-RGB-channel values (n, 3), RGB order, at wavelengths (n, K) ->
    (n, K)."""
    v = vals3.flip(-1)  # B, G, R: ascending wavelength
    t = torch.clamp(divide(wl - _ANCHORS[0], _ANCHORS[2] - _ANCHORS[0]),
                    0.0, 1.0) * 2.0
    i0 = torch.clamp(t.to(torch.int64), 0, 1)
    frac = t - i0
    lo = torch.gather(v, 1, i0)
    hi = torch.gather(v, 1, torch.clamp_max(i0 + 1, 2))
    return lo * (1 - frac) + hi * frac


class SpectralCtx:
    """The hero-wavelength set of one wavefront, N_WL wavelengths a lane,
    and the three conversions every spectral integrator needs: the BSDF
    table's uplift, the emission's uplift (times D65) and the splat-time
    spectrum -> sRGB conversion."""

    __slots__ = ("wl", "wl_pdf")

    def __init__(self, wl: torch.Tensor, wl_pdf: torch.Tensor):
        self.wl = wl
        self.wl_pdf = wl_pdf

    @staticmethod
    def make(key, n: int) -> "SpectralCtx":
        """The wavelengths of ``n`` lanes from the sampler key ``key``, on
        its device: ``jax.random.uniform(fold_in(key, 0x57AC), (n,))``,
        bit for bit."""
        u_wl = rng.uniform(key, SPECTRAL_STREAM_TAG, (n,))
        return SpectralCtx(*sample_shifted(u_wl))

    @staticmethod
    def _rgb3(x: torch.Tensor) -> torch.Tensor:
        return x.expand(*x.shape[:-1], 3) if x.shape[-1] == 1 else x

    def uplift(self, rgb: torch.Tensor) -> torch.Tensor:
        """Reflectance-like (n, C) RGB -> (n, N_WL)."""
        return srgb_uplift(self._rgb3(rgb), self.wl)

    def emission(self, rgb: torch.Tensor) -> torch.Tensor:
        """Emitted radiance (n, C) RGB -> (n, N_WL), D65-shaped."""
        return srgb_uplift(self._rgb3(rgb), self.wl) * d65(self.wl)

    def uplift_lb(self, lb):
        """A LaneBSDF's color data at the lanes' wavelengths (the IOR
        columns only where the scene's kinds read them)."""
        out = {"reflectance": self.uplift(lb.reflectance)}
        for f in ("eta_re", "eta_im"):
            if getattr(lb, f) is not None:
                out[f] = _interp_rgb(self._rgb3(getattr(lb, f)), self.wl)
        return lb._replace(**out)

    def to_film(self, vals: torch.Tensor) -> torch.Tensor:
        """(n, N_WL) radiance -> (n, 3) linear sRGB for splatting."""
        return spectrum_to_srgb(vals, self.wl, self.wl_pdf)

    def to_film_any(self, vals: torch.Tensor, polarized: bool):
        return self.to_film_stokes(vals) if polarized else self.to_film(vals)

    def to_film_stokes(self, vals: torch.Tensor) -> torch.Tensor:
        """(n, 4 N_WL) Stokes-major radiance -> (n, 12): each Stokes row
        converts to sRGB on its own."""
        n = vals.shape[0]
        x = vals.reshape(n, 4, -1)
        rgb = spectrum_to_srgb(x, self.wl[:, None, :],
                               self.wl_pdf[:, None, :])
        return rgb.reshape(n, 12)
