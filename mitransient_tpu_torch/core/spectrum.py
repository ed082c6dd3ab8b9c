"""Variants as values (counterpart of ``mitransient_tpu/core/spectrum.py``).

A :class:`Variant` travels with the loaded scene; spectra are float32
tensors whose trailing shape encodes the mode:

* unpolarized: ``(..., C)`` with ``C`` = 1 (mono) or 3 (rgb);
* polarized: ``(..., 4, 4, C)``, a Mueller matrix per channel; the
  radiance that reaches the film is its first column (a Stokes vector), and
  the film carries ``4 * C`` channels, Stokes-major.

The spectral variants keep the scene's tables RGB; their lanes carry
hero wavelengths (``core/spectra.py``) and their splats convert to sRGB.
The integrators' throughput carries use the structured Mueller layout of
``core/mueller.py`` (``msoa_*``) rather than these dense helpers.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Variant(NamedTuple):
    color_channels: int = 3  # 1 = mono, 3 = rgb (film/table channels)
    polarized: bool = False
    spectral: bool = False  # hero-wavelength sampling; film stays 3-channel

    @property
    def name(self) -> str:
        base = ("spectral" if self.spectral
                else ("mono" if self.color_channels == 1 else "rgb"))
        return base + ("_polarized" if self.polarized else "")


_KNOWN = {
    "mono": Variant(1, False),
    "rgb": Variant(3, False),
    "mono_polarized": Variant(1, True),
    "rgb_polarized": Variant(3, True),
    "spectral": Variant(3, False, True),
    "spectral_polarized": Variant(3, True, True),
}

# Default variant of newly loaded scenes (API parity with mi.set_variant);
# a loaded scene keeps the variant it was loaded with.
_current = _KNOWN["rgb"]


def set_variant(name) -> None:
    global _current
    if isinstance(name, Variant):  # restore pattern: set_variant(variant())
        if name not in _KNOWN.values():
            raise ValueError(f"unknown variant {name!r}")
        _current = name
        return
    # Accept mitsuba-style names like "llvm_ad_rgb" by taking the suffix;
    # the longest matching key wins ("mono_polarized" over "mono").
    key = name
    for k in sorted(_KNOWN, key=len):
        if name == k or name.endswith("_" + k):
            key = k
    if key not in _KNOWN:
        raise ValueError(
            f"unknown variant {name!r}; choose from {list(_KNOWN)}")
    _current = _KNOWN[key]


def variant() -> Variant:
    return _current


def is_polarized() -> bool:
    return _current.polarized


def is_monochromatic() -> bool:
    return _current.color_channels == 1


def is_rgb() -> bool:
    return _current.color_channels == 3 and not _current.spectral


def is_spectral() -> bool:
    return _current.spectral


# --------------------------------------------------------------------------
# Spectrum ops (shape-polymorphic over the variant encoding above)
# --------------------------------------------------------------------------

def is_polarized_spec(spec: torch.Tensor) -> bool:
    return spec.ndim >= 3 and spec.shape[-3] == 4 and spec.shape[-2] == 4


def spec_zeros(v: Variant, batch_shape=(), device="cpu") -> torch.Tensor:
    shape = ((*batch_shape, 4, 4, v.color_channels) if v.polarized
             else (*batch_shape, v.color_channels))
    return torch.zeros(shape, dtype=torch.float32, device=device)


def spec_identity(v: Variant, batch_shape=(), device="cpu") -> torch.Tensor:
    """Multiplicative identity: ones unpolarized, the identity Mueller
    matrix polarized."""
    if v.polarized:
        eye = torch.eye(4, dtype=torch.float32, device=device)[..., None]
        return eye.expand(*batch_shape, 4, 4, v.color_channels).clone()
    return torch.ones((*batch_shape, v.color_channels), dtype=torch.float32,
                      device=device)


def spec_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Spectrum x Spectrum: for two polarized spectra the Mueller product
    ``a @ b`` (light flows right to left); a scalar-like spectrum scales a
    Mueller matrix."""
    ap, bp = is_polarized_spec(a), is_polarized_spec(b)
    if not ap and not bp:
        return a * b
    if ap and bp:
        from .mueller import mueller_product

        return mueller_product(a, b)
    if ap:
        return a * b[..., None, None, :]
    return b * a[..., None, None, :]


def spec_scale(spec: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Multiply a spectrum by a per-lane scalar ``s`` of shape (...)."""
    if is_polarized_spec(spec):
        return spec * s[..., None, None, None]
    return spec * s[..., None]


def unpolarized(spec: torch.Tensor) -> torch.Tensor:
    """The intensity ``(..., C)`` (Mueller element [0, 0]) of a polarized
    spectrum; an unpolarized one as it is."""
    if is_polarized_spec(spec):
        return spec[..., 0, 0, :]
    return spec


def to_stokes(spec: torch.Tensor) -> torch.Tensor:
    """The first Mueller column ``(..., 4, C)``: the outgoing Stokes vector
    for unpolarized unit input light."""
    if is_polarized_spec(spec):
        return spec[..., :, 0, :]
    raise ValueError("to_stokes requires a polarized spectrum")


def luminance(spec: torch.Tensor) -> torch.Tensor:
    """The largest channel of the intensity, Russian roulette's throughput
    measure."""
    return unpolarized(spec).amax(dim=-1)
