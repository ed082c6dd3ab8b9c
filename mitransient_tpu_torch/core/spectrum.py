"""Variants as values (counterpart of ``mitransient_tpu/core/spectrum.py``).

A :class:`Variant` travels with the loaded scene; spectra are ``(..., C)``
float32 tensors with ``C`` = 1 (mono) or 3 (rgb).  The polarized and
spectral variants of the JAX package are not ported yet (ROADMAP item 16)
and raise.
"""
from __future__ import annotations

from typing import NamedTuple


class Variant(NamedTuple):
    color_channels: int = 3  # 1 = mono, 3 = rgb (film/table channels)
    polarized: bool = False
    spectral: bool = False

    @property
    def name(self) -> str:
        base = ("spectral" if self.spectral
                else ("mono" if self.color_channels == 1 else "rgb"))
        return base + ("_polarized" if self.polarized else "")


_KNOWN = {"mono": Variant(1), "rgb": Variant(3)}
_NOT_PORTED = ("mono_polarized", "rgb_polarized", "spectral",
               "spectral_polarized")

# Default variant of newly loaded scenes (API parity with mi.set_variant);
# a loaded scene keeps the variant it was loaded with.
_current = _KNOWN["rgb"]


def set_variant(name) -> None:
    global _current
    if isinstance(name, Variant):  # restore pattern: set_variant(variant())
        if name not in _KNOWN.values():
            raise NotImplementedError(
                f"variant {name.name!r} is not ported yet (ROADMAP item 16)")
        _current = name
        return
    # Accept mitsuba-style names like "llvm_ad_rgb" by taking the suffix;
    # the longest matching key wins ("mono_polarized" over "mono").
    key = name
    for k in sorted((*_KNOWN, *_NOT_PORTED), key=len):
        if name == k or name.endswith("_" + k):
            key = k
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"variant {key!r} is not ported yet (ROADMAP item 16)")
    if key not in _KNOWN:
        raise ValueError(f"unknown variant {name!r}; choose from {list(_KNOWN)}")
    _current = _KNOWN[key]


def variant() -> Variant:
    return _current
