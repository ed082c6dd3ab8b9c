"""Small vector-math helpers over ``(..., 3)`` float32 tensors.

Counterpart of ``mitransient_tpu/core/math.py``.  Every function rounds
the same way on the card and on the CPU, so that a render takes the same
paths on both.  Dot products are written out component by component
(``ax*bx + ay*by + az*bz``) so that every operation rounds on its own, in
a fixed order; a reduction such as ``torch.sum(a * b, -1)`` leaves the
order to the backend.  :func:`sqrt` and :func:`cos_sin` return the
correctly rounded float32: the card's float32 ``torch.sqrt`` is, the
CPU's vectorized one is an ulp off in about 0.6 % of arguments, and
neither device's float32 ``cos`` / ``sin`` is, so those go through
float64 (as do :func:`log` and :func:`exp`, the media's free-flight
and transmittance terms, and :func:`atanh` and :func:`cosh`, the
spectral wavelength sampler's); and :func:`divide` divides by a Python number,
where the card's ``x / c`` multiplies by a rounded 1 / c.  Rays that meet coplanar triangles would
otherwise part between the devices.
"""
from __future__ import annotations

import contextlib

import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root on every device."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


_SCALARS: dict = {}  # (c, dtype, device) -> 0-dim tensor, at most 64
_kept: list | None = None  # what a CUDA graph capture reads (keeping)


def _scalar(c: float, dtype: torch.dtype, device: torch.device):
    key = (c, dtype, device)
    s = _SCALARS.get(key)
    if s is None:
        s = torch.full((), c, dtype=dtype, device=device)
        # one made inside a capture is filled only when the graph runs
        if _kept is None:
            if len(_SCALARS) >= 64:
                _SCALARS.clear()
            _SCALARS[key] = s
    if _kept is not None:
        _kept.append(s)
    return s


@contextlib.contextmanager
def keeping(kept: list):
    """Inside, every scalar :func:`divide` divides by is appended to
    ``kept``, and none is cached: a CUDA graph captured there reads them,
    so its owner keeps them alive as long as the graph."""
    global _kept
    _kept = kept
    try:
        yield kept
    finally:
        _kept = None


def divide(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a Python number ``c``, rounded as one division on
    every device (a 0-dim tensor on ``x``'s device is divided by, not
    multiplied by its reciprocal)."""
    return x / _scalar(float(c), x.dtype, x.device)


def cos_sin(x: torch.Tensor):
    """The correctly rounded float32 cosine and sine on every device."""
    xd = x.double()
    return torch.cos(xd).to(x.dtype), torch.sin(xd).to(x.dtype)


def log(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 natural logarithm on every device."""
    return torch.log(x.double()).to(x.dtype)


def exp(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 exponential on every device."""
    return torch.exp(x.double()).to(x.dtype)


def atanh(x: torch.Tensor) -> torch.Tensor:
    """The float32 inverse hyperbolic tangent, rounded alike on every
    device (through float64, as :func:`exp`)."""
    return torch.atanh(x.double()).to(x.dtype)


def cosh(x: torch.Tensor) -> torch.Tensor:
    """The float32 hyperbolic cosine, rounded alike on every device."""
    return torch.cosh(x.double()).to(x.dtype)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis -> shape ``(...)``."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalize(a: torch.Tensor) -> torch.Tensor:
    return a / sqrt(torch.clamp_min(dot(a, a), 1e-24))[..., None]


def safe_div(a, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` with 0 where ``|b|`` is (denormal-)zero (broadcasts)."""
    bz = torch.abs(b) < 1e-20
    return torch.where(bz, 0.0, a / torch.where(bz, 1.0, b))


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    return sqrt(torch.clamp_min(x, 0.0))


def mis_weight(pdf_a: torch.Tensor, pdf_b: torch.Tensor) -> torch.Tensor:
    """Power heuristic (beta=2): ``pdf_a^2 / (pdf_a^2 + pdf_b^2)``, 0 when
    ``pdf_a == 0`` or the ratio is not finite."""
    a2 = pdf_a * pdf_a
    w = safe_div(a2, a2 + pdf_b * pdf_b)
    return torch.where(torch.isfinite(w), w, 0.0)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the trailing axis, written out as ``jnp.cross``
    computes it."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


def norm(a: torch.Tensor) -> torch.Tensor:
    return sqrt(torch.clamp_min(dot(a, a), 0.0))


def squared_norm(a: torch.Tensor) -> torch.Tensor:
    return dot(a, a)


def lerp(a, b, t):
    return a + (b - a) * t


def matvec3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched (..., 3, 3) @ (..., 3), each row a written-out dot."""
    return torch.stack([dot(m[..., i, :], v) for i in range(3)], dim=-1)


def rodrigues(w: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) from axis-angle vectors ``w`` (..., 3):
    |w| radians about w.  Series-safe at w -> 0 (R is I exactly at w = 0,
    with the derivative dR = skew(dw))."""
    theta2 = dot(w, w)
    # clamp at 1e-12: the reciprocal's derivative squares the denominator
    theta = sqrt(torch.clamp_min(theta2, 1e-12))
    small = theta2 < 1e-12
    c, s = cos_sin(theta)
    # sin(t) / t and (1 - cos t) / t^2, with Taylor forms near 0
    a = torch.where(small, 1.0 - divide(theta2, 6.0), s / theta)
    b = torch.where(small, 0.5 - divide(theta2, 24.0),
                    (1.0 - c) / torch.clamp_min(theta2, 1e-12))
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    K = torch.stack([torch.stack([zero, -wz, wy], dim=-1),
                     torch.stack([wz, zero, -wx], dim=-1),
                     torch.stack([-wy, wx, zero], dim=-1)], dim=-2)
    K2 = torch.stack([torch.stack([dot(K[..., i, :], K[..., :, j])
                                   for j in range(3)], dim=-1)
                      for i in range(3)], dim=-2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * K2


def safe_rcp(x: torch.Tensor) -> torch.Tensor:
    """``1 / x`` with 0 where ``|x|`` is (denormal-)zero."""
    nz = torch.abs(x) > 1e-20
    return torch.where(nz, 1.0 / torch.where(nz, x, 1.0), 0.0)


def stable_sqrt(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """sqrt clamped at 0 whose gradient stays finite where the argument
    touches 0; differs from ``safe_sqrt`` only for x in (0, eps)."""
    return sqrt(torch.clamp_min(x, eps)) * (x > 0.0)


def stable_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """normalize() that returns 0 for the zero vector."""
    return v / sqrt(torch.clamp_min(dot(v, v), eps * eps))[..., None]


def replace_grad(value_of: torch.Tensor,
                 grad_of: torch.Tensor) -> torch.Tensor:
    """Dr.Jit's ``dr.replace_grad(a, b)``: the value of ``value_of`` with
    the derivative of ``grad_of``.  Written as ``value + (g - g)`` rather
    than the JAX package's ``g + (value - g)``, so that the value is
    ``value_of``'s bit for bit wherever ``grad_of`` is finite."""
    return value_of.detach() + (grad_of - grad_of.detach())
