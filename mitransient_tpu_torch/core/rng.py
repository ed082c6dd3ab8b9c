"""Counter-based, stateless sample streams (counterpart of
``mitransient_tpu/core/rng.py``).

Every random number is a pure function ``u = U(seed, dimension, lane)``,
drawn bit for bit as ``jax.random`` draws it with the threefry2x32 PRNG
and ``jax_threefry_partitionable`` on:

* ``key(seed)`` is the word pair ``(0, seed)``;
* ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``, both output words the
  new key;
* ``uniform(k, shape)`` hashes each flat row-major index ``i`` of
  ``shape`` as the counter ``(i >> 32, i & 0xFFFFFFFF)``, XORs the two
  output words and keeps their top 23 bits as the mantissa of a float32
  in [1, 2), minus 1.

A sample stream's key ``K`` (a pass's ``fold_in(key(seed), pass)``) is a
``(2,)`` int32 tensor holding the two words, on the device the stream
draws on; every draw is ``uniform(fold_in(K, dimension), shape)``, with the
dimension a Python int (a sampler dimension or a tag:
``BOUNCE_STREAM_TAG + bounce``, ``volpath.GRID_STREAM_TAG + tag``,
``spectra.SPECTRAL_STREAM_TAG``).  :func:`pass_keys` makes the keys of a
render's passes in one upload.  A draw on the CPU reads the key's words,
folds the dimension in and runs the plain version (``_uniform_plain``):
PyTorch has no uint32 shifts there, so the 32-bit words are held in int64
and masked to 32 bits, as the regen loop's PCG hash is
(``integrators/path_regen.py``).  A draw on the card is one launch of the
hand-written kernel ``csrc/rng.cu`` (``_uniform_kernel``), which reads the
key from the tensor when it runs and folds the dimension in itself, or
raises.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..kernels import _build

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
BOUNCE_STREAM_TAG = 0x42000000  # disambiguates bounce blocks from scalar dims


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under the
    key ``(k0, k1)``.  The words are Python ints or int64 tensors holding
    values in [0, 2^32); returns the two output words in the same form."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & _M32
    return x0, x1


def make_key(seed: int) -> tuple[int, int]:
    """``jax.random.key(jnp.uint32(seed))``."""
    return 0, int(seed) & _M32


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, jnp.uint32(data))``."""
    return threefry2x32(key[0], key[1], 0, int(data) & _M32)


def pass_keys(seed: int, passes, device="cpu") -> torch.Tensor:
    """The stream keys of passes ``passes`` of a render under ``seed``:
    (P, 2) int32 on ``device``, row i = ``fold_in(make_key(seed),
    passes[i])``, computed on the host (the chain of :func:`fold_in`, on
    numpy words) and uploaded once, pinned and asynchronous, to the card."""
    k0, k1 = make_key(seed)
    p = np.asarray(list(passes), np.uint64)
    a, b = threefry2x32(k0, k1, np.zeros_like(p), p & _M32)
    words = np.stack([a, b], axis=-1).astype(np.uint32).reshape(-1, 2)
    host = torch.from_numpy(words.view(np.int32))
    if torch.device(device).type == "cpu":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def uniform(key: torch.Tensor, dim: int, shape,
            rows: tuple[int, int] | None = None) -> torch.Tensor:
    """``jax.random.uniform(fold_in(K, dim), shape)``: float32 in [0, 1),
    on the device of the stream key ``key`` (K, see :func:`pass_keys`).

    ``rows=(r0, r1)`` draws only rows ``[r0, r1)`` of the leading axis,
    the same bits as those rows of the whole draw (they are the flat
    counters ``[r0 * k, r1 * k)``, k the size of a row), so that a large
    draw can be made in slices.  CPU keys take the plain version; CUDA
    keys launch the kernel."""
    shape = tuple(shape)
    row = 1
    for s in shape[1:]:
        row *= s
    r0, r1 = rows if rows is not None else (0, shape[0] if shape else 1)
    dev = key.device
    trace.count("rng.draws", 1)
    with trace.span("mitr:rng"):
        if dev.type == "cpu":
            k0, k1 = (int(w) & _M32 for w in key.tolist())
            u = _uniform_plain(fold_in((k0, k1), dim), r0 * row, r1 * row,
                               dev)
        elif dev.type == "cuda":
            u = _uniform_kernel(key, dim, r0 * row, r1 * row)
        else:
            raise ValueError(f"uniform: device {dev}; expected cpu or cuda")
        return u.reshape((r1 - r0,) + shape[1:] if shape else ())


def _uniform_plain(key: tuple[int, int], c0: int, c1: int,
                   device) -> torch.Tensor:
    """Numbers ``[c0, c1)`` of the flat draw under the host key words
    ``key`` (the dimension already folded in), as a chain of eager int64
    operations on ``device``: the CPU's path, and on the card the kernel's
    yardstick."""
    i = torch.arange(c0, c1, dtype=torch.int64, device=device)
    a, b = threefry2x32(key[0], key[1], i >> 32, i & _M32)
    bits = (((a ^ b) >> 9) | 0x3F800000).to(torch.int32)
    return torch.clamp_min(bits.view(torch.float32) - 1.0, 0.0)


def _uniform_kernel(key: torch.Tensor, dim: int, c0: int,
                    c1: int) -> torch.Tensor:
    """Numbers ``[c0, c1)`` of the flat draw under ``fold_in(K, dim)``, K
    the two words of ``key`` on the card when the launch runs: one launch
    of ``csrc/rng.cu`` (none for an empty range)."""
    kernel = "threefry_uniform"
    out = torch.empty((c1 - c0,), dtype=torch.float32, device=key.device)
    if c1 == c0:
        return out
    lib = _build.library()
    with torch.cuda.device(key.device):
        err = lib.mitr_threefry_uniform(out.data_ptr(), c1 - c0, c0,
                                        key.data_ptr(), int(dim) & _M32,
                                        _build.stream_of(key.device))
    _build.check(err, kernel)
    trace.count_launch(kernel)
    trace.count("rng.draws_kernel", 1)
    return out


class Sampler:
    """Per-wavefront independent sampler over ``n`` lanes on the device of
    its stream key ``key`` (:func:`pass_keys`).

    ``next_1d()`` returns ``(n,)`` float32 in [0, 1), ``next_2d()`` returns
    ``(n, 2)``; the only state is the dimension counter.
    ``Sampler(seed, n, stream, device)`` makes its own key (``stream``
    separates passes and sensors; ``seed`` is the user seed);
    :meth:`on` takes a key made by the caller, a row of a render's
    :func:`pass_keys`."""

    def __init__(self, seed: int, n: int, stream: int = 0, device="cpu"):
        self.key = pass_keys(seed, [stream], device)[0]
        self.n = n
        self.dim = 0

    @classmethod
    def on(cls, key: torch.Tensor, n: int) -> "Sampler":
        s = cls.__new__(cls)
        s.key, s.n, s.dim = key, n, 0
        return s

    def next_1d(self) -> torch.Tensor:
        u = self.eval_1d(self.dim)
        self.dim += 1
        return u

    def next_2d(self) -> torch.Tensor:
        u = self.eval_2d(self.dim)
        self.dim += 2
        return u

    def eval_1d(self, dim: int) -> torch.Tensor:
        return uniform(self.key, dim, (self.n,))

    def eval_2d(self, dim: int) -> torch.Tensor:
        return torch.stack([self.eval_1d(dim), self.eval_1d(dim + 1)], dim=-1)


def draw_bounce_block(key: torch.Tensor, it: int, n: int,
                      dims: int) -> torch.Tensor:
    """One uniform draw of all of a bounce's sampler dimensions, ``(n,
    dims)``, on ``key``'s device; deterministic in ``(key, it)``."""
    return uniform(key, BOUNCE_STREAM_TAG + it, (n, dims))
