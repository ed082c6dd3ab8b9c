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

Keys are pairs of Python ints, derived on the host; only the draws run on
the device.  A draw on the CPU is the plain version (``_uniform_plain``):
PyTorch has no uint32 shifts there, so the 32-bit words are held in int64
and masked to 32 bits, as the regen loop's PCG hash is
(``integrators/path_regen.py``).  A draw on the card is one launch of the
hand-written kernel ``csrc/rng.cu`` (``_uniform_kernel``), with the keys as
two ``uint32`` arguments, or raises.

A pass body captured into a CUDA graph (``passgraph.py``) cannot take its
keys as arguments, which the graph would freeze.  While a
:class:`KeyRecorder` records (:func:`recording`), each draw on the card
instead takes the next row of the recorder's device buffer of key slots
and launches the kernel's keyed entry point, which reads the key from that
row when it runs; the recorder notes which dimension of the pass's stream
the draw's key folds in.  :func:`pass_key_table` derives every pass's keys
for those dimensions on the host, as :class:`Sampler` and
:func:`draw_bounce_block` do, and the graph's owner copies a pass's row
into the slots before each replay.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from .. import trace
from ..kernels import _build

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
BOUNCE_STREAM_TAG = 0x42000000  # disambiguates bounce blocks from scalar dims
SCALAR_DIMS = 64  # the Sampler dimensions a KeyRecorder looks among

_local = threading.local()  # .recorder: the KeyRecorder recording, or None


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


def uniform(key: tuple[int, int], shape, device="cpu",
            rows: tuple[int, int] | None = None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1).

    ``rows=(r0, r1)`` draws only rows ``[r0, r1)`` of the leading axis,
    the same bits as those rows of the whole draw (they are the flat
    counters ``[r0 * k, r1 * k)``, k the size of a row), so that a large
    draw can be made in slices.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    shape = tuple(shape)
    row = 1
    for s in shape[1:]:
        row *= s
    r0, r1 = rows if rows is not None else (0, shape[0] if shape else 1)
    dev = torch.device(device)
    trace.count("rng.draws", 1)
    with trace.span("mitr:rng"):
        if dev.type == "cpu":
            u = _uniform_plain(key, r0 * row, r1 * row, dev)
        elif dev.type == "cuda":
            rec = getattr(_local, "recorder", None)
            u = (_uniform_kernel(key, r0 * row, r1 * row, dev) if rec is None
                 else _uniform_keyed(rec.slot(key), r0 * row, r1 * row, dev))
        else:
            raise ValueError(f"uniform: device {dev}; expected cpu or cuda")
        return u.reshape((r1 - r0,) + shape[1:] if shape else ())


def _uniform_plain(key: tuple[int, int], c0: int, c1: int,
                   device) -> torch.Tensor:
    """Numbers ``[c0, c1)`` of the flat draw under ``key``, as a chain of
    eager int64 operations on ``device``: the CPU's path, and on the card
    the kernel's yardstick."""
    i = torch.arange(c0, c1, dtype=torch.int64, device=device)
    a, b = threefry2x32(key[0], key[1], i >> 32, i & _M32)
    bits = (((a ^ b) >> 9) | 0x3F800000).to(torch.int32)
    return torch.clamp_min(bits.view(torch.float32) - 1.0, 0.0)


def _uniform_kernel(key: tuple[int, int], c0: int, c1: int,
                    device) -> torch.Tensor:
    """Numbers ``[c0, c1)`` of the flat draw under ``key``: one launch of
    ``csrc/rng.cu`` on ``device`` (none for an empty range)."""
    kernel = "threefry_uniform"
    out = torch.empty((c1 - c0,), dtype=torch.float32, device=device)
    if c1 == c0:
        return out
    lib = _build.library()
    with torch.cuda.device(device):
        err = lib.mitr_threefry_uniform(out.data_ptr(), c1 - c0, c0, key[0],
                                        key[1], _build.stream_of(device))
    _build.check(err, kernel)
    trace.count_launch(kernel)
    trace.count("rng.draws_kernel", 1)
    return out


def _uniform_keyed(slot: int, c0: int, c1: int, device) -> torch.Tensor:
    """Numbers ``[c0, c1)`` of the flat draw under the key held by the two
    ``uint32`` words at device address ``slot`` when the launch runs: the
    keyed entry point of ``csrc/rng.cu``, the same bits as
    :func:`_uniform_kernel` under that key."""
    kernel = "threefry_uniform_keyed"
    out = torch.empty((c1 - c0,), dtype=torch.float32, device=device)
    if c1 == c0:
        return out
    lib = _build.library()
    with torch.cuda.device(device):
        err = lib.mitr_threefry_uniform_keyed(out.data_ptr(), c1 - c0, c0,
                                              slot, _build.stream_of(device))
    _build.check(err, kernel)
    trace.count_launch(kernel)
    trace.count("rng.draws_kernel", 1)
    return out


class GraphRefusal(Exception):
    """A pass body drew under a key that the pass graph cannot derive."""


class KeyRecorder:
    """The key slots of a pass body being captured into a CUDA graph.

    ``base`` is the key of the pass's stream (``Sampler.key``), ``slots`` an
    (S, 2) int32 tensor on the card.  Draw j of the body reads its key from
    row j of ``slots``; :attr:`dims` lists the dimension each draw's key
    folds into ``base``, among the sampler dimensions below
    :data:`SCALAR_DIMS` and the bounce blocks of ``max_depth`` bounces.  A
    key outside them, or more draws than rows, raises
    :class:`GraphRefusal`."""

    def __init__(self, base: tuple[int, int], slots: torch.Tensor,
                 max_depth: int):
        dims = list(range(SCALAR_DIMS)) + [BOUNCE_STREAM_TAG + it
                                           for it in range(max_depth)]
        self.fold = {fold_in(base, d): d for d in dims}
        self.slots = slots
        self.dims: list[int] = []

    def slot(self, key: tuple[int, int]) -> int:
        """The device address of the next draw's slot, for ``key``."""
        d = self.fold.get(tuple(key))
        if d is None:
            raise GraphRefusal(f"a draw under {key}: not a dimension of the "
                               "pass's stream")
        j = len(self.dims)
        if j >= self.slots.shape[0]:
            raise GraphRefusal(f"more than {j} draws in a pass")
        self.dims.append(d)
        return self.slots.data_ptr() + j * 2 * self.slots.element_size()


@contextlib.contextmanager
def recording(rec: KeyRecorder):
    """Draws on the card take their keys from ``rec``'s slots inside."""
    _local.recorder = rec
    try:
        yield rec
    finally:
        _local.recorder = None


def pass_key_table(seed: int, passes, dims) -> np.ndarray:
    """The keys of the multi-pass render's passes ``passes`` for the draw
    dimensions ``dims`` (a :attr:`KeyRecorder.dims`): (P, D, 2) uint32,
    row ``[i, j]`` = ``fold_in(fold_in(make_key(seed), passes[i]),
    dims[j])``, the key of ``Sampler(seed, n, stream=passes[i])``'s
    dimension ``dims[j]`` (or of its bounce block ``dims[j] -
    BOUNCE_STREAM_TAG``).  The same chain as :func:`fold_in`, on numpy
    words."""
    k0, k1 = make_key(seed)
    p = np.asarray(list(passes), np.uint64)[:, None]
    d = np.asarray(list(dims), np.uint64)[None, :]
    b0, b1 = threefry2x32(k0, k1, np.zeros_like(p), p & _M32)
    a, b = threefry2x32(b0, b1, np.zeros_like(d), d & _M32)
    return np.stack(np.broadcast_arrays(a, b), axis=-1).astype(np.uint32)


class Sampler:
    """Per-wavefront independent sampler over ``n`` lanes on ``device``.

    ``next_1d()`` returns ``(n,)`` float32 in [0, 1), ``next_2d()`` returns
    ``(n, 2)``; the only state is the dimension counter.  ``stream``
    separates passes and sensors; ``seed`` is the user seed."""

    def __init__(self, seed: int, n: int, stream: int = 0, device="cpu"):
        self.key = fold_in(make_key(seed), stream)
        self.n = n
        self.dim = 0
        self.device = device

    def next_1d(self) -> torch.Tensor:
        u = self.eval_1d(self.dim)
        self.dim += 1
        return u

    def next_2d(self) -> torch.Tensor:
        u = self.eval_2d(self.dim)
        self.dim += 2
        return u

    def eval_1d(self, dim: int) -> torch.Tensor:
        return uniform(fold_in(self.key, dim), (self.n,), self.device)

    def eval_2d(self, dim: int) -> torch.Tensor:
        return torch.stack([self.eval_1d(dim), self.eval_1d(dim + 1)], dim=-1)

    def fork(self, stream: int) -> "Sampler":
        s = Sampler.__new__(Sampler)
        s.key = fold_in(self.key, stream)
        s.n = self.n
        s.dim = 0
        s.device = self.device
        return s


def draw_bounce_block(key: tuple[int, int], it: int, n: int, dims: int,
                      device="cpu") -> torch.Tensor:
    """One uniform draw of all of a bounce's sampler dimensions, ``(n,
    dims)``; deterministic in ``(key, it)``."""
    return uniform(fold_in(key, BOUNCE_STREAM_TAG + it), (n, dims), device)
