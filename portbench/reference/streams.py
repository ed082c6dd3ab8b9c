"""The sample streams the renderer under test documents, written anew.

* The path-regeneration render draws every number from a stateless PCG
  hash of (seed, sample id, dimension), sample id = sample * HW + pixel.
* Every other render draws from the threefry-2x32 generator as
  ``jax.random`` defines it (20 rounds, partitionable counters): a key is
  a pair of 32-bit words, ``key(seed) = (0, seed)``, ``fold_in(k, d)`` is
  the hash of the counter ``(0, d)`` under ``k``, and a uniform of a flat
  index ``i`` hashes the counter ``(i >> 32, i & 0xffffffff)``, XORs the
  two output words and keeps the top 23 bits as a float in [1, 2), minus 1.
  A bounce's draws are one block of ``(lanes, dims)`` under
  ``fold_in(pass_key, 0x42000000 + bounce)``.

The 32-bit words are held in int64 tensors (the CPU has no uint32 shifts).
Only the lanes asked for are drawn: a lane's numbers do not depend on the
others', so a sample of pixels is drawn exactly as in the whole render.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
BOUNCE_TAG = 0x42000000


def _pcg_mix(x):
    x = (x * 747796405 + 2891336453) & M32
    w = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & M32
    return (w >> 22) ^ w


def pcg_uniform(seed: int, sample_id: torch.Tensor, dim) -> torch.Tensor:
    """Float32 uniform of (seed, sample id, dim); dim an int or a tensor."""
    inner = _pcg_mix((dim & M32) ^ _pcg_mix(int(seed) & M32))
    h = _pcg_mix((sample_id & M32) ^ inner)
    return h.to(torch.float32) * (1.0 / 4294967296.0)


def _rotl(x, r):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry(key, x0, x1):
    """Threefry-2x32, 20 rounds: key (k0, k1) Python ints, counter words
    Python ints or int64 tensors -> the two output words."""
    k0, k1 = key
    ks = (k0, k1, (k0 ^ k1 ^ 0x1BD11BDA) & M32)
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for rnd in range(5):
        for r in rot[rnd % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(rnd + 1) % 3]) & M32
        x1 = (x1 + ks[(rnd + 2) % 3] + rnd + 1) & M32
    return x0, x1


def fold_in(key, data: int):
    return threefry(key, 0, int(data) & M32)


def seed_key(seed: int):
    return (0, int(seed) & M32)


def uniform_at(key, index: torch.Tensor) -> torch.Tensor:
    """Float32 uniforms at the flat indices ``index`` (int64) of a draw."""
    a, b = threefry(key, index >> 32, index & M32)
    bits = (((a ^ b) >> 9) | 0x3F800000).to(torch.int32)
    return torch.clamp_min(bits.view(torch.float32) - 1.0, 0.0)


class PassStreams:
    """The threefry numbers of one pass of a multi-pass render (or of the
    differentiable renders' chunks and the NLOS captures), for the lanes
    ``lane`` (global lane ids, int64) of that pass."""

    def __init__(self, seed: int, pass_index: int, lane: torch.Tensor,
                 dims_per_bounce: int):
        self.key = fold_in(seed_key(seed), pass_index)
        self.lane = lane
        self.dims = dims_per_bounce

    def scalar_dim(self, dim: int) -> torch.Tensor:
        """Sampler dimension ``dim`` (the camera jitter takes 0 and 1)."""
        return uniform_at(fold_in(self.key, dim), self.lane)

    def bounce(self, it: int) -> torch.Tensor:
        """(lanes, dims) numbers of bounce ``it``."""
        k = fold_in(self.key, BOUNCE_TAG + it)
        idx = (self.lane[:, None] * self.dims
               + torch.arange(self.dims, device=self.lane.device)[None, :])
        return uniform_at(k, idx.reshape(-1)).reshape(-1, self.dims)
