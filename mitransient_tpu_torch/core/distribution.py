"""Discrete distributions for table-driven sampling (counterpart of
``mitransient_tpu/core/distribution.py``, ``mi.DiscreteDistribution``).

The JAX package searches the inclusive CDF with a fixed-trip branchless
binary search; ``torch.searchsorted`` (left side) returns the same index,
the first entry not below ``u``, because the CDF is a float32 cumsum of
non-negative weights and never decreases.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class DiscreteDistribution(NamedTuple):
    pmf: torch.Tensor  # (n,) normalized probabilities
    cdf: torch.Tensor  # (n,) inclusive cumulative sum (last element == 1)
    total: torch.Tensor  # () original (unnormalized) sum

    @staticmethod
    def from_weights(w) -> "DiscreteDistribution":
        w = torch.as_tensor(w, dtype=torch.float32)
        total = w.sum()
        pmf = w / torch.clamp_min(total, 1e-30)
        return DiscreteDistribution(pmf, torch.cumsum(pmf, 0), total)

    @staticmethod
    def from_cdf(cdf: torch.Tensor,
                 total: torch.Tensor) -> "DiscreteDistribution":
        """The distribution of an inclusive CDF made elsewhere (the NLOS
        hidden-geometry table), each pmf entry the step of the CDF to it."""
        pmf = cdf - torch.cat([cdf.new_zeros(1), cdf[:-1]])
        return DiscreteDistribution(pmf, cdf, total)

    @property
    def n(self) -> int:
        return self.pmf.shape[0]

    def sample(self, u: torch.Tensor) -> torch.Tensor:
        """Inverse-CDF sample; u in [0, 1) of any shape -> int64 indices."""
        idx = torch.searchsorted(self.cdf, u.contiguous())
        return torch.clamp(idx, 0, self.n - 1)

    def sample_pmf(self, u: torch.Tensor):
        idx = self.sample(u)
        return idx, self.pmf[idx]

    def sample_reuse(self, u: torch.Tensor):
        """Sample an index and rescale ``u`` to a fresh uniform in [0, 1)."""
        idx = self.sample(u)
        cdf_lo = torch.where(idx > 0, self.cdf[torch.clamp_min(idx - 1, 0)],
                             0.0)
        p = self.pmf[idx]
        u2 = torch.clamp((u - cdf_lo) / torch.clamp_min(p, 1e-30), 0.0,
                         1.0 - 1e-7)
        return idx, u2, p
