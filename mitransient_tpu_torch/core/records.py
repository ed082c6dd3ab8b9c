"""Interaction / sample records as NamedTuples of ``(N, ...)`` tensors
(counterpart of ``mitransient_tpu/core/records.py``)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from .frame import Frame
from .math import dot


class Ray(NamedTuple):
    o: torch.Tensor  # (N, 3) origin
    d: torch.Tensor  # (N, 3) unit direction
    maxt: torch.Tensor  # (N,) maximum t (inf for camera rays)

    @staticmethod
    def make(o, d, maxt=None):
        if maxt is None:
            maxt = torch.full(o.shape[:-1], float("inf"), dtype=torch.float32,
                              device=o.device)
        return Ray(o, d, maxt)


class SurfaceInteraction(NamedTuple):
    valid: torch.Tensor  # (N,) bool - hit anything
    t: torch.Tensor  # (N,) hit distance (inf on miss)
    p: torch.Tensor  # (N, 3) hit point
    n: torch.Tensor  # (N, 3) geometric normal
    frame: Frame  # shading frame (n == frame.n for flat shading)
    uv: torch.Tensor  # (N, 2)
    wi: torch.Tensor  # (N, 3) incident dir in the local frame (toward viewer)
    prim: torch.Tensor  # (N,) int32 triangle index (-1 miss)
    shape_id: torch.Tensor  # (N,) int32
    bsdf_id: torch.Tensor  # (N,) int32
    emitter_id: torch.Tensor  # (N,) int32 (-1 = not an emitter)

    def spawn_ray(self, d: torch.Tensor, offset_eps: float = 1e-4) -> Ray:
        """Offset along the geometric normal on the side of ``d`` to avoid
        self-intersection."""
        side = torch.sign(dot(self.n, d))[:, None]
        return Ray.make(self.p + self.n * side * offset_eps, d)


class DirectionSample(NamedTuple):
    """Direction toward an emitter from a reference point; ``pdf`` is in
    solid angle and includes the emitter-selection probability."""

    p: torch.Tensor  # (N, 3) sampled point on the emitter
    n: torch.Tensor  # (N, 3) emitter normal at p
    d: torch.Tensor  # (N, 3) unit direction ref -> p
    dist: torch.Tensor  # (N,)
    pdf: torch.Tensor  # (N,)
    delta: torch.Tensor  # (N,) bool - delta emitter
    emitter_id: torch.Tensor  # (N,) int32


class BSDFSample(NamedTuple):
    wo: torch.Tensor  # (N, 3) sampled outgoing dir, local frame
    pdf: torch.Tensor  # (N,)
    eta: torch.Tensor  # (N,) relative IOR of the sampled event
    delta: torch.Tensor  # (N,) bool - sampled a Dirac lobe
    weight: torch.Tensor  # (N, C) bsdf * cos / pdf
