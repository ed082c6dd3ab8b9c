"""Scene state carried across from the JAX package.

The renderer's counterpart of carrying weights across: the JAX package's
``SceneData``, flattened by path into numpy arrays (``"tri.v0"``,
``"bsdf.reflectance"``, ...), becomes the port's :class:`SceneData`, so
that both packages can trace the very same scene.
"""
from __future__ import annotations

import numpy as np
import torch

from .scene.scene import (
    BSDF_DIFFUSE,
    EM_AREA,
    BSDFParams,
    EmitterParams,
    GeomParams,
    SceneData,
    Triangles,
)

_RECORDS = {"tri": Triangles, "bsdf": BSDFParams, "emitter": EmitterParams,
            "geom": GeomParams}


def scene_data_from_numpy(leaves: dict[str, np.ndarray], device="cpu") -> SceneData:
    """Build the port's SceneData from ``{"record.field": array}``.

    Every field of the port's records must be present (the ``geom`` record
    may be left out).  Media leaves (``medium.*``) are ignored when no
    triangle has an interior medium.  A leaf the port cannot render - an
    acceleration structure, textures, another BSDF or emitter kind, media -
    raises ``NotImplementedError``.
    """
    extra = set(leaves) - {f"{r}.{f}" for r, cls in _RECORDS.items()
                           for f in cls._fields}
    if np.any(np.asarray(leaves["tri.medium_id"]) >= 0):
        raise NotImplementedError("participating media (ROADMAP item 15)")
    extra = {k for k in extra if not k.startswith("medium.")}
    if any(k.startswith("accel.") for k in extra):
        raise NotImplementedError("BVH acceleration structures (ROADMAP item 17)")
    if extra:
        raise NotImplementedError(
            f"scene leaves not ported yet (ROADMAP item 11): {sorted(extra)}")
    if np.any(np.asarray(leaves["bsdf.kind"]) != BSDF_DIFFUSE) or np.any(
            np.asarray(leaves["bsdf.two_sided"])):
        raise NotImplementedError(
            "only one-sided diffuse BSDFs are ported (ROADMAP item 11)")
    if np.any(np.asarray(leaves["emitter.kind"]) != EM_AREA):
        raise NotImplementedError("only area emitters are ported (ROADMAP item 11)")

    def record(name):
        cls = _RECORDS[name]
        return cls(*(torch.tensor(np.asarray(leaves[f"{name}.{f}"]),
                                  device=device) for f in cls._fields))

    has_geom = any(k.startswith("geom.") for k in leaves)
    return SceneData(tri=record("tri"), bsdf=record("bsdf"),
                     emitter=record("emitter"),
                     geom=record("geom") if has_geom else None)


def scene_data_to_numpy(sd: SceneData) -> dict[str, np.ndarray]:
    """Flatten the port's SceneData by path into host numpy arrays."""
    out = {}
    for name in SceneData._fields:
        rec = getattr(sd, name)
        if rec is None:
            continue
        for f in rec._fields:
            out[f"{name}.{f}"] = getattr(rec, f).cpu().numpy()
    return out
