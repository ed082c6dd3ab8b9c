"""Scene state carried across from the JAX package.

The renderer's counterpart of carrying weights across: the JAX package's
``SceneData``, flattened by path into numpy arrays (``"tri.v0"``,
``"bsdf.reflectance"``, ...), becomes the port's :class:`SceneData`, so
that both packages can trace the very same scene.  The tables the port
derives (``scene/scene.py:DERIVED_FIELDS``: the kernels' triangle table,
the accel's trees over the chunk and super-chunk boxes) are its own: they
are rebuilt here and left out of the flattened leaves.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.accel import Accel, accel_trees
from .ops.intersect import tri_table
from .scene.schema import resolve_device
from .scene.scene import (
    BSDF_DIFFUSE,
    DERIVED_FIELDS,
    EM_AREA,
    BSDFParams,
    EmitterParams,
    GeomParams,
    SceneData,
    Triangles,
)

_RECORDS = {"tri": Triangles, "bsdf": BSDFParams, "emitter": EmitterParams,
            "accel": Accel, "geom": GeomParams}


def scene_data_from_numpy(leaves: dict[str, np.ndarray],
                          device="cuda") -> SceneData:
    """Build the port's SceneData on ``device`` from
    ``{"record.field": array}``.

    Every field of the port's records must be present (the ``accel`` and
    ``geom`` records may be left out; the derived tables are built, not
    read).  Media leaves (``medium.*``) are
    ignored when no triangle has an interior medium.  A leaf the port cannot
    render - textures, another BSDF or emitter kind, media - raises
    ``NotImplementedError``.
    """
    device = resolve_device(device)
    extra = set(leaves) - {f"{r}.{f}" for r, cls in _RECORDS.items()
                           for f in cls._fields}
    if np.any(np.asarray(leaves["tri.medium_id"]) >= 0):
        raise NotImplementedError("participating media (ROADMAP item 15)")
    extra = {k for k in extra if not k.startswith("medium.")}
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
        host = {f: np.asarray(leaves[f"{name}.{f}"]) for f in cls._fields
                if f not in DERIVED_FIELDS.get(name, ())}
        if name == "accel":
            host.update(accel_trees(host["aabb_min"], host["aabb_max"],
                                    host["sup_min"], host["sup_max"]))
        rec = {f: torch.tensor(a, device=device) for f, a in host.items()}
        if name == "tri":
            rec["table"] = tri_table(rec["v0"], rec["e1"], rec["e2"])
        return cls(**rec)

    def optional(name):
        has = any(k.startswith(name + ".") for k in leaves)
        return record(name) if has else None

    return SceneData(tri=record("tri"), bsdf=record("bsdf"),
                     emitter=record("emitter"), accel=optional("accel"),
                     geom=optional("geom"))


def scene_data_to_numpy(sd: SceneData) -> dict[str, np.ndarray]:
    """Flatten the port's SceneData by path into host numpy arrays: the
    leaves of the JAX package's SceneData (no derived tables)."""
    out = {}
    for name in SceneData._fields:
        rec = getattr(sd, name)
        if rec is None:
            continue
        for f in rec._fields:
            if f not in DERIVED_FIELDS.get(name, ()):
                out[f"{name}.{f}"] = getattr(rec, f).cpu().numpy()
    return out
