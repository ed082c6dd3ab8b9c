"""Scene state carried across from the JAX package.

The renderer's counterpart of carrying weights across: the JAX package's
``SceneData``, flattened by path into numpy arrays (``"tri.v0"``,
``"bsdf.reflectance"``, ...), becomes the port's :class:`SceneData`, so
that both packages can trace the very same scene.  The tables the port
derives (``scene/scene.py:DERIVED_FIELDS``: the kernels' triangle table,
the emitter-triangle search keys, the accel's trees over the chunk and
super-chunk boxes) and the static kind sets are its own: they are rebuilt
here and left out of the flattened leaves.  The NLOS
integrator's constants (``NLOSContext``, ``ExhaustiveLaser``) cross the
same way (:func:`nlos_context_from_numpy`), and so do the gradient
tables of the differentiable renders (:func:`diff_params_from_numpy`,
:func:`diff_params_to_numpy`).
"""
from __future__ import annotations

import numpy as np
import torch

from .integrators.nlos_path import ExhaustiveLaser, NLOSContext
from .integrators.prb import DiffParams
from .ops.accel import Accel, accel_trees
from .ops.intersect import tri_table
from .scene.schema import resolve_device
from .scene.scene import (
    DERIVED_FIELDS,
    BSDFParams,
    EmitterParams,
    GeomParams,
    MediumParams,
    SceneData,
    Triangles,
    bsdf_kinds,
    em_tri_key_table,
    emitter_kinds,
)

_RECORDS = {"tri": Triangles, "bsdf": BSDFParams, "emitter": EmitterParams,
            "accel": Accel, "geom": GeomParams, "medium": MediumParams}


def scene_data_from_numpy(leaves: dict[str, np.ndarray],
                          device="cuda") -> SceneData:
    """Build the port's SceneData on ``device`` from
    ``{"record.field": array}``.

    Every field of the port's records must be present, but for the BSDF
    table's texture and bump-map columns, which a scene without them
    leaves out (the ``accel``, ``geom`` and ``medium`` records may be
    left out; the derived tables are built, not read).  A scene whose
    triangles name an interior medium (``tri.medium_id``) needs the
    ``medium`` record.
    """
    device = resolve_device(device)
    if (np.any(np.asarray(leaves["tri.medium_id"]) >= 0)
            and not any(k.startswith("medium.") for k in leaves)):
        raise ValueError("tri.medium_id names media but no medium.* leaves "
                         "are given")
    extra = set(leaves) - {f"{r}.{f}" for r, cls in _RECORDS.items()
                           for f in cls._fields}
    if extra:
        raise ValueError(f"not leaves of a scene: {sorted(extra)}")

    def record(name):
        cls = _RECORDS[name]
        derived = DERIVED_FIELDS.get(name, ())
        host = {f: np.asarray(leaves[f"{name}.{f}"]) for f in cls._fields
                if f not in derived and (f"{name}.{f}" in leaves
                                         or f not in cls._field_defaults)}
        if name == "accel":
            host.update(accel_trees(host["aabb_min"], host["aabb_max"],
                                    host["sup_min"], host["sup_max"]))
        if name == "emitter":
            host["em_tri_key"] = em_tri_key_table(host["tri_count"],
                                                  host["em_tri_cdf"])
        rec = {f: torch.tensor(a, device=device) for f, a in host.items()}
        if name == "tri":
            rec["table"] = tri_table(rec["v0"], rec["e1"], rec["e2"])
        return cls(**rec)

    def optional(name):
        has = any(k.startswith(name + ".") for k in leaves)
        return record(name) if has else None

    return SceneData(tri=record("tri"), bsdf=record("bsdf"),
                     emitter=record("emitter"), accel=optional("accel"),
                     geom=optional("geom"), medium=optional("medium"),
                     emitter_kinds=emitter_kinds(leaves["emitter.kind"]),
                     bsdf_kinds=bsdf_kinds(leaves["bsdf.kind"],
                                           leaves["bsdf.two_sided"]))


def nlos_context_from_numpy(fields: dict[str, np.ndarray], device="cuda"):
    """The JAX package's ``NLOSContext`` or ``ExhaustiveLaser``, flattened
    to ``{field: array}``, as the port's record of the same name on
    ``device`` (which record: the one whose fields these are)."""
    device = resolve_device(device)
    for cls in (NLOSContext, ExhaustiveLaser):
        if set(fields) == set(cls._fields):
            return cls(**{f: torch.tensor(np.asarray(fields[f]), device=device)
                          for f in cls._fields})
    raise ValueError(f"not the fields of an NLOSContext or an "
                     f"ExhaustiveLaser: {sorted(fields)}")


def scene_data_to_numpy(sd: SceneData) -> dict[str, np.ndarray]:
    """Flatten the port's SceneData by path into host numpy arrays: the
    leaves of the JAX package's SceneData (no derived tables)."""
    out = {}
    for name in SceneData._fields:
        rec = getattr(sd, name)
        if rec is None or name in ("emitter_kinds", "bsdf_kinds"):
            continue
        for f in rec._fields:
            v = getattr(rec, f)
            if v is not None and f not in DERIVED_FIELDS.get(name, ()):
                out[f"{name}.{f}"] = v.cpu().numpy()
    return out


def diff_params_from_numpy(fields: dict, device="cuda") -> DiffParams:
    """The JAX package's ``DiffParams``, as ``{field: array or None}``, as
    the port's :class:`DiffParams` on ``device`` (the same field names;
    absent fields are None)."""
    device = resolve_device(device)
    extra = set(fields) - set(DiffParams._fields)
    if extra:
        raise ValueError(f"not fields of a DiffParams: {sorted(extra)}")
    return DiffParams(**{
        f: None if fields.get(f) is None
        else torch.tensor(np.asarray(fields[f]), device=device)
        for f in DiffParams._fields})


def diff_params_to_numpy(p: DiffParams) -> dict:
    """The port's DiffParams as ``{field: host array or None}`` under the
    JAX package's field names."""
    return {f: None if v is None else v.detach().cpu().numpy()
            for f, v in p._asdict().items()}
