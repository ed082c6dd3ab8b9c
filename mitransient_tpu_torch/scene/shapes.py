"""Host-side shape plugins that compile to world-space triangle soup.

A copy of the ``rectangle`` and ``cube`` plugins of
``mitransient_tpu/scene/shapes.py`` (numpy only).  Mesh shapes (obj, ply,
in-memory meshes) are not ported yet: ROADMAP item 11.

Conventions match Mitsuba:
* ``rectangle``: XY square [-1,1]^2 at z=0, normal +z, uv(0,0) at (-1,-1).
* ``cube``: [-1,1]^3 with outward normals, per-face uv in [0,1]^2.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..core.transform import Transform4, from_spec


class TriangleData(NamedTuple):
    """Host-side triangle arrays for one shape (world space)."""

    v0: np.ndarray  # (M, 3)
    v1: np.ndarray
    v2: np.ndarray
    uv0: np.ndarray  # (M, 2)
    uv1: np.ndarray
    uv2: np.ndarray

    @property
    def count(self) -> int:
        return self.v0.shape[0]


class Shape:
    """Base class: builds world-space TriangleData."""

    shape_type = "shape"

    def __init__(self, props: dict):
        self.id = props.get("id", "")
        self.to_world: Transform4 = from_spec(props.get("to_world"))
        self.bsdf_key = None  # filled by schema
        self.emitter_key = None

    def triangles(self) -> TriangleData:
        raise NotImplementedError

    def _bake(self, verts: np.ndarray, faces: np.ndarray,
              uvs: np.ndarray) -> TriangleData:
        w = self.to_world.apply_point(verts).astype(np.float64)
        return TriangleData(
            v0=w[faces[:, 0]].astype(np.float32),
            v1=w[faces[:, 1]].astype(np.float32),
            v2=w[faces[:, 2]].astype(np.float32),
            uv0=uvs[faces[:, 0]].astype(np.float32),
            uv1=uvs[faces[:, 1]].astype(np.float32),
            uv2=uvs[faces[:, 2]].astype(np.float32),
        )


class Rectangle(Shape):
    shape_type = "rectangle"

    def triangles(self) -> TriangleData:
        verts = np.array(
            [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float64
        )
        uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
        faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
        return self._bake(verts, faces, uvs)


class Cube(Shape):
    shape_type = "cube"

    def triangles(self) -> TriangleData:
        # 6 faces x 2 triangles; each face has its own 4 vertices for clean
        # uvs, vertices CCW seen from outside
        quads = [
            [[-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]],  # +z
            [[1, -1, -1], [-1, -1, -1], [-1, 1, -1], [1, 1, -1]],  # -z
            [[1, -1, 1], [1, -1, -1], [1, 1, -1], [1, 1, 1]],  # +x
            [[-1, -1, -1], [-1, -1, 1], [-1, 1, 1], [-1, 1, -1]],  # -x
            [[-1, 1, 1], [1, 1, 1], [1, 1, -1], [-1, 1, -1]],  # +y
            [[-1, -1, -1], [1, -1, -1], [1, -1, 1], [-1, -1, 1]],  # -y
        ]
        quad_uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
        verts = np.concatenate([np.asarray(q, np.float64) for q in quads])
        uvs = np.concatenate([quad_uv] * len(quads))
        faces = np.concatenate([
            np.array([[b, b + 1, b + 2], [b, b + 2, b + 3]])
            for b in range(0, 4 * len(quads), 4)]).astype(np.int32)
        return self._bake(verts, faces, uvs)


SHAPE_REGISTRY = {
    "rectangle": Rectangle,
    "cube": Cube,
}
