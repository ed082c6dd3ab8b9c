"""Host-side 4x4 affine transforms (numpy) used at scene-build time.

A copy of ``mitransient_tpu/core/transform.py``: importing the JAX package
would import jax, so the numpy-only module is copied rather than imported.
Semantics mirror Mitsuba's ``ScalarTransform4f`` chain API
(``T().translate(...).rotate(...).scale(...)`` and ``T().look_at(...)``).
"""
from __future__ import annotations

import numpy as np


class Transform4:
    """Immutable 4x4 homogeneous transform with Mitsuba-style chaining.

    ``t.translate(v)`` returns ``t @ translation(v)`` (right-multiplication,
    matching Mitsuba where the chain is applied left-to-right to points).
    """

    __slots__ = ("m",)

    def __init__(self, m: np.ndarray | None = None):
        self.m = np.eye(4, dtype=np.float64) if m is None else np.asarray(m, np.float64)

    # ---- chaining constructors -------------------------------------------------
    def _chain(self, other: np.ndarray) -> "Transform4":
        return Transform4(self.m @ other)

    def translate(self, v) -> "Transform4":
        m = np.eye(4)
        m[:3, 3] = np.asarray(v, np.float64)
        return self._chain(m)

    def scale(self, v) -> "Transform4":
        v = np.asarray(v, np.float64)
        if v.ndim == 0:
            v = np.array([v, v, v])
        m = np.diag(np.array([v[0], v[1], v[2], 1.0]))
        return self._chain(m)

    def rotate(self, axis, angle_deg: float) -> "Transform4":
        axis = np.asarray(axis, np.float64)
        axis = axis / np.linalg.norm(axis)
        a = np.deg2rad(angle_deg)
        c, s = np.cos(a), np.sin(a)
        x, y, z = axis
        r = np.array(
            [
                [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
                [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
                [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
            ]
        )
        m = np.eye(4)
        m[:3, :3] = r
        return self._chain(m)

    def look_at(self, origin, target, up) -> "Transform4":
        """Mitsuba look_at: camera-space +z points at ``target``; x axis is
        ``cross(up, dir)`` (left-handed camera basis, cf. Mitsuba core
        transform.h semantics)."""
        origin = np.asarray(origin, np.float64)
        target = np.asarray(target, np.float64)
        up = np.asarray(up, np.float64)
        d = target - origin
        d = d / np.linalg.norm(d)
        left = np.cross(up, d)
        left = left / np.linalg.norm(left)
        new_up = np.cross(d, left)
        m = np.eye(4)
        m[:3, 0] = left
        m[:3, 1] = new_up
        m[:3, 2] = d
        m[:3, 3] = origin
        return self._chain(m)

    # ---- application -----------------------------------------------------------
    def apply_point(self, p: np.ndarray) -> np.ndarray:
        p = np.asarray(p, np.float64)
        return p @ self.m[:3, :3].T + self.m[:3, 3]

    def apply_vector(self, v: np.ndarray) -> np.ndarray:
        v = np.asarray(v, np.float64)
        return v @ self.m[:3, :3].T

    def apply_normal(self, n: np.ndarray) -> np.ndarray:
        inv = np.linalg.inv(self.m[:3, :3])
        n = np.asarray(n, np.float64) @ inv
        return n

    @property
    def translation(self) -> np.ndarray:
        return self.m[:3, 3].copy()

    def inverse(self) -> "Transform4":
        return Transform4(np.linalg.inv(self.m))

    def __matmul__(self, other: "Transform4") -> "Transform4":
        return Transform4(self.m @ other.m)

    def __repr__(self):
        return f"Transform4(\n{self.m}\n)"


def from_spec(spec) -> Transform4:
    """Build a Transform4 from a scene-dict value: a Transform4 already, a
    4x4 nested list, a dict of chained ops like
    ``{'look_at': {'origin': ..., 'target': ..., 'up': ...}}``, or a list of
    single-op dicts (``[{'rotate': ...}, {'rotate': ...}]``) when the same
    op repeats — matching Mitsuba's sequentially-chained ``<transform>``."""
    if isinstance(spec, Transform4):
        return spec
    if spec is None:
        return Transform4()
    if (isinstance(spec, (list, tuple)) and spec
            and all(isinstance(s, dict) for s in spec)):
        t = Transform4()
        for s in spec:
            t = Transform4(t.m @ from_spec(s).m)
        return t
    if isinstance(spec, dict):
        t = Transform4()
        for op, args in spec.items():
            if op == "look_at":
                t = t.look_at(args["origin"], args["target"], args.get("up", [0, 1, 0]))
            elif op == "translate":
                t = t.translate(args)
            elif op == "scale":
                t = t.scale(args)
            elif op == "rotate":
                t = t.rotate(args["axis"], args["angle"])
            elif op == "matrix":
                t = t._chain(np.asarray(args, np.float64).reshape(4, 4))
            else:
                raise ValueError(f"unknown transform op {op!r}")
        return t
    return Transform4(np.asarray(spec, np.float64).reshape(4, 4))
