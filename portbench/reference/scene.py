"""A scene dict (the Mitsuba-style dict the benchmark's configurations
hold) worked out into the arrays the plain reference traces: world-space
triangles, their diffuse reflectance, the area emitter and its triangle
distribution, the pinhole camera, the transient film and, for an NLOS
capture, the relay wall's scan points and the focused laser.

It covers what the configurations use: ``rectangle`` and ``cube`` shapes,
``diffuse`` BSDFs with RGB reflectance (inline or by ``ref``), an ``area``
emitter on a shape, one ``projector`` laser, a ``perspective`` sensor or
an ``nlos_capture_meter`` on a rectangle.  Shapes follow Mitsuba's
conventions: a rectangle is [-1, 1]^2 at z = 0 with normal +z, split
(0, 1, 2), (0, 2, 3) over its corners (-1,-1), (1,-1), (1,1), (-1,1); a
cube is [-1, 1]^3 with its six faces split the same way.  Transforms
chain left to right in the dict's order (Mitsuba's ``ScalarTransform4f``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

_RECT = (np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], float),
         np.array([[0, 1, 2], [0, 2, 3]]))
_CUBE_QUADS = (
    [[-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]],
    [[1, -1, -1], [-1, -1, -1], [-1, 1, -1], [1, 1, -1]],
    [[1, -1, 1], [1, -1, -1], [1, 1, -1], [1, 1, 1]],
    [[-1, -1, -1], [-1, -1, 1], [-1, 1, 1], [-1, 1, -1]],
    [[-1, 1, 1], [1, 1, 1], [1, 1, -1], [-1, 1, -1]],
    [[-1, -1, -1], [1, -1, -1], [1, -1, 1], [-1, -1, 1]],
)


def _rotation(axis, angle_deg):
    a = np.asarray(axis, float)
    x, y, z = a / np.linalg.norm(a)
    t = math.radians(angle_deg)
    c, s = math.cos(t), math.sin(t)
    C = 1.0 - c
    return np.array([[c + x * x * C, x * y * C - z * s, x * z * C + y * s],
                     [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
                     [z * x * C - y * s, z * y * C + x * s, c + z * z * C]])


def _look_at(origin, target, up):
    o, t, u = (np.asarray(v, float) for v in (origin, target, up))
    fwd = (t - o) / np.linalg.norm(t - o)
    left = np.cross(u, fwd)
    left /= np.linalg.norm(left)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = left, np.cross(fwd, left), fwd, o
    return m


def transform(spec) -> np.ndarray:
    """4x4 float64 matrix of a ``to_world`` dict (ops applied in order)."""
    m = np.eye(4)
    for op, arg in (spec or {}).items():
        step = np.eye(4)
        if op == "translate":
            step[:3, 3] = arg
        elif op == "scale":
            step[:3, :3] = np.diag(np.broadcast_to(np.asarray(arg, float),
                                                   (3,)))
        elif op == "rotate":
            step[:3, :3] = _rotation(arg["axis"], arg["angle"])
        elif op == "look_at":
            step = _look_at(arg["origin"], arg["target"],
                            arg.get("up", [0, 1, 0]))
        else:
            raise ValueError(f"transform op {op!r} is not covered")
        m = m @ step
    return m


def _shape_mesh(kind):
    if kind == "rectangle":
        return _RECT
    if kind == "cube":
        verts = np.concatenate([np.asarray(q, float) for q in _CUBE_QUADS])
        faces = np.concatenate([[[b, b + 1, b + 2], [b, b + 2, b + 3]]
                                for b in range(0, 24, 4)])
        return verts, faces
    raise ValueError(f"shape type {kind!r} is not covered")


def _world(m, p):
    return np.asarray(p, float) @ m[:3, :3].T + m[:3, 3]


class RefScene:
    """Host arrays of a scene; :meth:`to` puts the tracer's on a device."""

    def __init__(self, desc: dict, focus_pixel=None):
        bsdfs = {k: v for k, v in desc.items()
                 if isinstance(v, dict) and v.get("type") == "diffuse"}
        v0s, v1s, v2s, refl, emit, shape_of = [], [], [], [], [], []
        bsdf_names = []
        self.laser = None
        self.sensor = None
        self.wall = None  # the relay wall's transform (NLOS)
        shape_no = 0
        for key, val in desc.items():
            if not isinstance(val, dict):
                continue
            kind = val.get("type")
            if kind in ("rectangle", "cube"):
                m = transform(val.get("to_world"))
                verts, faces = _shape_mesh(kind)
                w = _world(m, verts).astype(np.float32)
                v0s.append(w[faces[:, 0]])
                v1s.append(w[faces[:, 1]])
                v2s.append(w[faces[:, 2]])
                b = val.get("bsdf", {"type": "diffuse"})
                b_name = key
                if b.get("type") == "ref":
                    b_name = b["id"]
                    b = bsdfs[b_name]
                rgb = b.get("reflectance", {"value": [0.5] * 3})["value"]
                n = faces.shape[0]
                refl += [rgb] * n
                bsdf_names += [b_name] * n
                em = val.get("emitter")
                emit += [em["radiance"]["value"] if em else None] * n
                shape_of += [shape_no] * n
                if "nlos_sensor" in val:
                    self.wall, self.wall_shape = m, shape_no
                    self.sensor = val["nlos_sensor"]
                shape_no += 1
            elif kind == "projector":
                self.laser = dict(origin=np.asarray(
                    val["to_world"]["translate"], float),
                    irradiance=np.asarray(val["irradiance"]["value"], float))
            elif kind == "perspective":
                self.sensor = val
            elif kind in ("transient_path", "transient_nlos_path"):
                self.integrator = val
        self.v0 = np.concatenate(v0s)
        e1 = np.concatenate(v1s) - self.v0
        e2 = np.concatenate(v2s) - self.v0
        self.e1, self.e2 = e1, e2
        cr = np.cross(e1, e2)
        nrm = np.linalg.norm(cr, axis=-1, keepdims=True)
        self.ng = (cr / np.maximum(nrm, 1e-20)).astype(np.float32)
        self.area = (0.5 * nrm[:, 0]).astype(np.float32)
        self.refl = np.asarray(refl, np.float32)
        self.shape_id = np.asarray(shape_of)
        self.bsdf_name = np.asarray(bsdf_names)
        self.is_emitter = np.array([e is not None for e in emit])
        film = self.sensor["film"]
        self.width, self.height = film["width"], film["height"]
        self.bins = film["temporal_bins"]
        self.start_opl = float(film.get("start_opl", 0.0))
        self.bin_width = float(film["bin_width_opl"])
        self.max_depth = int(self.integrator.get("max_depth", 8))
        self.rr_depth = int(self.integrator.get("rr_depth", 5))
        if self.laser is None:
            self._area_light(emit)
            self._camera()
        else:
            self._nlos(focus_pixel)

    def _area_light(self, emit):
        idx = np.nonzero(self.is_emitter)[0]
        if len(set(self.shape_id[idx])) != 1:
            raise ValueError("one area emitter is covered")
        self.radiance = np.asarray(emit[idx[0]], np.float32)
        areas = self.area[idx]
        total = float(np.sum(areas))
        self.light_tris = idx
        self.light_cdf = np.cumsum(areas / total).astype(np.float32)
        self.light_area = np.float32(total)

    def _camera(self):
        s = self.sensor
        m = transform(s["to_world"])
        w, h = self.width, self.height
        t = math.tan(math.radians(s.get("fov", 45.0)) / 2.0)
        axis = s.get("fov_axis", "x")
        if axis == "smaller":
            axis = "x" if w <= h else "y"
        elif axis == "larger":
            axis = "x" if w >= h else "y"
        self.cam_R = m[:3, :3].astype(np.float32)
        self.cam_o = m[:3, 3].astype(np.float32)
        self.tan_half = np.array([t, t / (w / h)] if axis == "x"
                                 else [t * (w / h), t], np.float32)

    def _nlos(self, focus_pixel):
        """Scan points at the relay wall's pixel centres, the laser aimed at
        the centre of ``focus_pixel``, the hidden-geometry distribution over
        every triangle off the wall."""
        px, py = np.meshgrid(np.arange(self.width), np.arange(self.height))
        uv = np.stack([(px.ravel() + 0.5) / self.width,
                       (py.ravel() + 0.5) / self.height], -1)
        self.scan = self._wall_point(uv).astype(np.float32)
        self.sensor_origin = np.asarray(self.sensor["sensor_origin"],
                                        np.float32)
        fx, fy = focus_pixel
        target = self._wall_point(np.array([fx / self.width,
                                            fy / self.height]))
        self.laser_target = target.astype(np.float32)
        hidden = np.nonzero(self.shape_id != self.wall_shape)[0]
        areas = self.area[hidden]
        total = float(np.sum(areas))
        self.hidden_tris = hidden
        self.hidden_cdf = np.cumsum(areas / total).astype(np.float32)
        self.hidden_area = np.float32(total)
        self.wall_tris = np.nonzero(self.shape_id == self.wall_shape)[0]

    def _wall_point(self, uv):
        uv = np.asarray(uv, float)
        local = np.stack([2 * uv[..., 0] - 1, 2 * uv[..., 1] - 1,
                          np.zeros_like(uv[..., 0])], -1)
        return _world(self.wall, local)

    @property
    def triangles(self) -> int:
        return int(self.v0.shape[0])

    def to(self, device, dtype=torch.float32) -> dict:
        """The tracer's tensors on ``device``, floats in ``dtype``."""
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), dtype=dtype,
                                   device=device)

        out = dict(v0=t(self.v0), e1=t(self.e1), e2=t(self.e2),
                   ng=t(self.ng), refl=t(self.refl),
                   is_emitter=torch.as_tensor(self.is_emitter, device=device),
                   dtype=dtype, device=device)
        if self.laser is None:
            li = self.light_tris
            out.update(radiance=t(self.radiance), light_v0=t(self.v0[li]),
                       light_e1=t(self.e1[li]), light_e2=t(self.e2[li]),
                       light_ng=t(self.ng[li]), light_cdf=t(self.light_cdf),
                       light_area=float(self.light_area),
                       cam_R=t(self.cam_R), cam_o=t(self.cam_o),
                       tan_half=t(self.tan_half))
        else:
            hi = self.hidden_tris
            out.update(hidden_v0=t(self.v0[hi]), hidden_e1=t(self.e1[hi]),
                       hidden_e2=t(self.e2[hi]), hidden_ng=t(self.ng[hi]),
                       hidden_cdf=t(self.hidden_cdf),
                       hidden_area=float(self.hidden_area),
                       scan=t(self.scan), sensor_origin=t(self.sensor_origin),
                       laser_target=t(self.laser_target),
                       laser_origin=t(self.laser["origin"]),
                       irradiance=t(self.laser["irradiance"]),
                       wall_refl=t(self.refl[self.wall_tris[0]]),
                       wall_n=t(self.ng[self.wall_tris[0]]))
        return out
