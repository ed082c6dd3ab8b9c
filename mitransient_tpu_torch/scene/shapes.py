"""Host-side shape plugins that compile to world-space triangle soup.

A copy of the shape plugins of ``mitransient_tpu/scene/shapes.py`` (numpy
only): ``rectangle``, ``cube``, the ``obj`` / ``ply`` file meshes and the
in-memory ``mesh``.

Conventions match Mitsuba:
* ``rectangle``: XY square [-1,1]^2 at z=0, normal +z, uv(0,0) at (-1,-1).
* ``cube``: [-1,1]^3 with outward normals, per-face uv in [0,1]^2.
* ``obj`` / ``ply``: triangle meshes loaded from file.
"""
from __future__ import annotations

import os
import struct
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
        self.medium_key = None  # the interior medium's row, None = vacuum

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

    def position_from_uv(self, uv: np.ndarray) -> np.ndarray:
        """Exact uv -> world point map (the NLOS sensor's scan grid),
        float64."""
        uv = np.asarray(uv, np.float64)
        local = np.stack(
            [2.0 * uv[..., 0] - 1.0, 2.0 * uv[..., 1] - 1.0,
             np.zeros_like(uv[..., 0])], axis=-1)
        return self.to_world.apply_point(local)


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


class Mesh(Shape):
    """``obj`` / ``ply`` file mesh.  A UV-free OBJ above 1 MiB takes the
    native parser (``native.load_obj_native``); :func:`load_obj` is the
    semantic reference and handles uv-indexed faces."""

    shape_type = "mesh"

    def __init__(self, props: dict):
        super().__init__(props)
        self.filename = props["filename"]
        if not os.path.isabs(self.filename):
            base = props.get("_base_dir", ".")
            cand = os.path.join(base, self.filename)
            self.filename = cand if os.path.exists(cand) else self.filename
        self.face_normals = props.get("face_normals", False)

    def triangles(self) -> TriangleData:
        ext = os.path.splitext(self.filename)[1].lower()
        if ext == ".obj":
            verts = faces = uvs = None
            try:
                with open(self.filename, "rb") as fh:
                    head = fh.read(1 << 16)
                has_uv = b"\nvt " in head or head.startswith(b"vt ")
                big = os.path.getsize(self.filename) > (1 << 20)
            except OSError:
                has_uv, big = True, False
            if big and not has_uv:
                from ..native import load_obj_native

                res = load_obj_native(self.filename)
                if res is not None:
                    verts, faces = res
            if verts is None:
                verts, faces, uvs = load_obj(self.filename)
        elif ext == ".ply":
            verts, faces, uvs = load_ply(self.filename)
        else:
            raise ValueError(f"unsupported mesh format {ext}")
        if uvs is None:
            uvs = np.zeros((verts.shape[0], 2), np.float64)
        return self._bake(verts, faces, uvs)


def load_obj(path: str):
    """Minimal OBJ loader (v / vt / f with triangulation by fanning)."""
    verts, uvs_list, faces, face_uvs = [], [], [], []
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vt":
                uvs_list.append([float(x) for x in parts[1:3]])
            elif parts[0] == "f":
                idx = []
                for tok in parts[1:]:
                    comp = tok.split("/")
                    vi = int(comp[0])
                    ti = int(comp[1]) if len(comp) > 1 and comp[1] else 0
                    idx.append((vi, ti))
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0][0], idx[k][0], idx[k + 1][0]])
                    face_uvs.append([idx[0][1], idx[k][1], idx[k + 1][1]])
    verts = np.asarray(verts, np.float64)
    nv = verts.shape[0]
    faces = np.asarray(faces, np.int64)
    faces = np.where(faces > 0, faces - 1, faces + nv)  # negative indices wrap
    uvs = None
    if uvs_list and np.any(np.asarray(face_uvs) != 0):
        # re-index uvs per vertex (last write wins; fine for simple meshes)
        uv_arr = np.asarray(uvs_list, np.float64)
        uvs = np.zeros((nv, 2), np.float64)
        fu = np.asarray(face_uvs, np.int64)
        fu = np.where(fu > 0, fu - 1, fu + uv_arr.shape[0])
        for fi in range(faces.shape[0]):
            for c in range(3):
                if 0 <= fu[fi, c] < uv_arr.shape[0]:
                    uvs[faces[fi, c]] = uv_arr[fu[fi, c]]
    return verts, faces.astype(np.int32), uvs


_PLY_TYPES = {
    "float": ("f", 4), "float32": ("f", 4), "double": ("d", 8),
    "uchar": ("B", 1), "uint8": ("B", 1), "char": ("b", 1),
    "short": ("h", 2), "ushort": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4), "uint": ("I", 4), "uint32": ("I", 4),
}


def load_ply(path: str):
    """Minimal PLY loader: ascii + binary_little_endian, vertex xyz (+uv)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(h.split()[1] for h in header if h.startswith("format"))
        n_vert = n_face = 0
        vert_props = []
        cur = None
        for h in header:
            p = h.split()
            if not p:
                continue
            if p[0] == "element":
                cur = p[1]
                if p[1] == "vertex":
                    n_vert = int(p[2])
                elif p[1] == "face":
                    n_face = int(p[2])
            elif p[0] == "property" and cur == "vertex":
                vert_props.append((p[-1], p[1]))
        names = [n for n, _ in vert_props]
        faces = []
        if fmt == "ascii":
            verts_raw = np.array(
                [f.readline().split()[: len(names)] for _ in range(n_vert)],
                np.float64,
            )
            for _ in range(n_face):
                toks = f.readline().split()
                cnt = int(toks[0])
                idx = [int(x) for x in toks[1: 1 + cnt]]
                for k in range(1, cnt - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
        else:
            codes = "".join(_PLY_TYPES[t][0] for _, t in vert_props)
            sz = struct.calcsize("<" + codes)
            buf = f.read(sz * n_vert)
            verts_raw = np.array(list(struct.iter_unpack("<" + codes, buf)),
                                 np.float64)
            for _ in range(n_face):
                (cnt,) = struct.unpack("<B", f.read(1))
                idx = struct.unpack(f"<{cnt}i", f.read(4 * cnt))
                for k in range(1, cnt - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
        faces = np.asarray(faces, np.int32)
        xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
        verts = verts_raw[:, [xi, yi, zi]]
        uvs = None
        for uname, vname in (("u", "v"), ("s", "t"), ("texture_u", "texture_v")):
            if uname in names and vname in names:
                uvs = verts_raw[:, [names.index(uname), names.index(vname)]]
                break
        return verts, faces, uvs


class RawMesh(Shape):
    """In-memory triangle mesh from ``vertices`` (V,3) / ``faces`` (F,3)
    arrays, with optional per-vertex ``uvs`` (V,2)."""

    shape_type = "mesh"

    def __init__(self, props: dict):
        super().__init__(props)
        self.vertices = np.asarray(props["vertices"], np.float64)
        self.faces = np.asarray(props["faces"], np.int32)
        uv = props.get("uvs")
        self.uvs = None if uv is None else np.asarray(uv, np.float64)

    def triangles(self) -> TriangleData:
        uvs = self.uvs
        if uvs is None:
            uvs = np.zeros((self.vertices.shape[0], 2), np.float64)
        return self._bake(self.vertices, self.faces, uvs)


SHAPE_REGISTRY = {
    "rectangle": Rectangle,
    "cube": Cube,
    "obj": Mesh,
    "ply": Mesh,
    "mesh": RawMesh,
}
