"""Scene description: dict schema -> loaded :class:`Scene` with its
:class:`SceneData` on one device.

Counterpart of ``mitransient_tpu/scene/schema.py`` for the plugin set of
the transient Cornell box: ``rectangle`` and ``cube`` shapes, ``diffuse``
BSDFs (top level, nested or by ``ref``), ``area`` emitters, the
``perspective`` sensor with a ``transient_hdr_film`` and the
``transient_path`` integrator.  Every other plugin raises
``NotImplementedError`` naming the ROADMAP item that will port it.

The tables are built on the host with numpy exactly as the JAX loader
builds them, then each one is moved to ``device`` once.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..core.spectrum import Variant, variant
from ..core.transform import from_spec
from .scene import (
    BSDF_DIFFUSE,
    EM_AREA,
    BSDFParams,
    EmitterParams,
    GeomParams,
    SceneData,
    Triangles,
)
from .shapes import SHAPE_REGISTRY, Shape

RGB_TO_LUMA = np.array([0.212671, 0.715160, 0.072169])

# Above this triangle count the JAX package builds a BVH and runs its BVH
# kernels (ops/accel.py ACCEL_MIN_TRIS); the port has no BVH yet.
ACCEL_MIN_TRIS = 4096

# BSDF plugin types of the JAX package; all but "diffuse" are refused.
_BSDF_TYPES = (
    "diffuse", "conductor", "mirror", "roughconductor",
    "dielectric", "thindielectric", "null", "twosided",
    "plastic", "roughplastic", "bumpmap", "normalmap", "mask",
    "blendbsdf",
)
_ROADMAP_ITEM = {
    # scene entries the JAX package accepts and the port does not yet
    "bsdf": "11", "angulararea": "11", "projector": "11", "point": "11",
    "spot": "11", "thinlens": "11", "obj": "11", "ply": "11", "mesh": "11",
    "texture": "11", "homogeneous": "15", "heterogeneous": "15",
    "transient_nlos_path": "13", "nlos_capture_meter": "13",
    "irradiancemeter": "13", "transient_prbvolpath": "15", "path": "10",
    "phasor_hdr_film": "12",
}


def _not_ported(what: str, key: str) -> NotImplementedError:
    item = _ROADMAP_ITEM.get(key, "11")
    return NotImplementedError(
        f"{what} is not ported to mitransient_tpu_torch yet "
        f"(ROADMAP item {item})")


def parse_color(spec: Any, channels: int) -> np.ndarray:
    """Parse an rgb/float spectrum value to (C,) float32."""
    if isinstance(spec, dict):
        t = spec.get("type")
        if t in ("rgb", "srgb", "spectrum", "uniform", "d65"):
            v = np.asarray(spec.get("value", 1.0), np.float64)
        elif t in ("bitmap", "checkerboard"):
            raise _not_ported(f"texture {t!r}", "texture")
        else:
            raise ValueError(f"unsupported spectrum type {t!r}")
    else:
        v = np.asarray(spec, np.float64)
    if v.ndim == 0:
        v = np.full((3,), float(v))
    if channels == 1:
        if v.shape[-1] == 3:
            v = np.array([float(RGB_TO_LUMA @ v)])
        else:
            v = v[:1]
    elif channels == 3 and v.shape[-1] == 1:
        v = np.repeat(v, 3)
    return v.astype(np.float32)


# --------------------------------------------------------------------------
# Static configs
# --------------------------------------------------------------------------

class FilmConfig(NamedTuple):
    kind: str = "transient_hdr_film"
    width: int = 256
    height: int = 256
    temporal_bins: int = 2048  # default of transient_hdr_film.py:116
    start_opl: float = 0.0
    bin_width_opl: float = 0.003
    # opt-in sample validation: count negative / non-finite splat values
    warn_negative: bool = False
    warn_invalid: bool = False
    rfilter: str = "box"  # "box" | "gaussian" (steady image only)
    crop_offset_x: int = 0
    crop_offset_y: int = 0
    crop_width: int = 0  # 0 = full width
    crop_height: int = 0  # 0 = full height

    @property
    def data_width(self) -> int:
        return self.crop_width if self.crop_width > 0 else self.width

    @property
    def data_height(self) -> int:
        return self.crop_height if self.crop_height > 0 else self.height

    @property
    def is_cropped(self) -> bool:
        return (self.crop_width > 0 or self.crop_height > 0
                or self.crop_offset_x != 0 or self.crop_offset_y != 0)


class IntegratorConfig(NamedTuple):
    kind: str = "transient_path"
    max_depth: int = 6
    rr_depth: int = 5
    camera_unwarp: bool = False
    discard_direct_light: bool = False
    temporal_filter: str = ""
    gaussian_stddev: float = 2.0


class SensorConfig(NamedTuple):
    kind: str  # 'perspective'
    to_world: Any  # Transform4 (host)
    fov: float
    fov_axis: str
    near_clip: float
    spp: int
    seed: int
    film: FilmConfig


MAX_DEPTH_CAP = 32  # static bound substituted for max_depth = -1 (infinity)


def _parse_film(d: dict) -> FilmConfig:
    kind = d.get("type", "transient_hdr_film")
    if kind != "transient_hdr_film":
        raise _not_ported(f"film {kind!r}", kind)
    rf = d.get("rfilter", "box")
    fc = FilmConfig(
        kind=kind,
        width=int(d.get("width", 256)),
        height=int(d.get("height", 256)),
        temporal_bins=int(d.get("temporal_bins", 2048)),
        start_opl=float(d.get("start_opl", 0.0)),
        bin_width_opl=float(d.get("bin_width_opl", 0.003)),
        warn_negative=bool(d.get("warn_negative", False)),
        warn_invalid=bool(d.get("warn_invalid", False)),
        rfilter=str((rf or {}).get("type", "box") if isinstance(rf, dict)
                    else rf).lower(),
        crop_offset_x=int(d.get("crop_offset_x", 0)),
        crop_offset_y=int(d.get("crop_offset_y", 0)),
        crop_width=int(d.get("crop_width", 0)),
        crop_height=int(d.get("crop_height", 0)),
    )
    if fc.is_cropped:
        if (fc.crop_offset_x < 0 or fc.crop_offset_y < 0
                or fc.crop_offset_x + fc.data_width > fc.width
                or fc.crop_offset_y + fc.data_height > fc.height):
            raise ValueError("crop window exceeds the film bounds")
    return fc


def _parse_integrator(d: dict) -> IntegratorConfig:
    md = int(d.get("max_depth", 6))
    if md < 0:
        md = MAX_DEPTH_CAP
    return IntegratorConfig(
        kind=d.get("type", "transient_path"),
        max_depth=md,
        rr_depth=int(d.get("rr_depth", 5)),
        camera_unwarp=bool(d.get("camera_unwarp", False)),
        discard_direct_light=bool(d.get("discard_direct_light", False)),
        temporal_filter=d.get("temporal_filter", ""),
        gaussian_stddev=float(d.get("gaussian_stddev", 2.0)),
    )


class _BSDFEntry(NamedTuple):
    key: str
    kind: int
    two_sided: bool
    reflectance: np.ndarray
    eta_re: np.ndarray
    eta_im: np.ndarray
    alpha: float
    eta_ratio: float
    alpha_v: float = 0.0


def _parse_bsdf(key: str, d: dict, channels: int) -> _BSDFEntry:
    t = d.get("type", "diffuse")
    if t != "diffuse":
        raise _not_ported(f"bsdf {t!r} (key {key!r})", "bsdf")
    refl = parse_color(d.get("reflectance", 1.0), channels)
    zeros = np.zeros(channels, np.float32)
    return _BSDFEntry(key, BSDF_DIFFUSE, False, refl, zeros, zeros.copy(),
                      0.0, 1.5046)


class _EmitterEntry(NamedTuple):
    key: str
    kind: int
    radiance: np.ndarray
    to_world: Any
    fov: float
    cutoff_angle: float
    beam_width: float
    shape_index: int


class Scene:
    """Loaded scene: host-side object model + :class:`SceneData` on
    ``device``."""

    def __init__(self, desc: dict, device="cpu"):
        self.variant: Variant = variant()
        self.device = torch.device(device)
        C = self.variant.color_channels
        self.integrator = IntegratorConfig()
        self.sensors: list[SensorConfig] = []
        self.shapes: list[Shape] = []
        self._bsdfs: list[_BSDFEntry] = []
        self._bsdf_index: dict[str, int] = {}
        self._emitters: list[_EmitterEntry] = []
        sensor_dicts: list[dict] = []

        def add_bsdf(key: str, d: dict) -> int:
            if d.get("type") == "ref":
                ref = d["id"]
                if ref not in self._bsdf_index:
                    raise KeyError(f"bsdf ref {ref!r} not found")
                return self._bsdf_index[ref]
            idx = len(self._bsdfs)
            self._bsdfs.append(_parse_bsdf(key, d, C))
            self._bsdf_index[key] = idx
            return idx

        def register_nested_ids(val):
            # Mitsuba allows an ``id`` on any nesting level
            for cv in val.values():
                if isinstance(cv, dict) and cv.get("type") in _BSDF_TYPES:
                    nid = cv.get("id")
                    if nid and nid not in self._bsdf_index:
                        add_bsdf(nid, cv)
                    register_nested_ids(cv)

        items = [(k, v) for k, v in desc.items() if k != "type"]
        # Pass 1: named top-level BSDFs first so refs resolve.
        for key, val in items:
            if isinstance(val, dict) and val.get("type") in _BSDF_TYPES:
                add_bsdf(key, val)
                register_nested_ids(val)

        for key, val in items:
            if not isinstance(val, dict):
                continue
            t = val.get("type")
            if t == "scene" or t in _BSDF_TYPES:
                continue
            if t in SHAPE_REGISTRY:
                shape_idx = len(self.shapes)
                props = dict(val)
                props["id"] = key
                shape = SHAPE_REGISTRY[t](props)
                bsdf_idx = None
                for ck, cv in val.items():
                    if not isinstance(cv, dict):
                        continue
                    ct = cv.get("type")
                    if ct == "ref" or ct in _BSDF_TYPES:
                        bsdf_idx = add_bsdf(f"{key}.{ck}", cv)
                    elif ct == "area":
                        em_idx = len(self._emitters)
                        cutoff = float(cv.get("cutoff_angle", 20.0))
                        self._emitters.append(_EmitterEntry(
                            key=f"{key}.{ck}",
                            kind=EM_AREA,
                            radiance=parse_color(cv.get("radiance", 1.0), C),
                            to_world=from_spec(cv.get("to_world")),
                            fov=0.0,
                            cutoff_angle=cutoff,
                            beam_width=float(cv.get("beam_width",
                                                    cutoff * 0.75)),
                            shape_index=shape_idx,
                        ))
                        shape.emitter_key = em_idx
                    elif ct in _ROADMAP_ITEM:
                        raise _not_ported(f"{ct!r} (in {key!r})", ct)
                    elif ct == "perspective":
                        sensor_dicts.append(cv)
                if bsdf_idx is None:
                    bsdf_idx = add_bsdf(f"{key}.__default", {"type": "diffuse"})
                shape.bsdf_key = bsdf_idx
                self.shapes.append(shape)
            elif t in _ROADMAP_ITEM:
                raise _not_ported(f"scene entry {key!r} of type {t!r}", t)
            elif t == "perspective":
                sensor_dicts.append(val)
            elif t == "transient_path":
                self.integrator = _parse_integrator(val)
            else:
                raise ValueError(f"unknown scene entry {key!r} of type {t!r}")

        for sdict in sensor_dicts:
            sampler = sdict.get("sampler", {})
            self.sensors.append(SensorConfig(
                kind="perspective",
                to_world=from_spec(sdict.get("to_world")),
                fov=float(sdict.get("fov", 45.0)),
                fov_axis=sdict.get("fov_axis", "x"),
                near_clip=float(sdict.get("near_clip", 1e-2)),
                spp=int(sampler.get("sample_count", 4)),
                seed=int(sampler.get("seed", 0)),
                film=_parse_film(sdict.get("film", {})),
            ))
        if not self.sensors:
            raise ValueError("scene has no sensor")
        self.data = self._compile()

    def _compile(self) -> SceneData:
        C = self.variant.color_channels
        tris = [shape.triangles() for shape in self.shapes]
        counts = [td.count for td in tris]
        count = sum(counts)
        if count == 0:
            raise ValueError("scene has no geometry")
        if count > ACCEL_MIN_TRIS:
            raise NotImplementedError(
                f"{count} triangles: scenes above {ACCEL_MIN_TRIS} triangles "
                "need the BVH kernels, not ported yet (ROADMAP item 17)")
        starts = np.cumsum([0] + counts[:-1])
        self.shape_tri_ranges = list(zip(starts.tolist(), counts))

        def cat(field):
            return np.concatenate([getattr(td, field) for td in tris])

        def per_tri(values):
            return np.concatenate([np.full(m, v, np.int32)
                                   for m, v in zip(counts, values)])

        v0, v1, v2 = cat("v0"), cat("v1"), cat("v2")
        e1 = v1 - v0
        e2 = v2 - v0
        cr = np.cross(e1, e2)
        area = 0.5 * np.linalg.norm(cr, axis=-1)
        ng = cr / np.maximum(np.linalg.norm(cr, axis=-1, keepdims=True), 1e-20)
        uv0, uv1, uv2 = cat("uv0"), cat("uv1"), cat("uv2")
        shape_id = per_tri(range(len(self.shapes)))
        em_of_shape = [-1 if s.emitter_key is None else s.emitter_key
                       for s in self.shapes]
        host = {
            "tri": Triangles(
                v0=v0, e1=e1, e2=e2, ng=ng.astype(np.float32),
                uv0=uv0, uv_e1=uv1 - uv0, uv_e2=uv2 - uv0,
                area=area.astype(np.float32),
                shape_id=shape_id,
                bsdf_id=per_tri([s.bsdf_key for s in self.shapes]),
                emitter_id=per_tri(em_of_shape),
                medium_id=per_tri([-1] * len(self.shapes)),
            ),
            "bsdf": BSDFParams(
                kind=np.array([b.kind for b in self._bsdfs], np.int32),
                two_sided=np.array([b.two_sided for b in self._bsdfs]),
                reflectance=np.stack([b.reflectance for b in self._bsdfs]),
                eta_re=np.stack([b.eta_re for b in self._bsdfs]),
                eta_im=np.stack([b.eta_im for b in self._bsdfs]),
                alpha=np.array([b.alpha for b in self._bsdfs], np.float32),
                eta_ratio=np.array([b.eta_ratio for b in self._bsdfs],
                                   np.float32),
                alpha_v=np.array([b.alpha_v for b in self._bsdfs], np.float32),
            ),
            "emitter": self._emitter_table(C, v0, e1, e2, ng, area, shape_id),
        }
        pivot = np.zeros((max(len(self.shapes), 1), 3), np.float32)
        for s_i, shp in enumerate(self.shapes):
            pivot[s_i] = shp.to_world.translation
        host["geom"] = GeomParams(translate=np.zeros_like(pivot),
                                  rotate=np.zeros_like(pivot), pivot=pivot)

        def dev(table):
            return type(table)(*(torch.from_numpy(np.ascontiguousarray(a))
                                 .to(self.device) for a in table))

        return SceneData(**{k: dev(v) for k, v in host.items()})

    def _emitter_table(self, C, v0, e1, e2, ng, area, shape_id):
        E = len(self._emitters)
        em_pos = np.zeros((E, 3), np.float32)
        em_dir = np.zeros((E, 3), np.float32)
        em_fs = np.zeros((E, 3), np.float32)
        em_ft = np.zeros((E, 3), np.float32)
        em_thf = np.zeros(E, np.float32)
        em_cb = np.zeros(E, np.float32)
        em_cc = np.zeros(E, np.float32)
        em_area = np.zeros(E, np.float32)
        em_tri_start = np.zeros(E, np.int32)
        em_tri_count = np.zeros(E, np.int32)
        idx_l: list[np.ndarray] = []
        cdf_l: list[np.ndarray] = []
        k = 0
        for i, e in enumerate(self._emitters):
            R = e.to_world.m[:3, :3]
            em_pos[i] = e.to_world.translation
            em_dir[i] = R @ np.array([0, 0, 1.0])
            em_fs[i] = R @ np.array([1.0, 0, 0])
            em_ft[i] = R @ np.array([0, 1.0, 0])
            em_thf[i] = np.tan(np.deg2rad(e.fov) / 2.0)
            em_cb[i] = np.cos(np.deg2rad(e.beam_width))
            em_cc[i] = np.cos(np.deg2rad(e.cutoff_angle))
            start, cnt = self.shape_tri_ranges[e.shape_index]
            areas = area[start:start + cnt]
            total = float(np.sum(areas))
            em_area[i] = total
            em_tri_start[i] = k
            em_tri_count[i] = cnt
            idx_l.append(np.arange(start, start + cnt, dtype=np.int32))
            cdf_l.append(np.cumsum(areas / max(total, 1e-30)).astype(np.float32))
            k += cnt
        em_tri_idx = np.concatenate(idx_l) if idx_l else np.zeros(1, np.int32)
        em_tri_cdf = np.concatenate(cdf_l) if cdf_l else np.ones(1, np.float32)
        return EmitterParams(
            kind=np.array([e.kind for e in self._emitters], np.int32).reshape(E),
            radiance=(np.stack([e.radiance for e in self._emitters]) if E
                      else np.zeros((0, C), np.float32)).astype(np.float32),
            position=em_pos, direction=em_dir, frame_s=em_fs, frame_t=em_ft,
            tan_half_fov=em_thf, cos_beam=em_cb, cos_cutoff=em_cc,
            area=em_area, tri_start=em_tri_start, tri_count=em_tri_count,
            em_tri_idx=em_tri_idx, em_tri_cdf=em_tri_cdf,
            em_tri_v0=v0[em_tri_idx].astype(np.float32),
            em_tri_e1=e1[em_tri_idx].astype(np.float32),
            em_tri_e2=e2[em_tri_idx].astype(np.float32),
            em_tri_ng=ng[em_tri_idx].astype(np.float32),
            em_tri_shape=shape_id[em_tri_idx].astype(np.int32),
        )


def load_dict(desc: dict, device="cpu") -> Scene:
    """Entry point mirroring ``mi.load_dict``; ``scene.data`` lives on
    ``device`` and :func:`render` runs there."""
    if desc.get("type") != "scene":
        raise ValueError("top-level dict must have type='scene'")
    return Scene(desc, device=device)
