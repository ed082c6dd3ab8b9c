"""Scene description: dict schema -> loaded :class:`Scene` with its
:class:`SceneData` on one device.

Counterpart of ``mitransient_tpu/scene/schema.py``: ``rectangle``,
``cube``, ``obj``, ``ply`` and in-memory ``mesh`` shapes; every BSDF of
the JAX package (``diffuse``, ``conductor`` / ``mirror``,
``roughconductor``, ``plastic`` / ``roughplastic``, ``dielectric`` /
``thindielectric``, ``null``; top level, nested or by ``ref``), with the
``twosided``, ``bumpmap``, ``normalmap``, ``mask`` and ``blendbsdf``
wrappers and ``bitmap`` / ``checkerboard`` textures; ``area`` and
``angulararea`` emitters and the delta emitters ``projector``, ``point``
and ``spot`` (loaded as a point); the ``perspective`` sensor and the
``nlos_capture_meter`` nested in a shape, with a ``transient_hdr_film`` or
a ``phasor_hdr_film``; ``homogeneous`` and ``heterogeneous`` media nested
in a shape (its interior), the density of a heterogeneous one inline or
from a Mitsuba ``.vol`` file; and the ``transient_path``, ``path``,
``transient_nlos_path`` and ``transient_prbvolpath`` integrators.  What
the JAX loader refuses (other sensor types such as ``thinlens`` and
``irradiancemeter``, unknown scene entries) raises its ``ValueError``.

The tables are built on the host with numpy exactly as the JAX loader
builds them, then each one is moved to ``device`` once.  Above
``ACCEL_MIN_TRIS`` triangles the loader also builds the chunked
acceleration structure (``ops/accel.py``).  The device is the card unless
the caller asks for the CPU.

:func:`traverse` gives the ``mi.traverse``-style string-path view of the
scene's parameters (:class:`ParamMap`), over the paths the loader
registers as the JAX loader does (``Scene._param_paths``).

Bitmaps are decoded with ``imageio``.  A missing file leaves the BSDF
untextured, as in the JAX package; an existing file without ``imageio``
to decode it raises ``ImportError`` (the JAX package would render it
untextured).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import logging
import os

import numpy as np
import torch

from .. import trace
from ..core.spectrum import Variant, variant
from ..core.transform import Transform4, from_spec
from ..ops.accel import ACCEL_MIN_TRIS, build_accel
from ..ops.intersect import tri_table
from .scene import (
    BSDF_CONDUCTOR,
    BSDF_DIELECTRIC,
    BSDF_DIFFUSE,
    BSDF_NULL,
    BSDF_ROUGH_CONDUCTOR,
    BSDF_ROUGH_PLASTIC,
    EM_ANGULAR_AREA,
    EM_AREA,
    EM_POINT,
    EM_PROJECTOR,
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
from .shapes import SHAPE_REGISTRY, Shape

RGB_TO_LUMA = np.array([0.212671, 0.715160, 0.072169])

_BSDF_TYPES = (
    "diffuse", "conductor", "mirror", "roughconductor",
    "dielectric", "thindielectric", "null", "twosided",
    "plastic", "roughplastic", "bumpmap", "normalmap", "mask",
    "blendbsdf",
)
_MEDIA = ("homogeneous", "heterogeneous")
_INTEGRATORS = ("transient_path", "path", "transient_nlos_path",
                "transient_prbvolpath")
_TEXTURES = ("bitmap", "checkerboard")
_log = logging.getLogger("mitransient_tpu_torch")


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r}: no CUDA device is available "
            "(torch.cuda.is_available() is false); pass device='cpu' to "
            "run the plain PyTorch versions on the CPU")
    return dev


# --------------------------------------------------------------------------
# Textures: every texture of a scene is packed into one padded f32 atlas
# (BSDFParams.textures) so that the shading-time lookup is a flat bilinear
# gather; images are capped at TEXTURE_MAX_RES a side by box downsampling
# --------------------------------------------------------------------------

TEXTURE_MAX_RES = 512
_IMAGE_CACHE: dict = {}  # (path, mtime) -> decoded ndarray as stored
_IMAGE_CACHE_MAX = 64


def _read_image(fn: str):
    """Decode an image file once per process; None where the file cannot
    be read or decoded.  Raises ImportError where ``imageio`` is missing."""
    try:
        key = (fn, os.path.getmtime(fn))
    except OSError:
        return None
    if key in _IMAGE_CACHE:
        return _IMAGE_CACHE[key]
    try:
        import imageio.v3 as iio
    except ImportError as e:
        raise ImportError(f"decoding the bitmap {fn!r} needs imageio, which "
                          "is not installed") from e
    try:
        img = np.asarray(iio.imread(fn))
    except Exception:
        return None
    if len(_IMAGE_CACHE) >= _IMAGE_CACHE_MAX:
        _IMAGE_CACHE.clear()
    _IMAGE_CACHE[key] = img
    return img


def _texture_mean(spec: dict, base_dir: str = ".") -> np.ndarray:
    """The mean colour of a texture, the table's reflectance entry."""
    fn = spec.get("filename")
    if fn and not os.path.isabs(fn):
        fn = os.path.join(base_dir, fn)
    if fn and os.path.exists(fn):
        img = _read_image(fn)
        if img is not None:
            was_int = img.dtype.kind in "ui"
            img = np.asarray(img, np.float64)
            if was_int or img.max() > 1.5:
                img = img / 255.0
            if img.ndim == 2:
                img = img[..., None]
            return img.reshape(-1, img.shape[-1]).mean(axis=0)[:3]
    try:
        a = parse_color(spec.get("color0", 0.4), 3)
        b = parse_color(spec.get("color1", 0.2), 3)
        return 0.5 * (np.asarray(a, np.float64) + np.asarray(b, np.float64))
    except Exception:
        return np.full((3,), 0.5)


def _srgb_to_linear(c: np.ndarray) -> np.ndarray:
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


_SRGB_LUT8 = _srgb_to_linear(np.arange(256, dtype=np.float64) / 255.0)


def _box_downsample(img: np.ndarray, cap: int) -> np.ndarray:
    k = int(np.ceil(max(img.shape[0], img.shape[1]) / cap))
    if k <= 1:
        return img
    h2 = (img.shape[0] // k) * k
    w2 = (img.shape[1] // k) * k
    img = img[:h2, :w2]
    return img.reshape(h2 // k, k, w2 // k, k, img.shape[-1]).mean(axis=(1, 3))


def _to_channels(img: np.ndarray, channels: int) -> np.ndarray:
    if img.shape[-1] >= 3 and channels == 1:
        return (img[..., :3] @ RGB_TO_LUMA)[..., None]
    if img.shape[-1] == 1 and channels == 3:
        return np.repeat(img, 3, axis=-1)
    return img[..., :channels]


def _uv_transform(spec) -> tuple[float, float, float, float]:
    """(su, sv, ou, ov) of a ``to_uv`` transform (scale and offset only)."""
    if spec is None:
        return (1.0, 1.0, 0.0, 0.0)
    t = spec if hasattr(spec, "m") else from_spec(spec)
    m = np.asarray(t.m, np.float64)
    return (float(m[0, 0]), float(m[1, 1]), float(m[0, 3]), float(m[1, 3]))


def _load_texture(spec: dict, base_dir: str, channels: int, cache: dict):
    """Texture spec -> (img (h, w, C) f32 linear, (su, sv, ou, ov)), or
    None for a bitmap without a readable file."""
    t = spec.get("type")
    uv_t = _uv_transform(spec.get("to_uv"))
    if t == "checkerboard":
        c0 = parse_color(spec.get("color0", 0.4), channels)
        c1 = parse_color(spec.get("color1", 0.2), channels)
        key = ("checker", tuple(c0), tuple(c1), channels)
        if key not in cache:
            res = 64
            u = (np.arange(res) + 0.5) / res
            mask = (u[None, :] > 0.5) ^ (u[:, None] > 0.5)  # (v, u)
            cache[key] = np.where(mask[..., None], c1, c0).astype(np.float32)
        return cache[key], uv_t
    if t == "bitmap":
        fn = spec.get("filename")
        if not fn:
            return None
        if not os.path.isabs(fn):
            fn = os.path.join(base_dir, fn)
        raw = spec.get("raw", False)
        key = ("bitmap", fn, bool(raw), channels)
        if key not in cache:
            if not os.path.exists(fn):
                return None
            img = _read_image(fn)
            if img is None:
                return None
            if img.dtype == np.uint8:
                img = (_SRGB_LUT8[img] if not raw
                       else img.astype(np.float64) / 255.0)
            else:
                img = img.astype(np.float64)
                if img.max() > 1.5:
                    img = img / 255.0
                if not raw:
                    img = _srgb_to_linear(img)
            if img.ndim == 2:
                img = img[..., None]
            img = _box_downsample(img, TEXTURE_MAX_RES)
            cache[key] = _to_channels(img, channels).astype(np.float32)
        return cache[key], uv_t
    return None


def _load_bump_texture(spec: dict, base_dir: str, cache: dict, kind: int):
    """A bumpmap (``kind`` 1) or normalmap (2) wrapper's texture -> ((h, w,
    3) f32, uv transform), or None.  A bump map packs (height, dh/dx,
    dh/dy), its central-difference gradients in texel units; a normal map
    the tangent-space normal 2 rgb - 1 of its raw data."""
    if kind == 2:
        spec = dict(spec)
        spec.setdefault("raw", True)  # normals are data, never sRGB
    key = ("bump", kind, spec.get("filename"), spec.get("type"),
           str(spec.get("to_uv")))
    if key in cache:
        return cache[key]
    loaded = _load_texture(spec, base_dir, 3 if kind == 2 else 1, cache)
    if loaded is None:
        return None
    img, uv_t = loaded
    if kind == 2:
        out = (2.0 * img[..., :3] - 1.0).astype(np.float32)
    else:
        hgt = img[..., 0]
        # central differences, one-sided at the border
        gx = np.empty_like(hgt)
        gy = np.empty_like(hgt)
        gx[:, 1:-1] = 0.5 * (hgt[:, 2:] - hgt[:, :-2])
        gx[:, :1] = hgt[:, 1:2] - hgt[:, :1]
        gx[:, -1:] = hgt[:, -1:] - hgt[:, -2:-1]
        gy[1:-1, :] = 0.5 * (hgt[2:, :] - hgt[:-2, :])
        gy[:1, :] = hgt[1:2, :] - hgt[:1, :]
        gy[-1:, :] = hgt[-1:, :] - hgt[-2:-1, :]
        out = np.stack([hgt, gx, gy], axis=-1).astype(np.float32)
    cache[key] = (out, uv_t)
    return cache[key]


# --------------------------------------------------------------------------
# Media: density grids
# --------------------------------------------------------------------------

def _parse_density(dens, base_dir: str):
    """A heterogeneous medium's density: an inline (GZ, GY, GX) array, or a
    ``gridvolume`` dict holding it (``data``) or naming a Mitsuba ``.vol``
    file (``filename``), with an optional ``to_world``.  -> (grid (GZ, GY,
    GX) f32, world -> local affine (3, 4) f32 into [0, 1]^3)."""
    to_world = None
    if isinstance(dens, dict):
        to_world = dens.get("to_world")
        if dens.get("type") == "gridvolume" or "filename" in dens:
            fn = dens["filename"]
            if not os.path.isabs(fn):
                fn = os.path.join(base_dir, fn)
            grid = read_vol(fn)
        else:
            grid = np.asarray(dens.get("data", dens.get("value")),
                              np.float32)
    else:
        grid = np.asarray(dens, np.float32)
    if grid.ndim == 4:  # (Z, Y, X, 1) channel grids
        grid = grid[..., 0]
    if grid.ndim != 3:
        raise ValueError("density grid must be 3-D (Z, Y, X)")
    inv = np.linalg.inv(np.asarray(from_spec(to_world).m, np.float64))
    return grid.astype(np.float32), inv[:3, :].astype(np.float32)


def read_vol(path: str) -> np.ndarray:
    """A Mitsuba binary grid volume (``.vol``, float32 encoding) -> its
    first channel, (Z, Y, X) f32."""
    import struct

    with open(path, "rb") as f:
        head = f.read(48)
        if head[:3] != b"VOL":
            raise ValueError("not a Mitsuba .vol file")
        enc, gx, gy, gz, ch = struct.unpack_from("<iiiii", head, 4)
        if enc != 1:
            raise NotImplementedError("only float32 .vol grids supported")
        data = np.fromfile(f, np.float32, gx * gy * gz * ch)
    return data.reshape(gz, gy, gx, ch)[..., 0]


def _parse_medium(cv: dict, channels: int, base_dir: str) -> dict:
    """A ``homogeneous`` or ``heterogeneous`` medium as the JAX loader
    reads it: ``sigma_t`` (the ``scale`` where ``sigma_t`` is itself the
    grid), ``albedo``, the HG ``g`` and, for a heterogeneous medium, its
    density grid (``density``, else ``sigma_t``) and affine."""
    sig = cv.get("sigma_t")
    med = {"sigma_t": (float(cv.get("scale", 1.0)) if isinstance(sig, dict)
                       else float(cv.get("sigma_t", 1.0))),
           "albedo": parse_color(cv.get("albedo", 0.75), channels),
           "g": float(cv.get("phase", {}).get("g", 0.0)),
           "grid": None}
    if cv.get("type") == "heterogeneous":
        med["grid"], med["grid_w2l"] = _parse_density(
            cv.get("density", sig), base_dir)
    return med


def _medium_table(media: list, channels: int) -> MediumParams:
    """The host medium table (at least one row, so lookups are well
    formed).  Grids are edge-padded to one common shape (each medium's
    affine rescaled to its own extent); media without a grid get a
    constant-1 grid, a (1, 1, 1) one where no medium has a grid."""
    n_med = max(len(media), 1)
    sigma_t = np.array([m["sigma_t"] for m in media] or [0.0], np.float32)
    grids = [m["grid"] for m in media if m["grid"] is not None]
    w2l = np.zeros((n_med, 3, 4), np.float32)
    w2l[:, :, :3] = np.eye(3)
    if not grids:
        packed = np.ones((n_med, 1, 1, 1), np.float32)
        maj = sigma_t.copy()
    else:
        gz, gy, gx = (max(g.shape[a] for g in grids) for a in range(3))
        packed = np.ones((n_med, gz, gy, gx), np.float32)
        maj = np.zeros((n_med,), np.float32)
        for i, m in enumerate(media):
            g = m["grid"]
            if g is None:
                maj[i] = m["sigma_t"]
                continue
            z, y, x = g.shape
            packed[i, :z, :y, :x] = g
            packed[i, z:] = packed[i, z - 1:z]
            packed[i, :, y:] = packed[i, :, y - 1:y]
            packed[i, :, :, x:] = packed[i, :, :, x - 1:x]
            sz = np.array([(x - 1) / max(gx - 1, 1), (y - 1) / max(gy - 1, 1),
                           (z - 1) / max(gz - 1, 1)])
            w2l[i] = (np.asarray(m["grid_w2l"], np.float64)
                      * sz[:, None]).astype(np.float32)
            maj[i] = m["sigma_t"] * float(g.max())
    return MediumParams(
        sigma_t=sigma_t,
        albedo=np.stack([m["albedo"] for m in media]
                        or [np.zeros(channels, np.float32)]),
        g=np.array([m["g"] for m in media] or [0.0], np.float32),
        grid=packed, grid_w2l=w2l, majorant=maj)


def parse_color(spec: Any, channels: int, base_dir: str = ".") -> np.ndarray:
    """Parse an rgb/float spectrum value to (C,) float32; a texture gives
    its mean colour (the atlas holds the texture itself)."""
    if isinstance(spec, dict):
        t = spec.get("type")
        if t in ("rgb", "srgb", "spectrum", "uniform", "d65"):
            v = np.asarray(spec.get("value", 1.0), np.float64)
        elif t in _TEXTURES:
            v = _texture_mean(spec, base_dir)
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
    kind: str = "transient_hdr_film"  # or "phasor_hdr_film"
    width: int = 256
    height: int = 256
    temporal_bins: int = 2048  # default of transient_hdr_film.py:116
    start_opl: float = 0.0
    bin_width_opl: float = 0.003
    # exhaustive NLOS capture: a (laser_scan_height x laser_scan_width)
    # illumination grid per scan pixel
    exhaustive_scan: bool = False
    laser_scan_width: int = 0
    laser_scan_height: int = 0
    # phasor_hdr_film: the tracked band's mean and width in OPL units
    wl_mean: float = 100.0
    wl_sigma: float = 1000.0
    # opt-in sample validation: count negative / non-finite splat values
    warn_negative: bool = False
    warn_invalid: bool = False
    rfilter: str = "box"  # "box" | "gaussian" (steady image only)
    rfilter_stddev: float = 0.5
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
    # transient_nlos_path (the reference's transientnlospath.py:201-249)
    capture_type: str = "single"  # single | confocal | exhaustive
    filter_depth: int = -1
    filter_bounces: int = -1
    discard_direct_paths: bool = False
    nlos_laser_sampling: bool = False
    nlos_hidden_geometry_sampling: bool = False
    nlos_hidden_geometry_sampling_do_rroulette: bool = False
    nlos_hidden_geometry_sampling_includes_relay_wall: bool = True
    account_first_and_last_bounces: bool = True
    # the exhaustive capture's illumination grid
    force_equal_illumination_scanning: bool = True
    illumination_scan_fov: float = 20.0


class SensorConfig(NamedTuple):
    kind: str  # 'perspective' | 'nlos_capture_meter'
    to_world: Any  # Transform4 (host)
    fov: float
    fov_axis: str
    near_clip: float
    spp: int
    seed: int
    film: FilmConfig
    # nlos_capture_meter: the sensor's origin, the shape (relay wall) it is
    # nested in, and in confocal mode the scan grid behind a 1x1 film
    sensor_origin: Any = None  # (3,) float64
    shape_index: int = -1
    original_film_width: int | None = None
    original_film_height: int | None = None

    @property
    def is_confocal(self) -> bool:
        return (self.original_film_width is not None
                and self.original_film_height is not None)

    @property
    def scan_size(self):
        """(width, height) of the scan grid: the film's, or in confocal
        mode the original film's."""
        if self.is_confocal:
            return (self.original_film_width, self.original_film_height)
        return (self.film.width, self.film.height)


MAX_DEPTH_CAP = 32  # static bound substituted for max_depth = -1 (infinity)


def _parse_film(d: dict) -> FilmConfig:
    # as in the JAX loader, every kind but the phasor film is the
    # transient film
    kind = d.get("type", "transient_hdr_film")
    rf = d.get("rfilter", "box")
    fc = FilmConfig(
        kind=kind,
        width=int(d.get("width", 256)),
        height=int(d.get("height", 256)),
        temporal_bins=int(d.get("temporal_bins", 4096 if kind == "phasor_hdr_film"
                                else 2048)),
        start_opl=float(d.get("start_opl", 0.0)),
        bin_width_opl=float(d.get("bin_width_opl", 0.003)),
        exhaustive_scan=bool(d.get("exhaustive_scan", False)),
        laser_scan_width=int(d.get("laser_scan_width", 0)),
        laser_scan_height=int(d.get("laser_scan_height", 0)),
        wl_mean=float(d.get("wl_mean", 100.0)),
        wl_sigma=float(d.get("wl_sigma", 1000.0)),
        warn_negative=bool(d.get("warn_negative", False)),
        warn_invalid=bool(d.get("warn_invalid", False)),
        rfilter=str((rf or {}).get("type", "box") if isinstance(rf, dict)
                    else rf).lower(),
        rfilter_stddev=float((rf or {}).get("stddev", 0.5)
                             if isinstance(rf, dict) else 0.5),
        crop_offset_x=int(d.get("crop_offset_x", 0)),
        crop_offset_y=int(d.get("crop_offset_y", 0)),
        crop_width=int(d.get("crop_width", 0)),
        crop_height=int(d.get("crop_height", 0)),
    )
    if fc.kind == "phasor_hdr_film" and fc.is_cropped:
        raise ValueError("phasor_hdr_film does not support cropped films "
                         "(phasor_hdr_film.py:147-152)")
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
    # filter_bounces is an alias: filter_depth = filter_bounces + 1; setting
    # both is an error (transientnlospath.py:204-215)
    filter_depth = int(d.get("filter_depth", -1))
    filter_bounces = int(d.get("filter_bounces", -1))
    if filter_depth != -1 and filter_bounces != -1:
        raise ValueError("Only use one of filter_depth or filter_bounces "
                         "(transientnlospath.py:207-208)")
    if filter_bounces != -1:
        filter_depth = filter_bounces + 1
    if filter_depth != -1 and filter_depth >= md:
        _log.warning("You have set filter_depth >= max_depth. "
                     "This will cause the final image to be all zero. "
                     "(transientnlospath.py:212-216)")
    return IntegratorConfig(
        kind=d.get("type", "transient_path"),
        max_depth=md,
        rr_depth=int(d.get("rr_depth", 5)),
        camera_unwarp=bool(d.get("camera_unwarp", False)),
        discard_direct_light=bool(d.get("discard_direct_light", False)),
        temporal_filter=d.get("temporal_filter", ""),
        gaussian_stddev=float(d.get("gaussian_stddev", 2.0)),
        capture_type=str(d.get("capture_type", "single")).lower(),
        filter_depth=filter_depth,
        filter_bounces=filter_bounces,
        discard_direct_paths=bool(d.get("discard_direct_paths", False)),
        nlos_laser_sampling=bool(d.get("nlos_laser_sampling", False)),
        nlos_hidden_geometry_sampling=bool(
            d.get("nlos_hidden_geometry_sampling", False)),
        nlos_hidden_geometry_sampling_do_rroulette=bool(
            d.get("nlos_hidden_geometry_sampling_do_rroulette", False)),
        nlos_hidden_geometry_sampling_includes_relay_wall=bool(
            d.get("nlos_hidden_geometry_sampling_includes_relay_wall", True)),
        account_first_and_last_bounces=bool(
            d.get("account_first_and_last_bounces", True)),
        force_equal_illumination_scanning=bool(
            d.get("force_equal_illumination_scanning", True)),
        illumination_scan_fov=float(d.get("illumination_scan_fov", 20.0)),
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
    alpha_v: float = 0.0  # bitangent GGX roughness; == alpha if isotropic
    tex: np.ndarray | None = None  # (h, w, C) reflectance texture
    tex_uv: tuple = (1.0, 1.0, 0.0, 0.0)  # (su, sv, ou, ov)
    # bump / normal map: (h, w, 3), see _load_bump_texture
    bump_tex: np.ndarray | None = None
    bump_uv: tuple = (1.0, 1.0, 0.0, 0.0)
    bump_scale: float = 1.0
    bump_kind: int = 0  # 0 none, 1 bumpmap, 2 normalmap


# complex IORs (about 550 nm) of the named conductor materials
CONDUCTOR_IOR = {
    "Au": (np.array([0.1431, 0.3749, 1.4424]), np.array([3.9831, 2.3857, 1.6032])),
    "Ag": (np.array([0.1553, 0.1163, 0.1380]), np.array([4.8283, 3.1222, 2.1457])),
    "Al": (np.array([1.3404, 0.9511, 0.6852]), np.array([7.3509, 6.4542, 5.6351])),
    "Cu": (np.array([0.2004, 0.9240, 1.1022]), np.array([3.9129, 2.4528, 2.1421])),
    "none": (np.zeros(3), np.zeros(3)),
}


def _ior(value, default: float) -> float:
    """An IOR given as a number; a named one (a string) takes ``default``,
    as the JAX loader does."""
    return default if value is None or isinstance(value, str) else float(value)


def _parse_bsdf(key: str, d: dict, channels: int, base_dir: str = ".",
                tex_cache: dict | None = None) -> _BSDFEntry:
    t = d.get("type", "diffuse")
    two_sided = False
    bump_tex = None
    bump_uv = (1.0, 1.0, 0.0, 0.0)
    bump_scale = 1.0
    bump_kind = 0
    # unwrap the adapter BSDFs down to the lobe that carries the response
    for _ in range(4):
        if t == "twosided":
            two_sided = True
        elif t in ("bumpmap", "normalmap"):
            # the wrapper's texture, taken before descending
            spec = d.get("map") or d.get("normalmap") or next(
                (v for v in d.values() if isinstance(v, dict)
                 and v.get("type") in _TEXTURES), None)
            if spec is not None and tex_cache is not None:
                kind = 1 if t == "bumpmap" else 2
                loaded = _load_bump_texture(spec, base_dir, tex_cache, kind)
                if loaded is not None:
                    bump_tex, bump_uv = loaded
                    bump_kind = kind
                    bump_scale = float(d.get("scale", 1.0))
        elif t not in ("mask", "blendbsdf"):
            break
        inner = d.get("bsdf") or next(
            (v for v in d.values() if isinstance(v, dict)
             and v.get("type") not in (None,) + _TEXTURES and "type" in v),
            None)
        if inner is None:
            break
        d = inner
        t = d.get("type", "diffuse")

    refl_spec = d.get("reflectance", d.get("specular_reflectance", 1.0))
    eta_re = np.zeros(channels, np.float32)
    eta_im = np.zeros(channels, np.float32)
    alpha = alpha_v = 0.0
    eta_ratio = 1.5046

    def alpha_of(default: float) -> tuple[float, float]:
        # isotropic ``alpha`` or the anisotropic ``alpha_u`` / ``alpha_v``
        # pair (cbox_polarized.xml:53-54) -> (alpha_u, alpha_v)
        if "alpha" in d:
            a = float(d["alpha"])
            return a, a
        if "alpha_u" in d or "alpha_v" in d:
            au = float(d.get("alpha_u", d.get("alpha_v", default)))
            return au, float(d.get("alpha_v", au))
        return default, default

    if t == "diffuse":
        kind = BSDF_DIFFUSE
    elif t in ("plastic", "roughplastic"):
        # a GGX dielectric coating over a diffuse substrate; the smooth
        # plastic is a low-roughness coating
        kind = BSDF_ROUGH_PLASTIC
        refl_spec = d.get("diffuse_reflectance", 0.5)
        alpha, alpha_v = (alpha_of(0.1) if t == "roughplastic"
                          else (0.03, 0.03))
        eta_ratio = (_ior(d.get("int_ior"), 1.49)
                     / _ior(d.get("ext_ior"), 1.000277))
    elif t in ("conductor", "mirror", "roughconductor"):
        rough = t == "roughconductor"
        kind = BSDF_ROUGH_CONDUCTOR if rough else BSDF_CONDUCTOR
        default = "Au" if rough else "none"
        er, ei = CONDUCTOR_IOR.get(d.get("material", default),
                                   CONDUCTOR_IOR[default])
        eta_re = parse_color(d.get("eta", list(er)), channels)
        eta_im = parse_color(d.get("k", list(ei)), channels)
        if rough:
            alpha, alpha_v = alpha_of(0.1)
    elif t in ("dielectric", "thindielectric"):
        kind = BSDF_DIELECTRIC
        eta_ratio = (_ior(d.get("int_ior"), 1.5046)
                     / _ior(d.get("ext_ior"), 1.000277))
    elif t == "null":
        kind = BSDF_NULL
    else:
        raise ValueError(f"unsupported bsdf type {t!r} (key {key!r})")
    refl = parse_color(refl_spec, channels, base_dir)

    tex = None
    tex_uv = (1.0, 1.0, 0.0, 0.0)
    if isinstance(refl_spec, dict) and refl_spec.get("type") in _TEXTURES:
        loaded = _load_texture(refl_spec, base_dir, channels,
                               tex_cache if tex_cache is not None else {})
        if loaded is not None:
            tex, tex_uv = loaded
    return _BSDFEntry(key, kind, two_sided, refl, eta_re, eta_im, alpha,
                      eta_ratio, alpha_v=alpha_v, tex=tex, tex_uv=tex_uv,
                      bump_tex=bump_tex, bump_uv=bump_uv,
                      bump_scale=bump_scale, bump_kind=bump_kind)


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
    ``device``; relative mesh file names resolve against ``base_dir``.

    NLOS bookkeeping: ``laser_target``, ``laser_bounce_opl`` and
    ``laser_focused`` record the laser focus set by ``nlos.py``'s helpers,
    which aim a delta emitter through :meth:`replace_emitter_transform`."""

    def __init__(self, desc: dict, device="cuda", base_dir: str = "."):
        self.variant: Variant = variant()
        self.device = resolve_device(device)
        C = self.variant.color_channels
        self.integrator = IntegratorConfig()
        self.sensors: list[SensorConfig] = []
        self.shapes: list[Shape] = []
        self._shape_keys: list[str] = []
        self._bsdfs: list[_BSDFEntry] = []
        self._bsdf_index: dict[str, int] = {}
        self._emitters: list[_EmitterEntry] = []
        self._tex_cache: dict = {}
        self._media: list[dict] = []
        # traverse() path -> (table, row), as the JAX loader registers them
        self._param_paths: dict[str, tuple[str, int]] = {}
        sensor_dicts: list[tuple[dict, int]] = []  # (dict, enclosing shape)

        def add_bsdf(key: str, d: dict) -> int:
            if d.get("type") == "ref":
                ref = d["id"]
                if ref not in self._bsdf_index:
                    raise KeyError(f"bsdf ref {ref!r} not found")
                return self._bsdf_index[ref]
            idx = len(self._bsdfs)
            self._bsdfs.append(_parse_bsdf(key, d, C, base_dir,
                                           self._tex_cache))
            self._bsdf_index[key] = idx
            for leaf in ("reflectance", "alpha", "alpha_u", "alpha_v"):
                self._param_paths[f"{key}.{leaf}.value"] = (
                    "bsdf.reflectance" if leaf == "reflectance"
                    else f"bsdf.{leaf}", idx)
            return idx

        def register_nested_ids(val):
            # Mitsuba allows an ``id`` on any nesting level (a twosided
            # inside a bumpmap wrapper, say): each such subtree is
            # referencable
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
                props["_base_dir"] = base_dir
                shape = SHAPE_REGISTRY[t](props)
                bsdf_idx = None
                for ck, cv in val.items():
                    if not isinstance(cv, dict):
                        continue
                    ct = cv.get("type")
                    if ct == "ref" or ct in _BSDF_TYPES:
                        bsdf_idx = add_bsdf(f"{key}.{ck}", cv)
                    elif ct in ("area", "angulararea"):
                        em_idx = len(self._emitters)
                        cutoff = float(cv.get("cutoff_angle", 20.0))
                        self._emitters.append(_EmitterEntry(
                            key=f"{key}.{ck}",
                            kind=EM_AREA if ct == "area" else EM_ANGULAR_AREA,
                            radiance=parse_color(cv.get("radiance", 1.0), C),
                            to_world=from_spec(cv.get("to_world")),
                            fov=0.0,
                            cutoff_angle=cutoff,
                            beam_width=float(cv.get("beam_width",
                                                    cutoff * 0.75)),
                            shape_index=shape_idx,
                        ))
                        self._param_paths[f"{key}.{ck}.radiance.value"] = (
                            "emitter.radiance", em_idx)
                        shape.emitter_key = em_idx
                    elif ct in _MEDIA:
                        shape.medium_key = len(self._media)
                        self._media.append(_parse_medium(cv, C, base_dir))
                        for leaf in ("albedo", "sigma_t"):
                            self._param_paths[f"{key}.{ck}.{leaf}.value"] = (
                                f"medium.{leaf}", shape.medium_key)
                    elif ct in ("nlos_capture_meter", "perspective",
                                "irradiancemeter"):
                        sensor_dicts.append((cv, shape_idx))
                if bsdf_idx is None:
                    bsdf_idx = add_bsdf(f"{key}.__default", {"type": "diffuse"})
                shape.bsdf_key = bsdf_idx
                self.shapes.append(shape)
                self._shape_keys.append(key)
            elif t in ("projector", "point", "spot"):
                # a spot loads as a point light; irradiance or intensity is
                # the table's radiance
                rad_key = "irradiance" if t == "projector" else "intensity"
                em_idx = len(self._emitters)
                self._param_paths.update({
                    f"{key}.{rad_key}.value": ("emitter.radiance", em_idx),
                    f"{key}.to_world": ("emitter.to_world", em_idx),
                    f"{key}.position": ("emitter.position", em_idx)})
                self._emitters.append(_EmitterEntry(
                    key=key,
                    kind=EM_PROJECTOR if t == "projector" else EM_POINT,
                    radiance=parse_color(val.get(rad_key, 1.0), C),
                    to_world=from_spec(val.get("to_world")),
                    fov=float(val.get("fov", 45.0)),
                    cutoff_angle=float(val.get("cutoff_angle", 20.0)),
                    beam_width=float(val.get("beam_width", 15.0)),
                    shape_index=-1,
                ))
            elif t in ("perspective", "thinlens"):
                sensor_dicts.append((val, -1))
            elif t in _INTEGRATORS:
                self.integrator = _parse_integrator(val)
            else:
                raise ValueError(f"unknown scene entry {key!r} of type {t!r}")

        for sdict, shape_idx in sensor_dicts:
            st = sdict.get("type")
            film = _parse_film(sdict.get("film", {}))
            sampler = sdict.get("sampler", {})
            if st == "perspective":
                self.sensors.append(SensorConfig(
                    kind="perspective",
                    to_world=from_spec(sdict.get("to_world")),
                    fov=float(sdict.get("fov", 45.0)),
                    fov_axis=sdict.get("fov_axis", "x"),
                    near_clip=float(sdict.get("near_clip", 1e-2)),
                    spp=int(sampler.get("sample_count", 4)),
                    seed=int(sampler.get("seed", 0)),
                    film=film,
                ))
            elif st == "nlos_capture_meter":
                self.sensors.append(SensorConfig(
                    kind="nlos_capture_meter",
                    to_world=Transform4(),
                    fov=0.0,
                    fov_axis="x",
                    near_clip=0.0,
                    spp=int(sampler.get("sample_count", 4)),
                    seed=int(sampler.get("seed", 0)),
                    film=film,
                    sensor_origin=np.asarray(
                        sdict.get("sensor_origin", [0, 0, 0]), np.float64),
                    shape_index=shape_idx,
                    original_film_width=sdict.get("original_film_width"),
                    original_film_height=sdict.get("original_film_height"),
                ))
            else:
                raise ValueError(f"unsupported sensor type {st!r}")
        if not self.sensors:
            raise ValueError("scene has no sensor")
        # the film's time window and the NLOS laser in the traversal
        # surface: host-side settings that update() applies to the next
        # render (the reference's NonDifferentiable film parameters)
        for s_i, scfg in enumerate(self.sensors):
            sk = "sensor" if s_i == 0 else f"sensor{s_i}"
            for f in ("start_opl", "bin_width_opl", "temporal_bins"):
                self._param_paths[f"{sk}.film.{f}"] = (f"film.{f}", s_i)
            if scfg.kind == "nlos_capture_meter":
                self._param_paths[f"{sk}.laser_bounce_opl"] = (
                    "nlos.laser_bounce_opl", s_i)
                self._param_paths[f"{sk}.laser_target"] = (
                    "nlos.laser_target", s_i)
        self.laser_target = np.zeros(3)
        self.laser_bounce_opl = 0.0
        self.laser_focused = False
        self.data = self._compile()

    def emitter_index(self, key_or_idx) -> int:
        """Index of the emitter whose key is, or starts with, ``key_or_idx``
        (an int passes through)."""
        if isinstance(key_or_idx, int):
            return key_or_idx
        for i, e in enumerate(self._emitters):
            if e.key == key_or_idx or e.key.startswith(str(key_or_idx)):
                return i
        raise KeyError(key_or_idx)

    def shape_index(self, key: str) -> int:
        return self._shape_keys.index(key)

    def replace_emitter_transform(self, em_idx: int, t: Transform4) -> None:
        """Give emitter ``em_idx`` the transform ``t``: its host entry and
        its rows of the device table (position, direction, frame), written
        in place."""
        self._emitters[em_idx] = self._emitters[em_idx]._replace(to_world=t)
        R = t.m[:3, :3]
        em = self.data.emitter
        for table, value in ((em.position, t.translation),
                             (em.direction, R @ np.array([0, 0, 1.0])),
                             (em.frame_s, R @ np.array([1.0, 0, 0])),
                             (em.frame_t, R @ np.array([0, 1.0, 0]))):
            table[em_idx] = torch.from_numpy(value.astype(np.float32))

    def _compile(self) -> SceneData:
        C = self.variant.color_channels
        tris = [shape.triangles() for shape in self.shapes]
        counts = [td.count for td in tris]
        count = sum(counts)
        if count == 0:
            raise ValueError("scene has no geometry")
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
                medium_id=per_tri([-1 if s.medium_key is None
                                   else s.medium_key for s in self.shapes]),
                table=tri_table(*map(torch.from_numpy, (v0, e1, e2))).numpy(),
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
                **self._atlas("tex", C),
                **self._atlas("bump", 3),
            ),
            "emitter": self._emitter_table(C, v0, e1, e2, ng, area, shape_id),
            "medium": _medium_table(self._media, C),
        }
        pivot = np.zeros((max(len(self.shapes), 1), 3), np.float32)
        for s_i, shp in enumerate(self.shapes):
            pivot[s_i] = shp.to_world.translation
        host["geom"] = GeomParams(translate=np.zeros_like(pivot),
                                  rotate=np.zeros_like(pivot), pivot=pivot)
        for s_i, skey in enumerate(self._shape_keys):
            self._param_paths[f"{skey}.to_world.translate"] = (
                "shape.translate", s_i)
            self._param_paths[f"{skey}.to_world.rotate"] = (
                "shape.rotate", s_i)

        def dev(table):
            return type(table)(*(
                None if a is None
                else torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in table))

        accel = None
        if count > ACCEL_MIN_TRIS:
            accel = build_accel(v0, e1, e2, device=self.device)
        bp = host["bsdf"]
        return SceneData(**{k: dev(v) for k, v in host.items()}, accel=accel,
                         emitter_kinds=emitter_kinds(host["emitter"].kind),
                         bsdf_kinds=bsdf_kinds(bp.kind, bp.two_sided))

    def _atlas(self, prefix: str, channels: int) -> dict:
        """The atlas columns of the BSDF table for the reflectance textures
        (``prefix`` "tex") or the bump and normal maps ("bump"), or {} when
        no BSDF has one: each distinct texture padded to the largest (h,
        w) and stacked; the per-BSDF (h, w) drive the wrap, so the padding
        is never sampled."""
        img_of, name = (("tex", "textures") if prefix == "tex"
                        else ("bump_tex", "bump_textures"))
        if all(getattr(b, img_of) is None for b in self._bsdfs):
            return {}
        B = len(self._bsdfs)
        slots: dict[int, int] = {}
        uniq: list[np.ndarray] = []
        ids = np.full(B, -1, np.int32)
        hw = np.ones((B, 2), np.float32)
        uvt = np.tile(np.array([1.0, 1.0, 0.0, 0.0], np.float32), (B, 1))
        scale = np.zeros(B, np.float32)
        kind = np.zeros(B, np.int32)
        for bi, b in enumerate(self._bsdfs):
            img = getattr(b, img_of)
            if img is None:
                continue
            if id(img) not in slots:
                slots[id(img)] = len(uniq)
                uniq.append(img)
            ids[bi] = slots[id(img)]
            if prefix == "tex":
                # the texels of the texture's padded atlas slab (th, tw, C)
                # as traverse paths (the reference's bitmap ``.data``)
                for alias in ("reflectance.data", "diffuse_reflectance.data"):
                    self._param_paths[f"{b.key}.{alias}"] = (
                        "bsdf.textures", int(ids[bi]))
            hw[bi] = img.shape[:2]
            uvt[bi] = b.tex_uv if prefix == "tex" else b.bump_uv
            scale[bi], kind[bi] = b.bump_scale, b.bump_kind
        th = max(t.shape[0] for t in uniq)
        tw = max(t.shape[1] for t in uniq)
        atlas = np.zeros((len(uniq), th, tw, channels), np.float32)
        for j, img in enumerate(uniq):
            atlas[j, :img.shape[0], :img.shape[1]] = img
        out = {f"{prefix}_id": ids, f"{prefix}_hw": hw, f"{prefix}_uv": uvt,
               name: atlas}
        if prefix == "bump":
            out.update(bump_scale=scale, bump_kind=kind)
        return out

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
            if e.shape_index < 0:  # a delta emitter has no triangles
                continue
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
            em_tri_key=em_tri_key_table(em_tri_count, em_tri_cdf),
        )


def load_dict(desc: dict, device="cuda", base_dir: str = ".") -> Scene:
    """Entry point mirroring ``mi.load_dict``; ``scene.data`` lives on
    ``device`` (the card by default; ``"cpu"`` runs the plain versions)
    and :func:`render` runs there.  Without a CUDA device the default
    raises rather than falling back to the CPU."""
    if desc.get("type") != "scene":
        raise ValueError("top-level dict must have type='scene'")
    return Scene(desc, device=device, base_dir=base_dir)


# --------------------------------------------------------------------------
# Parameter traversal (mi.traverse; the JAX package's ParamMap)
# --------------------------------------------------------------------------

def _host(value) -> np.ndarray:
    """A parameter value (tensor, array or number) as a host float64 array."""
    if isinstance(value, torch.Tensor):
        with trace.span("mitr:sync"):
            value = value.detach().cpu().numpy()
    return np.asarray(value, np.float64)


def _set_row(table: torch.Tensor, idx: int, value) -> torch.Tensor:
    """A copy of ``table`` with row ``idx`` set to ``value`` (autograd
    reaches ``value`` through the copy)."""
    out = table.clone()
    out[idx] = torch.as_tensor(value, dtype=table.dtype, device=table.device)
    return out


# traverse tables held in SceneData: table -> (record, field)
_DEVICE_TABLES = {
    "bsdf.reflectance": ("bsdf", "reflectance"),
    "bsdf.alpha_u": ("bsdf", "alpha"),
    "bsdf.alpha_v": ("bsdf", "alpha_v"),
    "bsdf.textures": ("bsdf", "textures"),
    "emitter.radiance": ("emitter", "radiance"),
    "emitter.position": ("emitter", "position"),
    "medium.albedo": ("medium", "albedo"),
    "medium.sigma_t": ("medium", "sigma_t"),
}


class ParamMap:
    """String-path view over the scene's parameters, as ``mi.traverse``::

        params = traverse(scene)
        params['white.reflectance.value'] = torch.tensor([0.5, 0.5, 0.5])
        params.update()

    :meth:`apply` is the pure form: it maps a {path: value} dict onto a new
    SceneData and leaves the scene as it is."""

    def __init__(self, scene: Scene):
        self.scene = scene
        self._staged: dict[str, Any] = {}

    def keys(self):
        return list(self.scene._param_paths.keys())

    def __contains__(self, key):
        return key in self.scene._param_paths

    def __getitem__(self, key):
        sc = self.scene
        table, idx = sc._param_paths[key]
        if table == "bsdf.alpha":
            table = "bsdf.alpha_u"
        if table in _DEVICE_TABLES:
            rec, field = _DEVICE_TABLES[table]
            return getattr(getattr(sc.data, rec), field)[idx]
        if table == "emitter.to_world":
            return sc._emitters[idx].to_world
        if table == "shape.translate":
            # the absolute translation of the shape's to_world
            return torch.tensor(sc.shapes[idx].to_world.translation,
                                dtype=torch.float32, device=sc.device)
        if table == "shape.rotate":
            # an additive axis-angle delta about the shape's pivot, zero
            # after update() has baked the pose into the soup
            return sc.data.geom.rotate[idx]
        if table.startswith("film."):
            return getattr(sc.sensors[idx].film, table.split(".", 1)[1])
        if table == "nlos.laser_bounce_opl":
            return float(sc.laser_bounce_opl)
        if table == "nlos.laser_target":
            return np.asarray(sc.laser_target, np.float32)
        raise KeyError(key)

    def __setitem__(self, key, value):
        if key not in self.scene._param_paths:
            raise KeyError(key)
        self._staged[key] = value

    def update(self) -> None:
        """Apply the staged values: the device tables, their host mirrors
        (so that a later re-bake keeps them), and the host-side settings.
        A moved shape re-bakes the soup, the emitter tables, the pivots and
        the accel on the host; the geometry deltas stay zero."""
        sc = self.scene
        sc.data = self.apply(self._staged, sc.data)
        rebake = False
        for key, value in self._staged.items():
            table, idx = sc._param_paths[key]
            if table == "bsdf.reflectance":
                b = sc._bsdfs[idx]
                sc._bsdfs[idx] = b._replace(reflectance=_host(value).astype(
                    np.float32).reshape(b.reflectance.shape))
            elif table == "emitter.radiance":
                e = sc._emitters[idx]
                sc._emitters[idx] = e._replace(radiance=_host(value).astype(
                    np.float32).reshape(e.radiance.shape))
            elif table in ("bsdf.alpha", "bsdf.alpha_u"):
                a = float(_host(value))
                b = sc._bsdfs[idx]
                sc._bsdfs[idx] = b._replace(
                    alpha=a, alpha_v=a if table == "bsdf.alpha" else b.alpha_v)
            elif table == "bsdf.alpha_v":
                sc._bsdfs[idx] = sc._bsdfs[idx]._replace(
                    alpha_v=float(_host(value)))
            elif table == "medium.albedo":
                sc._media[idx]["albedo"] = _host(value).astype(
                    np.float32).reshape(sc._media[idx]["albedo"].shape)
            elif table == "medium.sigma_t":
                sc._media[idx]["sigma_t"] = float(_host(value))
            elif table == "emitter.position":
                e = sc._emitters[idx]
                m = e.to_world.m.copy()
                m[:3, 3] = _host(value)
                sc._emitters[idx] = e._replace(to_world=Transform4(m))
            elif table == "emitter.to_world":
                sc.replace_emitter_transform(idx, value)
            elif table == "shape.translate":
                shp = sc.shapes[idx]
                m = shp.to_world.m.copy()
                m[:3, 3] = _host(value)
                shp.to_world = Transform4(m)
                rebake = True
            elif table == "shape.rotate":
                shp = sc.shapes[idx]
                w = _host(value)
                th = float(np.linalg.norm(w))
                if th > 0.0:
                    piv = shp.to_world.translation
                    delta = (Transform4().translate(piv)
                             .rotate(w / th, np.rad2deg(th))
                             .translate(-piv))
                    shp.to_world = delta @ shp.to_world
                    rebake = True
            elif table.startswith("film."):
                field = table.split(".", 1)[1]
                cast = int if field == "temporal_bins" else float
                scfg = sc.sensors[idx]
                sc.sensors[idx] = scfg._replace(
                    film=scfg.film._replace(**{field: cast(value)}))
            elif table == "nlos.laser_bounce_opl":
                sc.laser_bounce_opl = float(value)
            elif table == "nlos.laser_target":
                sc.laser_target = _host(value)
                sc.laser_focused = True
        if rebake:
            # the soup moved: rebuild SceneData from the host objects, then
            # this batch's device tables on top (textures have no mirror)
            sc.data = self.apply(self._staged, sc._compile())
        self._staged = {}

    def apply(self, updates: dict, data: SceneData | None = None
              ) -> SceneData:
        """``data`` (by default the scene's) with ``updates`` {path: value}
        written into copies of its tables; host-side paths (emitter and
        shape transforms, film and laser settings) are left to
        :meth:`update`."""
        data = data if data is not None else self.scene.data
        for key, value in updates.items():
            table, idx = self.scene._param_paths[key]
            if table == "bsdf.alpha":  # the isotropic path sets both leaves
                data = data._replace(bsdf=data.bsdf._replace(
                    alpha=_set_row(data.bsdf.alpha, idx, value),
                    alpha_v=_set_row(data.bsdf.alpha_v, idx, value)))
            elif table in _DEVICE_TABLES:
                rec, field = _DEVICE_TABLES[table]
                r = getattr(data, rec)
                data = data._replace(**{rec: r._replace(**{
                    field: _set_row(getattr(r, field), idx, value)})})
            elif not (table in ("emitter.to_world", "shape.translate",
                                "shape.rotate")
                      or table.startswith(("film.", "nlos."))):
                raise KeyError(key)
        return data


def traverse(scene: Scene) -> ParamMap:
    """The :class:`ParamMap` of ``scene`` (``mi.traverse``)."""
    return ParamMap(scene)
