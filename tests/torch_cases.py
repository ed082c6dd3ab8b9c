"""Inputs and comparison rules shared by the port's tests and chip_smoke.py.

Everything is made with numpy from a seed, so the JAX reference and the
PyTorch port see the same arrays.  This module imports neither jax nor the
JAX package, so it also runs on a machine that has only PyTorch.
"""
from __future__ import annotations

import numpy as np

GOLDEN_RTOL = 5e-4  # test_golden's tolerance: rtol, and atol as a share of max
GOLDEN_ATOL_SCALE = 5e-5


def small_cbox(mt, w=16, h=16, bins=120, max_depth=6):
    """The cbox_rgb golden's scene (tests/golden_configs.py:_small_cbox)."""
    d = mt.cornell_box()
    d["sensor"]["film"]["width"] = w
    d["sensor"]["film"]["height"] = h
    d["sensor"]["film"]["temporal_bins"] = bins
    d["integrator"]["max_depth"] = max_depth
    return d


def uv_sphere(rings: int, segments: int, radius: float = 1.0,
              center=(0.0, 0.0, 0.0)):
    """(vertices (V, 3) f64, faces (F, 3) int32) of a UV sphere: two poles
    and ``rings - 1`` circles of ``segments`` vertices, y up, every
    triangle facing outward; ``segments * (2 * rings - 2)`` triangles
    (48 x 48: 4,512; 256 x 512: 261,120)."""
    theta = np.pi * np.arange(1, rings) / rings
    phi = 2.0 * np.pi * np.arange(segments) / segments
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    ring = np.stack([st * np.cos(phi),
                     np.broadcast_to(ct, (rings - 1, segments)),
                     st * np.sin(phi)], axis=-1).reshape(-1, 3)
    verts = np.concatenate([[[0.0, 1.0, 0.0]], ring, [[0.0, -1.0, 0.0]]])
    j = np.arange(segments)
    j1 = (j + 1) % segments
    faces = [np.stack([np.zeros_like(j), 1 + j1, 1 + j], axis=-1)]
    for i in range(rings - 2):
        a, b = 1 + i * segments + j, 1 + i * segments + j1
        faces += [np.stack([a, b, a + segments], axis=-1),
                  np.stack([b, b + segments, a + segments], axis=-1)]
    base = 1 + (rings - 2) * segments
    faces.append(np.stack([np.full_like(j, len(verts) - 1), base + j,
                           base + j1], axis=-1))
    verts = np.asarray(center, np.float64) + radius * verts
    return verts, np.concatenate(faces).astype(np.int32)


SPHERE_RADIUS = 0.3
SPHERE_CENTER = (0.335, -0.7, 0.38)  # where cornell_box() has its small box


def with_sphere(desc: dict, rings: int, segments: int) -> dict:
    """``desc`` with its ``small-box`` cube replaced, in place in the shape
    order, by a diffuse white UV sphere ``mesh`` of radius 0.3."""
    verts, faces = uv_sphere(rings, segments, SPHERE_RADIUS, SPHERE_CENTER)
    sphere = {"type": "mesh", "vertices": verts, "faces": faces,
              "bsdf": {"type": "ref", "id": "white"}}
    return {k: (sphere if k == "small-box" else v) for k, v in desc.items()}


def cbox_mesh(mt, rings=256, segments=512):
    """The large-mesh config: cornell_box() (256x256, 300 bins, depth 8)
    with a 261,120-triangle sphere for the small box."""
    return with_sphere(mt.cornell_box(), rings, segments)


def small_sphere_cbox(mt):
    """small_cbox() with a 48 x 48 sphere (4,512 triangles, just above the
    4,096 at which the loader builds an accel) for the small box."""
    return with_sphere(small_cbox(mt), 48, 48)


def golden_mismatch(got: np.ndarray, want: np.ndarray) -> dict:
    """Compare a render with a golden under test_golden's rule (rtol 5e-4,
    atol 5e-5 * max|want|).  Returns the share of elements within that
    tolerance and the relative mean error mean|got - want| / mean|want|."""
    scale = float(np.abs(want).max()) or 1.0
    ok = np.isclose(got, want, rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL_SCALE * scale)
    return {
        "shape_ok": got.shape == want.shape,
        "frac_ok": float(ok.mean()),
        "n_bad": int((~ok).sum()),
        "rel_mean_err": float(np.abs(got - want).mean()
                              / max(float(np.abs(want).mean()), 1e-30)),
    }


def physics_checks(steady: np.ndarray, transient: np.ndarray,
                   red_green: bool = True) -> list[str]:
    """The cbox physics checks of the verify recipe; returns failures.

    First arrival (camera -> light distance) in bins 15-18, transient /
    steady energy ratio in (0.9, 1.0001], everything finite and, at a
    width of at least 32, the red wall left and the green wall right."""
    fails = []
    if not (np.all(np.isfinite(steady)) and np.all(np.isfinite(transient))):
        fails.append("non-finite values")
    prof = transient.sum(axis=(0, 1, 3))
    nz = np.nonzero(prof)[0]
    if nz.size == 0 or not 15 <= nz[0] <= 18:
        fails.append(f"first arrival bin {nz[:1]} not in 15-18")
    ratio = transient.sum() / steady.sum()
    if not 0.9 < ratio <= 1.0001:
        fails.append(f"transient/steady ratio {ratio}")
    if red_green:
        h, w, _ = steady.shape
        left, right = steady[h // 2, int(w * 6 / 256)], steady[h // 2, int(w * 249 / 256)]
        if not (left[0] > left[1] and right[1] > right[0]):
            fails.append(f"red/green walls: left {left}, right {right}")
    return fails


def random_soup(rng: np.random.Generator, m: int):
    """m random triangles in [-1, 1]^3; the last one repeats triangle 0,
    an exact tie that the lower index must win."""
    v0 = rng.uniform(-1.0, 1.0, (m, 3)).astype(np.float32)
    e1 = rng.normal(0.0, 0.4, (m, 3)).astype(np.float32)
    e2 = rng.normal(0.0, 0.4, (m, 3)).astype(np.float32)
    v0[-1], e1[-1], e2[-1] = v0[0], e1[0], e2[0]
    return v0, e1, e2


def random_rays(rng: np.random.Generator, n: int, soup=None):
    """Rays from random points of [-0.99, 0.99]^3 in random directions.
    A quarter have a short maxt, a tenth are inactive; with ``soup`` given
    a fifth aim at the centroid of triangle 0 (the tied pair)."""
    o = rng.uniform(-0.99, 0.99, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    if soup is not None:
        v0, e1, e2 = soup
        k = n // 5
        d[:k] = (v0[0] + (e1[0] + e2[0]) / 3.0) - o[:k]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    maxt = np.full(n, np.inf, np.float32)
    short = rng.random(n) < 0.25
    maxt[short] = rng.uniform(0.05, 1.5, short.sum()).astype(np.float32)
    active = rng.random(n) >= 0.1
    return o, d, maxt, active


def camera_rays(rng: np.random.Generator, n: int, R: np.ndarray,
                origin: np.ndarray, tan_half: np.ndarray):
    """Jittered pinhole rays over the whole image of a camera."""
    u, v = rng.random(n), rng.random(n)
    d_cam = np.stack([(1 - 2 * u) * tan_half[0], (1 - 2 * v) * tan_half[1],
                      np.ones(n)], axis=-1)
    d = d_cam @ R.T
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.broadcast_to(origin, (n, 3)).astype(np.float32)
    return o, d


def box_rays(rng: np.random.Generator, n: int, R: np.ndarray,
             origin: np.ndarray, tan_half: np.ndarray):
    """The kernels' test rays for a box scene: half camera rays (inf maxt,
    a tenth inactive), half ``random_rays`` inside the box."""
    half = n // 2
    o_c, d_c = camera_rays(rng, half, R, origin, tan_half)
    o_r, d_r, maxt_r, act_r = random_rays(rng, n - half)
    return (np.concatenate([o_c, o_r]), np.concatenate([d_c, d_r]),
            np.concatenate([np.full(half, np.inf, np.float32), maxt_r]),
            np.concatenate([rng.random(half) >= 0.1, act_r]))


def splat_events(rng: np.random.Generator, lanes: int, hw: int, bins: int,
                 channels: int = 3):
    """One event set for a (channels, bins + 1, hw) film: bins in [0, bins]
    (bin ``bins`` is the overflow slot, about 5% of lanes), values with
    about 30% exact zeros (inactive lanes)."""
    n = lanes * hw
    b = rng.integers(0, bins, n).astype(np.int32)
    b[rng.random(n) < 0.05] = bins
    v = rng.random((n, channels)).astype(np.float32)
    v[rng.random(n) < 0.3] = 0.0
    return b, v


def overlapping_soup(rng: np.random.Generator, m: int = 20000):
    """m long thin triangles (slivers) in [-1, 1]^3: every chunk box of
    their accel covers most of the cube while a ray meets few triangles,
    so rays from outside cross many boxes without a hit, which fills the
    chunk-mode kernel's queues."""
    v0 = rng.uniform(-1.0, 1.0, (m, 3)).astype(np.float32)
    e1 = rng.uniform(-1.0, 1.0, (m, 3)).astype(np.float32)
    e2 = rng.uniform(-1e-3, 1e-3, (m, 3)).astype(np.float32)
    return v0, e1, e2


def overlapping_rays(rng: np.random.Generator, n: int):
    """Rays for ``overlapping_soup``: origins on a sphere of radius 4
    around it, aimed at random points of [-0.5, 0.5]^3; a tenth inactive,
    a fifth with a maxt short of the cube."""
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-0.5, 0.5, (n, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    maxt = np.where(rng.random(n) < 0.2, 2.5, np.inf).astype(np.float32)
    return o.astype(np.float32), d, maxt, rng.random(n) >= 0.1


def nlos_scene(sx=4, sy=4, laser_sampling=True, hg_sampling=True,
               account=False, bins=300, spp=64):
    """The NLOS scene of tests/test_nlos.py:15-65 (a copy without jax): a
    [-1, 1]^2 relay wall at z = 0 with an ``nlos_capture_meter`` of sx x sy
    pixels, a 0.5-wide hidden rectangle at z = 1 facing it, and a projector
    laser beside the sensor origin; depth 4, bins of 0.02 from OPL 0."""
    return {
        "type": "scene",
        "integrator": {
            "type": "transient_nlos_path",
            "max_depth": 4,
            "filter_depth": -1,
            "nlos_laser_sampling": laser_sampling,
            "nlos_hidden_geometry_sampling": hg_sampling,
            "nlos_hidden_geometry_sampling_do_rroulette": False,
            "nlos_hidden_geometry_sampling_includes_relay_wall": False,
            "account_first_and_last_bounces": account,
            "temporal_filter": "box",
        },
        "hidden-target": {
            "type": "rectangle",
            "to_world": {
                "translate": [0.0, 0.0, 1.0],
                "rotate": {"axis": [0, 1, 0], "angle": 180},
                "scale": 0.5,
            },
            "bsdf": {"type": "diffuse", "reflectance": {"type": "rgb", "value": [1.0, 1.0, 1.0]}},
        },
        "laser": {
            "type": "projector",
            "to_world": {"translate": [-0.5, 0.0, 0.25]},
            "irradiance": {"type": "rgb", "value": [1.0, 1.0, 1.0]},
            "fov": 0.2,
        },
        "relay_wall": {
            "type": "rectangle",
            "bsdf": {"type": "diffuse", "reflectance": {"type": "rgb", "value": [1.0, 1.0, 1.0]}},
            "nlos_sensor": {
                "type": "nlos_capture_meter",
                "sampler": {"type": "independent", "sample_count": spp,
                            "seed": 0},
                "sensor_origin": [-0.5, 0.0, 0.25],
                "film": {
                    "type": "transient_hdr_film",
                    "width": sx,
                    "height": sy,
                    "temporal_bins": bins,
                    "bin_width_opl": 0.02,
                    "start_opl": 0.0,
                },
            },
        },
    }


def nlos_z_scene(sx, sy, bins=300, spp=64) -> dict:
    """examples/transient_nlos/simple_nlos_scenes.py's capture (a copy
    without jax): ``nlos_scene``'s relay wall, sensor and laser, with the
    hidden Z of three diffuse bars at z = 1 for the hidden rectangle."""
    def bar(translate, scale, angle=0.0):
        return {"type": "rectangle",
                "to_world": [{"translate": translate},
                             {"rotate": {"axis": [0, 0, 1], "angle": angle}},
                             {"rotate": {"axis": [0, 1, 0], "angle": 180}},
                             {"scale": scale}],
                "bsdf": {"type": "diffuse", "reflectance": {
                    "type": "rgb", "value": [1.0, 1.0, 1.0]}}}

    d = nlos_scene(sx, sy, bins=bins, spp=spp)
    del d["hidden-target"]
    d["z-top"] = bar([0.0, 0.35, 1.0], [0.35, 0.1, 1.0])
    d["z-mid"] = bar([0.0, 0.0, 1.0], [0.38, 0.09, 1.0], angle=45.0)
    d["z-bot"] = bar([0.0, -0.35, 1.0], [0.35, 0.1, 1.0])
    return d


# the polarimetric NLOS example (examples/polarization/
# transient_nlos_polarization.py:31-43, BASELINE.md:22): mono_polarized, a
# 64 x 64 scan of 300 bins, the hidden Z, a gold GGX relay wall of alpha
# 0.3, the laser at wall pixel (32, 32); spp 65,536
GOLD_GGX_WALL = {"type": "roughconductor", "material": "Au",
                 "distribution": "ggx", "alpha": 0.3}


def polarized_nlos(scan=64, bins=300) -> dict:
    """The polarimetric NLOS scene (load it under ``mono_polarized`` and
    focus the laser at pixel (scan / 2, scan / 2))."""
    d = nlos_z_scene(scan, scan, bins)
    d["relay_wall"]["bsdf"] = dict(GOLD_GGX_WALL)
    return d


def nlos_exhaustive(desc: dict, lw: int, lh: int) -> dict:
    """``desc`` (an nlos_scene) as an exhaustive capture with a lw x lh
    laser grid, in place."""
    desc["integrator"]["capture_type"] = "exhaustive"
    desc["relay_wall"]["nlos_sensor"]["film"].update(
        exhaustive_scan=True, laser_scan_width=lw, laser_scan_height=lh)
    return desc


def nlos_confocal(desc: dict, w: int, h: int) -> dict:
    """``desc`` (an nlos_scene of a 1x1 film) as a confocal capture over a
    w x h scan grid, in place."""
    desc["relay_wall"]["nlos_sensor"].update(original_film_width=w,
                                             original_film_height=h)
    return desc


def nlos_perspective(desc: dict) -> dict:
    """``desc`` (an nlos_scene) seen through a perspective sensor at the
    sensor origin, aimed at the wall's centre, with the capture meter's
    film and sampler, in place."""
    sens = desc["relay_wall"].pop("nlos_sensor")
    desc["sensor"] = {
        "type": "perspective", "fov": 30.0,
        "to_world": {"look_at": {"origin": [-0.5, 0.0, 0.25],
                                 "target": [0.0, 0.0, 0.0], "up": [0, 1, 0]}},
        "sampler": sens["sampler"], "film": sens["film"]}
    return desc


def nlos_hidden_mesh(desc: dict) -> dict:
    """``desc`` (an nlos_scene) with a 48 x 48 UV sphere (4,512 triangles,
    r 0.2) between the wall and the hidden rectangle, so that the scene has
    4,516 triangles and the loader builds an accel, in place."""
    verts, faces = uv_sphere(48, 48, 0.2, (0.25, 0.15, 0.7))
    desc["hidden-sphere"] = {"type": "mesh", "vertices": verts,
                             "faces": faces}
    return desc


# the NLOS configurations held card against CPU (chip_smoke.py) and port
# against the JAX package (tests/test_torch_nlos.py)
NLOS_CASES = ("plain_nee", "hg_rr", "account", "filter_depth", "multipass",
              "confocal", "scan_confocal", "exhaustive", "perspective",
              "point_regen", "point_multipass", "mesh_single",
              "mesh_exhaustive")
POINT_LIGHT = {"type": "point", "to_world": {"translate": [0.1, 0.8, 0.2]},
               "intensity": {"type": "rgb", "value": [3.0, 2.5, 1.5]}}


def nlos_case(pkg, name: str):
    """Configuration ``name`` of NLOS_CASES for the package ``pkg`` (the
    port or the JAX package, which share their entry points) -> (scene
    dict, run(scene) -> (steady, transient, stats)).  Each renders in under
    a second on the CPU.

    plain_nee: a point laser, NEE toward it, hidden-geometry sampling;
    hg_rr: HG mixed with BSDF sampling by RR, rr_depth 1; account:
    account_first_and_last_bounces; filter_depth: filter_depth 3 with
    discard_direct_paths; multipass: 5 passes (max_lanes 80); confocal: a
    1x1 film over a 4x4 scan; scan_confocal: ``nlos.scan_confocal`` over
    4x4; exhaustive: 4x4 scan x 2x2 lasers, laser_chunk 3 (two chunks, two
    padded rows); perspective: the capture through a perspective sensor;
    point_regen / point_multipass: the 8x8 cbox with a point light for its
    area light, through the regen loop (spp 8) and the multi-pass
    accumulator (spp 4); mesh_single / mesh_exhaustive: the single capture
    and the exhaustive capture (4x4 scan x 2x2 lasers, one chunk) of
    ``nlos_hidden_mesh``, whose accel sends every query of the card to the
    BVH kernel."""
    import importlib

    def focused(pixel, **kw):
        def run(scene):
            pkg.nlos.focus_emitter_at_relay_wall_pixel(pixel, scene)
            return pkg.render(scene, return_stats=True, **kw)
        return run

    d = nlos_scene()
    run = focused([2.0, 2.0], spp=16, seed=0)
    if name == "plain_nee":
        d = nlos_scene(laser_sampling=False)
        d["laser"] = {"type": "point",
                      "to_world": {"translate": [-0.5, 0.0, 0.25]},
                      "intensity": {"type": "rgb", "value": [1.0, 2.0, 3.0]}}

        def run(scene):
            return pkg.render(scene, spp=16, seed=1, return_stats=True)
    elif name == "hg_rr":
        d["integrator"].update(nlos_hidden_geometry_sampling_do_rroulette=True,
                               rr_depth=1)
        run = focused([1.0, 2.0], spp=16, seed=2)
    elif name == "account":
        d = nlos_scene(account=True)
    elif name == "filter_depth":
        d["integrator"].update(filter_depth=3, discard_direct_paths=True)
    elif name == "multipass":
        run = focused([3.0, 1.0], spp=20, seed=4, max_lanes=4 * 16)
    elif name == "confocal":
        d = nlos_confocal(nlos_scene(sx=1, sy=1), 4, 4)
        run = focused([2.0, 2.0], spp=32, seed=0)
    elif name == "scan_confocal":
        d = nlos_confocal(nlos_scene(sx=1, sy=1), 4, 4)

        def run(scene):
            return pkg.nlos.scan_confocal(scene, spp=8, seed=0,
                                          return_stats=True)
    elif name == "exhaustive":
        d = nlos_exhaustive(nlos_scene(), 2, 2)
        mod = importlib.import_module(pkg.__name__ + ".integrators.nlos_path")

        def run(scene):
            return mod.render_nlos_exhaustive(scene, 8, seed=0, laser_chunk=3,
                                              return_stats=True)
    elif name == "perspective":
        d = nlos_perspective(d)

        def run(scene):
            pkg.nlos.focus_emitter_at_relay_wall_3dpoint([0.1, 0.05, 0.0],
                                                         scene)
            return pkg.render(scene, spp=16, seed=0, return_stats=True)
    elif name in ("point_regen", "point_multipass"):
        d = small_cbox(pkg, 8, 8, 100, 4)
        del d["light"]["emitter"]
        d["bulb"] = dict(POINT_LIGHT)
        spp = 8 if name == "point_regen" else 4

        def run(scene):
            return pkg.render(scene, spp=spp, seed=3, return_stats=True)
    elif name == "mesh_single":
        d = nlos_hidden_mesh(d)
        run = focused([1.0, 2.0], spp=16, seed=5)
    elif name == "mesh_exhaustive":
        d = nlos_exhaustive(nlos_hidden_mesh(d), 2, 2)

        def run(scene):
            return pkg.render(scene, spp=8, seed=6, return_stats=True)
    elif name not in ("account", "filter_depth"):
        raise KeyError(name)
    return d, run


# --------------------------------------------------------------------------
# Materials, textures and the angulararea emitter
# --------------------------------------------------------------------------

GOLD_GGX = {"type": "roughconductor", "material": "Au", "alpha_u": 0.3,
            "alpha_v": 0.3}  # the reference's gold (cbox_polarized.xml:53-54)


def materials_cbox(pkg, w=256, h=256, bins=300, max_depth=8) -> dict:
    """The materials flagship: cornell_box() (bins of 0.02 from OPL 3.5,
    rr_depth 5) with a gold GGX large box and a glass small box (a
    dielectric of the default IORs)."""
    d = small_cbox(pkg, w, h, bins, max_depth)
    d["large-box"]["bsdf"] = dict(GOLD_GGX)
    d["small-box"]["bsdf"] = {"type": "dielectric"}
    return d


def room(emitter: dict, res: int, bins: int) -> dict:
    """A gray room with a downward-facing ceiling light panel (a copy of
    examples/angulararea_emitter/render_angular_vs_area.py:room)."""
    return {
        "type": "scene",
        "integrator": {"type": "transient_path", "max_depth": 8,
                       "temporal_filter": "box"},
        "sensor": {
            "type": "perspective",
            "fov": 45.0,
            "to_world": {"look_at": {"origin": [0.0, 1.0, 3.5],
                                     "target": [0.0, 0.5, 0.0],
                                     "up": [0, 1, 0]}},
            "film": {"type": "transient_hdr_film", "width": res,
                     "height": res, "temporal_bins": bins,
                     "start_opl": 3.0, "bin_width_opl": 0.08},
        },
        "floor": {
            "type": "rectangle",
            "to_world": [{"rotate": {"axis": [1, 0, 0], "angle": -90}},
                         {"scale": 4.0}],
            "bsdf": {"type": "diffuse",
                     "reflectance": {"type": "rgb",
                                     "value": [0.85, 0.85, 0.85]}},
        },
        "back": {
            "type": "rectangle",
            "to_world": [{"translate": [0.0, 2.0, -3.0]}, {"scale": 4.0}],
            "bsdf": {"type": "diffuse",
                     "reflectance": {"type": "rgb",
                                     "value": [0.85, 0.85, 0.85]}},
        },
        "light": {
            "type": "rectangle",
            "to_world": [{"translate": [0.0, 2.5, 0.0]},
                         {"rotate": {"axis": [1, 0, 0], "angle": 90}},
                         {"scale": 0.4}],
            "bsdf": {"type": "diffuse",
                     "reflectance": {"type": "rgb", "value": [0, 0, 0]}},
            "emitter": emitter,
        },
    }


ROOM_RADIANCE = {"type": "rgb", "value": [18.387, 10.9873, 2.75357]}
ROOM_EMITTERS = {  # the example's two lights (angular_1light.xml:59-64)
    "area": {"type": "area", "radiance": ROOM_RADIANCE},
    "angulararea": {"type": "angulararea", "radiance": ROOM_RADIANCE,
                    "cutoff_angle": 35.0, "beam_width": 20.0},
}


def room_spot_share(steady: np.ndarray) -> float:
    """The share of the floor's energy under the light: the steady image's
    bottom rows (the floor) within the middle third of the columns."""
    h, w, _ = steady.shape
    floor = steady[int(0.7 * h):].sum(axis=-1)
    return float(floor[:, w // 3:2 * w // 3].sum() / max(floor.sum(), 1e-30))


def _diffuse(rgb):
    return {"type": "diffuse", "reflectance": {"type": "rgb", "value": rgb}}


# the small box's BSDF (or, with a key, another shape's) in each lobe and
# wrapper case; each name of MATERIAL_CASES not here builds its own scene
_BOX_BSDFS = {
    "conductor": {"type": "conductor"},
    "mirror": {"type": "mirror", "material": "Cu"},
    "roughconductor": {"type": "roughconductor", "material": "Au",
                       "alpha": 0.2},
    "roughconductor_aniso": {"type": "roughconductor", "material": "Ag",
                             "alpha_u": 0.4, "alpha_v": 0.05},
    "plastic": {"type": "plastic",
                "diffuse_reflectance": {"type": "rgb",
                                        "value": [0.2, 0.4, 0.7]}},
    "roughplastic": {"type": "roughplastic", "alpha": 0.2, "int_ior": 1.6,
                     "diffuse_reflectance": {"type": "rgb",
                                             "value": [0.7, 0.4, 0.2]}},
    "dielectric": {"type": "dielectric"},
    "thindielectric": {"type": "thindielectric", "int_ior": 1.33},
    "null": {"type": "null"},
    "mask": {"type": "mask", "opacity": 0.5,
             "bsdf": {"type": "roughconductor", "material": "Al",
                      "alpha": 0.15}},
    "blendbsdf": {"type": "blendbsdf", "weight": 0.3,
                  "coat": {"type": "plastic"},
                  "base": _diffuse([0.3, 0.6, 0.3])},
}

# the cases that render the box scene of materials_cbox() or a cube of
# another BSDF standing on the floor: their rays can reach the cube's
# bottom from inside, where it is coplanar with the floor (see
# MATERIAL_TIES)
MATERIAL_CASES = (
    "conductor", "mirror", "roughconductor", "roughconductor_aniso",
    "plastic", "roughplastic", "dielectric", "thindielectric", "null",
    "twosided", "mask", "blendbsdf", "checkerboard", "bumpmap",
    "normalmap", "angulararea", "emissive_sphere", "nlos_rough_wall",
    "flagship")
# the elements of the steady image (of 12 x 12 x 3 = 432) out of
# test_golden's rule between the JAX package on the CPU and the port, in
# the regen render and the multi-pass render: rays that leave a
# transmissive cube through its bottom meet the floor in the same plane,
# and XLA's FMA-contracted t and the port's separately rounded one pick
# different triangles there (ROADMAP queue 3); with the cube lifted off
# the floor by 2 mm no element is out.  The transient films agree with
# none out.  The paths that part change the ray count by up to 0.3 %.
MATERIAL_TIES = {"dielectric": (14, 12), "thindielectric": (6, 4),
                 "null": (4, 6), "flagship": (15, 16)}
MATERIAL_TIE_RAYS = 3e-3


def material_case(pkg, name: str):
    """Configuration ``name`` of MATERIAL_CASES for the package ``pkg`` ->
    (scene dict, run(scene, multipass) -> (steady, transient, stats)).  A
    12 x 12 box of 120 bins (the cbox_rgb golden's) and depth 6 unless
    said otherwise; the regen
    render at spp 8, the multi-pass render (``regenerate=False``) at spp 4.

    The lobes and wrappers replace the small box's BSDF (mask and
    blendbsdf unwrap to their inner lobe); twosided: a two-sided rough
    plastic panel in the small box's place, turned so that the camera
    sees its back; checkerboard: a red and green checkered floor with an
    offset and scaled ``to_uv`` (negative uv); bumpmap / normalmap: a
    checkerboard bump map on the floor and a checkerboard normal map on
    the back wall; angulararea: ``room`` at 12 x 12 with the example's
    angulararea light; emissive_sphere: a rough gold 48 x 48 UV sphere
    (4,512 triangles: the accel and the BVH kernel) that is an area light
    beside the ceiling light, so that NEE picks among 4,514 emitter
    triangles in two segments; nlos_rough_wall: ``nlos_scene`` with a rough
    conductor relay wall; flagship: ``materials_cbox`` at 12 x 12."""

    def run_box(spp_regen=8, spp_mp=4):
        def run(scene, multipass):
            if multipass:
                return pkg.render(scene, spp=spp_mp, seed=1,
                                  regenerate=False, return_stats=True)
            return pkg.render(scene, spp=spp_regen, seed=0,
                              return_stats=True)
        return run

    d = small_cbox(pkg, 12, 12, 120, 6)
    run = run_box()
    if name in _BOX_BSDFS:
        d["small-box"]["bsdf"] = dict(_BOX_BSDFS[name])
    elif name == "twosided":
        d["small-box"] = {
            "type": "rectangle",
            "to_world": [{"translate": [0.3, -0.55, 0.3]},
                         {"rotate": {"axis": [1, 0, 0], "angle": -40}},
                         {"rotate": {"axis": [0, 1, 0], "angle": 180}},
                         {"scale": 0.35}],
            "bsdf": {"type": "twosided",
                     "bsdf": {"type": "roughplastic", "alpha": 0.3}}}
    elif name == "checkerboard":
        d["floor"]["bsdf"] = {"type": "diffuse", "reflectance": {
            "type": "checkerboard",
            "color0": {"type": "rgb", "value": [0.9, 0.05, 0.05]},
            "color1": {"type": "rgb", "value": [0.05, 0.9, 0.05]},
            "to_uv": {"translate": [-0.3, 0.2, 0.0],
                      "scale": [3.0, 3.0, 1.0]}}}
    elif name == "bumpmap":
        d["floor"]["bsdf"] = {
            "type": "bumpmap", "scale": 0.02,
            "map": {"type": "checkerboard", "color0": 0.0, "color1": 1.0,
                    "to_uv": {"scale": [4.0, 4.0, 1.0]}},
            "bsdf": _diffuse([0.8, 0.8, 0.8])}
        d["back"]["bsdf"] = {
            "type": "normalmap",
            "normalmap": {"type": "checkerboard",
                          "color0": {"type": "rgb", "value": [0.5, 0.5, 1.0]},
                          "color1": {"type": "rgb", "value": [0.8, 0.6, 0.8]},
                          "to_uv": {"scale": [3.0, 3.0, 1.0]}},
            "bsdf": {"type": "roughplastic", "alpha": 0.25}}
    elif name == "normalmap":
        d["floor"]["bsdf"] = {
            "type": "normalmap",
            "normalmap": {"type": "checkerboard",
                          "color0": {"type": "rgb", "value": [0.3, 0.5, 0.9]},
                          "color1": {"type": "rgb", "value": [0.7, 0.4, 0.9]},
                          "to_uv": {"scale": [2.0, 2.0, 1.0]}},
            "bsdf": _diffuse([0.8, 0.8, 0.8])}
    elif name == "angulararea":
        d = room(dict(ROOM_EMITTERS["angulararea"]), 12, 48)
    elif name == "emissive_sphere":
        d = with_sphere(d, 48, 48)
        d["small-box"]["bsdf"] = {"type": "roughconductor", "material": "Au",
                                  "alpha": 0.25}
        d["small-box"]["emitter"] = {
            "type": "area", "radiance": {"type": "rgb",
                                         "value": [0.8, 0.5, 0.2]}}
    elif name == "nlos_rough_wall":
        d = nlos_scene()
        d["relay_wall"]["bsdf"] = {"type": "roughconductor", "material": "Al",
                                   "alpha": 0.3}

        def run(scene, multipass):
            pkg.nlos.focus_emitter_at_relay_wall_pixel([2.0, 2.0], scene)
            return pkg.render(scene, spp=16, seed=0, return_stats=True,
                              **({"max_lanes": 4 * 16} if multipass else {}))
    elif name == "flagship":
        d = materials_cbox(pkg, 12, 12, 120, 6)
    else:
        raise KeyError(name)
    return d, run


# --------------------------------------------------------------------------
# Differentiable rendering: copies of the JAX tests' scene dicts (those test
# modules import the JAX package, which chip_smoke.py must not load)
# --------------------------------------------------------------------------

def gradients_cbox(pkg) -> dict:
    """The ``gradients`` golden's scene (golden_configs.gradients):
    small_cbox 8 x 8, 100 bins of 0.2 from OPL 0, depth 4, no Russian
    roulette; its render_backward takes ones for both adjoint images at
    ``GRADIENTS``."""
    d = small_cbox(pkg, 8, 8, 100, 4)
    d["sensor"]["film"]["start_opl"] = 0.0
    d["sensor"]["film"]["bin_width_opl"] = 0.2
    d["integrator"]["rr_depth"] = 99
    return d


GRADIENTS = dict(spp=8, seed=0)


def grad_cbox(pkg, w=16, h=16, bins=300, max_depth=4) -> dict:
    """test_grad.py's box: a full-coverage time window (bins of 0.1 from
    OPL 0) and no Russian roulette, so the estimator is smooth in the
    parameters; rendered at ``GRAD_SPP``."""
    d = pkg.cornell_box()
    f = d["sensor"]["film"]
    f.update(width=w, height=h, temporal_bins=bins, start_opl=0.0,
             bin_width_opl=0.1)
    d["integrator"]["max_depth"] = max_depth
    d["integrator"]["rr_depth"] = 99
    return d


GRAD_SPP = 32


def flat_scene(light="point", bins=100, tfilter="gaussian") -> dict:
    """test_geomgrad.py's flip-free geometry-gradient scene: a large floor
    filling the 16 x 16 view and a point light or an area light the
    contributing rays never hit (``discard_direct_light`` for the area
    light), no Russian roulette, a gaussian temporal filter (the arrival
    bins move smoothly with the hit distance); spp 64."""
    d = {
        "type": "scene",
        "integrator": {
            "type": "transient_path", "max_depth": 2, "rr_depth": 99,
            "temporal_filter": tfilter,
            "discard_direct_light": light == "area",
        },
        "floor": {
            "type": "rectangle", "to_world": {"scale": 5.0},
            "bsdf": {"type": "diffuse",
                     "reflectance": {"type": "rgb",
                                     "value": [0.7, 0.5, 0.3]}},
        },
        "sensor": {
            "type": "perspective", "fov": 40,
            "to_world": {"look_at": {"origin": [0, 0, 3],
                                     "target": [0, 0, 0], "up": [0, 1, 0]}},
            "film": {"type": "transient_hdr_film", "width": 16,
                     "height": 16, "temporal_bins": bins, "start_opl": 0.0,
                     "bin_width_opl": 0.1},
            "sampler": {"type": "independent", "sample_count": 64},
        },
    }
    if light == "point":
        d["light"] = {"type": "point",
                      "to_world": {"translate": [0.6, 0.4, 2.0]},
                      "intensity": {"type": "rgb",
                                    "value": [10.0, 10.0, 10.0]}}
    else:
        d["light"] = {
            "type": "rectangle",
            "to_world": {"translate": [0.5, 0.3, 2.0],
                         "rotate": {"axis": [1, 0, 0], "angle": 180},
                         "scale": 0.3},
            "emitter": {"type": "area",
                        "radiance": {"type": "rgb",
                                     "value": [8.0, 8.0, 8.0]}}}
    return d


def flat_adjoint(kind: str, bins: int = 100):
    """test_geomgrad.py's adjoint images of ``flat_scene``: "steady" (ones
    on the steady image), "rand" (uniform [0, 1) on the transient, seed 0)
    or "arrival" (bin index b on bin b) -> (grad_steady, grad_transient)."""
    if kind == "steady":
        return np.ones((16, 16, 3), np.float32), None
    if kind == "rand":
        return None, np.random.RandomState(0).uniform(
            0.0, 1.0, (16, 16, bins, 3)).astype(np.float32)
    return None, np.broadcast_to(
        np.arange(bins, dtype=np.float32)[None, None, :, None],
        (16, 16, bins, 3)).copy()


# (light, adjoint, traverse paths whose gradients are compared)
GEOMETRY_CASES = {
    "floor_point_steady": ("point", "steady", ("floor.to_world.translate",
                                              "floor.to_world.rotate",
                                              "light.position")),
    "point_rand": ("point", "rand", ("floor.to_world.translate",
                                     "floor.to_world.rotate",
                                     "light.position")),
    "point_arrival": ("point", "arrival", ("light.position",
                                           "floor.to_world.translate")),
    "area_rand": ("area", "rand", ("light.to_world.translate",
                                   "light.to_world.rotate",
                                   "floor.to_world.translate")),
}


def diffparams_cbox(pkg, res=16, max_depth=4) -> dict:
    """test_diffparams.py's box: res x res, 200 bins of 0.1 from OPL 0, no
    Russian roulette."""
    d = pkg.cornell_box()
    d["sensor"]["film"].update(width=res, height=res, temporal_bins=200,
                               start_opl=0.0, bin_width_opl=0.1)
    d["integrator"]["max_depth"] = max_depth
    d["integrator"]["rr_depth"] = 99
    return d


GGX_SMALL_BOX = {"type": "roughconductor", "material": "Al", "alpha": 0.3}
CHECKER_FLOOR = {"type": "diffuse", "reflectance": {
    "type": "checkerboard",
    "color0": {"type": "rgb", "value": [0.7, 0.3, 0.2]},
    "color1": {"type": "rgb", "value": [0.2, 0.6, 0.7]}}}


def diff_case(pkg, name: str) -> dict:
    """The GGX-alpha ("ggx": the small box a rough aluminium of alpha 0.3,
    12 x 12) and texel ("texels": a checkerboard floor, 8 x 8, depth 3)
    scenes of test_diffparams.py."""
    if name == "ggx":
        d = diffparams_cbox(pkg, res=12)
        d["small-box"]["bsdf"] = dict(GGX_SMALL_BOX)
    elif name == "texels":
        d = diffparams_cbox(pkg, res=8, max_depth=3)
        d["floor"]["bsdf"] = dict(CHECKER_FLOOR)
    else:
        raise KeyError(name)
    return d


def safety_scene(bsdf: dict, max_depth=3) -> dict:
    """test_grad_safety.py's scene: a 3 x 3 floor of ``bsdf`` under a small
    area light, 8 x 8, 40 bins of 0.4 from OPL 0, no Russian roulette."""
    return {
        "type": "scene",
        "integrator": {"type": "transient_path", "max_depth": max_depth,
                       "rr_depth": 99},
        "floor": {"type": "rectangle", "to_world": {"scale": 3.0},
                  "bsdf": bsdf},
        "light": {"type": "rectangle",
                  "to_world": {"translate": [0.4, 0.2, 2.0],
                               "rotate": {"axis": [1, 0, 0], "angle": 180},
                               "scale": 0.3},
                  "emitter": {"type": "area", "radiance": 6.0}},
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": {"look_at": {"origin": [0, 0, 3],
                                            "target": [0, 0, 0],
                                            "up": [0, 1, 0]}},
                   "film": {"type": "transient_hdr_film", "width": 8,
                            "height": 8, "temporal_bins": 40,
                            "start_opl": 0.0, "bin_width_opl": 0.4}},
    }


SAFETY_BSDFS = {  # test_grad_safety.BSDFS
    "diffuse": {"type": "diffuse", "reflectance": 0.6},
    "roughconductor": {"type": "roughconductor", "alpha": 0.1},
    "roughplastic": {"type": "roughplastic", "alpha": 0.1,
                     "diffuse_reflectance": 0.5},
    "roughplastic_tex": {"type": "roughplastic", "alpha": 0.1,
                         "diffuse_reflectance": {"type": "checkerboard"}},
    "conductor": {"type": "conductor"},
    "dielectric": {"type": "dielectric"},
    "twosided_rc": {"type": "twosided",
                    "nested": {"type": "roughconductor", "alpha": 0.1}},
}


def time_window_cbox(pkg, res: int, bins: int) -> dict:
    """The diff_transient examples' box (optimize_reflectance.py,
    forward_time_gradients.py): res x res, ``bins`` bins covering OPL 0-8,
    depth 4."""
    d = pkg.cornell_box()
    d["sensor"]["film"].update(width=res, height=res, temporal_bins=bins,
                               start_opl=0.0, bin_width_opl=8.0 / bins)
    d["integrator"]["max_depth"] = 4
    return d


OPTIMIZE_REFLECTANCE = dict(res=64, bins=200, spp=256, lr=5e-2,
                            target_seed=7, start=(0.15, 0.6, 0.25))
FORWARD_TIME_GRADIENTS = dict(res=128, bins=300, spp=512)


# --------------------------------------------------------------------------
# Volumetric rendering (transient_prbvolpath)
# --------------------------------------------------------------------------

def vol_cbox(pkg, sigma_t=None, albedo=0.9, g=0.1, w=8, h=8, bins=100,
             max_depth=5, lift=0.0, rr_depth=99) -> dict:
    """tests/test_volumetric.py's ``vol_cbox``: the box with the
    ``transient_prbvolpath`` integrator and, where ``sigma_t`` is given,
    fog of that extinction, ``albedo`` and HG ``g`` in the small box
    behind a null BSDF (the reference tutorial's scene).  ``lift`` raises
    the small box off the floor, with which its bottom is coplanar."""
    d = pkg.cornell_box()
    d["sensor"]["film"].update(width=w, height=h, temporal_bins=bins)
    d["integrator"] = {"type": "transient_prbvolpath",
                       "max_depth": max_depth, "rr_depth": rr_depth}
    d["small-box"]["to_world"]["translate"][1] += lift
    if sigma_t is not None:
        d["small-box"]["bsdf"] = {"type": "null"}
        d["small-box"]["medium"] = {
            "type": "homogeneous", "sigma_t": sigma_t,
            "albedo": {"type": "rgb", "value": [albedo] * 3},
            "phase": {"type": "hg", "g": g}}
    return d


def hetero_medium(density, scale=3.0, albedo=0.9, g=0.1,
                  to_world=None) -> dict:
    """test_volumetric's ``_hetero_cbox`` medium: a ``heterogeneous``
    medium of an inline density grid, in a dict with its ``to_world``
    where it has one (a ``gridvolume`` dict names a ``.vol`` file)."""
    med = {"type": "heterogeneous", "scale": scale,
           "density": np.asarray(density, np.float32),
           "albedo": {"type": "rgb", "value": [albedo] * 3},
           "phase": {"type": "hg", "g": g}}
    if to_world is not None:
        med["density"] = {"data": med["density"], "to_world": to_world}
    return med


# a grid placed over the small box, axis-aligned ([0, 1]^3 -> world)
GRID_TO_WORLD = {"translate": [0.03, -1.0, 0.07], "scale": 0.62}
VOL_LIFT = 0.002  # the per-sample cases' small box, 2 mm off the floor


def grid_density(n: int = 8, seed: int = 5) -> np.ndarray:
    """A seeded random (n, n, n) density in [0.2, 1.8)."""
    return (0.2 + 1.6 * np.random.default_rng(seed).random(
        (n, n, n))).astype(np.float32)


VOL_CASES = ("fog", "absorbing", "unwarp", "null_box", "rr", "grid_constant",
             "grid_random", "crop_filters")


def vol_case(pkg, name: str) -> tuple[dict, dict]:
    """Configuration ``name`` of VOL_CASES -> (scene dict, render kwargs).
    An 8 x 8 box of 100 bins, depth 5, the small box lifted by
    ``VOL_LIFT`` so that no path meets its coplanar bottom: fog (sigma_t
    2, albedo 0.9, g 0.3), absorbing fog (sigma_t 5, albedo 0),
    ``camera_unwarp`` (a window of 0.02 from OPL 0), the null box with no
    medium, fog with Russian roulette from depth 2 over two passes, a
    constant 4^3 grid (scale 3, which the JAX loader reads as sigma_t 1),
    the seeded 8^3 grid with ``GRID_TO_WORLD``, and the fog through a crop
    window with the gaussian rfilter and temporal filter; "phasor", the
    fog into the phasor golden's film (8 x 8, 400 bins; a mono variant),
    is no member of VOL_CASES."""
    kw = dict(spp=4, seed=1)
    if name in ("phasor", "crop_filters"):
        d, kw = vol_case(pkg, "fog")
        if name == "phasor":
            d["sensor"]["film"] = {
                "type": "phasor_hdr_film", "width": 8, "height": 8,
                "temporal_bins": 400, "bin_width_opl": 0.02,
                "start_opl": 3.5, "wl_mean": 0.5, "wl_sigma": 0.5}
        else:
            d["sensor"]["film"].update(
                crop_offset_x=2, crop_offset_y=1, crop_width=5,
                crop_height=6, rfilter={"type": "gaussian", "stddev": 0.6})
            d["integrator"].update(temporal_filter="gaussian",
                                   gaussian_stddev=1.5)
        return d, kw
    if name == "null_box":
        d = vol_cbox(pkg, lift=VOL_LIFT)
        d["small-box"]["bsdf"] = {"type": "null"}
        return d, kw
    if name.startswith("grid"):
        d = vol_cbox(pkg, 1.0, lift=VOL_LIFT)
        d["small-box"]["medium"] = (
            hetero_medium(np.ones((4, 4, 4)), scale=3.0)
            if name == "grid_constant"
            else hetero_medium(grid_density(), scale=2.5, albedo=0.7,
                               to_world=GRID_TO_WORLD))
        return d, kw
    sig, alb, g = {"absorbing": (5.0, 0.0, 0.1), "unwarp": (1.0, 0.9, 0.1)
                   }.get(name, (2.0, 0.9, 0.3))
    d = vol_cbox(pkg, sig, alb, g, lift=VOL_LIFT,
                 rr_depth=2 if name == "rr" else 99)
    if name == "unwarp":
        d["integrator"]["camera_unwarp"] = True
        d["sensor"]["film"].update(start_opl=0.0, bin_width_opl=0.02)
    if name == "rr":
        kw = dict(spp=6, seed=2, max_lanes=3 * 64)
    return d, kw


# the elements of the volumetric golden (8 x 8, 120 bins: 192 steady and
# 23,040 transient elements) out of test_golden's rule between the port
# on the CPU and the JAX package's golden: paths in the fog leave the
# small box through its bottom, coplanar with the floor, where XLA's
# FMA-contracted hit distance and the port's separately rounded one pick
# different triangles (ROADMAP queue 3); with the box lifted 2 mm none is
# out.  Those paths change the ray count by 0.15 %.
VOLUMETRIC_TIES = {"steady": 12, "transient": 3}
VOLUMETRIC_TIE_RAYS = 2e-3


def vol_grad_case(pkg, name: str) -> dict:
    """The differentiated volumetric configurations: fog, test_prb_vol.py's
    ``_scene`` (sigma_t 2, albedo 0.8, g 0.2); grid, its heterogeneous
    replay case (a 4^3 density of 0.8 around a 2.0 core, scale 2.5,
    albedo 0.7).  8 x 8, 100 bins of 0.6 from OPL 0, depth 5, the small
    box 2 mm off the floor."""
    if name == "grid":
        density = np.full((4, 4, 4), 0.8, np.float32)
        density[1:3, 1:3, 1:3] = 2.0
        d = vol_cbox(pkg, 1.0, lift=VOL_LIFT)
        d["small-box"]["medium"] = hetero_medium(density, scale=2.5,
                                                 albedo=0.7)
    else:
        d = vol_cbox(pkg, 2.0, 0.8, 0.2, lift=VOL_LIFT)
    d["sensor"]["film"].update(start_opl=0.0, bin_width_opl=0.6)
    return d


# the reference tutorial (examples/transient/render_cbox_volumetric.py:
# 25-38): 128 x 128, 400 bins, depth 64, spp 512, fog of sigma_t 1.8,
# albedo 0.9, HG g 0.3 in the small box
TUTORIAL = dict(res=128, bins=400, max_depth=64, spp=512)
# [0, 1]^3 onto the small box of cornell_box() (its to_world after a map
# of the unit cube onto [-1, 1]^3)
GRID_IN_SMALL_BOX = [{"translate": [0.335, -0.7, 0.38]},
                     {"rotate": {"axis": [0, 1, 0], "angle": -17}},
                     {"scale": 0.3}, {"translate": [-1.0, -1.0, -1.0]},
                     {"scale": 2.0}]


def tutorial_cbox(pkg, res=TUTORIAL["res"], bins=TUTORIAL["bins"],
                  max_depth=TUTORIAL["max_depth"]) -> dict:
    """The volumetric tutorial's scene (default rr_depth 5)."""
    d = pkg.cornell_box()
    d["sensor"]["film"].update(width=res, height=res, temporal_bins=bins)
    d["integrator"] = {"type": "transient_prbvolpath", "max_depth": max_depth}
    d["small-box"]["bsdf"] = {"type": "null"}
    d["small-box"]["medium"] = {
        "type": "homogeneous", "sigma_t": 1.8,
        "albedo": {"type": "rgb", "value": [0.9, 0.9, 0.9]},
        "phase": {"type": "hg", "g": 0.3}}
    return d


def tutorial_grid(pkg, n=64, seed=0, max_depth=16, **kw) -> dict:
    """The tutorial's scene with a seeded random n^3 density (in [0.2,
    1.8)) filling the small box, scale 3: the grid given as ``sigma_t``,
    as Mitsuba gives it, so that the loaders read the scale as sigma_t."""
    d = tutorial_cbox(pkg, max_depth=max_depth, **kw)
    d["small-box"]["medium"] = {
        "type": "heterogeneous", "scale": 3.0,
        "sigma_t": {"data": grid_density(n, seed),
                    "to_world": GRID_IN_SMALL_BOX},
        "albedo": {"type": "rgb", "value": [0.9, 0.9, 0.9]},
        "phase": {"type": "hg", "g": 0.3}}
    return d


# --------------------------------------------------------------------------
# Polarized and spectral variants
# --------------------------------------------------------------------------

class with_variant:
    """``with with_variant(pkg, name):`` sets the package's variant and
    restores the one before on exit (loaded scenes keep theirs)."""

    def __init__(self, pkg, name: str):
        self.pkg, self.name = pkg, name

    def __enter__(self):
        self.old = self.pkg.variant()
        self.pkg.set_variant(self.name)
        return self

    def __exit__(self, *exc):
        self.pkg.set_variant(self.old)
        return False


# the reference's polarized cbox (examples/polarization/
# render_cbox_polarized.py:27-41, BASELINE.md:21): mono_polarized, 256 x
# 256, 400 bins, depth 5, a gold GGX small box of alpha 0.3; spp 4096
GOLD_GGX_BOX = {"type": "roughconductor", "material": "Au",
                "distribution": "ggx", "alpha": 0.3}


def polarized_cbox(pkg, res=256, bins=400, max_depth=5) -> dict:
    """The polarized cbox's scene (load it under ``mono_polarized``)."""
    d = small_cbox(pkg, res, res, bins, max_depth)
    d["small-box"]["bsdf"] = dict(GOLD_GGX_BOX)
    return d


# the variant configurations held per sample against the JAX package and
# card against CPU: each variant with a gold GGX small box (a regen and a
# multi-pass render for the polarized ones; the spectral ones render only
# multi-pass, as in the JAX package)
VARIANT_CASES = ("mono_polarized", "rgb_polarized", "spectral",
                 "spectral_polarized")
VARIANT_REGEN = ("mono_polarized", "rgb_polarized")


def variant_case(pkg, name: str, w=8, bins=40, max_depth=4) -> dict:
    """The scene of configuration ``name`` (a variant of VARIANT_CASES):
    an 8 x 8 box of 40 bins, depth 4, with a gold GGX small box."""
    d = small_cbox(pkg, w, w, bins, max_depth)
    d["small-box"]["bsdf"] = dict(GOLD_GGX_BOX)
    return d


def variant_render(pkg, name: str, multipass: bool, device=None):
    """Load configuration ``name`` under its variant and render it: the
    regen render at spp 8, seed 0, or the multi-pass render
    (``regenerate=False``) at spp 4, seed 1.  -> (steady, transient,
    stats)."""
    kw = {} if device is None else {"device": device}
    with with_variant(pkg, name):
        scene = pkg.load_dict(variant_case(pkg, name), **kw)
    if multipass:
        return pkg.render(scene, spp=4, seed=1, regenerate=False,
                          return_stats=True)
    return pkg.render(scene, spp=8, seed=0, return_stats=True)


DOP_Q95_MAX = 1.05  # tests/test_polarized.py:46-48, Monte Carlo noise allowed


def stokes_checks(steady: np.ndarray) -> dict:
    """Physical Stokes vectors of a (..., 4) image: the 0.95 quantile of
    the degree of polarization sqrt(Q^2 + U^2 + V^2) / I over the pixels
    with I > 1e-3 (at most DOP_Q95_MAX), and the share (|Q| + |U|) / I
    summed over the image."""
    I, Q, U, V = (steady[..., k] for k in range(4))
    mask = I > 1e-3
    dop = np.sqrt(Q * Q + U * U + V * V)[mask] / I[mask]
    return {"dop_q95": float(np.quantile(dop, 0.95)) if mask.any() else 0.0,
            "qu_share": float((np.abs(Q) + np.abs(U)).sum()
                              / max(float(np.abs(I).sum()), 1e-30))}


# --------------------------------------------------------------------------
# The variants through NLOS, volumetric and differentiable rendering
# --------------------------------------------------------------------------

GOLD_WALL = {"type": "roughconductor", "material": "Au", "alpha": 0.15}
WHITE = {"type": "diffuse", "reflectance": {"type": "rgb", "value": 1.0}}

# the variant NLOS configurations held per sample against the JAX package
# and card against CPU
VARIANT_NLOS_CASES = ("pol_gold", "pol_diffuse", "pol_hg_rr",
                      "pol_plain_nee", "pol_exhaustive", "pol_scan_confocal",
                      "rgb_pol_confocal", "spectral", "spectral_plain_nee",
                      "spectral_polarized")


def variant_nlos_case(pkg, name: str):
    """Configuration ``name`` of VARIANT_NLOS_CASES -> (variant, scene
    dict, run(scene) -> (steady, transient, stats)).

    pol_gold: tests/test_polarized.py:123's capture (mono_polarized, a
    4x4 scan of 200 bins, a rough gold relay wall of alpha 0.15, laser at
    pixel (2, 2), spp 32); pol_diffuse: its intensity case (:142, the
    diffuse wall, spp 48); pol_hg_rr: the gold wall with HG mixed with
    BSDF sampling by RR from depth 1 (spp 16, seed 2); pol_plain_nee:
    rgb_polarized, NEE toward a point laser without laser sampling, so
    that the emitter-hit term stays (spp 16, seed 1); pol_exhaustive: the
    exhaustive 2x2 x 2x2 capture of :164 (spp 8), which the variants take
    point by point; pol_scan_confocal: tests/test_nlos.py:404's
    ``scan_confocal`` over 2x2 (spp 256); rgb_pol_confocal: a 1x1
    confocal capture over a 3x3 scan with the gold wall under
    rgb_polarized (spp 32); spectral: tests/test_spectral.py:74's
    unfocused 4x4 capture (spp 16); spectral_plain_nee: the plain-NEE
    scene under spectral; spectral_polarized: :178's 2x2 capture focused
    at (1, 1), spp 8."""
    import importlib

    def focused(pixel, **kw):
        def run(scene):
            pkg.nlos.focus_emitter_at_relay_wall_pixel(pixel, scene)
            return pkg.render(scene, return_stats=True, **kw)
        return run

    def plain(**kw):
        def run(scene):
            return pkg.render(scene, return_stats=True, **kw)
        return run

    d = nlos_scene(sx=4, sy=4, bins=200, spp=32)
    if name in ("pol_gold", "pol_hg_rr"):
        d["relay_wall"]["bsdf"] = dict(GOLD_WALL)
        run = focused([2.0, 2.0], spp=32, seed=0)
        if name == "pol_hg_rr":
            d["integrator"].update(
                nlos_hidden_geometry_sampling_do_rroulette=True, rr_depth=1)
            run = focused([1.0, 2.0], spp=16, seed=2)
        return "mono_polarized", d, run
    if name == "pol_diffuse":
        d["relay_wall"]["bsdf"] = dict(WHITE)
        return "mono_polarized", d, focused([2.0, 2.0], spp=48, seed=0)
    if name in ("pol_plain_nee", "spectral_plain_nee"):
        d = nlos_scene(laser_sampling=False, bins=200)
        d["laser"] = {"type": "point",
                      "to_world": {"translate": [-0.5, 0.0, 0.25]},
                      "intensity": {"type": "rgb", "value": [1.0, 2.0, 3.0]}}
        d["relay_wall"]["bsdf"] = dict(GOLD_WALL)
        return ("rgb_polarized" if name == "pol_plain_nee" else "spectral",
                d, plain(spp=16, seed=1))
    if name == "pol_exhaustive":
        d = nlos_exhaustive(nlos_scene(sx=2, sy=2, bins=200, spp=8), 2, 2)
        mod = importlib.import_module(pkg.__name__ + ".integrators.nlos_path")

        def run(scene):
            return mod.render_nlos_exhaustive(scene, 8, seed=0,
                                              return_stats=True)
        return "mono_polarized", d, run
    if name == "pol_scan_confocal":
        d = nlos_confocal(nlos_scene(sx=1, sy=1), 2, 2)

        def run(scene):
            return pkg.nlos.scan_confocal(scene, spp=256, seed=0,
                                          return_stats=True)
        return "mono_polarized", d, run
    if name == "rgb_pol_confocal":
        d = nlos_confocal(nlos_scene(sx=1, sy=1, bins=200), 3, 3)
        d["relay_wall"]["bsdf"] = dict(GOLD_WALL)
        return "rgb_polarized", d, focused([1.0, 2.0], spp=32, seed=3)
    if name == "spectral":
        return "spectral", nlos_scene(sx=4, sy=4, bins=200, spp=16), plain(
            spp=16, seed=0)
    if name == "spectral_polarized":
        return ("spectral_polarized", nlos_scene(sx=2, sy=2, spp=8),
                focused([1.0, 1.0], spp=8, seed=0))
    raise KeyError(name)


# the variant volumetric configurations: the small box 2 mm off the floor
# (VOL_LIFT), so that no path meets its coplanar bottom
VARIANT_VOL_CASES = ("mono_polarized", "spectral", "rgb_polarized",
                     "spectral_polarized", "spectral_grid", "pol_grid")


def variant_vol_case(pkg, name: str):
    """Configuration ``name`` of VARIANT_VOL_CASES -> (variant, scene dict,
    render kwargs).  mono_polarized: tests/test_volumetric.py:159's fog
    (12x12, sigma_t 2, albedo 0.8, g 0.3, depth 5, spp 48); spectral:
    tests/test_spectral.py:101's (sigma_t 1.5, albedo 0.9, g 0.2, spp
    48); rgb_polarized: test_prb_vol.py:111's fog (sigma_t 2, albedo 0.8,
    g 0.2, depth 8, spp 16) with a gold GGX large box; spectral_polarized: tests/test_spectral.py:
    178's (4x4, 32 bins, depth 4, sigma_t 1, spp 8); spectral_grid and
    pol_grid (mono_polarized): ``vol_case``'s seeded 8^3 grid."""
    if name == "mono_polarized":
        return name, vol_cbox(pkg, 2.0, 0.8, 0.3, w=12, h=12, max_depth=5,
                              lift=VOL_LIFT), dict(spp=48, seed=0)
    if name == "spectral":
        return name, vol_cbox(pkg, 1.5, 0.9, 0.2, lift=VOL_LIFT), dict(
            spp=48, seed=0)
    if name == "rgb_polarized":
        d = vol_cbox(pkg, 2.0, 0.8, 0.2, max_depth=8, lift=VOL_LIFT)
        d["large-box"]["bsdf"] = dict(GOLD_GGX_BOX)
        return name, d, dict(spp=16, seed=0)
    if name == "spectral_polarized":
        return name, vol_cbox(pkg, 1.0, 0.8, 0.2, w=4, h=4, bins=32,
                              max_depth=4, lift=VOL_LIFT), dict(spp=8, seed=0)
    if name in ("spectral_grid", "pol_grid"):
        d, kw = vol_case(pkg, "grid_random")
        return ("spectral" if name == "spectral_grid" else "mono_polarized",
                d, kw)
    raise KeyError(name)


# the variant gradient configurations (tables held within 1e-4 of each
# table's largest value against the JAX package and card against CPU)
VARIANT_GRAD_CASES = ("pol_cbox", "pol_nlos", "pol_fog", "spectral_fog",
                      "spectral_cbox", "pol_vol_steady")


def variant_grad_case(pkg, name: str):
    """Configuration ``name`` of VARIANT_GRAD_CASES -> (variant, scene
    dict, call(pkg, scene) -> gradients).  pol_cbox:
    tests/test_polarized.py:188 (mono_polarized 8x8 box of 100 bins of
    0.1, depth 3, rr_depth 99, the gold GGX small box, the S0 rows of the
    transient as the adjoint, spp 16); pol_nlos: tests/test_fullad.py:92
    (the 2x2 capture, rr_depth 99, laser at (1, 1), S0 adjoint, spp 16);
    pol_fog: tests/test_prb_vol.py:111 (rgb_polarized fog of sigma_t 2,
    albedo 0.8, g 0.2, depth 8, bins of 0.96, the S0 rows, spp 16);
    spectral_fog: the fog at depth 5 under spectral through the PRB
    replay (a seeded random transient adjoint, spp 8); spectral_cbox: the
    8x8 box of 40 bins, depth 3, under spectral (full AD, a seeded random
    transient adjoint, spp 8); pol_vol_steady: tests/test_volumetric.py:
    196 (mono_polarized fog of sigma_t 1, 8x8, depth 3, the S0 steady
    adjoint, spp 4)."""
    def s0(channels, steady=False):
        def call(pkg, scene):
            fc = scene.sensors[0].film
            shape = ((fc.height, fc.width) if steady
                     else (fc.height, fc.width, fc.temporal_bins))
            g = np.zeros(shape + (channels,), np.float32)
            g[..., :channels // 4] = 1.0
            adj = (g, None) if steady else (None, g)
            return pkg.render_backward(scene, adj, spp=spp, seed=0)
        return call

    def rand(channels, spp_):
        def call(pkg, scene):
            fc = scene.sensors[0].film
            g = np.random.default_rng(4).random(
                (fc.height, fc.width, fc.temporal_bins, channels)).astype(
                    np.float32)
            return pkg.render_backward(scene, (None, g), spp=spp_, seed=0)
        return call

    spp = 16
    if name == "pol_cbox":
        d = small_cbox(pkg, 8, 8, 100, 3)
        d["small-box"]["bsdf"] = dict(GOLD_GGX_BOX)
        d["sensor"]["film"].update(start_opl=0.0, bin_width_opl=0.1)
        d["integrator"]["rr_depth"] = 99
        return "mono_polarized", d, s0(4)
    if name == "pol_nlos":
        d = nlos_scene(sx=2, sy=2)
        d["integrator"]["rr_depth"] = 99
        inner = s0(4)

        def call(pkg, scene):
            pkg.nlos.focus_emitter_at_relay_wall_pixel([1.0, 1.0], scene)
            return inner(pkg, scene)
        return "mono_polarized", d, call
    if name == "pol_fog":
        d = vol_cbox(pkg, 2.0, 0.8, 0.2, max_depth=8, lift=VOL_LIFT)
        d["sensor"]["film"].update(start_opl=0.0, bin_width_opl=0.96)
        return "rgb_polarized", d, s0(12)
    if name == "spectral_fog":
        d = vol_cbox(pkg, 2.0, 0.8, 0.2, lift=VOL_LIFT)
        d["sensor"]["film"].update(start_opl=0.0, bin_width_opl=0.6)
        return "spectral", d, rand(3, 8)
    if name == "spectral_cbox":
        return "spectral", small_cbox(pkg, 8, 8, 40, 3), rand(3, 8)
    if name == "pol_vol_steady":
        spp = 4
        return ("mono_polarized", vol_cbox(pkg, 1.0, max_depth=3,
                                           lift=VOL_LIFT), s0(4, True))
    raise KeyError(name)


def run_variant_case(pkg, kind: str, name: str, device=None):
    """Load configuration ``name`` of the variant ``kind`` ("nlos", "vol"
    or "grad") under its variant and run it on ``device``: (steady,
    transient, stats) for the renders, the gradient dict for "grad"."""
    make = {"nlos": variant_nlos_case, "vol": variant_vol_case,
            "grad": variant_grad_case}[kind]
    variant, desc, run = make(pkg, name)
    import copy

    with with_variant(pkg, variant):
        scene = pkg.load_dict(copy.deepcopy(desc),
                              **({} if device is None else {"device": device}))
    if kind == "vol":
        return pkg.render(scene, return_stats=True, **run)
    return run(pkg, scene) if kind == "grad" else run(scene)


# the film channels of each variant
FILM_CHANNELS = {"mono": 1, "rgb": 3, "mono_polarized": 4, "rgb_polarized": 12,
                 "spectral": 3, "spectral_polarized": 12}
# the differentiation routes of both packages: (module under the package,
# function, route name)
DIFF_ROUTES = ((".render", "render_backward_volpath", "prb_vol"),
               (".render", "_backward_pass", "prb"),
               (".integrators.fullad", "render_backward_fullad", "fullad"),
               (".render", "_forward_pass", "prb_forward"),
               (".render", "_forward_pass_jvp", "jvp"))


class Routed(Exception):
    """Raised by a route that :func:`spy_routes` stops."""


def spy_routes(monkeypatch, pkg, stop: bool = False) -> list:
    """Wrap ``pkg``'s differentiation routes (``DIFF_ROUTES``) so that each
    call appends the route's name to the returned list, then goes on, or
    with ``stop`` raises :class:`Routed` (no gradient is computed)."""
    import importlib

    seen = []

    def wrap(inner, name):
        def f(*a, **k):
            seen.append(name)
            if stop:
                raise Routed(name)
            return inner(*a, **k)
        return f

    for mod, fn, name in DIFF_ROUTES:
        m = importlib.import_module(pkg.__name__ + mod)
        monkeypatch.setattr(m, fn, wrap(getattr(m, fn), name))
    return seen
