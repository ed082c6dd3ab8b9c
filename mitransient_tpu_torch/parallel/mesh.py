"""Multi-device rendering over a mesh of shards (counterpart of
``mitransient_tpu/parallel/mesh.py``).

The spp axis is the data-parallel axis, as in the JAX package: every shard
renders the whole film with its own counter-based sample streams (stream =
pass * n_shards + global shard index) into a fresh film partial a pass;
the partials, ray counts and parameter gradients are summed over the
shards (``distributed.reduce_shards``: this process's shards in index
order, then ``dist.all_reduce`` across processes) and the passes are added
in order.  Scene, camera and NLOS-context tables are copied to each
shard's device (``distributed.replicate``).

Each shard's pass is the single-device render's own pass function, called
with the sharded stream: ``render._perspective_pass`` (surface and
volumetric), ``nlos_path._nlos_pass`` (single and confocal captures),
``fullad.fullad_grads`` and ``render._backward_pass`` (the PRB replay).
The exhaustive NLOS capture shards its laser axis instead
(:func:`render_nlos_exhaustive_sharded`).

Determinism: a render over N shards draws the same samples whatever the
layout of those shards over processes; with one shard and one pass a pass
it draws the single-device multi-pass render's samples.  The sums run in
another order than the single-device render's in-place film (fresh films
a pass, added after the reduction, as the JAX package adds them), so the
two agree per sample within float32 rounding, not bit for bit.
"""
from __future__ import annotations

import torch

from ..film.transient_film import (
    TransientFilmState,
    develop,
    develop_any,
    film_init,
    film_init_any,
    sum_rows,
)
from ..integrators import DEFAULT_MAX_LANES, _split_spp
from ..integrators.fullad import EXHAUSTIVE_REFUSAL, fullad_grads
from ..integrators.nlos_path import (
    LANE_LASER_PAIRS,
    ExhaustiveLaser,
    _check_exhaustive,
    _nlos_pass,
    _pixel_uv,
    can_skip_le,
    exhaustive_laser_targets,
    film_channels,
    prepare_exhaustive_lasers,
    prepare_nlos,
    sample_nlos_exhaustive_primal,
    sample_nlos_rays,
)
from ..integrators.prb import adjoint_images, grads_to_named
from ..core.rng import Sampler, pass_keys
from ..ops.bvh import BVH_MODE
from ..render import _backward_pass, _perspective_pass, _refuse_film
from ..scene.scene import primal_sd
from ..scene.schema import Scene
from ..sensors.perspective import build_camera
from .distributed import (
    Mesh,
    mesh_of,
    reduce_shards,
    replicate,
    tree_add,
    tree_map,
)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over ``devices`` (by default this process's CUDA devices;
    an error where there is none), the first ``n_devices`` of them.  A
    device may repeat: ``["cpu"] * n`` or ``["cuda:0"] * n`` are n logical
    shards, run in turn.  Inside a process group (:func:`init_distributed`)
    whose backend reduces these devices' tensors the mesh spans every
    process, each with as many shards."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices=['cpu'] * n for "
                "logical CPU shards")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_devices is not None and n_devices > len(devices):
            raise RuntimeError(
                f"make_mesh: {n_devices} devices asked for, {len(devices)} "
                "CUDA devices present; pass devices=['cuda:0'] * n for "
                "logical shards of one card")
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return mesh_of(devices)


def _is_nlos(scene: Scene, cfg) -> bool:
    return (cfg.kind == "nlos_capture_meter"
            or scene.integrator.kind == "transient_nlos_path")


def _sensor_context(scene: Scene, cfg, bvh_mode: str = BVH_MODE):
    """The NLOS capture's constants for a capture meter or the NLOS
    integrator, the camera arrays otherwise; on the scene's device."""
    if _is_nlos(scene, cfg):
        return prepare_nlos(scene, cfg, bvh_mode)
    return build_camera(cfg, device=scene.device)


def _shards(mesh: Mesh):
    """(local index, global index, device) of this process's shards."""
    return [(i, mesh.offset + i, d) for i, d in enumerate(mesh.devices)]


@torch.no_grad()
def render_sharded(
    scene: Scene,
    mesh: Mesh,
    spp: int | None = None,
    seed: int = 0,
    sensor: int = 0,
    spp_per_pass_per_device: int | None = None,
    return_stats: bool = False,
    bvh_mode: str = BVH_MODE,
):
    """Sharded ``render``: (steady, transient) on the mesh's first device,
    the same in every process.

    ``spp`` is the global sample count, split over ``mesh.size`` shards and
    passes as the JAX package splits it; every sensor, integrator, variant,
    film (the phasor film, crop windows, the gaussian rfilter) of the
    multi-pass ``render`` is taken.  An exhaustive NLOS capture goes to
    :func:`render_nlos_exhaustive_sharded`.  With ``return_stats`` a third
    value holds ``rays`` (an int), ``spp`` (the total drawn) and
    ``devices`` (the mesh's size)."""
    cfg = scene.sensors[sensor]
    icfg = scene.integrator
    nlos = _is_nlos(scene, cfg)
    if nlos and icfg.capture_type == "exhaustive":
        return render_nlos_exhaustive_sharded(
            scene, mesh, spp=spp, seed=seed, sensor=sensor,
            return_stats=return_stats, bvh_mode=bvh_mode)
    film_cfg = cfg.film
    if nlos and film_cfg.is_cropped:
        raise NotImplementedError(
            "NLOS capture films do not support crop windows")
    ndev = mesh.size
    spp = spp if spp is not None else cfg.spp
    # lanes cover the data (crop) window; the uv mapping uses the whole
    # sensor, as render() does
    dw, dh = film_cfg.data_width, film_cfg.data_height
    hw = dw * dh
    var = scene.variant
    C = film_channels(var)

    spp_dev = max(1, spp // ndev)
    chunk = spp_per_pass_per_device or min(
        spp_dev, max(1, DEFAULT_MAX_LANES // hw))
    n_passes = (spp_dev + chunk - 1) // chunk
    chunk = (spp_dev + n_passes - 1) // n_passes
    total_spp = chunk * n_passes * ndev
    inv_total = 1.0 / total_spp

    ctx = _sensor_context(scene, cfg, bvh_mode)
    scan_pixels = hw if (nlos or film_cfg.is_cropped) else None
    skip_le = nlos and can_skip_le(scene.data)
    sds = replicate(primal_sd(scene.data), mesh)
    ctxs = replicate(ctx, mesh)
    # shard i's stream keys: pass p draws stream p * ndev + g
    keys = [pass_keys(seed, range(g, n_passes * ndev, ndev), dev)
            for _i, g, dev in _shards(mesh)]

    def shard_pass(i, g, dev, p):
        film = film_init_any(film_cfg, C, scan_pixels=scan_pixels,
                             device=dev)
        if nlos:
            film, n_rays = _nlos_pass(
                sds[i], ctxs[i], film, keys[i][p], inv_total,
                film_cfg=film_cfg, icfg=icfg, spp=chunk, hw=hw,
                skip_le=skip_le, bvh_mode=bvh_mode, variant=var)
        else:
            film, n_rays = _perspective_pass(
                sds[i], ctxs[i], film, keys[i][p], inv_total,
                film_cfg=film_cfg, icfg=icfg, width=dw, height=dh,
                spp_chunk=chunk, bvh_mode=bvh_mode, variant=var)
        return film, torch.as_tensor(n_rays, dtype=torch.int64, device=dev)

    acc = None
    total_rays = 0
    for p in range(n_passes):
        film, n_rays = reduce_shards(
            mesh, (shard_pass(i, g, dev, p) for i, g, dev in _shards(mesh)))
        total_rays = total_rays + n_rays
        acc = film if acc is None else tree_add(acc, film)
    steady, transient = develop_any(
        acc, film_cfg,
        shape_hw=(film_cfg.height, film_cfg.width) if nlos else (dh, dw))
    if return_stats:
        return steady, transient, {"rays": int(total_rays),
                                   "spp": total_spp, "devices": ndev}
    return steady, transient


@torch.no_grad()
def render_nlos_exhaustive_sharded(
    scene: Scene,
    mesh: Mesh,
    spp: int | None = None,
    seed: int = 0,
    sensor: int = 0,
    max_lanes: int = DEFAULT_MAX_LANES,
    progress_callback=None,
    return_stats: bool = False,
    bvh_mode: str = BVH_MODE,
):
    """Sharded exhaustive NLOS capture: the laser axis is split over the
    mesh, ``ceil(L / n)`` points a shard (padded rows repeat the last point
    and add nothing).  Every shard traces the local capture's sample
    streams (stream = pass) through the fused all-laser wavefront
    (``sample_nlos_exhaustive_primal``), so the 6-D transient equals
    ``render_nlos_exhaustive``'s bit for bit, while the per-bounce NEE work
    divides by the mesh's size.  The steady image is the mean over the
    lasers of the all-reduced radiance sums.  Polarized and spectral
    scenes, emitters that are not delta and scenes without laser sampling
    take :func:`_render_nlos_exhaustive_sharded_perpoint`.  Returns
    (steady (h, w, C), transient (h, w, lh, lw, T, C)) on the mesh's first
    device, the same in every process."""
    cfg = scene.sensors[sensor]
    film_cfg = cfg.film
    icfg = scene.integrator
    _check_exhaustive(film_cfg)
    if (scene.variant.polarized or scene.variant.spectral
            or not can_skip_le(scene.data) or not icfg.nlos_laser_sampling):
        return _render_nlos_exhaustive_sharded_perpoint(
            scene, mesh, spp=spp, seed=seed, sensor=sensor,
            max_lanes=max_lanes, progress_callback=progress_callback,
            return_stats=return_stats, bvh_mode=bvh_mode)
    spp = spp if spp is not None else cfg.spp
    lw, lh = film_cfg.laser_scan_width, film_cfg.laser_scan_height
    h, w = film_cfg.height, film_cfg.width
    hw = h * w
    C = scene.variant.color_channels
    T = film_cfg.temporal_bins
    ndev = mesh.size
    f32 = torch.float32

    targets, tvalid = exhaustive_laser_targets(scene, cfg, icfg, bvh_mode)
    lasers = prepare_exhaustive_lasers(scene, targets, bvh_mode)
    lasers = lasers._replace(wall_clear=lasers.wall_clear
                             & torch.from_numpy(tvalid).to(scene.device))
    L = targets.shape[0]
    if not scene.laser_focused:
        # prepare needs a valid focus; the single-laser fields go unused
        from ..nlos import focus_emitter_at_relay_wall_3dpoint

        focus_emitter_at_relay_wall_3dpoint(targets[int(tvalid.argmax())],
                                            scene)
    ctx = prepare_nlos(scene, cfg, bvh_mode)
    spp_chunk, n_passes, total_spp = _split_spp(spp, hw, max_lanes)

    # shard k takes points [k * Ld, (k + 1) * Ld), in chunks of Lc points
    # within the local capture's (laser, lane) budget; padded rows repeat
    # the shard's last point with the wall->laser segment blocked
    Ld = (L + ndev - 1) // ndev
    Lc = max(1, min(Ld, LANE_LASER_PAIRS // (spp_chunk * hw)))
    n_sub = (Ld + Lc - 1) // Lc

    def shard_lasers(g):
        rows = torch.arange(g * Ld, g * Ld + n_sub * Lc)
        valid = rows < min(L, (g + 1) * Ld)
        rows = torch.clamp_max(rows, L - 1).to(scene.device)
        out = ExhaustiveLaser(*(a[rows] for a in lasers))
        return out._replace(
            wall_clear=out.wall_clear & valid.to(scene.device))

    sds = replicate(primal_sd(scene.data), mesh)
    ctxs = replicate(ctx, mesh)
    shards = _shards(mesh)
    local_lasers = [tree_map(lambda x, d=dev: x.to(d), shard_lasers(g))
                    for _i, g, dev in shards]
    transients = [torch.zeros((n_sub, C, T + 1, Lc * hw), dtype=f32,
                              device=dev) for _i, _g, dev in shards]
    dev0 = mesh.devices[0]
    steady_sum = torch.zeros((hw, C), dtype=f32, device=dev0)
    keys = [pass_keys(seed, range(n_passes), dev) for _i, _g, dev in shards]

    def shard_pass(i, dev, p):
        sampler = Sampler.on(keys[i][p], spp_chunk * hw)
        ray, ray_weight = sample_nlos_rays(ctxs[i], spp_chunk, hw)
        L_sum = n_rays = 0
        for j in range(n_sub):
            lasers_j = ExhaustiveLaser(*(a[j * Lc:(j + 1) * Lc]
                                         for a in local_lasers[i]))
            film = TransientFilmState(
                steady=torch.zeros((hw, C), dtype=f32, device=dev),
                steady_weight=torch.zeros((hw,), dtype=f32, device=dev),
                transient=transients[i][j],
                n_negative=torch.zeros((), dtype=f32, device=dev),
                n_invalid=torch.zeros((), dtype=f32, device=dev))
            _film, L_j, _valid, n_j = sample_nlos_exhaustive_primal(
                sds[i], ctxs[i], lasers_j, sampler, ray, ray_weight, film,
                film_cfg, icfg, 1.0 / total_spp, spp_chunk, hw, bvh_mode)
            L_sum, n_rays = L_sum + L_j, n_rays + n_j
        return L_sum, n_rays

    total_rays = 0
    for p in range(n_passes):
        L_tot, n_rays = reduce_shards(
            mesh, (shard_pass(i, dev, p) for i, _g, dev in shards))
        steady_sum = steady_sum + sum_rows(L_tot.reshape(spp_chunk, hw, C))
        total_rays = total_rays + n_rays
        if progress_callback is not None:
            progress_callback((p + 1) / n_passes)

    # every shard's slab of the 6-D film into one (n, C, T, Ld, hw) buffer,
    # all-reduced so that every process holds the whole capture (the other
    # processes' slabs are zeros there: the sum is exact)
    full = torch.zeros((ndev, C, T, Ld, hw), dtype=f32, device=dev0)
    for i, g, _dev in shards:
        tr = transients[i][:, :, :T].reshape(n_sub, C, T, Lc, hw)
        full[g] = tr.permute(1, 2, 0, 3, 4).reshape(
            C, T, n_sub * Lc, hw)[:, :, :Ld].to(dev0)
    full = reduce_shards(mesh, [full])
    out = (full.permute(1, 2, 0, 3, 4).reshape(C, T, ndev * Ld, hw)[:, :, :L]
           .permute(3, 2, 1, 0).reshape(h, w, lh, lw, T, C))
    steady = (steady_sum / float(total_spp * L)).reshape(h, w, C)
    if return_stats:
        return steady, out, {"rays": int(total_rays), "spp": spp * L,
                             "devices": ndev}
    return steady, out


def _render_nlos_exhaustive_sharded_perpoint(
    scene: Scene,
    mesh: Mesh,
    spp: int | None = None,
    seed: int = 0,
    sensor: int = 0,
    max_lanes: int = DEFAULT_MAX_LANES,
    progress_callback=None,
    return_stats: bool = False,
    bvh_mode: str = BVH_MODE,
):
    """The exhaustive capture point by point (polarized and spectral
    scenes, emitters that are not delta, no laser sampling): whole laser
    points round-robin over the shards (point r * n + k to shard k), each
    rendered as the local capture renders it (a focused single capture with
    the full spp budget and the passes' streams, into one film), so every
    slab and the steady mean equal ``render_nlos_exhaustive``'s bit for
    bit."""
    from ..nlos import focus_emitter_at_relay_wall_3dpoint

    cfg = scene.sensors[sensor]
    film_cfg = cfg.film
    _check_exhaustive(film_cfg)
    spp = spp if spp is not None else cfg.spp
    lw, lh = film_cfg.laser_scan_width, film_cfg.laser_scan_height
    h, w = film_cfg.height, film_cfg.width
    hw = h * w
    var = scene.variant
    C = film_channels(var)
    T = film_cfg.temporal_bins
    ndev = mesh.size
    laser_targets = scene.shapes[cfg.shape_index].position_from_uv(
        _pixel_uv(lw, lh)).astype("float32")
    n_pts = lh * lw
    spp_chunk, n_passes, total_spp = _split_spp(spp, hw, max_lanes)
    skip_le = can_skip_le(scene.data)

    saved_icfg = scene.integrator
    scene.integrator = saved_icfg._replace(capture_type="single")
    icfg = scene.integrator
    try:
        ctxs = []
        for i in range(n_pts):
            focus_emitter_at_relay_wall_3dpoint(laser_targets[i], scene)
            ctxs.append(prepare_nlos(scene, cfg, bvh_mode))
    finally:
        scene.integrator = saved_icfg

    sds = replicate(primal_sd(scene.data), mesh)
    shards = _shards(mesh)
    keys = [pass_keys(seed, range(n_passes), dev) for _i, _g, dev in shards]
    dev0 = mesh.devices[0]
    out = torch.zeros((h, w, lh, lw, T, C), device=dev0)
    steadies = torch.zeros((n_pts, h, w, C), device=dev0)
    total_rays = torch.zeros((), dtype=torch.int64, device=dev0)
    n_rounds = (n_pts + ndev - 1) // ndev
    for r in range(n_rounds):
        for i, g, dev in shards:
            pt = r * ndev + g
            if pt >= n_pts:
                continue
            ctx = tree_map(lambda x, d=dev: x.to(d), ctxs[pt])
            film = film_init(film_cfg, C, scan_pixels=hw, device=dev)
            for p in range(n_passes):
                film, n_rays = _nlos_pass(
                    sds[i], ctx, film, keys[i][p], 1.0 / total_spp,
                    film_cfg=film_cfg, icfg=icfg, spp=spp_chunk, hw=hw,
                    skip_le=skip_le, bvh_mode=bvh_mode, variant=var)
                total_rays += torch.as_tensor(n_rays).to(dev0)
            s, t = develop(film, film_cfg, shape_hw=(h, w))
            ly, lx = divmod(pt, lw)
            out[:, :, ly, lx] = t.to(dev0)
            steadies[pt] = s.to(dev0)
        if progress_callback is not None:
            progress_callback((r + 1) / n_rounds)
    # each point's slab and steady image come from one shard: the
    # all-reduce adds zeros elsewhere, and the steady mean is taken in
    # point order, as the local capture takes it
    out, steadies, total_rays = reduce_shards(
        mesh, [(out, steadies, total_rays)])
    steady = torch.zeros((h, w, C), device=dev0)
    for s in steadies:
        steady += s / n_pts
    if return_stats:
        return steady, out, {"rays": int(total_rays), "spp": spp * n_pts,
                             "devices": ndev}
    return steady, out


@torch.no_grad()
def render_backward_sharded(
    scene: Scene,
    mesh: Mesh,
    grad_in,
    spp: int | None = None,
    seed: int = 0,
    sensor: int = 0,
    bvh_mode: str = BVH_MODE,
):
    """Sharded reverse-mode rendering: every shard differentiates its
    share of ``spp`` (``spp // mesh.size`` samples a pixel, stream = its
    global index, in one call), and the parameter gradients are summed
    over the mesh.  The same dict as ``render_backward``.

    The routes are the JAX package's sharded ones: full AD
    (``fullad_grads``) for ``transient_nlos_path`` (single and confocal),
    ``transient_prbvolpath`` and every polarized or spectral scene (a
    volumetric scene is differentiated by full AD here, not by the
    volumetric PRB replay ``render_backward`` takes); the PRB two-sweep
    replay (``render._backward_pass``) for ``transient_path``.  A crop
    window, the phasor film and the exhaustive capture are refused."""
    cfg = scene.sensors[sensor]
    icfg = scene.integrator
    film_cfg = cfg.film
    if film_cfg.is_cropped:
        raise NotImplementedError(
            "sharded rendering with a cropped film is not supported")
    _refuse_film(film_cfg)
    ndev = mesh.size
    spp = spp if spp is not None else cfg.spp
    spp_dev = max(1, spp // ndev)
    inv_total = 1.0 / (spp_dev * ndev)
    hw = film_cfg.width * film_cfg.height
    var = scene.variant
    T = film_cfg.temporal_bins
    kind = icfg.kind
    shards = _shards(mesh)

    if (kind in ("transient_nlos_path", "transient_prbvolpath")
            or var.polarized or var.spectral):
        if kind == "transient_nlos_path" and icfg.capture_type == "exhaustive":
            raise ValueError(EXHAUSTIVE_REFUSAL)
        C = film_channels(var)
        gs, gt = adjoint_images(grad_in, film_cfg, C, scene.device)
        gt = gt.reshape(film_cfg.height, film_cfg.width, T, C)
        ctx = _sensor_context(scene, cfg, bvh_mode)
        skip_le = kind == "transient_nlos_path" and can_skip_le(scene.data)
        reps = replicate((scene.data, ctx, gs, gt), mesh)

        def shard_grads(i, g, dev):
            sd, ctx_, gs_, gt_ = reps[i]
            return fullad_grads(
                sd, ctx_, gs_, gt_, pass_keys(seed, [g], dev)[0], inv_total,
                film_cfg=film_cfg, icfg=icfg, spp=spp_dev, hw=hw, kind=kind,
                skip_le=skip_le, bvh_mode=bvh_mode, polarized=var.polarized,
                spectral=var.spectral)
    else:
        gs, gt = adjoint_images(grad_in, film_cfg, var.color_channels,
                                scene.device)
        cam = build_camera(cfg, device=scene.device)
        reps = replicate((primal_sd(scene.data), cam, gs,
                          gt.reshape(hw * T, -1)), mesh)

        def shard_grads(i, g, dev):
            sd, cam_, gs_, gt_ = reps[i]
            return _backward_pass(
                sd, cam_, gs_, gt_, pass_keys(seed, [g], dev)[0], inv_total,
                film_cfg=film_cfg, icfg=icfg, width=film_cfg.width,
                height=film_cfg.height, spp=spp_dev, bvh_mode=bvh_mode)

    grads = reduce_shards(mesh, (shard_grads(i, g, d) for i, g, d in shards))
    return grads_to_named(scene, grads)
