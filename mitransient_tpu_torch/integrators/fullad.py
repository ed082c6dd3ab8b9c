"""Full reverse-mode AD through the whole wavefront (counterpart of
``mitransient_tpu/integrators/fullad.py``), for ``transient_nlos_path``
(single and confocal captures) and for ``transient_path`` and
``transient_prbvolpath`` with ``method="fullad"``, and for every
polarized or spectral scene.

Autograd records the primal render of one spp chunk (every bounce, kept
alive until the backward) and runs its exact adjoint.  Sampling decisions
are detached inside the loops (Russian roulette, the pdfs), so the
estimator is detached PRB's, except that each splat's adjoint is read at
its own time bin: the film splat is differentiated exactly, through K3's
autograd Function (``film/transient_film.py:SplatEvents``), whose
backward gathers the film's cotangent.  The ray kernels get detached
inputs; with the scene's geometry deltas kept, gradients reach the shape
poses through the attached hit distance (``scene.py:_si_from_t_prim``).
Gradients add up over spp chunks, so memory is bounded by one chunk's
graph.  The taped estimator is the scene variant's: 4 C Stokes channels
in the film and the adjoint when polarized, hero wavelengths splatted in
sRGB when spectral.
"""
from __future__ import annotations

import torch

from ..core.rng import Sampler, pass_keys
from ..film.transient_film import develop_any, film_init_any
from ..ops.bvh import BVH_MODE
from ..scene.schema import Scene
from ..sensors.perspective import build_camera, sample_rays
from . import _split_spp
from .nlos_path import (
    can_skip_le,
    film_channels,
    prepare_nlos,
    sample_nlos_primal,
    sample_nlos_rays,
)
from .path import sample_primal
from .volpath import sample_volpath_primal
from .prb import (
    DiffParams,
    add_params,
    adjoint_images,
    as_leaves,
    extract_params,
    grads_to_named,
    insert_params,
    table_grads,
)


EXHAUSTIVE_REFUSAL = ("Exhaustive capture is not supported in differentiable "
                      "rendering (transientnlospath.py:729-731)")


def fullad_grads(sd, ctx, gs, gt_full, key, inv_total, *, film_cfg, icfg,
                 spp, hw, kind, skip_le: bool = False,
                 bvh_mode: str = BVH_MODE, polarized: bool = False,
                 spectral: bool = False) -> DiffParams:
    """The table gradients of one spp chunk on the stream key ``key``:
    d/d(theta) of <gt_full, transient> + <gs, steady partial>, through the
    primal of the given variant."""
    leaves = as_leaves(extract_params(sd))
    dev = sd.bsdf.reflectance.device
    with torch.enable_grad():
        sdt = insert_params(sd, leaves)
        C = sdt.bsdf.reflectance.shape[-1] * (4 if polarized else 1)
        film = film_init_any(film_cfg, C, scan_pixels=hw, device=dev)
        sampler = Sampler.on(key, spp * hw)
        if kind == "transient_nlos_path":
            ray, rw = sample_nlos_rays(ctx, spp, hw)
            film, L, _v, _r = sample_nlos_primal(
                sdt, ctx, sampler, ray, rw, film, film_cfg, icfg, inv_total,
                spp, skip_le=skip_le, bvh_mode=bvh_mode, polarized=polarized,
                spectral=spectral)
        else:
            ray, pix, rw = sample_rays(ctx, sampler, film_cfg.width,
                                       film_cfg.height, spp)
            sample_fn = (sample_volpath_primal
                         if kind == "transient_prbvolpath" else sample_primal)
            film, L, _v, _r = sample_fn(
                sdt, sampler, ray, pix, rw, film, film_cfg, icfg, inv_total,
                spp, bvh_mode, polarized=polarized, cam_vertical=ctx.R[:, 1],
                spectral=spectral)
        _steady, transient = develop_any(
            film, film_cfg, shape_hw=(film_cfg.height, film_cfg.width))
        # the steady partial: this chunk's sum of L with box weights
        steady_partial = L.reshape(spp, hw, -1).sum(dim=0) * inv_total
        loss = (gt_full * transient).sum() + (gs * steady_partial).sum()
        return table_grads(loss, leaves)


def render_backward_fullad(scene: Scene, grad_in, spp=None, seed=0,
                           sensor=0, max_lanes=1 << 20,
                           bvh_mode: str = BVH_MODE):
    """Reverse-mode gradients by full AD, accumulated over spp chunks of at
    most ``max_lanes`` lanes; the same dict as ``render_backward``, which
    refuses the crop and the phasor film (``render._refuse_film``) before
    it calls this.  Any spp is chunked, so no lane count is refused; the
    exhaustive capture is, as in the JAX package."""
    cfg = scene.sensors[sensor]
    icfg = scene.integrator
    film_cfg = cfg.film
    kind = icfg.kind
    if kind == "transient_nlos_path" and icfg.capture_type == "exhaustive":
        raise ValueError(EXHAUSTIVE_REFUSAL)
    spp = spp if spp is not None else cfg.spp
    hw = film_cfg.width * film_cfg.height
    var = scene.variant
    C = film_channels(var)
    T = film_cfg.temporal_bins
    dev = scene.device
    skip_le = False
    if kind == "transient_nlos_path":
        ctx = prepare_nlos(scene, cfg, bvh_mode)
        skip_le = can_skip_le(scene.data)
    else:
        ctx = build_camera(cfg, device=dev)

    gs, gt = adjoint_images(grad_in, film_cfg, C, dev)
    gt = gt.reshape(film_cfg.height, film_cfg.width, T, C)
    spp_chunk, n_passes, total_spp = _split_spp(spp, hw, max_lanes)
    keys = pass_keys(seed, range(n_passes), dev)
    grads = None
    for p in range(n_passes):
        grads = add_params(grads, fullad_grads(
            scene.data, ctx, gs, gt, keys[p], 1.0 / total_spp,
            film_cfg=film_cfg, icfg=icfg, spp=spp_chunk, hw=hw, kind=kind,
            skip_le=skip_le, bvh_mode=bvh_mode, polarized=var.polarized,
            spectral=var.spectral))
    return grads_to_named(scene, grads)
