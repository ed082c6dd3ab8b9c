#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout with no arguments::

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. Build the CUDA kernels from ``mitransient_tpu_torch/csrc`` (one nvcc per
   source, in parallel) and print ptxas' register and spill report.
2. K1-K3 against their plain PyTorch versions at the flagship's shapes
   (2^21 rays against the 36-triangle box; a (3, 301, 65536) film).  K1
   and K2 must equal their plain versions on every ray (K1's ``t`` bit for
   bit), on random rays and on the rays of one loop iteration of a
   flagship render (K1 its closest-hit rays, K2 its shadow rays), and are
   timed on both, each with the active share of the rays; their bounds
   count the tests and the ray bytes of the active rays only.  K3's
   film must be bit-equal to the plain version run on a copy on the host
   CPU (sequential adds), on random events and on the events of the same
   loop iteration, and is timed on both; its bound on each counts the film
   sectors those events touch.
3. The flagship transient Cornell box (256x256, 300 bins, max_depth 8,
   spp 1024) on the card: each of K1-K3 launches once per loop iteration,
   the physics checks pass; rays/s of a second render.
4. The ``cbox_rgb`` golden config on the card against its golden.
5. The large-mesh path, ``cbox_mesh`` (the box with a 261,120-triangle
   sphere): the host accel build is timed and must use the native SAH
   builder.
6. The BVH kernel in both modes (chunk, super) and for the three queries
   (closest, any hit, mixed at n_closest = N/2), launched on all 2^21
   rays: every 32nd ray (2^16 of them) is held against ``query_plain`` on
   the same rays, ``t`` bit-equal and ``prim`` equal, at most
   ``MAX_RAY_MISMATCHES`` rays out.  Each mode also counts, on all rays,
   its tree's box tests and triangle tests per ray and the share of rays
   whose queue overflowed; on the subset its triangle tests must equal
   ``query_plain``'s (both sweep the same chunks).
7. The BVH kernel (Woop) in each mode against K1's brute force
   (Moller-Trumbore) on all 2^21 rays: the share of rays whose ``prim``
   differs (rounding at triangle edges) must be at most
   ``K1_MISMATCH_SHARE``.  Then the K1 / BVH crossover: K1 and the BVH
   kernel in both modes timed on 2^21 box rays in the box with a UV
   sphere of 64-8192 triangles (``CROSSOVER``), one line per count, under
   the same agreement rule.
8. ``cbox_mesh`` rendered in chunk mode, then in super mode, both at spp
   1024: the BVH kernel launches twice per loop iteration (closest hit and
   shadow rays), K1/K2 never, the physics checks pass; each mode's rays/s
   and peak memory.
9. One more ``cbox_mesh`` render in each mode (spp 64) under
   torch.profiler: the device's busy share and its time by kernel group.
10. The small sphere config (``small_cbox`` with a 4,512-triangle sphere)
    on the card against the port on the host CPU, under test_golden's rule
    with no element out.
11. The threefry sample streams: ``draw_bounce_block`` at (2^21, 6) and
    ``Sampler.eval_2d`` at 2^21 lanes on the card, each bit-equal to the
    same draw on the host CPU, timed, and their time per multi-pass
    flagship render (32 passes of 8 bounce blocks and one jitter draw).
12. The flagship through the multi-pass accumulator (``regenerate=False``,
    spp 1024: 32 passes of spp 32 at 2^21 lanes): each of K1-K3 launches
    once per bounce of every pass, the physics checks pass; peak memory and
    the rays/s of a second render (seed 1).
13. The ``cbox_rgb_multipass`` and ``phasor`` golden configs on the card
    against their goldens.
14. Multi-pass renders on the card against the port on the host CPU: the
    small sphere config (through the BVH kernel) and a small config with
    ``camera_unwarp``, the gaussian temporal filter (through K3 at spp * K
    lanes, once a bounce), the gaussian rfilter and a crop
    window; test_golden's rule, no element out.
15. Checkpoint/resume on the card: a render resumed from a pass's state,
    written and read back by ``save_film_state`` / ``load_film_state``, is
    bit for bit the uninterrupted render, with the box and with the
    gaussian temporal filter.
16. The NLOS single capture at full width: ``nlos_scene`` at a 32x32 scan
    (300 bins of 0.02, depth 4, laser and hidden-geometry sampling, the
    laser focused at wall pixel (16, 16)), spp 2048 = 2^21 lanes in one
    pass.  K1, K2 and K3 each launch once a bounce (the capture's
    constants add one K1 and one K2 launch on one ray each), K3 splats one
    event set; finite, non-negative, first arrival in bins 90-115.  The
    inputs K1, K2 and K3 get in bounce 1 (2^21 closest-hit rays, 2^21
    vertex -> wall rays, one event set) are held against the plain
    versions as in phase 2, each timed with its bound (K3 also against
    ``index_add_``).  Wall time, rays/s and peak memory of a second,
    uninstrumented render (seed 1); the threefry's share (its standalone
    draw time over that wall); then a render at spp 25,000 (13 passes)
    and its rays/s.
17. The ``nlos_single`` golden config on the card against its golden.
18. Every configuration of ``torch_cases.NLOS_CASES`` (plain NEE, HG with
    RR, account_first_and_last_bounces, filter_depth, several passes, a
    1x1 confocal capture, ``scan_confocal`` at 4x4, the exhaustive capture
    at 4x4 x 2x2 lasers with laser_chunk 3, the capture through a
    perspective sensor, the cbox with a point light through the regen loop
    and the multi-pass accumulator, and a single and an exhaustive capture
    with a 4,512-triangle sphere among the hidden geometry, whose accel
    sends every ray query to the BVH kernel) on the card against the port
    on the host CPU, test_golden's rule with no element out; K3 launches
    once a bounce on the card, and K1 and K2 (the BVH kernel twice, with
    an accel) at least once.
19. Full scans: ``scan_confocal`` at 32x32, spp 2048, and the exhaustive
    capture at a 32x32 scan x 8x8 lasers, spp 512 (2^19 lanes, 2 laser
    chunks of 32), each rendered twice.  The exhaustive capture's first
    render keeps what K1, K2 and K3 get in bounce 1 (2^19 closest-hit
    rays, one K2 launch of 32 x 2^19 = 2^24 vertex -> wall rays, one
    event set into a (3, 301, 32768) film of laser x pixel slots), held
    against the plain versions as in phase 16; the second render's rays/s
    and peak memory.
20. The materials flagship at full width: ``materials_cbox`` (the flagship
    cbox, 256x256, 300 bins, depth 8, spp 1024, with a gold GGX large box
    and a glass small box) through the regen loop.  K1, K2 and K3 each
    launch once per loop iteration and the physics checks pass; the
    inputs K1, K2 and K3 get in loop iteration 8 (closest-hit rays,
    refracted ones inside the glass among them, shadow rays, two event
    sets) are held against the plain versions as in phase 2, each timed
    with its bound (K3 also against ``index_add_``).  The lobe code of
    one iteration (the BSDF gather, ``eval_pdf`` and ``sample`` on the
    iteration's 2^21 hits) is timed for this scene and for the diffuse
    flagship on the same rays.  Rays/s and peak memory of a second render
    (seed 1), then the rays/s of the same scene through the multi-pass
    accumulator (``regenerate=False``).
21. The angulararea example at its canonical size: ``room`` at 200x200,
    200 bins, spp 256, with the example's area and angulararea lights.
    Each render is finite and non-negative, the angulararea light puts
    more of the floor's energy under it than the area light; the rays/s
    of a second render of each.
22. Every ``torch_cases.MATERIAL_CASES`` configuration (each lobe, the
    two-sided, mask and blendbsdf wrappers, a checkerboard floor, a
    checkerboard bump map and normal map, the angulararea room, an
    emissive rough gold 4,512-triangle sphere through the BVH kernel and
    the emitter-triangle search, an NLOS capture with a rough relay wall,
    the materials flagship at 12x12), regen and multi-pass, on the card
    against the port on the host CPU: test_golden's rule, no element out;
    K3 launches once a loop iteration or bounce, and K1 and K2 (the BVH
    kernel twice, with an accel) at least once.

23. PRB backward (``render_backward`` of ``transient_path``): the
    ``gradients`` golden config on the card against
    ``tests/goldens/gradients.npz`` and against the port on the host CPU
    (test_golden's rule, no element out); ``optimize_reflectance``'s full
    configuration (64x64, 200 bins of 0.04 from OPL 0, depth 4, spp 256 =
    2^20 lanes), 3 Adam steps (``torch.optim.Adam``, lr 5e-2, seeds 0-2),
    each a multi-pass render and a ``render_backward``, with the loss,
    max|theta - true|, the seconds of each and the peak memory, and at
    step 0 the gradient by full AD beside PRB's; ``render_backward`` of
    the flagship frame (256x256,
    300 bins, depth 8, rr_depth 5, spp 128 = 2^23 lanes in one pass): K1
    and K2 launch once a bounce of each of the two sweeps and K3 never;
    the inputs K1 and K2 get in the replay sweep's bounce 1 (2^23
    closest-hit rays, 2^23 shadow rays) held against the plain versions
    as in phase 16, each timed with its bound; wall and peak memory of a
    second call, the share of a third call spent
    in autograd's backward, and a fourth under torch.profiler with the
    device time of the table-gradient reductions (K8, ``reduce_rows``;
    no ``index_add_`` kernel may be left); the gradients golden and the
    4,512-triangle sphere config through the BVH kernel, card against CPU
    (tables within 1e-4 of their largest value, the difference printed
    beside the 6.71e-6 the atomics left; 0 asserted where the card
    equals the CPU).
24. Forward mode: ``forward_time_gradients``' full configuration
    (128x128, 300 bins of 8/300 from 0, depth 4, spp 512 = 2^23 lanes)
    timed on a second call, K3 launching once a bounce for the
    derivative film; the inputs K1 and K2 get in the replay sweep's
    bounce 1 (2^23 rays each) and the events of bounce 1's derivative
    splat (2^23 lanes into a (3, 301, 16384) film) held against the plain
    versions as in phase 16, each timed with its bound; the test_grad box's derivative video on the card
    against the CPU (test_golden's rule).
25. Full AD and K3's autograd Function: on the NLOS single capture's
    bounce-1 events, the Function's backward (a gather) bit-equal to the
    plain version's ``index_add_`` autograd on the card and its jvp (K3
    on the tangents) bit-equal to the plain version's forward AD on the
    host CPU, the gather timed beside its bound and one ``index_select``;
    ``render_backward`` (full AD) of the 32x32 single capture at spp 2048
    (2 chunks of 2^20 lanes; K3 once a bounce of each) with its wall and
    peak memory; the flip-free geometry scenes (``GEOMETRY_CASES``), the
    GGX-alpha and texel cases (PRB and full AD) card against CPU (as
    in phase 23).
26. Volumetric rendering on the card: the ``volumetric`` golden config
    against ``tests/goldens/volumetric.npz`` within its coplanar ties
    (``torch_cases.VOLUMETRIC_TIES``, as on the CPU), then every
    ``torch_cases.VOL_CASES`` configuration (fog, absorbing fog,
    ``camera_unwarp``, the null box, Russian roulette over two passes, a
    constant and a random 8^3 grid with a ``to_world``, a crop window with
    the gaussian filters) card against the
    host CPU, each bit for bit.
27. The volumetric tutorial at full size (``torch_cases.tutorial_cbox``:
    128x128, 400 bins, depth 64, spp 512 = 4 passes of 2^21 lanes; fog of
    sigma_t 1.8, albedo 0.9, HG g 0.3 in the small box): K1 launches 5
    times a bounce (the path ray and the shadow walk's 4 steps), K3 once
    and K2 never; finite, non-negative, first arrival in bins 15-18, and
    the fog's in-scattered light adds energy over black fog (spp 64).
    The inputs of bounce 1 (K1's path rays and its shadow walk's first
    rays, which start inside the medium, and K3's two event sets) are held
    against the plain versions as in phase 16, each timed with its bound
    (K3 also against ``index_add_``).  Wall, rays/s, peak memory and the
    threefry's share of a second, uninstrumented render.  Then its grid
    variant (``tutorial_grid``: a seeded 64^3 density of scale 3, spp 128,
    depth 16, cut from 64 for the run's time): launches, wall, rays/s,
    peak memory, the ms of one (2^21, 32, 2) and one (2^21, 16) tracking
    draw, and the tracking loops' share of a third render synchronized
    around them.
28. Volumetric gradients: ``render_backward`` (the PRB replay) of the
    tutorial's film at depth 64, spp 64 (one chunk of 2^20 lanes; K1 5
    times a bounce of each sweep, K3 never), full AD and
    ``render_forward`` at depth 8 (call 1, which pays PyTorch's forward-AD
    set-up, and call 2), each with its seconds and peak memory, and one
    depth-2 forward call profiled (host operators against device
    kernels); the fog
    and grid configs of ``torch_cases.vol_grad_case``, PRB, full AD and
    forward mode, card against CPU within 1e-4 of each table's or video's
    largest value.
29. The polarized and spectral variants on the card: the ``cbox_polarized``
    and ``cbox_spectral`` goldens (test_golden's rule, no element out),
    then every ``torch_cases.VARIANT_CASES`` configuration (mono_polarized,
    rgb_polarized, spectral, spectral_polarized, each with a gold GGX
    small box; regen for the polarized ones, multi-pass for all) card
    against CPU, no element out, with whether it is bit for bit; K3 once a
    loop iteration or bounce, K1 and K2 at least once.
30. The polarized cbox at full width (``torch_cases.polarized_cbox``, the
    reference's ``examples/polarization`` config: mono_polarized, 256x256,
    400 bins, depth 5, a gold GGX small box; spp 1024, cut from 4096)
    through the regen loop: K1-K3 once a loop iteration; intensity
    physics, physical Stokes vectors (DoP 0.95 quantile at most 1.05),
    linear polarization on the gold box and none on the diffuse walls, the
    ``vis_polarized`` false-color maps in [0, 1]; the inputs K1, K2 and K3
    get in loop iteration 1 held against the plain versions as in phase
    16 (K3 into a (4, 401, 65536) film), each timed with its bound (K3
    also against ``index_add_``); wall, rays/s and peak memory of a second,
    uninstrumented render (seed 1); one render at spp 64 under
    torch.profiler (``profile_render``: busy share, device time by kernel
    group and the kernels of most time).
31. The spectral flagship (``cornell_box()`` under ``spectral``, multi-pass,
    spp 256 = 8 passes of 2^21 lanes): K1-K3 once a bounce, the physics
    checks, rays/s of a second render, the threefry's share (bounce
    blocks, jitter and the hero-wavelength draw) and the spectral
    conversions' (a bounce's uplifts and sRGB conversions on 2^21 lanes),
    and one pass under torch.profiler; then ``rgb_polarized``
    (regen) and ``spectral_polarized`` (multi-pass) at the flagship's film,
    spp 64, with K3 held bit for bit on each one's bounce-1 12-channel
    events (into (12, 301, 65536)), timed with its bound and
    ``index_add_``.

32. The variants through NLOS, volumetric and differentiable rendering,
    card against CPU: every ``torch_cases.VARIANT_NLOS_CASES``
    configuration (polarized captures with a gold relay wall, HG with RR,
    plain NEE toward a point light, the exhaustive capture point by point,
    ``scan_confocal`` and a confocal capture; spectral captures) and every
    ``VARIANT_VOL_CASES`` one (polarized and spectral fog, a random 8^3
    grid), bit for bit with the same ray count, K3 launched, K1 and K2 (or
    K1 five times a bounce in media) too; the ``VARIANT_GRAD_CASES``
    gradients (polarized box, NLOS and fog through full AD, the spectral
    fog through the PRB replay, a spectral box) within 1e-4 of each
    table's largest value, NaN where the CPU has NaN.
33. The polarimetric NLOS capture at the reference's scan
    (``torch_cases.polarized_nlos``: mono_polarized, 64x64, 300 bins, the
    hidden Z, a gold GGX wall of alpha 0.3, the laser at pixel (32, 32);
    spp 2048, cut from 65,536: 2^23 lanes in 4 passes): K1-K3 once a
    bounce (and the constants' K1 and K2), Stokes I's energy and first
    arrival, DoP 0.95 quantile at most 1.05 and some linear polarization;
    K1, K2 and K3 held on pass 1's bounce-1 inputs (K3 into (4, 301,
    4096)), each timed with its bound (K3 also against ``index_add_``);
    rays/s and peak memory of a second render.  Then the spectral single
    capture at phase 16's config (32x32, spp 2048) and ``scan_confocal``
    32x32 under mono_polarized, each with the rays/s of a second render.
34. The volumetric tutorial under ``spectral`` and ``mono_polarized``
    (128x128, 400 bins, depth 64, spp 128, cut from 512: one pass of 2^21
    lanes): K1 five times and K3 once a bounce, the first arrival, physical
    Stokes vectors; K3 held on bounce 1's 3- and 4-channel events, timed
    with its bound and ``index_add_``; rays/s and peak memory of a second
    render, and the spectral conversions' share of its wall.
35. Variant gradients, each call's seconds and peak memory: full AD of the
    polarized cbox (256x256, 400 bins, depth 5, spp 16 = 2^20 lanes, S0
    adjoint; K3 once a bounce) and of the spectral flagship (spp 16), the
    spectral tutorial through the (RGB) PRB replay at 2^20 lanes, full AD
    of the polarized NLOS capture at 32x32, spp 1024, and
    ``render_forward`` of the polarized cbox at 64x64, spp 64 (calls 1 and
    2); K3's autograd Function at 4 and 12 channels on seeded events, its
    backward and jvp bit-equal to the plain version's autograd.
36. Multi-device rendering (``mitransient_tpu_torch.parallel``): a
    one-process NCCL world on the card through ``init_distributed`` and
    its ``global_mesh`` (one card: NCCL takes one rank a device, so only
    a one-rank world is checked); the flagship through ``render_sharded``
    (spp 1024: 32 passes of 32): K1-K3 once a bounce of every pass, the
    physics checks, steady and transient within test_golden's rule of
    phase 12's multi-pass render with the same ray count, rays/s, wall
    and peak memory of a second render, and the time of one NCCL
    all-reduce of its (3, 301, 65536) film; the small cbox, an 8x8 NLOS
    capture, a fog and a mono_polarized cbox over 4 logical shards of the
    card against 4 CPU shards, bit for bit with equal rays; the exhaustive
    capture at phase 19's config over 4 logical shards, its transient bit
    for bit the local capture's, with both rays/s; the flagship's PRB
    replay through ``render_backward_sharded`` at 2^23 lanes equal to
    ``render_backward`` bit for bit (the same stream), and PRB and full-AD (NLOS,
    volumetric tutorial at depth 4) cases over 4 shards card against CPU,
    within 1e-4 of each table's largest value; ``dryrun_multichip`` on 8
    logical shards of the card against 8 CPU shards.
37. Reproducible results: K8 (``ops/gather.py:reduce_rows``, the table
    gradients' fixed-order reduction) bit-equal to its plain version on
    the host CPU on the cotangents and indices of the flagship backward's
    replay bounce ``GRAD_HELD_BOUNCE`` (2^23 lanes onto the BSDF and
    emitter tables) and on a texel case at the staircase example's size
    (``TEXEL``: 2^18 lanes' four bilinear taps into a 5 x 512 x 512 RGB
    atlas), each timed with its bound and ``index_add_``; two calls each
    of the flagship ``render_backward`` (2^23 lanes), phase 25's NLOS full
    AD, phase 28's volumetric PRB, phase 24's forward mode and the texel
    case's PRB and full AD, their tables (or videos) bit-identical; the
    gaussian temporal filter's splat (K3 at spp x K lanes) bit-equal to its
    plain version on the host CPU on two 2^21-lane sets of 13 taps into
    (3, 301, 65536), timed with its bound and ``index_add_``; the
    gaussian-filtered ``torch_cases.flat_scene`` render bit for bit card
    against CPU.

Kernel times (``_time_ms``) are means of launches made back to back, so
that the wrapper's host work overlaps the card's as in a render.  It
prints, as its last three lines, the card's name and power limit, one
JSON object with each kernel's launches (in the regen flagship or
``cbox_mesh`` render; K1-K3 also in the multi-pass flagship render,
``multipass_launches``, in the NLOS single capture, ``nlos_launches``,
and in the materials flagship, ``materials_launches``; in the gradient
phases ``prb_backward_launches``, ``forward_launches`` and
``fullad_launches``; in the volumetric tutorial, ``volumetric_launches``,
and its PRB backward, ``volumetric_prb_backward_launches``; in the
polarized cbox, ``polarized_launches``; in the spectral flagship,
``spectral_launches``; in the 12-channel flagships,
``stokes12_launches`` and ``stokes12_spectral_launches``), error, times
and bound (K1 and K3 also on the volumetric tutorial's bounce-1 inputs,
``volumetric_*``, K1 also on its shadow walk's, ``volumetric_walk_*``;
K1-K3 also on the inputs of
phases 16, 19 and 20, keys ``nlos_*``, ``exhaustive_*`` and
``materials_*``, and on those of phases 23 and 24, ``grad_prb_*`` for K1
and K2 and ``grad_forward_*``; K1-K3 on the polarized cbox's iteration-1
inputs, ``polarized_*``; K3 on the 12-channel events, ``stokes12_*``
(rgb_polarized) and ``stokes12_spectral_*``; K1-K3 on the polarized NLOS
capture's, ``pol_nlos_*``, and K3 on the variant tutorials' events,
``spectral_vol_*`` and ``pol_vol_*``, with the launches of phases 33-35,
``pol_nlos_launches``, ``spectral_nlos_launches``,
``pol_confocal_launches``, ``spectral_vol_launches``,
``pol_vol_launches`` and ``variant_fullad_launches`` (the polarized
cbox's full AD), and the sharded flagship's, ``sharded_launches``; K8's
in the flagship backward (``launches``) and the volumetric PRB backward,
and on each held input, ``calls``; the gaussian splat's in phase 14's
gaussian render; K3 also its Function's ``backward_max_abs_err``,
``jvp_max_abs_err``, at 4 and 12 channels ``stokes_fn_*_max_abs_err``,
and the backward gather's ``gather_*`` times), and
``{"ok": true,
"device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, it exits with an error.  Nothing here
imports jax.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = dict(spp=1024, seed=0)  # cornell_box(): 256x256, 300 bins, depth 8
N_RAYS = 1 << 21  # the flagship's lanes: 65536 pixels x 32 lanes per pixel
SPLAT_LANES, SPLAT_BINS = 32, 300  # film (3, 301, 65536), two event sets
MAX_RAY_MISMATCHES = 2  # of BVH_SUBSET for BVH (K1-K3: 0)
# the loop iteration of a flagship render whose K1 closest-hit rays, K2
# shadow rays and K3 events are captured
FLAGSHIP_EVENTS = dict(spp=64, seed=2, iteration=8)
TIMING_REPS = 20  # calls back to back in one timed batch
TIMING_BATCHES = 5
MESH = dict(spp=1024, seed=0)  # cbox_mesh: 256x256, 300 bins, depth 8
MULTIPASS_PASSES = 32  # the multi-pass flagship: 1024 spp, 32 a pass
NLOS_SCAN = 32  # the NLOS captures' scan: 32 x 32 wall pixels, 300 bins
NLOS = dict(spp=2048, seed=0)  # 2^21 lanes, one pass of depth 4
NLOS_SPP_LONG = 25000  # the reference's single-capture budget (13 passes)
NLOS_EVENTS_BOUNCE = 1  # the bounce whose K3 events are captured
NLOS_FIRST_BINS = (90, 115)  # wall -> target -> wall (tests/test_nlos.py)
CONFOCAL_SPP = 2048  # scan_confocal at 32 x 32 (BASELINE.md:98)
EXHAUSTIVE = dict(spp=512, lasers=8)  # 32 x 32 scan x 8 x 8 lasers
MATERIALS_EVENTS_ITERATION = 8  # the materials flagship's held iteration
ROOM = dict(res=200, bins=200, spp=256)  # the angulararea example's size
PROFILE_SPP = 64  # the profiled render: the profiler slows the host
GRAD_FLAGSHIP = dict(spp=128, seed=0)  # render_backward: 2^23 lanes, 1 pass
# the replay sweep's bounce whose K1 and K2 inputs (and, in forward mode,
# whose derivative splat's events) phases 23 and 24 hold
GRAD_HELD_BOUNCE = 1
# card against CPU, gradient tables: a sweep may round apart on the two
# devices (the table-gradient reductions themselves add alike, K8)
GRAD_TABLE_ATOL = 1e-4
# the texel case of phase 37: optimize_staircase_texture's full run (64x64,
# spp 64 = 2^18 lanes, four bilinear taps each) into the staircase's atlas
# as tests/test_textures.py bounds it (5 textures of at most 512 x 512)
TEXEL = dict(lanes=1 << 18, atlas=(5, 512, 512, 3))
# the kernels of csrc/gather.cu (K8), as the profiler names them
K8_KERNELS = ("tile_partials_kernel", "sum_tiles_kernel", "halve_kernel",
              "run_tree_kernel")
GAUSSIAN_SIGMA = 2.0  # 2 ceil(3 sigma) + 1 = 13 taps a lane
# card-against-CPU gradient comparisons whose tables are bit for bit alike
# (measured 0 on an H100; the others, within 1.12e-7 there, take a full-AD
# sweep's or the BVH kernel's roundings)
CARD_CPU_EXACT = frozenset({
    "gradients golden", "geometry floor_point_steady", "ggx prb",
    "texels prb", "variant gradients pol_cbox", "4 shards PRB small cbox"})
# the largest card-against-CPU table share while the table-gradient
# reductions added by atomics (index_add_) on the card
ATOMICS_CARD_CPU = 6.71e-6
# the volumetric tutorial's held bounce (K1's path and first shadow-walk
# rays, K3's events) and its first-arrival bins (camera -> light)
VOL_HELD_BOUNCE = 1
VOL_FIRST_BINS = (15, 18)
VOL_COMPARE_SPP = 64  # the fog and black-fog renders (2^20 lanes)
VOL_GRID = dict(n=64, spp=128, max_depth=16)  # one pass of 2^21 lanes
VOL_GRAD = dict(spp=64, fullad_depth=8)  # 2^20 lanes, one chunk
# the polarized cbox (torch_cases.polarized_cbox: 256x256, 400 bins, depth
# 5, gold GGX small box), spp cut from the reference's 4096 for chip time;
# its held loop iteration; the gold box's pixels and the top rows, where
# every camera ray meets a diffuse wall first (Q = U = 0 exactly)
POL_CBOX = dict(spp=1024, seed=0)
POL_HELD_ITERATION = 1
POL_BOX = (slice(184, 232), slice(136, 200))
POL_DIFFUSE_ROWS = 128
SPECTRAL = dict(spp=256, seed=0)  # the spectral flagship: 8 passes of 32
STOKES12_SPP = 64  # rgb_polarized / spectral_polarized at the flagship film
# the polarimetric NLOS capture (torch_cases.polarized_nlos: 64x64 scan,
# 300 bins, the hidden Z, a gold GGX wall), spp cut from the reference's
# 65,536 for chip time: 2^23 lanes in 4 passes
POL_NLOS = dict(scan=64, bins=300, spp=2048)
VARIANT_TUTORIAL_SPP = 128  # the tutorial under the variants: 2^21 lanes
# the variant gradient calls: the polarized cbox and the spectral flagship
# at spp 16 (2^20 lanes, one chunk), the spectral tutorial's PRB replay at
# spp 64 (2^20), the polarized NLOS capture at spp 1024 (2^20), and
# forward mode of the polarized cbox at 64x64, spp 64
VARIANT_GRAD = dict(spp=16, tutorial_spp=64, nlos_spp=1024, forward_res=64,
                    forward_spp=64)
STOKES_FN_EVENTS = (64, 4096, 300)  # lanes a pixel, pixels, bins
BVH_SUBSET = 1 << 16  # rays of the kernel-against-plain comparison
K1_MISMATCH_SHARE = 1e-4  # BVH kernel (Woop) against K1 (Moller-Trumbore)
# the K1 / BVH crossover: UV spheres (rings, segments) of 64-8192
# triangles in place of the box's small cube
CROSSOVER = ((3, 16), (5, 16), (9, 16), (9, 32), (17, 32), (17, 64),
             (33, 64), (33, 128))
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and FP32 (non-tensor) ops/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations of one test, as the kernels write them
MT_OPS = 46  # Moller-Trumbore: 2 crosses, 3 dots, 4 subs, 1 div, u + v
SLAB_OPS = 23  # 6 subs, 6 muls, 6 min/max per axis pair, 5 min/max
WOOP_OPS = 40  # 6 dots of 3, 3 subs, neg, div, 2 mul-adds, u + v


def _run(cmd):
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    return (res.stdout + res.stderr).strip()


def _time_ms(fn, reps=TIMING_REPS, warmup=3, batches=TIMING_BATCHES):
    """Milliseconds of one call of ``fn`` on the card: the median over
    ``batches`` of the mean of ``reps`` calls made back to back between two
    CUDA events, so that the host's work for a launch overlaps the card's
    work for the one before, as in a render's loop."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def _bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and FP32
    operations over the FP32 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _rays(cases, scene, rng, n, dev):
    """``cases.box_rays`` for the scene's camera, on ``dev``."""
    import numpy as np
    import torch

    from mitransient_tpu_torch.sensors.perspective import build_camera

    cam = build_camera(scene.sensors[0], device="cpu")
    rays = cases.box_rays(rng, n, cam.R.numpy().astype(np.float64),
                          cam.origin.numpy(), cam.tan_half.numpy())
    return tuple(torch.from_numpy(a).to(dev) for a in rays)


def check_kernels(mt, cases, dev):
    """K1-K3 against their plain versions at the flagship's shapes."""
    import numpy as np
    import torch

    from mitransient_tpu_torch.film import transient_film as tf
    from mitransient_tpu_torch.ops import intersect as isect

    scene = mt.load_dict(mt.cornell_box(), device=dev)
    tri = scene.data.tri
    soup, table = (tri.v0, tri.e1, tri.e2), tri.table
    m = soup[0].shape[0]
    rng = np.random.default_rng(0)
    o, d, maxt, active = _rays(cases, scene, rng, N_RAYS, dev)
    # shadow rays get a finite maxt: the lengths of connections in the box
    maxt_sh = torch.from_numpy(
        rng.uniform(0.05, 3.0, N_RAYS).astype(np.float32)).to(dev)
    rows = []
    events, flagship_rays = flagship_iteration(mt, dev)

    # K1 closest hit, bit-equal (prim equal, t equal bit for bit; 0 rays
    # may differ) on random rays and on a flagship iteration's closest-hit
    # rays
    k1 = {}
    for name, rays in (("random", (o, d, maxt, active)),
                       ("flagship", flagship_rays["closest_hit"])):
        err, hits = hold_soup_rays(isect, soup, table, "closest_hit", rays,
                                   f"K1 closest_hit on {name} rays")
        n_rays, n_active = rays[0].shape[0], int(rays[3].sum())
        bound = _bound(ray_bytes(n_rays, n_active, 8) + m * 36,
                       n_active * m * MT_OPS)
        k1[name] = dict(
            max_abs_err=err, bound=bound, active_share=n_active / n_rays,
            ms=_time_ms(lambda: isect.closest_hit(*soup, *rays, table=table)),
            plain_ms=_time_ms(lambda: isect.intersect_soup(*soup, *rays)))
        print(f"K1 on {name} rays: {hits} hits of {n_active} "
              f"active of {n_rays} (active share {n_active / n_rays:.4f}) -> "
              f"bound {bound[0]:.4f} ms ({bound[1]}); kernel "
              f"{k1[name]['ms']:.4f} ms, plain {k1[name]['plain_ms']:.4f} ms")
    rnd, flag = k1["random"], k1["flagship"]
    rows.append(dict(
        bound_ms=rnd["bound"][0], bound_by=rnd["bound"][1],
        library_ms=None,
        name="closest_hit", route="cuda",
        source="mitransient_tpu_torch/csrc/intersect.cu",
        replaces="mitransient_tpu/ops/intersect_pallas.py:44",
        max_abs_err=max(rnd["max_abs_err"], flag["max_abs_err"]),
        ms=rnd["ms"], plain_ms=rnd["plain_ms"],
        flagship_ms=flag["ms"], flagship_plain_ms=flag["plain_ms"],
        flagship_bound_ms=flag["bound"][0], flagship_bound_by=flag["bound"][1],
        flagship_active_share=flag["active_share"]))

    # K2 any hit, bit-equal on random rays and on a flagship iteration's
    # shadow rays (0 rays may differ)
    k2 = {}
    for name, rays in (("random", (o, d, maxt_sh, active)),
                       ("flagship", flagship_rays["ray_test"])):
        err, occluded = hold_soup_rays(isect, soup, table, "ray_test", rays,
                                       f"K2 ray_test on {name} rays")
        n_rays, n_active = rays[0].shape[0], int(rays[3].sum())
        tests = any_hit_tests(isect, soup, *rays)
        bound = _bound(ray_bytes(n_rays, n_active, 1) + m * 36,
                       tests * MT_OPS)
        k2[name] = dict(
            max_abs_err=err, bound=bound, active_share=n_active / n_rays,
            ms=_time_ms(lambda: isect.ray_test(*soup, *rays, table=table)),
            plain_ms=_time_ms(lambda: isect.ray_test_soup(*soup, *rays)))
        print(f"K2 on {name} rays: {occluded} occluded of {n_active} "
              f"active of {n_rays} (active share {n_active / n_rays:.4f}); "
              f"{tests / max(n_active, 1):.2f} tests per active ray -> bound "
              f"{bound[0]:.4f} ms ({bound[1]}); kernel {k2[name]['ms']:.4f} "
              f"ms, plain {k2[name]['plain_ms']:.4f} ms")
    rnd, flag = k2["random"], k2["flagship"]
    rows.append(dict(
        bound_ms=rnd["bound"][0], bound_by=rnd["bound"][1],
        library_ms=None,
        name="ray_test", route="cuda",
        source="mitransient_tpu_torch/csrc/intersect.cu",
        replaces="mitransient_tpu/ops/intersect_pallas.py:98",
        max_abs_err=max(rnd["max_abs_err"], flag["max_abs_err"]),
        ms=rnd["ms"], plain_ms=rnd["plain_ms"],
        flagship_ms=flag["ms"], flagship_plain_ms=flag["plain_ms"],
        flagship_bound_ms=flag["bound"][0], flagship_bound_by=flag["bound"][1],
        flagship_active_share=flag["active_share"]))

    # K3 splat, two event sets into a (3, 301, 65536) film: random events
    # and one loop iteration's events of a flagship render
    hw = 256 * 256
    random_events = [
        torch.from_numpy(a).to(dev) for _ in range(2)
        for a in cases.splat_events(rng, SPLAT_LANES, hw, SPLAT_BINS)]
    k3 = {name: check_splat(tf, ev, hw, dev) for name, ev in (
        ("random", random_events), ("flagship", events))}
    for name, r in k3.items():
        print(f"K3 splat_accumulate on {name} events: bit-equal to the plain "
              f"version on the CPU; kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, index_add_ {r['library_ms']:.4f} ms; "
              f"{r['sectors']} of {3 * (SPLAT_BINS + 1) * hw // 8} film "
              f"sectors touched -> bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]})")
    rnd, flag = k3["random"], k3["flagship"]
    rows.append(dict(
        bound_ms=rnd["bound"][0], bound_by=rnd["bound"][1],
        library_ms=rnd["library_ms"],
        name="splat_accumulate", route="cuda",
        source="mitransient_tpu_torch/csrc/splat.cu",
        replaces="mitransient_tpu/ops/splat_pallas.py:36",
        max_abs_err=max(rnd["max_abs_err"], flag["max_abs_err"]),
        ms=rnd["ms"], plain_ms=rnd["plain_ms"],
        sectors=rnd["sectors"],
        flagship_ms=flag["ms"], flagship_plain_ms=flag["plain_ms"],
        flagship_library_ms=flag["library_ms"],
        flagship_bound_ms=flag["bound"][0], flagship_bound_by=flag["bound"][1],
        flagship_sectors=flag["sectors"]))
    for r in rows:
        print(f"{r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), library {r['library_ms']} ms")
    return rows


def ray_bytes(n_rays, n_active, out_bytes):
    """The bytes a soup query must move: every ray's active flag and
    result, and the o, d and maxt (28 bytes) of the active rays only."""
    return n_rays * (1 + out_bytes) + n_active * (12 + 12 + 4)


def hold_soup_rays(isect, soup, table, kernel, rays, label):
    """K1 (``kernel`` "closest_hit") or K2 ("ray_test") on ``rays`` (o, d,
    maxt, active) against its plain version on the same card: K1's prim
    equal and t bit for bit, K2's answer equal, on every ray (none may
    differ; the first ten that do are printed).  -> (the largest |error|:
    of t over K1's hits, of the 0/1 answer for K2; K1's hits or K2's
    occluded rays)."""
    import torch

    if kernel == "closest_hit":
        t_k, prim_k = isect.closest_hit(*soup, *rays, table=table)
        t_p, prim_p, _, _ = isect.intersect_soup(*soup, *rays)
        bad = (prim_k != prim_p) | (t_k != t_p)
        hit = prim_k >= 0
        err = float((t_k - t_p)[hit].abs().max()) if hit.any() else 0.0
        count = int(hit.sum())
    else:
        occ_k = isect.ray_test(*soup, *rays, table=table)
        occ_p = isect.ray_test_soup(*soup, *rays)
        bad = occ_k != occ_p
        err = float((occ_k.float() - occ_p.float()).abs().max())
        count = int(occ_k.sum())
    torch.cuda.synchronize()
    o, d, maxt, active = rays
    idx = torch.nonzero(bad).flatten().tolist()
    for i in idx[:10]:
        print(f"  {label} mismatch ray {i}: o={o[i].tolist()} "
              f"d={d[i].tolist()} maxt={maxt[i].item()} "
              f"active={bool(active[i])}")
    print(f"{label}: {len(idx)} of {bad.numel()} rays differ (none "
          "allowed)")
    if idx:
        raise AssertionError(f"{label}: {len(idx)} rays differ")
    return err, count


def any_hit_tests(isect, soup, o, d, maxt, active):
    """The Moller-Trumbore tests an any-hit query needs on these rays: up
    to the first hit below maxt for an active ray, all M for an active ray
    that misses, none for an inactive ray or one whose maxt leaves no room
    for a hit."""
    import torch

    m = soup[0].shape[0]
    hit, tt, _u, _v = isect._moller_trumbore(o, d, *soup)
    first = hit & (tt < maxt[:, None])
    need = torch.where(first.any(1), first.to(torch.int8).argmax(1) + 1, m)
    return int(torch.where(active & (maxt > isect.RAY_EPS), need, 0).sum())


def flagship_iteration(mt, dev):
    """What FLAGSHIP_EVENTS' loop iteration of a flagship render (at its
    spp and seed) hands the kernels, copied as their wrappers receive them:
    the two event sets K3 splats (bins_a, vals_a, bins_b, vals_b), and the
    closest-hit rays K1 and the shadow rays K2 test, each as (o, d, maxt,
    active) under the kernel's name."""
    import torch

    from mitransient_tpu_torch.film import transient_film as tf
    from mitransient_tpu_torch.ops import intersect as isect

    it = FLAGSHIP_EVENTS["iteration"]
    calls = {"splat": 0, "closest_hit": 0, "ray_test": 0}
    kept, rays = {}, {}
    active = {"closest_hit": 0, "ray_test": 0}  # summed over the render
    splat, soup_kernel = tf.splat_accumulate, isect._soup_kernel

    def capture_splat(film, *events, spp):
        if calls["splat"] == it:
            kept["events"] = [e.clone() for e in events]
        calls["splat"] += 1
        splat(film, *events, spp=spp)

    def capture_soup(kernel, table, m, *args):
        if calls[kernel] == it:
            rays[kernel] = tuple(a.clone() for a in args)
        calls[kernel] += 1
        active[kernel] = active[kernel] + args[3].sum()
        return soup_kernel(kernel, table, m, *args)

    scene = mt.load_dict(mt.cornell_box(), device=dev)
    tf.splat_accumulate, isect._soup_kernel = capture_splat, capture_soup
    try:
        mt.render(scene, spp=FLAGSHIP_EVENTS["spp"],
                  seed=FLAGSHIP_EVENTS["seed"])
    finally:
        tf.splat_accumulate, isect._soup_kernel = splat, soup_kernel
    torch.cuda.synchronize()
    if len(kept.get("events", ())) != 4 or len(rays) != 2:
        raise AssertionError(f"the flagship render made {calls}, too few "
                             f"to capture iteration {it}")
    for kernel, n_active in active.items():
        n = calls[kernel] * rays[kernel][0].shape[0]  # a fixed lane count
        print(f"flagship render (spp {FLAGSHIP_EVENTS['spp']}, seed "
              f"{FLAGSHIP_EVENTS['seed']}): {kernel} rays active "
              f"{int(n_active)} of {n} over {calls[kernel]} launches "
              f"(share {int(n_active) / n:.4f})")
    return kept["events"], rays


def check_splat(tf, events, hw, dev, t_pad=SPLAT_BINS + 1):
    """K3 on one or two event sets (bins, vals, ...) into a zeroed (C,
    t_pad, hw) film: the film must be bit-equal to the plain version run on
    the host CPU (which adds in lane order).  -> the largest |film
    difference|, the kernel's, the plain version's (on the card, where
    index_add_ uses atomics) and one index_add_'s ms, and the bound on
    these events (``splat_bound``)."""
    import torch

    sets = list(zip(events[0::2], events[1::2]))
    C = sets[0][1].shape[1]
    lanes = sets[0][0].shape[0] // hw
    flat = [a for ev in sets for a in ev] + [None] * (4 - 2 * len(sets))
    film_k = torch.zeros((C, t_pad, hw), device=dev)
    film_c = torch.zeros(film_k.shape)
    tf.splat_accumulate(film_k, *flat, spp=lanes)
    for b, v in sets:
        tf._scatter_layout(film_c, hw, b.cpu(), v.cpu())
    err = float((film_k.cpu() - film_c).abs().max())
    if not torch.equal(film_k.cpu(), film_c):
        raise AssertionError(f"K3 is not bit-equal to its plain version "
                             f"(max |dfilm| {err})")
    sectors, bound = splat_bound(events, hw, t_pad)
    film_p = torch.zeros_like(film_k)

    def plain():
        for b, v in sets:
            tf._scatter_layout(film_p, hw, b, v)

    # the library call: one index_add_ of the event sets into the flat
    # film, with the flat cell indices made beforehand
    pix = torch.arange(sets[0][0].shape[0], device=dev) % hw
    ch = torch.arange(C, device=dev)[:, None] * (t_pad * hw)
    cells = torch.cat([(ch + b.long()[None] * hw + pix[None]).reshape(-1)
                       for b, _ in sets])
    vals = torch.cat([v.T.reshape(-1) for _, v in sets])
    film_l = film_p.view(-1)
    return dict(
        max_abs_err=err, sectors=sectors, bound=bound,
        ms=_time_ms(lambda: tf.splat_accumulate(film_k, *flat, spp=lanes)),
        plain_ms=_time_ms(plain),
        library_ms=_time_ms(lambda: film_l.index_add_(0, cells, vals)))


def splat_bound(events, hw, t_pad=SPLAT_BINS + 1):
    """K3's least work on these events: the film's 32-byte sectors (8
    pixels of one (channel, bin) row) that a nonzero event with a bin in
    the film lands in, read once and written once, plus every event read
    once; one add for each such (event, channel).  -> (sectors, (bound_ms,
    bound_by))."""
    import torch

    keys, adds, event_bytes = [], 0, 0
    for b, v in zip(events[0::2], events[1::2]):
        pix = torch.arange(b.shape[0], device=b.device) % hw
        lands = ((b >= 0) & (b < t_pad))[:, None] & (v != 0)  # (lanes, C)
        lane, c = torch.nonzero(lands, as_tuple=True)
        keys.append((c * t_pad + b[lane].long()) * (hw // 8) + pix[lane] // 8)
        adds += lane.numel()
        event_bytes += (b.numel() + v.numel()) * 4
    sectors = torch.unique(torch.cat(keys)).numel()
    return sectors, _bound(2 * 32 * sectors + event_bytes, adds)


def render_flagship(mt, cases, dev):
    """The flagship render through the kernels; returns launch counts."""
    import torch

    from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts

    scene = mt.load_dict(mt.cornell_box(), device=dev)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    s, t, stats = mt.render(scene, return_stats=True, **FLAGSHIP)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    print(f"flagship render 1 (seed 0): {wall:.3f} s, launches {counts}, "
          f"loop iterations {stats['loop_iters']}, JAX-loop iterations "
          f"{int(stats['iters'])}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    n = stats["loop_iters"]
    for name in ("closest_hit", "ray_test", "splat_accumulate"):
        if counts.get(name, 0) != n or n == 0:
            raise AssertionError(f"{name} launched {counts.get(name, 0)} "
                                 f"times in {n} loop iterations")
    s, t = s.cpu().numpy(), t.cpu().numpy()
    print(f"steady {s.shape}, transient {t.shape}")
    fails = cases.physics_checks(s, t)
    prof = t.sum(axis=(0, 1, 3))
    print(f"first arrival bin {prof.nonzero()[0][0]}, transient/steady "
          f"{t.sum() / s.sum():.6f}, left wall {s[128, 6]}, right wall "
          f"{s[128, 249]}")
    if fails:
        raise AssertionError(f"flagship physics checks failed: {fails}")

    # a second run with a new seed, timed end to end
    t0 = time.perf_counter()
    _s, _t, stats2 = mt.render(scene, return_stats=True, spp=FLAGSHIP["spp"],
                               seed=1)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    rays = int(stats2["rays"])
    print(f"flagship render 2 (seed 1): {wall2:.3f} s, {rays} rays, "
          f"{stats2['loop_iters']} loop iterations -> "
          f"{rays / wall2 / 1e6:.2f} M rays/s")
    return counts


def render_golden(mt, cases, dev):
    """The cbox_rgb golden config on the card against its golden, under
    the CPU slice test's rule: no element outside rtol 5e-4 / atol
    5e-5 * max."""
    import numpy as np

    scene = mt.load_dict(cases.small_cbox(mt), device=dev)
    s, t = mt.render(scene, spp=8, seed=0)
    golden = np.load(os.path.join(ROOT, "tests", "goldens", "cbox_rgb.npz"))
    for key, got in (("steady", s.cpu().numpy()), ("transient", t.cpu().numpy())):
        m = cases.golden_mismatch(got, golden[key])
        print(f"cbox_rgb {key} vs golden: {m}")
        if not (m["shape_ok"] and m["n_bad"] == 0):
            raise AssertionError(f"cbox_rgb {key} disagrees with its golden")


def build_mesh(mt, cases, dev):
    """cbox_mesh loaded on the card; the host accel build timed, and it
    must run the native SAH builder."""
    import torch

    from mitransient_tpu_torch import native
    from mitransient_tpu_torch.ops.accel import build_accel_numpy

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native BVH builder did not build or load")
    print(f"native builder ready in {time.perf_counter() - t0:.3f} s: "
          f"{native.library_path().name}")
    desc = cases.cbox_mesh(mt)
    t0 = time.perf_counter()
    scene = mt.load_dict(desc, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    tri = scene.data.tri
    host = [a.cpu().numpy() for a in (tri.v0, tri.e1, tri.e2)]
    t0 = time.perf_counter()
    tables = build_accel_numpy(*host)
    build_s = time.perf_counter() - t0
    acc = scene.data.accel
    for k, a in tables.items():
        if not torch.equal(getattr(acc, k).cpu(), torch.from_numpy(a)):
            raise AssertionError(f"accel.{k} differs between two builds")
    c = acc.pages.shape[0]
    print(f"cbox_mesh: {tri.v0.shape[0]} triangles, {c} chunks of "
          f"{acc.pages.shape[1]} rows ({float(acc.rows.mean()):.1f} used on "
          f"average), {acc.sup_min.shape[0]} super-chunks, pages "
          f"{acc.pages.numel() * 4 / 1e6:.1f} MB; host accel build "
          f"{build_s:.3f} s, load_dict {load_s:.3f} s")
    return scene


def check_bvh(mt, cases, dev, scene):
    """The BVH kernel in both modes on all 2^21 rays: every 32nd ray held
    against query_plain for the three queries, and every ray against K1."""
    import numpy as np
    import torch

    from mitransient_tpu_torch.ops import bvh
    from mitransient_tpu_torch.ops import intersect as isect

    sd = scene.data
    acc = sd.accel
    rng = np.random.default_rng(1)
    rays = _rays(cases, scene, rng, N_RAYS, dev)
    stride = N_RAYS // BVH_SUBSET
    sub = tuple(a[::stride].contiguous() for a in rays)
    n = BVH_SUBSET
    accel_bytes = sum(t.numel() * 4 for t in acc)

    # The bound counts the work the closest-hit query needs on these rays:
    # a box's slab test gives the same answer on every visit, so each box
    # at most once per ray, and no more box or triangle tests than the
    # least of the linear picks of both modes and the two trees makes.
    # Counted on the subset, scaled.
    work = {}
    for mode in bvh.MODES:
        counts = {"slab": 0, "woop": 0, "box_once": 0}
        bvh.query_plain(acc, *sub, n, mode, counts=counts)
        work[mode] = {k: int(v) for k, v in counts.items()}
        print(f"bvh {mode} linear pick (query_plain): "
              f"{work[mode]['slab'] / n:.1f} box tests "
              f"({work[mode]['box_once'] / n:.1f} of distinct boxes) and "
              f"{work[mode]['woop'] / n:.1f} triangle tests per ray")
    trees = {mode: tree_stats(bvh, acc, sub, n, mode) for mode in bvh.MODES}
    for mode, tree in trees.items():
        print(f"bvh {mode} tree (kernel) on rays [::{stride}]: "
              f"{tree['box_tests'] / n:.1f} box tests and "
              f"{tree['triangle_tests'] / n:.1f} triangle tests per ray, "
              f"{tree['overflow_rays']} rays overflowed the queue")
        if tree["triangle_tests"] != work[mode]["woop"]:
            raise AssertionError(f"the {mode} tree swept other chunks than "
                                 "query_plain's linear pick")
    box = min([w["box_once"] for w in work.values()]
              + [t["box_tests"] for t in trees.values()])
    woop = min(w["woop"] for w in work.values())
    ops = N_RAYS / n * (box * SLAB_OPS + woop * WOOP_OPS)
    bound = _bound(N_RAYS * (12 + 12 + 4 + 1 + 8) + accel_bytes, ops)
    print(f"bvh bound: {box / n:.1f} box and {woop / n:.1f} triangle tests "
          f"per ray -> {bound[0]:.4f} ms ({bound[1]})")

    # Moller-Trumbore over the whole soup (K1), for the cross-check below
    t_1, p_1 = isect.closest_hit(sd.tri.v0, sd.tri.e1, sd.tri.e2, *rays,
                                 table=sd.tri.table)
    rows = []
    for mode in bvh.MODES:
        err = 0.0
        stats = {}
        for query, n_closest in (("closest", N_RAYS), ("any", 0),
                                 ("mixed", N_RAYS // 2)):
            t_f, p_f = bvh.query_kernel(acc, *rays, n_closest, mode)
            st = tree_stats(bvh, acc, rays, n_closest, mode)
            stats[query] = {k: v / N_RAYS for k, v in st.items()}
            print(f"bvh {mode} tree {query} on all {N_RAYS} rays: "
                  f"{st['box_tests'] / N_RAYS:.2f} box tests, "
                  f"{st['triangle_tests'] / N_RAYS:.2f} triangle tests "
                  f"per ray; queue overflowed on "
                  f"{st['overflow_rays'] / N_RAYS:.3e} of the rays")
            t_k, p_k = t_f[::stride], p_f[::stride]
            t_p, p_p = bvh.query_plain(acc, *sub, n_closest // stride, mode)
            torch.cuda.synchronize()
            bad = (p_k != p_p) | ~((t_k == t_p) | (torch.isinf(t_k)
                                                  & torch.isinf(t_p)))
            nbad = int(bad.sum())
            hit = (p_k >= 0) & (p_k == p_p)
            if hit.any():
                err = max(err, float((t_k - t_p)[hit].abs().max()))
            print(f"bvh {mode} {query}: {int((p_f >= 0).sum())} hits of "
                  f"{N_RAYS}; of rays [::{stride}] {nbad} differ from "
                  f"query_plain (at most {MAX_RAY_MISMATCHES})")
            for i in torch.nonzero(bad).flatten().tolist()[:5]:
                print(f"  ray {i * stride}: kernel ({t_k[i].item()}, "
                      f"{p_k[i].item()}) plain ({t_p[i].item()}, "
                      f"{p_p[i].item()})")
            if nbad > MAX_RAY_MISMATCHES:
                raise AssertionError(f"bvh {mode} {query}: {nbad} rays differ")

        # Woop through the BVH against Moller-Trumbore (K1), all rays
        t_b, p_b = isect.closest_hit(sd.tri.v0, sd.tri.e1, sd.tri.e2, *rays,
                                     accel=acc, bvh_mode=mode)
        torch.cuda.synchronize()
        share = float((p_b != p_1).float().mean())
        both = (p_b == p_1) & (p_b >= 0)
        rel = float(((t_b - t_1) / t_1)[both].abs().max())
        print(f"bvh {mode} against K1 on {N_RAYS} rays: prim differs on "
              f"{share:.3e} of the rays (at most {K1_MISMATCH_SHARE}); max "
              f"relative |dt| {rel:.3e} where prim agrees")
        if not share <= K1_MISMATCH_SHARE:
            raise AssertionError(f"the BVH kernel ({mode}) disagrees with K1")

        rows.append(dict(
            name=f"bvh_query_{mode}", route="cuda",
            source="mitransient_tpu_torch/csrc/bvh.cu",
            replaces=("mitransient_tpu/ops/bvh_pallas.py:138+804" if
                      mode == "chunk" else
                      "mitransient_tpu/ops/bvh_pallas.py:424+588"),
            max_abs_err=err,
            ms=_time_ms(lambda: bvh.query_kernel(acc, *rays, N_RAYS, mode)),
            plain_ms=_time_ms(lambda: bvh.query_plain(acc, *sub, n, mode),
                              reps=1, warmup=1, batches=3),
            plain_rays=n, bound_ms=bound[0], bound_by=bound[1],
            library_ms=None, per_ray=stats))
        print(f"bvh_query_{mode}: kernel {rows[-1]['ms']:.4f} ms at 2^21 "
              f"rays, plain {rows[-1]['plain_ms']:.4f} ms at 2^16 rays, "
              f"bound {bound[0]:.4f} ms ({bound[1]})")
    return rows


def crossover(mt, cases, dev):
    """K1 against the BVH kernel in both modes on 2^21 box rays, in the box
    with a UV sphere of each size in CROSSOVER for its small cube: one line
    per triangle count.  Where the loader builds no Accel (at most
    ACCEL_MIN_TRIS triangles), one is built directly.  The BVH's hits must
    agree with K1's as in check_bvh."""
    import numpy as np

    from mitransient_tpu_torch.ops import accel as TA
    from mitransient_tpu_torch.ops import bvh
    from mitransient_tpu_torch.ops import intersect as isect

    if TA.ACCEL_MIN_TRIS != 4096:
        raise AssertionError(f"ACCEL_MIN_TRIS is {TA.ACCEL_MIN_TRIS}, the "
                             "JAX loader's is 4096")
    for rings, segments in CROSSOVER:
        desc = cases.with_sphere(mt.cornell_box(), rings, segments)
        scene = mt.load_dict(desc, device=dev)
        sd, tri = scene.data, scene.data.tri
        acc, built = sd.accel, "loader"
        if acc is None:
            acc, built = TA.build_accel(*(a.cpu().numpy() for a in (
                tri.v0, tri.e1, tri.e2)), device=dev), "direct"
        rays = _rays(cases, scene, np.random.default_rng(3), N_RAYS, dev)
        soup = (tri.v0, tri.e1, tri.e2)
        _t1, p_1 = isect.closest_hit(*soup, *rays, table=tri.table)
        ms = {"K1": _time_ms(lambda: isect.closest_hit(*soup, *rays,
                                                       table=tri.table),
                             reps=5, warmup=1, batches=3)}
        share = {}
        for mode in bvh.MODES:
            _tb, p_b = bvh.query_kernel(acc, *rays, N_RAYS, mode)
            share[mode] = float((p_b != p_1).float().mean())
            if not share[mode] <= K1_MISMATCH_SHARE:
                raise AssertionError(f"crossover: the BVH kernel ({mode}) "
                                     "disagrees with K1")
            ms[mode] = _time_ms(lambda: bvh.query_kernel(acc, *rays, N_RAYS,
                                                         mode),
                                reps=5, warmup=1, batches=3)
        m = tri.v0.shape[0]
        print(f"crossover {m} triangles ({built} accel, "
              f"{acc.pages.shape[0]} chunks) on {N_RAYS} rays: K1 "
              f"{ms['K1']:.4f} ms, bvh chunk {ms['chunk']:.4f} ms, bvh super "
              f"{ms['super']:.4f} ms; prim differs from K1 on "
              + ", ".join(f"{share[k]:.3e} ({k})" for k in bvh.MODES)
              + f"; fastest {min(ms, key=ms.get)}")


def tree_stats(bvh, acc, rays, n_closest, mode):
    """The kernel's counts (``bvh.STATS``) over one launch on ``rays``."""
    import torch

    buf = torch.zeros(len(bvh.STATS), dtype=torch.int64,
                      device=rays[0].device)
    bvh.query_kernel(acc, *rays, n_closest, mode, stats=buf)
    return dict(zip(bvh.STATS, buf.tolist()))


def render_mesh(mt, cases, dev, scene):
    """cbox_mesh through the BVH kernel in each mode at the same spp;
    returns each mode's BVH launches in its run."""
    import torch

    from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mitransient_tpu_torch.ops import bvh

    counts = {}
    for mode in bvh.MODES:
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        s, t, stats = mt.render(scene, spp=MESH["spp"], seed=MESH["seed"],
                                return_stats=True, bvh_mode=mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = launch_counts()
        n = stats["loop_iters"]
        rays = int(stats["rays"])
        print(f"cbox_mesh {mode} spp {MESH['spp']}: {wall:.3f} s, {rays} rays"
              f" -> {rays / wall / 1e6:.2f} M rays/s; launches {c}, loop "
              f"iterations {n}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        want = {f"bvh_query_{mode}": 2 * n, "splat_accumulate": n}
        if n == 0 or c != want:
            raise AssertionError(f"cbox_mesh {mode}: launches {c}, expected "
                                 f"{want}")
        s, t = s.cpu().numpy(), t.cpu().numpy()
        fails = cases.physics_checks(s, t)
        prof = t.sum(axis=(0, 1, 3))
        print(f"  first arrival bin {prof.nonzero()[0][0]}, transient/steady "
              f"{t.sum() / s.sum():.6f}, left wall {s[128, 6]}, right wall "
              f"{s[128, 249]}")
        if fails:
            raise AssertionError(f"cbox_mesh {mode} physics checks: {fails}")
        counts[f"bvh_query_{mode}"] = c[f"bvh_query_{mode}"]
    return counts


def profile_render(label, render, top=0):
    """``render()`` under torch.profiler: the device's busy share (the
    union of the kernels' intervals against the render's wall time; the
    profiler itself slows the host), device time by kernel group (the BVH
    kernel, K1, K2, K3 and the rest) and, with ``top``, the ``top``
    kernels of most device time.  -> device ms by group."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:  # union of the kernels' intervals, in us
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    groups, names = {}, {}
    for e in kernels:
        g = ("bvh_query" if "bvh_tree_kernel" in e.name
             or "bvh_super_kernel" in e.name else
             "closest_hit" if "closest_hit_kernel" in e.name else
             "ray_test" if "any_hit_kernel" in e.name else
             "splat" if "splat_kernel" in e.name else "other")
        us = e.time_range.elapsed_us()
        groups[g] = groups.get(g, 0.0) + us
        names[e.name] = names.get(e.name, 0.0) + us
    total = sum(groups.values())
    print(f"{label}: wall {wall:.3f} s, {len(spans)} device kernels, busy "
          f"{busy / 1e6:.4f} s = {busy / 1e6 / wall:.3f} of wall; device "
          "time by group: "
          + ", ".join(f"{g} {t / 1e3:.2f} ms ({t / total:.3f})"
                      for g, t in sorted(groups.items())))
    for name, us in sorted(names.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {us / 1e3:9.2f} ms ({us / total:.3f}) {name[:100]}")
    return groups


def profile_mesh(mt, scene):
    """One cbox_mesh render in each mode (spp 64, seed 1) under
    torch.profiler (``profile_render``)."""
    from mitransient_tpu_torch.ops import bvh

    for mode in bvh.MODES:
        groups = profile_render(
            f"cbox_mesh profiled render ({mode}, spp {PROFILE_SPP})",
            lambda: mt.render(scene, spp=PROFILE_SPP, seed=1, bvh_mode=mode))
        if not groups.get("bvh_query"):
            raise AssertionError(f"the {mode} profile shows no BVH kernel "
                                 "time")


def render_small_sphere(mt, cases, dev):
    """The small sphere config on the card against the port on the host
    CPU: test_golden's rule, no element out."""
    out = []
    for d in (dev, "cpu"):
        scene = mt.load_dict(cases.small_sphere_cbox(mt), device=d)
        s, t = mt.render(scene, spp=8, seed=0)
        out.append((s.cpu().numpy(), t.cpu().numpy()))
    for k, got, want in zip(("steady", "transient"), out[0], out[1]):
        m = cases.golden_mismatch(got, want)
        print(f"small sphere {k}, card against CPU: {m}")
        if not (m["shape_ok"] and m["n_bad"] == 0):
            raise AssertionError(f"small sphere {k}: card and CPU disagree")


def check_threefry(dev):
    """Phase 11: the threefry draws of a multi-pass flagship pass on the
    card, bit-equal to the host CPU's, and their time per render."""
    import torch

    from mitransient_tpu_torch.core import rng

    key = rng.Sampler(0, N_RAYS, stream=5).key
    draws = {
        "draw_bounce_block (2^21, 6)":
            lambda d: rng.draw_bounce_block(key, 3, N_RAYS, 6, d),
        "Sampler.eval_2d (2^21 lanes)":
            lambda d: rng.Sampler(7, N_RAYS, 2, device=d).eval_2d(0),
    }
    ms = {}
    for name, draw in draws.items():
        got, want = draw(dev).cpu(), draw("cpu")
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"threefry {name}: the card's draw differs "
                                 "from the CPU's")
        ms[name] = _time_ms(lambda: draw(dev), reps=5, warmup=1, batches=3)
        print(f"threefry {name}: bit-equal to the CPU; {ms[name]:.4f} ms a "
              "draw on the card")
    block, jitter = ms.values()
    passes, depth = MULTIPASS_PASSES, 8
    per_render = passes * (depth * block + jitter)
    print(f"threefry per multi-pass flagship render ({passes} passes x "
          f"({depth} bounce blocks + 1 jitter draw)): {per_render:.1f} ms")
    return per_render


def render_multipass_flagship(mt, cases, dev, threefry_ms):
    """Phase 12: the flagship through the multi-pass accumulator; returns
    the launch counts of its first render and that render (host steady and
    transient, rays) with render 2's rays/s, which phase 36 compares with."""
    import torch

    from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts

    scene = mt.load_dict(mt.cornell_box(), device=dev)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    s, t, stats = mt.render(scene, return_stats=True, regenerate=False,
                            **FLAGSHIP)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    n = stats["loop_iters"]
    print(f"multi-pass flagship render 1 (seed 0): {wall:.3f} s, launches "
          f"{counts}, bounces {n} (spp {stats['spp']}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if n != MULTIPASS_PASSES * 8:
        raise AssertionError(f"the multi-pass flagship ran {n} bounces")
    for name in ("closest_hit", "ray_test", "splat_accumulate"):
        if counts.get(name, 0) != n:
            raise AssertionError(f"{name} launched {counts.get(name, 0)} "
                                 f"times in {n} bounces")
    s, t = s.cpu().numpy(), t.cpu().numpy()
    fails = cases.physics_checks(s, t)
    prof = t.sum(axis=(0, 1, 3))
    print(f"  first arrival bin {prof.nonzero()[0][0]}, transient/steady "
          f"{t.sum() / s.sum():.6f}, left wall {s[128, 6]}, right wall "
          f"{s[128, 249]}")
    if fails:
        raise AssertionError(f"multi-pass flagship physics checks: {fails}")
    t0 = time.perf_counter()
    _s, _t, stats2 = mt.render(scene, return_stats=True, regenerate=False,
                               spp=FLAGSHIP["spp"], seed=1)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    rays = int(stats2["rays"])
    print(f"multi-pass flagship render 2 (seed 1): {wall2:.3f} s, {rays} "
          f"rays -> {rays / wall2 / 1e6:.2f} M rays/s; threefry "
          f"{threefry_ms / 1e3:.3f} s of it ({threefry_ms / 1e3 / wall2:.3f})")
    return counts, dict(steady=s, transient=t, rays=int(stats["rays"]),
                        rays_per_s=rays / wall2)


def render_multipass_goldens(mt, cases, dev):
    """Phase 13: cbox_rgb_multipass and phasor on the card against their
    goldens, under test_golden's rule with no element out."""
    import copy

    import numpy as np

    phasor = mt.cornell_box()
    phasor["integrator"]["max_depth"] = 4
    phasor["sensor"]["film"] = {
        "type": "phasor_hdr_film", "width": 8, "height": 8,
        "temporal_bins": 400, "bin_width_opl": 0.02, "start_opl": 3.5,
        "wl_mean": 0.5, "wl_sigma": 0.5}
    for name, desc, variant, kw in (
            ("cbox_rgb_multipass", cases.small_cbox(mt), "rgb",
             dict(regenerate=False)),
            ("phasor", phasor, "mono", {})):
        mt.set_variant(variant)
        try:
            s, t = mt.render(mt.load_dict(copy.deepcopy(desc), device=dev),
                             spp=8, seed=0, **kw)
        finally:
            mt.set_variant("rgb")
        golden = np.load(os.path.join(ROOT, "tests", "goldens",
                                      f"{name}.npz"))
        for key, got in (("steady", s), ("transient", t)):
            m = cases.golden_mismatch(got.cpu().numpy(), golden[key])
            print(f"{name} {key} vs golden: {m}")
            if not (m["shape_ok"] and m["n_bad"] == 0):
                raise AssertionError(f"{name} {key} disagrees with its golden")


def multipass_card_against_cpu(mt, cases, dev):
    """Phase 14: multi-pass renders on the card against the CPU: the small
    sphere config (the BVH kernel twice a bounce, K1/K2 never) and one with
    camera_unwarp, both gaussian filters and a crop window.  Returns the
    gaussian-filtered render's launches on the card."""
    import copy

    from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mitransient_tpu_torch.ops import bvh

    filters = cases.small_cbox(mt)
    filters["integrator"].update(camera_unwarp=True, temporal_filter="gaussian",
                                 gaussian_stddev=1.5)
    filters["sensor"]["film"].update(
        rfilter={"type": "gaussian", "stddev": 0.6}, crop_offset_x=3,
        crop_offset_y=2, crop_width=10, crop_height=12)
    for name, desc in (("small sphere", cases.small_sphere_cbox(mt)),
                       ("unwarp + gaussian filters + crop", filters)):
        out = []
        for d in (dev, "cpu"):
            reset_launch_counts()
            s, t, stats = mt.render(mt.load_dict(copy.deepcopy(desc), device=d),
                                    spp=4, seed=0, return_stats=True)
            out.append((s.cpu().numpy(), t.cpu().numpy()))
            if d == dev:
                counts, n = launch_counts(), stats["loop_iters"]
        passes = n // desc["integrator"]["max_depth"]
        # the gaussian temporal filter splats through K3 at spp * K lanes;
        # camera_unwarp adds a closest-hit query a pass
        want = ({f"bvh_query_{bvh.BVH_MODE}": 2 * n, "splat_accumulate": n}
                if name == "small sphere" else
                {"closest_hit": n + passes, "ray_test": n,
                 "splat_accumulate": n})
        print(f"multi-pass {name} on the card: launches {counts}")
        if counts != want:
            raise AssertionError(f"multi-pass {name}: launches {counts}, "
                                 f"expected {want}")
        for k, got, ref in zip(("steady", "transient"), out[0], out[1]):
            m = cases.golden_mismatch(got, ref)
            print(f"multi-pass {name} {k}, card against CPU: {m}")
            if not (m["shape_ok"] and m["n_bad"] == 0):
                raise AssertionError(f"multi-pass {name} {k}: card and CPU "
                                     "disagree")
    return counts


def check_resume(mt, cases, dev):
    """Phase 15: a render resumed on the card from its second pass's state
    (through save_film_state / load_film_state) is bit for bit the
    uninterrupted render, with the box and the gaussian temporal
    filter."""
    import io

    import torch

    for tfilter in ("", "gaussian"):
        desc = cases.small_cbox(mt)
        desc["integrator"].update(temporal_filter=tfilter)
        scene = mt.load_dict(desc, device=dev)
        kw = dict(spp=12, seed=4, max_lanes=4 * 256, regenerate=False)
        states = []
        s0, t0 = mt.render(scene, checkpoint_callback=states.append, **kw)
        buf = io.BytesIO()
        mt.save_film_state(buf, states[1])
        buf.seek(0)
        s1, t1 = mt.render(scene, film_state=mt.load_film_state(buf), **kw)
        same = torch.equal(s0, s1) and torch.equal(t0, t1)
        print(f"resume on the card ({tfilter or 'box'} temporal filter) "
              f"from pass {states[1][1]} of {len(states)}: bit-identical "
              f"{same}")
        if not same:
            raise AssertionError(f"the resumed render ({tfilter or 'box'} "
                                 "filter) differs from the uninterrupted "
                                 "one")


def _check_energy(name, s, t, first_bins=None):
    """Finite, non-negative, some energy and, where given, the first
    arrival in ``first_bins``."""
    import numpy as np

    prof = t.reshape(-1, t.shape[-2], t.shape[-1]).sum(axis=(0, 2))
    nz = np.nonzero(prof)[0]
    first = int(nz[0]) if nz.size else None
    print(f"{name}: steady {s.shape}, transient {t.shape}, sum "
          f"{float(t.sum()):.6g}, first arrival bin {first}")
    if not (np.all(np.isfinite(s)) and np.all(np.isfinite(t))):
        raise AssertionError(f"{name}: non-finite values")
    if t.min() < 0 or s.min() < 0 or first is None:
        raise AssertionError(f"{name}: negative values or no energy")
    if first_bins and not first_bins[0] <= first <= first_bins[1]:
        raise AssertionError(f"{name}: first arrival bin {first} not in "
                             f"{first_bins}")


@contextlib.contextmanager
def capture_bounce(sizes, bounce=NLOS_EVENTS_BOUNCE, splat=None, picks=None):
    """While open, keep copies of what the kernels get in bounce ``bounce``
    of the renders run: K3's event sets under "events" (the ``splat``-th
    splat, by default the ``bounce``-th), and under a soup kernel's name
    ("closest_hit", "ray_test") the (o, d, maxt, active) of its
    ``bounce``-th launch on ``sizes[kernel]`` rays (a wavefront's launches,
    counted over every sweep of a differentiated render; the few-ray
    launches of a capture's constants do not count).  ``picks`` ({kernel:
    {launch index: key}}) keeps other launches instead, each under its
    key.  Yields the dict it fills."""
    from mitransient_tpu_torch.film import transient_film as tf
    from mitransient_tpu_torch.ops import intersect as isect

    calls = {"splat": 0, **{k: 0 for k in sizes}}
    splat_at = bounce if splat is None else splat
    picks = picks or {k: {bounce: k} for k in sizes}
    kept = {}
    splat, soup_kernel = tf.splat_accumulate, isect._soup_kernel

    def capture(film, *events, spp):
        if calls["splat"] == splat_at:
            kept["events"] = [e.clone() for e in events if e is not None]
        calls["splat"] += 1
        splat(film, *events, spp=spp)

    def capture_soup(kernel, table, m, *args):
        if args[0].shape[0] == sizes.get(kernel):
            key = picks.get(kernel, {}).get(calls[kernel])
            if key is not None:
                kept[key] = tuple(a.clone() for a in args)
            calls[kernel] += 1
        return soup_kernel(kernel, table, m, *args)

    tf.splat_accumulate, isect._soup_kernel = capture, capture_soup
    try:
        yield kept
    finally:
        tf.splat_accumulate, isect._soup_kernel = splat, soup_kernel


def hold_captured(scene, kept, label, dev, hw, t_pad=301):
    """K1, K2 and K3 on a render's captured inputs (``capture_bounce``)
    against their plain versions, bit for bit: K1 and K2 against the plain
    soup queries on the card, K3 against its plain version on the host CPU
    (``check_splat``, into a (C, t_pad, hw) film), where K3 ran.  Each
    timed, with its bound.  -> {capture key (the kernel's name, or a
    ``picks`` key): {max_abs_err, ms, plain_ms, bound, ...}}."""
    from mitransient_tpu_torch.film import transient_film as tf
    from mitransient_tpu_torch.ops import intersect as isect

    tri = scene.data.tri
    soup, table = (tri.v0, tri.e1, tri.e2), tri.table
    m = soup[0].shape[0]
    out = {}
    for key in [k for k in kept if k != "events"]:
        kernel = "ray_test" if key.startswith("ray_test") else "closest_hit"
        rays = kept[key]
        err, count = hold_soup_rays(isect, soup, table, kernel, rays,
                                    f"{key} on {label} rays")
        n_rays, n_active = rays[0].shape[0], int(rays[3].sum())
        if kernel == "closest_hit":
            query, plain = isect.closest_hit, isect.intersect_soup
            bound = _bound(ray_bytes(n_rays, n_active, 8) + m * 36,
                           n_active * m * MT_OPS)
        else:
            query, plain = isect.ray_test, isect.ray_test_soup
            bound = _bound(ray_bytes(n_rays, n_active, 1) + m * 36,
                           any_hit_tests(isect, soup, *rays) * MT_OPS)
        out[key] = dict(
            max_abs_err=err, bound=bound,
            ms=_time_ms(lambda: query(*soup, *rays, table=table)),
            plain_ms=_time_ms(lambda: plain(*soup, *rays), reps=3, warmup=1,
                              batches=3))
        r = out[key]
        print(f"{key} on {label} rays ({n_active} active of {n_rays}, "
              f"{count} {'hits' if kernel == 'closest_hit' else 'occluded'}, "
              f"{m} triangles): kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    if "events" not in kept:
        return out
    k3 = check_splat(tf, kept["events"], hw, dev, t_pad=t_pad)
    print(f"splat_accumulate on {label} events "
          f"({kept['events'][0].shape[0]} lanes, {hw} slots, "
          f"{len(kept['events']) // 2} event sets): bit-equal to the plain version on the CPU; kernel "
          f"{k3['ms']:.4f} ms, plain {k3['plain_ms']:.4f} ms, index_add_ "
          f"{k3['library_ms']:.4f} ms; {k3['sectors']} film sectors touched "
          f"-> bound {k3['bound'][0]:.4f} ms ({k3['bound'][1]})")
    out["splat_accumulate"] = k3
    return out


def render_nlos_single(mt, cases, dev):
    """Phase 16: the NLOS single capture at full width; returns its launch
    counts and K1-K3 on one bounce's inputs (``hold_captured``)."""
    import torch

    from mitransient_tpu_torch.core import rng
    from mitransient_tpu_torch.integrators import nlos_path
    from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts

    scene = mt.load_dict(cases.nlos_scene(sx=NLOS_SCAN, sy=NLOS_SCAN),
                         device=dev)
    mt.nlos.focus_emitter_at_relay_wall_pixel([NLOS_SCAN / 2] * 2, scene)
    reset_launch_counts()
    nlos_path.prepare_nlos(scene, scene.sensors[0])
    prep = launch_counts()
    print(f"NLOS prepare_nlos: launches {prep}")

    # render 1 keeps what the kernels get in bounce NLOS_EVENTS_BOUNCE:
    # K3's events, K1's closest-hit and K2's vertex -> wall rays
    lanes = NLOS["spp"] * NLOS_SCAN ** 2
    hw = NLOS_SCAN ** 2
    reset_launch_counts()
    with capture_bounce({"closest_hit": lanes, "ray_test": lanes}) as kept:
        s, t, stats = mt.render(scene, return_stats=True, **NLOS)
        torch.cuda.synchronize()
    counts = launch_counts()
    n = stats["loop_iters"]
    print(f"NLOS single {NLOS_SCAN}x{NLOS_SCAN} spp {NLOS['spp']} render 1 "
          f"(seed 0, its kernel inputs captured): launches {counts} in {n} "
          "bounces")
    want = {k: n + prep.get(k, 0) for k in ("closest_hit", "ray_test",
                                            "splat_accumulate")}
    if n != 4 or counts != want or len(kept) != 3 or len(kept["events"]) != 2:
        raise AssertionError(f"NLOS single: launches {counts}, expected "
                             f"{want} (one event set a splat)")
    _check_energy("NLOS single", s.cpu().numpy(), t.cpu().numpy(),
                  NLOS_FIRST_BINS)
    held = hold_captured(scene, kept, f"NLOS bounce {NLOS_EVENTS_BOUNCE}'s",
                         dev, hw)
    del s, t, kept

    # render 2, uninstrumented: wall, rays/s, peak memory
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _s, _t, stats2 = mt.render(scene, return_stats=True, spp=NLOS["spp"],
                               seed=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    rays = int(stats2["rays"])
    key = rng.Sampler(1, lanes).key
    draw_ms = _time_ms(lambda: rng.draw_bounce_block(
        key, 2, lanes, nlos_path.NLOS_DIMS_PER_BOUNCE, dev), reps=5,
        warmup=1, batches=3)
    share = n * draw_ms / 1e3 / wall
    print(f"NLOS single render 2 (seed 1): {wall:.4f} s, {rays} rays -> "
          f"{rays / wall / 1e6:.2f} M rays/s, peak memory {peak:.2f} GiB; "
          f"threefry ({lanes}, 10) {draw_ms:.4f} ms a bounce, {n} bounces = "
          f"{share:.3f} of the wall")
    kern = n * sum(held[k]["ms"] for k in held) / 1e3
    print(f"NLOS single render 2 split ({wall:.4f} s): threefry "
          f"{n * draw_ms / 1e3:.4f} s, K1-K3 {kern:.4f} s (bounce "
          f"{NLOS_EVENTS_BOUNCE}'s times x {n}), the rest (eager bounce "
          f"code, prepare, develop) {wall - n * draw_ms / 1e3 - kern:.4f} s")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _s, t3, stats3 = mt.render(scene, return_stats=True, spp=NLOS_SPP_LONG,
                               seed=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rays = int(stats3["rays"])
    print(f"NLOS single spp {NLOS_SPP_LONG} (seed 2, {stats3['spp']} spp in "
          f"{stats3['loop_iters'] // 4} passes): {wall:.4f} s, {rays} rays -> "
          f"{rays / wall / 1e6:.2f} M rays/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _check_energy(f"NLOS single spp {NLOS_SPP_LONG}", _s.cpu().numpy(),
                  t3.cpu().numpy(), NLOS_FIRST_BINS)
    return counts, held


def render_nlos_golden(mt, cases, dev):
    """Phase 17: the nlos_single golden config on the card."""
    import numpy as np

    scene = mt.load_dict(cases.nlos_scene(sx=4, sy=4, bins=200), device=dev)
    s, t = mt.render(scene, spp=16, seed=0)
    golden = np.load(os.path.join(ROOT, "tests", "goldens", "nlos_single.npz"))
    for key, got in (("steady", s), ("transient", t)):
        m = cases.golden_mismatch(got.cpu().numpy(), golden[key])
        print(f"nlos_single {key} vs golden: {m}")
        if not (m["shape_ok"] and m["n_bad"] == 0):
            raise AssertionError(f"nlos_single {key} disagrees with its golden")


def check_launches(label, counts, n, accel):
    """K3 once in each of the ``n`` loop iterations or bounces, and the
    ray queries at least once each: K1 and K2, or with an ``accel`` the
    BVH kernel twice (closest hit and shadow rays) and K1 and K2 never."""
    from mitransient_tpu_torch.ops import bvh

    if accel:
        rays_ok = (counts.get(f"bvh_query_{bvh.BVH_MODE}", 0) >= 2 * n
                   and not {"closest_hit", "ray_test"} & set(counts))
    else:
        rays_ok = min(counts.get(k, 0) for k in ("closest_hit",
                                                 "ray_test")) >= n
    if counts.get("splat_accumulate") != n or not rays_ok:
        raise AssertionError(f"{label}: launches {counts} in {n} loop "
                             f"iterations or bounces (accel {accel})")


def nlos_card_against_cpu(mt, cases, dev):
    """Phase 18: the NLOS configurations on the card against the CPU."""
    from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts

    for name in cases.NLOS_CASES:
        out = []
        for d in (dev, "cpu"):
            desc, run = cases.nlos_case(mt, name)
            reset_launch_counts()
            scene = mt.load_dict(desc, device=d)
            s, t, stats = run(scene)
            out.append((s.cpu().numpy(), t.cpu().numpy(), int(stats["rays"])))
            if d == dev:
                counts, n = launch_counts(), stats["loop_iters"]
                accel = scene.data.accel is not None
        print(f"NLOS {name} on the card: launches {counts}, {n} bounces, rays "
              f"{out[0][2]} (CPU {out[1][2]})")
        check_launches(f"NLOS {name}", counts, n, accel)
        if abs(out[0][2] - out[1][2]) > 1e-3 * out[1][2]:
            raise AssertionError(f"NLOS {name}: ray counts differ")
        for k, got, ref in zip(("steady", "transient"), out[0], out[1]):
            m = cases.golden_mismatch(got, ref)
            print(f"NLOS {name} {k}, card against CPU: {m}")
            if not (m["shape_ok"] and m["n_bad"] == 0):
                raise AssertionError(f"NLOS {name} {k}: card and CPU "
                                     "disagree")


def render_nlos_scans(mt, cases, dev):
    """Phase 19: the full confocal scan and the exhaustive capture, each
    rendered twice: render 1 (seed 0) warms up, passes the physics checks
    and, for the exhaustive capture, keeps one bounce's kernel inputs,
    which ``hold_captured`` holds against the plain versions (K2 on all
    Lc * lanes vertex -> wall rays, K3 into the Lc * hw slot film); render
    2 (seed 1) gives the wall time, rays/s and peak memory.  -> the
    exhaustive capture's ``hold_captured``."""
    import torch

    from mitransient_tpu_torch.integrators import nlos_path
    from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts

    conf = cases.nlos_confocal(cases.nlos_scene(sx=1, sy=1), NLOS_SCAN,
                               NLOS_SCAN)
    exh = cases.nlos_exhaustive(cases.nlos_scene(sx=NLOS_SCAN, sy=NLOS_SCAN),
                                EXHAUSTIVE["lasers"], EXHAUSTIVE["lasers"])
    hw = NLOS_SCAN ** 2
    lanes = EXHAUSTIVE["spp"] * hw  # one pass
    # render_nlos_exhaustive's laser chunk: 32 of the 64 lasers
    lc = min(EXHAUSTIVE["lasers"] ** 2, nlos_path.LANE_LASER_PAIRS // lanes)
    held = None
    for name, desc, run in (
            (f"scan_confocal {NLOS_SCAN}x{NLOS_SCAN} spp {CONFOCAL_SPP}", conf,
             lambda sc, seed: mt.nlos.scan_confocal(
                 sc, spp=CONFOCAL_SPP, seed=seed, return_stats=True)),
            (f"exhaustive {NLOS_SCAN}x{NLOS_SCAN} x {EXHAUSTIVE['lasers']}x"
             f"{EXHAUSTIVE['lasers']} lasers spp {EXHAUSTIVE['spp']}", exh,
             lambda sc, seed: mt.render(sc, spp=EXHAUSTIVE["spp"], seed=seed,
                                        return_stats=True))):
        scene = mt.load_dict(desc, device=dev)
        exhaustive = name.startswith("exhaustive")
        reset_launch_counts()
        sizes = {"closest_hit": lanes, "ray_test": lc * lanes}
        with (capture_bounce(sizes) if exhaustive
              else contextlib.nullcontext({})) as kept:
            s, t, stats = run(scene, 0)
            torch.cuda.synchronize()
        print(f"NLOS {name} render 1 (seed 0): launches {launch_counts()} in "
              f"{stats['loop_iters']} bounces")
        _check_energy(f"NLOS {name}", s.cpu().numpy(), t.cpu().numpy())
        del s, t
        if exhaustive:
            if len(kept) != 3 or len(kept["events"]) != 2:
                raise AssertionError(f"NLOS {name}: captured {sorted(kept)}, "
                                     f"expected K1 rays of {lanes}, K2 rays "
                                     f"of {lc * lanes} and one event set")
            held = hold_captured(scene, kept, f"exhaustive bounce "
                                 f"{NLOS_EVENTS_BOUNCE}'s", dev, lc * hw)
            del kept
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        s, t, stats = run(scene, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rays = int(stats["rays"])
        print(f"NLOS {name} render 2 (seed 1): {wall:.4f} s, {rays} rays -> "
              f"{rays / wall / 1e6:.2f} M rays/s; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return held


def lobe_ms(mt, scene, rays):
    """Milliseconds of one loop iteration's lobe code on ``scene``: the BSDF
    gather, ``eval_pdf`` toward the ceiling light's centre and ``sample``,
    on the hits of the closest-hit ``rays`` (o, d, maxt, active)."""
    import torch

    from mitransient_tpu_torch.bsdf import api as bsdf_api
    from mitransient_tpu_torch.core.records import Ray
    from mitransient_tpu_torch.scene.scene import primal_sd, ray_intersect

    sd = primal_sd(scene.data)
    si = ray_intersect(sd, Ray(*rays[:3]), rays[3])
    gen = torch.Generator(device=rays[0].device).manual_seed(0)
    n = si.t.shape[0]
    u1 = torch.rand(n, generator=gen, device=rays[0].device)
    u2 = torch.rand((n, 2), generator=gen, device=rays[0].device)
    light = torch.tensor([0.0, 0.99, 0.01], device=rays[0].device)
    wo = si.frame.to_local(torch.nn.functional.normalize(light - si.p,
                                                         dim=-1))

    def lobes():
        lb = bsdf_api.gather_lane_bsdf(sd.bsdf, si.bsdf_id, si.uv,
                                       sd.bsdf_kinds)
        bsdf_api.eval_pdf(lb, si.wi, wo, si.valid)
        bsdf_api.sample(lb, si.wi, u1, u2, si.valid)

    return _time_ms(lobes, reps=5, warmup=1, batches=3)


def render_materials_flagship(mt, cases, dev):
    """Phase 20: the materials flagship at full width; returns its launch
    counts and K1-K3 on one loop iteration's inputs (``hold_captured``)."""
    import torch

    from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts

    scene = mt.load_dict(cases.materials_cbox(mt), device=dev)
    print(f"materials flagship: BSDF kinds {scene.data.bsdf_kinds}")
    it = MATERIALS_EVENTS_ITERATION
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with capture_bounce({"closest_hit": N_RAYS, "ray_test": N_RAYS},
                        bounce=it) as kept:
        s, t, stats = mt.render(scene, return_stats=True, **FLAGSHIP)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    n = stats["loop_iters"]
    print(f"materials flagship render 1 (seed 0, iteration {it}'s kernel "
          f"inputs captured): {wall:.3f} s, launches {counts}, loop "
          f"iterations {n}")
    for name in ("closest_hit", "ray_test", "splat_accumulate"):
        if counts.get(name, 0) != n or n == 0:
            raise AssertionError(f"materials flagship: {name} launched "
                                 f"{counts.get(name, 0)} times in {n} loop "
                                 "iterations")
    if len(kept) != 3 or len(kept["events"]) != 4:
        raise AssertionError(f"materials flagship: captured {sorted(kept)}")
    s, t = s.cpu().numpy(), t.cpu().numpy()
    prof = t.sum(axis=(0, 1, 3))
    h, w = s.shape[0] // 256, s.shape[1] // 256  # pixels a 256th
    print(f"  first arrival bin {prof.nonzero()[0][0]}, transient/steady "
          f"{t.sum() / s.sum():.6f}, left wall {s[128 * h, 6 * w]}, right "
          f"wall {s[128 * h, 249 * w]}, glass box {s[180 * h, 150 * w]}, "
          f"gold box {s[128 * h, 90 * w]}")
    fails = cases.physics_checks(s, t)
    if fails:
        raise AssertionError(f"materials flagship physics checks: {fails}")
    del s, t
    held = hold_captured(scene, kept, f"materials iteration {it}'s", dev,
                         256 * 256)
    rays = kept["closest_hit"]
    lobes = lobe_ms(mt, scene, rays)
    diffuse = lobe_ms(mt, mt.load_dict(mt.cornell_box(), device=dev), rays)
    del kept

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _s, _t, stats2 = mt.render(scene, return_stats=True, spp=FLAGSHIP["spp"],
                               seed=1)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    n2, n_rays = stats2["loop_iters"], int(stats2["rays"])
    print(f"materials flagship render 2 (seed 1): {wall2:.3f} s, {n_rays} "
          f"rays, {n2} loop iterations -> {n_rays / wall2 / 1e6:.2f} M "
          f"rays/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    per_it = wall2 / n2 * 1e3
    kern = sum(held[k]["ms"] for k in held)
    print(f"materials flagship iteration: {per_it:.3f} ms (render 2's wall "
          f"over its iterations); lobe code (gather, eval_pdf, sample on "
          f"2^21 hits) {lobes:.3f} ms = {lobes / per_it:.3f} of it (the "
          f"diffuse flagship's lobe code on the same rays {diffuse:.3f} ms); "
          f"K1-K3 on iteration {it}'s inputs {kern:.3f} ms = "
          f"{kern / per_it:.3f}")
    del _s, _t
    t0 = time.perf_counter()
    _s, _t, stats3 = mt.render(scene, return_stats=True, regenerate=False,
                               **FLAGSHIP)
    torch.cuda.synchronize()
    wall3 = time.perf_counter() - t0
    n_rays = int(stats3["rays"])
    print(f"materials flagship multi-pass (regenerate=False, seed 0): "
          f"{wall3:.3f} s, {n_rays} rays -> {n_rays / wall3 / 1e6:.2f} M "
          f"rays/s")
    _check_energy("materials flagship multi-pass", _s.cpu().numpy(),
                  _t.cpu().numpy())
    return counts, held


def render_angulararea(mt, cases, dev):
    """Phase 21: the angulararea example at its canonical size."""
    import torch

    share = {}
    for kind, em in cases.ROOM_EMITTERS.items():
        scene = mt.load_dict(cases.room(dict(em), ROOM["res"], ROOM["bins"]),
                             device=dev)
        s, t = mt.render(scene, spp=ROOM["spp"], seed=0)
        s, t = s.cpu().numpy(), t.cpu().numpy()
        _check_energy(f"room with the {kind} light", s, t)
        share[kind] = cases.room_spot_share(s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _s, _t, stats = mt.render(scene, spp=ROOM["spp"], seed=1,
                                  return_stats=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rays = int(stats["rays"])
        print(f"room {ROOM['res']}x{ROOM['res']} x {ROOM['bins']} bins, spp "
              f"{ROOM['spp']}, {kind} light: floor energy under the light "
              f"{share[kind]:.4f}; render 2 (seed 1) {wall:.3f} s, "
              f"{stats['loop_iters']} loop iterations, {rays} rays -> "
              f"{rays / wall / 1e6:.2f} M rays/s")
    if not share["angulararea"] > share["area"]:
        raise AssertionError(f"the angulararea light does not concentrate "
                             f"the floor's energy: {share}")


def materials_card_against_cpu(mt, cases, dev):
    """Phase 22: the material configurations on the card against the CPU,
    regen and multi-pass."""
    from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts

    for name in cases.MATERIAL_CASES:
        for multipass in (False, True):
            label = f"{name} {'multi-pass' if multipass else 'regen'}"
            out = []
            for d in (dev, "cpu"):
                desc, run = cases.material_case(mt, name)
                reset_launch_counts()
                scene = mt.load_dict(desc, device=d)
                s, t, stats = run(scene, multipass)
                out.append((s.cpu().numpy(), t.cpu().numpy(),
                            int(stats["rays"])))
                if d == dev:
                    counts, n = launch_counts(), stats["loop_iters"]
                    accel = scene.data.accel is not None
            print(f"{label} on the card: launches {counts}, {n} loop "
                  f"iterations or bounces, rays {out[0][2]} (CPU {out[1][2]})")
            check_launches(label, counts, n, accel)
            for k, got, ref in zip(("steady", "transient"), out[0], out[1]):
                m = cases.golden_mismatch(got, ref)
                print(f"{label} {k}, card against CPU: {m}")
                if not (m["shape_ok"] and m["n_bad"] == 0):
                    raise AssertionError(f"{label} {k}: card and CPU "
                                         "disagree")


def _tables_close(label, got, want, atol=GRAD_TABLE_ATOL):
    """Two DiffParams (card, CPU) field by field: within ``atol`` of each
    table's largest |value|, over the finite elements; a NaN must stand
    where the CPU has one (the polarized box's roughness and poses, ROADMAP
    queue 3); the other elements bit for bit where ``label`` is in
    ``CARD_CPU_EXACT`` (a NaN's payload may differ).  -> the largest such
    share."""
    import torch

    worst = 0.0
    for f in got._fields:
        g, w = getattr(got, f), getattr(want, f)
        if (g is None) != (w is None):
            raise AssertionError(f"{label}: table {f} present on one side")
        if g is None:
            continue
        g, w = g.cpu(), w.cpu()
        nan = torch.isnan(w)
        if not torch.equal(torch.isnan(g), nan):
            raise AssertionError(f"{label}: table {f} has NaN elsewhere")
        g, w = g[~nan], w[~nan]
        if label in CARD_CPU_EXACT and not _bit_equal(g, w):
            raise AssertionError(f"{label}: table {f} is not bit for bit the "
                                 "CPU's")
        if w.numel() == 0:
            continue
        scale = max(float(w.abs().max()), 1e-30)
        share = float((g - w).abs().max()) / scale
        worst = max(worst, share)
        if not share <= atol:
            raise AssertionError(f"{label}: table {f} differs by {share:.3g} "
                                 f"of its largest value (allowed {atol})")
    return worst


def _bit_equal(a, b):
    """Two float32 tensors of one shape hold the same bits (a NaN equals
    a NaN of the same payload; -0 is not +0)."""
    import torch

    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _tables_equal(label, got, want):
    """Two DiffParams (or tuples of tensors) bit for bit, field by field,
    on the host."""
    for i, (g, w) in enumerate(zip(got, want)):
        if (g is None) != (w is None):
            raise AssertionError(f"{label}: field {i} present on one side")
        if g is not None and not _bit_equal(g.cpu(), w.cpu()):
            raise AssertionError(f"{label}: field {i} differs")


def _grad_in(film_cfg, rng, steady=False):
    """(grad_steady, grad_transient) for a film: uniform [0, 1) adjoints
    made by numpy from ``rng`` (the steady one only with ``steady``)."""
    import numpy as np

    h, w, T = film_cfg.height, film_cfg.width, film_cfg.temporal_bins
    gs = rng.random((h, w, 3)).astype(np.float32) if steady else None
    return gs, rng.random((h, w, T, 3)).astype(np.float32)


def _timed(fn):
    """(result, seconds) of ``fn()`` up to a synchronize, with the peak
    memory it allocated (GiB)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2**30)


def prb_backward_phase(mt, cases, dev):
    """Phase 23: PRB backward.  Returns the K1-K3 launches of the flagship
    backward and K1 and K2 on the inputs of its replay sweep's bounce
    ``GRAD_HELD_BOUNCE`` (``hold_captured``)."""
    import numpy as np
    import torch

    from mitransient_tpu_torch.integrators import prb
    from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mitransient_tpu_torch.ops import bvh

    # 1. the gradients golden, card against its golden and the CPU
    golden = np.load(os.path.join(ROOT, "tests", "goldens",
                                  "gradients.npz"))
    grad_in = (np.ones((8, 8, 3), np.float32),
               np.ones((8, 8, 100, 3), np.float32))
    tabs = {}
    for d in (dev, "cpu"):
        scene = mt.load_dict(cases.gradients_cbox(mt), device=d)
        tabs[str(d)] = mt.render_backward(scene, grad_in, **cases.GRADIENTS)[
            "__tables__"]
    for k in ("bsdf_reflectance", "emitter_radiance"):
        for label, got in (("golden", golden[k]),
                           ("CPU", getattr(tabs["cpu"], k).numpy())):
            m = cases.golden_mismatch(getattr(tabs[str(dev)], k).cpu().numpy(),
                                      got)
            print(f"gradients {k} on the card vs {label}: {m}")
            if not (m["shape_ok"] and m["n_bad"] == 0):
                raise AssertionError(f"gradients {k}: card against {label}")
    worst = _tables_close("gradients golden", tabs[str(dev)], tabs["cpu"])
    print(f"gradients golden, card against CPU: tables within {worst:.3g} "
          f"of their largest value (with atomics: {ATOMICS_CARD_CPU})")

    # 2. optimize_reflectance's full configuration, 3 Adam steps
    cfg = cases.OPTIMIZE_REFLECTANCE
    scene = mt.load_dict(cases.time_window_cbox(mt, cfg["res"], cfg["bins"]),
                         device=dev)
    path = "white.reflectance.value"
    params = mt.traverse(scene)
    true_val = params[path].clone()
    _s, target = mt.render(scene, spp=cfg["spp"], seed=cfg["target_seed"])
    theta = torch.tensor(cfg["start"], device=dev, requires_grad=True)
    opt = torch.optim.Adam([theta], lr=cfg["lr"])
    err0 = float((theta.detach() - true_val).abs().max())
    print(f"optimize_reflectance ({cfg['res']}x{cfg['res']}, {cfg['bins']} "
          f"bins, depth 4, spp {cfg['spp']} = {cfg['res'] ** 2 * cfg['spp']} "
          f"lanes): start max|theta - true| {err0:.4f}")
    for step in range(3):
        params[path] = theta.detach()
        params.update()
        (_s, img), t_render, _m = _timed(lambda: mt.render(
            scene, spp=cfg["spp"], seed=step, regenerate=False))
        adj = (2.0 / img.numel()) * (img - target)
        grads, t_back, peak = _timed(lambda: mt.render_backward(
            scene, (None, adj), spp=cfg["spp"], seed=step))
        loss = float(((img - target) ** 2).mean())
        if step == 0:
            # the same gradient by full AD: each splat's adjoint at its own
            # bin, where PRB reads it at the vertex's
            exact, t_full, peak_full = _timed(lambda: mt.render_backward(
                scene, (None, adj), spp=cfg["spp"], seed=step,
                method="fullad")[path])
            print(f"optimize_reflectance step 0 gradient: PRB "
                  f"{grads[path].cpu().numpy()}, full AD "
                  f"{exact.cpu().numpy()} ({t_full:.4f} s, peak memory "
                  f"{peak_full:.2f} GiB)")
        theta.grad = grads[path].clone()
        opt.step()
        with torch.no_grad():
            theta.clamp_(0.0, 1.0)
        err = float((theta.detach() - true_val).abs().max())
        print(f"optimize_reflectance step {step} (seed {step}): loss "
              f"{loss:.6e}, max|theta - true| {err:.4f}, render "
              f"{t_render:.4f} s, render_backward {t_back:.4f} s, peak "
              f"memory {peak:.2f} GiB")
        if not np.isfinite(loss) or not torch.isfinite(theta).all():
            raise AssertionError("optimize_reflectance: non-finite step")

    # 3. render_backward on the flagship frame, 2^23 lanes in one pass
    scene = mt.load_dict(mt.cornell_box(), device=dev)
    film_cfg = scene.sensors[0].film
    rng = np.random.default_rng(11)
    grad_in = _grad_in(film_cfg, rng, steady=True)
    lanes = film_cfg.width * film_cfg.height * GRAD_FLAGSHIP["spp"]
    depth = scene.integrator.max_depth
    # call 1 keeps what K1 and K2 get in the replay sweep's bounce
    # GRAD_HELD_BOUNCE (the primal sweep launches them `depth` times first)
    reset_launch_counts()
    with capture_bounce({"closest_hit": lanes, "ray_test": lanes},
                        bounce=depth + GRAD_HELD_BOUNCE) as kept:
        g1, wall1, peak1 = _timed(lambda: mt.render_backward(
            scene, grad_in, **GRAD_FLAGSHIP))
    counts = launch_counts()
    print(f"flagship render_backward ({lanes} lanes, depth {depth}, rr_depth "
          f"{scene.integrator.rr_depth}) call 1 (its replay's kernel inputs "
          f"captured): {wall1:.3f} s, launches {counts}, peak memory "
          f"{peak1:.2f} GiB")
    if (counts.get("closest_hit") != 2 * depth
            or counts.get("ray_test") != 2 * depth
            or "splat_accumulate" in counts
            or counts.get("reduce_rows", 0) < depth):
        raise AssertionError(f"flagship backward: launches {counts}, "
                             f"expected K1 and K2 {2 * depth} times each "
                             "and K8 at least once a bounce")
    for f in g1["__tables__"]._fields:
        v = getattr(g1["__tables__"], f)
        if v is not None and not torch.isfinite(v).all():
            raise AssertionError(f"flagship backward: {f} not finite")
    if set(kept) != {"closest_hit", "ray_test"}:
        raise AssertionError(f"flagship backward: captured {set(kept)}")
    held = hold_captured(scene, kept, f"PRB replay bounce {GRAD_HELD_BOUNCE}'s",
                         dev, film_cfg.width * film_cfg.height)
    del kept
    g2, wall2, peak2 = _timed(lambda: mt.render_backward(
        scene, grad_in, **GRAD_FLAGSHIP))
    print(f"flagship render_backward call 2: {wall2:.3f} s -> "
          f"{lanes * 2 / wall2 / 1e6:.2f} M lanes/s over both sweeps, peak "
          f"memory {peak2:.2f} GiB")
    # call 3: the time in autograd's backward (table_grads), synchronized
    spent = []
    table_grads = prb.table_grads

    def timed_table_grads(obj, leaves):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = table_grads(obj, leaves)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    prb.table_grads = timed_table_grads
    try:
        _g3, wall3, _p = _timed(lambda: mt.render_backward(
            scene, grad_in, **GRAD_FLAGSHIP))
    finally:
        prb.table_grads = table_grads
    print(f"flagship render_backward call 3 (synchronized around autograd): "
          f"{wall3:.3f} s, autograd's backward {sum(spent):.4f} s in "
          f"{len(spent)} bounces = {sum(spent) / wall3:.3f} of the call")
    # call 4 under the profiler: the table-gradient reductions' share
    _profile_backward(mt, scene, grad_in)

    # 4. the 4,512-triangle sphere config through the BVH kernel
    tabs = {}
    for d in (dev, "cpu"):
        sc = mt.load_dict(cases.small_sphere_cbox(mt), device=d)
        reset_launch_counts()
        tabs[str(d)] = mt.render_backward(
            sc, _grad_in(sc.sensors[0].film, np.random.default_rng(12)),
            spp=8, seed=0)["__tables__"]
        if d == dev:
            sphere_counts = launch_counts()
    worst = _tables_close("sphere backward", tabs[str(dev)], tabs["cpu"])
    print(f"small sphere render_backward on the card: launches "
          f"{sphere_counts}; tables against the CPU within {worst:.3g} of "
          f"their largest value (with atomics: {ATOMICS_CARD_CPU})")
    if sphere_counts.get(f"bvh_query_{bvh.BVH_MODE}", 0) < 2 * 2 * 6:
        raise AssertionError(f"sphere backward: launches {sphere_counts}")
    return counts, held


def _profile_backward(mt, scene, grad_in):
    """One flagship render_backward under torch.profiler: device time by
    kernel group, the table-gradient reductions (K8's kernels: the
    backward of every table gather) apart; no ``index_add_`` kernel
    (``indexFunc*``) may be left."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mt.render_backward(scene, grad_in, **GRAD_FLAGSHIP)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    groups, by_name, k8 = {}, {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        mine = [k for k in K8_KERNELS if k in e.name]
        for k in mine:
            n, t = k8.get(k, (0, 0.0))
            k8[k] = (n + 1, t + us)
        g = ("table_grad_reduction" if mine
             else "index_add" if "indexFunc" in e.name
             else "ray_kernels" if ("hit_kernel" in e.name
                                    or "bvh_" in e.name) else "other")
        groups[g] = groups.get(g, 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    total = sum(groups.values())
    if not total:
        raise AssertionError("the profiled backward shows no device time")
    print(f"flagship render_backward profiled: wall {wall:.3f} s, device "
          f"time {total / 1e6:.4f} s in {len(kernels)} kernels; by group: "
          + ", ".join(f"{g} {t / 1e3:.2f} ms ({t / total:.3f})"
                      for g, t in sorted(groups.items())))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print("  largest kernels: " + "; ".join(
        f"{n[:60]} {t / 1e3:.2f} ms" for n, t in top))
    print("  K8's kernels: " + ", ".join(
        f"{k} {n} launches {t / 1e3:.3f} ms" for k, (n, t) in k8.items()))
    # the flagship's tables are all regime (a): every call launches both
    if "index_add" in groups or any(
            k not in k8 for k in ("tile_partials_kernel", "sum_tiles_kernel")):
        raise AssertionError(f"the profiled backward's groups {groups}, K8 "
                             f"{k8}: expected K8's tile_partials_kernel and "
                             "sum_tiles_kernel and no index_add_ kernel")


def forward_mode_phase(mt, cases, dev):
    """Phase 24: forward mode.  Returns the launches of the
    forward_time_gradients render and K1-K3 on the inputs of its replay
    sweep's bounce ``GRAD_HELD_BOUNCE`` and that bounce's derivative splat
    (``hold_captured``)."""
    import numpy as np

    from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts

    cfg = cases.FORWARD_TIME_GRADIENTS
    scene = mt.load_dict(cases.time_window_cbox(mt, cfg["res"], cfg["bins"]),
                         device=dev)
    tangent = {"green.reflectance.value": [1.0, 1.0, 1.0]}
    lanes = cfg["res"] ** 2 * cfg["spp"]
    depth = scene.integrator.max_depth
    reset_launch_counts()
    with capture_bounce({"closest_hit": lanes, "ray_test": lanes},
                        bounce=depth + GRAD_HELD_BOUNCE,
                        splat=GRAD_HELD_BOUNCE) as kept:
        (ds, dt), wall1, peak1 = _timed(lambda: mt.render_forward(
            scene, tangent, spp=cfg["spp"], seed=0))
    counts = launch_counts()
    (_ds, _dt), wall2, peak2 = _timed(lambda: mt.render_forward(
        scene, tangent, spp=cfg["spp"], seed=1))
    print(f"forward_time_gradients ({cfg['res']}x{cfg['res']}, {cfg['bins']} "
          f"bins, depth {depth}, spp {cfg['spp']} = {lanes} lanes): call 1 "
          f"{wall1:.3f} s, launches {counts}; call 2 (seed 1) {wall2:.3f} s, "
          f"peak memory {peak2:.2f} GiB; d_steady sum {float(ds.sum()):.6g}, "
          f"d_transient sum {float(dt.sum()):.6g}")
    if counts != {"closest_hit": 2 * depth, "ray_test": 2 * depth,
                  "splat_accumulate": depth}:
        raise AssertionError(f"forward replay: launches {counts}, expected "
                             f"K3 once a bounce ({depth})")
    if not (np.isfinite(dt.cpu().numpy()).all() and float(dt.sum()) > 0):
        raise AssertionError("forward_time_gradients: non-finite or no "
                             "derivative")
    if len(kept) != 3 or len(kept["events"]) != 2:
        raise AssertionError(f"forward replay: captured {set(kept)}")
    held = hold_captured(scene, kept, f"forward replay bounce "
                         f"{GRAD_HELD_BOUNCE}'s", dev, cfg["res"] ** 2)
    del kept
    out = []
    for d in (dev, "cpu"):
        sc = mt.load_dict(cases.grad_cbox(mt), device=d)
        out.append([a.cpu().numpy() for a in mt.render_forward(
            sc, {"white.reflectance.value": [1.0, 1.0, 1.0]},
            spp=cases.GRAD_SPP, seed=0)])
    for k, got, want in zip(("d_steady", "d_transient"), out[0], out[1]):
        m = cases.golden_mismatch(got, want)
        print(f"test_grad box render_forward {k}, card against CPU: {m}")
        if not (m["shape_ok"] and m["n_bad"] == 0):
            raise AssertionError(f"forward {k}: card and CPU disagree")
    return counts, held


def full_ad_phase(mt, cases, dev):
    """Phase 25: full AD and K3's autograd Function.  Returns (the K3
    Function's errors and the gather's times, the NLOS full-AD launches)."""
    import numpy as np
    import torch
    from torch.autograd import forward_ad as fwAD

    from mitransient_tpu_torch.film import transient_film as tf
    from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts

    # 1. the Function on the NLOS single capture's bounce-1 events
    scene = mt.load_dict(cases.nlos_scene(sx=NLOS_SCAN, sy=NLOS_SCAN),
                         device=dev)
    mt.nlos.focus_emitter_at_relay_wall_pixel([NLOS_SCAN / 2] * 2, scene)
    hw = NLOS_SCAN ** 2
    with capture_bounce({}) as kept:
        mt.render(scene, **NLOS)
    bins, vals = kept["events"][:2]
    shape = (vals.shape[1], scene.sensors[0].film.temporal_bins + 1, hw)
    lanes = bins.shape[0] // hw
    rng = np.random.default_rng(13)
    w = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    v = vals.clone().requires_grad_()
    film = tf.SplatEvents.apply(torch.zeros(shape, device=dev), bins,
                                v * 1.0, None, None, lanes)
    (g_fn,) = torch.autograd.grad((film * w).sum(), v)
    p = vals.clone().requires_grad_()
    plain = torch.zeros(shape, device=dev)
    tf._scatter_layout(plain, hw, bins, p * 1.0)
    (g_plain,) = torch.autograd.grad((plain * w).sum(), p)
    bwd_err = float((g_fn - g_plain).abs().max())
    if not torch.equal(g_fn, g_plain):
        raise AssertionError(f"K3 Function backward differs from the plain "
                             f"version's autograd ({bwd_err})")
    tan = torch.from_numpy(rng.normal(size=vals.shape).astype(np.float32))
    with fwAD.dual_level():
        out = tf.SplatEvents.apply(torch.zeros(shape, device=dev), bins,
                                   fwAD.make_dual(vals, tan.to(dev)), None,
                                   None, lanes)
        t_card = fwAD.unpack_dual(out).tangent.cpu()
        ref = torch.zeros(shape)
        tf._scatter_layout(ref, hw, bins.cpu(),
                           fwAD.make_dual(vals.cpu(), tan))
        t_cpu = fwAD.unpack_dual(ref).tangent
    jvp_err = float((t_card - t_cpu).abs().max())
    if not torch.equal(t_card, t_cpu):
        raise AssertionError(f"K3 Function jvp differs from the plain "
                             f"version's forward AD on the CPU ({jvp_err})")
    # the backward gather beside its bound: the film sectors the events
    # land in read once, the bins read once, the (N, C) cotangent written
    sectors, _b = splat_bound([bins, vals], hw, shape[1])
    gather_bound = _bound(32 * sectors + bins.numel() * 4 + vals.numel() * 4,
                          0)
    gfilm = w
    cells = tf.gather_index(bins, shape)
    idx = ((torch.arange(shape[0], device=dev)[None, :] * (shape[1] * hw))
           + (bins.long() * hw + torch.arange(bins.shape[0], device=dev)
              % hw)[:, None]).reshape(-1)
    flat = gfilm.reshape(-1)
    k3fn = dict(
        backward_max_abs_err=bwd_err, jvp_max_abs_err=jvp_err,
        gather_ms=_time_ms(lambda: tf.gather_cells(gfilm, *cells)),
        gather_bound_ms=gather_bound[0], gather_bound_by=gather_bound[1],
        gather_library_ms=_time_ms(lambda: flat.index_select(0, idx)))
    print(f"K3 Function on the NLOS bounce-{NLOS_EVENTS_BOUNCE} events "
          f"({bins.shape[0]} lanes, {hw} pixels): backward bit-equal to the "
          "plain version's index_add_ autograd on the card, jvp bit-equal to "
          "its forward AD on the CPU; the backward gather "
          f"{k3fn['gather_ms']:.4f} ms, one index_select "
          f"{k3fn['gather_library_ms']:.4f} ms, bound "
          f"{gather_bound[0]:.4f} ms ({gather_bound[1]}, {sectors} sectors)")

    # 2. full AD of the 32 x 32 single capture, spp 2048 (2 chunks)
    fc = scene.sensors[0].film
    grad_in = _grad_in(fc, np.random.default_rng(14))
    reset_launch_counts()
    grads, wall, peak = _timed(lambda: mt.render_backward(
        scene, grad_in, spp=NLOS["spp"], seed=0))
    counts = launch_counts()
    key = "hidden-target.bsdf.reflectance.value"
    print(f"NLOS single {NLOS_SCAN}x{NLOS_SCAN} render_backward (full AD, "
          f"spp {NLOS['spp']} in 2 chunks of 2^20 lanes): {wall:.3f} s, "
          f"peak memory {peak:.2f} GiB, launches {counts}; {key} "
          f"{grads[key].cpu().numpy()}")
    depth = scene.integrator.max_depth
    if counts.get("splat_accumulate") != 2 * depth or not torch.isfinite(
            grads[key]).all() or not (grads[key] > 0).all():
        raise AssertionError(f"NLOS full AD: launches {counts} (K3 expected "
                             f"{2 * depth}), gradient {grads[key]}")
    _g, wall2, _p = _timed(lambda: mt.render_backward(
        scene, grad_in, spp=NLOS["spp"], seed=1))
    print(f"NLOS single render_backward call 2 (seed 1): {wall2:.3f} s")

    # 3. the geometry, GGX-alpha and texel cases, card against CPU
    for name, (light, adjoint, _paths) in sorted(cases.GEOMETRY_CASES.items()):
        tabs = {}
        for d in (dev, "cpu"):
            sc = mt.load_dict(cases.flat_scene(light), device=d)
            tabs[str(d)] = mt.render_backward(
                sc, cases.flat_adjoint(adjoint), spp=64, seed=0,
                method="fullad")["__tables__"]
        worst = _tables_close(f"geometry {name}", tabs[str(dev)],
                              tabs["cpu"])
        print(f"geometry {name} full AD, card against CPU: tables within "
              f"{worst:.3g} of their largest value (with atomics: {ATOMICS_CARD_CPU})")
    for name in ("ggx", "texels"):
        for method in (None, "fullad"):
            tabs = {}
            for d in (dev, "cpu"):
                sc = mt.load_dict(cases.diff_case(mt, name), device=d)
                tabs[str(d)] = mt.render_backward(
                    sc, _grad_in(sc.sensors[0].film,
                                 np.random.default_rng(15)),
                    spp=16, seed=0, method=method)["__tables__"]
            worst = _tables_close(f"{name} {method or 'prb'}",
                                  tabs[str(dev)], tabs["cpu"])
            print(f"{name} {method or 'prb'} backward, card against CPU: "
                  f"tables within {worst:.3g} of their largest value (with atomics: "
                  f"{ATOMICS_CARD_CPU})")
    return k3fn, counts


def volumetric_card_against_cpu(mt, cases, dev):
    """Phase 26: the ``volumetric`` golden on the card against its golden
    (within ``VOLUMETRIC_TIES``, as on the CPU), then every
    ``VOL_CASES`` configuration card against CPU."""
    import numpy as np
    import torch

    d = cases.vol_cbox(mt, 2.0, 0.9, 0.1, bins=120)
    s, t = mt.render(mt.load_dict(d, device=dev), spp=8, seed=0)
    golden = np.load(os.path.join(ROOT, "tests", "goldens", "volumetric.npz"))
    for key, got in (("steady", s), ("transient", t)):
        m = cases.golden_mismatch(got.cpu().numpy(), golden[key])
        print(f"volumetric {key} vs golden: {m} (coplanar ties allowed: "
              f"{cases.VOLUMETRIC_TIES[key]})")
        if not (m["shape_ok"] and m["n_bad"] <= cases.VOLUMETRIC_TIES[key]):
            raise AssertionError(f"volumetric {key} disagrees with its "
                                 "golden")
    for name in cases.VOL_CASES:
        desc, kw = cases.vol_case(mt, name)
        out = [mt.render(mt.load_dict(desc, device=d), **kw)
               for d in (dev, "cpu")]
        same = all(torch.equal(a.cpu(), b) for a, b in zip(*out))
        for key, got, want in zip(("steady", "transient"), *out):
            m = cases.golden_mismatch(got.cpu().numpy(), want.numpy())
            if not (m["shape_ok"] and m["n_bad"] == 0):
                raise AssertionError(f"volumetric {name} {key}: card and CPU "
                                     f"disagree ({m})")
        print(f"volumetric {name}, card against CPU: none out, bit-equal "
              f"{same}")
        if not same:
            raise AssertionError(f"volumetric {name}: card and CPU not bit "
                                 "for bit")


def render_volumetric_tutorial(mt, cases, dev):
    """Phase 27: the volumetric tutorial at full size, then its grid
    variant.  Returns the tutorial render's launches and K1 and K3 on its
    bounce ``VOL_HELD_BOUNCE``'s inputs (``hold_captured``)."""
    import numpy as np
    import torch

    from mitransient_tpu_torch.core import rng
    from mitransient_tpu_torch.integrators import volpath
    from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts

    cfg = cases.TUTORIAL
    scene = mt.load_dict(cases.tutorial_cbox(mt), device=dev)
    hw = cfg["res"] ** 2
    steps = 1 + volpath.TRANSMITTANCE_STEPS
    first = steps * VOL_HELD_BOUNCE  # K1's launches before the held bounce
    lanes = 1 << 21
    reset_launch_counts()
    with capture_bounce({"closest_hit": lanes}, splat=VOL_HELD_BOUNCE,
                        picks={"closest_hit": {
                            first: "closest_hit",
                            first + 1: "closest_hit_walk"}}) as kept:
        s, t, stats = mt.render(scene, spp=cfg["spp"], seed=0,
                                return_stats=True)
        torch.cuda.synchronize()
    counts = launch_counts()
    n = stats["loop_iters"]
    passes = n // cfg["max_depth"]
    print(f"volumetric tutorial {cfg['res']}x{cfg['res']}, {cfg['bins']} "
          f"bins, depth {cfg['max_depth']}, spp {cfg['spp']} ({passes} "
          f"passes of {lanes} lanes) render 1 (seed 0, its kernel inputs "
          f"captured): launches {counts} in {n} bounces")
    if counts != {"closest_hit": steps * n, "splat_accumulate": n}:
        raise AssertionError(f"volumetric tutorial: launches {counts}, "
                             f"expected K1 {steps} and K3 1 a bounce, K2 "
                             "never")
    s_np, t_np = s.cpu().numpy(), t.cpu().numpy()
    _check_energy("volumetric tutorial", s_np, t_np, VOL_FIRST_BINS)
    # the fog's in-scattered light: more energy than black fog
    sums = {}
    for albedo in (0.9, 0.0):
        d = cases.tutorial_cbox(mt)
        d["small-box"]["medium"]["albedo"]["value"] = [albedo] * 3
        st = mt.render(mt.load_dict(d, device=dev), spp=VOL_COMPARE_SPP,
                       seed=3)[0]
        sums[albedo] = float(st.sum())
    print(f"volumetric tutorial at spp {VOL_COMPARE_SPP}: steady sum "
          f"{sums[0.9]:.6g} with fog of albedo 0.9, {sums[0.0]:.6g} with "
          "black fog")
    if not sums[0.9] > sums[0.0]:
        raise AssertionError("volumetric tutorial: the fog adds no energy")
    if len(kept) != 3 or len(kept["events"]) != 4:
        raise AssertionError(f"volumetric tutorial: captured {set(kept)}")
    walk = kept["closest_hit_walk"]
    print(f"volumetric bounce {VOL_HELD_BOUNCE}'s shadow walk: "
          f"{int(walk[3].sum())} active rays")
    held = hold_captured(scene, kept, f"volumetric bounce "
                         f"{VOL_HELD_BOUNCE}'s", dev, hw,
                         t_pad=cfg["bins"] + 1)
    del s, t, kept

    # render 2, uninstrumented: wall, rays/s, peak memory, threefry share
    (_s, _t, stats2), wall, peak = _timed(lambda: mt.render(
        scene, spp=cfg["spp"], seed=1, return_stats=True))
    rays = int(stats2["rays"])
    key = rng.Sampler(1, lanes).key
    draw_ms = _time_ms(lambda: rng.draw_bounce_block(
        key, 2, lanes, volpath.VOL_DIMS_PER_BOUNCE, dev), reps=5, warmup=1,
        batches=3)
    share = n * draw_ms / 1e3 / wall
    kern = n * (steps * held["closest_hit"]["ms"]
                + held["splat_accumulate"]["ms"]) / 1e3
    print(f"volumetric tutorial render 2 (seed 1): {wall:.4f} s, {rays} rays "
          f"-> {rays / wall / 1e6:.2f} M rays/s, peak memory {peak:.2f} GiB; "
          f"threefry ({lanes}, {volpath.VOL_DIMS_PER_BOUNCE}) {draw_ms:.4f} "
          f"ms a bounce, {n} bounces = {share:.3f} of the wall; K1 x "
          f"{steps} + K3 {kern:.4f} s (bounce {VOL_HELD_BOUNCE}'s times x "
          f"{n}); the rest (eager bounce code) "
          f"{wall - n * draw_ms / 1e3 - kern:.4f} s")

    # the grid variant: a seeded 64^3 density in the small box
    g = VOL_GRID
    grid = mt.load_dict(cases.tutorial_grid(mt, n=g["n"],
                                            max_depth=g["max_depth"]),
                        device=dev)
    reset_launch_counts()
    _s, t1, st1 = mt.render(grid, spp=g["spp"], seed=0, return_stats=True)
    gcounts = launch_counts()
    ng = st1["loop_iters"]
    if gcounts != {"closest_hit": steps * ng, "splat_accumulate": ng}:
        raise AssertionError(f"volumetric grid: launches {gcounts}")
    _check_energy("volumetric grid", _s.cpu().numpy(), t1.cpu().numpy(),
                  VOL_FIRST_BINS)
    (_s, _t, st2), gwall, gpeak = _timed(lambda: mt.render(
        grid, spp=g["spp"], seed=1, return_stats=True))
    grays = int(st2["rays"])
    track_ms = _time_ms(lambda: volpath.tracking_draw(
        key, 3, lanes, (volpath.DELTA_STEPS, 2), dev), reps=2, warmup=1,
        batches=3)
    ratio_ms = _time_ms(lambda: volpath.tracking_draw(
        key, 1000, lanes, (volpath.RATIO_STEPS,), dev), reps=2, warmup=1,
        batches=3)
    print(f"volumetric grid ({g['n']}^3 density, scale 3; {cfg['res']}x"
          f"{cfg['res']}, depth {g['max_depth']}, spp {g['spp']} = {lanes} "
          f"lanes): launches {gcounts} in {ng} bounces; render 2 (seed 1) "
          f"{gwall:.4f} s, {grays} rays -> {grays / gwall / 1e6:.2f} M rays/s, "
          f"peak memory {gpeak:.2f} GiB; one ({lanes}, "
          f"{volpath.DELTA_STEPS}, 2) tracking draw {track_ms:.4f} ms, one "
          f"({lanes}, {volpath.RATIO_STEPS}) {ratio_ms:.4f} ms")
    # render 3: the tracking loops (draws included), synchronized around
    spent = {"delta_track_flight": [0.0, 0], "segment_transmittance": [0.0, 0]}
    originals = {name: getattr(volpath, name) for name in spent}

    def synchronized(name):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = originals[name](*args, **kw)
            torch.cuda.synchronize()
            spent[name][0] += time.perf_counter() - t0
            spent[name][1] += 1
            return out
        return run

    for name in spent:
        setattr(volpath, name, synchronized(name))
    try:
        _r, gwall3, _p = _timed(lambda: mt.render(grid, spp=g["spp"], seed=1))
    finally:
        for name, fn in originals.items():
            setattr(volpath, name, fn)
    track = sum(v[0] for v in spent.values())
    draws = ng * (track_ms + volpath.TRANSMITTANCE_STEPS * ratio_ms) / 1e3
    print(f"volumetric grid render 3 (synchronized around the tracking): "
          f"{gwall3:.4f} s; delta tracking {spent['delta_track_flight'][0]:.4f}"
          f" s in {spent['delta_track_flight'][1]} calls, ratio tracking "
          f"{spent['segment_transmittance'][0]:.4f} s in "
          f"{spent['segment_transmittance'][1]} calls: {track / gwall3:.3f} "
          f"of the wall, of which the draws ~{draws:.4f} s "
          f"({draws / gwall3:.3f}), the eager density steps the rest")
    return counts, held


def _profile_forward(mt, cases, dev, tangent, depth=2, spp=64):
    """One volumetric render_forward (the tutorial's film at ``depth``,
    ``spp``) under torch.profiler: its wall against the host time of its
    operators and the device time of its kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    scene = mt.load_dict(cases.tutorial_cbox(mt, max_depth=depth),
                         device=dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mt.render_forward(scene, tangent, spp=spp, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    device = sum(e.time_range.elapsed_us() for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    host = sum(e.self_cpu_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CPU)
    if not device:
        raise AssertionError("the profiled forward shows no device time")
    print(f"volumetric render_forward profiled (depth {depth}, spp {spp}): "
          f"wall {wall:.3f} s, host operators {host / 1e6:.4f} s, device "
          f"kernels {device / 1e6:.4f} s")


def volumetric_gradients(mt, cases, dev):
    """Phase 28: volumetric PRB backward at the tutorial's film and depth,
    full AD and forward mode at depth ``VOL_GRAD['fullad_depth']``, each
    timed with its peak memory; on the small configurations each card
    against CPU.  Returns the PRB backward's launches."""
    import numpy as np
    import torch

    from mitransient_tpu_torch.integrators import volpath
    from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts

    cfg = cases.TUTORIAL
    scene = mt.load_dict(cases.tutorial_cbox(mt), device=dev)
    fc = scene.sensors[0].film
    grad_in = _grad_in(fc, np.random.default_rng(21), steady=True)
    lanes = fc.width * fc.height * VOL_GRAD["spp"]
    depth = cfg["max_depth"]
    reset_launch_counts()
    g, wall, peak = _timed(lambda: mt.render_backward(
        scene, grad_in, spp=VOL_GRAD["spp"], seed=0))
    counts = launch_counts()
    tabs = g["__tables__"]
    print(f"volumetric render_backward (PRB; {fc.width}x{fc.height}, depth "
          f"{depth}, spp {VOL_GRAD['spp']} = {lanes} lanes in one chunk): "
          f"{wall:.3f} s, peak memory {peak:.2f} GiB, launches {counts}; "
          f"medium_albedo {tabs.medium_albedo.cpu().numpy()}")
    steps = 1 + volpath.TRANSMITTANCE_STEPS
    if (counts.get("closest_hit") != 2 * steps * depth
            or counts.get("reduce_rows", 0) < depth
            or set(counts) != {"closest_hit", "reduce_rows"}):
        raise AssertionError(f"volumetric backward: launches {counts}")
    if not all(torch.isfinite(v).all() for v in tabs if v is not None):
        raise AssertionError("volumetric backward: non-finite tables")

    small = mt.load_dict(cases.tutorial_cbox(
        mt, max_depth=VOL_GRAD["fullad_depth"]), device=dev)
    _g, wall_f, peak_f = _timed(lambda: mt.render_backward(
        small, grad_in, spp=VOL_GRAD["spp"], seed=0, method="fullad"))
    tangent = {"small-box.medium.albedo.value": [1.0, 1.0, 1.0],
               "small-box.medium.sigma_t.value": 0.5}
    # the first forward-mode call of a process pays PyTorch's one-time set-up
    # of its forward-AD formulas (seconds): timed apart from call 2
    _d, wall_j1, _p = _timed(lambda: mt.render_forward(
        small, tangent, spp=VOL_GRAD["spp"], seed=0))
    (ds, dt), wall_j, peak_j = _timed(lambda: mt.render_forward(
        small, tangent, spp=VOL_GRAD["spp"], seed=1))
    print(f"volumetric full AD (depth {VOL_GRAD['fullad_depth']}, {lanes} "
          f"lanes): {wall_f:.3f} s, peak memory {peak_f:.2f} GiB; "
          f"render_forward (albedo and sigma_t): call 1 {wall_j1:.3f} s, "
          f"call 2 (seed 1) {wall_j:.3f} s, peak memory {peak_j:.2f} GiB, "
          f"d_transient sum {float(dt.sum()):.6g}")
    if not (torch.isfinite(dt).all() and torch.isfinite(ds).all()):
        raise AssertionError("volumetric forward: non-finite derivative")
    _profile_forward(mt, cases, dev, tangent)

    for name in ("fog", "grid"):
        out = {}
        for d in (dev, "cpu"):
            sc = mt.load_dict(cases.vol_grad_case(mt, name), device=d)
            adj = _grad_in(sc.sensors[0].film, np.random.default_rng(22),
                           steady=True)
            out[str(d)] = (
                mt.render_backward(sc, adj, spp=4, seed=3)["__tables__"],
                mt.render_backward(sc, adj, spp=4, seed=3,
                                   method="fullad")["__tables__"],
                [a.cpu() for a in mt.render_forward(sc, tangent, spp=4,
                                                    seed=3)])
        worst = max(_tables_close(f"volumetric {name} {m}", a, b)
                    for m, a, b in zip(("prb", "fullad"), out[str(dev)][:2],
                                       out["cpu"][:2]))
        for got, want in zip(out[str(dev)][2], out["cpu"][2]):
            share = float((got - want).abs().max()) / max(
                float(want.abs().max()), 1e-30)
            worst = max(worst, share)
            if not share <= GRAD_TABLE_ATOL:
                raise AssertionError(f"volumetric {name} forward: card and "
                                     f"CPU differ by {share:.3g}")
        print(f"volumetric {name} PRB, full AD and forward, card against "
              f"CPU: within {worst:.3g} of each table's largest value")
    return counts


def variant_card_against_cpu(mt, cases, dev):
    """Phase 29: the cbox_polarized and cbox_spectral goldens on the card,
    then every ``torch_cases.VARIANT_CASES`` configuration (regen for the
    polarized ones, multi-pass for all) on the card against the CPU."""
    import numpy as np
    import torch

    from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts

    for name, variant in (("cbox_polarized", "mono_polarized"),
                          ("cbox_spectral", "spectral")):
        with cases.with_variant(mt, variant):
            scene = mt.load_dict(cases.small_cbox(mt, 8, 8, 80, 4),
                                 device=dev)
        s, t = mt.render(scene, spp=4, seed=0)
        golden = np.load(os.path.join(ROOT, "tests", "goldens",
                                      f"{name}.npz"))
        for key, got in (("steady", s), ("transient", t)):
            m = cases.golden_mismatch(got.cpu().numpy(), golden[key])
            print(f"{name} {key} vs golden: {m}")
            if not (m["shape_ok"] and m["n_bad"] == 0):
                raise AssertionError(f"{name} {key} disagrees with its golden")
    for name in cases.VARIANT_CASES:
        for multipass in (False, True):
            if not multipass and name not in cases.VARIANT_REGEN:
                continue
            label = f"{name} {'multi-pass' if multipass else 'regen'}"
            out = []
            for d in (dev, "cpu"):
                reset_launch_counts()
                s, t, stats = cases.variant_render(mt, name, multipass,
                                                   device=d)
                out.append((s.cpu(), t.cpu(), int(stats["rays"])))
                if d == dev:
                    counts, n = launch_counts(), stats["loop_iters"]
            check_launches(label, counts, n, False)
            same = all(torch.equal(a, b) for a, b in zip(out[0][:2],
                                                          out[1][:2]))
            print(f"{label} on the card: launches {counts}, {n} loop "
                  f"iterations or bounces, rays {out[0][2]} (CPU "
                  f"{out[1][2]}), bit for bit with the CPU: {same}")
            for k, got, ref in zip(("steady", "transient"), out[0], out[1]):
                m = cases.golden_mismatch(got.numpy(), ref.numpy())
                print(f"{label} {k}, card against CPU: {m}")
                if not (m["shape_ok"] and m["n_bad"] == 0):
                    raise AssertionError(f"{label} {k}: card and CPU "
                                         "disagree")


def render_polarized_cbox(mt, cases, dev):
    """Phase 30: the polarized cbox at full width through the regen loop;
    returns its launch counts and K1-K3 on one loop iteration's inputs
    (``hold_captured``)."""
    import numpy as np
    import torch

    from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts

    with cases.with_variant(mt, "mono_polarized"):
        scene = mt.load_dict(cases.polarized_cbox(mt), device=dev)
    fc = scene.sensors[0].film
    it = POL_HELD_ITERATION
    reset_launch_counts()
    with capture_bounce({"closest_hit": N_RAYS, "ray_test": N_RAYS},
                        bounce=it) as kept:
        s, t, stats = mt.render(scene, return_stats=True, **POL_CBOX)
        torch.cuda.synchronize()
    counts = launch_counts()
    n = stats["loop_iters"]
    print(f"polarized cbox render 1 ({fc.width}x{fc.height}, "
          f"{fc.temporal_bins} bins, depth {scene.integrator.max_depth}, "
          f"spp {POL_CBOX['spp']}, seed 0; iteration {it}'s kernel inputs "
          f"captured): launches {counts}, loop iterations {n}")
    for name in ("closest_hit", "ray_test", "splat_accumulate"):
        if counts.get(name, 0) != n or n == 0:
            raise AssertionError(f"polarized cbox: {name} launched "
                                 f"{counts.get(name, 0)} times in {n} loop "
                                 "iterations")
    if len(kept) != 3 or len(kept["events"]) != 4:
        raise AssertionError(f"polarized cbox: captured {sorted(kept)}")
    s, t = s.cpu().numpy(), t.cpu().numpy()
    if s.shape != (fc.height, fc.width, 4):
        raise AssertionError(f"polarized cbox: steady {s.shape}")
    fails = cases.physics_checks(s[..., :1], t[..., :1], red_green=False)
    pol = cases.stokes_checks(s)
    dolp = mt.vis_polarized.degree_of_linear_polarization(s)
    box = float(np.median(dolp[POL_BOX]))
    walls = float(np.abs(s[:POL_DIFFUSE_ROWS, :, 1:3]).max())
    maps = {m: mt.vis_polarized.polarization_generate_false_color(s, m)
            for m in ("dop", "aolp", "top", "chirality")}
    print(f"  Stokes: DoP 0.95 quantile {pol['dop_q95']:.4f} (at most "
          f"{cases.DOP_Q95_MAX}), (|Q| + |U|) / I {pol['qu_share']:.6f}, "
          f"median DoLP on the gold box {box:.4f}, largest |Q|, |U| in the "
          f"top {POL_DIFFUSE_ROWS} rows (diffuse walls) {walls}; false-color "
          f"maps {sorted(maps)} in [0, 1]: "
          f"{all(0 <= v.min() <= v.max() <= 1 for v in maps.values())}")
    if (fails or pol["dop_q95"] > cases.DOP_Q95_MAX or not box > 0.01
            or walls != 0.0
            or not all(np.isfinite(v).all() and 0 <= v.min() <= v.max() <= 1
                       for v in maps.values())):
        raise AssertionError(f"polarized cbox physics checks: {fails}, "
                             f"{pol}, gold box DoLP {box}, walls {walls}")
    del s, t
    held = hold_captured(scene, kept, f"polarized cbox iteration {it}'s",
                         dev, fc.width * fc.height,
                         t_pad=fc.temporal_bins + 1)
    del kept
    _out, wall, peak = _timed(lambda: mt.render(
        scene, return_stats=True, spp=POL_CBOX["spp"], seed=1))
    rays = int(_out[2]["rays"])
    print(f"polarized cbox render 2 (seed 1): {wall:.3f} s, {rays} rays, "
          f"{_out[2]['loop_iters']} loop iterations -> "
          f"{rays / wall / 1e6:.2f} M rays/s, peak memory {peak:.2f} GiB")
    profile_render(f"polarized cbox profiled render (spp {PROFILE_SPP})",
                   lambda: mt.render(scene, spp=PROFILE_SPP, seed=2), top=8)
    return counts, held


def spectral_conversion_ms(scene, key, dev):
    """Milliseconds of one bounce's spectral conversions on 2^21 lanes (as
    ``integrators/path.py:_bounce`` makes them): the lane BSDF's uplift,
    the emission uplift of the emitter hit and of NEE, and the sRGB
    conversion of both splat event sets."""
    import torch

    from mitransient_tpu_torch.bsdf import api as bsdf_api
    from mitransient_tpu_torch.core.spectra import N_WL, SpectralCtx

    sctx = SpectralCtx.make(key, N_RAYS, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    bp = scene.data.bsdf
    ids = torch.randint(0, bp.kind.shape[0], (N_RAYS,), generator=gen,
                        device=dev, dtype=torch.int32)
    lb = bsdf_api.gather_lane_bsdf(bp, ids, None, scene.data.bsdf_kinds)
    rgb = torch.rand((N_RAYS, 3), generator=gen, device=dev)
    vals = torch.rand((N_RAYS, N_WL), generator=gen, device=dev)

    def conversions():
        sctx.uplift_lb(lb)
        for _ in range(2):
            sctx.emission(rgb)
            sctx.to_film(vals)

    return _time_ms(conversions, reps=5, warmup=1, batches=3)


def render_spectral(mt, cases, dev):
    """Phase 31: the spectral flagship through the multi-pass accumulator,
    then rgb_polarized and spectral_polarized at the flagship's film with
    K3 held on their 12-channel events.  Returns the spectral flagship's
    launch counts, each 12-channel render's, and K3 on their events."""
    import numpy as np
    import torch

    from mitransient_tpu_torch.core import rng, spectra
    from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts

    with cases.with_variant(mt, "spectral"):
        scene = mt.load_dict(mt.cornell_box(), device=dev)
    depth = scene.integrator.max_depth
    reset_launch_counts()
    (s, t, stats), wall, peak = _timed(lambda: mt.render(
        scene, return_stats=True, **SPECTRAL))
    counts = launch_counts()
    n = stats["loop_iters"]
    passes = n // depth
    print(f"spectral flagship render 1 (multi-pass, spp {SPECTRAL['spp']} = "
          f"{passes} passes, seed 0): {wall:.3f} s, launches {counts}, "
          f"bounces {n}, peak memory {peak:.2f} GiB")
    for name in ("closest_hit", "ray_test", "splat_accumulate"):
        if counts.get(name, 0) != n or n == 0:
            raise AssertionError(f"spectral flagship: {name} launched "
                                 f"{counts.get(name, 0)} times in {n} bounces")
    s, t = s.cpu().numpy(), t.cpu().numpy()
    fails = cases.physics_checks(s, t)
    h, w = s.shape[:2]
    print(f"  first arrival bin {t.sum(axis=(0, 1, 3)).nonzero()[0][0]}, "
          f"transient/steady {t.sum() / s.sum():.6f}, left wall "
          f"{s[h // 2, w * 6 // 256]}, right wall {s[h // 2, w * 249 // 256]}")
    if fails:
        raise AssertionError(f"spectral flagship physics checks: {fails}")
    del s, t
    (_s, _t, stats2), wall2, _p = _timed(lambda: mt.render(
        scene, return_stats=True, spp=SPECTRAL["spp"], seed=1))
    rays = int(stats2["rays"])
    key = rng.Sampler(0, N_RAYS, stream=5).key
    block = _time_ms(lambda: rng.draw_bounce_block(key, 3, N_RAYS, 6, dev),
                     reps=5, warmup=1, batches=3)
    jitter = _time_ms(lambda: rng.Sampler(7, N_RAYS, 2, device=dev)
                      .eval_2d(0), reps=5, warmup=1, batches=3)
    wl = _time_ms(lambda: spectra.SpectralCtx.make(key, N_RAYS, dev),
                  reps=5, warmup=1, batches=3)
    draws = passes * (depth * block + jitter + wl) / 1e3
    conv = spectral_conversion_ms(scene, key, dev)
    convs = passes * depth * conv / 1e3
    print(f"spectral flagship render 2 (seed 1): {wall2:.3f} s, {rays} rays "
          f"-> {rays / wall2 / 1e6:.2f} M rays/s; threefry {draws:.3f} s of "
          f"it ({draws / wall2:.3f}: {passes} passes x ({depth} bounce "
          f"blocks of {block:.3f} ms + a jitter draw of {jitter:.3f} ms + "
          f"the hero-wavelength draw and sampling, {wl:.3f} ms)); the "
          f"spectral conversions {conv:.3f} ms a bounce, {convs:.3f} s "
          f"({convs / wall2:.3f})")
    profile_render("spectral flagship profiled render (one pass, spp 32)",
                   lambda: mt.render(scene, spp=32, seed=2), top=8)

    counts12, held12 = {}, {}
    for variant, prefix in (("rgb_polarized", "stokes12"),
                            ("spectral_polarized", "stokes12_spectral")):
        with cases.with_variant(mt, variant):
            scene = mt.load_dict(mt.cornell_box(), device=dev)
        reset_launch_counts()
        with capture_bounce({}, bounce=1) as kept:
            (s, t, stats), wall, peak = _timed(lambda: mt.render(
                scene, return_stats=True, spp=STOKES12_SPP, seed=0))
        counts12[prefix] = c = launch_counts()
        n = stats["loop_iters"]
        s = s.cpu().numpy()
        pol = cases.stokes_checks(s.reshape(*s.shape[:2], 4, 3).sum(-1))
        print(f"{variant} flagship (spp {STOKES12_SPP}, seed 0): {wall:.3f} "
              f"s, {int(stats['rays'])} rays -> "
              f"{int(stats['rays']) / wall / 1e6:.2f} M rays/s, peak memory "
              f"{peak:.2f} GiB, launches {c}, {n} loop iterations or "
              f"bounces; steady {s.shape}, Stokes {pol}")
        check_launches(variant, c, n, False)
        fc = scene.sensors[0].film
        if (s.shape != (fc.height, fc.width, 12) or not np.isfinite(s).all()
                or pol["dop_q95"] > cases.DOP_Q95_MAX):
            raise AssertionError(f"{variant} flagship: {s.shape}, {pol}")
        del s, t
        if kept["events"][1].shape[1] != 12:
            raise AssertionError(f"{variant}: K3 got "
                                 f"{kept['events'][1].shape} values")
        held12[prefix] = hold_captured(
            scene, kept, f"{variant} bounce 1's", dev, fc.width * fc.height,
            t_pad=fc.temporal_bins + 1)["splat_accumulate"]
        del kept
    return counts, counts12, held12


def variant_paths_card_against_cpu(mt, cases, dev):
    """Phase 32: every variant NLOS, volumetric and gradient configuration
    of ``torch_cases`` on the card against the CPU: the renders bit for
    bit with the same ray count, the gradient tables within
    ``GRAD_TABLE_ATOL`` of each table's largest value (NaN where the CPU
    has NaN)."""
    import torch

    from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts

    for kind, names in (("nlos", cases.VARIANT_NLOS_CASES),
                        ("vol", cases.VARIANT_VOL_CASES)):
        for name in names:
            out = []
            for d in (dev, "cpu"):
                reset_launch_counts()
                s, t, stats = cases.run_variant_case(mt, kind, name, device=d)
                if d == dev:
                    counts = launch_counts()
                out.append((s.cpu(), t.cpu(), int(stats["rays"])))
            same = all(torch.equal(a, b) for a, b in zip(out[0][:2],
                                                          out[1][:2]))
            k3 = counts.get("splat_accumulate", 0)
            if kind == "vol":  # K1 five times a bounce, K2 never
                rays_ok = (counts.get("closest_hit") == 5 * k3
                           and "ray_test" not in counts)
            else:
                rays_ok = min(counts.get("closest_hit", 0),
                              counts.get("ray_test", 0)) >= k3
            print(f"variant {kind} {name} on the card: launches {counts}, "
                  f"rays {out[0][2]} (CPU {out[1][2]}), film "
                  f"{tuple(out[0][1].shape)}, bit for bit with the CPU: "
                  f"{same}")
            if not (same and k3 > 0 and rays_ok and out[0][2] == out[1][2]):
                raise AssertionError(f"variant {kind} {name}: card and CPU "
                                     "disagree, or the kernels did not run")
    for name in cases.VARIANT_GRAD_CASES:
        reset_launch_counts()
        g = cases.run_variant_case(mt, "grad", name, device=dev)
        counts = launch_counts()
        want = cases.run_variant_case(mt, "grad", name, device="cpu")
        worst = _tables_close(f"variant gradients {name}", g["__tables__"],
                              want["__tables__"])
        print(f"variant gradients {name}, card against CPU: launches "
              f"{counts}, tables within {worst:.3g} of their largest value")
        if not counts.get("closest_hit"):
            raise AssertionError(f"variant gradients {name}: K1 never ran")


def render_polarized_nlos(mt, cases, dev):
    """Phase 33: the polarimetric NLOS capture at the reference's scan, the
    spectral single capture at phase 16's config and ``scan_confocal``
    under mono_polarized.  Returns ({cell: launches}, K1-K3 on the
    polarized capture's bounce-1 inputs)."""
    import numpy as np
    import torch

    from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts

    cfg = POL_NLOS
    scan, hw = cfg["scan"], cfg["scan"] ** 2
    with cases.with_variant(mt, "mono_polarized"):
        scene = mt.load_dict(cases.polarized_nlos(scan, cfg["bins"]),
                             device=dev)
    mt.nlos.focus_emitter_at_relay_wall_pixel([scan / 2] * 2, scene)
    lanes = 1 << 21  # a pass
    reset_launch_counts()
    with capture_bounce({"closest_hit": lanes, "ray_test": lanes}) as kept:
        (s, t, stats), wall1, peak1 = _timed(lambda: mt.render(
            scene, spp=cfg["spp"], seed=0, return_stats=True))
    counts = {"pol_nlos": launch_counts()}
    n = stats["loop_iters"]
    print(f"polarized NLOS {scan}x{scan}, {cfg['bins']} bins, depth "
          f"{scene.integrator.max_depth}, spp {cfg['spp']} "
          f"({n // scene.integrator.max_depth} passes of {lanes} lanes) "
          f"render 1 (seed 0, its kernel inputs captured): {wall1:.3f} s, "
          f"launches {counts['pol_nlos']} in {n} bounces")
    want = {"closest_hit": n + 1, "ray_test": n + 1, "splat_accumulate": n}
    if counts["pol_nlos"] != want or len(kept) != 3:
        raise AssertionError(f"polarized NLOS: launches {counts['pol_nlos']}"
                             f", expected {want}")
    s_np, t_np = s.cpu().numpy(), t.cpu().numpy()
    _check_energy("polarized NLOS (Stokes I)", s_np[..., :1], t_np[..., :1],
                  NLOS_FIRST_BINS)
    pol = cases.stokes_checks(s_np)
    print(f"  Stokes: DoP 0.95 quantile {pol['dop_q95']:.4f} (at most "
          f"{cases.DOP_Q95_MAX}), (|Q| + |U|) / I {pol['qu_share']:.6f}")
    if (s_np.shape != (scan, scan, 4) or not np.isfinite(t_np).all()
            or pol["dop_q95"] > cases.DOP_Q95_MAX or not pol["qu_share"] > 0):
        raise AssertionError(f"polarized NLOS: {s_np.shape}, {pol}")
    del s, t, s_np, t_np
    if kept["events"][1].shape[1] != 4:
        raise AssertionError(f"polarized NLOS: K3 got "
                             f"{tuple(kept['events'][1].shape)} values")
    held = hold_captured(scene, kept, "polarized NLOS bounce 1's", dev, hw,
                         t_pad=cfg["bins"] + 1)
    del kept
    (_s, _t, stats2), wall, peak = _timed(lambda: mt.render(
        scene, spp=cfg["spp"], seed=1, return_stats=True))
    rays = int(stats2["rays"])
    print(f"polarized NLOS render 2 (seed 1): {wall:.4f} s, {rays} rays -> "
          f"{rays / wall / 1e6:.2f} M rays/s, peak memory {peak:.2f} GiB "
          f"(render 1: {peak1:.2f} GiB)")
    del _s, _t

    # the spectral single capture at phase 16's config
    with cases.with_variant(mt, "spectral"):
        sc = mt.load_dict(cases.nlos_scene(sx=NLOS_SCAN, sy=NLOS_SCAN),
                          device=dev)
    mt.nlos.focus_emitter_at_relay_wall_pixel([NLOS_SCAN / 2] * 2, sc)
    reset_launch_counts()
    s, t = mt.render(sc, **NLOS)
    counts["spectral_nlos"] = launch_counts()
    s_np, t_np = s.cpu().numpy(), t.cpu().numpy()
    prof = t_np.sum(axis=(0, 1, 3))
    first = int(np.nonzero(prof)[0][0])
    print(f"spectral NLOS {NLOS_SCAN}x{NLOS_SCAN} spp {NLOS['spp']} render "
          f"1: launches {counts['spectral_nlos']}, film {t_np.shape}, first "
          f"arrival bin {first}")
    if (t_np.shape[-1] != 3 or not np.isfinite(t_np).all()
            or not NLOS_FIRST_BINS[0] <= first <= NLOS_FIRST_BINS[1]):
        raise AssertionError("spectral NLOS: bad film")
    (_s, _t, st2), wall, peak = _timed(lambda: mt.render(
        sc, spp=NLOS["spp"], seed=1, return_stats=True))
    rays = int(st2["rays"])
    print(f"spectral NLOS render 2 (seed 1): {wall:.4f} s, {rays} rays -> "
          f"{rays / wall / 1e6:.2f} M rays/s, peak memory {peak:.2f} GiB")

    # scan_confocal 32 x 32 under mono_polarized
    with cases.with_variant(mt, "mono_polarized"):
        sc = mt.load_dict(cases.nlos_confocal(cases.nlos_scene(sx=1, sy=1),
                                              NLOS_SCAN, NLOS_SCAN),
                          device=dev)
    reset_launch_counts()
    s, t = mt.nlos.scan_confocal(sc, spp=CONFOCAL_SPP, seed=0)
    counts["pol_confocal"] = launch_counts()
    _check_energy("polarized scan_confocal (Stokes I)",
                  s.cpu().numpy()[..., :1], t.cpu().numpy()[..., :1])
    (_s, _t, st3), wall, peak = _timed(lambda: mt.nlos.scan_confocal(
        sc, spp=CONFOCAL_SPP, seed=1, return_stats=True))
    rays = int(st3["rays"])
    print(f"polarized scan_confocal {NLOS_SCAN}x{NLOS_SCAN} spp "
          f"{CONFOCAL_SPP}: launches {counts['pol_confocal']}; render 2 "
          f"(seed 1) {wall:.4f} s, {rays} rays -> {rays / wall / 1e6:.2f} M "
          f"rays/s, peak memory {peak:.2f} GiB")
    return counts, held


def vol_spectral_conversion_ms(scene, key, dev):
    """Milliseconds of one volumetric bounce's spectral conversions on 2^21
    lanes (as ``integrators/volpath.py`` makes them): the medium albedo's
    and the lane BSDF's uplifts, the emission uplifts of the emitter hit
    and of NEE, and the sRGB conversion of both splat event sets."""
    import torch

    from mitransient_tpu_torch.bsdf import api as bsdf_api
    from mitransient_tpu_torch.core.spectra import N_WL, SpectralCtx

    sctx = SpectralCtx.make(key, N_RAYS, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    bp = scene.data.bsdf
    ids = torch.randint(0, bp.kind.shape[0], (N_RAYS,), generator=gen,
                        device=dev, dtype=torch.int32)
    lb = bsdf_api.gather_lane_bsdf(bp, ids, None, scene.data.bsdf_kinds)
    rgb = torch.rand((N_RAYS, 3), generator=gen, device=dev)
    vals = torch.rand((N_RAYS, N_WL), generator=gen, device=dev)

    def conversions():
        sctx.uplift(rgb)
        sctx.uplift_lb(lb)
        for _ in range(2):
            sctx.emission(rgb)
            sctx.to_film(vals)

    return _time_ms(conversions, reps=5, warmup=1, batches=3)


def render_variant_tutorial(mt, cases, dev):
    """Phase 34: the volumetric tutorial under spectral and mono_polarized.
    Returns ({cell: launches}, {prefix: K3 on its bounce-1 events})."""
    import numpy as np
    import torch

    from mitransient_tpu_torch.core import rng
    from mitransient_tpu_torch.integrators import volpath
    from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts

    cfg = cases.TUTORIAL
    hw = cfg["res"] ** 2
    steps = 1 + volpath.TRANSMITTANCE_STEPS
    counts, held = {}, {}
    for variant, prefix, C in (("spectral", "spectral_vol", 3),
                               ("mono_polarized", "pol_vol", 4)):
        with cases.with_variant(mt, variant):
            scene = mt.load_dict(cases.tutorial_cbox(mt), device=dev)
        reset_launch_counts()
        with capture_bounce({}, bounce=VOL_HELD_BOUNCE) as kept:
            (s, t, stats), wall1, _p = _timed(lambda: mt.render(
                scene, spp=VARIANT_TUTORIAL_SPP, seed=0, return_stats=True))
        counts[prefix] = c = launch_counts()
        n = stats["loop_iters"]
        s_np, t_np = s.cpu().numpy(), t.cpu().numpy()
        prof = t_np[..., :3 if C == 3 else 1].sum(axis=(0, 1, 3))
        first = int(np.nonzero(prof)[0][0])
        pol = cases.stokes_checks(s_np) if C == 4 else None
        print(f"{variant} volumetric tutorial {cfg['res']}x{cfg['res']}, "
              f"{cfg['bins']} bins, depth {cfg['max_depth']}, spp "
              f"{VARIANT_TUTORIAL_SPP} (one pass of {1 << 21} lanes) render 1 "
              f"(seed 0): {wall1:.3f} s, launches {c} in {n} bounces; film "
              f"{t_np.shape}, first arrival bin {first}"
              + (f", Stokes {pol}" if pol else ""))
        if (c != {"closest_hit": steps * n, "splat_accumulate": n}
                or t_np.shape[-1] != C or not np.isfinite(t_np).all()
                or not VOL_FIRST_BINS[0] <= first <= VOL_FIRST_BINS[1]
                or (pol and pol["dop_q95"] > cases.DOP_Q95_MAX)):
            raise AssertionError(f"{variant} tutorial: launches {c}, film "
                                 f"{t_np.shape}, first bin {first}, {pol}")
        del s, t, s_np, t_np
        if kept["events"][1].shape[1] != C:
            raise AssertionError(f"{variant} tutorial: K3 got "
                                 f"{tuple(kept['events'][1].shape)} values")
        held[prefix] = hold_captured(
            scene, kept, f"{variant} tutorial bounce {VOL_HELD_BOUNCE}'s",
            dev, hw, t_pad=cfg["bins"] + 1)["splat_accumulate"]
        del kept
        (_s, _t, stats2), wall, peak = _timed(lambda: mt.render(
            scene, spp=VARIANT_TUTORIAL_SPP, seed=1, return_stats=True))
        rays = int(stats2["rays"])
        line = (f"{variant} tutorial render 2 (seed 1): {wall:.4f} s, {rays} "
                f"rays -> {rays / wall / 1e6:.2f} M rays/s, peak memory "
                f"{peak:.2f} GiB")
        if variant == "spectral":
            conv = vol_spectral_conversion_ms(scene, rng.Sampler(1, 1 << 21)
                                              .key, dev)
            line += (f"; the spectral conversions {conv:.3f} ms a bounce x "
                     f"{n} bounces = {n * conv / 1e3 / wall:.3f} of the wall")
        print(line)
        del _s, _t
    return counts, held


def check_stokes_function(mt, cases, dev):
    """K3's autograd Function at 4 and 12 channels on seeded events (2^18
    lanes into (C, 301, 4096)): its backward (a gather) bit-equal to the
    plain version's index_add_ autograd on the card, its jvp bit-equal to
    the plain version's forward AD on the host CPU.  -> the largest
    errors."""
    import numpy as np
    import torch
    from torch.autograd import forward_ad as fwAD

    from mitransient_tpu_torch.film import transient_film as tf

    lanes, hw, bins = STOKES_FN_EVENTS
    errs = {"backward": 0.0, "jvp": 0.0}
    for C in (4, 12):
        rng = np.random.default_rng(40 + C)
        b_np, v_np = cases.splat_events(rng, lanes, hw, bins, C)
        b, vals = torch.from_numpy(b_np).to(dev), torch.from_numpy(v_np)
        shape = (C, bins + 1, hw)
        w = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
        v = vals.to(dev).requires_grad_()
        film = tf.SplatEvents.apply(torch.zeros(shape, device=dev), b,
                                    v * 1.0, None, None, lanes)
        (g_fn,) = torch.autograd.grad((film * w).sum(), v)
        p = vals.to(dev).requires_grad_()
        plain = torch.zeros(shape, device=dev)
        tf._scatter_layout(plain, hw, b, p * 1.0)
        (g_plain,) = torch.autograd.grad((plain * w).sum(), p)
        errs["backward"] = max(errs["backward"],
                               float((g_fn - g_plain).abs().max()))
        tan = torch.from_numpy(rng.normal(size=v_np.shape).astype(np.float32))
        with fwAD.dual_level():
            out = tf.SplatEvents.apply(
                torch.zeros(shape, device=dev), b,
                fwAD.make_dual(vals.to(dev), tan.to(dev)), None, None, lanes)
            t_card = fwAD.unpack_dual(out).tangent.cpu()
            ref = torch.zeros(shape)
            tf._scatter_layout(ref, hw, b.cpu(), fwAD.make_dual(vals, tan))
            t_cpu = fwAD.unpack_dual(ref).tangent
        errs["jvp"] = max(errs["jvp"], float((t_card - t_cpu).abs().max()))
        same = torch.equal(g_fn, g_plain) and torch.equal(t_card, t_cpu)
        cells = tf.gather_index(b, shape)
        gather = _time_ms(lambda: tf.gather_cells(w, *cells))
        print(f"K3 Function at {C} channels ({lanes} lanes into {shape}): "
              f"backward and jvp bit-equal to the plain version's autograd "
              f"and forward AD: {same}; the backward gather {gather:.4f} ms")
        if not same:
            raise AssertionError(f"K3 Function at {C} channels: {errs}")
    return errs


def variant_gradients(mt, cases, dev):
    """Phase 35: gradients of the variant cells, each call's seconds and
    peak memory, and K3's Function at 4 and 12 channels.  Returns
    (the polarized cbox's full-AD launches, the Function's errors)."""
    import numpy as np
    import torch

    from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts

    cfg = VARIANT_GRAD

    def s0_adjoint(scene):
        fc = scene.sensors[0].film
        C = 4 * scene.variant.color_channels
        g = np.zeros((fc.height, fc.width, fc.temporal_bins, C), np.float32)
        g[..., :C // 4] = 1.0
        return None, g

    def rand_adjoint(scene, seed):
        fc = scene.sensors[0].film
        return None, np.random.default_rng(seed).random(
            (fc.height, fc.width, fc.temporal_bins, 3)).astype(np.float32)

    def report(label, scene, call, spp):
        reset_launch_counts()
        grads, wall, peak = _timed(call)
        c = launch_counts()
        refl = grads["__tables__"].bsdf_reflectance
        nan = sorted(f for f in grads["__tables__"]._fields
                     if getattr(grads["__tables__"], f) is not None
                     and bool(getattr(grads["__tables__"], f).isnan().any()))
        fc = scene.sensors[0].film
        print(f"{label} ({fc.width}x{fc.height}, {fc.temporal_bins} bins, "
              f"depth {scene.integrator.max_depth}, spp {spp} = "
              f"{spp * fc.width * fc.height} lanes): {wall:.3f} s, peak "
              f"memory {peak:.2f} GiB, launches {c}; |d reflectance| sum "
              f"{float(refl.abs().sum()):.6g}; NaN tables {nan}")
        if not torch.isfinite(refl).all() or not refl.abs().sum() > 0:
            raise AssertionError(f"{label}: reflectance gradient {refl}")
        return c

    with cases.with_variant(mt, "mono_polarized"):
        scene = mt.load_dict(cases.polarized_cbox(mt), device=dev)
    adj = s0_adjoint(scene)
    counts = report("polarized cbox render_backward (full AD)", scene,
                    lambda: mt.render_backward(scene, adj, spp=cfg["spp"],
                                               seed=0), cfg["spp"])
    if counts.get("splat_accumulate") != scene.integrator.max_depth:
        raise AssertionError(f"polarized cbox full AD: launches {counts}")
    del adj
    with cases.with_variant(mt, "spectral"):
        scene = mt.load_dict(mt.cornell_box(), device=dev)
    adj = rand_adjoint(scene, 50)
    report("spectral flagship render_backward (full AD)", scene,
           lambda: mt.render_backward(scene, adj, spp=cfg["spp"], seed=0),
           cfg["spp"])
    with cases.with_variant(mt, "spectral"):
        scene = mt.load_dict(cases.tutorial_cbox(mt), device=dev)
    adj = rand_adjoint(scene, 51)
    report("spectral tutorial render_backward (the RGB PRB replay)", scene,
           lambda: mt.render_backward(scene, adj, spp=cfg["tutorial_spp"],
                                      seed=0), cfg["tutorial_spp"])
    with cases.with_variant(mt, "mono_polarized"):
        scene = mt.load_dict(cases.nlos_scene(sx=NLOS_SCAN, sy=NLOS_SCAN),
                             device=dev)
    mt.nlos.focus_emitter_at_relay_wall_pixel([NLOS_SCAN / 2] * 2, scene)
    adj = s0_adjoint(scene)
    report("polarized NLOS render_backward (full AD)", scene,
           lambda: mt.render_backward(scene, adj, spp=cfg["nlos_spp"],
                                      seed=0), cfg["nlos_spp"])
    del adj
    with cases.with_variant(mt, "mono_polarized"):
        scene = mt.load_dict(cases.polarized_cbox(mt, cfg["forward_res"]),
                             device=dev)
    for call in (1, 2):
        (d_s, d_t), wall, peak = _timed(lambda: mt.render_forward(
            scene, {"white.reflectance.value": [1.0]},
            spp=cfg["forward_spp"], seed=call))
        print(f"polarized cbox render_forward ({cfg['forward_res']}^2, spp "
              f"{cfg['forward_spp']}) call {call}: {wall:.3f} s, peak memory "
              f"{peak:.2f} GiB, video {tuple(d_t.shape)}, |d steady| sum "
              f"{float(d_s.abs().sum()):.6g}")
        if not (torch.isfinite(d_t).all() and d_s[..., 0].abs().sum() > 0):
            raise AssertionError("polarized cbox forward: bad video")
    return counts, check_stokes_function(mt, cases, dev)


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _same_render(label, got, want, rays=None):
    """Two sharded renders (steady, transient[, stats]), card and CPU, bit
    for bit with equal ray counts."""
    import torch

    same = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got[:2],
                                                               want[:2]))
    r = (got[2]["rays"], want[2]["rays"]) if rays else None
    print(f"{label}: bit for bit {same}" + (f", rays {r[0]} and {r[1]}"
                                            if r else ""))
    if not same or (r and r[0] != r[1]):
        raise AssertionError(f"{label}: the renders differ")


def multi_device_phase(mt, cases, dev, flagship):
    """Phase 36: multi-device rendering (``mitransient_tpu_torch.parallel``)
    on the card.  A one-process NCCL world through ``init_distributed``
    and its ``global_mesh`` (one card: NCCL takes one rank a device, so a
    larger world cannot be checked here); the flagship through
    ``render_sharded`` (K1-K3 once a bounce of every pass, the physics
    checks, test_golden's rule against phase 12's render with the same
    rays; rays/s, wall and peak memory of a second render) and one
    all-reduce of its film; 4 logical shards of the card against 4 CPU
    shards, bit for bit; the sharded exhaustive capture at phase 19's
    config against the local one, bit for bit; ``render_backward_sharded``
    (the flagship's PRB replay at 2^23 lanes against ``render_backward``,
    whose single chunk draws the same stream, and 4-shard PRB and full-AD
    cases against the CPU, within ``GRAD_TABLE_ATOL``); the dry run on 8
    logical shards of the card against 8 CPU shards.  Returns the
    flagship's launches."""
    import copy

    import numpy as np
    import torch
    import torch.distributed as dist

    from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mitransient_tpu_torch.parallel import (
        dryrun_multichip,
        global_mesh,
        init_distributed,
        make_mesh,
        render_backward_sharded,
        render_sharded,
        shutdown,
    )

    init_distributed(coordinator_address=f"localhost:{_free_port()}",
                     num_processes=1, process_id=0)
    try:
        mesh = global_mesh()
        print(f"process group: backend {dist.get_backend()}, world "
              f"{dist.get_world_size()}, mesh {mesh.size} shard(s) on "
              f"{[str(d) for d in mesh.devices]}")
        if (dist.get_backend() != "nccl" or mesh.group is None
                or mesh.devices != (dev,)):
            raise AssertionError(f"not a one-rank NCCL mesh on {dev}: {mesh}")

        # 1. the flagship over the NCCL mesh
        scene = mt.load_dict(mt.cornell_box(), device=dev)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        s, t, stats = render_sharded(scene, mesh, return_stats=True,
                                     **FLAGSHIP)
        torch.cuda.synchronize()
        counts = launch_counts()
        n = MULTIPASS_PASSES * 8
        print(f"sharded flagship render 1 (seed 0, {stats['devices']} "
              f"shard, spp {stats['spp']}): launches {counts}, rays "
              f"{stats['rays']} (phase 12: {flagship['rays']})")
        if any(counts.get(k, 0) != n for k in ("closest_hit", "ray_test",
                                                "splat_accumulate")):
            raise AssertionError(f"sharded flagship: launches {counts}, "
                                 f"expected {n} of each of K1-K3")
        s, t = s.cpu().numpy(), t.cpu().numpy()
        fails = cases.physics_checks(s, t)
        for k, got in (("steady", s), ("transient", t)):
            m = cases.golden_mismatch(got, flagship[k])
            print(f"sharded flagship {k} against phase 12's multi-pass "
                  f"render: {m}")
            if not (m["shape_ok"] and m["n_bad"] == 0):
                fails.append(f"{k} against the multi-pass render: {m}")
        if fails or stats["rays"] != flagship["rays"]:
            raise AssertionError(f"sharded flagship: {fails}, rays "
                                 f"{stats['rays']}")
        del s, t
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _s, _t, stats2 = render_sharded(scene, mesh, spp=FLAGSHIP["spp"],
                                        seed=1, return_stats=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rate = stats2["rays"] / wall
        print(f"sharded flagship render 2 (seed 1): {wall:.3f} s, "
              f"{stats2['rays']} rays -> {rate / 1e6:.2f} M rays/s "
              f"({rate / flagship['rays_per_s']:.4f} of phase 12's render 2); "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
              "GiB")
        del _s, _t
        film = torch.zeros((3, 301, 256 * 256), device=dev)
        ms = _time_ms(lambda: dist.all_reduce(film, group=mesh.group))
        print(f"one NCCL all-reduce of a (3, 301, 65536) f32 film "
              f"({film.numel() * 4 / 1e6:.1f} MB, one rank): {ms:.4f} ms")
        del film

        # 2. 4 logical shards of the card against 4 CPU shards
        shards = {d: make_mesh(devices=[d] * 4) for d in (dev, "cpu")}
        nlos = cases.nlos_scene(sx=8, sy=8)
        vol = cases.vol_cbox(mt, 2.0, w=16, h=16, bins=100,
                             lift=cases.VOL_LIFT)
        for name, desc, variant, spp in (
                ("small cbox", cases.small_cbox(mt), "rgb", 16),
                ("NLOS single 8x8", nlos, "rgb", 64),
                ("volumetric fog", vol, "rgb", 16),
                ("mono_polarized cbox", cases.small_cbox(mt, 8, 8, 60, 4),
                 "mono_polarized", 16)):
            out = {}
            with cases.with_variant(mt, variant):
                for d, m in shards.items():
                    sc = mt.load_dict(copy.deepcopy(desc), device=d)
                    if name.startswith("NLOS"):
                        mt.nlos.focus_emitter_at_relay_wall_pixel([4, 4], sc)
                    out[d] = render_sharded(sc, m, spp=spp, seed=0,
                                            return_stats=True)
            _same_render(f"4 shards {name} ({variant}), card against CPU",
                         out[dev], out["cpu"], rays=True)

        # 3. the exhaustive capture at phase 19's config over 4 shards
        exh = cases.nlos_exhaustive(cases.nlos_scene(sx=NLOS_SCAN,
                                                     sy=NLOS_SCAN),
                                    EXHAUSTIVE["lasers"], EXHAUSTIVE["lasers"])
        sc = mt.load_dict(exh, device=dev)
        (s_loc, t_loc, st_loc), w_loc, _p = _timed(lambda: mt.render(
            sc, spp=EXHAUSTIVE["spp"], seed=0, return_stats=True))
        (s_sh, t_sh, st_sh), w_sh, peak = _timed(lambda: render_sharded(
            sc, shards[dev], spp=EXHAUSTIVE["spp"], seed=0,
            return_stats=True))
        same = torch.equal(t_sh, t_loc)
        rel = float(((s_sh - s_loc).abs() / s_loc.abs().clamp_min(1e-30))
                    .max())
        print(f"sharded exhaustive {NLOS_SCAN}x{NLOS_SCAN} x "
              f"{EXHAUSTIVE['lasers']}x{EXHAUSTIVE['lasers']} lasers spp "
              f"{EXHAUSTIVE['spp']} over 4 shards: {w_sh:.4f} s, "
              f"{st_sh['rays']} rays -> {st_sh['rays'] / w_sh / 1e6:.2f} M "
              f"rays/s, peak memory {peak:.2f} GiB (local: {w_loc:.4f} s, "
              f"{int(st_loc['rays'])} rays -> "
              f"{int(st_loc['rays']) / w_loc / 1e6:.2f} M rays/s); transient "
              f"bit for bit {same}, steady within rtol {rel:.3g}")
        if not same or rel > 1e-5:
            raise AssertionError("sharded exhaustive capture differs from "
                                 "the local one")
        del s_loc, t_loc, s_sh, t_sh

        # 4. render_backward_sharded
        fc = scene.sensors[0].film
        grad_in = _grad_in(fc, np.random.default_rng(36))
        reset_launch_counts()
        g_sh, w_sh, peak = _timed(lambda: render_backward_sharded(
            scene, mesh, grad_in, **GRAD_FLAGSHIP))
        counts_b = launch_counts()
        g_1, w_1, _p = _timed(lambda: mt.render_backward(
            scene, grad_in, **GRAD_FLAGSHIP))
        _tables_equal("sharded flagship PRB backward against "
                      "render_backward", g_sh["__tables__"],
                      g_1["__tables__"])
        print(f"sharded flagship render_backward (PRB, spp "
              f"{GRAD_FLAGSHIP['spp']} = 2^23 lanes on the NCCL mesh): "
              f"{w_sh:.3f} s, peak memory {peak:.2f} GiB, launches "
              f"{counts_b}; render_backward {w_1:.3f} s; tables bit for bit "
              "equal")
        del g_sh, g_1
        for name, desc, spp, focus in (
                ("PRB small cbox", cases.grad_cbox(mt, 8, 8, 100, 3), 16,
                 None),
                ("full AD NLOS single 8x8", nlos, 64, [4, 4]),
                ("full AD tutorial 16x16 depth 4",
                 cases.tutorial_cbox(mt, res=16, bins=100, max_depth=4), 16,
                 None)):
            tabs = {}
            for d, m in shards.items():
                sc = mt.load_dict(copy.deepcopy(desc), device=d)
                if focus:
                    mt.nlos.focus_emitter_at_relay_wall_pixel(focus, sc)
                adj = _grad_in(sc.sensors[0].film, np.random.default_rng(37),
                               steady=True)
                tabs[d] = render_backward_sharded(sc, m, adj, spp=spp,
                                                  seed=0)["__tables__"]
            worst = _tables_close(f"4 shards {name}", tabs[dev],
                                  tabs["cpu"])
            print(f"4 shards {name} backward, card against CPU: tables "
                  f"within {worst:.3g} of their largest value")

        # 5. the dry run on 8 logical shards of the card and of the CPU
        runs = {d: dryrun_multichip(8, devices=[d] * 8) for d in (dev, "cpu")}
        a, b = runs[dev], runs["cpu"]
        for k in ("steady", "transient", "nlos_transient",
                  "exhaustive_transient"):
            m = cases.golden_mismatch(a[k], b[k])
            if not (m["shape_ok"] and m["n_bad"] == 0):
                raise AssertionError(f"dry run {k}: card against CPU {m}")
        for k in ("grad_bsdf_reflectance", "grad_emitter_radiance",
                  "nlos_grad_bsdf_reflectance"):
            share = float(np.abs(a[k] - b[k]).max()) / max(
                float(np.abs(b[k]).max()), 1e-30)
            if not share <= GRAD_TABLE_ATOL:
                raise AssertionError(f"dry run {k}: card against CPU "
                                     f"{share:.3g}")
        print("dry run on 8 shards of the card against 8 CPU shards: "
              "renders within test_golden's rule, tables within "
              f"{GRAD_TABLE_ATOL}")
    finally:
        shutdown()
    return counts


def hold_reduce_rows(G, g, idx, rows, label):
    """K8 on one call's cotangents ``g`` (N, C) and indices ``idx`` onto
    ``rows`` rows against its plain version on the host CPU, bit for bit;
    the kernel's, the plain version's (on the card) and one
    ``index_add_``'s ms; the bound: the cotangents and indices read once
    and the table written once, one add a cotangent element."""
    import torch

    out = G.reduce_rows(g, idx, rows)
    torch.cuda.synchronize()
    ref = G.reduce_rows(g.cpu(), idx.cpu(), rows)
    err = float((out.cpu() - ref).abs().max())
    if not _bit_equal(out.cpu(), ref):
        raise AssertionError(f"K8 on {label} is not bit-equal to its plain "
                             f"version on the CPU (max |d| {err})")
    n, C = g.shape
    bound = _bound(g.numel() * 4 + idx.numel() * idx.element_size()
                   + rows * C * 4, g.numel())
    r = dict(rows=rows, lanes=n, channels=C, max_abs_err=err, bound=bound,
             ms=_time_ms(lambda: G.reduce_rows(g, idx, rows)),
             plain_ms=_time_ms(lambda: G.reduce_rows_plain(g, idx, rows)),
             library_ms=_time_ms(lambda: torch.zeros(
                 (rows, C), device=g.device).index_add_(0, idx, g)))
    print(f"K8 reduce_rows on {label} ({n} lanes x {C} channels onto {rows} "
          f"rows): bit-equal to the plain version on the CPU; kernel "
          f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, index_add_ "
          f"{r['library_ms']:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    return r


def check_gaussian_splat(mt, tf, dev):
    """The gaussian temporal filter's splat (K3 at spp * K lanes on
    ``gaussian_taps``' layout) on two seeded 2^21-lane sets of 13 taps into
    a (3, 301, 65536) film, bit-equal to its plain version on the host CPU;
    the taps made on the card bit-equal to the CPU's; timed with its bound
    (the film sectors the taps land in and the taps read once) and one
    ``index_add_``."""
    import numpy as np
    import torch

    cfg = mt.load_dict(mt.cornell_box(), device=dev).sensors[0].film
    hw = cfg.width * cfg.height
    n, t_pad = N_RAYS, cfg.temporal_bins + 1
    rng = np.random.default_rng(38)
    span = cfg.temporal_bins * cfg.bin_width_opl
    taps, host = [], []
    for _ in range(2):
        dist = rng.uniform(cfg.start_opl - 0.05 * span,
                           cfg.start_opl + 1.05 * span, n).astype(np.float32)
        val = rng.random((n, 3), dtype=np.float32)
        act = rng.random(n) > 0.3
        args = [torch.from_numpy(a) for a in (dist, val, act)]
        taps += tf.gaussian_taps(cfg, *(a.to(dev) for a in args),
                                 GAUSSIAN_SIGMA, n // hw)
        host += tf.gaussian_taps(cfg, *args, GAUSSIAN_SIGMA, n // hw)
    if not all(_bit_equal(a.cpu(), b) for a, b in zip(taps, host)):
        raise AssertionError("gaussian_taps differ between card and CPU")
    lanes = taps[0].shape[0] // hw  # spp * K
    k = lanes // (n // hw)
    film = torch.zeros((3, t_pad, hw), device=dev)
    tf.splat_accumulate(film, *taps, spp=lanes)
    ref = torch.zeros(film.shape)
    tf.splat_accumulate(ref, *host, spp=lanes)
    err = float((film.cpu() - ref).abs().max())
    if not _bit_equal(film.cpu(), ref):
        raise AssertionError(f"the gaussian splat is not bit-equal to its "
                             f"plain version on the CPU (max |d| {err})")
    del ref, host
    sectors, bound = splat_bound(taps, hw, t_pad)
    # the library call: one index_add_ of both sets' taps into the flat
    # film, with the flat cell indices made beforehand
    ch = torch.arange(3, device=dev)[:, None] * (t_pad * hw)
    cells = torch.cat([(ch + tf.gather_index(b, film.shape)[0][None])
                       .reshape(-1) for b in taps[0::2]])
    vals = torch.cat([v.T.reshape(-1) for v in taps[1::2]])
    flat = film.view(-1)

    def plain():
        for b, v in zip(taps[0::2], taps[1::2]):
            tf._scatter_layout(film, hw, b, v)

    r = dict(max_abs_err=err, bound=bound, sectors=sectors, taps=k,
             ms=_time_ms(lambda: tf.splat_accumulate(film, *taps,
                                                     spp=lanes)),
             plain_ms=_time_ms(plain),
             library_ms=_time_ms(lambda: flat.index_add_(0, cells, vals)))
    print(f"gaussian splat (K3 at {lanes} lanes) on two {n}-lane sets of {k} "
          f"taps into (3, {t_pad}, {hw}): bit-equal to the plain version on "
          f"the CPU, taps bit-equal card against CPU; kernel "
          f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, index_add_ "
          f"{r['library_ms']:.4f} ms; {sectors} film sectors touched -> "
          f"bound {bound[0]:.4f} ms ({bound[1]})")
    return r


def reproducibility_phase(mt, cases, dev):
    """Phase 37: reproducible results.  Returns the K8 row's measurements
    (on the flagship backward's held bounce and the texel case) and the
    gaussian splat's."""
    import numpy as np
    import torch

    from mitransient_tpu_torch.film import transient_film as tf
    from mitransient_tpu_torch.integrators import prb
    from mitransient_tpu_torch.ops import gather as G
    from mitransient_tpu_torch.scene.scene import atlas_lookup

    # 1. K8 on the flagship backward's replay bounce GRAD_HELD_BOUNCE, and
    # the flagship backward twice
    scene = mt.load_dict(mt.cornell_box(), device=dev)
    grad_in = _grad_in(scene.sensors[0].film, np.random.default_rng(11),
                       steady=True)
    bounce, held = [-1], []
    table_grads, reduce_rows = prb.table_grads, G.reduce_rows

    def counting_table_grads(obj, leaves):
        bounce[0] += 1
        return table_grads(obj, leaves)

    def capture(g, idx, rows):
        if bounce[0] == GRAD_HELD_BOUNCE:
            held.append((g.clone(), idx.clone(), rows))
        return reduce_rows(g, idx, rows)

    prb.table_grads, G.reduce_rows = counting_table_grads, capture
    try:
        g1, wall1, _p = _timed(lambda: mt.render_backward(
            scene, grad_in, **GRAD_FLAGSHIP)["__tables__"])
    finally:
        prb.table_grads, G.reduce_rows = table_grads, reduce_rows
    g2, wall2, _p = _timed(lambda: mt.render_backward(
        scene, grad_in, **GRAD_FLAGSHIP)["__tables__"])
    _tables_equal("flagship render_backward, two calls", g1, g2)
    print(f"flagship render_backward twice ({wall1:.3f} s with the capture, "
          f"{wall2:.3f} s): tables bit-identical; bounce "
          f"{GRAD_HELD_BOUNCE} reduced {len(held)} tables")
    if not held:
        raise AssertionError("no K8 call captured in the flagship backward")
    calls = [hold_reduce_rows(G, g, idx, rows, f"flagship backward bounce "
                              f"{GRAD_HELD_BOUNCE} table {i}")
             for i, (g, idx, rows) in enumerate(held)]
    del held, g1, g2

    # 2. K8 on the texel case's four taps (regime (b)), and the texture
    # gradients twice
    nt, th, tw, C = TEXEL["atlas"]
    n = TEXEL["lanes"]
    rng = np.random.default_rng(37)
    atlas = torch.from_numpy(rng.random(TEXEL["atlas"], dtype=np.float32)
                             ).to(dev).requires_grad_()
    tid = torch.from_numpy(rng.integers(0, nt, n).astype(np.int32)).to(dev)
    uv = torch.from_numpy(rng.random((n, 2), dtype=np.float32)).to(dev)
    size = torch.full((n,), float(th), device=dev)
    tuv = torch.tensor([1.0, 1.0, 0.0, 0.0], device=dev).expand(n, 4)
    cot = torch.from_numpy(rng.random((n, C), dtype=np.float32)).to(dev)
    taps = []

    def capture_all(g, idx, rows):
        taps.append((g.clone(), idx.clone(), rows))
        return reduce_rows(g, idx, rows)

    G.reduce_rows = capture_all
    try:
        torch.autograd.grad(atlas_lookup(atlas, tid, size, size, tuv, uv),
                            atlas, cot)
    finally:
        G.reduce_rows = reduce_rows
    if len(taps) != 4:
        raise AssertionError(f"the texel lookup reduced {len(taps)} taps")
    texel = [hold_reduce_rows(G, g, idx, rows, f"texel tap {i}")
             for i, (g, idx, rows) in enumerate(taps)]
    del taps, atlas
    for method in (None, "fullad"):
        sc = mt.load_dict(cases.diff_case(mt, "texels"), device=dev)
        adj = _grad_in(sc.sensors[0].film, np.random.default_rng(15))
        a, b = (mt.render_backward(sc, adj, spp=16, seed=0,
                                   method=method)["__tables__"]
                for _ in range(2))
        _tables_equal(f"texel {method or 'prb'} backward, two calls", a, b)
    print("texel case render_backward (PRB and full AD) twice: tables "
          "bit-identical")

    # 3. phase 25's NLOS full AD, phase 28's volumetric PRB and phase 24's
    # forward mode, twice each
    nlos = mt.load_dict(cases.nlos_scene(sx=NLOS_SCAN, sy=NLOS_SCAN),
                        device=dev)
    mt.nlos.focus_emitter_at_relay_wall_pixel([NLOS_SCAN / 2] * 2, nlos)
    adj = _grad_in(nlos.sensors[0].film, np.random.default_rng(14))
    runs = [_timed(lambda: mt.render_backward(
        nlos, adj, spp=NLOS["spp"], seed=0)["__tables__"]) for _ in range(2)]
    _tables_equal("NLOS full AD, two calls", runs[0][0], runs[1][0])
    print(f"NLOS single {NLOS_SCAN}x{NLOS_SCAN} full AD twice ("
          f"{runs[0][1]:.3f} s, {runs[1][1]:.3f} s): tables bit-identical")
    tut = mt.load_dict(cases.tutorial_cbox(mt), device=dev)
    adj = _grad_in(tut.sensors[0].film, np.random.default_rng(21),
                   steady=True)
    runs = [_timed(lambda: mt.render_backward(
        tut, adj, spp=VOL_GRAD["spp"], seed=0)["__tables__"])
        for _ in range(2)]
    _tables_equal("volumetric PRB, two calls", runs[0][0], runs[1][0])
    print(f"volumetric tutorial PRB backward twice ({runs[0][1]:.3f} s, "
          f"{runs[1][1]:.3f} s): tables bit-identical")
    cfg = cases.FORWARD_TIME_GRADIENTS
    fwd = mt.load_dict(cases.time_window_cbox(mt, cfg["res"], cfg["bins"]),
                       device=dev)
    tangent = {"green.reflectance.value": [1.0, 1.0, 1.0]}
    runs = [_timed(lambda: mt.render_forward(fwd, tangent, spp=cfg["spp"],
                                             seed=0)) for _ in range(2)]
    _tables_equal("forward mode, two calls", runs[0][0], runs[1][0])
    print(f"forward_time_gradients render_forward twice ({runs[0][1]:.3f} s, "
          f"{runs[1][1]:.3f} s): videos bit-identical")
    del runs

    # 4. the gaussian temporal filter: its splat against its plain version,
    # and flat_scene's gaussian-filtered renders card against CPU
    gauss = check_gaussian_splat(mt, tf, dev)
    for light in ("point", "area"):
        out = [mt.render(mt.load_dict(cases.flat_scene(light), device=d),
                         spp=64, seed=0) for d in (dev, "cpu")]
        _tables_equal(f"flat_scene ({light}) gaussian render, card against "
                      "CPU", out[0], out[1])
        print(f"flat_scene ({light} light, gaussian temporal filter) render, "
              "card against CPU: bit for bit")
    return dict(calls=calls, texel=texel), gauss


def port_only_rows(k8, gauss, phase_counts, gauss_counts):
    """The kernels line's rows of K8 and the gaussian splat, the port's
    own kernels: K8's launches in the flagship backward (phase 23), the
    splat's in phase 14's gaussian-filtered render; each must have
    launched there."""
    def times(r, prefix=""):
        return {f"{prefix}ms": r["ms"], f"{prefix}plain_ms": r["plain_ms"],
                f"{prefix}bound_ms": r["bound"][0],
                f"{prefix}bound_by": r["bound"][1],
                f"{prefix}library_ms": r["library_ms"]}

    def call(r):
        return {"rows": r["rows"], "lanes": r["lanes"],
                "channels": r["channels"], **times(r)}

    # the row's own numbers: the held bounce's call onto the most rows
    main = max(k8["calls"], key=lambda c: c["rows"])
    tex = k8["texel"][0]
    rows = [dict(
        name="reduce_rows", route="cuda",
        source="mitransient_tpu_torch/csrc/gather.cu",
        replaces="mitransient_tpu/ops/gather.py:39",
        launches=phase_counts["prb_backward"].get("reduce_rows", 0),
        max_abs_err=max(c["max_abs_err"] for c in k8["calls"] + k8["texel"]),
        **times(main),
        volumetric_prb_backward_launches=phase_counts[
            "volumetric_prb_backward"].get("reduce_rows", 0),
        calls=[call(c) for c in k8["calls"]],
        **times(tex, "texel_"), texel_calls=[call(c) for c in k8["texel"]]),
        dict(name="splat_gaussian", route="cuda",
             source="mitransient_tpu_torch/csrc/splat.cu",
             replaces="mitransient_tpu/film/transient_film.py:213",
             launches=gauss_counts.get("splat_accumulate", 0),
             max_abs_err=gauss["max_abs_err"], **times(gauss),
             sectors=gauss["sectors"], taps=gauss["taps"])]
    for r in rows:
        if not r["launches"]:
            raise AssertionError(f"{r['name']} never launched on its path")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    try:
        import mitransient_tpu_torch as mt
        import torch_cases as cases
        from mitransient_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: run it from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    assert "jax" not in sys.modules
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    print(_run([kernels._build.find_nvcc(), "--version"]).splitlines()[-1])

    info = kernels.build()
    print(f"kernels built in {info.seconds:.2f} s: {info.path.name}")
    for line in info.log.splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry")):
            print("  " + line.strip())

    rows = check_kernels(mt, cases, dev)
    counts = render_flagship(mt, cases, dev)
    render_golden(mt, cases, dev)
    mesh = build_mesh(mt, cases, dev)
    rows += check_bvh(mt, cases, dev, mesh)
    crossover(mt, cases, dev)
    counts.update(render_mesh(mt, cases, dev, mesh))
    profile_mesh(mt, mesh)
    render_small_sphere(mt, cases, dev)
    threefry_ms = check_threefry(dev)
    multipass, multipass_ref = render_multipass_flagship(
        mt, cases, dev, threefry_ms)
    render_multipass_goldens(mt, cases, dev)
    gauss_counts = multipass_card_against_cpu(mt, cases, dev)
    check_resume(mt, cases, dev)
    nlos, nlos_held = render_nlos_single(mt, cases, dev)
    render_nlos_golden(mt, cases, dev)
    nlos_card_against_cpu(mt, cases, dev)
    exhaustive_held = render_nlos_scans(mt, cases, dev)
    materials, materials_held = render_materials_flagship(mt, cases, dev)
    render_angulararea(mt, cases, dev)
    materials_card_against_cpu(mt, cases, dev)
    phase_counts, grad_held = {}, {}
    phase_counts["prb_backward"], grad_held["grad_prb"] = prb_backward_phase(
        mt, cases, dev)
    phase_counts["forward"], grad_held["grad_forward"] = forward_mode_phase(
        mt, cases, dev)
    k3fn, phase_counts["fullad"] = full_ad_phase(mt, cases, dev)
    volumetric_card_against_cpu(mt, cases, dev)
    vol, vol_held = render_volumetric_tutorial(mt, cases, dev)
    phase_counts["volumetric_prb_backward"] = volumetric_gradients(
        mt, cases, dev)
    variant_card_against_cpu(mt, cases, dev)
    phase_counts["polarized"], pol_held = render_polarized_cbox(mt, cases,
                                                                dev)
    phase_counts["spectral"], counts12, held12 = render_spectral(mt, cases,
                                                                 dev)
    phase_counts.update(counts12)
    variant_paths_card_against_cpu(mt, cases, dev)
    counts33, pol_nlos_held = render_polarized_nlos(mt, cases, dev)
    phase_counts.update(counts33)
    counts34, vol_variant_held = render_variant_tutorial(mt, cases, dev)
    phase_counts.update(counts34)
    phase_counts["variant_fullad"], fn_errs = variant_gradients(mt, cases,
                                                                dev)
    phase_counts["sharded"] = multi_device_phase(mt, cases, dev,
                                                 multipass_ref)
    k8, gauss = reproducibility_phase(mt, cases, dev)
    for r in rows:
        for phase, c in phase_counts.items():
            if r["name"] in ("closest_hit", "ray_test", "splat_accumulate"):
                r[f"{phase}_launches"] = c.get(r["name"], 0)
        if r["name"] == "splat_accumulate":
            r["max_abs_err"] = max(r["max_abs_err"],
                                   k3fn["backward_max_abs_err"],
                                   k3fn["jvp_max_abs_err"],
                                   *fn_errs.values())
            r.update(k3fn)
            r.update({f"stokes_fn_{k}_max_abs_err": v
                      for k, v in fn_errs.items()})
        r["launches"] = counts[r["name"]]
        if r["name"] in ("closest_hit", "ray_test", "splat_accumulate"):
            r["volumetric_launches"] = vol.get(r["name"], 0)
        # K1 and K3 on the volumetric tutorial's inputs (prefix volumetric_;
        # K1 also on its shadow walk's first rays, volumetric_walk_)
        for prefix, key in (("volumetric", r["name"]),
                            ("volumetric_walk", r["name"] + "_walk")):
            if key not in vol_held:
                continue
            h = vol_held[key]
            r["max_abs_err"] = max(r["max_abs_err"], h["max_abs_err"])
            r.update({f"{prefix}_ms": h["ms"],
                      f"{prefix}_plain_ms": h["plain_ms"],
                      f"{prefix}_bound_ms": h["bound"][0],
                      f"{prefix}_bound_by": h["bound"][1]})
            if "library_ms" in h:
                r.update({f"{prefix}_library_ms": h["library_ms"],
                          f"{prefix}_sectors": h["sectors"]})
        if r["name"] not in nlos_held:
            continue
        r["multipass_launches"] = multipass[r["name"]]
        r["nlos_launches"] = nlos[r["name"]]
        r["materials_launches"] = materials[r["name"]]
        # K1-K3 on the NLOS single capture's, the exhaustive capture's and
        # the materials flagship's inputs (prefixes nlos_, exhaustive_,
        # materials_): their error joins the row's
        for prefix, held in (("nlos", nlos_held), ("exhaustive",
                                                   exhaustive_held),
                             ("materials", materials_held),
                             *grad_held.items(), ("polarized", pol_held),
                             *((p, {"splat_accumulate": h})
                               for p, h in held12.items()),
                             ("pol_nlos", pol_nlos_held),
                             *((p, {"splat_accumulate": h})
                               for p, h in vol_variant_held.items())):
            if r["name"] not in held:  # K3 does not run in PRB backward
                continue
            h = held[r["name"]]
            r["max_abs_err"] = max(r["max_abs_err"], h["max_abs_err"])
            r.update({f"{prefix}_ms": h["ms"],
                      f"{prefix}_plain_ms": h["plain_ms"],
                      f"{prefix}_bound_ms": h["bound"][0],
                      f"{prefix}_bound_by": h["bound"][1]})
            if "library_ms" in h:
                r.update({f"{prefix}_library_ms": h["library_ms"],
                          f"{prefix}_sectors": h["sectors"]})
    rows += port_only_rows(k8, gauss, phase_counts, gauss_counts)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi.splitlines()[0])
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys}, **{k: v for k, v in r.items()
                                        if k not in keys}} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
