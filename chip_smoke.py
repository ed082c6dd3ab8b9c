#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels from ``mitransient_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version at the shapes of the flagship
render, renders the flagship transient Cornell box (256x256, 300 bins,
max_depth 8, spp 1024) on the card through the kernels, checks its
physics, renders the small ``cbox_rgb`` config against its golden, and
prints, as its last three lines, the card's name and power limit, one JSON
object with each kernel's launches, error and times, and
``{"ok": true, "device": {...}}``.  Any failed phase raises, so no ``ok``
line is printed and the exit code is not 0.  Without a CUDA device, or
without the rest of the repository beside it, it exits with an error.
Nothing here imports jax.
"""
from __future__ import annotations

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
MAX_RAY_MISMATCHES = 2  # of N_RAYS, for K1 and K2
SPLAT_TOL = 1e-6  # K3: max abs error <= SPLAT_TOL * max|film|
TIMING_REPS = 20


def _run(cmd):
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    return (res.stdout + res.stderr).strip()


def _time_ms(fn, reps=TIMING_REPS, warmup=3):
    """Median milliseconds of ``fn`` on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def check_kernels(mt, cases, dev):
    """K1-K3 against their plain versions at the flagship's shapes."""
    import numpy as np
    import torch

    from mitransient_tpu_torch.film import transient_film as tf
    from mitransient_tpu_torch.ops import intersect as isect
    from mitransient_tpu_torch.sensors.perspective import build_camera

    scene = mt.load_dict(mt.cornell_box(), device=dev)
    soup = (scene.data.tri.v0, scene.data.tri.e1, scene.data.tri.e2)
    cam = build_camera(scene.sensors[0])
    rng = np.random.default_rng(0)
    half = N_RAYS // 2
    o_c, d_c = cases.camera_rays(rng, half, cam.R.numpy().astype(np.float64),
                                 cam.origin.numpy(), cam.tan_half.numpy())
    o_r, d_r, maxt_r, act_r = cases.random_rays(rng, N_RAYS - half)
    o = np.concatenate([o_c, o_r])
    d = np.concatenate([d_c, d_r])
    maxt = np.concatenate([np.full(half, np.inf, np.float32), maxt_r])
    active = np.concatenate([rng.random(half) >= 0.1, act_r])
    o, d, maxt, active = (torch.from_numpy(a).to(dev)
                          for a in (o, d, maxt, active))
    # shadow rays get a finite maxt: the lengths of connections in the box
    maxt_sh = torch.from_numpy(
        rng.uniform(0.05, 3.0, N_RAYS).astype(np.float32)).to(dev)
    rows = []

    def report_rays(name, bad, extra):
        idx = torch.nonzero(bad).flatten().tolist()
        for i in idx[:10]:
            print(f"  {name} mismatch ray {i}: o={o[i].tolist()} "
                  f"d={d[i].tolist()} maxt={extra[i].item()} "
                  f"active={bool(active[i])}")
        print(f"{name}: {len(idx)} of {N_RAYS} rays differ "
              f"(at most {MAX_RAY_MISMATCHES} allowed)")
        if len(idx) > MAX_RAY_MISMATCHES:
            raise AssertionError(f"{name}: {len(idx)} rays differ")

    # K1 closest hit
    t_k, prim_k = isect.closest_hit(*soup, o, d, maxt, active)
    t_p, prim_p, _, _ = isect.intersect_soup(*soup, o, d, maxt, active)
    torch.cuda.synchronize()
    both = (prim_k == prim_p) & (prim_k >= 0)
    t_bad = both & ~torch.isclose(t_k, t_p, rtol=1e-6, atol=0.0)
    report_rays("K1 closest_hit", (prim_k != prim_p) | t_bad, maxt)
    k1_err = float((t_k - t_p)[both].abs().max())
    print(f"K1: {int((prim_k >= 0).sum())} hits, max |dt| {k1_err}")
    rows.append(dict(
        name="closest_hit", route="cuda",
        source="mitransient_tpu_torch/csrc/intersect.cu",
        replaces="mitransient_tpu/ops/intersect_pallas.py:44",
        max_abs_err=k1_err,
        ms=_time_ms(lambda: isect.closest_hit(*soup, o, d, maxt, active)),
        plain_ms=_time_ms(lambda: isect.intersect_soup(*soup, o, d, maxt,
                                                       active))))

    # K2 any hit
    occ_k = isect.ray_test(*soup, o, d, maxt_sh, active)
    occ_p = isect.ray_test_soup(*soup, o, d, maxt_sh, active)
    torch.cuda.synchronize()
    report_rays("K2 ray_test", occ_k != occ_p, maxt_sh)
    print(f"K2: {int(occ_k.sum())} occluded of {int(active.sum())} active")
    rows.append(dict(
        name="ray_test", route="cuda",
        source="mitransient_tpu_torch/csrc/intersect.cu",
        replaces="mitransient_tpu/ops/intersect_pallas.py:98",
        max_abs_err=float((occ_k.float() - occ_p.float()).abs().max()),
        ms=_time_ms(lambda: isect.ray_test(*soup, o, d, maxt_sh, active)),
        plain_ms=_time_ms(lambda: isect.ray_test_soup(*soup, o, d, maxt_sh,
                                                      active))))

    # K3 splat, two event sets into a (3, 301, 65536) film
    hw = 256 * 256
    (ba, va), (bb, vb) = (
        tuple(torch.from_numpy(a).to(dev)
              for a in cases.splat_events(rng, SPLAT_LANES, hw, SPLAT_BINS))
        for _ in range(2))
    film_k = torch.zeros((3, SPLAT_BINS + 1, hw), device=dev)
    film_p = torch.zeros_like(film_k)
    tf.splat_accumulate(film_k, ba, va, bb, vb, spp=SPLAT_LANES)
    tf._scatter_layout(film_p, hw, ba, va)
    tf._scatter_layout(film_p, hw, bb, vb)
    torch.cuda.synchronize()
    k3_err = float((film_k - film_p).abs().max())
    scale = float(film_p.abs().max())
    print(f"K3 splat_accumulate: max |dfilm| {k3_err} (limit "
          f"{SPLAT_TOL} * {scale})")
    if not k3_err <= SPLAT_TOL * scale:
        raise AssertionError("K3 disagrees with its plain version")

    def plain_splat():
        tf._scatter_layout(film_p, hw, ba, va)
        tf._scatter_layout(film_p, hw, bb, vb)

    rows.append(dict(
        name="splat_accumulate", route="cuda",
        source="mitransient_tpu_torch/csrc/splat.cu",
        replaces="mitransient_tpu/ops/splat_pallas.py:36",
        max_abs_err=k3_err,
        ms=_time_ms(lambda: tf.splat_accumulate(film_k, ba, va, bb, vb,
                                                spp=SPLAT_LANES)),
        plain_ms=_time_ms(plain_splat)))
    for r in rows:
        print(f"{r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
    return rows


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
        if "registers" in line or "Compiling entry" in line:
            print("  " + line.strip())

    rows = check_kernels(mt, cases, dev)
    counts = render_flagship(mt, cases, dev)
    render_golden(mt, cases, dev)
    for r in rows:
        r["launches"] = counts[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms")
    print(smi.splitlines()[0])
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
