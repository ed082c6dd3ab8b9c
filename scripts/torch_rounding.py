#!/usr/bin/env python3
"""Why ``mitransient_tpu_torch/core/math.py`` rounds its own way: float32
operations on the card against the same operations on the host CPU.

Run on a machine with a CUDA device, from the root of a checkout::

    python3 scripts/torch_rounding.py

It prints, for 2^22 random arguments, how many results differ between the
card and the CPU for torch's float32 sqrt, cos, sin, division by a Python
number and an (N, 3) @ (3, 3) product, and for core/math.py's sqrt,
cos_sin and divide; how many of the regen loop's first camera rays differ
computed each way, in a 12 x 12 cbox (8 lanes a pixel) and the 256 x 256
flagship (32); and each function's time on 2^21 lanes on the card (the
median of 5 batches of 20 calls).
"""
from __future__ import annotations

import os
import statistics
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]


def time_ms(fn, reps=20, batches=5):
    for _ in range(3):
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


def differing(f, *args, dev):
    """Results of ``f`` whose bits differ between ``dev`` and the CPU."""
    got = f(*(a.to(dev) for a in args)).cpu()
    want = f(*args)
    return int((got.view(torch.int32) != want.view(torch.int32)).sum())


def camera_rays(tm, plain: bool, dev, w: int, lanes: int):
    """The regen loop's first camera rays of a w x w cbox (``lanes`` a
    pixel), with torch's float32 operations or core/math.py's."""
    import mitransient_tpu_torch as mt
    import torch_cases as cases
    from mitransient_tpu_torch.integrators.path_regen import hash_uniform
    from mitransient_tpu_torch.sensors.perspective import build_camera

    desc = cases.small_cbox(mt, w, w)
    cam = build_camera(mt.load_dict(desc, device=dev).sensors[0], device=dev)
    h = w
    lane = torch.arange(w * h * lanes, dtype=torch.int64, device=dev)
    pix = lane % (w * h)
    sid = (lane // (w * h)) * (w * h) + pix
    px, py = (pix % w).to(torch.float32), (pix // w).to(torch.float32)
    if plain:
        u = (px + hash_uniform(0, sid, 0)) / w
        v = (py + hash_uniform(0, sid, 1)) / h
    else:
        u = tm.divide(px + hash_uniform(0, sid, 0), w)
        v = tm.divide(py + hash_uniform(0, sid, 1), h)
    d = torch.stack([(1.0 - 2.0 * u) * cam.tan_half[0],
                     (1.0 - 2.0 * v) * cam.tan_half[1],
                     torch.ones_like(u)], dim=-1)
    d = d @ cam.R.T
    if plain:
        return (d / torch.sqrt(tm.dot(d, d))[:, None]).cpu()
    return tm.normalize(d).cpu()


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_rounding: no CUDA device", file=sys.stderr)
        return 1
    from mitransient_tpu_torch.core import math as tm

    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    x = torch.rand(1 << 22, generator=g) * 8.0 - 4.0
    v = torch.rand((1 << 16, 3), generator=g) - 0.5
    R = torch.rand((3, 3), generator=g)
    n = x.numel()
    pairs = (
        ("sqrt", lambda a: torch.sqrt(a.abs()), lambda a: tm.sqrt(a.abs())),
        ("cos", torch.cos, lambda a: tm.cos_sin(a)[0]),
        ("sin", torch.sin, lambda a: tm.cos_sin(a)[1]),
        ("x / 12", lambda a: a / 12, lambda a: tm.divide(a, 12)),
        ("x / 0.02", lambda a: a / 0.02, lambda a: tm.divide(a, 0.02)),
    )
    print(torch.cuda.get_device_name(0))
    for name, plain, ours in pairs:
        print(f"{name}: torch float32 {differing(plain, x, dev=dev)} of {n} "
              f"results differ card against CPU, core/math.py "
              f"{differing(ours, x, dev=dev)}")
    print(f"(N, 3) @ (3, 3): torch "
          f"{differing(lambda a, b: a @ b.T, v, R, dev=dev)} of {v.numel()} "
          "results differ card against CPU")
    for w, lanes in ((12, 8), (256, 32)):
        for plain in (True, False):
            c = camera_rays(tm, plain, "cpu", w, lanes)
            d = camera_rays(tm, plain, dev, w, lanes)
            rays = int((c.view(torch.int32) != d.view(torch.int32)).any(1)
                       .sum())
            print(f"camera rays of a {w}x{w} cbox, "
                  f"{'torch float32' if plain else 'core/math.py'}: {rays} "
                  f"of {c.shape[0]} differ card against CPU")
    xs = x[: 1 << 21].to(dev)
    for name, plain, ours in pairs:
        print(f"{name} on 2^21 lanes: torch {time_ms(lambda: plain(xs)):.4f} "
              f"ms, core/math.py {time_ms(lambda: ours(xs)):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
