#!/usr/bin/env python3
"""Rays per second of the port's renders on the card, for comparing two
trees of the repository in turns.

Run on a machine with a CUDA device::

    python3 scripts/torch_render_rate.py [--root TREE] [--repeat N] [CELL ...]

``--root`` names the checkout whose ``mitransient_tpu_torch`` and
``tests/torch_cases.py`` are imported (by default this script's own), so
one copy of the script times an older tree as well.  Cells: ``flagship``
(the regen flagship, spp 1024), ``multipass`` (the same through
``regenerate=False``), ``mesh_chunk`` / ``mesh_super`` (``cbox_mesh`` in
each BVH mode), ``nlos`` (the 32x32 NLOS single capture, spp 2048) and
``materials`` (``materials_cbox``, where the tree has it).  Each cell is
rendered once to warm up (seed 0), then ``N`` times (seeds 1..N), each
timed from the call to a ``torch.cuda.synchronize()``; one line a render.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

CELLS = ("flagship", "multipass", "mesh_chunk", "mesh_super", "nlos",
         "materials")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("cells", nargs="*", default=list(CELLS))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import torch

    if not torch.cuda.is_available():
        print("torch_render_rate: no CUDA device", file=sys.stderr)
        return 1
    import mitransient_tpu_torch as mt
    import torch_cases as cases

    dev = torch.device("cuda", 0)
    for cell in args.cells:
        kw = dict(spp=1024)
        if cell in ("flagship", "multipass"):
            desc = mt.cornell_box()
            kw["regenerate"] = cell == "flagship"
        elif cell.startswith("mesh_"):
            desc = cases.cbox_mesh(mt)
            kw["bvh_mode"] = cell[len("mesh_"):]
        elif cell == "nlos":
            desc = cases.nlos_scene(sx=32, sy=32)
            kw = dict(spp=2048)
        elif cell == "materials" and hasattr(cases, "materials_cbox"):
            desc = cases.materials_cbox(mt)
        else:
            print(f"{cell}: not in this tree")
            continue
        scene = mt.load_dict(desc, device=dev)
        if cell == "nlos":
            mt.nlos.focus_emitter_at_relay_wall_pixel([16.0, 16.0], scene)
        for seed in range(args.repeat + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _s, _t, stats = mt.render(scene, seed=seed, return_stats=True,
                                      **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if seed:
                rays = int(stats["rays"])
                print(f"{cell} seed {seed}: {wall:.4f} s, {rays} rays, "
                      f"{rays / wall / 1e6:.2f} M rays/s")
            del _s, _t
    return 0


if __name__ == "__main__":
    sys.exit(main())
