#!/usr/bin/env python3
"""K8 (the table-gradient reduction, ``ops/gather.py:reduce_rows``) of one
tree of the repository on the card, for comparing two trees in turns.

Run on a machine with a CUDA device::

    python3 scripts/torch_k8_compare.py [--root TREE] [--label NAME]
        [--check] [--parts P,...] [--json PATH]

``--root`` names the checkout whose ``mitransient_tpu_torch`` (and so whose
``csrc/gather.cu``) is imported and built, by default this script's own;
the cases come from this script's ``chip_smoke.py`` (``k8_cases``): the
flagship ``render_backward`` twice with K8 on its bounce-1 calls, the
textured flagship backward (a checkerboard floor) twice with K8 on its
bounce-1 atlas taps, the texel case's four taps and ``K8_WORST``
(or only the ``--parts`` named, of ``chip_smoke.K8_PARTS``).
Each call is timed (kernel, plain version, ``index_add_``) with its runs;
``--check`` also holds each against its plain version on the host CPU.
The stable sort of a call's indices above 128 rows is timed on its own.
One line a call; with ``--json``, every number also in that file.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--parts", default=None,
                    help="comma-separated cases of chip_smoke.K8_PARTS")
    ap.add_argument("--json", default=None, help="file for every number")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import torch

    if not torch.cuda.is_available():
        print("torch_k8_compare: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import mitransient_tpu_torch as mt
    from mitransient_tpu_torch import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{args.label}: {root}, {smi}")
    info = kernels.build()
    print(f"kernels built in {info.seconds:.2f} s: {info.path.name}")
    for line in info.log.splitlines():  # ptxas' report
        if any(w in line for w in ("registers", "spill", "Compiling entry")):
            print("  " + line.strip())
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    parts = args.parts.split(",") if args.parts else smoke.K8_PARTS
    k8 = smoke.k8_cases(mt, dev, check=args.check, parts=parts)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(label=args.label, root=root, device=smi, **k8), f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
