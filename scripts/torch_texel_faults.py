#!/usr/bin/env python3
"""The planted faults of ``portbench/tests/test_portbench_textured.py``
(its ``FAULTS`` and ``planted``) at ``cbox_textured.grad``'s full size,
for the readings its limits are set from (``portbench/control.py`` reads
the program, the control and the half-spp backward planted in the
reference, not these).

Run from the root of the repository on a machine with a CUDA device::

    python3 scripts/torch_texel_faults.py SEED[,SEED...]

One JSON line a seed and fault, with the numbers the run compared.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "portbench"), ROOT,
                os.path.join(ROOT, "portbench", "tests")]
import torch  # noqa: E402

import run  # noqa: E402
from test_portbench_textured import FAULTS, planted  # noqa: E402

CELL = "cbox_textured.grad"


def main() -> int:
    torch.set_num_threads(1)
    for seed in (int(s) for s in sys.argv[1].split(",")):
        for kind in FAULTS:
            with planted(kind, CELL) as program:
                res = run.run_cell(CELL, seed, 1.0, False, mt=program,
                                   log=lambda m: print(m, file=sys.stderr))
            print(json.dumps({"seed": seed, "fault": kind,
                              "correct": res["correct"],
                              "compared": {k: v["value"] for k, v in
                                           res["compared"].items()}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
