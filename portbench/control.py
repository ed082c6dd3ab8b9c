"""The readings the comparison's limits are set from (not run by the
benchmark's runs): in one process, the program against the plain
reference on many seeds, and the control (the reference computed in
bfloat16, put in the program's place) on some of them, at the cell's own
size and load with a short window.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds 1

One JSON line a seed: its compared numbers and, on a control seed, the
control's."""
from __future__ import annotations

import argparse
import json
import sys

import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--half-backward-seeds", default="",
                    help="gradient cells: also read the fault of a "
                    "backward over half the samples, planted in the "
                    "reference put in the program's place")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench: the readings need a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    halves = {int(s) for s in args.half_backward_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.run_cell(args.workload, seed, args.seconds, False,
                           control=seed in controls,
                           half_backward=seed in halves,
                           log=lambda m: print(m, file=sys.stderr))
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "compared": {k: v["value"] for k, v in
                                       res["compared"].items()},
                          "control": res.get("control"),
                          "half_backward": res.get("half_backward")}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
