"""Run one cell of the benchmark of ``mitransient_tpu_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n>
        --seconds <s> --trace <0|1>

From the root of a checkout on a machine with an NVIDIA card.  The cell,
its configuration, its traffic, its entry and its metrics are found by
name (``harness/spec.py``).  A run builds the scene on the card, warms the
cell's own shapes once (set-up ends there), drives the cell's entry in a
closed loop until ``--seconds`` have passed (the window ends at the
completion of the call that crosses it), checks what the window produced
against the plain reference (``reference/``) and prints one JSON line
last on standard output.  With ``--trace 1`` the window runs under
``torch.profiler`` and the line carries the per-layer metrics instead of
the end-to-end ones.  It exits non-zero, printing no result, without a
CUDA device, or if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time


def _process_age_s() -> float:
    """Seconds since this process started (Linux), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        import os as _os

        return max(0.0, uptime - start_ticks / _os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


# set-up is timed from the start of the process
T_START = time.perf_counter() - _process_age_s()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# the port's kernel caches live in the checkout, at fixed paths: its CUDA
# library in build/ (the port's own choice), Triton's here
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(ROOT, "build", "triton-cache"))
os.environ.setdefault("USE_FLAX", "0")
sys.path[:0] = [BENCH_DIR, ROOT]

FORBIDDEN = ("jax", "jaxlib", "flax", "mitransient_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``mitransient_tpu_torch`` is neither)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", mt=None, shrink: dict | None = None,
             control: bool = False, half_backward: bool = False,
             log=print) -> dict:
    """One run of ``workload`` -> the result dict (see the module
    docstring).  ``mt`` (the package under test), ``device`` and
    ``shrink`` (film and traffic overrides) are for the CPU tests;
    ``control`` adds the control's numbers (the reference in bfloat16 put
    in the program's place) under ``"control"``, ``half_backward`` (a
    gradient cell) those of the reference with a backward over half the
    samples in the program's place, under ``"half_backward"``."""
    import torch

    from harness import spec, trace as trace_mod
    from harness.traffic import ClosedLoop

    cell = spec.load_cell(workload)
    if mt is None:
        import mitransient_tpu_torch as mt
    traffic = dict(cell.traffic, **(shrink or {}).get("traffic", {}))
    ctx = SimpleNamespace(mt=mt, device=device, cell=cell, seed=seed,
                          traffic=ClosedLoop(traffic, seed), shrink=shrink)
    cuda = torch.device(device).type == "cuda"
    entry = cell.entry
    state = entry.setup(ctx)
    setup_s = time.perf_counter() - T_START
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    prof = trace_mod.profiler(trace)
    with prof:
        t0 = time.perf_counter()
        index = 0
        while True:
            entry.call(state, index)
            index += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    work = entry.work(state)
    summary = trace_mod.summarize(prof) if trace else None

    walls = work.pop("walls")
    log(f"window {window_s:.6f} s, {work['calls']} calls, walls (s): "
        + " ".join(f"{w:.6f}" for w in walls))
    for key in [k for k, v in work.items() if isinstance(v, list)]:
        log(f"{key}: " + " ".join(str(v) for v in work.pop(key)))
    if work["rays"]:
        log(f"rays {work['rays']} in the window: "
            f"{work['rays'] / window_s / 1e6:.4f} M rays/s")

    outputs = entry.program_outputs(state)
    entry.release(state)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = entry.reference_outputs(state, torch.float32, device)
    # a number that is not finite reads as 1e300, which JSON can carry
    compared = {k: v if math.isfinite(v) else 1e300
                for k, v in entry.compare(outputs, ref).items()}
    log(f"reference {time.perf_counter() - t_ref:.3f} s")
    limits = cell.cell["check"]["limits"]
    correct = all(compared[k] <= limits[k] for k in compared)
    result_control = None
    if control:
        low = entry.reference_outputs(state, torch.bfloat16, device)
        result_control = entry.compare(low, ref)
    result_half = None
    if half_backward:
        half = entry.reference_outputs(
            state, torch.float32, device,
            backward_spp=traffic["spp"] // 2)
        result_half = entry.compare(half, ref)

    run = SimpleNamespace(
        setup_s=setup_s, window_s=window_s, peak_window_bytes=peak_window,
        trace=summary, **work)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if cuda
                            else "cpu"),
                   "count": int(cell.workload["chips"]),
                   "memory_peak_bytes": max(peak_setup, peak_window)}
    if cuda:
        device_info["power_limit_w"] = power_limit_w()
    result = {"correct": correct, "attempted": work["calls"], "failed": 0,
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
        log("kernels (count, s): " + json.dumps(summary.kernels))
    if result_control is not None:
        result["control"] = result_control
    if result_half is not None:
        result["half_backward"] = result_half
    result["compared"] = {k: {"value": v, "limit": limits[k]}
                          for k, v in compared.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from harness import spec

    torch.set_num_threads(1)  # one process, few threads: a steadier host
    manifest = spec.load_json(spec.ROOT / "BENCHMARK.json")
    chips = next(w["chips"] for w in manifest["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), log=log)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package loaded: "
              f"{found}", file=sys.stderr)
        return 3
    for k, v in result["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
