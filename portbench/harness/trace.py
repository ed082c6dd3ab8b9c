"""The traced run's reading of ``torch.profiler``: device busy time (the
union of the intervals in which a kernel, copy or set ran), kernel time
and count by name, the operations that took most device time, and the
longest idle gaps of the device labelled by what the host was doing: the
CUDA runtime call it was in at the gap's middle (a synchronize, a copy),
or else host work, named by the device operation it issued next."""
from __future__ import annotations

import re
from contextlib import nullcontext
from typing import NamedTuple

_NAME = re.compile(r"([A-Za-z_]\w*)\s*[<(]")


def short_name(name: str) -> str:
    """A kernel's identifier: ``void at::native::foo_kernel<4, ...>(...)``
    -> ``foo_kernel``."""
    m = _NAME.search(name.replace("void ", ""))
    return m.group(1) if m else name[:60]


class TraceSummary(NamedTuple):
    busy_s: float
    kernels: dict  # short kernel name -> (count, seconds)
    n_kernels: int
    device_ops: list  # [[name, seconds]] largest first, at most 10
    idle_gaps: list  # [[host operation, seconds]] longest first


def profiler(enabled: bool):
    if not enabled:
        return nullcontext()
    import torch
    from torch.profiler import ProfilerActivity, profile

    # the device alone: tracing every host operation as well doubled a
    # render's wall on the card, and the idle share with it (the host's
    # activity stands in where there is no card: the CPU tests)
    return profile(activities=[ProfilerActivity.CUDA
                               if torch.cuda.is_available()
                               else ProfilerActivity.CPU])


def _events(prof):
    """(device intervals [(start, end, name, is_kernel)], host intervals
    [(start, end, name)]), nanoseconds on one clock."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type().name == "CUDA":
            name = e.name()
            low = name.lower()
            is_kernel = not ("memcpy" in low or "memset" in low)
            dev.append((start, end, name, is_kernel))
        else:
            host.append((start, end, e.name()))
    return dev, host


def summarize(prof) -> TraceSummary:
    dev, host = _events(prof)
    dev.sort()
    kernels: dict[str, list] = {}
    by_op: dict[str, float] = {}
    n_kernels = 0
    merged = []
    for start, end, name, is_kernel in dev:
        sec = (end - start) * 1e-9
        key = short_name(name)
        by_op[key] = by_op.get(key, 0.0) + sec
        if is_kernel:
            n_kernels += 1
            k = kernels.setdefault(key, [0, 0.0])
            k[0] += 1
            k[1] += sec
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    busy = sum(b - a for a, b in merged) * 1e-9
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:10]
    labelled = []
    for length, a, b in gaps:
        mid = (a + b) // 2
        inner = [(e - s, n) for s, e, n in host if s <= mid <= e]
        if inner:  # a CUDA runtime call the host was in
            label = min(inner)[1]
        else:  # host work between calls: name what it was waiting to issue
            nxt = next((short_name(n) for s, _e, n, _k in dev if s >= b),
                       "the end")
            label = f"host, before {nxt}"
        labelled.append([label, length * 1e-9])
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(busy, {k: tuple(v) for k, v in kernels.items()},
                        n_kernels, [list(o) for o in ops], labelled)
