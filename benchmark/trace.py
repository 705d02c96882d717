"""The traced run's profiler trace, reduced to what the per-layer metrics
read: device seconds by kernel name, the busy time (the union of kernel
intervals), the traced window's length, and the idle gaps by what the host
was doing.

The kernel-name -> layer table is the port's own (``scripts/
profile_iteration.py::ALS_PARTS``, ``scripts/yahoo_robustness.py::
HYBRID_PARTS``), copied here so that the yardstick does not move with the
program's scripts.
"""

from __future__ import annotations

import bisect
import re

#: kernel name patterns of each layer: the CCD++ panel kernels K1 (the
#: column sweep and its reduce) and K2 (the row sweep); the ALS gram
#: products (cuBLAS' f32 SIMT kernels and its Hopper bf16 kernels), the
#: gathers ``table[idx]`` (aten::index's kernels) and K5 (Gauss-Jordan)
LAYER_PATTERNS = {
    "K1": re.compile(r"col_sweep|col_reduce"),
    "K2": re.compile(r"row_sweep"),
    "bmm": re.compile(r"gemm|nvjet|xmma|cutlass"),
    "gather": re.compile(r"index|gather"),
    "K5": re.compile(r"gj_"),
}
#: entries of the ``breakdown`` lists
TOP = 10


def profiler():
    """A torch.profiler context tracing the host and the card."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _union(spans: list) -> tuple[float, list]:
    """(total length, merged intervals) of (start, end) spans."""
    merged: list = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def _host_at(cpu: list, starts: list, t: float) -> str:
    """The innermost host operation running at time ``t`` (the shortest
    span in ``cpu``, sorted by start, that covers it)."""
    best, best_len = "host idle", None
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 400), -1):
        a, b, name = cpu[j]
        if b >= t and (best_len is None or b - a < best_len):
            best, best_len = name, b - a
    return best


def reduce_events(kernels: list, cpu: list, window_s: float,
                  iterations: int) -> dict:
    """The reduction of a trace given as kernel spans ``(name, start_us,
    end_us)`` and host spans ``(start_us, end_us, name)``, taken over
    ``window_s`` host seconds that held ``iterations`` outer iterations."""
    by_name: dict = {}
    for name, a, b in kernels:
        s, n = by_name.get(name, (0.0, 0))
        by_name[name] = (s + (b - a) / 1e6, n + 1)
    busy_us, merged = _union([(a, b) for _, a, b in kernels])
    cpu = sorted(cpu)
    starts = [a for a, _, _ in cpu]
    gaps: dict = {}
    for (_, b0), (a1, _) in zip(merged, merged[1:]):
        name = _host_at(cpu, starts, (b0 + a1) / 2)
        gaps[name] = gaps.get(name, 0.0) + (a1 - b0) / 1e6
    return {
        "kernels": [[name, s, n] for name, (s, n) in
                    sorted(by_name.items(), key=lambda x: -x[1][0])],
        "busy_s": busy_us / 1e6, "window_s": window_s,
        "iterations": iterations,
        "idle_gaps": sorted(([name, s] for name, s in gaps.items()),
                            key=lambda x: -x[1]),
    }


def reduce_profile(prof, window_s: float, iterations: int) -> dict:
    """``reduce_events`` of a finished torch.profiler trace."""
    from torch.autograd import DeviceType

    kernels, cpu = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels.append((e.name, e.time_range.start, e.time_range.end))
        elif e.device_type == DeviceType.CPU:
            cpu.append((e.time_range.start, e.time_range.end, e.name))
    return reduce_events(kernels, cpu, window_s, iterations)


def layer_seconds(trace: dict, layer: str) -> float:
    """Device seconds of the kernels whose names match ``layer``'s
    pattern, over the whole traced window."""
    rx = LAYER_PATTERNS[layer]
    return sum(s for name, s, _ in trace["kernels"] if rx.search(name))


def breakdown(trace: dict) -> dict:
    """The contract's ``breakdown``: the device operations that took most
    time and the longest idle gaps by what the host was doing."""
    return {"device_ops": [[name, s] for name, s, _ in
                           trace["kernels"][:TOP]],
            "idle_gaps": trace["idle_gaps"][:TOP]}
