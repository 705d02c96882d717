"""The program's spans in a traced window, and what they attribute.

The port names the parts of its training step with ``crtpu.*`` profiler
ranges (its ``utils/timing.py::span``): ``crtpu.step`` around each outer
iteration's step, inside it ``crtpu.ccd.panels`` and ``crtpu.ccd.tail``
(CCD++) or ``crtpu.als.gather``, ``crtpu.als.gram`` and ``crtpu.als.solve``
(ALS), and beside it ``crtpu.eval.rmse``, ``crtpu.loop.sync``,
``crtpu.loop.callback`` and ``crtpu.loop.checkpoint``. The ranges are of
function scope, so they put no annotation on the device's timeline.

``reduce_spans`` attributes each device operation (kernel, copy, fill) to
the innermost span that held its launch on the launching thread (the
profiler links a device operation to its runtime call by correlation id),
and each idle gap of the card to the innermost span at the gap's midpoint.
``span_metrics`` reads six figures from that: the ELL tail's, the test
RMSE's, the ALS gathers' and gram products' device ms an iteration, the
share of the window that the card idled while the host was inside the
step, and the launches of a step.

    python3 -m benchmark.spans --workload <name> --seed <n> --seconds <s>

runs a cell's program as ``python3 -m benchmark.run --trace 1`` does (the
same set-up, window and traced iterations; no reference, no comparison)
and prints one JSON line: the cell's per-layer metrics from that traced
window, ``span_metrics``, and the span reduction. It exits 2 without a
CUDA card.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys

#: prefix of the program's span names
PREFIX = "crtpu."
#: where a gap or an operation lies outside every program span
OUTSIDE = "outside"


def profile_tuples(prof) -> tuple[list, dict, list]:
    """``(ops, launches, spans)`` of a finished torch.profiler trace, times
    in µs from the trace's first event: ``ops`` the card's kernels, copies
    and fills ``(name, start, end, correlation)`` (user annotations left
    out); ``launches`` the host's runtime calls ``{correlation: (start,
    thread)}``, the thread being that of the host operation the profiler
    links the call to (None where it links none); ``spans`` the program's
    ranges ``(name, start, end, thread)``."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    base = min((e.start_ns() for e in events), default=0)
    ops, spans, threads, runtime = [], [], {}, {}
    for e in events:
        name = e.name()
        a, b = (e.start_ns() - base) / 1e3, (e.end_ns() - base) / 1e3
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append((name, a, b, e.correlation_id()))
        elif name.startswith("cu"):
            # a CUDA runtime or driver call: its correlation is the device
            # operation's, its link the host operation it ran inside
            runtime[e.correlation_id()] = (a, e.linked_correlation_id())
        else:
            threads[e.correlation_id()] = e.start_thread_id()
            if name.startswith(PREFIX):
                spans.append((name, a, b, e.start_thread_id()))
    launches = {corr: (a, threads.get(link))
                for corr, (a, link) in runtime.items()}
    return ops, launches, spans


class _Nest:
    """The spans' nesting on each thread: each span's parent (the
    innermost span that encloses it, -1 for none) and, per thread, the
    times at which the innermost span changes, for a lookup by bisection.
    A span that outlasts its parent (a range the profiler's stop cut) is
    cut to its parent's end."""

    def __init__(self, spans: list):
        self.spans = spans
        self.parent = [-1] * len(spans)
        self.end = [b for _, _, b, _ in spans]
        self.marks: dict = {}
        by_thread: dict = {}
        for i, (_, a, b, th) in enumerate(spans):
            by_thread.setdefault(th, []).append(i)
        for th, idx in by_thread.items():
            idx.sort(key=lambda i: (spans[i][1], -spans[i][2]))
            times, inner = [], []
            stack: list = []

            def mark(t, i):
                if times and times[-1] == t:
                    inner[-1] = i
                else:
                    times.append(t)
                    inner.append(i)

            def pop_until(t):
                while stack and self.end[stack[-1]] <= t:
                    j = stack.pop()
                    mark(self.end[j], stack[-1] if stack else -1)

            for i in idx:
                a = spans[i][1]
                pop_until(a)
                if stack:
                    self.parent[i] = stack[-1]
                    self.end[i] = min(self.end[i], self.end[stack[-1]])
                mark(a, i)
                stack.append(i)
            pop_until(float("inf"))
            self.marks[th] = (times, inner)

    def innermost(self, t: float, thread=None) -> int:
        """The innermost span at time ``t`` on ``thread`` (with None, on
        any thread: the shortest of the threads' innermost), -1 for none."""
        threads = self.marks if thread is None else (thread,)
        best, best_len = -1, None
        for th in threads:
            times, inner = self.marks.get(th, ((), ()))
            k = bisect.bisect_right(times, t) - 1
            i = inner[k] if k >= 0 else -1
            if i >= 0 and (best_len is None or
                           self.end[i] - self.spans[i][1] < best_len):
                best, best_len = i, self.end[i] - self.spans[i][1]
        return best

    def names_up(self, i: int) -> set:
        """The names of span ``i`` and of every span that encloses it."""
        names = set()
        while i >= 0:
            names.add(self.spans[i][0])
            i = self.parent[i]
        return names


def _union_gaps(ops: list) -> tuple[float, list]:
    """(busy µs, the gaps between the merged intervals of ``ops``)."""
    merged: list = []
    for _, a, b, _ in sorted(ops, key=lambda o: o[1]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(merged, merged[1:])]
    return sum(b - a for a, b in merged), gaps


def reduce_spans(ops: list, launches: dict, spans: list, window_s: float,
                 iterations: int) -> dict:
    """The window's device work and idle gaps by program span
    (``profile_tuples``' tuples; the window's host seconds and the outer
    iterations it held). For each span name: ``count``, host seconds
    (``host_s``, and ``host_self_s`` less its children), device seconds
    and launches of the operations launched inside it (``device_s``,
    ``launches``: at any depth; ``device_self_s``, ``launches_self``: with
    no span between; ``kernels``: self seconds by operation name) and
    idle seconds of the card (``idle_s``, ``idle_self_s``, by the
    innermost span at a gap's midpoint). ``unattributed_s``: device
    seconds launched outside every span, or whose launch the trace lacks;
    ``idle_by_span``: idle seconds by innermost span, ``outside`` for
    none."""
    nest = _Nest(spans)
    per: dict = {}

    def entry(name):
        return per.setdefault(name, dict(
            count=0, host_s=0.0, host_self_s=0.0, device_s=0.0,
            device_self_s=0.0, launches=0, launches_self=0, idle_s=0.0,
            idle_self_s=0.0, kernels={}))

    for i, (name, a, _, _) in enumerate(spans):
        e, dt = entry(name), (nest.end[i] - a) / 1e6
        e["count"] += 1
        e["host_s"] += dt
        e["host_self_s"] += dt
        if nest.parent[i] >= 0:
            entry(spans[nest.parent[i]][0])["host_self_s"] -= dt
    unattributed = 0.0
    for name, a, b, corr in ops:
        dt = (b - a) / 1e6
        launch = launches.get(corr)
        i = nest.innermost(*launch) if launch else -1
        if i < 0:
            unattributed += dt
            continue
        e = entry(spans[i][0])
        e["device_self_s"] += dt
        e["launches_self"] += 1
        e["kernels"][name] = e["kernels"].get(name, 0.0) + dt
        for up in nest.names_up(i):
            entry(up)["device_s"] += dt
            entry(up)["launches"] += 1
    busy_us, gaps = _union_gaps(ops)
    idle: dict = {}
    for b0, a1 in gaps:
        dt = (a1 - b0) / 1e6
        i = nest.innermost((b0 + a1) / 2)
        name = spans[i][0] if i >= 0 else OUTSIDE
        idle[name] = idle.get(name, 0.0) + dt
        if i >= 0:
            entry(name)["idle_self_s"] += dt
            for up in nest.names_up(i):
                entry(up)["idle_s"] += dt
    return {
        "spans": per, "window_s": window_s, "iterations": iterations,
        "device_s": sum((b - a) for _, a, b, _ in ops) / 1e6,
        "launches": len(ops), "unattributed_s": unattributed,
        "busy_s": busy_us / 1e6, "idle_s": sum(idle.values()),
        "idle_by_span": sorted(([n, s] for n, s in idle.items()),
                               key=lambda x: -x[1]),
    }


def span_metrics(red: dict) -> dict:
    """The figures a span reduction gives, each None where its span did
    not run: device ms an iteration launched inside ``crtpu.ccd.tail``
    (``ell_tail_ms``), ``crtpu.eval.rmse`` (``rmse_ms``),
    ``crtpu.als.gather`` (``gather_ms``) and ``crtpu.als.gram``
    (``gram_ms``); the share of the window that the card idled while the
    host's innermost span lay inside ``crtpu.step`` (``dispatch_idle_pct``:
    starved by the step's dispatch, not by the loop's fence or callback);
    operations launched inside ``crtpu.step`` an iteration
    (``step_launches``)."""
    spans, n = red["spans"], red["iterations"]

    def per_iter(name, key, scale):
        if name not in spans or not n:
            return None
        return scale * spans[name][key] / n

    step = spans.get("crtpu.step")
    return {
        "ell_tail_ms": per_iter("crtpu.ccd.tail", "device_s", 1e3),
        "rmse_ms": per_iter("crtpu.eval.rmse", "device_s", 1e3),
        "gather_ms": per_iter("crtpu.als.gather", "device_s", 1e3),
        "gram_ms": per_iter("crtpu.als.gram", "device_s", 1e3),
        "dispatch_idle_pct": (100.0 * step["idle_s"] / red["window_s"]
                              if step and red["window_s"] > 0 else None),
        "step_launches": per_iter("crtpu.step", "launches", 1),
    }


def layers_by_span(red: dict) -> dict:
    """Device seconds of each layer of ``trace.LAYER_PATTERNS`` by the
    innermost span that launched it (``unattributed`` time aside)."""
    from .trace import LAYER_PATTERNS

    out: dict = {layer: {} for layer in LAYER_PATTERNS}
    for span_name, e in red["spans"].items():
        for kernel, s in e["kernels"].items():
            for layer, rx in LAYER_PATTERNS.items():
                if rx.search(kernel):
                    out[layer][span_name] = out[layer].get(span_name, 0.0) + s
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python3 -m benchmark.spans",
        description="a cell's traced window by the program's spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from . import cell as cellmod, datagen, peaks, spec, trace

    c = spec.resolve(spec.load_spec(), args.workload)
    if not torch.cuda.is_available():
        print("benchmark.spans: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    data = datagen.generate(c.traffic, args.seed, device)
    cellmod._free(device)
    kept: dict = {}
    reduce_profile = trace.reduce_profile

    def reduce_and_keep(prof, window_s, iterations):
        kept.update(reduce_spans(*profile_tuples(prof), window_s,
                                 iterations))
        return reduce_profile(prof, window_s, iterations)

    trace.reduce_profile = reduce_and_keep
    try:
        out = cellmod.run_program(c, data, args.seed, args.seconds, device,
                                  traced=True)
    finally:
        trace.reduce_profile = reduce_profile
    tr = out.context.trace
    metrics = {m["name"]: spec.metric_reader(m["name"]).read(out.context)
               for m in c.per_layer}
    line = {"workload": c.name, "seed": args.seed,
            "device": peaks.card(device),
            "window_iter_s": out.window_s / out.iters,
            "traced_iter_s": tr["window_s"] / tr["iterations"],
            "trace_busy_s": tr["busy_s"], "metrics": metrics,
            "span_metrics": span_metrics(kept),
            "layers_by_span": layers_by_span(kept), "spans": kept}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
