"""Run one cell of the port's benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (an entry of ``workloads`` in BENCHMARK.json) names a
configuration and a traffic mix; everything else is found from those names
(``spec.py``). The run makes the ratings and initial factors from
``--seed``, sets up and warms up the port's solver, measures whole outer
iterations for ``--seconds`` (``cell.py``), and compares the output with
the plain reference. The last line of standard output is one JSON object:
``correct``, ``attempted`` (the window's iterations), ``failed`` (those
whose test RMSE is not finite), ``metrics`` (with ``--trace 0`` the
end-to-end metrics; with ``--trace 1`` the cell's per-layer metrics, read
from a profiler trace of the window), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit,
which also end standard error.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
2 and prints no result. If JAX or the JAX package is loaded once the
window has closed, it names them on standard error, exits 3 and prints no
result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "cuda_recommender_tpu")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python3 -m benchmark.run",
        description="one run of one cell of the port's benchmark")
    p.add_argument("--workload", required=True,
                   help="a workload name of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True,
                   help="seed of the ratings and the initial factors")
    p.add_argument("--seconds", type=float, required=True,
                   help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: trace the window and report per-layer metrics")
    return p


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, whole)
    is one of FORBIDDEN."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def result_line(cell, out, device_rec: dict, traced: bool,
                correct: bool) -> dict:
    """The contract's result object of one run."""
    from . import spec, trace as tracing

    if traced:
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"]).read(out.context)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        tr = out.context.trace
        device_rec = dict(device_rec, busy_s=tr["busy_s"],
                          window_s=tr["window_s"])
    else:
        e2e = {"iter_s": out.window_s / out.iters,
               "peak_mem_gib": out.peak_bytes / 2 ** 30,
               "setup_s": out.setup_s}
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {name: {"value": e2e[name], "unit": units[name]}
                   for name in units if name in e2e}
    line = {"correct": correct, "attempted": out.iters,
            "failed": out.failed, "metrics": metrics, "device": device_rec}
    if traced:
        line["breakdown"] = tracing.breakdown(out.context.trace)
    line["checks"] = out.checks
    return line


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from . import cell as cellmod, peaks, spec

    c = spec.resolve(spec.load_spec(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"benchmark: the cell needs {c.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = cellmod.run_cell(c, args.seed, args.seconds, device,
                           traced=bool(args.trace), t_start=T_START)
    correct, out.checks = cellmod.judge(out.readings, c.limits)
    correct = correct and out.failed == 0
    device_rec = dict(peaks.card(device), memory_peak_bytes=out.peak_bytes)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules loaded that no run may load: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 3
    line = result_line(c, out, device_rec, bool(args.trace), correct)
    print(json.dumps(line), flush=True)
    if args.trace:
        print("[trace] " + json.dumps(dict(out.context.trace,
                                           panels=out.context.panels)),
              file=sys.stderr)
    for name, value in out.readings.items():
        print(f"reading {name}: {value!r}", file=sys.stderr)
    for name, chk in out.checks.items():
        print(f"check {name}: {chk['value']!r} (limit {chk['limit']!r})",
              file=sys.stderr)
    if not out.checks:
        print("check: no limits for this workload", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
