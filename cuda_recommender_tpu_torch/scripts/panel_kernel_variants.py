"""Panel-kernel variant matrix (the port of
``scripts/panel_kernel_variants.py``): where does K1's time go?

    python -m cuda_recommender_tpu_torch.scripts.panel_kernel_variants \\
        [M W]

At M x W bfloat16 (default 165,376 x 18,432) with the probe's NaN-sentinel
pattern (cell (r, c) observed, value 1, where (7r + 13c) % 41 == 0; NaN
elsewhere), each run timed by CUDA events over REPS chained launches
after one warm-up launch:

  rmw_floor  the read-modify-write floor: R <- R + 1, no sweep, in
             16-byte vectors (``probe_kernels.stream_rmw``)
  read_floor the read floor: g = column sums with NaN read as 0, in
             16-byte vectors (``probe_kernels.stream_read``)
  rmw_add_   ``R.add_(1)``, the one PyTorch call that does rmw_floor's work
  read_nansum  ``torch.nansum(R, 0)``, the one PyTorch call that does
             read_floor's work
  A0         K1, panel_update_vsweep (hardware round-to-nearest-even)
  A1         K1 with its store rounded by integer round-to-nearest-even on
             the f32 bits (panel_update_vsweep_irne), from the same
             initial panel through as many chained launches as A0
  B0         K2, panel_usweep

The floors run in turns with their PyTorch call (floor, call, call,
floor; ``sweep_timing.time_turns``) on one panel each; then
A1 against A0: the stored residuals' bit mismatches (0 expected: both
round to nearest even) and max |g diff|. Prints one line per run and a
JSON summary with the launch counts.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops import launches
from ..ops import panel_kernels as pk
from ..ops import probe_kernels as pr
from .common import card, rate, time_ms
from .sweep_timing import time_turns

DEFAULT_SHAPE = (165_376, 18_432)
#: timed launches per run, after one untimed
REPS = 10
#: a cell is observed where (ROW_MUL * r + COL_MUL * c) % PERIOD == 0
ROW_MUL, COL_MUL, PERIOD = 7, 13, 41


def pattern_panel(M: int, W: int, device) -> torch.Tensor:
    """The probe's (M, W) bfloat16 panel: 1 where observed, NaN elsewhere,
    built on ``device`` in row chunks."""
    R = torch.empty((M, W), dtype=torch.bfloat16, device=device)
    c = (torch.arange(W, device=device) * COL_MUL) % PERIOD
    rows = max(1, (1 << 26) // W)
    for r0 in range(0, M, rows):
        r = (torch.arange(r0, min(M, r0 + rows), device=device) * ROW_MUL
             ) % PERIOD
        obs = (r[:, None] + c[None, :]) % PERIOD == 0
        R[r0:r0 + rows] = torch.where(obs, 1.0, float("nan"))
    return R


def run(M: int, W: int, device, seed: int = 0) -> dict:
    """The seven runs and the A1/A0 comparison; returns the summary."""
    rng = np.random.default_rng(seed)
    uo, up = (torch.as_tensor(rng.normal(size=M).astype(np.float32),
                              device=device) for _ in range(2))
    vo, vp = (torch.as_tensor(rng.normal(size=W).astype(np.float32),
                              device=device) for _ in range(2))
    cells = M * W
    out = {"shape": [M, W], "reps": REPS, "device": card(device)}
    launches.reset_launch_counts()

    def report(tag, nbytes, ms):
        out[tag] = rate(nbytes, ms)
        gbs = out[tag]["GB_s"]
        print(f"{tag:16s}: " + ("not measured (cpu)" if ms is None else
                                f"{ms:.3f} ms ({gbs:.0f} GB/s)"),
              flush=True)

    R = pattern_panel(M, W, device)
    for tags, nbytes, fns in (
            (("rmw_floor", "rmw_add_"), 4 * cells,
             (lambda: pr.stream_rmw(R), lambda: R.add_(1))),
            (("read_floor", "read_nansum"), 2 * cells,
             (lambda: pr.stream_read(R),
              lambda: torch.nansum(R, 0, dtype=torch.float32)))):
        for tag, turns in zip(tags, time_turns(fns, device, REPS)):
            report(tag, nbytes, None if turns[0] is None else sum(turns) / 2)
    del R

    res = {}
    for tag, fn in (("A0", pk.panel_update_vsweep),
                    ("A1", pk.panel_update_vsweep_irne)):
        R = pattern_panel(M, W, device)
        last = []

        def call(R=R, fn=fn, last=last):
            last[:] = fn(R, uo, up, vo, vp)

        report(tag, 4 * cells, time_ms(call, device, REPS, 1))
        res[tag] = (R, *last)
        del R
    (R0, g0, _), (R1, g1, _) = res["A0"], res["A1"]
    mism = int((R0.view(torch.int16) != R1.view(torch.int16)).sum())
    g_diff = float((g0 - g1).abs().max())
    out["A1_vs_A0"] = {"bit_mismatches": mism, "cells": cells,
                       "max_abs_g_diff": g_diff}
    print(f"A1 vs A0: residual bit-mismatches {mism}/{cells}, max|g diff| "
          f"{g_diff:.3e}", flush=True)
    del R1, res
    report("B0", 2 * cells,
           time_ms(lambda: pk.panel_usweep(R0, vo), device, REPS, 1))
    out["launches"] = launches.launch_counts()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="cuda_recommender_tpu_torch.scripts.panel_kernel_variants",
        description="K1 variant matrix and its stream floors")
    p.add_argument("shape", nargs="*", type=int, metavar="M W",
                   help=f"panel rows and width (default "
                        f"{DEFAULT_SHAPE[0]} {DEFAULT_SHAPE[1]})")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if len(args.shape) not in (0, 2):
        p.error("give both M and W, or neither")
    M, W = args.shape or DEFAULT_SHAPE
    out = run(M, W, resolve_device(args.device))
    print(json.dumps(out), flush=True)
    return 0 if out["A1_vs_A0"]["bit_mismatches"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
