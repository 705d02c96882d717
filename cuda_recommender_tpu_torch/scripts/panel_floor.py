"""Panel-side stream controls beside the panel kernels, at the headline's
panel shapes (the port of ``scripts/panel_floor.py``).

    python -m cuda_recommender_tpu_torch.scripts.panel_floor \\
        [--shapes 330128x17770,150061x4096]

Per bfloat16 panel (the headline stair's two panels at their true shapes;
the port has no block padding), each mode's ms per call, GB/s and share of
3.35 TB/s:

  rmw        control: R <- R + 1 in place, no other work, in 16-byte
             vectors (the cells walked flat, so the Pallas control's grid
             order is no parameter): what a read-modify-write stream
             reaches (the bench's yardstick, ``bench.ACHIEVABLE``);
  read       control: the u-weighted column sums of 512-row blocks, in
             16-byte vectors (likewise, for a read);
  uv         K1, panel_update_vsweep (2 + 2 B/cell);
  us         K2, panel_usweep (2 B/cell).

The panels are drawn on the device from a ``torch.Generator`` seed. PyTorch
runs eagerly, so each mode is timed with CUDA events over REPS
back-to-back launches after WARMUP others. A panel smaller than
``common.COLD_BYTES`` is timed in turns with copies of itself, 128 MB in
all, so that it comes from device memory, as it does in training, and not
from the 50 MB L2. Prints one JSON line per panel and
one line of the implied panel time per outer iteration at k = 40.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..core.device import resolve_device
from ..ops import panel_kernels as pk
from ..ops import probe_kernels as pr
from .common import PEAK_BYTES_S, card, cold_copies, cycling, device_panel, \
    device_vector, rate, time_ms

#: the headline stair's panels (rows, width): Netflix-100M dims, k = 40,
#: hand stair (4096, 2048) under 6.5e9 cells
HEADLINE_PANELS = ((330128, 17770), (150061, 4096))
#: bytes each mode moves per panel cell
BYTES_PER_CELL = {"rmw": 4, "read": 2, "uv": 4, "us": 2}
CONTROLS = ("rmw", "read")
#: timed launches per mode, after WARMUP untimed ones
REPS, WARMUP = 20, 3
#: the headline's rank, for the implied time per outer iteration
K = 40


def panel_modes(shapes, device, *, modes=CONTROLS) -> list:
    """Time ``modes`` on a seeded bfloat16 panel of each (M, W) in
    ``shapes``, one panel at a time (freed before the next). Returns one
    record per shape: {"shape", mode: {"ms", "GB_s", "share_of_peak"}}."""
    out = []
    for i, (M, W) in enumerate(shapes):
        panels = cold_copies(device_panel(M, W, device, seed=i))
        u1, u2 = (device_vector(M, device, 100 + j) for j in (0, 1))
        v1, v2 = (device_vector(W, device, 200 + j) for j in (0, 1))
        calls = {
            "rmw": lambda R: pr.stream_rmw(R),
            "read": lambda R: pr.stream_read(R, u1),
            "uv": lambda R: pk.panel_update_vsweep(R, u1, u2, v1, v2),
            "us": lambda R: pk.panel_usweep(R, v1),
        }
        rec = {"shape": [M, W]}
        for mode in modes:
            ms = time_ms(cycling([(lambda R=R, f=calls[mode]: f(R))
                                  for R in panels]), device, REPS, WARMUP)
            rec[mode] = rate(BYTES_PER_CELL[mode] * M * W, ms)
        out.append(rec)
        del panels, calls
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _shapes(text: str):
    return tuple(tuple(int(x) for x in s.split("x")) for s in text.split(","))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="cuda_recommender_tpu_torch.scripts.panel_floor",
        description="stream controls beside K1 and K2 at panel shapes")
    p.add_argument("--shapes", default=",".join(
        f"{m}x{w}" for m, w in HEADLINE_PANELS), metavar="MxW,...")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    recs = panel_modes(_shapes(args.shapes), dev,
                       modes=CONTROLS + ("uv", "us"))
    for rec in recs:
        print(json.dumps(rec), flush=True)
    per_rank = (None if dev.type != "cuda" else
                sum(r[m]["ms"] for r in recs for m in ("uv", "us")))
    cells = sum(m * w for m, w in _shapes(args.shapes))
    implied = {"k": K, "panel_ms_per_rank": per_rank,
               "panel_s_per_iter": (None if per_rank is None
                                    else per_rank * K / 1e3),
               "bound_s_per_iter": 6 * cells * K / PEAK_BYTES_S,
               "device": card(dev)}
    print(json.dumps({"implied": implied}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
