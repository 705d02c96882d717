"""What N cards would give the sharded panel-hybrid CCD++ step: an
analytic model (the port of ``scripts/scaling_model.py``, in its form,
with the card's own terms).

    python -m cuda_recommender_tpu_torch.scripts.scaling_model \\
        [--s-iter S] [--panel-share P] [--tail-share T] [--bus-gb-s B] \\
        [--call-ms C] [--out FILE]

The model, per outer iteration at the headline (Netflix-100M dims, k = 40,
one inner iteration), as the JAX script builds it (``:56-87``):

* compute: a rank holds m/N of every panel's rows and 1/N of the ELL
  tail (``parallel/ccd_hybrid_sharded.py`` splits both by row block), so
  the panel and tail shares of one device's measured s/iter divide by N;
  the rest (the half-sweep divisions over all of m and n, the idle gaps)
  runs on every rank and does not. The JAX model had no rest: its shares
  came from a roofline and summed to 1.
* communication: the step keeps W and H whole on every rank and
  all-reduces the pair (g, h) once a half-sweep
  (``parallel/collectives.py::all_reduce_pair``): 8·n bytes after the
  v-sweep and 8·m after the u-sweep, 2·k·T calls an outer iteration. A
  ring all-reduce moves 2·(N-1)/N of the payload through each card's
  link; each call also costs ``call_s`` on the host. Both add serially
  (the division needs the whole sum): a bound from above.
* efficiency against one device: s_iter / N / iter_s(N); the break-even
  bus rate at which it falls to 80%.

Every constant is an input (``Terms``), its default the card's own number
with its source (PERF.md): ``s_iter`` 0.6179 (the smoke's headline run,
§6); the panel share 0.946 (K1 63.9% + K2 30.7% of the busy time) and
the tail share 0.048 (the headline's profile, §5); ``call_s`` 0.19 ms,
the top of the 0.12-0.19 ms that a NCCL call cost the host
(``scripts/collective_overhead.py``, §5); the bus rate 450 GB/s, one
direction of the 900 GB/s in all that the H100 SXM data sheet gives NVLink
4: **assumed, not measured** (the machine here has one card). No 4-card
run checks the model yet.

Prints one JSON line for each N in ``N_DEVICES`` (1, 2, 4, 8), also
written to ``--out`` (default ``cuda_recommender_tpu_torch/results/
scaling_model.jsonl``; none with ``--out ''``); the N = 1 line equals its
anchor. Nothing runs on a device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from .run_trajectories import OUT_DIR

OUT = os.path.join(OUT_DIR, "scaling_model.jsonl")
N_DEVICES = (1, 2, 4, 8)


@dataclasses.dataclass(frozen=True)
class Terms:
    """The model's inputs, each with its source."""

    m: int = 480_189            # the headline's users (bench.py)
    n: int = 17_770             # its items
    nnz: int = 100_000_000      # its ratings
    k: int = 40
    inner: int = 1
    #: one device's s/iter at the headline (PERF.md §6: the smoke's phase
    #: 4; H100 80GB HBM3, 700.00 W)
    s_iter: float = 0.6179
    #: shares of s_iter that split by rows: K1 + K2 (63.9% + 30.7% of busy)
    #: and the ELL tail (4.8%), the headline's profile (PERF.md §5)
    panel_share: float = 0.946
    tail_share: float = 0.048
    #: host cost of one NCCL call (scripts/collective_overhead.py, PERF.md
    #: §5: 0.12-0.19 ms; the top)
    call_s: float = 0.19e-3
    #: all-reduce bus rate a card, bytes/s: NVLink 4, 900 GB/s in all per
    #: H100 SXM (data sheet), one direction; assumed, not measured
    bus_bytes_s: float = 450e9
    bus_source: str = ("assumed, not measured: one card here; NVLink 4's "
                       "900 GB/s in all per H100 SXM (data sheet), one "
                       "direction")


def roofline_shares(k: int, panel_cells: float, bytes_per_cell: float,
                    hbm_bytes_s: float, tail_nnz: float, tail_pad: float,
                    gather_s_per_row: float) -> tuple[float, float]:
    """(panel share, tail share) from roofline terms, the JAX model's way:
    k · cells · bytes / rate against k · 2 · tail nnz · pad · s a row."""
    panel = k * panel_cells * bytes_per_cell / hbm_bytes_s
    tail = k * 2 * tail_nnz * tail_pad * gather_s_per_row
    return panel / (panel + tail), tail / (panel + tail)


def calls_per_iter(t: Terms) -> int:
    """All-reduces an outer iteration: one a half-sweep, 2·k·T."""
    return 2 * t.k * t.inner


def payload_bytes(t: Terms) -> int:
    """Bytes a rank passes to ``all_reduce_pair`` an outer iteration:
    (g, h) in f32 over the n items and over the m users, k·T times."""
    return t.k * t.inner * 2 * 4 * (t.m + t.n)


def model(n_dev: int, t: Terms = Terms()) -> dict:
    """The model's line at ``n_dev`` ranks."""
    split = t.panel_share + t.tail_share
    compute_s = t.s_iter * ((1.0 - split) + split / n_dev)
    if n_dev == 1:
        compute_s, comm_s, ring = t.s_iter, 0.0, 0.0
    else:
        ring = 2 * (n_dev - 1) / n_dev * payload_bytes(t)
        comm_s = ring / t.bus_bytes_s + calls_per_iter(t) * t.call_s
    iter_s = compute_s + comm_s
    if n_dev > 1:
        # comm allowed at 80%: iter_s = s_iter / N / 0.8
        budget = t.s_iter / n_dev / 0.8 - compute_s \
            - calls_per_iter(t) * t.call_s
        breakeven = ring / budget / 1e9 if budget > 0 else None
    else:
        breakeven = 0.0
    return {"n_devices": n_dev, "iter_s": iter_s, "compute_s": compute_s,
            "comm_s": comm_s, "ring_bytes_per_iter": ring,
            "allreduce_calls_per_iter": calls_per_iter(t) if n_dev > 1
            else 0,
            "updates_per_s_M": t.nnz * t.k / iter_s / 1e6,
            "efficiency_vs_1_device": t.s_iter / n_dev / iter_s,
            "breakeven_bus_GB_s_for_80pct": breakeven}


def main(argv=None) -> int:
    d = Terms()
    p = argparse.ArgumentParser(
        prog="cuda_recommender_tpu_torch.scripts.scaling_model",
        description="the sharded hybrid's s/iter on N cards, modelled")
    p.add_argument("--s-iter", type=float, default=d.s_iter)
    p.add_argument("--panel-share", type=float, default=d.panel_share)
    p.add_argument("--tail-share", type=float, default=d.tail_share)
    p.add_argument("--call-ms", type=float, default=d.call_s * 1e3)
    p.add_argument("--bus-gb-s", type=float, default=d.bus_bytes_s / 1e9)
    p.add_argument("--out", default=OUT,
                   help="JSONL file of the lines ('' for none)")
    args = p.parse_args(argv)
    t = dataclasses.replace(d, s_iter=args.s_iter,
                            panel_share=args.panel_share,
                            tail_share=args.tail_share,
                            call_s=args.call_ms / 1e3,
                            bus_bytes_s=args.bus_gb_s * 1e9)
    if t.bus_bytes_s != d.bus_bytes_s:
        t = dataclasses.replace(t, bus_source="--bus-gb-s")
    lines = []
    for n_dev in N_DEVICES:
        line = dict(model(n_dev, t), terms=dataclasses.asdict(t),
                    payload_bytes_per_iter=payload_bytes(t))
        lines.append(line)
        print(json.dumps(line), flush=True)
    if lines[0]["iter_s"] != t.s_iter:
        raise AssertionError(f"N = 1: {lines[0]['iter_s']} s, anchor "
                             f"{t.s_iter}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
