"""Gather probe (the port of ``scripts/probe_vmem_gather.py``): the three
gather forms as hand kernels, each against its plain version and its one
PyTorch call.

    python -m cuda_recommender_tpu_torch.scripts.probe_gather \\
        [--tail LANES:ROWS:WIDTH ...]

Over an f32 table ``tab`` (S, 128) and an int32 index tile ``idx``
(rows, 128), drawn on the device from a seed:

  A  out[r, l] = tab[idx[r, l], l]      against torch.gather(tab, 0, idx)
  B  out[r, l] = tab.flatten()[idx[r, l]]  against torch.take(tab, idx)
  C  out[r, :] = tab[idx[r, 0], :]      against tab.index_select(0, idx[:, 0])

(the library calls take an int64 copy of the index, made before timing).
Forms A and B take the shared-memory path where the table fits in a
block's opt-in shared memory (the rows tail's 417 x 128 table), else the
L2 path (``ops/probe_kernels.py::gather_plan``; each record names the
path). The index tiles are cycled through copies of 128 MB in all, so that
they come from device memory as the tail's do. Each call's device time is
below the host's cost of issuing it, so REPS calls are captured in a CUDA
graph and timed by its replay.
First at the probe's shapes (S = 8192, a 4 MB table; 4096 index rows),
then at each ``--tail`` shape: an ELL tail side that gathers LANES padded
lanes from a table of ROWS entities x WIDTH floats becomes ceil(LANES /
128) index rows over a table of the same bytes (ceil(ROWS * WIDTH / 128)
rows of 128). Each form's output must equal its plain version's bit for
bit: a form that fails fails the run (nothing is caught). Prints one JSON
line per shape.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..core.device import resolve_device
from ..ops import probe_kernels as pr
from .common import card, cold_copies, cycling, time_ms

L = 128
PROBE_SHAPE = (8192, 4096)        # table rows S, index rows
FORMS = ("A", "B", "C")
#: calls captured in the timing graph
REPS = 100


def tail_shape(lanes: int, rows: int, width: int) -> tuple[int, int]:
    """(table rows, index rows) of the probe for an ELL tail side that
    gathers ``lanes`` lanes from a ``rows`` x ``width`` f32 table."""
    return -(-rows * width // L), -(-lanes // L)


def probe_inputs(S: int, n_rows: int, device, seed: int = 0):
    """The table and the per-form index tiles (A and C: rows of the table;
    B: flat positions)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tab = torch.randn((S, L), generator=gen, device=device)
    rows = torch.randint(0, S, (n_rows, L), generator=gen, device=device,
                         dtype=torch.int32)
    flat = torch.randint(0, S * L, (n_rows, L), generator=gen, device=device,
                         dtype=torch.int32)
    return tab, {"A": rows, "B": flat, "C": rows}


def library_call(tab, idx64, form):
    """The one PyTorch call that computes form ``form`` (timed beside the
    kernel, never used by the port)."""
    if form == "A":
        return lambda: torch.gather(tab, 0, idx64)
    if form == "B":
        return lambda: torch.take(tab, idx64)
    col = idx64[:, 0].contiguous()
    return lambda: tab.index_select(0, col)


def gather_probe(S: int, n_rows: int, device, *, seed: int = 0,
                 library: bool = True) -> dict:
    """Each form at (S, n_rows): checked bit-equal to its plain version
    (AssertionError otherwise), then timed by a graph replay with the index
    cold; with ``library`` its PyTorch call too. Returns {"table_rows",
    "index_rows", "elements", form: {"ms", "ns_per_element",
    "library_ms", "path" ("smem" or "l2"; form C: "l2")}}."""
    tab, idx = probe_inputs(S, n_rows, device, seed)
    n = n_rows * L
    out = {"table_rows": S, "index_rows": n_rows, "elements": n}
    path = pr.gather_plan(S, L, n, pr.gather_limits(tab.device)[0])["path"]
    for form in FORMS:
        got = pr.gather(tab, idx[form], form)
        want = pr.gather_plain(tab, idx[form], form)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            raise AssertionError(f"gather form {form} at S={S}, rows="
                                 f"{n_rows}: {bad} of {n} entries differ "
                                 "from the plain version")
        del got, want
        copies = cold_copies(idx[form])
        ms = time_ms(cycling([
            (lambda ix=ix: pr.gather(tab, ix, form)) for ix in copies]),
            device, REPS, graph=True)
        lib = None
        if library:
            copies = cold_copies(idx[form].to(torch.int64))
            lib = time_ms(cycling([library_call(tab, ix, form)
                                   for ix in copies]), device, REPS,
                          graph=True)
        del copies
        out[form] = {"ms": ms, "library_ms": lib,
                     "ns_per_element": None if ms is None else ms * 1e6 / n,
                     "path": "l2" if form == "C" else path}
    return out


def _tail(text: str) -> tuple[int, int, int]:
    lanes, rows, width = (int(x) for x in text.split(":"))
    return lanes, rows, width


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="cuda_recommender_tpu_torch.scripts.probe_gather",
        description="gather forms A, B, C against their PyTorch calls")
    p.add_argument("--tail", action="append", default=[], type=_tail,
                   metavar="LANES:ROWS:WIDTH",
                   help="an ELL tail side: its padded lanes and the table "
                        "it gathers from (entities x floats); repeatable")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    cases = [("probe", PROBE_SHAPE)] + [
        (f"tail {lanes}:{rows}:{width}", tail_shape(lanes, rows, width))
        for lanes, rows, width in args.tail]
    for name, (S, n_rows) in cases:
        rec = gather_probe(S, n_rows, dev)
        print(json.dumps({"case": name, **rec}), flush=True)
    print(json.dumps({"device": card(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
