"""The reference grid (the port of ``scripts/sweep.sh``, after the
reference's ``scripts/times.sh:5-66``): CCD++ over k x T, then ALS over the
same k, 3 repeats, one dataset a call, every record appended to one JSONL
file.

    python -m cuda_recommender_tpu_torch.scripts.sweep [DATASET] [OUT] \\
        [--vary-seed] [--solvers ccd,als] [--ks ...] [--inners ...] \\
        [--iters 10] [--repeats 3] [--compare JAX_RECORD ...] \\
        [--device cuda]

DATASET is a synthetic spec (default the ml10M dims,
``synthetic:m=69878,n=10677,nnz=10000000``) or a converted dataset
directory; OUT defaults to ``cuda_recommender_tpu_torch/results/
sweep.jsonl``. The grid is ``cli/bench.py::main`` called once a solver, as
``sweep.sh:20-28`` calls the JAX package's: CCD++ at k in
{1,5,10,15,20,25,30,40,50} x T in {1,3,5,7}, ALS at the same k, λ = 0.1,
10 outer iterations, 3 repeats. Each record is ``cli/bench.py``'s with the
dataset spec and ``card`` (the card's name and power limit, ``scripts/
common.py::card``) added.

The factor-init seed is fixed across repeats (0), so the repeats of a
cell must agree bit for bit; ``--vary-seed`` sets seed =
repeat, as the JAX package's ``r2`` records ran
(``results/jester_seed_gap_r5.json``, ``harness_fix``).

``--compare FILE`` holds every cell against a JAX record of the same
(solver, k, inner, repeat, seed) (``compare``): ``final_rmse`` within
``BARS`` (f32 CCD++ 1e-3, ALS 1e-2); a miss exits 1. ``--device cpu``
runs the grid on the CPU (the kernels' plain versions; ``iter_s`` is the
host's and says nothing of the card).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from ..cli import bench as cli_bench
from ..core.device import resolve_device
from .common import card
from .run_trajectories import JAX_RECORDS, OUT_DIR

#: sweep.sh's grid (times.sh:5-66)
DATASET = "synthetic:m=69878,n=10677,nnz=10000000"
KS = "1,5,10,15,20,25,30,40,50"
INNERS = "1,3,5,7"
LAM, ITERS, REPEATS = 0.1, 10, 3
OUT = os.path.join(OUT_DIR, "sweep.jsonl")
#: |final_rmse - the JAX record's| allowed a cell: f32 CCD++ at the port's
#: "Run" bar (ROADMAP.md), ALS at the JAX package's f32 ALS trajectory bar
BARS = {"ccd": 1e-3, "als": 1e-2}
#: the JAX package's records of this grid (ml10M dims; ml20M dims, ALS)
JAX_SWEEPS = {"ml10m": os.path.join(JAX_RECORDS, "sweep_ml10m_r2.jsonl"),
              "ml20m_als": os.path.join(JAX_RECORDS,
                                        "sweep_ml20m_als_r2.jsonl")}


def _argv(dataset, solver, ks, inners, iters, repeats, vary_seed, out,
          device) -> list:
    """``cli/bench.py``'s argv for one solver; ``--device`` comes last."""
    argv = ["--dataset", dataset, "--solvers", solver, "--ks", ks,
            "--lambda", str(LAM), "--iters", str(iters), "--repeats",
            str(repeats), "--seed", "0", "-o", out]
    if solver == "ccd":
        argv += ["--inners", inners]
    return argv + (["--vary-seed"] if vary_seed else []) + ["--device",
                                                             device]


def run(dataset: str = DATASET, out: str | None = OUT, *,
        solvers: str = "ccd,als", ks: str = KS, inners: str = INNERS,
        iters: int = ITERS, repeats: int = REPEATS, vary_seed: bool = False,
        device="cuda") -> list:
    """The grid on ``dataset``: ``cli/bench.py::main`` once a solver (CCD++
    over ``ks`` x ``inners``, ALS over ``ks``); returns the records, each
    also appended to ``out`` (none with ``out`` None or '')."""
    dev = resolve_device(device)
    where = card(dev)
    recs = []
    with tempfile.TemporaryDirectory() as tmp:
        for solver in solvers.split(","):
            part = os.path.join(tmp, f"{solver}.jsonl")
            rc = cli_bench.main(_argv(dataset, solver, ks, inners, iters,
                                      repeats, vary_seed, part, str(dev)))
            if rc != 0:
                raise RuntimeError(f"cli/bench.py exited {rc} ({solver})")
            with open(part) as f:
                recs += [dict(json.loads(line), dataset=dataset, card=where)
                         for line in f]
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "a") as f:
            for rec in recs:
                f.write(json.dumps(rec) + "\n")
    return recs


def _key(rec: dict) -> tuple:
    """(solver, k, inner, repeat, seed) of a record; the JAX ``r2``
    records carry no seed and ran at seed = repeat."""
    return (rec["solver"], rec["k"], rec["inner"], rec["repeat"],
            rec.get("seed", rec["repeat"]))


def repeat_mismatches(recs: list) -> list:
    """The cells whose repeats at one seed did not end at the same
    ``final_rmse`` bit for bit (a fixed seed must repeat)."""
    by: dict = {}
    for rec in recs:
        by.setdefault((rec["solver"], rec["k"], rec["inner"], rec["seed"]),
                      set()).add(rec["final_rmse"])
    return [f"{solver} k={k} T={inner} seed={seed}: final_rmse {sorted(v)}"
            for (solver, k, inner, seed), v in sorted(by.items())
            if len(v) > 1]


def compare(recs: list, jax_recs: list) -> tuple[list, list]:
    """Every JAX record's cell against the run's cell of the same
    (solver, k, inner, repeat, seed): (misses, pairs). A miss is a JAX cell
    the run lacks, a cell run at another λ or iteration count, or a
    ``final_rmse`` off by more than ``BARS``. The JAX records hold five
    decimals, so a difference is read to the ninth. Cells of the run that
    the JAX record lacks are not compared."""
    got = {_key(rec): rec for rec in recs}
    misses, pairs = [], []
    for want in jax_recs:
        key = _key(want)
        solver, k, inner, rep, seed = key
        what = f"{solver} k={k} T={inner} repeat={rep} seed={seed}"
        rec = got.get(key)
        if rec is None:
            misses.append(f"{what}: no run")
            continue
        if (rec["lambda"], rec["iters"]) != (want["lambda"], want["iters"]):
            misses.append(f"{what}: λ {rec['lambda']}, {rec['iters']} "
                          f"iterations; the JAX record's λ {want['lambda']}, "
                          f"{want['iters']}")
            continue
        diff = round(abs(rec["final_rmse"] - want["final_rmse"]), 9)
        pairs.append({"cell": what, "final_rmse": rec["final_rmse"],
                      "final_rmse_jax": want["final_rmse"], "diff": diff})
        if diff > BARS[solver]:
            misses.append(f"{what}: |final_rmse - JAX| {diff} (bar "
                          f"{BARS[solver]})")
    return misses, pairs


def read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="cuda_recommender_tpu_torch.scripts.sweep",
        description="the reference's times.sh grid through cli/bench.py")
    p.add_argument("dataset", nargs="?", default=DATASET)
    p.add_argument("out", nargs="?", default=OUT,
                   help="JSONL file the records are appended to ('' for "
                        "none)")
    p.add_argument("--solvers", default="ccd,als")
    p.add_argument("--ks", default=KS)
    p.add_argument("--inners", default=INNERS)
    p.add_argument("--iters", type=int, default=ITERS)
    p.add_argument("--repeats", type=int, default=REPEATS)
    p.add_argument("--vary-seed", action="store_true",
                   help="seed = repeat (the JAX r2 records' setting)")
    p.add_argument("--compare", action="append", default=[],
                   metavar="JAX_RECORD",
                   help="a JAX record (JSONL) every cell of it is held to")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"sweep: {e}; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    recs = run(args.dataset, args.out, solvers=args.solvers, ks=args.ks,
               inners=args.inners, iters=args.iters, repeats=args.repeats,
               vary_seed=args.vary_seed, device=args.device)
    misses = [] if args.vary_seed else repeat_mismatches(recs)
    for path in args.compare:
        got, pairs = compare(recs, read_jsonl(path))
        for pair in pairs:
            print(f"[compare] {pair['cell']}: {pair['final_rmse']:.6f} "
                  f"JAX {pair['final_rmse_jax']:.5f} |diff| "
                  f"{pair['diff']:.6f}", flush=True)
        print(f"[compare] {os.path.basename(path)}: {len(pairs)} cells, "
              f"max |diff| {max((q['diff'] for q in pairs), default=None)}, "
              f"{len(got)} misses", flush=True)
        misses += got
    for miss in misses:
        print(f"MISS {miss}", flush=True)
    return 1 if misses else 0


if __name__ == "__main__":
    sys.exit(main())
