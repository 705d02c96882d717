"""The host set-up of a training run, split into its steps, with the native
C++ helpers (cuda_recommender_tpu_torch/native) against their NumPy paths.

    python -m cuda_recommender_tpu_torch.scripts.host_setup [--turns 2]

At the bench headline's data (``synthetic_cached(480189, 17770,
100_000_000, seed=1, test_fraction=0.02)``, generated once into the temp
directory when it is not cached; that generation is reported, not compared)
each turn runs the steps once on each path, NumPy first in even turns and
native first in odd ones (NumPy, native, native, NumPy for two turns):

* ``data``: ``synthetic_cached`` from the cache: the npz read, the CSR+CSC
  build (``from_coo``) and the test set;
* ``from_coo``: the CSR+CSC build alone, from the matrix's COO;
* ``plan``: ``ccd_hybrid.plan_oriented`` at the headline with
  ``hybrid_transpose="auto"`` (both orientations planned, as the bench's
  ``--transpose auto`` plans them);
* ``ell``: ``build_ell_pair`` over the whole matrix at the ALS and
  pure-ELL floor ("auto"), as ALS and the ell backend build it.

Every output of every run is held byte-equal to the first run's, and each
run's ``native.path_counts()`` must show its own path (the native run takes
NumPy for groupsort's calls below its size threshold). Host seconds:
the time of the machine's CPU, which is shared; a line per step and run,
then one JSON summary as the last line. No device is used.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

from .. import native
from ..core.config import Config
from ..data.datasets import synthetic_cached
from ..data.ell import build_ell_pair
from ..data.sparse import from_coo
from ..solvers.ccd_hybrid import plan_oriented

#: the bench headline's data (bench.py's defaults)
HEADLINE = dict(m=480_189, n=17_770, nnz=100_000_000, seed=1)
STEPS = ("data", "from_coo", "plan", "ell")


def same(a, b, path="x") -> None:
    """Raise AssertionError unless ``a`` and ``b`` are equal: arrays in
    dtype and bytes, dataclasses, sequences and dicts item by item."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        if a.dtype != b.dtype or a.shape != b.shape or \
                a.tobytes() != b.tobytes():
            raise AssertionError(f"{path} differs between the paths")
    elif isinstance(a, (tuple, list)):
        if len(a) != len(b):
            raise AssertionError(f"{path} differs in length")
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        if a.keys() != b.keys():
            raise AssertionError(f"{path} differs in keys")
        for key in a:
            same(a[key], b[key], f"{path}[{key!r}]")
    elif a != b:
        raise AssertionError(f"{path}: {a!r} != {b!r}")


def run_steps(m: int, n: int, nnz: int, seed: int, cfg: Config) -> tuple:
    """The four steps once on the current path: (seconds by step, outputs
    by step)."""
    secs, outs = {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        outs[name] = fn()
        secs[name] = time.perf_counter() - t0
        return outs[name]

    R, T = timed("data", lambda: synthetic_cached(m, n, nnz, seed=seed,
                                                  test_fraction=0.02))
    coo = R.to_coo()
    timed("from_coo", lambda: from_coo(m, n, *coo))
    timed("plan", lambda: plan_oriented(R, cfg))
    timed("ell", lambda: build_ell_pair(R, min_width=cfg.als_min_width))
    return secs, outs


def run(m: int, n: int, nnz: int, seed: int, turns: int = 2) -> dict:
    """The split of ``turns`` turns; raises AssertionError when a run's
    outputs differ from the first run's or a run took the other path."""
    cfg = Config(k=40, backend="hybrid", residual_dtype="bfloat16",
                 mask_dtype="nan", hybrid_panel_kernel=True,
                 hybrid_dense_cells=6_500_000_000,
                 hybrid_panel_widths=(4096, 2048), hybrid_transpose="auto")
    if not native.available():
        raise RuntimeError("the native helpers do not build here (g++ with "
                           "OpenMP is needed)")
    t0 = time.perf_counter()
    synthetic_cached(m, n, nnz, seed=seed, test_fraction=0.02)
    warm_s = time.perf_counter() - t0
    print(f"[host] data {m} x {n}, nnz {nnz}, seed {seed}: cached or "
          f"generated in {warm_s:.3f} s", flush=True)
    times = {"numpy": {s: [] for s in STEPS}, "native": {s: [] for s in STEPS}}
    ref = None
    for t in range(turns):
        for path in (("numpy", "native") if t % 2 == 0
                     else ("native", "numpy")):
            native.reset_path_counts()
            if path == "numpy":
                with native.numpy_only():
                    secs, outs = run_steps(m, n, nnz, seed, cfg)
            else:
                secs, outs = run_steps(m, n, nnz, seed, cfg)
            counts = native.path_counts()
            for helper in ("groupsort", "ellfill"):
                # the NumPy run takes no native call; the native run takes
                # NumPy only for calls below groupsort's size threshold
                if counts[helper][path] <= 0 or (
                        path == "numpy" and counts[helper]["native"]):
                    raise AssertionError(f"{path} run: {helper} paths "
                                         f"{counts[helper]}")
            if ref is None:
                ref = outs
            else:
                same(outs, ref, "outputs")
            del outs
            for step, s in secs.items():
                times[path][step].append(s)
            print(f"[host] turn {t} {path}: " + ", ".join(
                f"{step} {s:.3f} s" for step, s in secs.items())
                + f"; paths {counts}", flush=True)
    med = {path: {step: statistics.median(v) for step, v in by.items()}
           for path, by in times.items()}
    return {"data": f"synthetic_cached({m}, {n}, {nnz}, seed={seed}, "
                    "test_fraction=0.02)",
            "turns": turns, "cache_or_generate_s": warm_s, "seconds": times,
            "median_s": med,
            "numpy_over_native": {step: med["numpy"][step]
                                  / med["native"][step] for step in STEPS},
            "outputs_equal": True, "host_cpus": os.cpu_count()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="cuda_recommender_tpu_torch.scripts.host_setup",
        description="host set-up split, native helpers against NumPy")
    p.add_argument("--turns", type=int, default=2)
    for key, val in HEADLINE.items():
        p.add_argument(f"--{key}", type=int, default=val)
    args = p.parse_args(argv)
    out = run(args.m, args.n, args.nnz, args.seed, args.turns)
    # the machine these host seconds come from (its card, where it has one)
    out["card"] = (subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip() if shutil.which("nvidia-smi") else None)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
