"""The fp8 training runs of ``chip_smoke.py``'s phases 43-44 for one
checkout of the port, so that two commits are timed in turns on one card.

    python cuda_recommender_tpu_torch/scripts/fp8_runs.py [--root DIR]
        [--iters N]

Runs, through ``train()`` and the checkout's own ``chip_smoke._fp8_run``
(launch counts, RMSE finite and falling), ``--iters`` outer iterations
(default 3) of: the headline (Netflix-100M dims, k = 40, hand stair under
6.5e9 cells) at an fp8 residual with int8 masks (K4 delta-first,
``masked_usweep``) and with NaN panels and the panel kernels (K1 once,
K2); the dense quick start at fp8 (ml10M dims, k = 10: K4 delta-first,
``masked_usweep``); and the NaN hybrid without the panel kernel at fp8, -T
2 (K1 delta-first, K3, K2). ``--root`` imports the package and
``chip_smoke.py`` from another checkout (an unpacked copy of another
commit; default: the checkout that holds this file); run each checkout in
a fresh process, in turns (A, B, B, A). Prints one JSON line: each run's
s/iter (the mean of iterations 2..), RMSE an iteration and peak device
memory, with the card. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))


def runs(cs, iters: int) -> dict:
    """The four runs through ``chip_smoke`` module ``cs``: name ->
    {s_iter, rmse, peak}."""
    import torch

    from cuda_recommender_tpu_torch import Config
    from cuda_recommender_tpu_torch.data.datasets import synthetic_cached

    dev = torch.device("cuda")
    h, d = cs.HEADLINE, cs.DENSE_HEADLINE
    fp8 = dict(residual_dtype="float8_e4m3fn", maxiter=iters)
    headline = dict(k=h["k"], lambda_=h["lam"], backend="hybrid",
                    hybrid_dense_cells=h["budget"],
                    hybrid_panel_widths=h["widths"], **fp8)
    ml10m = dict(k=d["k"], lambda_=d["lam"], **fp8)
    per, k = h["k"] * iters, d["k"]
    plan = (
        ((h["m"], h["n"], h["nnz"], 0.02), {
            "headline_int8": (
                Config(mask_dtype="int8", **headline),
                ("fused_update_vsweep_fp8_delta_first", "masked_usweep_fp8"),
                (per, per)),
            "headline_nan_kernel": (
                Config(mask_dtype="nan", hybrid_panel_kernel=True,
                       **headline),
                ("panel_update_vsweep_fp8", "panel_usweep_fp8"),
                (per, per))}),
        ((d["m"], d["n"], d["nnz"], None), {
            "dense": (
                Config(**ml10m),
                ("fused_update_vsweep_fp8_delta_first", "masked_usweep_fp8"),
                (k * iters, k * iters)),
            "hybrid_nan": (
                Config(backend="hybrid", mask_dtype="nan", maxinneriter=2,
                       hybrid_dense_cells=cs.RESUME_HYBRID[
                           "hybrid_dense_cells"],
                       hybrid_panel_widths=h["widths"], **ml10m),
                ("panel_update_vsweep_fp8_delta_first", "panel_vsweep_fp8",
                 "panel_usweep_fp8"),
                (k * iters, k * iters, 2 * k * iters))}))
    out = {}
    for (m, n, nnz, test), configs in plan:
        kw = {} if test is None else {"test_fraction": test}
        R, T = synthetic_cached(m, n, nnz, seed=1, **kw)
        for name, (cfg, kernels, counts) in configs.items():
            rec = cs._fp8_run(
                name, dev, R, T, cfg,
                lambda P, ks=kernels, cs_=counts: cs._fp8_want(
                    ks, tuple(c * P for c in cs_)), None)
            out[name] = {key: rec[key] for key in ("s_iter", "rmse", "peak")}
        del R, T
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fp8_runs.py",
                                description=__doc__.split("\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(_HERE)),
                   help="the checkout to import the package and "
                        "chip_smoke.py from")
    p.add_argument("--iters", type=int, default=3)
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from cuda_recommender_tpu_torch.scripts.common import card

    for mod in (cs, sys.modules["cuda_recommender_tpu_torch"]):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise RuntimeError(f"{mod.__name__} came from {mod.__file__}, "
                               f"not from {root}: run each checkout in a "
                               "fresh process")
    if not torch.cuda.is_available():
        print("fp8_runs: no CUDA device", file=sys.stderr)
        return 2
    out = {"root": root, "device": card(torch.device("cuda")),
           "iters": args.iters, "runs": runs(cs, args.iters)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
