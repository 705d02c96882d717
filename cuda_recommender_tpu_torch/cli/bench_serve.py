"""Serving benchmark: MIPS top-k retrieval QPS + recall@k.

The port of ``cuda_recommender_tpu/cli/bench_serve.py``, the north-star
serving harness (BASELINE.json config #5): train (or load) factors, then
measure streaming top-k retrieval throughput over the item table and
recall@k against held-out interactions. Prints one JSON line.

    python -m cuda_recommender_tpu_torch.cli.bench_serve [--int8] \\
        [--approx] [--latency] [--model PATH] [--random-factors] \\
        [--device cuda]

By default it trains ALS (K5 on the card) at ml10M dims, 5 M ratings,
k=16; ``detail.launches`` counts the hand kernels' launches of the run.
The factor table and the query ids sit on the device before the timed
loop: each batch gathers its query rows there, streams the item table and
merges its top-k; the loop ends in ``synchronize()`` and reads the last
batch back. ``--latency`` serves single queries through
``serve/engine.py::RetrievalEngine``, each read back to the host.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def recall_sample(R, T, threshold: float, users: int = 512) -> tuple:
    """The recall sample: the first ``users`` users with held-out ratings
    >= ``threshold``, those items (relevant) and each user's train items
    (excluded from retrieval)."""
    hi = T.val >= threshold
    sample = np.unique(T.row_idx[hi])[:users]
    relevant = [T.col_idx[hi][T.row_idx[hi] == u] for u in sample]
    exclude = {int(u): R.csr_idx[R.csr_ptr[u]:R.csr_ptr[u + 1]]
               for u in sample}
    return sample, relevant, exclude


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="cuda_recommender_tpu_torch.cli.bench_serve")
    p.add_argument("--model", default=None,
                   help="saved model file; default trains ALS on synthetic")
    p.add_argument("--dataset", default="synthetic:m=69878,n=10677,nnz=5000000")
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--chunk", type=int, default=2048)
    p.add_argument("--queries", type=int, default=8192)
    p.add_argument("--approx", action="store_true",
                   help="reduce each chunk to its top-k before the merge "
                        "(exact in the port: PyTorch has no approximate "
                        "top-k)")
    p.add_argument("--int8", action="store_true",
                   help="int8-quantized item table (4x smaller device "
                        "footprint; per-item scales applied after the "
                        "product)")
    p.add_argument("--rel-threshold", type=float, default=4.0,
                   help="held-out items with rating >= this count as "
                        "relevant (rating-MF retrieves by predicted rating, "
                        "so 'was rated at all' would measure popularity, "
                        "which rating factors do not encode)")
    p.add_argument("--rank", type=int, default=16,
                   help="factor rank when training / generating factors")
    p.add_argument("--random-factors", action="store_true",
                   help="skip training and recall: seeded Gaussian factors, "
                        "pure-QPS mode for large-catalog scaling runs "
                        "(retrieval cost is independent of factor values)")
    p.add_argument("--latency", action="store_true",
                   help="per-query latency mode: serve --queries SEQUENTIAL "
                        "single-user queries through the device-resident "
                        "RetrievalEngine (serve/engine.py), each read back "
                        "to the host; reports p50/p99 ms instead of batch "
                        "QPS")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..core.config import Config
    from ..core.device import resolve_device, synchronize
    from ..core.init import init_factors_np
    from ..data import datasets
    from ..eval.ranking import recall_at_k
    from ..ops.launches import launch_counts
    from ..scripts.common import card
    from ..serve.retrieval import topk_mips, topk_mips_device
    from ..solvers.als_ell import als_ell_train

    dev = resolve_device(args.device)
    R, T = datasets.synthetic_from_spec(args.dataset)

    if args.model:
        from ..data.binfmt import load_model
        W, H = load_model(args.model, entity_major=True)
        if W.shape[0] != R.rows or H.shape[0] != R.cols:
            raise SystemExit(
                f"model dims ({W.shape[0]} users x {H.shape[0]} items) do "
                f"not match --dataset ({R.rows} x {R.cols}); recall@k would "
                f"be meaningless — pass the matching --dataset spec/dir")
    elif args.random_factors:
        rng = np.random.default_rng(0)
        W = rng.standard_normal((R.rows, args.rank)).astype(np.float32)
        H = rng.standard_normal((R.cols, args.rank)).astype(np.float32)
    else:
        W0, H0 = init_factors_np(args.rank, R.rows, R.cols, seed=0,
                                 entity_major=True)
        cfg = Config(solver="als", k=args.rank, maxiter=4, lambda_=0.05,
                     fused_outer_iters=4)
        W, H, _ = als_ell_train(R, W0, H0, T, cfg, device=dev)

    n, k = H.shape

    if args.latency:
        from ..serve.engine import RetrievalEngine
        eng = RetrievalEngine(W, H, int8=args.int8, approx=args.approx,
                              device=dev)
        eng.warmup(topk=args.topk)
        rng = np.random.default_rng(0)
        users = rng.integers(0, W.shape[0], args.queries)
        lat = np.empty(args.queries)
        t_all = time.perf_counter()
        for q, uid in enumerate(users):
            t0 = time.perf_counter()
            eng.query(user=int(uid), topk=args.topk)   # readback = fence
            lat[q] = time.perf_counter() - t0
        wall = time.perf_counter() - t_all
        p50, p99 = np.percentile(lat, [50, 99])
        print(json.dumps({
            "metric": f"mips_top{args.topk}_p50_latency",
            "value": round(float(p50) * 1e3, 3),
            "unit": "ms/query",
            "vs_baseline": 0.0,
            "detail": {"p99_ms": round(float(p99) * 1e3, 3),
                       "mean_ms": round(float(lat.mean()) * 1e3, 3),
                       "sequential_qps": round(args.queries / wall, 1),
                       "queries": args.queries, "items": n, "rank": k,
                       "int8": bool(args.int8), "approx": bool(args.approx),
                       "device": card(dev), "launches": launch_counts(),
                       "note": "sequential single queries, each read back "
                               "to the host"},
        }))
        return 0

    Wd = torch.from_numpy(np.asarray(W, np.float32)).to(dev)
    H32 = np.asarray(H, np.float32)
    if args.int8:
        from ..serve.retrieval import (quantize_item_table,
                                       topk_mips_device_int8)
        Hq, scale = quantize_item_table(H32)
        Hqd = torch.from_numpy(Hq).to(dev)
        scd = torch.from_numpy(scale).to(dev)

        def run_batch(U):
            return topk_mips_device_int8(U, Hqd, scd, topk=args.topk,
                                         chunk=args.chunk,
                                         approx=args.approx)
    else:
        Hd = torch.from_numpy(H32).to(dev)

        def run_batch(U):
            return topk_mips_device(U, Hd, topk=args.topk, chunk=args.chunk,
                                    approx=args.approx)
    rng = np.random.default_rng(0)
    users = rng.integers(0, W.shape[0], args.queries).astype(np.int64)
    # whole batches: the last one is padded with user 0, as the JAX
    # package's loop pads it
    n_pad = (-args.queries) % args.batch
    users_d = torch.from_numpy(np.pad(users, (0, n_pad))).to(dev)

    # one untimed batch: library handles and allocator growth
    s, i = run_batch(Wd[users_d[:args.batch]])
    s.cpu()

    synchronize(dev)
    t0 = time.perf_counter()
    for lo in range(0, users_d.shape[0], args.batch):
        s, i = run_batch(Wd[users_d[lo:lo + args.batch]])
    s.cpu()
    synchronize(dev)
    dt = time.perf_counter() - t0
    qps = args.queries / dt

    if args.random_factors:
        rec = None          # untrained factors — recall would be noise
    else:
        # recall@k on a sample of users, relevance = high-rated held-out items
        sample, relevant, exclude = recall_sample(R, T, args.rel_threshold)
        _, items = topk_mips(W, H, sample, topk=args.topk, chunk=args.chunk,
                             exclude=exclude, int8=args.int8,
                             approx=args.approx, device=dev)
        rec = recall_at_k(items, relevant)

    print(json.dumps({
        "metric": f"mips_top{args.topk}_qps",
        "value": round(qps, 1),
        "unit": "queries/s/chip",
        "vs_baseline": 0.0 if rec is None else round(rec, 4),
        "detail": {"recall_at_k": None if rec is None else round(rec, 4),
                   "topk": args.topk,
                   "items": n, "rank": k, "batch": args.batch,
                   "int8": bool(args.int8), "approx": bool(args.approx),
                   "device": card(dev), "launches": launch_counts(),
                   "note": "vs_baseline field carries recall@k (reference "
                           "has no serving benchmark); factors and query "
                           "ids device-resident before the timed loop"},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
