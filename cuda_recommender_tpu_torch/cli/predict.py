"""Predict/serve CLI.

The port of ``cuda_recommender_tpu/cli/predict.py``: two modes mirroring
and extending the reference's disabled predict path (reference
src/extras.cpp:143-180):

* ``score``: model file + text test file -> per-line predictions + RMSE
  (byte-format parity with calculate_rmse_from_file's output file).
* ``topk``: MIPS top-k retrieval for a list of user ids over the item table.

    python -m cuda_recommender_tpu_torch.cli.predict score model test.txt \\
        -o output [--device cuda]
    python -m cuda_recommender_tpu_torch.cli.predict topk model 0,1,2 \\
        -k 10 [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cuda_recommender_tpu_torch.cli.predict")
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default="cuda",
                     help="torch device: cuda (default) or cpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("score", parents=[dev],
                        help="score a text test file against a model")
    ps.add_argument("model")
    ps.add_argument("test_file")
    ps.add_argument("-o", "--output", default="output")
    ps.add_argument("--rank-major", action="store_true",
                    help="model was saved from CCD rank-major factors "
                         "without transposition")

    pt = sub.add_parser("topk", parents=[dev],
                        help="top-k MIPS retrieval for users")
    pt.add_argument("model")
    pt.add_argument("users", help="comma-separated user ids")
    pt.add_argument("-k", "--topk", type=int, default=10)
    pt.add_argument("--chunk", type=int, default=2048)

    args = p.parse_args(argv)
    if args.cmd == "score":
        from ..serve.scoring import predict_to_file
        predict_to_file(args.model, args.test_file, args.output,
                        entity_major_model=not args.rank_major,
                        device=args.device)
        return 0

    from ..data.binfmt import load_model
    from ..serve.retrieval import topk_mips
    W, H = load_model(args.model, entity_major=True)
    users = np.array([int(u) for u in args.users.split(",")], np.int64)
    scores, items = topk_mips(W, H, users, topk=args.topk, chunk=args.chunk,
                              device=args.device)
    for b, u in enumerate(users):
        pairs = ", ".join(f"{i}:{s:.4f}" for i, s in zip(items[b], scores[b])
                          if i >= 0)
        print(f"user {u}: {pairs}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
