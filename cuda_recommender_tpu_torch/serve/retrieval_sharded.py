"""MIPS top-k retrieval over an item table sharded across the ranks.

The port of ``cuda_recommender_tpu/serve/retrieval_sharded.py``: the item
factors are padded to N·chunk rows and row-sharded over the ranks of a
1-D mesh; each rank runs the streaming top-k (serve/retrieval.py's
``topk_mips_device``) against its local rows and offsets its ids, and only
the per-rank (B, per_dev_fetch) candidates -- not scores over the catalog
-- are all-gathered and merged on the host. Communication is
O(ranks · B · topk), independent of the catalog's size.

Pad rows are zero vectors (score 0): the candidates come back unranked
across ranks, the host drops pad and excluded ids first and only then
merges with a stable sort, so a pad row never beats a real item with a
negative score. The over-fetch rule is the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.collectives import all_gather_rows
from ..parallel.mesh import ell_shardings
from ..parallel.multihost import rank_device
from .retrieval import (quantize_item_table, topk_mips_device,
                        topk_mips_device_int8)
from .scoring import as_entity_major


def topk_mips_sharded(W, H, user_ids, mesh, *, topk: int = 10,
                      chunk: int = 1024, entity_major: bool = True,
                      exclude: dict[int, np.ndarray] | None = None,
                      int8: bool = False,
                      device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Host API mirroring serve.retrieval.topk_mips on a sharded item
    table; every rank returns the same (scores, ids). ``int8`` quantizes
    the table per item (``quantize_item_table``) before it is sharded."""
    lay = ell_shardings(mesh)
    dev = rank_device(device)
    W_em, H_em = as_entity_major(W, H, entity_major)
    n, k = H_em.shape
    N, s = lay.num_shards, lay.shard
    extra = max((len(v) for v in exclude.values()), default=0) if exclude else 0
    fetch = min(n, topk + extra)
    pad = (-n) % (N * chunk)
    local_n = (n + pad) // N
    rows = slice(s * local_n, (s + 1) * local_n)
    U = torch.from_numpy(np.ascontiguousarray(
        W_em[np.asarray(user_ids, np.int64)], np.float32)).to(dev)
    # over-fetch so pad rows (zero vectors, score 0) cannot crowd out real
    # items, and so host-side exclusion still leaves topk candidates: a
    # rank holds at most min(pad, local_n) pad rows (pad fills the tail)
    per_dev_fetch = min(local_n, fetch + min(pad, local_n))
    if int8:
        Hq, scale = quantize_item_table(H_em)
        Hq = np.pad(Hq, ((0, pad), (0, 0)))[rows]
        scale = np.pad(scale, (0, pad), constant_values=1.0)[rows]
        sc, ids = topk_mips_device_int8(
            U, torch.from_numpy(np.ascontiguousarray(Hq)).to(dev),
            torch.from_numpy(np.ascontiguousarray(scale)).to(dev),
            topk=per_dev_fetch, chunk=chunk)
    else:
        Hl = np.pad(np.asarray(H_em, np.float32), ((0, pad), (0, 0)))[rows]
        sc, ids = topk_mips_device(
            U, torch.from_numpy(np.ascontiguousarray(Hl)).to(dev),
            topk=per_dev_fetch, chunk=chunk)
    ids = ids + s * local_n
    # (N·B, f) gathered -> (B, N·f): each user's candidates of every rank
    B = U.shape[0]
    s_all = all_gather_rows(sc, lay.group).reshape(N, B, -1)
    i_all = all_gather_rows(ids, lay.group).reshape(N, B, -1)
    s_np = s_all.permute(1, 0, 2).reshape(B, -1).cpu().numpy()
    i_np = i_all.permute(1, 0, 2).reshape(B, -1).cpu().numpy()

    valid = i_np < n
    out_s = np.full((len(user_ids), topk), -np.inf, np.float32)
    out_i = np.full((len(user_ids), topk), -1, np.int32)
    for b, uid in enumerate(np.asarray(user_ids)):
        cand, cs = i_np[b][valid[b]], s_np[b][valid[b]]
        if exclude and int(uid) in exclude:
            keep = ~np.isin(cand, exclude[int(uid)])
            cand, cs = cand[keep], cs[keep]
        order = np.argsort(-cs, kind="stable")[:topk]   # merge rank streams
        out_i[b, :len(order)] = cand[order]
        out_s[b, :len(order)] = cs[order]
    return out_s, out_i
