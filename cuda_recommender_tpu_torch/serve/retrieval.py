"""MIPS top-k candidate retrieval over the item factor table.

The port of ``cuda_recommender_tpu/serve/retrieval.py`` (the north-star
serving path, BASELINE.json): given trained factors, retrieve the top-k
maximum-inner-product items per query user. The item table streams in
chunks of ``chunk`` items: per chunk one f32 ``(B, k) x (k, C)`` product,
then one ``torch.topk`` over the running ``(B, topk)`` state beside the
chunk's scores, so the full ``(B, n)`` score matrix never exists on the
device.

Against the JAX package: the last chunk is simply short, so the table
needs no pad rows and the device top-k no over-fetch beyond the host's
exclusions (``min(topk + excluded, n)`` wide). ``torch.topk`` orders tied
scores in no promised way, where ``lax.top_k`` puts the lower index first;
ids agree wherever scores differ. Sharded serving over the ranks of a
mesh is ``serve/retrieval_sharded.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from .scoring import as_entity_major

#: the score of a running-state slot that no item has filled yet
NEG = -3.4e38


def _merge_topk(best_s: torch.Tensor, best_i: torch.Tensor, s: torch.Tensor,
                base: int, topk: int, approx: bool):
    """Merge one chunk's scores ``s`` (B, C), items ``base .. base + C``,
    into the running (B, topk) state.

    ``approx`` first reduces the chunk to its own top-``topk`` (where that
    is at most half the chunk) and merges only (B, 2·topk). The JAX package
    reduces there with ``lax.approx_max_k``; PyTorch has no approximate
    top-k, so the reduction here is an exact ``torch.topk`` and the result
    equals the exact merge's."""
    if approx and topk <= s.shape[1] // 2:
        s, pos = torch.topk(s, topk, dim=1)
        ids = (pos + base).to(torch.int32)
    else:
        ids = torch.arange(base, base + s.shape[1], device=s.device,
                           dtype=torch.int32).expand(s.shape[0], -1)
    cand_s = torch.cat([best_s, s], dim=1)
    cand_i = torch.cat([best_i, ids], dim=1)
    top_s, pos = torch.topk(cand_s, topk, dim=1)
    return top_s, torch.gather(cand_i, 1, pos)


def _stream_topk(U: torch.Tensor, n: int, scores_of, *, topk: int,
                 chunk: int, approx: bool):
    B = U.shape[0]
    best_s = torch.full((B, topk), NEG, dtype=torch.float32, device=U.device)
    best_i = torch.full((B, topk), -1, dtype=torch.int32, device=U.device)
    for base in range(0, n, chunk):
        s = scores_of(base, min(base + chunk, n))
        best_s, best_i = _merge_topk(best_s, best_i, s, base, topk, approx)
    return best_s, best_i


def topk_mips_device(U: torch.Tensor, H_em: torch.Tensor, *, topk: int,
                     chunk: int, approx: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores f32, item ids int32) of the top-``topk`` inner products per
    query row, on U's device.

    U (B, k) query factors; H_em (n, k) item table, any n (the last chunk is
    short). Slots that no item fills (``topk`` > n) hold NEG and -1.
    ``approx=True`` reduces each chunk before the merge (exact here, see
    _merge_topk)."""
    return _stream_topk(
        U, H_em.shape[0], lambda lo, hi: U @ H_em[lo:hi].T, topk=topk,
        chunk=chunk, approx=approx)


def quantize_item_table(H_em: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-item int8 quantization of the item factor table.

    Returns (Hq int8 (n, k), scale f32 (n,)) with
    H[j] ≈ Hq[j] * scale[j]."""
    H_em = np.asarray(H_em, np.float32)
    amax = np.abs(H_em).max(axis=1)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    Hq = np.clip(np.rint(H_em / scale[:, None]), -127, 127).astype(np.int8)
    return Hq, scale


def topk_mips_device_int8(U: torch.Tensor, Hq: torch.Tensor,
                          scale: torch.Tensor, *, topk: int, chunk: int,
                          approx: bool = False
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming top-k over an int8-quantized item table: the merge of
    topk_mips_device, with each chunk's int8 rows cast to f32, multiplied,
    and the product scaled per item (in that order, as the JAX package
    does)."""
    return _stream_topk(
        U, Hq.shape[0],
        lambda lo, hi: (U @ Hq[lo:hi].to(torch.float32).T) * scale[lo:hi],
        topk=topk, chunk=chunk, approx=approx)


def _postprocess(s: np.ndarray, i: np.ndarray, topk: int, user_ids,
                 exclude) -> tuple[np.ndarray, np.ndarray]:
    """Apply per-user exclusions on the over-fetched candidate set
    (host-side, keeping the device pass dense); int32 ids and f32 scores,
    -1 and -inf where nothing is left."""
    out_s = np.full((len(user_ids), topk), -np.inf, np.float32)
    out_i = np.full((len(user_ids), topk), -1, np.int32)
    for b, uid in enumerate(np.asarray(user_ids)):
        cand, cs = i[b], s[b]
        if exclude and int(uid) in exclude:
            keep = ~np.isin(cand, exclude[int(uid)])
            cand, cs = cand[keep], cs[keep]
        take = min(topk, cand.shape[0])
        out_i[b, :take] = cand[:take]
        out_s[b, :take] = cs[:take]
    return out_s, out_i


def topk_mips(W, H, user_ids, *, topk: int = 10, chunk: int = 2048,
              entity_major: bool = True,
              exclude: dict[int, np.ndarray] | None = None,
              int8: bool = False, approx: bool = False,
              device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Host API: top-k item retrieval for a batch of users on ``device``.

    ``exclude`` optionally maps user id -> item ids to mask out (e.g. train
    interactions when evaluating recall on held-out items). Masking happens
    host-side on an over-fetched candidate set (topk + max excluded),
    keeping the device pass dense and branch-free. ``int8=True`` quantizes
    the item table per item (quantize_item_table) and runs the int8
    streaming pass; callers that serve many batches quantize once and call
    topk_mips_device_int8 directly.
    """
    dev = resolve_device(device)
    W_em, H_em = as_entity_major(W, H, entity_major)
    n = H_em.shape[0]
    extra = max((len(v) for v in exclude.values()), default=0) if exclude else 0
    fetch = min(n, topk + extra)
    U = torch.from_numpy(W_em[np.asarray(user_ids, np.int64)]).to(dev)
    if int8:
        Hq, scale = quantize_item_table(H_em)
        s, i = topk_mips_device_int8(U, torch.from_numpy(Hq).to(dev),
                                     torch.from_numpy(scale).to(dev),
                                     topk=fetch, chunk=chunk, approx=approx)
    else:
        s, i = topk_mips_device(U, torch.from_numpy(H_em).to(dev),
                                topk=fetch, chunk=chunk, approx=approx)
    return _postprocess(s.cpu().numpy(), i.cpu().numpy(), topk, user_ids,
                        exclude)
