"""Per-query low-latency retrieval engine (device-resident item index).

The port of ``cuda_recommender_tpu/serve/engine.py``. The batch path
(retrieval.topk_mips) is built for throughput: it streams the item table in
chunks, so a (B, n) score matrix never exists. For a single query that
structure is overhead. This engine is the latency path the reference has
no equivalent of (its predict path, src/extras.cpp:143-180, is offline file
scoring only):

  * factor tables go to the device once, at construction, and stay there
    (optionally int8-quantized, retrieval.quantize_item_table);
  * a query is one (n, k) x (k,) matvec and one ``torch.topk`` over the
    full score vector;
  * per-user exclusions (seen-item filtering) run on the host over an
    over-fetched candidate set, keeping the device work branch-free.

Ids match the batch path's wherever scores differ, and scores agree to
rounding: a matvec and the batch path's chunked products need not round
alike. int8 mode uses the int8 batch path's quantization exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device, synchronize
from .retrieval import quantize_item_table
from .scoring import as_entity_major


class RetrievalEngine:
    """Device-resident MIPS index over trained factors.

    Parameters
    ----------
    W, H : factor matrices in either reference layout (``entity_major``
        as in serve.scoring.as_entity_major). W may be ``None`` for a
        vector-only engine (queries must then pass ``u_vec``).
    int8 : quantize the item table per-item (4x smaller device footprint;
        identical quantization to the batch int8 pass).
    approx : accepted for the JAX package's interface, where it selects
        ``lax.approx_max_k``; PyTorch has no approximate top-k, so the
        query's top-k is exact either way.
    device : "cuda" (default; an error without a GPU) or "cpu".
    """

    def __init__(self, W, H, *, entity_major: bool = True,
                 int8: bool = False, approx: bool = False, device="cuda"):
        self.device = resolve_device(device)
        if W is None:
            H_em = np.asarray(H, np.float32)
            H_em = H_em if entity_major else np.ascontiguousarray(H_em.T)
            self._W = None
        else:
            W_em, H_em = as_entity_major(W, H, entity_major)
            self._W = torch.from_numpy(W_em).to(self.device)
        self.n_items, self.k = H_em.shape
        self.int8 = bool(int8)
        self.approx = bool(approx)
        if int8:
            Hq, scale = quantize_item_table(H_em)
            self._Hq = torch.from_numpy(Hq).to(self.device)
            self._scale = torch.from_numpy(scale).to(self.device)
        else:
            self._H = torch.from_numpy(H_em).to(self.device)

    # -- internal ---------------------------------------------------------
    def _dispatch(self, u: torch.Tensor, fetch: int):
        if self.int8:
            s = (self._Hq.to(torch.float32) @ u) * self._scale
        else:
            s = self._H @ u
        return torch.topk(s, fetch)

    def _uvec(self, user, u_vec) -> torch.Tensor:
        if (user is None) == (u_vec is None):
            raise ValueError("pass exactly one of user=, u_vec=")
        if u_vec is not None:
            u_vec = np.asarray(u_vec, np.float32)
            if u_vec.shape != (self.k,):
                raise ValueError(f"u_vec must be ({self.k},), "
                                 f"got {u_vec.shape}")
            return torch.from_numpy(u_vec).to(self.device)
        if self._W is None:
            raise ValueError("engine was built without W; pass u_vec=")
        if not 0 <= int(user) < self._W.shape[0]:
            raise ValueError(f"user {user} outside [0, {self._W.shape[0]})")
        return self._W[int(user)]

    # -- public -----------------------------------------------------------
    def query(self, *, user: int | None = None, u_vec=None, topk: int = 10,
              exclude=None) -> tuple[np.ndarray, np.ndarray]:
        """Top-``topk`` (scores, item_ids) for one query.

        ``exclude`` is an optional array of item ids to filter out (e.g. the
        user's train interactions); the device fetch is over-sized by
        ``len(exclude)`` so ``topk`` real candidates survive the host filter.
        """
        u = self._uvec(user, u_vec)
        extra = 0 if exclude is None else len(np.asarray(exclude).ravel())
        fetch = min(self.n_items, topk + extra)
        s, i = self._dispatch(u, fetch)
        s, i = s.cpu().numpy(), i.cpu().numpy()
        if exclude is not None and extra:
            keep = ~np.isin(i, np.asarray(exclude))
            s, i = s[keep], i[keep]
        take = min(topk, i.shape[0])
        out_s = np.full(topk, -np.inf, np.float32)
        out_i = np.full(topk, -1, np.int32)
        out_s[:take], out_i[:take] = s[:take], i[:take]
        return out_s, out_i

    def warmup(self, topk: int = 10, exclude_sizes=()) -> None:
        """Run each query shape once, so that the first timed query pays
        no one-time set-up (library handles, allocator growth)."""
        zeros = np.zeros(self.k, np.float32)
        self.query(u_vec=zeros, topk=topk)
        for e in exclude_sizes:
            fetch = min(self.n_items, topk + int(e))
            self._dispatch(torch.from_numpy(zeros).to(self.device), fetch)
        synchronize(self.device)
