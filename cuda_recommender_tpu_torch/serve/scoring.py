"""Batch scoring and prediction-file serving.

The port of ``cuda_recommender_tpu/serve/scoring.py``. It expands the
reference's (disabled) predict path -- save_mat_t model reload, per-line
test scoring, an output file and the final RMSE (calculate_rmse_from_file,
reference src/extras.cpp:143-180, call sites commented at
src/main.cpp:146-149) -- into a batch scorer on the device. Score rows are
one f32 ``(B, k) x (k, n)`` product (TF32 off, ``core/device.py``); pair
scores gather the factor rows and take a row-wise dot, in chunks of
``chunk`` pairs.

NumPy in and NumPy out; the work runs on ``device`` ("cuda" by default,
and an error without a GPU; "cpu" as the tests run it).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.binfmt import load_model
from ..data.datasets import load_text_ratings


def as_entity_major(W: np.ndarray, H: np.ndarray, entity_major: bool):
    """Normalize either reference layout to entity-major (m,k)/(n,k)."""
    if entity_major:
        return np.asarray(W, np.float32), np.asarray(H, np.float32)
    return (np.ascontiguousarray(np.asarray(W, np.float32).T),
            np.ascontiguousarray(np.asarray(H, np.float32).T))


def predict_pairs_device(W_em: torch.Tensor, H_em: torch.Tensor,
                         ui: torch.Tensor, ij: torch.Tensor) -> torch.Tensor:
    """Scores for (user, item) id pairs; entity-major factors on the
    device, int64 ids on the same device."""
    return (W_em.index_select(0, ui) * H_em.index_select(0, ij)).sum(dim=1)


def predict_pairs(W, H, ui, ij, *, entity_major: bool, chunk: int = 1 << 20,
                  device="cuda") -> np.ndarray:
    """Host API: pair scores in chunks of ``chunk`` pairs (the last chunk
    is short: no shape needs padding here)."""
    dev = resolve_device(device)
    W_em, H_em = as_entity_major(W, H, entity_major)
    Wd, Hd = torch.from_numpy(W_em).to(dev), torch.from_numpy(H_em).to(dev)
    ui = np.asarray(ui, np.int64)
    ij = np.asarray(ij, np.int64)
    out = np.empty(ui.shape[0], np.float32)
    for lo in range(0, ui.shape[0], chunk):
        hi = min(lo + chunk, ui.shape[0])
        u = torch.from_numpy(ui[lo:hi]).to(dev)
        j = torch.from_numpy(ij[lo:hi]).to(dev)
        out[lo:hi] = predict_pairs_device(Wd, Hd, u, j).cpu().numpy()
    return out


def score_users(W, H, user_ids, *, entity_major: bool,
                device="cuda") -> np.ndarray:
    """Full score rows for a user batch: (B, n) = U_batch @ H^T in f32."""
    dev = resolve_device(device)
    W_em, H_em = as_entity_major(W, H, entity_major)
    U = torch.from_numpy(W_em[np.asarray(user_ids, np.int64)]).to(dev)
    return (U @ torch.from_numpy(H_em).to(dev).T).cpu().numpy()


def predict_to_file(model_path: str, test_path: str, output_path: str, *,
                    entity_major_model: bool = True, device="cuda") -> float:
    """Reference predict-path parity (calculate_rmse_from_file,
    src/extras.cpp:143-180): load a save_mat_t model file, score a 1-based
    text test file, write one '%lf'-style prediction per line, print and
    return the final RMSE."""
    start = time.perf_counter()
    W, H = load_model(model_path, entity_major=entity_major_model)
    r, c, v = load_text_ratings(test_path, one_based=True)   # src/extras.cpp:166
    if r.shape[0] == 0:
        raise ValueError("empty test file")
    pred = predict_pairs(W, H, r, c, entity_major=True, device=device)
    with open(output_path, "w") as f:
        for p in pred:
            f.write("%f\n" % p)
    rmse = float(np.sqrt(np.mean((pred.astype(np.float64) - v) ** 2)))
    print("[FINAL INFO] Test RMSE = %f. Calculated in %fs"
          % (rmse, time.perf_counter() - start), flush=True)
    return rmse
