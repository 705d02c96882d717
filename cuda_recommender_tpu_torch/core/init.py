"""Deterministic factor initialization.

The port's copy of ``cuda_recommender_tpu/core/init.py``: the same host-side
``default_rng(seed)`` draws, so both packages start from identical bits.
The reference seeds ``srand(0)`` and draws ``0.1*rand()/RAND_MAX + 0.001``
per entry (reference src/tools.cpp:165-173), i.e. U[0.001, 0.101), in
(entity, rank) order; the identical seed for the CUDA and OMP factor copies is
what makes its runtime golden_compare meaningful (src/main.cpp:86-98). We keep
the distribution and the determinism (one seed → bit-identical init for every
backend and device count, generated host-side) without replicating glibc's
rand() bit-stream.

Layouts follow the reference exactly (src/main.cpp:86-98):
  * CCD++: rank-major (k, n_entities)  — initial_col(k, n)
  * ALS  : entity-major (n_entities, k) — initial_col(n, k)
"""

from __future__ import annotations

import numpy as np

LOW = 0.001
HIGH = 0.101


def init_factors_np(k: int, m: int, n: int, *, seed: int = 0,
                    entity_major: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Draw W (users) and H (items), U[0.001, 0.101) like the reference's
    initial_col, in (entity, rank) draw order mirroring its loop nesting.
    Host-side numpy so every backend / device count sees identical bits."""
    rng = np.random.default_rng(seed)
    W = rng.uniform(LOW, HIGH, (m, k)).astype(np.float32)
    H = rng.uniform(LOW, HIGH, (n, k)).astype(np.float32)
    if not entity_major:
        return np.ascontiguousarray(W.T), np.ascontiguousarray(H.T)
    return W, H
