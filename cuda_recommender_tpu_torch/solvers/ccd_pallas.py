"""CCD++ — the pallas backend, in PyTorch: a thin alias of the dense backend.

The JAX package's pallas backend (``cuda_recommender_tpu/solvers/
ccd_pallas.py``) runs the dense backend's state and schedule with the rank-1
residual update fused into the first v-sweep by its Pallas kernel
(``ops/ccd_pallas.py::fused_update_vsweep``, K4). The port's dense backend
already runs that schedule through the port of K4 on the card
(solvers/ccd_dense.py), so on the card both backends launch the same
kernels in the same order and give bit-equal factors. This module keeps
what differs in the JAX pallas backend and nothing else:

  * the mask is always bfloat16 (the JAX backend ignores
    ``cfg.mask_dtype``, ccd_pallas.py:82), so ``mask_dtype="nan"`` or
    "int8" does not change it;
  * no block padding: the JAX backend pads the residual and the factors to
    its 256 x 512 TPU blocks (ccd_pallas.py:77-80); the port's kernels mask
    the ragged edge, and ``dense_state_from_numpy`` trims a padded payload;
  * its checkpoint payload is padded with zeros to those blocks
    (``payload_shape``), as the JAX pallas backend writes and reads it;
  * at an fp8 residual K4 stores in the Pallas kernel's order ("once": the
    sum rounded once, the sweep reading it unrounded), where the dense
    backend stores delta-first as XLA does (ops/densify.py::store_order);
  * phase timing raises (core/trainer.py::check_supported), as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from ..core.config import Config
from ..core.metrics_log import MetricsLog
from ..data.sparse import RatingMatrix, TestCOO
from . import ccd_dense
from .reference import IterStats


#: the JAX pallas backend's block shape (its ops/ccd_pallas.py BM, BN): its
#: residual and factors are zero-padded to multiples of it
BLOCK = (256, 512)


def payload_shape(m: int, n: int) -> tuple[int, int]:
    """The JAX pallas backend's padded (rows, cols) of an (m, n) matrix."""
    return (-(-m // BLOCK[0]) * BLOCK[0], -(-n // BLOCK[1]) * BLOCK[1])


def _bf16_mask(cfg: Config) -> Config:
    # the pallas backend ignores the hybrid's panel-kernel flag as well, and
    # Config refuses that flag beside a bf16 mask; it has no phase mode
    # (the trainer refuses it there)
    return dataclasses.replace(cfg, mask_dtype="bfloat16",
                               hybrid_panel_kernel=False, phase_timing=False)


def make_pallas_outer_step(lam: float, maxinneriter: int, *,
                           nmf: bool = False) -> Callable:
    """The pallas schedule's outer step: ``ccd_dense.make_outer_step``,
    storing once."""
    return ccd_dense.make_outer_step(lam, maxinneriter, nmf=nmf,
                                     order="once")


def ccd_pallas_train(R: RatingMatrix, W0: np.ndarray, H0: np.ndarray,
                     T: TestCOO, cfg: Config, *, device="cuda",
                     callback: Optional[Callable[[IterStats], None]] = None,
                     ckpt_every: int = 0, ckpt_fn=None, resume=None,
                     log: Optional[MetricsLog] = None,
                     ) -> tuple[np.ndarray, np.ndarray, list[IterStats]]:
    """Train CCD++ with the pallas backend on ``device``: the dense backend
    with a bfloat16 mask. Returns (W, H, stats) in the reference's
    rank-major layout; ``resume`` may be the JAX pallas backend's padded
    payload, and the checkpoint payloads are padded as it pads them."""
    return ccd_dense.ccd_dense_train(
        R, W0, H0, T, _bf16_mask(cfg), device=device, callback=callback,
        ckpt_every=ckpt_every, ckpt_fn=ckpt_fn, resume=resume,
        payload_shape=payload_shape(R.rows, R.cols), log=log, order="once")
