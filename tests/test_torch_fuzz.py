"""Randomised cross-backend fuzz of the port against the JAX package
(tests/test_fuzz.py): random shapes, ranks and hyperparameters, every
compiled backend tracking the NumPy golden solver.

Each case's NumPy-seeded data and init go through the port's ``train(...,
device="cpu")`` (dense, ell, and the NaN-panel hybrid with the panel-kernel
flag, whose kernels take their plain versions on the CPU) and the JAX
package's ``train`` (the hybrid's Pallas panels in interpret mode), and
both are held to the NumPy reference at the JAX file's bars: CCD++
``golden_compare(atol=1e-3)`` passing on W and H; ALS under 0.5% of the
entries off at atol 2e-3. The two packages' final test RMSEs agree within
1e-4 (CCD++) and 1e-3 (ALS): f32 sums in another order.
"""

import numpy as np
import pytest

from cuda_recommender_tpu.core.config import Config as JConfig
from cuda_recommender_tpu.core.metrics_log import MetricsLog as JLog
from cuda_recommender_tpu.core.trainer import train as jtrain
from cuda_recommender_tpu.data import datasets as jdatasets
from cuda_recommender_tpu_torch import Config, train
from cuda_recommender_tpu_torch.core.init import init_factors_np
from cuda_recommender_tpu_torch.core.metrics_log import MetricsLog
from cuda_recommender_tpu_torch.data import datasets
from cuda_recommender_tpu_torch.eval.metrics import golden_compare
from cuda_recommender_tpu_torch.solvers.reference import (als_reference,
                                                          ccd_reference)

CASES = [
    # (m, n, nnz, k, lam, inner, power_law): tests/test_fuzz.py's
    (97, 53, 900, 3, 0.03, 1, True),
    (64, 200, 2500, 7, 0.5, 2, False),
    (310, 41, 4000, 5, 0.1, 3, True),
]
BACKENDS = ["dense", "ell", "hybrid-kernel"]


def _both(spec: dict, cfg: dict):
    """(port result, JAX result) of one configuration on one dataset."""
    R, T = datasets.synthetic(**spec)
    res = train(Config(**cfg), R, T, device="cpu",
                log=MetricsLog(None, echo=False))
    Rj, Tj = jdatasets.synthetic(**spec)
    jres = jtrain(JConfig(**cfg), Rj, Tj, log=JLog(None, echo=False))
    return R, T, res, jres


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("m,n,nnz,k,lam,inner,pl", CASES)
def test_ccd_backends_fuzz(m, n, nnz, k, lam, inner, pl, backend):
    name = backend.split("-")[0]
    extra = {}
    if backend == "hybrid-kernel":
        extra = dict(mask_dtype="nan", hybrid_panel_kernel=True,
                     hybrid_dense_cells=(m // 2) * n,
                     hybrid_panel_widths=(max(8, n // 4),))
    cfg = dict(k=k, maxiter=2, maxinneriter=inner, lambda_=lam,
               backend=name, **extra)
    R, T, res, jres = _both(dict(m=m, n=n, nnz=nnz, seed=m + n,
                                 power_law=pl), cfg)
    W0, H0 = init_factors_np(k, R.rows, R.cols, seed=0)
    Wr, Hr = W0.copy(), H0.copy()
    ccd_reference(R, Wr, Hr, T, lambda_=lam, maxiter=2, maxinneriter=inner)
    for W, H in ((res.W, res.H), (np.asarray(jres.W), np.asarray(jres.H))):
        g = golden_compare(W, Wr, atol=1e-3)
        assert g.passed, f"{backend} {g.message()}"
        assert golden_compare(H, Hr, atol=1e-3).passed
    assert abs(res.final_rmse - jres.final_rmse) <= 1e-4


@pytest.mark.parametrize("m,n,nnz,k,lam", [(97, 53, 900, 3, 0.03),
                                           (64, 200, 2500, 7, 0.5)])
def test_als_fuzz(m, n, nnz, k, lam):
    cfg = dict(solver="als", k=k, maxiter=2, lambda_=lam)
    R, T, res, jres = _both(dict(m=m, n=n, nnz=nnz, seed=m, power_law=True),
                            cfg)
    W0, H0 = init_factors_np(k, R.rows, R.cols, seed=0, entity_major=True)
    Wr, Hr = W0.copy(), H0.copy()
    als_reference(R, Wr, Hr, T, lambda_=lam, maxiter=2)
    for W, H in ((res.W, res.H), (np.asarray(jres.W), np.asarray(jres.H))):
        assert golden_compare(W, Wr, atol=2e-3).error_percentage < 0.5
        assert golden_compare(H, Hr, atol=2e-3).error_percentage < 0.5
    assert abs(res.final_rmse - jres.final_rmse) <= 1e-3
