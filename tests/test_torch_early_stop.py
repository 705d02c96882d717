"""Opt-in early stopping (``--early-stop``, ``-e eps``) in the port against
the JAX package (tests/test_early_stop.py).

The predicate ``early_stopped`` is a copy in the port, held to the JAX
package's on the same RMSE sequences. Through ``train``, on the same
NumPy-seeded data (conftest's ``small_data``): ``early_stop=True,
eps=0.9`` stops both packages' compiled runs and the port's golden run
after iteration 2 (an improvement of 90% is never reached), and the golden
check still passes; without the flag every one of ``maxiter`` iterations
runs (the reference's parity). The sharded stop is a case of
tests/test_torch_parallel.py's 4-rank launch.
"""

import numpy as np
import pytest

from cuda_recommender_tpu.core.config import Config as JConfig
from cuda_recommender_tpu.core.metrics_log import MetricsLog as JLog
from cuda_recommender_tpu.core.trainer import train as jtrain
from cuda_recommender_tpu.data import datasets as jdatasets
from cuda_recommender_tpu.solvers.reference import IterStats as JStats
from cuda_recommender_tpu.solvers.reference import early_stopped as jstopped
from cuda_recommender_tpu_torch import Config, train
from cuda_recommender_tpu_torch.core.init import init_factors_np
from cuda_recommender_tpu_torch.core.metrics_log import MetricsLog
from cuda_recommender_tpu_torch.data import datasets
from cuda_recommender_tpu_torch.solvers.reference import (IterStats,
                                                          als_reference,
                                                          ccd_reference,
                                                          early_stopped)

SMALL = dict(m=300, n=120, nnz=6000, seed=7)


@pytest.mark.parametrize("rmse,eps", [((1.0,), 0.1), ((1.0, 0.5), 0.1),
                                      ((1.0, 0.95), 0.1), ((1.0, 1.2), 0.1),
                                      ((1.0, 0.95), 0.0),
                                      ((1.0, 0.9, 0.899), 0.01)])
def test_early_stopped_predicate_matches_jax(rmse, eps):
    ours = [IterStats(oiter=i + 1, rmse=v) for i, v in enumerate(rmse)]
    theirs = [JStats(oiter=i + 1, rmse=v) for i, v in enumerate(rmse)]
    assert early_stopped(ours, eps) == jstopped(theirs, eps)


def test_reference_solvers_stop_early():
    R, T = datasets.synthetic(**SMALL)
    W, H = init_factors_np(4, R.rows, R.cols, seed=0)
    stats = ccd_reference(R, W, H, T, lambda_=0.1, maxiter=8,
                          early_stop_eps=0.9)
    assert len(stats) == 2
    W, H = init_factors_np(4, R.rows, R.cols, seed=0, entity_major=True)
    stats = als_reference(R, W, H, T, lambda_=0.1, maxiter=8,
                          early_stop_eps=0.9)
    assert len(stats) == 2


@pytest.mark.parametrize("solver,backend", [("ccd", "dense"), ("ccd", "ell"),
                                            ("ccd", "hybrid"),
                                            ("ccd", "pallas"),
                                            ("als", "ell")])
def test_trainer_early_stop_matches_jax(solver, backend):
    R, T = datasets.synthetic(**SMALL)
    Rj, Tj = jdatasets.synthetic(**SMALL)
    kw = dict(solver=solver, k=4, lambda_=0.1, backend=backend)
    res = train(Config(maxiter=8, golden=True, early_stop=True, eps=0.9,
                       **kw), R, T, device="cpu",
                log=MetricsLog(None, echo=False))
    assert len(res.stats) == 2 and len(res.ref_stats) == 2
    if solver == "ccd":
        assert res.golden_W.passed and res.golden_H.passed
    else:   # the JAX package's ALS bar (tests/test_trainer.py:29-34)
        assert res.golden_W.error_percentage < 1.0
        assert res.golden_H.error_percentage < 1.0
    jres = jtrain(JConfig(maxiter=8, early_stop=True, eps=0.9, **kw), Rj, Tj,
                  log=JLog(None, echo=False))
    assert len(jres.stats) == 2
    assert abs(res.final_rmse - jres.final_rmse) <= 1e-4
    # without the flag: every iteration, in both packages
    full = train(Config(maxiter=4, **kw), R, T, device="cpu",
                 log=MetricsLog(None, echo=False))
    jfull = jtrain(JConfig(maxiter=4, **kw), Rj, Tj,
                   log=JLog(None, echo=False))
    assert len(full.stats) == len(jfull.stats) == 4
    np.testing.assert_allclose([s.rmse for s in full.stats],
                               [s.rmse for s in jfull.stats], atol=1e-4)
