"""Nonnegative CCD++ (``-N``, ``do_nmf``) in the port against the JAX
package (tests/test_nmf.py).

The same NumPy-seeded data (conftest's ``small_data``: 300 x 120, 6,000
ratings) and the same seed-0 init go through the port's ``train(...,
device="cpu")`` (the kernels' plain versions) and the JAX package's
``train`` (XLA on the CPU; the pallas backend in Pallas interpret mode).
Bars: factors >= 0 on every backend, the port's strict golden check
(every entry within 10% of the NumPy reference's) passing on W and H, and
the final test RMSE within 1e-6 of the JAX package's. The NumPy reference
is a copy in the port, held bit-equal to the JAX package's here.
"""

import contextlib
import io

import numpy as np
import pytest

from cuda_recommender_tpu.core.config import Config as JConfig
from cuda_recommender_tpu.core.init import init_factors_np as jinit
from cuda_recommender_tpu.core.metrics_log import MetricsLog as JLog
from cuda_recommender_tpu.core.trainer import train as jtrain
from cuda_recommender_tpu.data import datasets as jdatasets
from cuda_recommender_tpu.solvers.reference import ccd_reference as jref
from cuda_recommender_tpu_torch import Config, train
from cuda_recommender_tpu_torch.cli import train as cli
from cuda_recommender_tpu_torch.core.init import init_factors_np
from cuda_recommender_tpu_torch.core.metrics_log import MetricsLog
from cuda_recommender_tpu_torch.data import datasets
from cuda_recommender_tpu_torch.solvers.reference import ccd_reference

K = 6
SMALL = dict(m=300, n=120, nnz=6000, seed=7)
RUN = dict(k=K, lambda_=0.1, maxiter=3, do_nmf=True)


def test_nmf_reference_matches_jax_nonnegative_and_converges():
    """The port's NumPy reference with the clamp gives the JAX package's
    factors bit for bit; they are >= 0, the RMSE does not regress, and the
    clamp binds (the unconstrained run has negative entries)."""
    R, T = datasets.synthetic(**SMALL)
    Rj, Tj = jdatasets.synthetic(**SMALL)
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    np.testing.assert_array_equal(W0, jinit(K, R.rows, R.cols, seed=0)[0])
    W, H = W0.copy(), H0.copy()
    stats = ccd_reference(R, W, H, T, lambda_=0.1, maxiter=3,
                          maxinneriter=1, nmf=True)
    Wj, Hj = W0.copy(), H0.copy()
    jstats = jref(Rj, Wj, Hj, Tj, lambda_=0.1, maxiter=3, maxinneriter=1,
                  nmf=True)
    np.testing.assert_array_equal(W, Wj)
    np.testing.assert_array_equal(H, Hj)
    assert [s.rmse for s in stats] == [s.rmse for s in jstats]
    assert (W >= 0).all() and (H >= 0).all()
    assert stats[-1].rmse <= stats[0].rmse < 1.0
    Wu, Hu = W0.copy(), H0.copy()
    ccd_reference(R, Wu, Hu, T, lambda_=0.1, maxiter=3, maxinneriter=1)
    assert (Wu < 0).any() or (Hu < 0).any()


@pytest.mark.parametrize("backend", ["dense", "ell", "hybrid", "pallas"])
def test_nmf_backend_matches_jax(backend):
    R, T = datasets.synthetic(**SMALL)
    res = train(Config(golden=True, backend=backend, **RUN), R, T,
                device="cpu", log=MetricsLog(None, echo=False))
    assert (res.W >= 0).all() and (res.H >= 0).all()
    assert res.golden_W.passed and res.golden_H.passed
    Rj, Tj = jdatasets.synthetic(**SMALL)
    jres = jtrain(JConfig(backend=backend, **RUN), Rj, Tj,
                  log=JLog(None, echo=False))
    assert (np.asarray(jres.W) >= 0).all()
    assert len(res.stats) == len(jres.stats) == RUN["maxiter"]
    assert abs(res.final_rmse - jres.final_rmse) <= 1e-6


def test_nmf_via_the_cli_flag():
    """``-N 1`` through the port's train CLI: the golden dual run passes."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--dataset", "synthetic:m=300,n=120,nnz=6000,seed=7",
                       "-k", str(K), "-t", "2", "-l", "0.1", "-N", "1",
                       "--backend", "dense", "--golden", "--device", "cpu"])
    assert rc == 0
    assert buf.getvalue().splitlines().count("Check... PASS!") == 2
