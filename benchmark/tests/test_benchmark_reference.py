"""The plain references against the port's NumPy golden solvers
(``solvers/reference.py``) at a small size on the CPU. The tests import
both; the references import neither."""

import numpy as np
import pytest
import torch

from benchmark import datagen
from benchmark.reference import als, ccd
from cuda_recommender_tpu_torch.core.init import init_factors_np
from cuda_recommender_tpu_torch.data.sparse import from_coo, make_test
from cuda_recommender_tpu_torch.solvers.reference import (als_reference,
                                                         ccd_reference)

MIX = dict(rows=300, cols=120, train_nnz=6000, test_share=0.02,
           user_zipf=0.8, item_zipf=0.9, truth_rank=8, noise=0.1, offset=3.5,
           structure_seed=3)


@pytest.fixture(scope="module")
def data():
    d = datagen.generate(MIX, 5, "cpu")
    return d, from_coo(d.rows, d.cols, *d.train), make_test(d.rows, d.cols,
                                                            *d.test)


@pytest.mark.parametrize("inner", [1, 2])
def test_ccd_matches_golden(data, inner):
    d, R, T = data
    W0, H0 = init_factors_np(10, d.rows, d.cols, seed=3)
    W, H = W0.copy(), H0.copy()
    st = ccd_reference(R, W, H, T, lambda_=0.05, maxiter=4,
                       maxinneriter=inner)
    out = ccd.ccd_train(d.rows, d.cols, d.train, d.test, torch.as_tensor(W0),
                        lam=0.05, inner=inner, iters=4, device="cpu",
                        keep=(2,))
    np.testing.assert_allclose(out["rmse"], [s.rmse for s in st], atol=1e-6)
    # float64 segment sums against the golden's float32 dots
    np.testing.assert_allclose(out["W"], W, atol=1e-4)
    np.testing.assert_allclose(out["H"], H, atol=1e-4)
    assert set(out["kept"]) == {2}


def test_als_matches_golden(data):
    d, R, T = data
    W0, H0 = init_factors_np(10, d.rows, d.cols, seed=3, entity_major=True)
    W, H = W0.copy(), H0.copy()
    st = als_reference(R, W, H, T, lambda_=0.1, maxiter=3)
    out = als.als_train(d.rows, d.cols, d.train, d.test, torch.as_tensor(W0),
                        torch.as_tensor(H0), lam=0.1, iters=3, device="cpu")
    np.testing.assert_allclose(out["rmse"], [s.rmse for s in st], atol=1e-4)
    # float32 LU against the golden's float32 solves, on low-degree rows
    np.testing.assert_allclose(out["W"], W, atol=2e-3)
    np.testing.assert_allclose(out["H"], H, atol=2e-3)


def test_als_empty_entities_get_zero():
    train = (np.array([0, 0, 2], np.int32), np.array([0, 1, 1], np.int32),
             np.array([1.0, 2.0, 3.0], np.float32))
    test = (np.array([2], np.int32), np.array([0], np.int32),
            np.array([1.0], np.float32))
    W0 = torch.full((4, 3), 0.1)
    H0 = torch.full((3, 3), 0.1)
    out = als.als_train(4, 3, train, test, W0, H0, lam=0.1, iters=1,
                        device="cpu")
    assert not out["W"][[1, 3]].any() and not out["H"][2].any()


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, -3.14159265])
    y = als.round_tf32(x)
    assert y[0] == 1.0 and y[2] == 1.0 + 2 ** -10
    assert y[1] == 1.0 + 2 ** -10               # a tie rounds away from 0
    assert abs(float(y[3]) + 3.14159265) < 2 ** -9 * 4
    bits = y.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())


def test_als_tf32_control_differs(data):
    d, _, _ = data
    W0, H0 = init_factors_np(10, d.rows, d.cols, seed=3, entity_major=True)
    kw = dict(lam=0.1, iters=3, device="cpu")
    a = als.als_train(d.rows, d.cols, d.train, d.test, torch.as_tensor(W0),
                      torch.as_tensor(H0), **kw)
    b = als.als_train(d.rows, d.cols, d.train, d.test, torch.as_tensor(W0),
                      torch.as_tensor(H0), tf32=True, **kw)
    gap = np.abs(a["W"] - b["W"]).max()
    assert 1e-5 < gap < 0.5


def test_step_residual_is_the_step_s_backward_error(data):
    d, _, _ = data
    W0, H0 = init_factors_np(10, d.rows, d.cols, seed=4, entity_major=True)
    state = als.als_train(d.rows, d.cols, d.train, d.test,
                          torch.as_tensor(W0), torch.as_tensor(H0), lam=0.1,
                          iters=2, device="cpu")
    state = (state["W"], state["H"])
    step = als.als_train(d.rows, d.cols, d.train, d.test,
                         torch.as_tensor(state[0]), torch.as_tensor(state[1]),
                         lam=0.1, iters=1, device="cpu")
    kw = dict(lam=0.1, device="cpu")
    good = als.step_residual(d.rows, d.cols, d.train, state,
                             (step["W"], step["H"]), **kw)
    assert good < 1e-5                      # a float32 solve's round-off
    W = step["W"].copy()
    W[:, 0] *= 1.001
    assert als.step_residual(d.rows, d.cols, d.train, state,
                             (W, step["H"]), **kw) > 100 * good
    # the state's own factors do not solve the step's equations
    assert als.step_residual(d.rows, d.cols, d.train, state, state,
                             **kw) > 1e-2
