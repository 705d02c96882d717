"""The port's transposed hybrid stair against the JAX package.

``hybrid_transpose=True`` trains on Rᵀ with the factors swapped (the item
side seeded); "auto" plans both orientations and keeps the smaller tail.
Held to ``cuda_recommender_tpu/solvers/ccd_hybrid.py``
(``resolve_hybrid_transpose``, ``ccd_hybrid_train``): the same orientation
on tests/test_hybrid.py:389-409's data, W and H of a transposed run within
rtol 1e-4, atol 1e-5 of the JAX run (f32; the kernels' accumulation order),
and golden against the reference on the TRANSPOSED problem as at
tests/test_hybrid.py:368-387.
"""

import ast
import io
import re
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest

from cuda_recommender_tpu.core.config import Config as JConfig
from cuda_recommender_tpu.data import datasets as jdatasets
from cuda_recommender_tpu.data.sparse import from_coo as jfrom_coo
from cuda_recommender_tpu.solvers import ccd_hybrid as jh
from cuda_recommender_tpu_torch import Config, train
from cuda_recommender_tpu_torch.cli import train as cli
from cuda_recommender_tpu_torch.core.init import init_factors_np
from cuda_recommender_tpu_torch.data import datasets
from cuda_recommender_tpu_torch.data.sparse import from_coo
from cuda_recommender_tpu_torch.eval.metrics import golden_compare
from cuda_recommender_tpu_torch.solvers import ccd_hybrid as th
from cuda_recommender_tpu_torch.solvers.reference import ccd_reference

K = 6
#: tests/test_hybrid.py:374-376: an explicit-mask stair with a tail; and
#: the headline's flavour, NaN panels through the panel kernels
CASES = {
    "mask": dict(backend="hybrid", hybrid_dense_cells=100 * 120,
                 hybrid_panel_widths=(32, 16)),
    "nan_kernel": dict(backend="hybrid", hybrid_dense_cells=100 * 120,
                       hybrid_panel_widths=(32, 16), mask_dtype="nan",
                       hybrid_panel_kernel=True),
}


@pytest.fixture(scope="module")
def zipf_items():
    """tests/test_hybrid.py:396-404: flat user degrees, zipf item degrees,
    built by both packages from the same COO."""
    rng = np.random.default_rng(11)
    m, n, nnz = 600, 400, 20_000
    rows = rng.integers(0, m, nnz)
    cols = (rng.zipf(1.3, nnz) - 1) % n
    _, u = np.unique(rows * n + cols, return_index=True)
    coo = (rows[u].astype(np.int32), cols[u].astype(np.int32),
           rng.standard_normal(u.size).astype(np.float32))
    return from_coo(m, n, *coo), jfrom_coo(m, n, *coo)


@pytest.mark.parametrize("widths,cells", [("auto", 30_000),
                                          ((64, 32), 30_000),
                                          ((128,), 60_000),
                                          ("auto", 2_000)])
def test_resolve_matches_jax(zipf_items, widths, cells):
    """Both orientations of the matrix resolve as the JAX package does."""
    R, RJ = zipf_items
    kw = dict(backend="hybrid", hybrid_dense_cells=cells,
              hybrid_panel_widths=widths, hybrid_transpose="auto")
    for a, b in ((R, RJ), (R.transpose(), RJ.transpose())):
        assert th.resolve_hybrid_transpose(a, Config(**kw)) == \
            jh.resolve_hybrid_transpose(b, JConfig(**kw))
    if (widths, cells) == ("auto", 30_000):     # tests/test_hybrid.py:405
        assert th.resolve_hybrid_transpose(R, Config(**kw)) is True
    assert th.resolve_hybrid_transpose(
        R, Config(**dict(kw, hybrid_transpose=True))) is True
    assert th.resolve_hybrid_transpose(
        R, Config(**dict(kw, hybrid_transpose=False))) is False


def test_plan_oriented_returns_the_chosen_plan(zipf_items):
    R, _ = zipf_items
    cfg = Config(backend="hybrid", hybrid_dense_cells=30_000,
                 hybrid_transpose="auto")
    transposed, plan = th.plan_oriented(R, cfg)
    assert transposed and plan.row_nnz.shape == (R.cols,)
    want = th.plan_hybrid(R.transpose(), Config(backend="hybrid",
                                                hybrid_dense_cells=30_000),
                          materialize_dense=False)
    assert plan.panels == want.panels and plan.nnz_light == want.nnz_light
    assert th.plan_oriented(R, Config(hybrid_transpose=True)) == (True, None)


@pytest.fixture(scope="module")
def data():
    R, T = datasets.synthetic(m=300, n=120, nnz=6000, seed=7)
    RJ, TJ = jdatasets.synthetic(m=300, n=120, nnz=6000, seed=7)
    return R, T, RJ, TJ


@pytest.mark.parametrize("case", sorted(CASES))
def test_transposed_run_matches_jax_and_golden(data, case):
    """One transposed run of each case: W, H within rtol 1e-4, atol 1e-5
    of the JAX run; both pass golden against the reference on Rᵀ with the
    item side seeded; the RMSE trajectories agree within 1e-5."""
    R, T, RJ, TJ = data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    kw = dict(k=K, maxiter=3, maxinneriter=1, lambda_=0.1,
              hybrid_transpose=True, **CASES[case])
    Wj, Hj, sj = jh.ccd_hybrid_train(RJ, W0.copy(), H0.copy(), TJ,
                                     JConfig(**kw))
    W, H, st = th.ccd_hybrid_train(R, W0.copy(), H0.copy(), T, Config(**kw),
                                   device="cpu")
    assert W.shape == (K, R.rows) and H.shape == (K, R.cols)
    np.testing.assert_allclose(W, np.asarray(Wj), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(H, np.asarray(Hj), rtol=1e-4, atol=1e-5)
    assert max(abs(a.rmse - b.rmse) for a, b in zip(st, sj)) < 1e-5
    Wt, Ht = H0.copy(), W0.copy()                 # the item side seeded
    stats_r = ccd_reference(R.transpose(), Wt, Ht, th.transpose_test(T),
                            lambda_=0.1, maxiter=3, maxinneriter=1)
    assert golden_compare(W, Ht, atol=1e-3).passed
    assert golden_compare(H, Wt, atol=1e-3).passed
    assert max(abs(a.rmse - b.rmse) for a, b in zip(st, stats_r)) < 1e-3


def test_transposed_differs_from_untransposed(data):
    """The transposed run is its own trajectory (the seeded side differs),
    so the golden run must follow the orientation."""
    R, T, _, _ = data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    base = dict(k=K, maxiter=2, lambda_=0.1, **CASES["mask"])
    Wt, _, _ = th.ccd_hybrid_train(R, W0, H0, T,
                                   Config(hybrid_transpose=True, **base),
                                   device="cpu")
    Wn, _, _ = th.ccd_hybrid_train(R, W0, H0, T, Config(**base),
                                   device="cpu")
    assert np.abs(Wt - Wn).max() > 1e-2


@pytest.mark.parametrize("transpose", [True, "auto"])
def test_train_golden_follows_the_orientation(zipf_items, transpose):
    """train() with golden on: the golden dual run solves the transposed
    problem when the stair is transposed, and both checks pass."""
    R, _ = zipf_items
    T = datasets.synthetic(m=600, n=400, nnz=2000, seed=5,
                           power_law=False)[1]
    cfg = Config(k=4, maxiter=3, lambda_=0.1, golden=True,
                 hybrid_dense_cells=30_000, hybrid_transpose=transpose,
                 **{k: v for k, v in CASES["nan_kernel"].items()
                    if k not in ("hybrid_dense_cells",
                                 "hybrid_panel_widths")})
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = train(cfg, R, T, device="cpu")
    assert res.golden_W.passed and res.golden_H.passed, buf.getvalue()
    assert abs(res.final_rmse - res.ref_final_rmse) < 1e-3
    # the plan line is the transposed matrix's: rows are the 400 items
    plan = re.search(r"hybrid plan: \d+ panels (\[.*?\]),", buf.getvalue())
    panels = ast.literal_eval(plan.group(1))
    assert max(r1 for _, r1, _ in panels) <= R.cols


@pytest.mark.parametrize("transpose", [False, True, "auto"])
def test_run_reports_its_one_orientation(zipf_items, monkeypatch,
                                         transpose):
    """ccd_hybrid_train decides the orientation once and writes it, with
    its plan, into ``run``; train()'s golden run reads that decision and
    plans nothing again."""
    R, _ = zipf_items
    T = datasets.synthetic(m=600, n=400, nnz=2000, seed=5,
                           power_law=False)[1]
    calls = []
    real = th.plan_oriented
    monkeypatch.setattr(th, "plan_oriented",
                        lambda R, cfg: calls.append(1) or real(R, cfg))
    kw = dict(backend="hybrid", k=3, maxiter=1, lambda_=0.1,
              hybrid_dense_cells=30_000, hybrid_transpose=transpose)
    W0, H0 = init_factors_np(3, R.rows, R.cols, seed=0)
    run = {}
    th.ccd_hybrid_train(R, W0, H0, T, Config(**kw), device="cpu", run=run)
    want = bool(transpose)          # auto transposes on this data (above)
    assert run["transposed"] is want and len(calls) == 1
    assert run["plan"].row_nnz.shape == ((R.cols,) if want else (R.rows,))
    assert run["plan_s"] >= 0 and run["setup_s"] >= 0
    with redirect_stdout(io.StringIO()):
        res = train(Config(golden=True, **kw), R, T, device="cpu")
    assert len(calls) == 2                       # the run's one decision
    assert res.golden_W.passed and res.golden_H.passed


def test_cli_transpose_stair_auto(capsys):
    """--transpose-stair auto through the CLI, golden on."""
    argv = ["--dataset", "synthetic:m=300,n=120,nnz=6000,seed=7", "-k", "4",
            "-t", "2", "-l", "0.1", "--backend", "hybrid", "--mask-dtype",
            "nan", "--panel-kernel", "--hybrid-cells", "6000",
            "--transpose-stair", "auto", "--golden", "--device", "cpu"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert out.count("Check... PASS!") == 2
    assert "hybrid plan:" in out


@pytest.mark.parametrize("flag,want", [("0", False), ("1", True),
                                       ("auto", "auto")])
def test_cli_flag_reaches_config(monkeypatch, flag, want):
    seen = {}

    def fake_train(cfg, R, T, **kw):
        seen["cfg"] = cfg

    monkeypatch.setattr(cli, "train", fake_train)
    with redirect_stdout(io.StringIO()):
        cli.main(["--dataset", "synthetic:m=40,n=25,nnz=400,seed=3",
                  "--transpose-stair", flag, "--device", "cpu"])
    assert seen["cfg"].hybrid_transpose == want


def test_jax_backend_untouched():
    """The JAX side of these tests ran on the CPU."""
    assert jax.default_backend() == "cpu"
