"""Port ALS backend against the JAX package, per part, per step and per run.

Copies: ``auto_min_width``, ``build_ell_pair(min_width="auto")`` and
``als_reference`` are bit-identical to the JAX package's. Assembly: the
port's ``_gram_and_rhs`` (one augmented ``bmm``, no lane chunking) against
the JAX one (augmented batch-last einsums, chunked over 512 lanes) at
rtol 1e-5, atol 1e-6 (f32, another summation order). Step: one outer step
from one slot-space state against JAX ``make_als_outer_step(solver="gj")``
(Pallas in interpret mode) at rtol 1e-3, atol 1e-4. Run: three iterations
against JAX ``als_ell_train`` (RMSE within 1e-4, factors pass
``golden_compare`` at atol 1e-3) and against the NumPy reference (the
``_assert_matches`` bar of tests/test_compiled_solvers.py:38-42).

The JAX side compiles its step per layout, which dominates the time of this
file, so each JAX run is made once per module (``_jax_run``).
"""

import dataclasses
import functools
import io
import re
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_recommender_tpu.core.config import Config as JConfig
from cuda_recommender_tpu.data import datasets as jds
from cuda_recommender_tpu.data import ell as jell
from cuda_recommender_tpu.data.sparse import from_coo as j_from_coo
from cuda_recommender_tpu.data.sparse import make_test as j_make_test
from cuda_recommender_tpu.solvers import als_ell as ja
from cuda_recommender_tpu.solvers.reference import als_reference as j_als_ref
from cuda_recommender_tpu_torch import Config, train
from cuda_recommender_tpu_torch.cli import train as cli
from cuda_recommender_tpu_torch.core.init import init_factors_np
from cuda_recommender_tpu_torch.core.metrics_log import MetricsLog
from cuda_recommender_tpu_torch.data import datasets
from cuda_recommender_tpu_torch.data import ell as tell
from cuda_recommender_tpu_torch.data.sparse import from_coo, make_test
from cuda_recommender_tpu_torch.eval.metrics import golden_compare
from cuda_recommender_tpu_torch.ops import launches
from cuda_recommender_tpu_torch.solvers import als_ell as ta
from cuda_recommender_tpu_torch.solvers.als_state import (
    als_state_from_numpy, als_state_to_numpy, slot_payload)
from cuda_recommender_tpu_torch.solvers.reference import als_reference

K = 6
SMALL = dict(m=300, n=120, nnz=6000, seed=7)   # tests/conftest.py small_data


def _wide_coo():
    """tests/test_compiled_solvers.py:199-217: one 700-wide user, so the
    rows side has a bucket wider than (and not a multiple of) the JAX
    package's 512-lane chunk."""
    rng = np.random.default_rng(0)
    m, n = 300, 800
    r = np.concatenate([np.full(700, 0), rng.integers(1, m, 4000)])
    c = np.concatenate([rng.choice(n, 700, replace=False),
                        rng.integers(0, n, 4000)])
    u, _ = np.unique(np.stack([r, c]), axis=1, return_index=True)
    r, c = u[0].astype(np.int32), u[1].astype(np.int32)
    v = rng.uniform(1, 5, r.size).astype(np.float32)
    ti = rng.integers(0, m, 500).astype(np.int32)
    tj = rng.integers(0, n, 500).astype(np.int32)
    tv = rng.uniform(1, 5, 500).astype(np.float32)
    return m, n, (r, c, v), (ti, tj, tv)


@functools.lru_cache(maxsize=None)
def _data(name):
    """(port R, T), (JAX R, T) of one dataset."""
    if name == "small":
        return datasets.synthetic(**SMALL), jds.synthetic(**SMALL)
    m, n, coo, test = _wide_coo()
    return ((from_coo(m, n, *coo), make_test(m, n, *test)),
            (j_from_coo(m, n, *coo), j_make_test(m, n, *test)))


def _init(R, k=K):
    return init_factors_np(k, R.rows, R.cols, seed=0, entity_major=True)


@functools.lru_cache(maxsize=None)
def _jax_run(name, maxiter=3, **kw):
    """JAX ``als_ell_train`` (solver gj, interpret mode) on one dataset;
    returns (W, H, rmse list, {oiter: slot-space payload})."""
    _, (R, T) = _data(name)
    W0, H0 = _init(R)
    payloads = {}
    W, H, stats = ja.als_ell_train(
        R, W0.copy(), H0.copy(), T,
        JConfig(solver="als", k=K, maxiter=maxiter, lambda_=0.1, **kw),
        ckpt_every=1,
        ckpt_fn=lambda oiter, p: payloads.__setitem__(
            oiter, {key: np.array(v) for key, v in p.items()}))
    return W, H, [s.rmse for s in stats], payloads


def _port_run(name, maxiter=3, **kw):
    (R, T), _ = _data(name)
    W0, H0 = _init(R, kw.pop("k", K))
    resume = kw.pop("resume", None)
    cfg = Config(solver="als", k=W0.shape[1], maxiter=maxiter, lambda_=0.1,
                 **kw)
    return ta.als_ell_train(R, W0.copy(), H0.copy(), T, cfg, device="cpu",
                            resume=resume)


def _assert_bit_identical(a, b, path="x"):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_bit_identical(getattr(a, f.name), getattr(b, f.name),
                                  f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bit_identical(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


# ---------------------------------------------------------------- copies

def test_auto_min_width_identical():
    rng = np.random.default_rng(0)
    cases = [np.zeros(5, np.int64), np.full(50, 200), np.full(50, 3),
             rng.integers(0, 40, 1000), rng.zipf(1.6, 5000) % 5000]
    for deg in cases:
        assert tell.auto_min_width(deg) == jell.auto_min_width(deg)
        assert tell.auto_min_width(deg, 2.0) == jell.auto_min_width(deg, 2.0)
    assert tell.AUTO_FLOOR_TAU == jell.AUTO_FLOOR_TAU


@pytest.mark.parametrize("name", ["small", "wide"])
def test_build_ell_pair_auto_identical(name):
    (R, _), (Rj, _) = _data(name)
    _assert_bit_identical(tell.build_ell_pair(R, min_width="auto"),
                          jell.build_ell_pair(Rj, min_width="auto"))


def test_als_reference_identical():
    (R, T), (Rj, Tj) = _data("small")
    W0, H0 = _init(R)
    W, H, Wj, Hj = W0.copy(), H0.copy(), W0.copy(), H0.copy()
    st = als_reference(R, W, H, T, lambda_=0.1, maxiter=2)
    stj = j_als_ref(Rj, Wj, Hj, Tj, lambda_=0.1, maxiter=2)
    assert np.array_equal(W, Wj) and np.array_equal(H, Hj)
    assert [s.rmse for s in st] == [s.rmse for s in stj]


# ---------------------------------------------------------------- parts

@pytest.mark.parametrize("name,min_width", [("small", 8), ("wide", "auto")])
def test_gram_and_rhs_matches_jax(name, min_width):
    """Every bucket, lane-packed (p > 1) ones and the 700-wide one that is
    not a multiple of the JAX package's 512-lane chunk."""
    (R, _), _ = _data(name)
    ell = tell.build_ell_pair(R, min_width=min_width)
    rng = np.random.default_rng(1)
    other = rng.uniform(-1, 1, (ell.cols_side.n_slots, K)).astype(np.float32)
    table = ta.augmented_table(torch.from_numpy(other))
    other_ext = jnp.asarray(np.concatenate([other, np.zeros((1, K),
                                                            np.float32)]))
    ps = set()
    for b in ell.rows_side.buckets:
        ps.add(b.p)
        G, r = ta._gram_and_rhs(torch.from_numpy(b.idx.astype(np.int64)),
                                torch.from_numpy(b.val), (table,), b, K)
        Gj, rj = ja._gram_and_rhs(jnp.asarray(b.idx), jnp.asarray(b.val),
                                  other_ext, b, 512, batch_last=True,
                                  augmented=True)
        np.testing.assert_allclose(G.numpy(), np.asarray(Gj).transpose(
            2, 0, 1), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r.numpy(), np.asarray(rj).T, rtol=1e-5,
                                   atol=1e-6)
    assert max(ps) > 1
    if name == "wide":
        assert max(b.L for b in ell.rows_side.buckets) == 700


def test_row_groups_bound_true_bytes():
    for rows, L, p, k in [(1000, 128, 1, 40), (7, 23721, 1, 40),
                          (500, 64, 2, 10)]:
        per_row = (L * (k + 1) + p * (k + 1) ** 2 + p * k) * 4
        for budget in (1, per_row * 3 + 1, 1 << 31):
            gs = ta._row_groups(rows, L, p, k, budget)
            assert gs[0][0] == 0 and gs[-1][1] == rows
            assert all(a[1] == b[0] for a, b in zip(gs, gs[1:]))
            assert all((r1 - r0) * per_row <= max(budget, per_row)
                       for r0, r1 in gs)


def _step_inputs(name, W_s, H_s, solver="gj"):
    (R, _), _ = _data(name)
    ell = tell.build_ell_pair(R, min_width="auto")
    idx_r, vals_r = ta.side_tensors(ell.rows_side, "cpu")
    idx_c, vals_c = ta.side_tensors(ell.cols_side, "cpu")
    return ell, (idx_r, idx_c, vals_r, vals_c, torch.from_numpy(W_s.copy()),
                 torch.from_numpy(H_s.copy()),
                 torch.from_numpy(ell.rows_side.slot_nnz),
                 torch.from_numpy(ell.cols_side.slot_nnz))


def test_one_step_matches_jax():
    """One outer step from the JAX run's slot-space state after iteration 1
    against JAX's step (solver gj, Pallas interpret mode)."""
    _, (Rj, _) = _data("small")
    p1 = _jax_run("small")[3][1]
    ellj = jell.build_ell_pair(Rj, min_width="auto", num_shards=1)
    stepj = ja.make_als_outer_step(ellj, 0.1, 512, solver="gj")
    j_args = (tuple(jnp.asarray(b.idx) for b in ellj.rows_side.buckets),
              tuple(jnp.asarray(b.idx) for b in ellj.cols_side.buckets),
              tuple(jnp.asarray(b.val) for b in ellj.rows_side.buckets),
              tuple(jnp.asarray(b.val) for b in ellj.cols_side.buckets),
              jnp.asarray(p1["W"]), jnp.asarray(p1["H"]),
              jnp.asarray(ellj.rows_side.slot_nnz),
              jnp.asarray(ellj.cols_side.slot_nnz))
    Wj, Hj = (np.asarray(x) for x in stepj(*j_args))
    ell, args = _step_inputs("small", p1["W"], p1["H"])
    W, H = ta.make_als_outer_step(ell, 0.1, solver="gj")(*args)
    np.testing.assert_allclose(W.numpy(), Wj, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(H.numpy(), Hj, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name", ["small", "wide"])
def test_three_iterations_match_jax_and_reference(name):
    Wj, Hj, rmse_j, _ = _jax_run(name)
    W, H, stats = _port_run(name)
    assert [s.oiter for s in stats] == [1, 2, 3]
    assert max(abs(s.rmse - r) for s, r in zip(stats, rmse_j)) < 1e-4
    assert golden_compare(W, Wj, atol=1e-3).passed
    assert golden_compare(H, Hj, atol=1e-3).passed
    (R, T), _ = _data(name)
    Wr, Hr = _init(R)
    stats_r = als_reference(R, Wr, Hr, T, lambda_=0.1, maxiter=3)
    assert golden_compare(W, Wr, atol=1e-3).passed
    assert golden_compare(H, Hr, atol=1e-3).passed
    assert all(abs(a.rmse - b.rmse) < 1e-3 for a, b in zip(stats, stats_r))


def test_solvers_agree():
    """gj (K5's plain version on the CPU) and gj_xla are one algorithm, bit
    for bit; lax (Cholesky) agrees with them at the run bar of this file:
    the two eliminations round apart, and three Gauss-Seidel iterations
    carry that to ~4e-3 relative on the smallest entries."""
    outs = {s: _port_run("small", als_solver=s)
            for s in ("gj", "gj_xla", "lax")}
    Wg, Hg, sg = outs["gj"]
    assert np.array_equal(Wg, outs["gj_xla"][0])
    assert np.array_equal(Hg, outs["gj_xla"][1])
    W, H, st = outs["lax"]
    assert golden_compare(W, Wg, atol=1e-3).passed
    assert golden_compare(H, Hg, atol=1e-3).passed
    assert max(abs(a.rmse - b.rmse) for a, b in zip(st, sg)) < 1e-4


def test_many_groups_equal_one_group():
    """A tiny group budget (a K5 launch per few rows) changes nothing but
    the batch the solves are grouped in."""
    W0, H0 = _init(_data("small")[0][0])
    ell, args = _step_inputs("small", *slot_payload(
        tell.build_ell_pair(_data("small")[0][0], min_width="auto"),
        W0, H0).values())
    one = ta.make_als_outer_step(ell, 0.1)(*args)
    many = ta.make_als_outer_step(ell, 0.1, group_bytes=4096)(*args)
    assert ta.k5_launches_per_iter(ell, K, "gj", 4096) > \
        ta.k5_launches_per_iter(ell, K, "gj", 1 << 31) == 16
    for a, b in zip(one, many):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_fused_outer_iters_same():
    W1, H1, s1 = _port_run("small", maxiter=4)
    W4, H4, s4 = _port_run("small", maxiter=4, fused_outer_iters=4)
    np.testing.assert_allclose(W1, W4, atol=1e-6)
    assert [s.oiter for s in s4] == [1, 2, 3, 4]
    assert max(abs(a.rmse - b.rmse) for a, b in zip(s1, s4)) < 1e-5


# ---------------------------------------------------------------- edges

@pytest.mark.parametrize("lam", [0.1, 0.0])
def test_empty_entities_zero(lam):
    """tests/test_compiled_solvers.py:176-184, also at λ = 0 (singular
    grams of the padding slots must not leak NaN)."""
    R = from_coo(6, 5, [0, 1, 1, 3], [0, 1, 2, 0], [4.0, 3.0, 5.0, 2.0])
    T = make_test(6, 5, [0], [0], [4.0])
    W0, H0 = init_factors_np(3, 6, 5, seed=0, entity_major=True)
    cfg = Config(solver="als", k=3, maxiter=2, lambda_=lam, backend="ell")
    W, H, _ = ta.als_ell_train(R, W0.copy(), H0.copy(), T, cfg, device="cpu")
    assert np.all(W[[2, 4, 5]] == 0) and np.all(H[[3, 4]] == 0)
    if lam:
        assert np.isfinite(W).all() and np.isfinite(H).all()


def test_maxiter_zero_and_k1():
    W0, H0 = _init(_data("small")[0][0])
    W, H, stats = _port_run("small", maxiter=0)
    assert stats == [] and np.array_equal(W, W0) and np.array_equal(H, H0)
    W, H, stats = _port_run("small", maxiter=2, k=1)
    assert W.shape == (300, 1) and np.isfinite(W).all()
    assert stats[1].rmse < stats[0].rmse


def test_resume_from_jax_payload():
    """The JAX run's slot-space state after iteration 1 resumes in the port
    and matches the JAX 3-iteration run."""
    Wj, Hj, rmse_j, payloads = _jax_run("small")
    p1 = payloads[1]
    W, H, stats = _port_run("small", resume={"oiter": 1, **p1})
    assert [s.oiter for s in stats] == [2, 3]
    assert max(abs(s.rmse - r) for s, r in zip(stats, rmse_j[1:])) < 1e-4
    np.testing.assert_allclose(W, Wj, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(H, Hj, rtol=1e-3, atol=1e-4)


def test_state_roundtrip_and_layout_check():
    (R, _), _ = _data("small")
    ell = tell.build_ell_pair(R, min_width="auto")
    W0, H0 = _init(R)
    pay = slot_payload(ell, W0, H0)
    W, H = als_state_from_numpy(pay, ell, "cpu")
    back = als_state_to_numpy(W, H)
    assert np.array_equal(back["W"], pay["W"])
    assert np.array_equal(back["W"][ell.rows_side.slot_of_entity], W0)
    with pytest.raises(ValueError, match="layout"):
        als_state_from_numpy({"W": pay["W"][1:], "H": pay["H"]}, ell, "cpu")


# ------------------------------------------------------- trainer and CLI

def _lines(fn):
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue().splitlines()


def test_train_als_golden_and_plan_event(tmp_path):
    (R, T), _ = _data("small")
    log = MetricsLog(str(tmp_path / "m.jsonl"))
    cfg = Config(solver="als", k=5, maxiter=2, lambda_=0.1, golden=True)
    res, lines = _lines(lambda: train(cfg, R, T, device="cpu", log=log))
    log.close()
    assert res.backend == "ell" and res.entity_major
    assert res.golden_W.error_percentage < 1.0
    assert res.golden_H.error_percentage < 1.0
    assert abs(res.final_rmse - res.ref_final_rmse) < 1e-3
    import json
    with open(tmp_path / "m.jsonl") as f:
        plan = [e for e in map(json.loads, f) if e["kind"] == "als_plan"]
    assert len(plan) == 1
    sides = plan[0]["sides"]
    assert plan[0]["k5_launches_per_iter"] == sum(
        sum(s["groups"]) for s in sides.values())
    assert sides["rows"]["min_width"] == tell.auto_min_width(
        np.diff(R.csr_ptr))
    assert any(x.startswith("[info] als plan: rows side") for x in lines)


def test_backend_request_reports_ell_and_update_time_label():
    """tests/test_trainer.py:124-142 on the port."""
    (R, T), _ = _data("small")
    res, lines = _lines(lambda: train(
        Config(solver="als", k=4, maxiter=1, backend="dense"), R, T,
        device="cpu"))
    assert res.backend == "ell" and "[info] Backend = ell | K = 4 | " \
        "InnerIter = 1 | OuterIter = 1 | L = 0.100" in lines
    line = next(ln for ln in lines if ln.startswith("[-INFO-]"))
    assert "update_time" in line and "rank_time" not in line
    assert float(line.split("update_time")[1].split("|")[0]) > 0.0


def test_als_phase_timing_and_precision_raise():
    """Phase timing is the JAX package's refusal; the precisions "high"
    and "default" (once refused, now in the port) train."""
    (R, T), _ = _data("small")
    with pytest.raises(NotImplementedError, match="CCD telemetry"):
        train(Config(solver="als", k=2, maxiter=1, phase_timing=True), R, T,
              device="cpu")
    for prec in ("high", "default"):
        res, _ = _lines(lambda: train(
            Config(solver="als", k=2, maxiter=2, als_precision=prec), R, T,
            device="cpu"))
        rmse = [s.rmse for s in res.stats]
        assert len(rmse) == 2 and np.isfinite(rmse).all()
        assert np.isfinite(res.W).all() and np.isfinite(res.H).all()


def test_untiled_note_where_jax_would_tile(tmp_path):
    """A threshold below the tables' size would tile the JAX package's
    gathers; the port logs one line and runs untiled, the same math."""
    (R, T), _ = _data("small")
    W0, H0 = _init(R)
    log = MetricsLog(str(tmp_path / "m.jsonl"))
    outs = []
    for mb in (0.002, 0):
        cfg = Config(solver="als", k=K, maxiter=1, als_gather_tile_mb=mb)
        outs.append(_lines(lambda: ta.als_ell_train(
            R, W0.copy(), H0.copy(), T, cfg, device="cpu", log=log)))
    log.close()
    notes = [[x for x in lines if "gather tiling is not in the port" in x]
             for _, lines in outs]
    assert len(notes[0]) == 1 and notes[1] == []
    assert np.array_equal(outs[0][0][0], outs[1][0][0])


def test_cli_als_flags_reach_config(monkeypatch):
    seen = {}

    def fake_train(cfg, R, T, *, device, log, resume_from_checkpoint):
        seen["cfg"], seen["device"] = cfg, device
        assert resume_from_checkpoint is False

    monkeypatch.setattr(cli, "train", fake_train)
    rc = cli.main(["--dataset", "synthetic:m=40,n=25,nnz=400,seed=3",
                   "-ALS", "--als-min-width", "16", "--als-group-mb", "64",
                   "--als-gather-tile-mb", "0.5", "--device", "cpu"])
    cfg = seen["cfg"]
    assert rc == 0 and cfg.solver.value == "als" and seen["device"] == "cpu"
    assert (cfg.als_min_width, cfg.als_group_mb, cfg.als_gather_tile_mb) \
        == (16, 64, 0.5)
    cli.main(["--dataset", "synthetic:m=40,n=25,nnz=400,seed=3", "-ALS",
              "--als-min-width", "auto", "--device", "cpu"])
    assert seen["cfg"].als_min_width == "auto"


def test_cli_als_runs_on_cpu():
    launches.reset_launch_counts()
    rc, lines = _lines(lambda: cli.main([
        "--device", "cpu", "-ALS", "--golden", "--dataset",
        "synthetic:m=300,n=120,nnz=6000,seed=7", "-k", "6", "-t", "3",
        "-l", "0.1"]))
    assert rc == 0
    assert "[info] Picked Version: ALS!" in lines
    assert any(re.match(r"\[info\] Backend = ell \|", x) for x in lines)
    assert len([x for x in lines if x.startswith("Check... ")]) == 2
    assert set(launches.launch_counts().values()) == {0}
