"""Port phase-timing mode: the rank/update split and per-rank verbose RMSE
(the reference's per-phase timers src/CCD.cpp:76-139,158 and its commented
calrmse_r1 verbose path src/CCD.cpp:141-148), on dense, hybrid and ell.

The five tests of tests/test_phase_timing.py run on the port (the mesh
case raises the port's item 15). Each phase function (add-back, sweeps,
subtract) is held against the JAX package's on ONE shared state: the
update phases bit-equal at a bf16 residual (both round the delta, then the
sum) and at rtol 2e-6 / atol 2e-6 at f32 (the kernel tolerance: XLA may
contract the product into the add); the sweeps at the step tolerance,
rtol 1e-4 / atol 1e-5 (the JAX hybrid's sweeps are its Pallas kernels in
interpret mode, or its einsums; the port's, K3/K2 or the masked sweeps'
plain versions).
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_recommender_tpu.core.config import Config as JConfig
from cuda_recommender_tpu.solvers import ccd_dense as jd
from cuda_recommender_tpu.solvers import ccd_ell as jell
from cuda_recommender_tpu.solvers import ccd_hybrid as jh
from cuda_recommender_tpu_torch import Config, train
from cuda_recommender_tpu_torch.core.init import init_factors_np
from cuda_recommender_tpu_torch.data import datasets
from cuda_recommender_tpu_torch.data.ell import build_ell_pair
from cuda_recommender_tpu_torch.solvers import ccd_dense, ccd_ell
from cuda_recommender_tpu_torch.solvers import ccd_hybrid as th
from cuda_recommender_tpu_torch.solvers.dense_state import DenseState
from cuda_recommender_tpu_torch.solvers.ell_state import ell_state_from_numpy
from cuda_recommender_tpu_torch.solvers.hybrid_state import (
    hybrid_state_from_numpy)

K = 5
HYB = dict(backend="hybrid", hybrid_dense_cells=50 * 120,
           hybrid_panel_widths=(16,))
TRAIN_FNS = {"dense": ccd_dense.ccd_dense_train,
             "ell": ccd_ell.ccd_ell_train,
             "hybrid": th.ccd_hybrid_train}
UPDATE_F32 = dict(rtol=2e-6, atol=2e-6)
STEP = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def data():
    return datasets.synthetic(m=300, n=120, nnz=6000, seed=7)


def _quiet(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


# ---- tests/test_phase_timing.py on the port ----

@pytest.mark.parametrize("backend", ["dense", "ell", "hybrid"])
def test_phase_mode_matches_fused(data, backend):
    """The phase-split plain schedule gives the factors and RMSE trajectory
    of the fused deferred-subtract schedule, with BOTH phase timers
    carrying real (nonzero) measurements."""
    R, T = data
    fn = TRAIN_FNS[backend]
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    base = dict(k=K, maxiter=3, lambda_=0.1,
                **(HYB if backend == "hybrid" else dict(backend=backend)))
    Wf, Hf, sf = fn(R, W0.copy(), H0.copy(), T, Config(**base),
                    device="cpu")
    Wp, Hp, sp = fn(R, W0.copy(), H0.copy(), T,
                    Config(phase_timing=True, **base), device="cpu")
    np.testing.assert_allclose(Wf, Wp, atol=1e-5)
    np.testing.assert_allclose(Hf, Hp, atol=1e-5)
    for a, b in zip(sf, sp):
        assert abs(a.rmse - b.rmse) < 1e-5
    for st in sp:
        assert st.rank_time > 0 and st.update_time > 0
        assert st.rmse_time is not None and st.rmse_time > 0


def test_phase_mode_rank_rmse_converges_to_iteration_rmse(data):
    """After the last rank of an outer iteration the residual-RMSE trick
    (calrmse_r1 semantics) equals the full test RMSE of the current
    factors."""
    R, T = data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    seen = []

    def rank_cb(oiter, t, dt, rmse):
        assert dt > 0
        seen.append((oiter, t, rmse))

    cfg = Config(k=K, maxiter=2, lambda_=0.1, backend="dense",
                 phase_timing=True)
    _, _, stats = ccd_dense.ccd_dense_train(R, W0.copy(), H0.copy(), T, cfg,
                                            device="cpu",
                                            rank_callback=rank_cb)
    assert len(seen) == 2 * K
    by_iter = {o: [r for oo, tt, r in seen if oo == o] for o in (1, 2)}
    for st in stats:
        assert abs(by_iter[st.oiter][-1] - st.rmse) < 1e-5


def test_phase_mode_through_trainer_verbose(data):
    """phase_timing with verbose: iteration lines carry a nonzero
    update_time AND a measured rmse time; per-rank `iter %d rank %d` lines
    appear."""
    R, T = data
    cfg = Config(k=4, maxiter=2, lambda_=0.1, backend="ell",
                 phase_timing=True, verbose=True)
    _, out = _quiet(lambda: train(cfg, R, T, device="cpu"))
    iter_lines = [ln for ln in out.splitlines() if ln.startswith("[-INFO-]")]
    assert len(iter_lines) == 2
    for ln in iter_lines:
        upd = float(ln.split("update_time")[1].split("|")[0])
        assert upd > 0.0
        assert "time:" in ln           # measured rmse_time present
    rank_lines = [ln for ln in out.splitlines() if ln.startswith("iter ")]
    assert len(rank_lines) == 2 * 4
    assert all("rmse" in ln for ln in rank_lines)


@pytest.mark.parametrize("kw,match", [
    (dict(backend="pallas"), "pallas"),
    (dict(solver="als"), "CCD telemetry mode"),
    pytest.param(dict(backend="ell", _mesh=True),
                 "single-device in the trainer loop", id="kw2-item 15"),
])
def test_phase_mode_unsupported_combinations(data, kw, match):
    """pallas, ALS and a mesh refuse phase timing with the JAX package's
    words (its phase loop is single-device; the sharded phase functions
    are parallel/ccd_hybrid_sharded.py's)."""
    R, T = data
    kw = dict(kw)
    mesh = object() if kw.pop("_mesh", False) else None
    with pytest.raises(NotImplementedError, match=match):
        train(Config(k=4, maxiter=1, phase_timing=True, **kw), R, T,
              device="cpu", mesh=mesh)


@pytest.mark.parametrize("mask_dtype", ["bfloat16", "nan"])
def test_phase_mode_hybrid(data, mask_dtype):
    """The hybrid backend gives the reference's populated rank/update/rmse
    split (src/CCD.cpp:158) in phase mode, golden-identical to the
    reference solver."""
    R, T = data
    kw = dict(HYB, mask_dtype=mask_dtype,
              hybrid_panel_kernel=mask_dtype == "nan")
    res, _ = _quiet(lambda: train(Config(k=4, maxiter=3, lambda_=0.1,
                                         phase_timing=True, golden=True,
                                         **kw), R, T, device="cpu"))
    assert res.golden_W.passed and res.golden_H.passed
    for st in res.stats:
        assert st.rank_time > 0 and st.rmse_time is not None
        if st.oiter > 1:
            assert st.update_time > 0


# ---- each phase function against the JAX package's ----

def _factors(rng, k, m, n):
    return (rng.normal(size=(k, m)).astype(np.float32) * 0.3,
            rng.normal(size=(k, n)).astype(np.float32) * 0.3)


def _check_update(got, want, dtype):
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **UPDATE_F32)


@pytest.mark.parametrize("rdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("inner", [1, 2])
def test_dense_phase_fns_match_jax(data, rdt, inner):
    R, _ = data
    rng = np.random.default_rng(5)
    W, H = _factors(rng, K, R.rows, R.cols)
    jrdt = jnp.dtype(rdt)
    Rd, Md = jd._device_densify(R, R.rows, R.cols, jrdt)
    row_nnz = np.diff(R.csr_ptr).astype(np.float32)
    col_nnz = np.diff(R.csc_ptr).astype(np.float32)
    jab, jsw, jsub = jd.make_dense_phase_fns(0.1, inner, residual_dtype=jrdt)
    ab, sw, sub = ccd_dense.make_dense_phase_fns(0.1, inner)
    Rd_np = np.asarray(Rd.astype(jnp.float32))
    tdt = getattr(torch, rdt)
    st = DenseState(Rhat=torch.from_numpy(Rd_np.copy()).to(tdt),
                    W=torch.from_numpy(W.copy()), H=torch.from_numpy(H.copy()),
                    u_pend=torch.zeros(R.rows), v_pend=torch.zeros(R.cols))
    mask = torch.from_numpy(np.asarray(Md.astype(jnp.float32))).to(
        torch.bfloat16)
    js = jd.DenseState(Rhat=Rd, W=jnp.asarray(W), H=jnp.asarray(H),
                       u_pend=jnp.zeros(R.rows), v_pend=jnp.zeros(R.cols))
    t = 2
    js = jab(js, Md, t)
    ab(st, mask, t)
    _check_update(st.Rhat.float().numpy(),
                  np.asarray(js.Rhat.astype(jnp.float32)), rdt)
    js = jsw(js, Md, jnp.asarray(row_nnz), jnp.asarray(col_nnz), t)
    sw(st, mask, torch.from_numpy(row_nnz), torch.from_numpy(col_nnz), t)
    np.testing.assert_allclose(st.W.numpy(), np.asarray(js.W), **STEP)
    np.testing.assert_allclose(st.H.numpy(), np.asarray(js.H), **STEP)
    js = jsub(js, Md, t)
    # subtract what JAX swept: both sides subtract the same outer product
    st.W[t], st.H[t] = torch.from_numpy(np.asarray(js.W[t])), \
        torch.from_numpy(np.asarray(js.H[t]))
    sub(st, mask, t)
    _check_update(st.Rhat.float().numpy(),
                  np.asarray(js.Rhat.astype(jnp.float32)), rdt)
    # unobserved cells stay exactly 0
    assert not st.Rhat.float().numpy()[np.asarray(Md.astype(jnp.float32))
                                       == 0].any()


HYBRID_CASES = {
    "nan_kernel_f32": ("nan", True, "float32"),
    "nan_kernel_bf16": ("nan", True, "bfloat16"),
    "mask_f32": ("bfloat16", False, "float32"),
    "mask_bf16": ("bfloat16", False, "bfloat16"),
    "int8_mask_bf16": ("int8", False, "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(HYBRID_CASES))
def test_hybrid_phase_fns_match_jax(data, case):
    """Add-back, sweeps and subtract of the hybrid (panels and both ELL tail
    sides) on one shared state, against make_hybrid_phase_fns of the JAX
    package (its panel kernels in interpret mode where it runs them)."""
    mask_dtype, kernel, rdt = HYBRID_CASES[case]
    R, _ = data
    kw = dict(k=K, lambda_=0.1, backend="hybrid",
              hybrid_dense_cells=100 * 120, hybrid_panel_widths=(32, 16),
              mask_dtype=mask_dtype, hybrid_panel_kernel=kernel,
              residual_dtype=rdt)
    jplan = jh.plan_hybrid(R, JConfig(**kw), materialize_dense=False)
    plan = th.plan_hybrid(R, Config(**kw), materialize_dense=False)
    assert plan.nnz_light > 0 and len(plan.panels) >= 2
    jrdt = jnp.dtype(rdt)
    jmask = jnp.int8 if mask_dtype == "int8" else jnp.bfloat16
    Rds, masks = jh.densify_panels(
        jplan, jrdt, mask_dtype="nan" if mask_dtype == "nan" else jmask,
        block_pad=kernel)
    rng = np.random.default_rng(6)
    m, n = R.rows, R.cols
    W, H = _factors(rng, K, m, n)
    payload = {"W": W, "H": H, "u_pend": np.zeros(m, np.float32),
               "v_pend": np.zeros(n, np.float32)}
    for i, Rp in enumerate(Rds):
        payload[f"Rd_{i}"] = np.asarray(Rp)
    rows, cols = plan.ell.rows_side, plan.ell.cols_side
    for i, b in enumerate(rows.buckets):
        payload[f"vals_r_{i}"] = b.val
    for i, b in enumerate(cols.buckets):
        payload[f"vals_c_{i}"] = b.val
    st = hybrid_state_from_numpy(payload, plan, "cpu", mask_dtype,
                                 dtype=getattr(torch, rdt))
    dplan = th.device_plan(plan, "cpu")
    ab, sw, sub = th.make_hybrid_phase_fns(plan, dplan, 0.1, 1)
    jab, jsw, jsub = jh.make_hybrid_phase_fns(
        jplan, 0.1, 1, nan_mask=mask_dtype == "nan", panel_kernel=kernel)
    j = {"idx_r": tuple(jnp.asarray(b.idx) for b in rows.buckets),
         "idx_c": tuple(jnp.asarray(b.idx) for b in cols.buckets),
         "upos": jnp.asarray(plan.upos_of_slot_safe),
         "ipos": jnp.asarray(plan.ipos_of_slot_safe)}
    Rds_j, vr, vc = Rds, tuple(jnp.asarray(b.val) for b in rows.buckets), \
        tuple(jnp.asarray(b.val) for b in cols.buckets)
    Wj, Hj = jnp.asarray(W), jnp.asarray(H)
    t = 3

    def check_residuals():
        for (r0, r1, w), a, b in zip(plan.panels, st.Rds, Rds_j):
            got = a.float().numpy()
            want = np.asarray(b.astype(jnp.float32))[:r1 - r0, :w]
            assert np.array_equal(np.isnan(got), np.isnan(want))
            _check_update(np.nan_to_num(got), np.nan_to_num(want), rdt)
        for a, b in zip(st.vals_r + st.vals_c, vr + vc):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       **UPDATE_F32)

    Rds_j, vr, vc = jab(j["idx_r"], j["idx_c"], Rds_j, masks, vr, vc, Wj,
                        Hj, t, j["upos"], j["ipos"])
    ab(st, t)
    check_residuals()
    Wj, Hj = jsw(j["idx_r"], j["idx_c"], Rds_j, masks, vr, vc, Wj, Hj, t,
                 jnp.asarray(plan.row_nnz), jnp.asarray(plan.col_nnz),
                 jnp.asarray(plan.slot_of_upos),
                 jnp.asarray(plan.slot_of_ipos))
    sw(st, t)
    np.testing.assert_allclose(st.W.numpy(), np.asarray(Wj), **STEP)
    np.testing.assert_allclose(st.H.numpy(), np.asarray(Hj), **STEP)
    st.W[t] = torch.from_numpy(np.asarray(Wj[t]))
    st.H[t] = torch.from_numpy(np.asarray(Hj[t]))
    Rds_j, vr, vc = jsub(j["idx_r"], j["idx_c"], Rds_j, masks, vr, vc, Wj,
                         Hj, t, j["upos"], j["ipos"])
    sub(st, t)
    check_residuals()


@pytest.mark.parametrize("inner", [1, 2])
def test_ell_phase_fns_match_jax(data, inner):
    R, _ = data
    ell = build_ell_pair(R, min_width=8)
    rows, cols = ell.rows_side, ell.cols_side
    rng = np.random.default_rng(7)
    W, H = _factors(rng, K, rows.n_slots, cols.n_slots)
    W[:, rows.entity_of_slot < 0] = 0.0
    H[:, cols.entity_of_slot < 0] = 0.0
    payload = {"W": W, "H": H, "u_pend": np.zeros(rows.n_slots, np.float32),
               "v_pend": np.zeros(cols.n_slots, np.float32)}
    payload.update({f"vals_r_{i}": b.val for i, b in enumerate(rows.buckets)})
    payload.update({f"vals_c_{i}": b.val for i, b in enumerate(cols.buckets)})
    st = ell_state_from_numpy(payload, ell, "cpu")
    rnnz_r = torch.from_numpy(rows.slot_nnz)
    rnnz_c = torch.from_numpy(cols.slot_nnz)
    ab, sw, sub = ccd_ell.make_ell_phase_fns(
        ell, ccd_ell.side_tiles(rows, "cpu"), ccd_ell.side_tiles(cols, "cpu"),
        rnnz_r, rnnz_c, 0.1, inner)
    jab, jsw, jsub = jell.make_ell_phase_fns(ell, 0.1, inner)
    idx_r = tuple(jnp.asarray(b.idx) for b in rows.buckets)
    idx_c = tuple(jnp.asarray(b.idx) for b in cols.buckets)
    vr = tuple(jnp.asarray(b.val) for b in rows.buckets)
    vc = tuple(jnp.asarray(b.val) for b in cols.buckets)
    Wj, Hj = jnp.asarray(W), jnp.asarray(H)
    t = 1

    def check_residuals():
        for a, b in zip(st.vals_r + st.vals_c, vr + vc):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       **UPDATE_F32)

    vr, vc = jab(idx_r, idx_c, vr, vc, Wj, Hj, t)
    ab(st, t)
    check_residuals()
    Wj, Hj = jsw(idx_r, idx_c, vr, vc, Wj, Hj, jnp.asarray(rows.slot_nnz),
                 jnp.asarray(cols.slot_nnz), t)
    sw(st, t)
    np.testing.assert_allclose(st.W.numpy(), np.asarray(Wj), **STEP)
    np.testing.assert_allclose(st.H.numpy(), np.asarray(Hj), **STEP)
    st.W[t] = torch.from_numpy(np.asarray(Wj[t]))
    st.H[t] = torch.from_numpy(np.asarray(Hj[t]))
    vr, vc = jsub(idx_r, idx_c, vr, vc, Wj, Hj, t)
    sub(st, t)
    check_residuals()


def test_rank1_update_rounds_twice_and_blocks_keep_bits(monkeypatch):
    """bf16: the delta is rounded to bf16 and then the sum (JAX's phase
    update), which differs from one rounding somewhere on random data;
    tiny row blocks give the same bits as one block."""
    rng = np.random.default_rng(8)
    R0 = torch.from_numpy(rng.normal(size=(37, 53)).astype(np.float32))
    u = torch.from_numpy(rng.normal(size=37).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=53).astype(np.float32))
    R = R0.to(torch.bfloat16)
    want = (R.float() + torch.outer(u, v).to(torch.bfloat16).float()).to(
        torch.bfloat16)
    once = (R.float() + torch.outer(u, v)).to(torch.bfloat16)
    got = R.clone()
    ccd_dense.rank1_update(got, None, u, v, 1.0)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert not torch.equal(got.view(torch.int16), once.view(torch.int16))
    monkeypatch.setattr(ccd_dense, "UPDATE_BLOCK_CELLS", 3 * 53 + 1)
    blocked = R.clone()
    ccd_dense.rank1_update(blocked, None, u, v, 1.0)
    assert torch.equal(blocked.view(torch.int16), got.view(torch.int16))
    M = torch.from_numpy(rng.random((37, 53)) < 0.3).to(torch.bfloat16)
    a, b = R.clone(), R.clone()
    ccd_dense.rank1_update(a, M, u, v, -1.0)
    ccd_dense.rank1_update(b, M, u, v, -1.0)  # same again: deterministic
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    unobserved = M == 0
    assert torch.equal(a[unobserved].view(torch.int16),
                       R[unobserved].view(torch.int16))
