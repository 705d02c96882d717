"""Port hybrid backend with explicit panel masks (bfloat16, int8) and with
NaN panels without ``hybrid_panel_kernel``, against the JAX package.

Step: both packages start from ONE state (the JAX state after an outer
step of ``make_hybrid_outer_step(nan_mask=..., panel_kernel=False)``, the
XLA einsum panel path, carried across with ``hybrid_state_from_numpy``)
and run one more outer step at an f32 residual; the port (K4 and the masked
sweeps, or K1-K3 for NaN panels, in their plain versions on the CPU) must
match at rtol 1e-4, atol 1e-5 (einsum vs kernel f32 summation order, ULP
level; tests/test_hybrid.py:174).

Run: ``ccd_hybrid_train`` passes golden_compare against the NumPy reference
at the reference's 10% bar (atol 1e-3) and tracks the JAX package's RMSE
trajectory within 1e-3; a bf16 residual tracks the golden RMSE within 0.02
(tests/test_hybrid.py:221).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_recommender_tpu.core.config import Config as JConfig
from cuda_recommender_tpu.solvers import ccd_hybrid as jh
from cuda_recommender_tpu_torch.core.config import Config
from cuda_recommender_tpu_torch.core.init import init_factors_np
from cuda_recommender_tpu_torch.data import datasets
from cuda_recommender_tpu_torch.data.sparse import from_coo, make_test
from cuda_recommender_tpu_torch.eval.metrics import golden_compare
from cuda_recommender_tpu_torch.ops import launches
from cuda_recommender_tpu_torch.solvers import ccd_hybrid as th
from cuda_recommender_tpu_torch.solvers.hybrid_state import (
    hybrid_state_from_numpy, hybrid_state_to_numpy)
from cuda_recommender_tpu_torch.solvers.reference import ccd_reference

K = 6
BUDGETS = {
    "stair_and_tail": (100 * 120, (32, 16)),   # multi-panel stair + ELL tail
    "all_dense": (300 * 120, (32,)),           # budget covers everything
    "one_panel_and_tail": (40 * 120, ()),      # one full-width panel + tail
}
MASKS = ("bfloat16", "int8", "nan")            # "nan": no panel kernel


def _small():
    """tests/conftest.py's small_data, from the port's own generator."""
    return datasets.synthetic(m=300, n=120, nnz=6000, seed=7)


@pytest.fixture(scope="module")
def data():
    return _small()


@pytest.fixture(scope="module")
def golden(data):
    R, T = data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    W, H = W0.copy(), H0.copy()
    stats = ccd_reference(R, W, H, T, lambda_=0.1, maxiter=3)
    return W0, H0, W, H, stats


def _cfg_kw(case, mask):
    cells, widths = BUDGETS[case]
    return dict(backend="hybrid", mask_dtype=mask, hybrid_panel_kernel=False,
                hybrid_dense_cells=cells, hybrid_panel_widths=widths)


@functools.lru_cache(maxsize=None)
def _jax_steps(case, mask, inner, rdt=jnp.float32, nsteps=2):
    """``nsteps`` JAX outer steps (einsum panel path) of budget ``case``
    from the initial state of its ``ccd_hybrid_train``; returns (plan, the
    payload after each step). Cached: callers must not modify them."""
    R, _ = _small()
    cfg = JConfig(k=K, lambda_=0.1, maxinneriter=inner, **_cfg_kw(case, mask))
    plan = jh.plan_hybrid(R, cfg, materialize_dense=False)
    Rds, masks = jh.densify_panels(plan, rdt, mask_dtype=mask)
    rows, cols = plan.ell.rows_side, plan.ell.cols_side
    W0, _ = init_factors_np(K, R.rows, R.cols, seed=0)
    s = (Rds, tuple(jnp.asarray(b.val) for b in rows.buckets),
         tuple(jnp.asarray(b.val) for b in cols.buckets),
         jnp.asarray(W0[:, plan.user_order]), jnp.zeros((K, R.cols)),
         jnp.zeros(R.rows), jnp.zeros(R.cols))
    consts = tuple(jnp.asarray(x) for x in (
        plan.row_nnz, plan.col_nnz, plan.upos_of_slot_safe,
        plan.ipos_of_slot_safe, plan.slot_of_upos, plan.slot_of_ipos))
    idx_r = tuple(jnp.asarray(b.idx) for b in rows.buckets)
    idx_c = tuple(jnp.asarray(b.idx) for b in cols.buckets)
    step = jh.make_hybrid_outer_step(plan, 0.1, inner, residual_dtype=rdt,
                                     nan_mask=mask == "nan",
                                     panel_kernel=False)
    out = []
    for _ in range(nsteps):
        s = step(idx_r, idx_c, s[0], masks, s[1], s[2], s[3], s[4], s[5],
                 s[6], *consts)
        Rds_, vals_r, vals_c, W, H, up, vp = s
        p = {"W": np.array(W), "H": np.array(H), "u_pend": np.array(up),
             "v_pend": np.array(vp)}
        p.update({f"Rd_{i}": np.array(x) for i, x in enumerate(Rds_)})
        p.update({f"vals_r_{i}": np.array(x) for i, x in enumerate(vals_r)})
        p.update({f"vals_c_{i}": np.array(x) for i, x in enumerate(vals_c)})
        out.append(p)
    return plan, tuple(out)


@functools.lru_cache(maxsize=None)
def _jax_run(case, mask):
    R, T = _small()
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    cfg = JConfig(k=K, maxiter=3, lambda_=0.1, **_cfg_kw(case, mask))
    return jh.ccd_hybrid_train(R, W0.copy(), H0.copy(), T, cfg)


def _port_plan(R, case, mask):
    return th.plan_hybrid(R, Config(k=K, **_cfg_kw(case, mask)),
                          materialize_dense=False)


@pytest.mark.parametrize("case,mask,inner",
                         [("stair_and_tail", m, i) for m in MASKS
                          for i in (1, 2)]
                         + [("all_dense", "bfloat16", 1),
                            ("one_panel_and_tail", "int8", 1)])
def test_outer_step_matches_jax(data, case, mask, inner):
    R, _ = data
    _, (p1, p2) = _jax_steps(case, mask, inner)
    plan = _port_plan(R, case, mask)
    state = hybrid_state_from_numpy(p1, plan, "cpu", mask_dtype=mask)
    assert len(state.masks) == (0 if mask == "nan" else len(plan.panels))
    th.make_hybrid_outer_step(plan, th.device_plan(plan, "cpu"), 0.1,
                              inner, order="once")(state)
    got = hybrid_state_to_numpy(state)
    assert sorted(got) == sorted(p2)
    for key in p2:
        g, w = got[key], np.asarray(p2[key], np.float32)
        assert g.shape == w.shape, key
        assert np.array_equal(np.isnan(g), np.isnan(w)), key
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=key)
    assert np.abs(p2["u_pend"]).max() > 0       # a non-trivial pending state


@pytest.mark.parametrize("case,mask",
                         [("stair_and_tail", m) for m in MASKS]
                         + [("all_dense", "bfloat16"),
                            ("one_panel_and_tail", "int8")])
def test_train_golden_and_jax_trajectory(data, golden, case, mask):
    R, T = data
    W0, H0, Wr, Hr, stats_r = golden
    launches.reset_launch_counts()
    W, H, stats = th.ccd_hybrid_train(
        R, W0.copy(), H0.copy(), T,
        Config(k=K, maxiter=3, lambda_=0.1, **_cfg_kw(case, mask)),
        device="cpu")
    assert golden_compare(W, Wr, atol=1e-3).passed
    assert golden_compare(H, Hr, atol=1e-3).passed
    for a, b in zip(stats, stats_r):
        assert abs(a.rmse - b.rmse) < 1e-3
    _, _, stats_j = _jax_run(case, mask)
    assert len(stats) == len(stats_j) == 3
    for a, b in zip(stats, stats_j):
        assert abs(a.rmse - b.rmse) < 1e-3
    assert set(launches.launch_counts().values()) == {0}   # CPU: plain


def test_mask_dtypes_identical(data):
    """bf16 and int8 panel masks give identical factors; NaN panels with
    and without ``hybrid_panel_kernel`` run the same kernels, so they are
    identical too."""
    R, T = data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)

    def run(**kw):
        cfg = Config(k=K, maxiter=2, lambda_=0.1,
                     **dict(_cfg_kw("stair_and_tail", "bfloat16"), **kw))
        return th.ccd_hybrid_train(R, W0.copy(), H0.copy(), T, cfg,
                                   device="cpu")[:2]

    for a, b in ((run(), run(mask_dtype="int8")),
                 (run(mask_dtype="nan"),
                  run(mask_dtype="nan", hybrid_panel_kernel=True))):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_bf16_residual_tracks_golden(data, golden):
    R, T = data
    W0, H0, _, _, stats_r = golden
    cfg = Config(k=K, maxiter=3, lambda_=0.1, residual_dtype="bfloat16",
                 **_cfg_kw("stair_and_tail", "bfloat16"))
    W, H, stats = th.ccd_hybrid_train(R, W0.copy(), H0.copy(), T, cfg,
                                      device="cpu")
    assert np.isfinite(W).all() and np.isfinite(H).all()
    for a, b in zip(stats, stats_r):
        assert abs(a.rmse - b.rmse) < 0.02


def test_inner_iterations_golden(data):
    """-T 2 runs masked_vsweep on the panels."""
    R, T = data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    Wr, Hr = W0.copy(), H0.copy()
    ccd_reference(R, Wr, Hr, T, lambda_=0.1, maxiter=2, maxinneriter=2)
    cfg = Config(k=K, maxiter=2, maxinneriter=2, lambda_=0.1,
                 **_cfg_kw("stair_and_tail", "int8"))
    W, H, _ = th.ccd_hybrid_train(R, W0.copy(), H0.copy(), T, cfg,
                                  device="cpu")
    assert golden_compare(W, Wr, atol=1e-3).passed
    assert golden_compare(H, Hr, atol=1e-3).passed


@pytest.mark.parametrize("mask", ["bfloat16", "int8"])
@pytest.mark.parametrize("cells", [2 * 5, 6 * 5])
def test_empty_entities_zero_lambda(cells, mask):
    """Empty rows/cols with λ=0 give exact-0 factors, never NaN, in both
    parts of the split (src/CCD.cpp:8)."""
    R = from_coo(6, 5, [0, 1, 1, 3], [0, 1, 2, 0], [4.0, 3.0, 5.0, 2.0])
    T = make_test(6, 5, [0], [0], [4.0])
    W0, H0 = init_factors_np(3, 6, 5, seed=0)
    cfg = Config(k=3, maxiter=2, lambda_=0.0, backend="hybrid",
                 mask_dtype=mask, hybrid_dense_cells=cells,
                 hybrid_panel_widths=())
    W, H, _ = th.ccd_hybrid_train(R, W0.copy(), H0.copy(), T, cfg,
                                  device="cpu")
    assert np.all(W[:, [2, 4, 5]] == 0)
    assert np.all(H[:, [3, 4]] == 0)
    assert np.isfinite(W).all() and np.isfinite(H).all()


def test_rank_one(data):
    R, T = data
    W0, H0 = init_factors_np(1, R.rows, R.cols, seed=0)
    Wr, Hr = W0.copy(), H0.copy()
    stats_r = ccd_reference(R, Wr, Hr, T, lambda_=0.1, maxiter=2)
    cfg = Config(k=1, maxiter=2, lambda_=0.1,
                 **_cfg_kw("stair_and_tail", "bfloat16"))
    W, H, stats = th.ccd_hybrid_train(R, W0.copy(), H0.copy(), T, cfg,
                                      device="cpu")
    assert golden_compare(W, Wr, atol=1e-3).passed
    assert golden_compare(H, Hr, atol=1e-3).passed
    assert abs(stats[-1].rmse - stats_r[-1].rmse) < 1e-3


@pytest.mark.parametrize("mask,tdt", [("bfloat16", torch.bfloat16),
                                      ("int8", torch.int8), ("nan", None)])
def test_densify_panels_masks(data, mask, tdt):
    """Explicit masks: 0 off the ratings and a {0,1} mask per panel; NaN
    mode: NaN off the ratings and no masks."""
    R, _ = data
    plan = _port_plan(R, "stair_and_tail", mask)
    Rds, masks = th.densify_panels(plan, torch.float32, "cpu", mask)
    assert len(masks) == (0 if tdt is None else len(plan.panels))
    for i, (r0, r1, w) in enumerate(plan.panels):
        lr, lc, _ = plan.panel_coo[i]
        want = np.zeros((r1 - r0, w), bool)
        want[lr, lc] = True
        x = Rds[i].numpy()
        if tdt is None:
            np.testing.assert_array_equal(~np.isnan(x), want)
        else:
            assert masks[i].dtype == tdt
            np.testing.assert_array_equal((masks[i] == 1).numpy(), want)
            assert not x[~want].any()


@pytest.mark.parametrize("mask", ["bfloat16", "int8"])
@pytest.mark.parametrize("rdt", [jnp.float32, jnp.bfloat16])
def test_state_round_trip(data, mask, rdt):
    """to_numpy(from_numpy(x)) == x for the JAX package's explicit-mask
    payload (no masks in it: they are rebuilt from the plan); bf16 panels
    keep their bits."""
    R, _ = data
    plan_j, (p1, _) = _jax_steps("stair_and_tail", mask, 1, rdt)
    plan = _port_plan(R, "stair_and_tail", mask)
    state = hybrid_state_from_numpy(p1, plan, "cpu", mask_dtype=mask)
    want_dt = torch.bfloat16 if rdt == jnp.bfloat16 else torch.float32
    assert all(Rd.dtype == want_dt for Rd in state.Rds)
    _, jmasks = jh.densify_panels(plan_j, rdt, mask_dtype=mask)
    for got, want in zip(state.masks, jmasks):
        np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                      np.asarray(want, np.float32))
    back = hybrid_state_to_numpy(state)
    assert sorted(back) == sorted(p1)
    for key, x in p1.items():
        x32 = np.asarray(x, np.float32)
        assert back[key].shape == x32.shape, key
        assert np.array_equal(back[key], x32), key


def test_state_rejects_observed_padding(data):
    R, _ = data
    _, (p1, _) = _jax_steps("stair_and_tail", "bfloat16", 1)
    plan = _port_plan(R, "stair_and_tail", "bfloat16")
    bad = dict(p1)
    bad["Rd_0"] = np.pad(p1["Rd_0"], ((0, 1), (0, 0)), constant_values=1.0)
    with pytest.raises(ValueError, match="must all be 0"):
        hybrid_state_from_numpy(bad, plan, "cpu", mask_dtype="bfloat16")
