"""The hybrid's rank-deferred ELL tail (``hybrid_defer_group``) against the
JAX package.

Ops: ``ops/ell_ops.py``'s ``deferred_sweep``, ``deferred_flush`` and
``fused_remap_combine`` against the JAX package's on the same plan's
buckets and the same NumPy-seeded tables: rtol 1e-5, atol 1e-5 (f32 sums
over bucket lanes in another order; the JAX package chunks its gathers
under ``lax.map``, the port gathers a bucket at once).

Runs: G ∈ {2, 3, 16} × inner ∈ {1, 2} (a G that divides k = 6, one that
leaves a partial last group, one past k: a single group flushed at the
last rank) against the same run at G = 0 and against the JAX package's
run at the same G, at the JAX package's bar (tests/test_hybrid.py:
345-365: W and H rtol 1e-3, atol 1e-4, the RMSE an iteration within
1e-4). Without an ELL tail G changes nothing: bit-equal to G = 0.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_recommender_tpu.core.config import Config as JConfig
from cuda_recommender_tpu.ops import ell_ops as je
from cuda_recommender_tpu.solvers import ccd_hybrid as jh
from cuda_recommender_tpu_torch import Config, train
from cuda_recommender_tpu_torch.core.init import init_factors_np
from cuda_recommender_tpu_torch.data import datasets
from cuda_recommender_tpu_torch.ops import ell_ops as te
from cuda_recommender_tpu_torch.solvers import ccd_hybrid as th

K = 6
#: tests/test_hybrid.py:352-354's stair: panels and an ELL tail
BASE = dict(k=K, maxiter=3, lambda_=0.1, backend="hybrid",
            hybrid_dense_cells=100 * 120, hybrid_panel_widths=(32, 16))
RUN_TOL = dict(rtol=1e-3, atol=1e-4)
OP_TOL = dict(rtol=1e-5, atol=1e-5)


def _small():
    """tests/conftest.py's small_data, from the port's own generator."""
    return datasets.synthetic(m=300, n=120, nnz=6000, seed=7)


@functools.lru_cache(maxsize=None)
def _plans():
    R, _ = _small()
    jplan = jh.plan_hybrid(R, JConfig(**BASE), materialize_dense=False)
    tplan = th.plan_hybrid(R, Config(**BASE), materialize_dense=False)
    assert jplan.nnz_light == tplan.nnz_light > 0
    return jplan, tplan


def _sides(side_name):
    jplan, tplan = _plans()
    jside = getattr(jplan.ell, side_name)
    tside = getattr(tplan.ell, side_name)
    jidx = tuple(jnp.asarray(b.idx) for b in jside.buckets)
    tidx = tuple(torch.as_tensor(np.asarray(b.idx, np.int64))
                 for b in tside.buckets)
    rng = np.random.default_rng(len(side_name))
    vals = [rng.normal(size=b.idx.shape).astype(np.float32)
            for b in tside.buckets]
    # the gather table's rows: the other side's entities, plus the zero row
    rows = int(max(b.idx.max() for b in tside.buckets))
    return jside, tside, jidx, tidx, vals, rows


@pytest.mark.parametrize("side_name", ["rows_side", "cols_side"])
@pytest.mark.parametrize("T", [2, 5, 17])
def test_deferred_sweep_matches_jax(side_name, T):
    jside, tside, jidx, tidx, vals, rows = _sides(side_name)
    tab = np.random.default_rng(T).normal(size=(rows, T)).astype(np.float32)
    tab_ext = np.concatenate([tab, np.zeros((1, T), np.float32)])
    S0j, Scj, hj = je.deferred_sweep(jidx, tuple(map(jnp.asarray, vals)),
                                     jside, jnp.asarray(tab_ext))
    S0t, Sct, ht = te.deferred_sweep(tidx, [torch.from_numpy(v)
                                            for v in vals], tside,
                                     torch.from_numpy(tab_ext))
    assert len(Sct) == len(Scj) == T - 1
    np.testing.assert_allclose(S0t.numpy(), np.asarray(S0j), **OP_TOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **OP_TOL)
    for a, b in zip(Sct, Scj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **OP_TOL)


@pytest.mark.parametrize("side_name", ["rows_side", "cols_side"])
@pytest.mark.parametrize("G", [1, 3])
def test_deferred_flush_matches_jax(side_name, G):
    """The port updates the value tiles in place; the JAX package returns
    new ones."""
    jside, tside, jidx, tidx, vals, rows = _sides(side_name)
    rng = np.random.default_rng(G)
    tab = rng.normal(size=(rows + 1, 2 * G)).astype(np.float32)
    tab[-1] = 0.0
    owns = rng.normal(size=(2 * G, tside.n_slots)).astype(np.float32)
    signs = tuple(-1.0 if c % 2 == 0 else 1.0 for c in range(2 * G))
    want = je.deferred_flush(jidx, tuple(map(jnp.asarray, vals)), jside,
                             jnp.asarray(tab), jnp.asarray(owns), signs)
    got = [torch.from_numpy(v.copy()) for v in vals]
    assert te.deferred_flush(tidx, got, tside, torch.from_numpy(tab),
                             torch.from_numpy(owns), signs) is None
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **OP_TOL)


@pytest.mark.parametrize("G", [1, 4])
def test_fused_remap_combine_matches_jax(G):
    """Slot -> entity remap with the corrections, the sentinel slot
    reading the appended zero row."""
    rng = np.random.default_rng(G)
    S, N = 700, 2500
    S_vecs = [rng.normal(size=S).astype(np.float32) for _ in range(2 * G + 1)]
    h = rng.normal(size=S).astype(np.float32)
    idx = rng.integers(0, S + 1, N).astype(np.int64)        # S: sentinel
    weights = rng.normal(size=(2 * G, N)).astype(np.float32)
    signs = tuple(-1.0 if c % 2 == 0 else 1.0 for c in range(2 * G))
    gj, hj = je.fused_remap_combine([jnp.asarray(x) for x in S_vecs],
                                    jnp.asarray(h), jnp.asarray(idx),
                                    jnp.asarray(weights), signs)
    gt, ht = te.fused_remap_combine([torch.from_numpy(x) for x in S_vecs],
                                    torch.from_numpy(h),
                                    torch.from_numpy(idx),
                                    torch.from_numpy(weights), signs)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **OP_TOL)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    assert (ht.numpy()[idx == S] == 0).all()


@functools.lru_cache(maxsize=None)
def _run(package, G, inner, **kw):
    R, T = _small()
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    cfg = dict(BASE, maxinneriter=inner, hybrid_defer_group=G, **kw)
    if package == "jax":
        W, H, stats = jh.ccd_hybrid_train(R, W0.copy(), H0.copy(), T,
                                          JConfig(**cfg))
    else:
        W, H, stats = th.ccd_hybrid_train(R, W0.copy(), H0.copy(), T,
                                          Config(**cfg), device="cpu")
    return W, H, [s.rmse for s in stats]


def _assert_run(got, want):
    np.testing.assert_allclose(got[0], want[0], **RUN_TOL)
    np.testing.assert_allclose(got[1], want[1], **RUN_TOL)
    assert len(got[2]) == len(want[2]) == 3
    for a, b in zip(got[2], want[2]):
        assert abs(a - b) < 1e-4


@pytest.mark.parametrize("inner", [1, 2])
@pytest.mark.parametrize("G", [2, 3, 16])
def test_defer_group_matches_g0_and_jax(G, inner):
    deferred = _run("torch", G, inner)
    _assert_run(deferred, _run("torch", 0, inner))
    _assert_run(deferred, _run("jax", G, inner))


@pytest.mark.parametrize("mask", ["nan", "int8"])
def test_defer_group_with_panel_layouts(mask):
    """The deferred tail beside NaN panels with the panel kernels and
    beside int8 masks, against G = 0."""
    kw = dict(mask_dtype=mask, hybrid_panel_kernel=mask == "nan")
    _assert_run(_run("torch", 3, 1, **kw), _run("torch", 0, 1, **kw))


def test_defer_group_ignored_without_tail():
    """A budget that covers the matrix leaves no tail: G changes no bit."""
    R, T = _small()
    kw = dict(BASE, hybrid_dense_cells=R.rows * R.cols,
              hybrid_panel_widths=(32,))
    runs = [train(Config(hybrid_defer_group=G, **kw), R, T, device="cpu")
            for G in (0, 8)]
    for name in "WH":
        assert np.array_equal(getattr(runs[0], name),
                              getattr(runs[1], name)), name
    assert [s.rmse for s in runs[0].stats] == [s.rmse for s in
                                               runs[1].stats]
