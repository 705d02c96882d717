"""The port's ALS gram precisions ("highest", "high", "default") against the
JAX package.

XLA on the CPU ignores ``jax.lax.Precision``, so the JAX side gets operands
already rounded as the TPU rounds them:

* "default" (one bf16 pass): the JAX ``_gram_and_rhs`` on the table and
  ratings rounded to bf16. Both sides then sum the same exact products in
  f32, in other orders: rtol 1e-6, atol 1e-6.
* "high" (bf16x3: hi·hi + hi·lo + lo·hi, hi = bf16(x), lo = bf16(x - hi)):
  ``JAX(hi + lo) - JAX(lo)``, the full product of the split less the lo·lo
  term that bf16x3 drops. JAX rounds the products of (hi + lo) to f32:
  rtol 1e-5, atol 1e-6.
* "highest": the f32 einsum, the bar of tests/test_torch_als.py.

Each bar also admits the rounding of an f32 sum of E lanes, E·2^-24 times
the sum of the terms' magnitudes: an entry whose terms cancel (an rhs
entry of ratings up to 5 near 0) carries that much error in either
package, whatever its own size.

Whole runs: "default" tracks the NumPy reference's RMSE trajectory within
0.01 an iteration, the JAX package's own bar for it
(tests/test_compiled_solvers.py:146-155); "high" tracks "highest" within
1e-3 (bf16x3 keeps about 16 bits of each operand; the runs here differ by
about 2e-5). Sharded: the mesh runs "high" as "default", as the JAX
package's sharded ALS does, so the two are bit-equal on 4 gloo ranks.
"""

import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_recommender_tpu.solvers import als_ell as ja
from cuda_recommender_tpu_torch import Config, train
from cuda_recommender_tpu_torch.core.init import init_factors_np
from cuda_recommender_tpu_torch.core.metrics_log import MetricsLog
from cuda_recommender_tpu_torch.data import datasets
from cuda_recommender_tpu_torch.data import ell as tell
from cuda_recommender_tpu_torch.eval.metrics import golden_compare
from cuda_recommender_tpu_torch.parallel.launch import run_ranks
from cuda_recommender_tpu_torch.solvers import als_ell as ta
from cuda_recommender_tpu_torch.solvers.reference import als_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(m=300, n=120, nnz=6000, seed=7)   # tests/conftest.py small_data
K = 6
#: (rtol, atol) of the gram and rhs against the JAX package's, by precision
TOL = {"highest": (1e-5, 1e-6), "high": (1e-5, 1e-6),
       "default": (1e-6, 1e-6)}


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 (round to nearest even), as f32."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _split(x: np.ndarray) -> tuple:
    hi = _bf16(x)
    return hi, _bf16(x - hi)


@functools.lru_cache(maxsize=None)
def _small():
    return datasets.synthetic(**SMALL)


def _jax_gram(b, other, val):
    """The JAX package's augmented batch-last assembly -> G (S, k, k) and
    r (S, k) as numpy."""
    ext = jnp.asarray(np.concatenate(
        [other, np.zeros((1, other.shape[1]), np.float32)]))
    G, r = ja._gram_and_rhs(jnp.asarray(b.idx), jnp.asarray(val), ext, b,
                            512, batch_last=True, augmented=True)
    return np.asarray(G).transpose(2, 0, 1), np.asarray(r).T


@pytest.mark.parametrize("k", [8, 16])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_gram_and_rhs_matches_jax(precision, k):
    """Every bucket of the rows side (lane-packed ones among them), the
    port's plain version (the CPU path) against the JAX function under the
    TPU's rounding of ``precision``."""
    R, _ = _small()
    ell = tell.build_ell_pair(R, min_width=8)
    rng = np.random.default_rng(k)
    other = rng.uniform(-1, 1, (ell.cols_side.n_slots, k)).astype(np.float32)
    tables = ta.gram_tables(torch.from_numpy(other), precision)
    assert all(t.shape[1] == (k + 1 if precision == "highest"
                              else -(-(k + 1) // 8) * 8) for t in tables)
    rtol, atol = TOL[precision]
    abs_tables = ta.gram_tables(torch.from_numpy(np.abs(other)), "highest")
    for b in ell.rows_side.buckets:
        idx = torch.from_numpy(b.idx.astype(np.int64))
        G, r = ta._gram_and_rhs(idx, torch.from_numpy(b.val), tables, b, k,
                                precision)
        Gt, rt = ta._gram_and_rhs(idx, torch.from_numpy(np.abs(b.val)),
                                  abs_tables, b, k)    # Σ|terms|
        assert G.dtype == r.dtype == torch.float32
        if precision == "highest":
            Gj, rj = _jax_gram(b, other, b.val)
        elif precision == "default":
            Gj, rj = _jax_gram(b, _bf16(other), _bf16(b.val))
        else:
            (oh, ol), (vh, vl) = _split(other), _split(b.val)
            Gf, rf = _jax_gram(b, oh + ol, vh + vl)
            Gl, rl = _jax_gram(b, ol, vl)
            Gj, rj = Gf - Gl, rf - rl
        for got, want, terms in ((G, Gj, Gt), (r, rj, rt)):
            err = np.abs(got.numpy() - want)
            bar = atol + rtol * np.abs(want) + b.E * 2.0 ** -24 * \
                terms.numpy()
            assert (err <= bar).all(), (precision, b.E, float(err.max()))


def test_split_and_padding():
    """hi + lo holds x to about 16 bits, hi and lo are bf16 values, and the
    tables' pad columns and zero row are exactly 0."""
    x = np.random.default_rng(3).standard_normal((50, 9)).astype(np.float32)
    hi, lo = ta.gram_tables(torch.from_numpy(x), "high")
    assert hi.dtype == lo.dtype == torch.bfloat16 and hi.shape == (51, 16)
    s = hi.float() + lo.float()
    np.testing.assert_allclose(s[:50, :9].numpy(), x, rtol=2 ** -15)
    assert not s[50].any() and not s[:, 9:].any()
    (d,) = ta.gram_tables(torch.from_numpy(x), "default")
    assert torch.equal(d, hi)


def test_gram_product_plain_on_cpu():
    """On CPU tensors ``gram_product`` is its plain version: bf16 widened
    to f32 (exact), one f32 bmm, an f32 result."""
    rng = np.random.default_rng(4)
    A = torch.from_numpy(rng.standard_normal((7, 33, 16)).astype(
        np.float32)).to(torch.bfloat16)
    G = ta.gram_product(A, A)
    assert G.dtype == torch.float32
    want = np.einsum("sea,seb->sab", A.float().numpy().astype(np.float64),
                     A.float().numpy().astype(np.float64))
    np.testing.assert_allclose(G.numpy(), want, rtol=1e-6, atol=1e-5)
    assert torch.equal(G, ta.gram_product_plain(A, A))


def _run(precision, **kw):
    R, T = _small()
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0, entity_major=True)
    cfg = Config(solver="als", k=K, maxiter=3, lambda_=0.1,
                 als_precision=precision, **kw)
    return ta.als_ell_train(R, W0.copy(), H0.copy(), T, cfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _runs():
    return {p: _run(p) for p in ("highest", "high", "default")}


def test_default_tracks_numpy_reference():
    """tests/test_compiled_solvers.py:146-155 on the port, with the bf16
    rounding that XLA on the CPU does not do."""
    R, T = _small()
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0, entity_major=True)
    stats_r = als_reference(R, W0.copy(), H0.copy(), T, lambda_=0.1,
                            maxiter=3)
    W, H, stats = _runs()["default"]
    assert np.isfinite(W).all() and np.isfinite(H).all()
    assert len(stats) == len(stats_r) == 3
    for a, b in zip(stats, stats_r):
        assert abs(a.rmse - b.rmse) < 0.01


def test_high_tracks_highest():
    runs = _runs()
    for a, b in zip(runs["high"][2], runs["highest"][2]):
        assert abs(a.rmse - b.rmse) < 1e-3
    # the bf16 passes do round: the three runs differ
    assert not np.array_equal(runs["high"][0], runs["highest"][0])
    assert not np.array_equal(runs["default"][0], runs["high"][0])


def test_highest_unchanged_by_bf16_runs():
    """No process-wide matmul flag leaks: "highest" after a "default" run
    is bit-equal to "highest" before it, and the flags are as they were."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    before = _run("highest")
    _run("default")
    _run("high")
    after = _run("highest")
    for a, b in zip(before[:2], after[:2]):
        assert np.array_equal(a.view(np.int32), b.view(np.int32))
    assert [s.rmse for s in before[2]] == [s.rmse for s in after[2]]
    assert flags == (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32,
                     torch.get_float32_matmul_precision())


@pytest.mark.parametrize("precision", ["high", "default"])
def test_train_reports_precision(tmp_path, precision):
    """train() runs the precision and reports it in the ``als_plan``
    event; the K5 launches of the plan count per precision."""
    R, T = _small()
    path = str(tmp_path / "m.jsonl")
    log = MetricsLog(path, echo=False)
    res = train(Config(solver="als", k=4, maxiter=2,
                       als_precision=precision), R, T, device="cpu",
                log=log)
    log.close()
    with open(path) as f:
        plan = [e for e in map(json.loads, f) if e["kind"] == "als_plan"]
    assert plan[0]["precision"] == precision
    assert plan[0]["k5_launches_per_iter"] == sum(
        sum(s["groups"]) for s in plan[0]["sides"].values())
    assert np.isfinite(res.W).all() and len(res.stats) == 2


def test_row_groups_count_the_precision_temps():
    """The group budget counts each precision's true temps: bf16 tiles of
    the padded width, and for "high" two tiles and two grams a row."""
    L, p, k = 256, 1, 40
    c = 48
    assert ta._row_bytes(L, p, k, "highest") == (
        L * 41 + 41 * 41 + 40) * 4
    assert ta._row_bytes(L, p, k, "default") == L * c * 2 + c * c * 4 + 160
    assert ta._row_bytes(L, p, k, "high") == 2 * (L * c * 2 + c * c * 4) \
        + 160
    per_row = ta._row_bytes(L, p, k, "high")
    gs = ta._row_groups(1000, L, p, k, per_row * 300, "high")
    assert len(gs) == 4 and all(r1 - r0 <= 300 for r0, r1 in gs)


@pytest.mark.parametrize("bad", ["medium", "HIGHEST", ""])
def test_invalid_precision_raises(bad):
    with pytest.raises(ValueError, match="als_precision"):
        Config(solver="als", als_precision=bad)
    R, _ = _small()
    ell = tell.build_ell_pair(R, min_width=8)
    with pytest.raises(ValueError, match="als_precision"):
        ta.make_als_outer_step(ell, 0.1, precision=bad)


def test_sharded_high_equals_sharded_default(tmp_path):
    """4 gloo ranks: the sharded "high" is the sharded "default" bit for
    bit (the JAX package's sharded step maps "high" to DEFAULT), and both
    stay within the sharded ALS bar (golden_compare atol 1e-4, RMSE within
    1e-4) of the single-device "default" run."""
    cases = [dict(name=f"als_{p}", kind="solve", mesh=4, data=SMALL,
                  cfg=dict(solver="als", k=K, maxiter=3, lambda_=0.1,
                           backend="ell", als_precision=p))
             for p in ("high", "default")]
    with open(tmp_path / "cases.json", "w") as f:
        json.dump(cases, f)
    res = run_ranks(["-m", "cuda_recommender_tpu_torch.parallel.run_cases",
                     str(tmp_path / "cases.json"), str(tmp_path), "--device",
                     "cpu"], 4, timeout=300, cwd=ROOT,
                    env={"OMP_NUM_THREADS": "2"})
    for rank, (rc, text) in enumerate(res):
        assert rc == 0, f"rank {rank} exited {rc}:\n{text}"
    hi, de = (np.load(tmp_path / f"als_{p}.npz") for p in ("high", "default"))
    for key in ("W", "H"):
        assert np.array_equal(hi[key].view(np.int32), de[key].view(np.int32))
    assert np.array_equal(hi["rmse"], de["rmse"])
    W1, H1, s1 = _runs()["default"]
    assert golden_compare(de["W"], W1, atol=1e-4).passed
    assert golden_compare(de["H"], H1, atol=1e-4).passed
    for a, b in zip(de["rmse"], s1):
        assert abs(a - b.rmse) < 1e-4
