"""Port serving path against the JAX package's: pair scoring, score rows,
streaming top-k retrieval (f32, int8, the chunk reduction of ``approx``,
exclusions, all-negative scores, rank-major input, ragged last chunks,
top-k past the catalog), the prediction file, the model artifact and its
registry, recall after the port's own ALS, and the device rule.

Ids are compared by the tie rule: in order where neighbouring scores differ
by more than 1e-5 relative, as sets within a tie (``torch.topk`` promises
no order among tied scores, ``lax.top_k`` puts the lower index first).
Scores: rtol 1e-5, atol 1e-5."""

import re

import numpy as np
import pytest
import torch

from cuda_recommender_tpu.data.binfmt import save_model as jsave_model
from cuda_recommender_tpu.serve import retrieval as jretrieval
from cuda_recommender_tpu.serve import scoring as jscoring
from cuda_recommender_tpu_torch import Config, train
from cuda_recommender_tpu_torch.data import datasets
from cuda_recommender_tpu_torch.data.binfmt import load_model
from cuda_recommender_tpu_torch.eval.ranking import recall_at_k
from cuda_recommender_tpu_torch.models.mf import MFModel, get_train_fn
from cuda_recommender_tpu_torch.serve import retrieval, scoring

RTOL = ATOL = 1e-5


@pytest.fixture(scope="module")
def factors():
    rng = np.random.default_rng(3)
    W = rng.normal(size=(60, 8)).astype(np.float32)
    H = rng.normal(size=(45, 8)).astype(np.float32)
    return W, H


def _tied(a, b):
    return abs(a - b) <= RTOL * max(abs(a), abs(b))


def assert_same_topk(got, want, full, exclude=None):
    """``got`` and ``want`` (scores, ids) of one batch; ``full`` (B, n) f64
    scores of every item. Types and the -1/-inf fill as the JAX package
    returns them; scores within tolerance; ids by the tie rule. A tie group
    that reaches the last slot may continue past it, so there each of the
    port's ids must only be a distinct, not excluded item with that
    score."""
    (gs, gi), (ws, wi) = got, want
    assert gs.dtype == np.float32 and gi.dtype == np.int32
    assert gs.shape == ws.shape and gi.shape == wi.shape
    np.testing.assert_array_equal(gi < 0, wi < 0)
    np.testing.assert_array_equal(np.isneginf(gs), np.isneginf(ws))
    np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=ATOL)
    for b in range(gs.shape[0]):
        filled = int((wi[b] >= 0).sum())
        assert len(set(gi[b, :filled])) == filled
        lo = 0
        while lo < filled:
            hi = lo + 1
            while hi < filled and _tied(ws[b, hi], ws[b, lo]):
                hi += 1
            if hi < filled:
                assert set(gi[b, lo:hi]) == set(wi[b, lo:hi]), (b, lo, hi)
            else:
                for i in gi[b, lo:hi]:
                    assert abs(full[b, i] - ws[b, lo]) <= RTOL * abs(
                        ws[b, lo]) + ATOL
            lo = hi
        if exclude and b in exclude:
            assert not np.isin(gi[b], exclude[b]).any()


# ------------------------------------------------------------ pair scoring

@pytest.mark.parametrize("entity_major", [True, False])
@pytest.mark.parametrize("chunk", [1 << 20, 128])
def test_predict_pairs_matches_jax(factors, entity_major, chunk):
    W, H = factors
    rng = np.random.default_rng(0)
    ui = rng.integers(0, 60, 500)
    ij = rng.integers(0, 45, 500)
    A, B = (W, H) if entity_major else (W.T, H.T)
    got = scoring.predict_pairs(A, B, ui, ij, entity_major=entity_major,
                                chunk=chunk, device="cpu")
    want = jscoring.predict_pairs(A, B, ui, ij, entity_major=entity_major,
                                  chunk=chunk)
    assert got.dtype == np.float32 and got.shape == (500,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.einsum("ek,ek->e", W[ui], H[ij]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("entity_major", [True, False])
def test_score_users_matches_jax(factors, entity_major):
    W, H = factors
    A, B = (W, H) if entity_major else (W.T, H.T)
    got = scoring.score_users(A, B, [0, 7, 59], entity_major=entity_major,
                              device="cpu")
    want = jscoring.score_users(A, B, [0, 7, 59], entity_major=entity_major)
    assert got.dtype == np.float32 and got.shape == (3, 45)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------- top-k

def _case_factors(name, factors):
    W, H = factors
    if name == "negative":                  # every score strongly negative
        return -np.abs(W), np.abs(H)
    if name == "catalog_700":               # a larger catalog, k = 16
        rng = np.random.default_rng(5)
        return (rng.normal(size=(64, 16)).astype(np.float32),
                rng.normal(size=(700, 16)).astype(np.float32))
    return W, H


#: name -> topk_mips keywords (the factors from _case_factors)
TOPK_CASES = {
    "f32": dict(topk=5, chunk=16),
    "int8": dict(topk=5, chunk=16, int8=True),
    "approx": dict(topk=5, chunk=16, approx=True),
    "approx_int8": dict(topk=3, chunk=16, approx=True, int8=True),
    "exclude": dict(topk=4, chunk=16, exclude={0: np.array([3, 9, 12]),
                                               5: np.arange(20)}),
    "exclude_int8": dict(topk=4, chunk=16, int8=True,
                         exclude={2: np.array([1, 2])}),
    "negative": dict(topk=4, chunk=16),
    "negative_exclude": dict(topk=4, chunk=16, exclude={1: np.array([7])}),
    "rank_major": dict(topk=6, chunk=16, entity_major=False),
    "ragged_chunk": dict(topk=7, chunk=13),
    "chunk_past_catalog": dict(topk=5, chunk=2048),
    "topk_past_catalog": dict(topk=60, chunk=16),
    "topk_past_catalog_exclude": dict(topk=50, chunk=16,
                                      exclude={0: np.array([0, 44])}),
    "catalog_700": dict(topk=10, chunk=128),
    "catalog_700_int8_approx": dict(topk=10, chunk=128, int8=True,
                                    approx=True),
}


@pytest.mark.parametrize("name", sorted(TOPK_CASES))
def test_topk_mips_matches_jax(factors, name):
    W, H = _case_factors(name, factors)
    kw = dict(TOPK_CASES[name])
    users = np.arange(12)
    A, B = (W, H) if kw.get("entity_major", True) else (W.T, H.T)
    got = retrieval.topk_mips(A, B, users, device="cpu", **kw)
    want = jretrieval.topk_mips(A, B, users, **kw)
    table = H
    if kw.get("int8"):
        Hq, scale = retrieval.quantize_item_table(H)
        table = Hq.astype(np.float64) * scale[:, None]
    full = W[users].astype(np.float64) @ np.asarray(table, np.float64).T
    assert_same_topk(got, want, full, kw.get("exclude"))
    # every filled slot holds a real item, whatever the sign of the scores
    n = H.shape[0]
    fill = min(kw["topk"], n - max((len(v) for v in kw.get(
        "exclude", {}).values()), default=0))
    assert (got[1][:, :fill] >= 0).all() and (got[1] < n).all()


def test_quantize_item_table_identical():
    rng = np.random.default_rng(5)
    H = rng.normal(size=(300, 16)).astype(np.float32)
    H[7] = 0.0                                   # a zero row: scale 1
    got, want = (retrieval.quantize_item_table(H),
                 jretrieval.quantize_item_table(H))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[1][7] == 1.0


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("int8", [False, True])
def test_topk_mips_device_matches_brute_force(factors, approx, int8):
    """The device functions against the plain oracle the smoke uses: all
    scores U @ H.T, then one torch.topk; int32 ids, running-state fill
    NEG / -1 where topk exceeds the catalog."""
    W, H = factors
    U = torch.from_numpy(W[:9])
    if int8:
        Hq, scale = retrieval.quantize_item_table(H)
        Hq, scale = torch.from_numpy(Hq), torch.from_numpy(scale)
        s, i = retrieval.topk_mips_device_int8(U, Hq, scale, topk=5,
                                               chunk=8, approx=approx)
        full = (U @ Hq.to(torch.float32).T) * scale
    else:
        s, i = retrieval.topk_mips_device(U, torch.from_numpy(H), topk=5,
                                          chunk=8, approx=approx)
        full = U @ torch.from_numpy(H).T
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    ws, wi = torch.topk(full, 5, dim=1)
    np.testing.assert_allclose(s.numpy(), ws.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(i.numpy(), wi.numpy())
    s, i = retrieval.topk_mips_device(U, torch.from_numpy(H[:3]), topk=5,
                                      chunk=2)
    assert (i[:, 3:] == -1).all() and (s[:, 3:] == retrieval.NEG).all()


def test_int8_close_to_f32():
    """tests/test_serve.py::test_int8_retrieval_matches_f32 on the port."""
    rng = np.random.default_rng(5)
    H = rng.normal(size=(700, 16)).astype(np.float32)
    W = rng.normal(size=(64, 16)).astype(np.float32)
    users = np.arange(8)
    s32, i32 = retrieval.topk_mips(W, H, users, topk=10, chunk=128,
                                   device="cpu")
    s8, i8 = retrieval.topk_mips(W, H, users, topk=10, chunk=128, int8=True,
                                 device="cpu")
    assert np.mean([len(np.intersect1d(a, b))
                    for a, b in zip(i32, i8)]) >= 8.0
    for b in range(8):
        m32, m8 = dict(zip(i32[b], s32[b])), dict(zip(i8[b], s8[b]))
        for it in np.intersect1d(i32[b], i8[b]):
            assert abs(m32[it] - m8[it]) < 0.15


# --------------------------------------------------------- prediction file

def test_predict_to_file_matches_jax(factors, tmp_path, capsys):
    W, H = factors
    model = str(tmp_path / "model")
    jsave_model(model, W, H, entity_major=True)
    rng = np.random.default_rng(1)
    lines = [f"{u} {i} {v:.1f}" for u, i, v in zip(
        rng.integers(1, 61, 300), rng.integers(1, 46, 300),
        rng.uniform(1, 5, 300))] + ["60 45 0.0"]
    (tmp_path / "test.txt").write_text("\n".join(lines) + "\n")
    got = scoring.predict_to_file(model, str(tmp_path / "test.txt"),
                                  str(tmp_path / "p.out"), device="cpu")
    out_p = capsys.readouterr().out
    want = jscoring.predict_to_file(model, str(tmp_path / "test.txt"),
                                    str(tmp_path / "j.out"))
    out_j = capsys.readouterr().out
    p_lines = (tmp_path / "p.out").read_text().splitlines()
    j_lines = (tmp_path / "j.out").read_text().splitlines()
    assert len(p_lines) == len(j_lines) == len(lines)
    assert all(re.fullmatch(r"-?\d+\.\d{6}", x) for x in p_lines)
    np.testing.assert_allclose(np.array(p_lines, float),
                               np.array(j_lines, float), rtol=RTOL,
                               atol=ATOL)
    assert abs(got - want) <= 1e-5
    line = re.compile(r"^\[FINAL INFO\] Test RMSE = \d+\.\d{6}\. Calculated "
                      r"in \d+\.\d{6}s$")
    assert line.match(out_p.strip()) and line.match(out_j.strip())


def test_predict_to_file_empty_raises(factors, tmp_path):
    W, H = factors
    jsave_model(str(tmp_path / "m"), W, H, entity_major=True)
    (tmp_path / "t.txt").write_text("")
    with pytest.raises(ValueError, match="empty test file"):
        scoring.predict_to_file(str(tmp_path / "m"), str(tmp_path / "t.txt"),
                                str(tmp_path / "o"), device="cpu")


# ----------------------------------------------------------- model, registry

def test_mfmodel_roundtrip(factors, tmp_path):
    W, H = factors
    m = MFModel.from_factors(W.T, H.T, entity_major=False)   # CCD layout in
    assert m.k == 8 and m.num_users == 60 and m.num_items == 45
    p = str(tmp_path / "m.bin")
    m.save(p)
    m2 = MFModel.load(p)
    np.testing.assert_array_equal(m.W, m2.W)
    np.testing.assert_array_equal(m.H, load_model(p)[1])
    pred = m2.predict([0, 1], [0, 1], device="cpu")
    np.testing.assert_allclose(pred, [W[0] @ H[0], W[1] @ H[1]], atol=1e-5)
    s, i = m2.recommend([0, 3], topk=4, device="cpu")
    want = jretrieval.topk_mips(W, H, [0, 3], topk=4)
    assert_same_topk((s, i), want, W[[0, 3]].astype(np.float64) @ H.T)


def test_recommend_mesh_raises_item_15(factors):
    """``recommend(mesh=...)`` (item 15, now in the port) shards the item
    table over the mesh's ranks: here a world of one rank in this
    process, the same items as the single-device path."""
    from cuda_recommender_tpu_torch.parallel import multihost
    from cuda_recommender_tpu_torch.parallel.mesh import make_mesh
    W, H = factors
    multihost.initialize_local("cpu")
    try:
        got = MFModel(W=W, H=H).recommend([0, 3], topk=4, mesh=make_mesh(1),
                                          device="cpu")
    finally:
        multihost.shutdown()
    want = retrieval.topk_mips(W, H, [0, 3], topk=4, device="cpu")
    assert_same_topk(got, want, W[[0, 3]].astype(np.float64) @ H.T)


@pytest.mark.parametrize("solver,backend,sharded,want", [
    ("als", "auto", False, "solvers.als_ell.als_ell_train"),
    ("als", "ell", False, "solvers.als_ell.als_ell_train"),
    ("ccd", "ref", False, "solvers.reference.ccd_reference"),
    ("ccd", "pallas", False, "solvers.ccd_pallas.ccd_pallas_train"),
    ("ccd", "dense", False, "solvers.ccd_dense.ccd_dense_train"),
    ("ccd", "dense", True, "solvers.ccd_dense.ccd_dense_train"),
    ("ccd", "hybrid", False, "solvers.ccd_hybrid.ccd_hybrid_train"),
    pytest.param("als", "ell", True,
                 "parallel.als_ell_sharded.als_ell_train_sharded",
                 id="als-ell-True-item 15"),
    pytest.param("ccd", "hybrid", True,
                 "parallel.ccd_hybrid_sharded.ccd_hybrid_train_sharded",
                 id="ccd-hybrid-True-item 15"),
    pytest.param("ccd", "ell", True,
                 "parallel.ccd_ell_sharded.ccd_ell_train_sharded",
                 id="ccd-ell-True-item 15"),
    ("ccd", "ell", False, "solvers.ccd_ell.ccd_ell_train"),
    ("ccd", "auto", False, "solvers.ccd_ell.ccd_ell_train"),
])
def test_get_train_fn(solver, backend, sharded, want):
    """The JAX registry's lookup mapped onto the port's trainers (pure ELL,
    item 12, and the sharded trainers, item 15, now in the port: the ELL
    cases look it up and fit); what the port lacks raises
    NotImplementedError naming its ROADMAP.md item."""
    if want.startswith("item"):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md .*{want}"):
            get_train_fn(solver, backend, sharded=sharded)
        return
    fn = get_train_fn(solver, backend, sharded=sharded)
    assert f"{fn.__module__}.{fn.__name__}" == (
        "cuda_recommender_tpu_torch." + want)
    if want.endswith("ccd_ell_train"):          # a working ell fit
        from cuda_recommender_tpu_torch.core.init import init_factors_np
        R, T = datasets.synthetic(m=40, n=25, nnz=400, seed=3)
        W0, H0 = init_factors_np(3, R.rows, R.cols, seed=0)
        W, H, stats = fn(R, W0, H0, T, Config(k=3, maxiter=2,
                                              backend=backend),
                         device="cpu")
        m = MFModel.from_factors(W, H, entity_major=False)
        assert m.W.shape == (40, 3) and np.isfinite(m.H).all()
        assert stats[-1].rmse < stats[0].rmse


def test_mips_recall_after_training():
    """tests/test_serve.py::test_mips_recall_after_training on the port's
    ALS: recall@10 on held-out items beats the random baseline (10/120)."""
    R, T = datasets.synthetic(m=300, n=120, nnz=6000, seed=7)
    res = train(Config(solver="als", k=8, maxiter=5, lambda_=0.1), R, T,
                device="cpu")
    model = MFModel.from_factors(res.W, res.H, entity_major=True)
    users = np.unique(T.row_idx)[:50]
    relevant = [T.col_idx[T.row_idx == u] for u in users]
    exclude = {int(u): R.csr_idx[R.csr_ptr[u]:R.csr_ptr[u + 1]]
               for u in users}
    _, items = retrieval.topk_mips(model.W, model.H, users, topk=10,
                                   chunk=64, exclude=exclude, device="cpu")
    assert recall_at_k(items, relevant) > 0.11


# ------------------------------------------------------------- device rule

def test_cuda_without_gpu_raises(factors, monkeypatch, tmp_path):
    """device='cuda' (every entry point's default) with no GPU is an error,
    never a silent CPU run."""
    from cuda_recommender_tpu_torch.cli import bench_serve, predict
    from cuda_recommender_tpu_torch.serve.engine import RetrievalEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    W, H = factors
    jsave_model(str(tmp_path / "m"), W, H, entity_major=True)
    calls = [
        lambda: scoring.predict_pairs(W, H, [0], [0], entity_major=True),
        lambda: scoring.score_users(W, H, [0], entity_major=True),
        lambda: retrieval.topk_mips(W, H, [0]),
        lambda: RetrievalEngine(W, H),
        lambda: MFModel(W=W, H=H).recommend([0]),
        lambda: predict.main(["topk", str(tmp_path / "m"), "0"]),
        lambda: bench_serve.main(["--dataset", "synthetic:m=30,n=20,nnz=200",
                                  "--random-factors"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="is_available"):
            call()
