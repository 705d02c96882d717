"""Port RetrievalEngine against the JAX package's: the cases of
tests/test_engine.py (oracle, vector queries, rank-major input, exclusions,
top-k past the catalog, int8, vector-only engines, argument checks,
warm-up), each held against the JAX engine on the same query, and the
engine's ids against the port's batch path. Ids by the tie rule, scores
rtol 1e-5 / atol 1e-5 (``tests/test_torch_serve.py``)."""

import numpy as np
import pytest

from cuda_recommender_tpu.serve.engine import RetrievalEngine as JEngine
from cuda_recommender_tpu_torch.serve.engine import RetrievalEngine
from cuda_recommender_tpu_torch.serve.retrieval import (quantize_item_table,
                                                        topk_mips)
from test_torch_serve import assert_same_topk


@pytest.fixture(scope="module")
def factors():
    rng = np.random.default_rng(11)
    W = rng.normal(size=(70, 8)).astype(np.float32)
    H = rng.normal(size=(53, 8)).astype(np.float32)
    return W, H


def _oracle(u, H, topk):
    s = H @ u
    order = np.argsort(-s, kind="stable")[:topk]
    return s[order], order


def _pair(W, H, **kw):
    return (RetrievalEngine(W, H, device="cpu", **kw), JEngine(W, H, **kw))


def _same(got, want, u, table, exclude=None):
    full = (np.asarray(table, np.float64) @ np.asarray(u, np.float64))[None]
    assert_same_topk(tuple(x[None] for x in got),
                     tuple(x[None] for x in want), full,
                     None if exclude is None else {0: exclude})


#: name -> (engine keywords, query keywords); ``user`` picks W's row
ENGINE_CASES = {
    "user_0": ({}, dict(user=0, topk=7)),
    "user_17": ({}, dict(user=17, topk=7)),
    "user_69": ({}, dict(user=69, topk=7)),
    "vector": ({}, dict(u_vec="W5", topk=10)),
    "rank_major": (dict(entity_major=False), dict(user=3, topk=5)),
    "exclude": ({}, dict(user=9, topk=6, exclude=np.array([4, 0, 51, 30]))),
    "topk_past_catalog": ({}, dict(user=0, topk=60)),
    "topk_past_catalog_exclude": ({}, dict(user=2, topk=60,
                                           exclude=np.array([1, 2, 3]))),
    "int8": (dict(int8=True), dict(user=21, topk=5)),
    "int8_exclude": (dict(int8=True), dict(user=21, topk=5,
                                           exclude=np.array([7]))),
    "approx": (dict(approx=True), dict(user=33, topk=8)),
}


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_engine_matches_jax(factors, name):
    W, H = factors
    ekw, qkw = ENGINE_CASES[name]
    qkw = dict(qkw)
    if isinstance(qkw.get("u_vec"), str):
        qkw["u_vec"] = W[5]
    A, B = (W.T, H.T) if ekw.get("entity_major") is False else (W, H)
    eng, jeng = _pair(A, B, **ekw)
    got, want = eng.query(**qkw), jeng.query(**qkw)
    u = qkw["u_vec"] if "u_vec" in qkw else W[qkw["user"]]
    table = H
    if ekw.get("int8"):
        Hq, scale = quantize_item_table(H)
        table = Hq.astype(np.float64) * scale[:, None]
    _same(got, want, u, table, qkw.get("exclude"))
    # and the oracle of tests/test_engine.py, exclusions applied
    ws, wi = _oracle(np.asarray(u, np.float64),
                     np.asarray(table, np.float64), H.shape[0])
    keep = ~np.isin(wi, qkw.get("exclude", []))
    ws, wi = ws[keep][:qkw["topk"]], wi[keep][:qkw["topk"]]
    take = len(wi)
    np.testing.assert_array_equal(got[1][:take], wi)
    np.testing.assert_allclose(got[0][:take], ws, rtol=1e-5, atol=1e-5)
    assert (got[1][take:] == -1).all() and np.isneginf(got[0][take:]).all()


def test_exclusion_overfetch(factors):
    W, H = factors
    eng = RetrievalEngine(W, H, device="cpu")
    base_s, base_i = eng.query(user=9, topk=53)   # full ranking
    excl = base_i[:4]                             # knock out the top 4
    s, i = eng.query(user=9, topk=6, exclude=excl)
    np.testing.assert_array_equal(i, base_i[4:10])
    np.testing.assert_allclose(s, base_s[4:10], atol=1e-6)


def test_topk_exceeds_catalog(factors):
    W, H = factors
    s, i = RetrievalEngine(W, H, device="cpu").query(user=0, topk=60)
    assert (i[:53] >= 0).all() and (i[53:] == -1).all()
    assert np.isneginf(s[53:]).all()
    np.testing.assert_array_equal(np.sort(i[:53]), np.arange(53))
    assert s.dtype == np.float32 and i.dtype == np.int32


@pytest.mark.parametrize("int8", [False, True])
def test_engine_matches_batch_path(factors, int8):
    """One query through the engine against the same user in the port's
    batch path: ids by the tie rule, scores within rounding."""
    W, H = factors
    eng = RetrievalEngine(W, H, int8=int8, device="cpu")
    users = np.arange(0, 70, 7)
    bs, bi = topk_mips(W, H, users, topk=10, chunk=16, int8=int8,
                       device="cpu")
    table = H
    if int8:
        Hq, scale = quantize_item_table(H)
        table = Hq.astype(np.float64) * scale[:, None]
    for b, uid in enumerate(users):
        _same(eng.query(user=int(uid), topk=10), (bs[b], bi[b]), W[uid],
              table)


def test_vector_only_engine(factors):
    _, H = factors
    eng, jeng = _pair(None, H)
    q = np.ones(8, np.float32)
    _same(eng.query(u_vec=q, topk=3), jeng.query(u_vec=q, topk=3), q, H)
    with pytest.raises(ValueError, match="without W"):
        eng.query(user=0, topk=3)
    eng = RetrievalEngine(None, H.T, entity_major=False, device="cpu")
    _same(eng.query(u_vec=q, topk=3), jeng.query(u_vec=q, topk=3), q, H)


@pytest.mark.parametrize("kw,match", [
    (dict(topk=3), "exactly one"),
    (dict(user=0, u_vec="W0", topk=3), "exactly one"),
    (dict(u_vec=np.ones(5, np.float32), topk=3), r"u_vec must be \(8,\)"),
    (dict(user=70, topk=3), "outside"),
    (dict(user=-1, topk=3), "outside"),
])
def test_arg_validation(factors, kw, match):
    W, H = factors
    eng = RetrievalEngine(W, H, device="cpu")
    kw = dict(kw)
    if isinstance(kw.get("u_vec"), str):
        kw["u_vec"] = W[0]
    with pytest.raises(ValueError, match=match):
        eng.query(**kw)


def test_warmup(factors):
    W, H = factors
    eng = RetrievalEngine(W, H, device="cpu")
    eng.warmup(topk=4, exclude_sizes=(2,))
    s, i = eng.query(user=1, topk=4)
    assert i.shape == (4,) and s.shape == (4,)
