"""The benchmark's generator against the port's ``data/datasets.py::
synthetic`` semantics, on the CPU at small sizes."""

import numpy as np
import pytest

from benchmark import datagen
from cuda_recommender_tpu_torch.data.datasets import synthetic

MIX = dict(rows=2000, cols=500, train_nnz=40_000, test_share=0.02,
           user_zipf=0.8, item_zipf=0.9, truth_rank=8, noise=0.1, offset=3.5,
           structure_seed=3)
#: the top-entity rating shares of the two generators may differ by this
#: much (absolute) at MIX's size: draws of one law, not one stream
SKEW_TOL = 0.03


def degree_shares(ids, size, tops=(0.001, 0.01, 0.1)):
    """Share of the ratings held by the top fraction of entities by
    degree, for each fraction in ``tops``."""
    deg = np.sort(np.bincount(ids, minlength=size))[::-1]
    total = max(1, int(deg.sum()))
    return [float(deg[:max(1, int(size * t))].sum()) / total for t in tops]


def _keys(d):
    r = np.concatenate([d.train[0], d.test[0]]).astype(np.int64)
    c = np.concatenate([d.train[1], d.test[1]]).astype(np.int64)
    return r * d.cols + c


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11])
def test_exact_nnz_no_duplicates(seed):
    d = datagen.generate(MIX, seed, "cpu")
    total, held = datagen.counts(MIX["train_nnz"], MIX["test_share"])
    assert d.train_nnz == MIX["train_nnz"] == total - held
    assert d.test[0].shape[0] == held
    keys = _keys(d)
    assert np.unique(keys).shape[0] == keys.shape[0] == total
    assert d.train[0].dtype == np.int32 and d.train[2].dtype == np.float32


def test_same_seed_same_output_other_seed_other():
    a = datagen.generate(MIX, 5, "cpu")
    b = datagen.generate(MIX, 5, "cpu")
    c = datagen.generate(MIX, 6, "cpu")
    for x, y in zip(a.train + a.test, b.train + b.test):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(_keys(a), _keys(c))


def test_every_seed_has_the_same_degrees():
    a = datagen.generate(MIX, 5, "cpu")
    b = datagen.generate(MIX, 2 ** 31 + 99, "cpu")
    for side, size in ((0, MIX["rows"]), (1, MIX["cols"])):
        for part in ("train", "test"):
            da = np.sort(np.bincount(getattr(a, part)[side], minlength=size))
            db = np.sort(np.bincount(getattr(b, part)[side], minlength=size))
            np.testing.assert_array_equal(da, db)
    assert not np.array_equal(a.train[0], b.train[0])
    assert not np.array_equal(a.train[2], b.train[2])


def test_degree_skew_matches_synthetic():
    d = datagen.generate(MIX, 3, "cpu")
    R, _ = synthetic(MIX["rows"], MIX["cols"], MIX["train_nnz"], seed=3,
                     test_fraction=MIX["test_share"])
    mine_u = degree_shares(d.train[0], MIX["rows"])
    mine_i = degree_shares(d.train[1], MIX["cols"])
    theirs_u = degree_shares(
        np.repeat(np.arange(R.rows), R.row_nnz), R.rows)
    theirs_i = degree_shares(R.csr_idx, R.cols)
    np.testing.assert_allclose(mine_u, theirs_u, atol=SKEW_TOL)
    np.testing.assert_allclose(mine_i, theirs_i, atol=SKEW_TOL)
    assert mine_i[2] > mine_u[2]          # items are the more skewed side


def test_held_out_share_and_values():
    d = datagen.generate(MIX, 9, "cpu")
    held = d.test[0].shape[0] / (d.test[0].shape[0] + d.train_nnz)
    assert abs(held - MIX["test_share"]) < 1e-4
    v = np.concatenate([d.train[2], d.test[2]])
    # rank-8 truth of N(0, 1/8) entries: var 8 * (1/8)^2 = 1/8, + noise
    assert abs(v.mean() - MIX["offset"]) < 0.02
    assert abs(v.var() - (1 / 8 + MIX["noise"] ** 2)) < 0.02


def test_too_many_pairs_raise():
    with pytest.raises(ValueError):
        datagen.generate(dict(MIX, rows=10, cols=10), 0, "cpu")
