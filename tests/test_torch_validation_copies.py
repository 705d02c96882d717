"""The port's copies of the validation layer's host functions against the
JAX package's: ``calrmse_r1_np`` and ``calloss_np`` (eval/metrics.py), the
ml-1m-calibrated fixture ``ml1m_like`` (data/datasets.py) and the Netflix
golden script's ``determination_histogram``. Each is held bit-identical
on NumPy-seeded inputs, as ``tests/test_torch_plan_and_ell.py`` holds the
other copies.

Importing the JAX golden script sets three JAX compilation-cache options
and puts a path first on sys.path; the fixture restores both, as
``tests/test_torch_probes.py``'s does.
"""

import importlib.util
import os
import sys

import jax
import numpy as np
import pytest

from cuda_recommender_tpu.data import datasets as jds
from cuda_recommender_tpu.data.sparse import from_coo as j_from_coo
from cuda_recommender_tpu.data.sparse import make_test as j_make_test
from cuda_recommender_tpu.eval import metrics as jmet
from cuda_recommender_tpu_torch.data import datasets
from cuda_recommender_tpu_torch.data.sparse import from_coo, make_test
from cuda_recommender_tpu_torch.eval import metrics
from cuda_recommender_tpu_torch.scripts import golden_netflix_scale

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_KEYS = ("jax_compilation_cache_dir",
              "jax_persistent_cache_min_entry_size_bytes",
              "jax_persistent_cache_min_compile_time_secs")
SPARSE_FIELDS = ("csr_ptr", "csr_idx", "csr_val", "csc_ptr", "csc_idx",
                 "csc_val", "row_nnz", "col_nnz")
TEST_FIELDS = ("row_idx", "col_idx", "val")


def _coo(rng, m, n, nnz):
    keys = rng.choice(m * n, size=nnz, replace=False)
    return (keys // n, keys % n,
            rng.normal(3.0, 1.0, size=nnz).astype(np.float32))


def _bit_equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), what


@pytest.mark.parametrize("m,n,nnz,seed", [(60, 40, 700, 0), (7, 300, 900, 1)])
def test_calrmse_r1_np_identical(m, n, nnz, seed):
    """The rank-one residual RMSE and the updated residual test values,
    bit for bit, on the same seeded test set and rank-t vectors."""
    rng = np.random.default_rng(seed)
    r, c, v = _coo(rng, m, n, nnz)
    T, Tj = make_test(m, n, r, c, v), j_make_test(m, n, r, c, v)
    vals = rng.normal(size=nnz).astype(np.float32)
    Wt = rng.normal(size=m).astype(np.float32)
    Ht = rng.normal(size=n).astype(np.float32)
    got, got_resid = metrics.calrmse_r1_np(T, vals.copy(), Wt, Ht)
    want, want_resid = jmet.calrmse_r1_np(Tj, vals.copy(), Wt, Ht)
    assert got == want
    _bit_equal(got_resid, want_resid, "residual")


@pytest.mark.parametrize("entity_major", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_calloss_np_identical(entity_major, seed):
    """The squared training loss in both factor layouts (CCD's rank-major
    (k, n), ALS's entity-major (n, k))."""
    rng = np.random.default_rng(seed)
    m, n, k = 80, 50, 6
    r, c, v = _coo(rng, m, n, 1500)
    R, Rj = from_coo(m, n, r, c, v), j_from_coo(m, n, r, c, v)
    shape_w, shape_h = ((m, k), (n, k)) if entity_major else ((k, m), (k, n))
    W = rng.normal(size=shape_w).astype(np.float32)
    H = rng.normal(size=shape_h).astype(np.float32)
    got = metrics.calloss_np(R, W, H, entity_major=entity_major)
    want = jmet.calloss_np(Rj, W, H, entity_major=entity_major)
    assert got == want


@pytest.mark.parametrize("seed", [0, 1])
def test_ml1m_like_identical(seed):
    """The fixture's train matrix (CSR and CSC arrays) and test set are
    bit-identical: the same default_rng draws in the same order (the
    port deduplicates by one sort, the JAX package by np.unique)."""
    R, T = datasets.ml1m_like(seed)
    Rj, Tj = jds.ml1m_like(seed)
    assert (R.rows, R.cols, R.nnz) == (Rj.rows, Rj.cols, Rj.nnz)
    assert (R.rows, R.cols) == (6040, 3706)
    for name in SPARSE_FIELDS:
        _bit_equal(getattr(R, name), getattr(Rj, name), name)
    for name in TEST_FIELDS:
        _bit_equal(getattr(T, name), getattr(Tj, name), name)


@pytest.fixture(scope="module")
def jax_golden_script():
    """The JAX script as a module, loaded from its file with the JAX config
    and sys.path as they were before (its import runs nothing; the JAX
    package it imports is this checkout's, already imported above)."""
    saved = {key: getattr(jax.config, key) for key in CACHE_KEYS}
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_golden_netflix_scale",
            os.path.join(ROOT, "scripts", "golden_netflix_scale.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for key, val in saved.items():
            jax.config.update(key, val)
        sys.path[:] = path
    return mod


def test_golden_script_fixture_restores(jax_golden_script):
    """The script sets these two to -1 and 0 when imported, and its JAX
    package is this checkout's."""
    assert jax.config.jax_persistent_cache_min_entry_size_bytes != -1
    assert jax.config.jax_persistent_cache_min_compile_time_secs != 0
    assert jax_golden_script.ccd_reference.__module__ == \
        "cuda_recommender_tpu.solvers.reference"
    assert sys.modules["cuda_recommender_tpu"].__file__.startswith(ROOT)


@pytest.mark.parametrize("seed", [0, 3])
def test_determination_histogram_identical(seed, jax_golden_script):
    """The failure anatomy of a bf16-like run against its golden factors:
    the same deciles, rates and conditional bar as the JAX script's."""
    jax_script = jax_golden_script
    rng = np.random.default_rng(seed)
    k, n = 8, 500
    G = rng.normal(scale=0.1, size=(k, n)).astype(np.float32)
    A = (G * (1 + rng.normal(scale=0.08, size=(k, n)))
         + rng.normal(scale=1e-3, size=(k, n))).astype(np.float32)
    deg = rng.zipf(1.6, size=n).astype(np.int64)
    got = golden_netflix_scale.determination_histogram(A, G, deg)
    want = jax_script.determination_histogram(A, G, deg)
    assert got == want
    assert 0 < got["conditional_bar"]["fail_rate_overall"] < 1
