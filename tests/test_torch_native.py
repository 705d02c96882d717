"""The port's native host helpers (cuda_recommender_tpu_torch/native) against
their NumPy paths and the JAX package's native helpers, and the port's
``utils/timing``.

The C++ sources are the JAX package's, line for line (one comment line
of each cites the reference's files as the port's other files do). Every
helper's
output is held byte-equal (arrays equal in dtype and bits) to the port's
NumPy path and to the JAX package's native output on the same input:
text parsing (1- and 0-based), the counting sort at key widths of at most
and more than 16 bits, the CSR+CSC build, and the ELL fill of a 4-shard
pair. ``numpy_only()`` and a missing toolchain take the NumPy paths, and
each call records the path it took.
"""

import filecmp
import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from cuda_recommender_tpu import native as jnative
from cuda_recommender_tpu.data import datasets as jdatasets
from cuda_recommender_tpu.data import ell as jell
from cuda_recommender_tpu.data.sparse import from_coo as j_from_coo
from cuda_recommender_tpu.native import groupsort as jgroupsort
from cuda_recommender_tpu.native import textparse as jtextparse
from cuda_recommender_tpu_torch import native
from cuda_recommender_tpu_torch.cli import convert
from cuda_recommender_tpu_torch.data import datasets
from cuda_recommender_tpu_torch.data import ell as tell
from cuda_recommender_tpu_torch.data import groupsort as numpy_path
from cuda_recommender_tpu_torch.data.sparse import from_coo
from cuda_recommender_tpu_torch.native import groupsort, textparse
from cuda_recommender_tpu_torch.utils import timing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = ("textparse.cpp", "groupsort.cpp", "ellfill.cpp")



def _same(a: np.ndarray, b: np.ndarray) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.fixture(autouse=True)
def _counts():
    native.reset_path_counts()
    yield


def test_native_builds_here():
    """g++ with OpenMP is on this machine: the library builds into the
    package's gitignored _build/, named by the sources' hash."""
    assert native.available()
    so = native.library_path()
    assert os.path.exists(so)
    assert os.path.dirname(so) == os.path.join(
        ROOT, "cuda_recommender_tpu_torch", "_build")
    out = subprocess.run(
        [sys.executable, "-m", "cuda_recommender_tpu_torch.native.build"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == so


@pytest.mark.parametrize("name", SRC)
def test_sources_are_the_jax_packages(name):
    """Line for line the JAX package's source; only comment lines may
    differ (three cite the reference's files as the port's other files
    do)."""
    def lines(pkg):
        with open(os.path.join(ROOT, pkg, "native/src", name)) as f:
            return f.read().splitlines()

    jax_src, port_src = (lines(pkg) for pkg in (
        "cuda_recommender_tpu", "cuda_recommender_tpu_torch"))
    assert len(port_src) == len(jax_src)
    for a, b in zip(port_src, jax_src):
        assert a == b or (a.startswith("//") and b.startswith("//"))
    assert sum(a != b for a, b in zip(port_src, jax_src)) <= 1


def _ratings(path, rng, n=500, base=1):
    """user item rating [ts] lines: half-star ratings and a few longer
    decimals, a blank line, and lines with a timestamp."""
    u = rng.integers(base, 60 + base, n)
    i = rng.integers(base, 40 + base, n)
    v = rng.integers(1, 11, n) / 2
    v[::7] = np.round(rng.uniform(0, 5, v[::7].size), 4)
    lines = [f"{a} {b} {c}" + (f" {978300760 + j}" if j % 3 == 0 else "")
             for j, (a, b, c) in enumerate(zip(u, i, v))]
    lines.insert(10, "")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("one_based", [True, False])
def test_textparse_matches_numpy_and_jax(tmp_path, one_based):
    path = _ratings(tmp_path / "r.txt", np.random.default_rng(1),
                    base=int(one_based))
    got = textparse.load_text_ratings(path, one_based=one_based)
    want = datasets.load_text_ratings(path, one_based=one_based)
    jax_native = jtextparse.load_text_ratings(path, one_based=one_based)
    for g, w, j in zip(got, want, jax_native):
        assert _same(g, w) and _same(g, j)
    assert got[0].min() == 0


def test_textparse_unreadable_file_raises(tmp_path):
    with pytest.raises(OSError):
        textparse.load_text_ratings(str(tmp_path / "missing.txt"))


@pytest.mark.parametrize("nkeys", [1, 11, 4813, 1 << 16, (1 << 16) + 3,
                                   300_000])
def test_groupsort_matches_numpy_and_jax(nkeys):
    """Key widths of at most 16 bits and above (the NumPy path's one or
    two radix passes); sizes above the native threshold, and one below it
    (the NumPy path either way)."""
    rng = np.random.default_rng(nkeys)
    for nnz in (200_000, 37):
        keys = rng.integers(0, nkeys, nnz).astype(np.int32)
        idx = rng.integers(0, 99, nnz).astype(np.int32)
        val = rng.standard_normal(nnz).astype(np.float32)
        native.reset_path_counts()
        counts = groupsort.key_count(keys, nkeys)
        ptr, perm = groupsort.stable_perm(keys, nkeys)
        gi, gv = groupsort.perm_gather(perm, idx, val)
        path = "native" if nnz >= groupsort._NATIVE_MIN else "numpy"
        assert native.path_counts()["groupsort"][path] == 3
        assert _same(counts, numpy_path.key_count(keys, nkeys))
        assert _same(counts, jgroupsort.key_count(keys, nkeys))
        for got, want in zip((ptr, perm),
                             numpy_path.stable_perm(keys, nkeys)):
            assert _same(got, want)
        for got, want in zip((ptr, perm),
                             jgroupsort.stable_perm(keys, nkeys)):
            assert _same(got, want)
        assert _same(perm, np.argsort(keys, kind="stable").astype(np.int64))
        for got, want in zip((gi, gv),
                             numpy_path.perm_gather(perm, idx, val)):
            assert _same(got, want)
        for got, want in zip((gi, gv), jgroupsort.perm_gather(perm, idx,
                                                               val)):
            assert _same(got, want)


def _coo(seed=3, nnz=70_000, m=301, n=57):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, m, nnz).astype(np.int32)
    c = rng.integers(0, n, nnz).astype(np.int32)
    v = rng.standard_normal(nnz).astype(np.float32)
    r[10:20], c[10:20] = r[0], c[0]          # duplicates, kept, not merged
    return m, n, r, c, v


FIELDS = ("csr_ptr", "csr_idx", "csr_val", "csc_ptr", "csc_idx", "csc_val")


def test_from_coo_native_matches_numpy_and_jax():
    m, n, r, c, v = _coo()
    A = from_coo(m, n, r, c, v)
    assert native.path_counts()["groupsort"]["native"] == 4
    with native.numpy_only():
        B = from_coo(m, n, r, c, v)
    assert native.path_counts()["groupsort"]["numpy"] == 4
    J = j_from_coo(m, n, r, c, v)
    for f in FIELDS:
        assert _same(getattr(A, f), getattr(B, f))
        assert _same(getattr(A, f), getattr(J, f))


def _assert_pairs_equal(a, b):
    for sa, sb in ((a.rows_side, b.rows_side), (a.cols_side, b.cols_side)):
        assert len(sa.buckets) == len(sb.buckets) and sa.buckets
        for x, y in zip(sa.buckets, sb.buckets):
            assert _same(x.idx, y.idx) and _same(x.val, y.val)
        assert sa.other_zero_slot == sb.other_zero_slot


@pytest.mark.parametrize("index_space", ["slot", "entity"])
def test_ell_fill_native_matches_vectorized_and_jax(index_space):
    """build_ell_pair on a 4-shard pair: the native fill against the
    vectorized NumPy fill and the JAX package's (native) fill."""
    R, _ = datasets.synthetic(m=300, n=120, nnz=6000, seed=7)
    pair = tell.build_ell_pair(R, min_width=8, num_shards=4,
                               index_space=index_space)
    assert native.path_counts()["ellfill"] == {"native": 2, "numpy": 0}
    with native.numpy_only():
        vec = tell.build_ell_pair(R, min_width=8, num_shards=4,
                                  index_space=index_space)
    assert native.path_counts()["ellfill"] == {"native": 2, "numpy": 2}
    _assert_pairs_equal(pair, vec)
    assert jnative.available()
    Rj, _ = jdatasets.synthetic(m=300, n=120, nnz=6000, seed=7)
    _assert_pairs_equal(pair, jell.build_ell_pair(
        Rj, min_width=8, num_shards=4, index_space=index_space))


def test_fill_bucket_refuses_wrong_arrays():
    from cuda_recommender_tpu_torch.native.ellfill import fill_bucket

    ptr = np.array([0, 2], np.int64)
    ok = dict(ptr=ptr, nbr_idx=np.zeros(2, np.int32),
              nbr_val=np.zeros(2, np.float32),
              other_slot=np.zeros(1, np.int32),
              grid=np.zeros((1, 1), np.int64), E=2, p=1, rows_per_shard=1,
              L_lanes=2, zero_slot=0, out_idx=np.zeros((1, 2), np.int32),
              out_val=np.zeros((1, 2), np.float32))
    fill_bucket(**ok)
    with pytest.raises(ValueError, match="dtypes"):
        fill_bucket(**dict(ok, ptr=ptr.astype(np.int32)))
    with pytest.raises(ValueError, match="do not hold"):
        fill_bucket(**dict(ok, out_idx=np.zeros((1, 1), np.int32)))


def test_no_toolchain_takes_numpy_paths(monkeypatch, tmp_path):
    """A host without g++: the library does not build, ``available()`` is
    False, and every user takes and records its NumPy path with the same
    bytes."""
    def no_gxx(verbose=False):
        raise FileNotFoundError("g++")

    m, n, r, c, v = _coo()
    want = from_coo(m, n, r, c, v)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build_library", no_gxx)
    assert not native.available()
    native.reset_path_counts()
    got = from_coo(m, n, r, c, v)
    for f in FIELDS:
        assert _same(getattr(got, f), getattr(want, f))
    path = _ratings(tmp_path / "r.txt", np.random.default_rng(2))
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert convert.main([path, str(tmp_path / "ds")]) == 0
    assert "[info] parsed with NumPy fallback" in buf.getvalue()
    counts = native.path_counts()
    assert counts["groupsort"] == {"native": 0, "numpy": 8}
    assert counts["textparse"] == {"native": 0, "numpy": 1}


def test_convert_native_and_numpy_write_the_same_files(tmp_path):
    path = _ratings(tmp_path / "r.txt", np.random.default_rng(5))
    outs = {}
    for name, ctx in (("native", None), ("numpy", native.numpy_only())):
        buf = io.StringIO()
        with redirect_stdout(buf):
            if ctx is None:
                rc = convert.main([path, str(tmp_path / name)])
            else:
                with ctx:
                    rc = convert.main([path, str(tmp_path / name)])
        assert rc == 0
        outs[name] = buf.getvalue().splitlines()[0]
    assert outs == {"native": "[info] parsed with native C++ parser",
                    "numpy": "[info] parsed with NumPy fallback"}
    assert native.path_counts()["textparse"] == {"native": 1, "numpy": 1}
    files = sorted(os.listdir(tmp_path / "native"))
    assert files == sorted(os.listdir(tmp_path / "numpy")) and files
    for f in files:
        assert filecmp.cmp(tmp_path / "native" / f, tmp_path / "numpy" / f,
                           shallow=False)


# ------------------------------------------------------------ utils/timing

def test_timeit_and_sync():
    calls = []

    def fn(x):
        calls.append(1)
        return {"out": (x @ x, None)}

    t = timing.timeit(fn, torch.randn(32, 32), iters=3, warmup=2)
    assert t >= 0.0 and len(calls) == 5
    timing.sync(None)
    timing.sync([1, {"a": torch.zeros(2)}])


def test_profile_trace_writes_a_trace(tmp_path):
    with timing.profile_trace(str(tmp_path)):
        with timing.span("crtpu.step", {"oiter": 1}):
            torch.randn(100) * 2
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert traces
    # the program's spans are what an operator reads in the trace
    with open(tmp_path / traces[0]) as f:
        assert '"crtpu.step"' in f.read()
