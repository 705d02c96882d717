"""Port host layer and ELL tail ops against the JAX package.

The port copies the JAX package's NumPy host layer (it cannot import it:
that package's import pulls in jax), so every host result must be
bit-identical: synthetic data, factor init, the dual CSR+CSC build, the ELL
layout and the hybrid plan are compared with ``np.array_equal``. The ELL
tail ops are plain torch in the port and XLA in the JAX package (jitted
here, as the JAX solvers run them); they are held at rtol 1e-6 (f32, same
operation order up to summation).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_recommender_tpu.core.config import Config as JConfig
from cuda_recommender_tpu.core.init import init_factors_np as j_init
from cuda_recommender_tpu.data import datasets as jds
from cuda_recommender_tpu.data.ell import build_ell_pair as j_build_ell
from cuda_recommender_tpu.data.sparse import from_coo as j_from_coo
from cuda_recommender_tpu.ops import ell_ops as jops
from cuda_recommender_tpu.solvers.ccd_hybrid import plan_hybrid as j_plan
from cuda_recommender_tpu_torch.core.config import Config
from cuda_recommender_tpu_torch.core.init import init_factors_np
from cuda_recommender_tpu_torch.data import datasets
from cuda_recommender_tpu_torch.data.ell import build_ell_pair
from cuda_recommender_tpu_torch.data.groupsort import stable_perm
from cuda_recommender_tpu_torch.data.sparse import from_coo
from cuda_recommender_tpu_torch.ops import ell_ops
from cuda_recommender_tpu_torch.solvers.ccd_hybrid import plan_hybrid


def _assert_same(a, b, path="x"):
    """Recursive structural equality: arrays bit-equal, scalars equal."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype, path
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.mark.parametrize("spec", [
    dict(m=300, n=120, nnz=6000, seed=7),
    dict(m=40, n=25, nnz=400, seed=3, power_law=False),
    dict(m=30, n=20, nnz=900, seed=1),            # nnz > m*n: capped
])
def test_synthetic_identical(spec):
    Rj, Tj = jds.synthetic(**spec)
    Rt, Tt = datasets.synthetic(**spec)
    _assert_same(Rt, Rj)
    _assert_same(Tt, Tj)


def test_synthetic_spec_and_cache(tmp_path):
    Rj, Tj = jds.synthetic_from_spec("synthetic:m=50,n=30,nnz=500,seed=2,"
                                     "noise=0.2")
    Rt, Tt = datasets.synthetic_from_spec("synthetic:m=50,n=30,nnz=500,"
                                          "seed=2,noise=0.2")
    _assert_same(Rt, Rj)
    _assert_same(Tt, Tj)
    # first call generates, second loads the cache (CSC order then follows
    # the cached CSR order, in both packages alike)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    for _ in range(2):
        Rc, Tc = datasets.synthetic_cached(50, 30, 500, seed=2,
                                           cache_dir=str(tmp_path / "t"))
        Rj2, Tj2 = jds.synthetic_cached(50, 30, 500, seed=2,
                                        cache_dir=str(tmp_path / "j"))
        _assert_same(Rc, Rj2)
        _assert_same(Tc, Tj2)


@pytest.mark.parametrize("k,m,n,seed", [(1, 7, 5, 0), (10, 300, 120, 3)])
def test_init_identical(k, m, n, seed):
    _assert_same(init_factors_np(k, m, n, seed=seed),
                 j_init(k, m, n, seed=seed))


def test_from_coo_identical_with_duplicates():
    rng = np.random.default_rng(5)
    r = rng.integers(0, 70, 3000)
    c = rng.integers(0, 90, 3000)
    v = rng.normal(size=3000).astype(np.float32)
    _assert_same(from_coo(70, 90, r, c, v), j_from_coo(70, 90, r, c, v))


@pytest.mark.parametrize("nkeys", [1, 5, 1 << 16, (1 << 16) + 3, 300_000])
def test_stable_perm_is_stable_argsort(nkeys):
    keys = np.random.default_rng(nkeys).integers(0, nkeys, 50_000)
    keys = keys.astype(np.int32)
    ptr, perm = stable_perm(keys, nkeys)
    assert np.array_equal(perm, np.argsort(keys, kind="stable"))
    assert np.array_equal(ptr, np.concatenate(
        [[0], np.cumsum(np.bincount(keys, minlength=nkeys))]))


@pytest.mark.parametrize("index_space", ["entity", "slot"])
@pytest.mark.parametrize("min_width", [1, 8])
def test_build_ell_pair_identical(small_data, index_space, min_width):
    R, _ = small_data
    Rt, _ = datasets.synthetic(m=300, n=120, nnz=6000, seed=7)
    _assert_same(build_ell_pair(Rt, min_width=min_width,
                                index_space=index_space),
                 j_build_ell(R, min_width=min_width, index_space=index_space))


PLAN_CASES = {
    "hand_stair": dict(hybrid_dense_cells=100 * 120,
                       hybrid_panel_widths=(32, 16)),
    "auto_stair": dict(hybrid_dense_cells=100 * 120,
                       hybrid_panel_widths="auto"),
    "full_budget": dict(hybrid_dense_cells=300 * 120,
                        hybrid_panel_widths=(32,)),
    "zero_budget": dict(hybrid_dense_cells=0, hybrid_panel_widths=()),
}


@pytest.mark.parametrize("materialize", [False, True])
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_hybrid_identical(small_data, case, materialize):
    R, _ = small_data
    Rt, _ = datasets.synthetic(m=300, n=120, nnz=6000, seed=7)
    kw = dict(backend="hybrid", **PLAN_CASES[case])
    pt = plan_hybrid(Rt, Config(**kw), materialize_dense=materialize)
    pj = j_plan(R, JConfig(**kw), materialize_dense=materialize)
    _assert_same(pt, pj)
    assert (len(pt.panels) > 0) == (case != "zero_budget")
    if case == "full_budget":
        assert pt.nnz_light == 0


def _ell_fixture(small_data):
    R, _ = small_data
    ell = build_ell_pair(from_coo(R.rows, R.cols, *R.to_coo()), min_width=8,
                         index_space="entity")
    rng = np.random.default_rng(9)
    return R, ell, rng


@pytest.mark.parametrize("side_name", ["rows_side", "cols_side"])
def test_fused_update_sweep_matches_jax(small_data, side_name):
    R, ell, rng = _ell_fixture(small_data)
    side = getattr(ell, side_name)
    n_other = R.cols if side_name == "rows_side" else R.rows
    T = 3
    table = rng.normal(size=(n_other, T)).astype(np.float32)
    owns = [rng.normal(size=side.n_slots).astype(np.float32)
            for _ in range(2)]
    vals = [b.val.copy() for b in side.buckets]
    idx = [b.idx for b in side.buckets]

    jv, jg, jh = jax.jit(lambda i, v, tab, o: jops.fused_update_sweep(
        i, v, side, jops.extend_zero(tab), owns=o, signs=(-1.0, 1.0),
        sweep_col=2))(tuple(jnp.asarray(i) for i in idx),
                      tuple(jnp.asarray(v) for v in vals), jnp.asarray(table),
                      tuple(jnp.asarray(o) for o in owns))
    tv = [torch.from_numpy(v.copy()) for v in vals]
    tg, th = ell_ops.fused_update_sweep(
        [torch.from_numpy(i.astype(np.int64)) for i in idx], tv, side,
        ell_ops.extend_zero(torch.from_numpy(table)),
        owns=[torch.from_numpy(o) for o in owns], signs=(-1.0, 1.0),
        sweep_col=2)
    for a, b in zip(tv, jv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("side_name", ["rows_side", "cols_side"])
def test_fused_sweep_matches_jax(small_data, side_name):
    R, ell, rng = _ell_fixture(small_data)
    side = getattr(ell, side_name)
    n_other = R.cols if side_name == "rows_side" else R.rows
    table = rng.normal(size=(n_other, 2)).astype(np.float32)
    idx = [b.idx for b in side.buckets]
    vals = [b.val for b in side.buckets]
    jg, jh = jax.jit(lambda i, v, tab: jops.fused_sweep(
        i, v, side, jops.extend_zero(tab), sweep_col=1))(
            tuple(jnp.asarray(i) for i in idx),
            tuple(jnp.asarray(v) for v in vals), jnp.asarray(table))
    tg, th = ell_ops.fused_sweep(
        [torch.from_numpy(i.astype(np.int64)) for i in idx],
        [torch.from_numpy(v) for v in vals], side,
        ell_ops.extend_zero(torch.from_numpy(table)), sweep_col=1)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6,
                               atol=1e-5)


def test_empty_side_gives_zero_partials():
    """A side with no buckets (every entity empty) sweeps to exact zeros."""
    R = from_coo(4, 3, [], [], [])
    ell = build_ell_pair(R, index_space="entity")
    tab = ell_ops.extend_zero(torch.ones(3, 2))
    g, h = ell_ops.fused_sweep([], [], ell.rows_side, tab)
    assert g.shape == (ell.rows_side.n_slots,) and not g.any() and not h.any()
    g, h = ell_ops.fused_update_sweep([], [], ell.rows_side, tab, owns=(),
                                      signs=(), sweep_col=0)
    assert not g.any() and not h.any()


def test_stacked_remap_matches_jax():
    rng = np.random.default_rng(4)
    vecs = [rng.normal(size=57).astype(np.float32) for _ in range(3)]
    idx = rng.integers(0, 58, 400).astype(np.int32)      # 57 = zero slot
    jout = jops.stacked_remap([jnp.asarray(v) for v in vecs],
                              jnp.asarray(idx))
    tout = ell_ops.stacked_remap([torch.from_numpy(v) for v in vecs],
                                 torch.from_numpy(idx.astype(np.int64)))
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert all((t.numpy()[idx == 57] == 0).all() for t in tout)


def test_extend_zero_matches_jax():
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    for a in (x, x[:, 0]):
        np.testing.assert_array_equal(
            ell_ops.extend_zero(torch.from_numpy(a.copy())).numpy(),
            np.asarray(jops.extend_zero(jnp.asarray(a))))


@pytest.fixture(scope="module")
def binary_dataset(tmp_path_factory):
    """tests/test_shard_loader.py's dataset, written by the port (the two
    packages' files are byte-identical, tests/test_torch_io.py)."""
    from cuda_recommender_tpu_torch.data.binfmt import write_binary_dataset
    R, T = datasets.synthetic(m=200, n=90, nnz=4000, seed=3)
    d = tmp_path_factory.mktemp("shard_loader") / "data"
    write_binary_dataset(str(d), R, T)
    return str(d), R


@pytest.mark.parametrize("index_space", ["slot", "entity"])
@pytest.mark.parametrize("shard_ids", [[0, 1, 2, 3], [4, 5, 6, 7]])
def test_shard_loader_identical(binary_dataset, index_space, shard_ids):
    """data/shard_loader.py's range-read fill: the port's blocks, layout
    and read count bit-identical to the JAX package's, and its blocks the
    shards' rows of the port's full shard-uniform build
    (tests/test_shard_loader.py's cases)."""
    from cuda_recommender_tpu.data import shard_loader as jsl
    from cuda_recommender_tpu_torch.data import shard_loader as tsl
    d, R = binary_dataset
    got = tsl.load_local_ell_shards(d, 8, shard_ids, min_width=8,
                                    index_space=index_space)
    _assert_same(got, jsl.load_local_ell_shards(d, 8, shard_ids, min_width=8,
                                                index_space=index_space))
    full = build_ell_pair(R, min_width=8, num_shards=8,
                          index_space=index_space)
    for blocks, side in ((got.rows_blocks, full.rows_side),
                         (got.cols_blocks, full.cols_side)):
        for b_i, b in enumerate(side.buckets):
            for q, s in enumerate(shard_ids):
                sl = slice(s * b.rows_per_shard, (s + 1) * b.rows_per_shard)
                np.testing.assert_array_equal(blocks[b_i][q][0], b.idx[sl])
                np.testing.assert_array_equal(blocks[b_i][q][1], b.val[sl])


@pytest.mark.parametrize("shard_ids", [[0, 1], [2, 3]])
def test_hybrid_shard_loader_identical(tmp_path, shard_ids):
    """The hybrid manifest and the range-read hybrid blocks (panel row
    blocks, the tail's shards) bit-identical to the JAX package's at
    tests/multihost_hybrid_worker.py's sizes, 4 shards."""
    from cuda_recommender_tpu.data import shard_loader as jsl
    from cuda_recommender_tpu_torch.data import shard_loader as tsl
    from cuda_recommender_tpu_torch.data.binfmt import write_binary_dataset
    R, T = datasets.synthetic(m=96, n=48, nnz=1500, seed=7)
    write_binary_dataset(str(tmp_path / "data"), R, T)
    kw = dict(k=4, backend="hybrid", hybrid_dense_cells=24 * 48,
              hybrid_panel_widths=(16,))
    mf = tsl.hybrid_manifest_from_plan(
        plan_hybrid(R, Config(**kw), num_shards=4, materialize_dense=False))
    _assert_same(mf, jsl.hybrid_manifest_from_plan(
        j_plan(jds.synthetic(m=96, n=48, nnz=1500, seed=7)[0], JConfig(**kw),
               num_shards=4, materialize_dense=False)))
    tsl.save_hybrid_manifest(str(tmp_path / "mf.npz"), mf)
    _assert_same(tsl.load_hybrid_manifest(str(tmp_path / "mf.npz")), mf)
    got = tsl.load_local_hybrid_shards(str(tmp_path / "data"), mf, 4,
                                       shard_ids)
    assert got.nnz_read == got.expected_nnz_read
    _assert_same(got, jsl.load_local_hybrid_shards(str(tmp_path / "data"),
                                                   mf, 4, shard_ids))
