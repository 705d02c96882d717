"""Port checkpoint/resume against itself and against the JAX package.

Within the port a resumed run must equal the uninterrupted one bit for bit
on every compiled backend (dense, pallas, hybrid with NaN panels, explicit
masks and the transposed stair, ell, ALS), in the fused and the phase-timed
schedule: the state round-trips exactly (a bf16 residual is widened to f32
on save and cast back on load) and every op on these paths repeats exactly.

Across packages a checkpoint that one package writes must resume in the
other: the checkpoint files have one format, the manifests one meta, and
the payloads one layout (with ``hybrid_panel_kernel`` the JAX package
block-pads the panels; its kernels run in interpret mode here). The
resumed run must match the uninterrupted JAX run at the step tolerance,
rtol 1e-4 / atol 1e-5 (f32); ALS at its own step tolerance, rtol 1e-3 /
atol 1e-4 (tests/test_torch_als.py: the k×k solves amplify summation-order
differences); a bf16 residual at the JAX ``test_bf16_checkpoint_resume``
atol of 1e-3.
"""

import contextlib
import io
import json
import os

import ml_dtypes
import numpy as np
import pytest

from cuda_recommender_tpu.core.checkpoint import Checkpointer as JCheckpointer
from cuda_recommender_tpu.core.config import Config as JConfig
from cuda_recommender_tpu.core.trainer import train as jtrain
from cuda_recommender_tpu_torch import Config, train
from cuda_recommender_tpu_torch.core.checkpoint import Checkpointer
from cuda_recommender_tpu_torch.core.trainer import checkpoint_meta
from cuda_recommender_tpu_torch.data import datasets
from cuda_recommender_tpu_torch.solvers.hybrid_state import (
    BM, BW, padded_panel_shape)

HYB = dict(backend="hybrid", hybrid_dense_cells=50 * 120,
           hybrid_panel_widths=(16,))
KERNEL = dict(HYB, mask_dtype="nan", hybrid_panel_kernel=True)
#: backend -> Config knobs; each runs on the 300 x 120 synthetic set
BACKENDS = {
    "dense": dict(backend="dense"),
    "pallas": dict(backend="pallas"),
    "hybrid_nan": KERNEL,
    "hybrid_mask": HYB,
    "hybrid_int8": dict(HYB, mask_dtype="int8"),
    "hybrid_transposed": dict(KERNEL, hybrid_dense_cells=30 * 300,
                              hybrid_panel_widths=(64,),
                              hybrid_transpose=True),
    "ell": dict(backend="ell"),
    "als": dict(solver="als"),
    "dense_phase": dict(backend="dense", phase_timing=True),
    "hybrid_phase": dict(KERNEL, phase_timing=True),
    "ell_phase": dict(backend="ell", phase_timing=True),
}
#: the cross-package cases: one per compiled backend, and the hybrid's
#: block-padded panel-kernel payloads (a 1100-row set: a panel of more
#: than BM rows pads to a multiple of BM)
CROSS = ("dense", "pallas", "hybrid_mask", "hybrid_transposed", "ell",
         "als", "hybrid_kernel_padded")


@pytest.fixture(scope="module")
def data():
    return datasets.synthetic(m=300, n=120, nnz=6000, seed=7)


@pytest.fixture(scope="module")
def tall():
    return datasets.synthetic(m=1100, n=40, nnz=9000, seed=5)


def _quiet(fn):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn()


def _port(cfg_kw, R, T, **kw):
    return _quiet(lambda: train(Config(**cfg_kw), R, T, device="cpu", **kw))


def _jax(cfg_kw, R, T, **kw):
    return _quiet(lambda: jtrain(JConfig(**cfg_kw), R, T, **kw))


# ---- the Checkpointer (tests/test_checkpoint.py's four cases) ----

def _roundtrip(ck, tmp_path):
    W = np.arange(6, dtype=np.float32).reshape(2, 3)
    H = np.ones((4, 3), np.float32)
    ck.save(1, W=W, H=H, solver="ccd", backend="dense",
            extra={"Rhat": np.zeros((2, 2), np.float32)})
    latest = ck.latest()
    assert latest["oiter"] == 1 and latest["solver"] == "ccd"
    np.testing.assert_array_equal(latest["W"], W)
    assert "Rhat" in latest["extra"]


def _gc(ck, tmp_path):
    for i in range(1, 6):
        ck.save(i, W=np.zeros((1, 1)), H=np.zeros((1, 1)),
                solver="ccd", backend="dense")
    snaps = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert snaps == ["ckpt_000004.npz", "ckpt_000005.npz"]
    assert ck.latest()["oiter"] == 5


def _empty(ck, tmp_path):
    assert ck.latest() is None


def _no_tmp(ck, tmp_path):
    ck.save(3, W=np.zeros((1, 1)), H=np.zeros((1, 1)),
            solver="als", backend="ell")
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


@pytest.mark.parametrize("case", [_roundtrip, _gc, _empty, _no_tmp],
                         ids=["roundtrip", "gc_keeps_last_2", "empty",
                              "no_tmp_leftovers"])
def test_checkpointer(tmp_path, case):
    case(Checkpointer(str(tmp_path), keep=2), tmp_path)


def test_both_packages_write_the_same_checkpoint(tmp_path):
    """The same arrays saved by both packages load to equal keys, dtypes,
    values and manifests; a bfloat16 array is widened to f32 by both."""
    rng = np.random.default_rng(0)
    W = rng.standard_normal((3, 5)).astype(np.float32)
    H = rng.standard_normal((3, 4)).astype(np.float32)
    extra = {"Rd_0": rng.standard_normal((6, 4)).astype(ml_dtypes.bfloat16),
             "vals_r_0": rng.standard_normal((2, 8)).astype(np.float32),
             "idx": np.arange(7, dtype=np.int32)}
    meta = {"k": 3, "num_shards": 1, "hybrid_panel_widths": [16]}
    got = []
    for cls, sub in ((Checkpointer, "port"), (JCheckpointer, "jax")):
        ck = cls(str(tmp_path / sub))
        ck.save(4, W=W, H=H, solver="ccd", backend="hybrid",
                extra=dict(extra), meta=meta)
        with open(tmp_path / sub / "manifest.json") as f:
            got.append((json.load(f), ck.latest()))
    (man_p, lat_p), (man_j, lat_j) = got
    assert man_p == man_j
    assert lat_p["extra"]["Rd_0"].dtype == np.float32
    for key in ("oiter", "solver", "backend", "meta"):
        assert lat_p[key] == lat_j[key]
    for a, b in ((lat_p, lat_j), (lat_p["extra"], lat_j["extra"])):
        keys = [key for key in a if isinstance(a[key], np.ndarray)]
        assert keys == [key for key in b if isinstance(b[key], np.ndarray)]
        for key in keys:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


# ---- resume inside the port: bit for bit ----

@pytest.mark.parametrize("name", sorted(BACKENDS))
def test_resume_bit_equal(data, tmp_path, name):
    """4 iterations straight vs 2, checkpoint, resume to 4: the same bits,
    and the resumed run reports iterations 3 and 4 only."""
    R, T = data
    base = dict(k=4, lambda_=0.1, **BACKENDS[name])
    full = _port(dict(maxiter=4, **base), R, T)
    ck = str(tmp_path / "ck")
    _port(dict(maxiter=2, checkpoint_dir=ck, checkpoint_every=1, **base),
          R, T)
    resumed = _port(dict(maxiter=4, checkpoint_dir=ck, checkpoint_every=1,
                         **base), R, T, resume_from_checkpoint=True)
    np.testing.assert_array_equal(full.W, resumed.W)
    np.testing.assert_array_equal(full.H, resumed.H)
    assert [s.oiter for s in resumed.stats] == [3, 4]
    assert sorted(os.listdir(ck)) == ["ckpt_000003.npz", "ckpt_000004.npz",
                                      "manifest.json"]


@pytest.mark.parametrize("backend", ["dense", "hybrid"])
def test_bf16_resume(data, tmp_path, backend):
    """A bf16 residual survives the f32 widening on save: the resumed run
    is bit-equal (and within the JAX test's atol 1e-3, a fortiori)."""
    R, T = data
    base = dict(k=4, lambda_=0.1, residual_dtype="bfloat16",
                **(HYB if backend == "hybrid" else dict(backend="dense")))
    full = _port(dict(maxiter=3, **base), R, T)
    ck = str(tmp_path / "ck")
    _port(dict(maxiter=2, checkpoint_dir=ck, checkpoint_every=2, **base),
          R, T)
    with np.load(os.path.join(ck, "ckpt_000002.npz")) as z:
        key = "extra_Rhat" if backend == "dense" else "extra_Rd_0"
        assert z[key].dtype == np.float32
    resumed = _port(dict(maxiter=3, checkpoint_dir=ck, checkpoint_every=2,
                         **base), R, T, resume_from_checkpoint=True)
    np.testing.assert_array_equal(full.W, resumed.W)
    np.testing.assert_array_equal(full.H, resumed.H)


@pytest.mark.parametrize("first,second,match", [
    (dict(backend="dense"), dict(backend="ell"), "incompatible"),
    (dict(solver="als"), dict(backend="ell"), "incompatible"),
    (dict(backend="ell", ell_min_width=8),
     dict(backend="ell", ell_min_width=16), "layout mismatch"),
    (dict(KERNEL), dict(KERNEL, hybrid_panel_kernel=False),
     "hybrid_panel_kernel"),
    (dict(HYB), dict(HYB, hybrid_dense_cells=60 * 120),
     "hybrid_dense_cells"),
    (dict(backend="dense", k=4), dict(backend="dense", k=5), "k: "),
])
def test_resume_mismatch_raises(data, tmp_path, first, second, match):
    """The JAX package's checks: another solver or backend, or another
    layout knob, is a ValueError."""
    R, T = data
    ck = str(tmp_path / "ck")
    _port(dict(dict(k=4, maxiter=1, checkpoint_dir=ck, checkpoint_every=1),
               **first), R, T)
    with pytest.raises(ValueError, match=match):
        _port(dict(dict(k=4, maxiter=2, checkpoint_dir=ck), **second), R, T,
              resume_from_checkpoint=True)


def test_resume_without_dir_raises_and_empty_dir_starts(data, tmp_path):
    R, T = data
    with pytest.raises(ValueError, match="no checkpoint_dir"):
        _port(dict(k=2, maxiter=1, backend="dense"), R, T,
              resume_from_checkpoint=True)
    res = _port(dict(k=2, maxiter=2, backend="dense",
                     checkpoint_dir=str(tmp_path / "ck")), R, T,
                resume_from_checkpoint=True)
    assert [s.oiter for s in res.stats] == [1, 2]


@pytest.mark.parametrize("backend", ["dense", "hybrid", "ell"])
def test_phase_mode_refuses_a_fused_checkpoint(data, tmp_path, backend):
    """A fused-schedule checkpoint holds a pending outer product; phase mode
    refuses it with the JAX package's message."""
    R, T = data
    kw = dict(HYB) if backend == "hybrid" else dict(backend=backend)
    ck = str(tmp_path / "ck")
    _port(dict(k=3, maxiter=1, checkpoint_dir=ck, checkpoint_every=1, **kw),
          R, T)
    with pytest.raises(ValueError, match="fused-schedule checkpoint"):
        _port(dict(k=3, maxiter=2, checkpoint_dir=ck, phase_timing=True,
                   **kw), R, T, resume_from_checkpoint=True)


def test_phase_checkpoint_resumes_fused(data, tmp_path):
    """A phase-mode checkpoint has no pending product, so the fused
    schedule resumes it (the JAX package's note, ccd_dense.py)."""
    R, T = data
    ck = str(tmp_path / "ck")
    _port(dict(k=3, maxiter=2, backend="dense", phase_timing=True,
               checkpoint_dir=ck, checkpoint_every=2), R, T)
    full = _port(dict(k=3, maxiter=3, backend="dense"), R, T)
    res = _port(dict(k=3, maxiter=3, backend="dense", checkpoint_dir=ck),
                R, T, resume_from_checkpoint=True)
    np.testing.assert_allclose(res.W, full.W, atol=1e-5)


def test_checkpoint_lands_on_a_flush(data, tmp_path, monkeypatch):
    """With fused_outer_iters=3 and checkpoint_every=2 the loop flushes at
    iterations 2, 4 (checkpoints) and 5 (the last), and each checkpoint
    holds the state after its own iteration."""
    from cuda_recommender_tpu_torch.solvers import pipeline

    R, T = data
    flushes = []
    real_sync = pipeline.synchronize
    monkeypatch.setattr(pipeline, "synchronize",
                        lambda dev: (flushes.append(1), real_sync(dev)))
    ck = str(tmp_path / "ck")
    base = dict(k=3, lambda_=0.1, backend="dense")
    res = _port(dict(maxiter=5, fused_outer_iters=3, checkpoint_dir=ck,
                     checkpoint_every=2, **base), R, T)
    assert [s.oiter for s in res.stats] == [1, 2, 3, 4, 5]
    assert len(flushes) == 3
    with open(os.path.join(ck, "manifest.json")) as f:
        assert json.load(f)["latest"] == 4
    at4 = _port(dict(maxiter=4, **base), R, T)
    with np.load(os.path.join(ck, "ckpt_000004.npz")) as z:
        np.testing.assert_array_equal(z["W"], at4.W)
    assert sorted(os.listdir(ck)) == ["ckpt_000002.npz", "ckpt_000004.npz",
                                      "manifest.json"]


def test_meta_matches_jax():
    """checkpoint_meta stamps the JAX package's keys and values."""
    from cuda_recommender_tpu.core.trainer import checkpoint_meta as jmeta

    for kw in ({}, dict(backend="ell"), dict(KERNEL),
               dict(backend="hybrid", hybrid_panel_widths="auto"),
               dict(solver="als", als_min_width=16)):
        cfg, jcfg = Config(**kw), JConfig(**kw)
        b = cfg.resolve_backend(300, 120)
        assert checkpoint_meta(cfg, b) == jmeta(
            jcfg, jcfg.resolve_backend(300, 120), None)


def test_padded_panel_shape_matches_jax():
    from cuda_recommender_tpu.ops.panel_pallas import BM as JBM, BW as JBW
    from cuda_recommender_tpu.ops.panel_pallas import (
        padded_panel_shape as jshape)

    assert (BM, BW) == (JBM, JBW)
    for shape in ((1, 1), (7, 40), (512, 2048), (513, 2049), (1100, 40),
                  (330_128, 17_770), (150_061, 4_096)):
        assert padded_panel_shape(*shape) == jshape(*shape)


# ---- across packages ----

def _cross_case(name, data, tall):
    if name == "hybrid_kernel_padded":
        return dict(KERNEL, hybrid_dense_cells=700 * 40), tall
    return BACKENDS[name], data


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("name", CROSS)
def test_checkpoint_resumes_across_packages(data, tall, tmp_path, name,
                                            writer):
    """One package trains 2 iterations and checkpoints, the other resumes
    to 4. From the same state, the resumed run matches the writing
    package's own uninterrupted run (for a JAX checkpoint: the
    uninterrupted JAX run) at the step tolerance; a port checkpoint's
    resumed run also tracks the uninterrupted JAX run's RMSE within 1e-3
    (the run tolerance: the port's and the JAX package's states after 2
    iterations already differ at ULP level, tests/test_torch_hybrid.py).
    The hybrid panel-kernel payloads have the JAX block-padded shapes
    whichever package wrote them."""
    kw, (R, T) = _cross_case(name, data, tall)
    base = dict(k=4, lambda_=0.1, **kw)
    first, then = (_jax, _port) if writer == "jax" else (_port, _jax)
    want = first(dict(maxiter=4, **base), R, T)
    ck = str(tmp_path / "ck")
    first(dict(maxiter=2, checkpoint_dir=ck, checkpoint_every=2, **base),
          R, T)
    if name == "hybrid_kernel_padded":
        with np.load(os.path.join(ck, "ckpt_000002.npz")) as z:
            shapes = [z[f"extra_Rd_{i}"].shape for i in range(2)]
        assert shapes == [(432, 40), (1024, 16)]
        assert shapes[1] != (700 - 432, 16)        # really padded
    got = then(dict(maxiter=4, checkpoint_dir=ck, **base), R, T,
               resume_from_checkpoint=True)
    assert [s.oiter for s in got.stats] == [3, 4]
    tol = (dict(rtol=1e-3, atol=1e-4) if name == "als"
           else dict(rtol=1e-4, atol=1e-5))
    np.testing.assert_allclose(got.W, want.W, **tol)
    np.testing.assert_allclose(got.H, want.H, **tol)
    if writer == "port":
        jax_full = _jax(dict(maxiter=4, **base), R, T)
        for a, b in zip(got.stats, jax_full.stats[2:]):
            assert abs(a.rmse - b.rmse) < 1e-3


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bf16_checkpoint_resumes_across_packages(data, tmp_path, writer):
    """The JAX package's test_bf16_checkpoint_resume across packages, on the
    pallas backend (the schedule the port's bf16 dense path follows; the
    JAX dense step rounds twice, ccd_dense.py): a widened bf16 residual,
    zero-padded to the JAX pallas blocks, resumes in the other package
    within atol 1e-3 of the writing package's uninterrupted run."""
    R, T = data
    base = dict(k=4, lambda_=0.1, backend="pallas",
                residual_dtype="bfloat16")
    first, then = (_jax, _port) if writer == "jax" else (_port, _jax)
    want = first(dict(maxiter=3, **base), R, T)
    ck = str(tmp_path / "ck")
    first(dict(maxiter=2, checkpoint_dir=ck, checkpoint_every=2, **base),
          R, T)
    with np.load(os.path.join(ck, "ckpt_000002.npz")) as z:
        assert z["extra_Rhat"].shape == (512, 512)
        assert z["extra_Rhat"].dtype == np.float32
    got = then(dict(maxiter=3, checkpoint_dir=ck, **base), R, T,
               resume_from_checkpoint=True)
    np.testing.assert_allclose(got.W, want.W, atol=1e-3)
    np.testing.assert_allclose(got.H, want.H, atol=1e-3)
