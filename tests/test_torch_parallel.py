"""Sharded training of the port on 4 ranks (gloo, the CPU) against the JAX
package's sharded runs on 4 of its 8 virtual CPU devices and the port's
own single-device runs.

One set of 4 ranks (``parallel/launch.py``: subprocesses that import only
the port, the launcher's environment, a free port, every rank killed when
one fails or the time runs out) trains every case of ``CASES`` in turn
(``parallel/run_cases.py``) and writes one npz a case; the parametrised
tests assert on those files, so each case counts. Sizes are the JAX tests'
own: tests/conftest.py's ``small_data`` (300 x 120, 6,000 ratings) and
``tiny_data``, k = 4-5, 2-4 iterations.

Bars (tests/test_sharded.py, tests/test_hybrid_sharded.py): CCD++ W and H
at atol 2e-5, rtol 1e-4 and each iteration's RMSE within 1e-5, against
the port's single-device run and the JAX package's sharded run; ALS
``golden_compare(atol=1e-4)``, JAX's bar. Checkpoints: a sharded resume is
bit-equal to the straight sharded run (gloo's all-reduce adds the ranks'
partials in one fixed order, so the resumed trajectory repeats the
straight one bit for bit; the ELL and ALS paths have no cross-rank sum at
all), and a checkpoint of either package's sharded run resumes in the
other at N = 4 within the CCD bar. Early stop (``eps=0.9``) ends the
sharded ELL run after iteration 2, as it ends the JAX package's.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest

from cuda_recommender_tpu.core.config import Config as JConfig
from cuda_recommender_tpu.core.init import init_factors_np as jinit
from cuda_recommender_tpu.core.metrics_log import MetricsLog as JLog
from cuda_recommender_tpu.core.trainer import train as jtrain
from cuda_recommender_tpu.data import datasets as jdatasets
from cuda_recommender_tpu.parallel import mesh as jmesh
from cuda_recommender_tpu.parallel.als_ell_sharded import (
    als_ell_train_sharded)
from cuda_recommender_tpu.parallel.ccd_ell_sharded import (
    ccd_ell_train_sharded)
from cuda_recommender_tpu.parallel.ccd_hybrid_sharded import (
    ccd_hybrid_train_sharded)
from cuda_recommender_tpu.solvers.ccd_dense import ccd_dense_train as jdense
from cuda_recommender_tpu_torch.core.config import Config
from cuda_recommender_tpu_torch.core.init import init_factors_np
from cuda_recommender_tpu_torch.core.metrics_log import MetricsLog
from cuda_recommender_tpu_torch.core.trainer import solve, train
from cuda_recommender_tpu_torch.data import datasets
from cuda_recommender_tpu_torch.eval.metrics import golden_compare
from cuda_recommender_tpu_torch.parallel.launch import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
SMALL = dict(m=300, n=120, nnz=6000, seed=7)
TINY = dict(m=40, n=25, nnz=400, seed=3, power_law=False)
HYB = dict(k=5, maxiter=3, lambda_=0.1, backend="hybrid")
#: the hybrid checkpoint runs: NaN panels through the panel kernels
HYBK = dict(k=4, lambda_=0.1, backend="hybrid", hybrid_dense_cells=100 * 120,
            hybrid_panel_widths=(32, 16), mask_dtype="nan",
            hybrid_panel_kernel=True)
ELLK = dict(k=4, lambda_=0.1, backend="ell")

#: name -> (data, Config kwargs, mesh): one sharded solve each
SOLVE = {
    "ell_t1": (SMALL, dict(k=5, maxiter=3, maxinneriter=1, lambda_=0.1,
                           backend="ell"), N),
    "ell_t2": (TINY, dict(k=4, maxiter=3, maxinneriter=2, lambda_=0.05,
                          backend="ell"), N),
    # tests/test_early_stop.py::test_early_stop_sharded
    "ell_early_stop": (SMALL, dict(k=4, maxiter=8, lambda_=0.1,
                                   backend="ell", early_stop=True, eps=0.9),
                       N),
    "als": (SMALL, dict(solver="als", k=5, maxiter=3, lambda_=0.1,
                        backend="ell", ell_chunk=256), N),
    "dense_1d": (SMALL, dict(k=5, maxiter=2, maxinneriter=1, lambda_=0.1,
                             backend="dense"), N),
    "dense_2x2": (SMALL, dict(k=5, maxiter=2, maxinneriter=1, lambda_=0.1,
                              backend="dense"), [2, 2]),
    # tests/test_hybrid_sharded.py:17-22
    "hyb_stair_tail": (SMALL, dict(HYB, hybrid_dense_cells=100 * 120,
                                   hybrid_panel_widths=(32, 16)), N),
    "hyb_pure_ell": (SMALL, dict(HYB, hybrid_dense_cells=0,
                                 hybrid_panel_widths=()), N),
    "hyb_all_dense": (SMALL, dict(HYB, hybrid_dense_cells=300 * 120,
                                  hybrid_panel_widths=(32,)), N),
    "hyb_inner2": (SMALL, dict(HYB, maxinneriter=2,
                               hybrid_dense_cells=100 * 120,
                               hybrid_panel_widths=(32,)), N),
    # NaN panels with and without the panel-kernel flag, the explicit mask
    "hyb_nan": (SMALL, dict(HYB, hybrid_dense_cells=100 * 120,
                            hybrid_panel_widths=(32, 16), mask_dtype="nan"),
                N),
    "hyb_nan_kernel": (SMALL, dict(HYB, maxinneriter=2,
                                   hybrid_dense_cells=100 * 120,
                                   hybrid_panel_widths=(32, 16),
                                   mask_dtype="nan",
                                   hybrid_panel_kernel=True), N),
    "hyb_bf16_mask": (SMALL, dict(HYB, hybrid_dense_cells=100 * 120,
                                  hybrid_panel_widths=(32, 16),
                                  mask_dtype="bfloat16"), N),
}
HYBRID = sorted(name for name in SOLVE if name.startswith("hyb"))
#: the sharded phase functions (tests/test_hybrid_sharded.py:115-...)
PHASE = dict(k=5, maxiter=2, maxinneriter=1, lambda_=0.1, backend="hybrid",
             hybrid_dense_cells=100 * 120, hybrid_panel_widths=(32, 16))


def _cfg_json(kw: dict) -> dict:
    return {key: list(v) if isinstance(v, tuple) else v
            for key, v in kw.items()}


def _cases(d) -> list:
    cases = [dict(name=name, kind="solve", mesh=mesh, data=data,
                  cfg=_cfg_json(kw))
             for name, (data, kw, mesh) in SOLVE.items()]
    cases.append(dict(name="phase", kind="phase", mesh=N, data=SMALL,
                      cfg=_cfg_json(dict(PHASE, phase_timing=True))))
    for tag, kw, iters, split in (("hyb", HYBK, 4, 2), ("ell", ELLK, 3, 2)):
        ck = dict(checkpoint_every=split if tag == "ell" else 1)
        cases += [
            dict(name=f"{tag}_straight", kind="train", mesh=N, data=SMALL,
                 cfg=_cfg_json(dict(kw, maxiter=iters))),
            dict(name=f"{tag}_ck", kind="train", mesh=N, data=SMALL,
                 cfg=_cfg_json(dict(kw, maxiter=split,
                                    checkpoint_dir=str(d / f"{tag}_ck"),
                                    **ck))),
            dict(name=f"{tag}_resumed", kind="train", mesh=N, data=SMALL,
                 resume=True,
                 cfg=_cfg_json(dict(kw, maxiter=iters,
                                    checkpoint_dir=str(d / f"{tag}_ck"),
                                    **ck)))]
    cases += [
        # a second 2-iteration checkpoint for the JAX package to resume
        dict(name="hyb_ck_for_jax", kind="train", mesh=N, data=SMALL,
             cfg=_cfg_json(dict(HYBK, maxiter=2, checkpoint_every=2,
                                checkpoint_dir=str(d / "ck_for_jax")))),
        # the JAX package's sharded checkpoint, resumed in the port
        dict(name="hyb_from_jax", kind="train", mesh=N, data=SMALL,
             resume=True,
             cfg=_cfg_json(dict(HYBK, maxiter=4, checkpoint_every=1,
                                checkpoint_dir=str(d / "jax_ck"))))]
    return cases


def _jmesh():
    return jmesh.make_mesh(jax.devices()[:N])


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    """The JAX package writes a sharded 2-iteration checkpoint; then 4
    ranks run every case. Returns the directory of their npz files."""
    d = tmp_path_factory.mktemp("parallel")
    R, T = jdatasets.synthetic(**SMALL)
    jtrain(JConfig(maxiter=2, checkpoint_dir=str(d / "jax_ck"),
                   checkpoint_every=1, **HYBK), R, T, mesh=_jmesh(),
           log=JLog(None, echo=False))
    with open(d / "cases.json", "w") as f:
        json.dump(_cases(d), f)
    res = run_ranks(["-m", "cuda_recommender_tpu_torch.parallel.run_cases",
                     str(d / "cases.json"), str(d), "--device", "cpu"], N,
                    timeout=300, cwd=ROOT, env={"OMP_NUM_THREADS": "2"})
    for rank, (rc, text) in enumerate(res):
        assert rc == 0, f"rank {rank} exited {rc}:\n{text}"
    return d


def _load(out, name):
    return np.load(out / f"{name}.npz")


def _data(spec):
    return datasets.synthetic(**spec)


def _port_single(data, kw):
    R, T = _data(data)
    cfg = Config(**kw)
    W0, H0 = init_factors_np(cfg.k, R.rows, R.cols, seed=0,
                             entity_major=cfg.solver.value == "als")
    return solve(cfg, cfg.resolve_backend(R.rows, R.cols), R, W0, H0, T,
                 device="cpu")


def _jax_sharded(data, kw, mesh):
    R, T = jdatasets.synthetic(**data)
    cfg = JConfig(**kw)
    als = kw.get("solver") == "als"
    W0, H0 = jinit(cfg.k, R.rows, R.cols, seed=0, entity_major=als)
    if als:
        return als_ell_train_sharded(R, W0, H0, T, cfg, _jmesh())
    if kw["backend"] == "ell":
        return ccd_ell_train_sharded(R, W0, H0, T, cfg, _jmesh())
    if kw["backend"] == "hybrid":
        return ccd_hybrid_train_sharded(R, W0, H0, T, cfg, _jmesh())
    if isinstance(mesh, list):
        sh = jmesh.dense_ccd_shardings_2d(
            jmesh.make_mesh_2d(tuple(mesh), jax.devices()[:N]))
    else:
        sh = jmesh.dense_ccd_shardings(_jmesh())
    return jdense(R, W0, H0, T, cfg, shardings=sh)


def _assert_ccd_bar(W, H, rmse, W_ref, H_ref, rmse_ref):
    np.testing.assert_allclose(W, W_ref, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(H, H_ref, atol=2e-5, rtol=1e-4)
    assert len(rmse) == len(rmse_ref)
    for a, b in zip(rmse, rmse_ref):
        assert abs(a - b) < 1e-5


@pytest.mark.parametrize("name", sorted(SOLVE))
def test_sharded_matches_port_single_device(out, name):
    data, kw, _ = SOLVE[name]
    z = _load(out, name)
    W1, H1, s1 = _port_single(data, kw)
    if kw.get("solver") == "als":
        assert golden_compare(z["W"], W1, atol=1e-4).passed
        assert golden_compare(z["H"], H1, atol=1e-4).passed
        for a, b in zip(z["rmse"], s1):
            assert abs(a - b.rmse) < 1e-4
        return
    _assert_ccd_bar(z["W"], z["H"], z["rmse"], W1, H1, [s.rmse for s in s1])


@pytest.mark.parametrize("name", sorted(SOLVE))
def test_sharded_matches_jax_sharded(out, name):
    data, kw, mesh = SOLVE[name]
    z = _load(out, name)
    Wj, Hj, sj = _jax_sharded(data, kw, mesh)
    if kw.get("solver") == "als":
        assert golden_compare(z["W"], np.asarray(Wj), atol=1e-4).passed
        assert golden_compare(z["H"], np.asarray(Hj), atol=1e-4).passed
        return
    _assert_ccd_bar(z["W"], z["H"], z["rmse"], np.asarray(Wj),
                    np.asarray(Hj), [s.rmse for s in sj])


@pytest.mark.parametrize("name", sorted(SOLVE))
def test_every_rank_ends_with_the_same_factors(out, name):
    z = _load(out, name)
    for rank in range(N):
        r = np.load(out / f"{name}.rank{rank}.npz")
        np.testing.assert_array_equal(r["W"], z["W"])
        np.testing.assert_array_equal(r["H"], z["H"])


def test_sharded_early_stop(out):
    """``early_stop=True, eps=0.9`` on 4 ranks stops after iteration 2, as
    the JAX package's sharded ELL run does."""
    assert len(_load(out, "ell_early_stop")["rmse"]) == 2


@pytest.mark.parametrize("name", HYBRID)
def test_hybrid_all_reduces_per_iteration(out, name):
    """Exactly one all-reduce of (g, h) per half-sweep: 2·k·T per outer
    iteration, nothing gathered."""
    _, kw, _ = SOLVE[name]
    counts = json.loads(str(_load(out, name)["collectives"]))
    want = 2 * kw["k"] * kw.get("maxinneriter", 1) * kw["maxiter"]
    assert counts == {"all_reduce": want, "all_gather": 0, "gather": 0}


def test_sharded_phase_functions(out):
    """The sharded phase functions reproduce the fused single-device
    hybrid within the CCD bar, with measured, nonzero rank and update
    times (update from iteration 2, which has add-backs)."""
    z = _load(out, "phase")
    W1, H1, s1 = _port_single(SMALL, PHASE)
    _assert_ccd_bar(z["W"], z["H"], z["rmse"], W1, H1, [s.rmse for s in s1])
    assert all(t > 0 for t in z["rank_time"])
    assert z["update_time"][-1] > 0


@pytest.mark.parametrize("tag", ["ell", "hyb"])
def test_sharded_resume_bit_equal(out, tag):
    a, b = _load(out, f"{tag}_straight"), _load(out, f"{tag}_resumed")
    np.testing.assert_array_equal(a["W"], b["W"])
    np.testing.assert_array_equal(a["H"], b["H"])
    # the resumed run's iterations are the straight run's last ones
    np.testing.assert_array_equal(a["rmse"][-len(b["rmse"]):], b["rmse"])


def test_jax_checkpoint_resumes_in_port(out):
    """The JAX package's 4-device checkpoint (panel-kernel payload), resumed
    by the port's 4 ranks to 4 iterations, equals the JAX package's
    straight 4-device run."""
    R, T = jdatasets.synthetic(**SMALL)
    full = jtrain(JConfig(maxiter=4, **HYBK), R, T, mesh=_jmesh(),
                  log=JLog(None, echo=False))
    z = _load(out, "hyb_from_jax")
    assert len(z["rmse"]) == 2
    _assert_ccd_bar(z["W"], z["H"], z["rmse"], full.W, full.H,
                    [s.rmse for s in full.stats[2:]])


def test_port_checkpoint_resumes_in_jax(out, tmp_path):
    """The port's 4-rank checkpoint, resumed by the JAX package on 4
    devices to 4 iterations, equals the port's straight 4-rank run."""
    ck = tmp_path / "ck"
    shutil.copytree(out / "ck_for_jax", ck)
    R, T = jdatasets.synthetic(**SMALL)
    res = jtrain(JConfig(maxiter=4, checkpoint_dir=str(ck),
                         checkpoint_every=2, **HYBK), R, T, mesh=_jmesh(),
                 log=JLog(None, echo=False), resume_from_checkpoint=True)
    z = _load(out, "hyb_straight")
    _assert_ccd_bar(res.W, res.H, [s.rmse for s in res.stats], z["W"],
                    z["H"], z["rmse"][2:])


@pytest.mark.parametrize("tag", ["ell", "hyb"])
def test_resume_under_other_shard_count_refused(out, tmp_path, tag):
    """A 4-rank checkpoint does not resume on one device (num_shards 1),
    as in the JAX package."""
    ck = tmp_path / "ck"
    shutil.copytree(out / f"{tag}_ck", ck)
    R, T = _data(SMALL)
    kw = HYBK if tag == "hyb" else ELLK
    with pytest.raises(ValueError, match="num_shards: checkpoint=4 run=1"):
        train(Config(maxiter=4, checkpoint_dir=str(ck), **kw), R, T,
              device="cpu", log=MetricsLog(None, echo=False),
              resume_from_checkpoint=True)
