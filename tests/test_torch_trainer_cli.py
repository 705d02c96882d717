"""Port trainer and CLI: reference-format output, the golden dual run, the
knobs outside the slice, the device rule, and the no-jax import rule."""

import io
import json
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from cuda_recommender_tpu.core.metrics_log import MetricsLog as JMetricsLog
from cuda_recommender_tpu_torch import Config, train
from cuda_recommender_tpu_torch.cli import train as cli
from cuda_recommender_tpu_torch.core.metrics_log import MetricsLog
from cuda_recommender_tpu_torch.data import datasets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL = dict(backend="hybrid", mask_dtype="nan", hybrid_panel_kernel=True)
ITER_LINE = re.compile(
    r"^\[-INFO-\] iteration num (\d+) \trank_time \d+\.\d{4}\|\d+\.\d{4} s "
    r"\tupdate_time \d+\.\d{4}\|\d+\.\d{4}s \tRMSE=\d+\.\d{6}"
    r"( time:\d+\.\d{6}s)?$")


@pytest.fixture(scope="module")
def tiny():
    return datasets.synthetic(m=40, n=25, nnz=400, seed=3, power_law=False)


def _lines(fn):
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue().splitlines()


@pytest.mark.parametrize("solver,rmse_time", [("ccd", None), ("ccd", 0.25),
                                              ("als", 0.5)])
def test_metrics_log_lines_identical(solver, rmse_time, tmp_path):
    """The port's MetricsLog prints and records exactly what the JAX
    package's does."""
    args = (solver, "hybrid", 3, 0.812345678, 1.5, 4.25, 0.125, 0.5)
    outs = []
    for cls, name in ((MetricsLog, "t.jsonl"), (JMetricsLog, "j.jsonl")):
        log = cls(str(tmp_path / name))
        _, lines = _lines(lambda: log.iteration(*args, rmse_time=rmse_time))
        log.rank(solver, "hybrid", 3, 1, 0.01, rmse=0.7)
        log.close()
        with open(tmp_path / name) as f:
            recs = [json.loads(x) for x in f]
        for r in recs:
            r.pop("ts")
        outs.append((lines, recs))
    assert outs[0] == outs[1]


def test_train_hybrid_lines_and_golden(tiny):
    R, T = tiny
    cfg = Config(k=4, maxiter=3, lambda_=0.05, golden=True,
                 hybrid_dense_cells=10 * 25, hybrid_panel_widths=(8,),
                 **KERNEL)
    res, lines = _lines(lambda: train(cfg, R, T, device="cpu"))
    it = [x for x in lines if x.startswith("[-INFO-]")]
    assert len(it) == 6                           # hybrid run + golden run
    assert all(ITER_LINE.match(x) for x in it), it
    assert [int(ITER_LINE.match(x).group(1)) for x in it] == [1, 2, 3] * 2
    assert res.backend == "hybrid" and res.golden_W.passed
    assert res.golden_H.passed
    assert lines.count("Check... PASS!") == 2
    assert abs(res.final_rmse - res.ref_final_rmse) < 1e-3
    assert [s.oiter for s in res.stats] == [1, 2, 3]
    assert any(x.startswith("[info] hybrid plan: 1 panels") for x in lines)


def test_train_ref_backend(tiny):
    R, T = tiny
    res, _ = _lines(lambda: train(Config(k=3, maxiter=2, backend="ref"),
                                  R, T, device="cpu"))
    assert res.backend == "ref" and len(res.stats) == 2
    assert np.isfinite(res.W).all()


def test_cli_runs_and_matches_train(tmp_path):
    metrics = tmp_path / "m.jsonl"
    argv = ["--dataset", "synthetic:m=40,n=25,nnz=400,seed=3", "-k", "4",
            "-t", "2", "-T", "2", "-l", "0.05", "--backend", "hybrid",
            "--mask-dtype", "nan", "--panel-kernel", "--hybrid-cells", "250",
            "--panel-widths", "8", "--golden", "--device", "cpu",
            "--metrics-file", str(metrics)]
    rc, lines = _lines(lambda: cli.main(argv))
    assert rc == 0
    assert lines[0] == "[info] loaded 40 x 25, nnz=400, test nnz=44"
    it = [x for x in lines if x.startswith("[-INFO-]")]
    assert len(it) == 4 and all(ITER_LINE.match(x) for x in it)
    assert lines.count("Check... PASS!") == 2
    with open(metrics) as f:
        kinds = [json.loads(x)["kind"] for x in f]
    assert "hybrid_plan" in kinds and "golden" in kinds
    # the same run through train(): identical RMSE trajectory
    R, T = datasets.synthetic_from_spec("synthetic:m=40,n=25,nnz=400,seed=3")
    cfg = Config(k=4, maxiter=2, maxinneriter=2, lambda_=0.05,
                 hybrid_dense_cells=250, hybrid_panel_widths=(8,), **KERNEL)
    res, _ = _lines(lambda: train(cfg, R, T, device="cpu"))
    want = ["RMSE=%f" % s.rmse for s in res.stats]
    assert [re.search(r"RMSE=\S+", x).group(0) for x in it[:2]] == want


#: knob -> (Config knobs, what the run does): a regex the raise must match,
#: or None where the port runs it (ALS precision "high", ell, phase timing,
#: checkpoints, the fp8 residual and the deferred tail, once outside the
#: port; each case keeps its name)
UNSUPPORTED = {
    "als": (dict(solver="als", als_precision="high"), None),
    "ell": (dict(backend="ell"), None),
    "dense_phase_timing": (dict(backend="dense", phase_timing=True), None),
    "dense_fp8": (dict(backend="dense", residual_dtype="float8_e4m3fn"),
                  None),
    "dense_checkpoint": (dict(backend="dense", checkpoint_dir="ck"), None),
    "pallas_phase_timing": (dict(backend="pallas", phase_timing=True),
                            "not implemented for the pallas backend"),
    "fp8": (dict(KERNEL, residual_dtype="float8_e4m3fn"), None),
    "phase_timing": (dict(KERNEL, phase_timing=True), None),
    "defer_group": (dict(KERNEL, hybrid_defer_group=2), None),
    "checkpoint": (dict(KERNEL, checkpoint_dir="ck"), None),
}


@pytest.mark.parametrize("knob", sorted(UNSUPPORTED))
def test_unsupported_knobs_raise(tiny, knob, tmp_path, monkeypatch):
    """The knobs still outside the port raise NotImplementedError naming
    their ROADMAP.md item (pallas phase timing: the JAX package's own
    refusal); those ported since run: a checkpoint lands in its directory,
    phase timing splits rank and update time."""
    R, T = tiny
    kw, match = UNSUPPORTED[knob]
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            train(Config(k=2, maxiter=1, **kw), R, T, device="cpu")
        return
    monkeypatch.chdir(tmp_path)
    res, _ = _lines(lambda: train(Config(k=2, maxiter=2, checkpoint_every=1,
                                         **kw), R, T, device="cpu"))
    assert [s.oiter for s in res.stats] == [1, 2]
    assert np.isfinite(res.W).all() and np.isfinite(res.H).all()
    if "checkpoint_dir" in kw:
        assert sorted(os.listdir(tmp_path / "ck")) == [
            "ckpt_000001.npz", "ckpt_000002.npz", "manifest.json"]
    if kw.get("phase_timing"):
        assert all(s.rank_time > 0 and s.update_time > 0 for s in res.stats)


@pytest.mark.parametrize("backend", ["dense", "auto"])
def test_dense_nan_mask_raises_value_error(tiny, backend):
    """The dense residual keeps an explicit mask: mask_dtype='nan' is a
    ValueError on dense (and on AUTO when it picks dense), as in the JAX
    package."""
    R, T = tiny
    with pytest.raises(ValueError, match="explicit mask"):
        train(Config(k=2, maxiter=1, backend=backend, mask_dtype="nan"), R,
              T, device="cpu")


@pytest.mark.parametrize("kw", [dict(mesh=True),
                                dict(resume_from_checkpoint=True)])
def test_mesh_and_resume_raise(tiny, kw):
    """A mesh (item 15, now in the port) trains: here a world of one rank
    in this process, the sharded hybrid equal to the single-device run
    within the sharded bar (atol 2e-5, rtol 1e-4); a resume with no
    checkpoint_dir is the JAX package's ValueError."""
    R, T = tiny
    cfg = Config(k=2, maxiter=1, **KERNEL)
    if "mesh" in kw:
        from cuda_recommender_tpu_torch.parallel import multihost
        from cuda_recommender_tpu_torch.parallel.mesh import make_mesh
        multihost.initialize_local("cpu")
        try:
            got = train(cfg, R, T, device="cpu", mesh=make_mesh(1))
        finally:
            multihost.shutdown()
        want = train(cfg, R, T, device="cpu")
        np.testing.assert_allclose(got.W, want.W, atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(got.H, want.H, atol=2e-5, rtol=1e-4)
        return
    with pytest.raises(ValueError, match="no checkpoint_dir"):
        train(cfg, R, T, device="cpu", **kw)


def test_cuda_without_gpu_raises(tiny, monkeypatch):
    """device='cuda' with no GPU is an error, never a silent CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    R, T = tiny
    with pytest.raises(RuntimeError, match="is_available"):
        train(Config(k=2, maxiter=1, **KERNEL), R, T, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["--dataset", "synthetic:m=40,n=25,nnz=400,seed=3",
                  "--backend", "hybrid", "--mask-dtype", "nan",
                  "--panel-kernel", "-t", "1"])


#: the measurement layer's modules, which the walk below must reach
MEASUREMENT_MODULES = (
    "cuda_recommender_tpu_torch.bench", "cuda_recommender_tpu_torch.cli.bench",
    "cuda_recommender_tpu_torch.ops.probe_kernels",
    "cuda_recommender_tpu_torch.scripts.common",
    "cuda_recommender_tpu_torch.scripts.panel_floor",
    "cuda_recommender_tpu_torch.scripts.panel_kernel_variants",
    "cuda_recommender_tpu_torch.scripts.probe_gather",
    "cuda_recommender_tpu_torch.scripts.profile_iteration",
    "cuda_recommender_tpu_torch.scripts.sweep_timing")
#: the file layer and serving modules, which the walk below must reach too
SERVING_MODULES = (
    "cuda_recommender_tpu_torch.data.binfmt",
    "cuda_recommender_tpu_torch.eval.ranking",
    "cuda_recommender_tpu_torch.serve.scoring",
    "cuda_recommender_tpu_torch.serve.retrieval",
    "cuda_recommender_tpu_torch.serve.engine",
    "cuda_recommender_tpu_torch.models.mf",
    "cuda_recommender_tpu_torch.cli.convert",
    "cuda_recommender_tpu_torch.cli.predict",
    "cuda_recommender_tpu_torch.cli.bench_serve")
#: the multi-device layer's modules, which the walk below must reach too
PARALLEL_MODULES = (
    "cuda_recommender_tpu_torch.parallel.mesh",
    "cuda_recommender_tpu_torch.parallel.multihost",
    "cuda_recommender_tpu_torch.parallel.collectives",
    "cuda_recommender_tpu_torch.parallel.launch",
    "cuda_recommender_tpu_torch.parallel.run_cases",
    "cuda_recommender_tpu_torch.parallel.ccd_ell_sharded",
    "cuda_recommender_tpu_torch.parallel.als_ell_sharded",
    "cuda_recommender_tpu_torch.parallel.ccd_hybrid_sharded",
    "cuda_recommender_tpu_torch.serve.retrieval_sharded",
    "cuda_recommender_tpu_torch.data.shard_loader")


def test_port_imports_no_jax():
    """Importing every module of the port, the measurement layer and the
    serving modules included, and chip_smoke.py (whose phases import only
    the port) loads neither jax nor the JAX package (the machine with the
    GPU has no jax)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import cuda_recommender_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"missing = set({MEASUREMENT_MODULES + SERVING_MODULES + PARALLEL_MODULES!r})"
        " - set(sys.modules)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'cuda_recommender_tpu'\n"
        "       or m.startswith('cuda_recommender_tpu.')]\n"
        "print(len(sys.modules), bad, missing)\n"
        "sys.exit(1 if bad or missing else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
