"""Nothing the benchmark runs loads JAX or the JAX package: every module
of ``benchmark/`` imported, and ``python -m benchmark.run --help`` run, in
fresh processes, compared by whole top-level module names."""

import json
import os
import pkgutil
import subprocess
import sys

from .conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "cuda_recommender_tpu"}


def _modules():
    import benchmark

    names = []
    for info in pkgutil.walk_packages(benchmark.__path__, "benchmark."):
        if ".tests" not in info.name:
            names.append(info.name)
    return names


def test_every_module_imports_without_jax():
    mods = _modules()
    assert {"benchmark.run", "benchmark.cell", "benchmark.datagen",
            "benchmark.reference.ccd", "benchmark.reference.als"} <= set(mods)
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from benchmark import spec\n"
            "for m in spec.load_spec()['per_layer']:\n"
            "    spec.metric_reader(m['name'])\n"
            "import cuda_recommender_tpu_torch.core.trainer\n"
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & FORBIDDEN, top & FORBIDDEN
    assert "cuda_recommender_tpu_torch" in top


def test_run_help_loads_no_jax():
    code = ("import runpy, sys\n"
            "sys.argv = ['benchmark.run', '--help']\n"
            "try:\n"
            "    runpy.run_module('benchmark.run', run_name='__main__')\n"
            "except SystemExit:\n"
            "    pass\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert "--workload" in out.stdout
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not top & FORBIDDEN


def test_references_import_nothing_of_the_program():
    code = ("import sys\n"
            "import benchmark.reference.ccd, benchmark.reference.als\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not top & (FORBIDDEN | {"cuda_recommender_tpu_torch"})


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark import run

    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "cuda_recommender_tpu_torch_extra", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "cuda_recommender_tpu.core", sys)
    assert run.forbidden_modules() == ["cuda_recommender_tpu", "jax"]
