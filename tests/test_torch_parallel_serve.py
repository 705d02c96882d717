"""Sharded serving, range-read loading and the sharded CLI of the port, on
4 ranks (gloo, the CPU), against the JAX package's sharded runs on 4 of its
8 virtual CPU devices and the port's single-device paths.

* Sharded top-k (``serve/retrieval_sharded.py``) against JAX's
  ``topk_mips_sharded`` and the port's ``topk_mips``: f32 and int8, a
  catalog that is not a multiple of N·chunk (pad rows), all-negative
  scores (a pad row must never win) and exclusions. Ids by the port's tie
  rule (tests/test_torch_serve.py::assert_same_topk); int8 against the
  single-device int8 paths, which JAX's sharded top-k lacks.
* Range-read loading (tests/test_multihost.py:56-113): this process writes
  the binary dataset and the ``HybridManifest``; each rank reads only its
  panel row blocks and tail shard (``data/shard_loader.py``), checks that
  it read exactly its fair share, and runs the sharded hybrid step; the
  replicated result matches the JAX package's sharded run at the JAX
  multi-host bar (atol 2e-5, rtol 1e-4).
* The CLI: ``--mesh 4`` under 4 ranks writes one model file, from rank 0
  alone, equal to the single-device CLI's at the CCD bar; ``--mesh 3`` in
  a world of 4 fails on every rank; the JAX package's refusals with a mesh
  raise (in this process, a world of one rank).
"""

import json
import os

import jax
import numpy as np
import pytest

from cuda_recommender_tpu.core.config import Config as JConfig
from cuda_recommender_tpu.core.init import init_factors_np as jinit
from cuda_recommender_tpu.data import datasets as jdatasets
from cuda_recommender_tpu.parallel.ccd_hybrid_sharded import (
    ccd_hybrid_train_sharded)
from cuda_recommender_tpu.parallel.mesh import make_mesh as jmake_mesh
from cuda_recommender_tpu.serve import retrieval as jretrieval
from cuda_recommender_tpu.serve.retrieval_sharded import topk_mips_sharded
from cuda_recommender_tpu_torch.cli import train as cli
from cuda_recommender_tpu_torch.core.config import Config
from cuda_recommender_tpu_torch.data import datasets
from cuda_recommender_tpu_torch.data.binfmt import (load_model,
                                                    write_binary_dataset)
from cuda_recommender_tpu_torch.data.shard_loader import (
    hybrid_manifest_from_plan, save_hybrid_manifest)
from cuda_recommender_tpu_torch.parallel.launch import run_ranks
from cuda_recommender_tpu_torch.parallel.multihost import free_port
from cuda_recommender_tpu_torch.serve import retrieval
from cuda_recommender_tpu_torch.solvers.ccd_hybrid import plan_hybrid
from test_torch_serve import assert_same_topk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
#: top-k cases: name -> (negate, topk, exclusions, int8); 45 items over 4
#: ranks at chunk 16 pad 19 rows
TOPK = {
    "f32": (False, 5, {}, False),
    "int8": (False, 5, {}, True),
    "negative": (True, 4, {}, False),
    "exclude": (False, 5, {0: [3, 7, 11], 5: [2]}, False),
    "negative_exclude": (True, 4, {0: [1, 2], 3: [0]}, False),
}
USERS = list(range(12))
CHUNK = 16
#: the range-read hybrid (tests/multihost_hybrid_worker.py's sizes)
LOADED = dict(m=96, n=48, nnz=1500, seed=7)
LOADED_CFG = dict(k=4, maxiter=2, lambda_=0.1, backend="hybrid",
                  hybrid_dense_cells=24 * 48, hybrid_panel_widths=(16,),
                  mask_dtype="int8")
CLI_ARGS = ["--dataset", "synthetic:m=300,n=120,nnz=6000,seed=7", "-k", "4",
            "-t", "2", "-l", "0.1", "--backend", "hybrid", "--mask-dtype",
            "nan", "--panel-kernel", "--hybrid-cells", "12000",
            "--panel-widths", "32,16", "--device", "cpu"]


def _factors(negate):
    rng = np.random.default_rng(3)
    W = rng.normal(size=(60, 8)).astype(np.float32)
    H = rng.normal(size=(45, 8)).astype(np.float32)
    return (-np.abs(W), np.abs(H)) if negate else (W, H)


def _launch(args, tmp, world=N, ok=True):
    res = run_ranks(args, world, timeout=240, cwd=ROOT,
                    env={"OMP_NUM_THREADS": "2"})
    if ok:
        for rank, (rc, text) in enumerate(res):
            assert rc == 0, f"rank {rank} exited {rc}:\n{text}"
    return res


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    """One set of 4 ranks: every top-k case and the range-read hybrid."""
    d = tmp_path_factory.mktemp("parallel_serve")
    cases = []
    for name, (negate, topk, excl, int8) in TOPK.items():
        W, H = _factors(negate)
        np.savez(d / f"factors_{name}.npz", W=W, H=H)
        cases.append(dict(name=name, kind="topk", mesh=N,
                          factors=str(d / f"factors_{name}.npz"),
                          users=USERS, topk=topk, chunk=CHUNK, int8=int8,
                          exclude={str(u): v for u, v in excl.items()}))
    R, T = datasets.synthetic(**LOADED)
    write_binary_dataset(str(d / "hyb_data"), R, T)
    plan = plan_hybrid(R, Config(**LOADED_CFG), num_shards=N,
                       materialize_dense=False)
    save_hybrid_manifest(str(d / "manifest.npz"),
                         hybrid_manifest_from_plan(plan))
    cfg = {key: list(v) if isinstance(v, tuple) else v
           for key, v in LOADED_CFG.items()}
    cases.append(dict(name="loaded", kind="load_hybrid", mesh=N, cfg=cfg,
                      data_dir=str(d / "hyb_data"),
                      manifest=str(d / "manifest.npz")))
    with open(d / "cases.json", "w") as f:
        json.dump(cases, f)
    _launch(["-m", "cuda_recommender_tpu_torch.parallel.run_cases",
             str(d / "cases.json"), str(d), "--device", "cpu"], d)
    return d


@pytest.mark.parametrize("name", sorted(TOPK))
def test_sharded_topk_matches_jax_and_single_device(out, name):
    negate, topk, excl, int8 = TOPK[name]
    W, H = _factors(negate)
    z = np.load(out / f"{name}.npz")
    got = (z["s"], z["i"])
    exclude = {u: np.asarray(v) for u, v in excl.items()} or None
    full = W[USERS].astype(np.float64) @ H.T
    if int8:
        Hq, scale = retrieval.quantize_item_table(H)
        full = W[USERS].astype(np.float64) @ (Hq * scale[:, None]).T
        want = jretrieval.topk_mips(W, H, USERS, topk=topk, chunk=CHUNK,
                                    exclude=exclude, int8=True)
    else:
        want = topk_mips_sharded(W, H, USERS, jmake_mesh(jax.devices()[:N]),
                                 topk=topk, chunk=CHUNK, exclude=exclude)
    assert_same_topk(got, tuple(np.asarray(x) for x in want), full, exclude)
    single = retrieval.topk_mips(W, H, USERS, topk=topk, chunk=CHUNK,
                                 exclude=exclude, int8=int8, device="cpu")
    assert_same_topk(got, single, full, exclude)
    assert (z["i"] >= 0).all() and (z["i"] < H.shape[0]).all()
    for u, items in excl.items():
        assert not set(items) & set(z["i"][USERS.index(u)])


def test_range_read_hybrid_matches_jax_sharded(out):
    z = np.load(out / "loaded.npz")
    assert int(z["nnz_read"]) < 2 * int(z["nnz"])
    R, T = jdatasets.synthetic(**LOADED)
    cfg = JConfig(**LOADED_CFG)
    W0, H0 = jinit(cfg.k, R.rows, R.cols, seed=0)
    W1, H1, _ = ccd_hybrid_train_sharded(R, W0, H0, T, cfg,
                                         jmake_mesh(jax.devices()[:N]))
    plan = plan_hybrid(datasets.synthetic(**LOADED)[0], Config(**LOADED_CFG),
                       num_shards=N, materialize_dense=False)
    np.testing.assert_allclose(W1, z["W"][:, plan.user_pos], atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(H1, z["H"][:, plan.item_pos], atol=2e-5,
                               rtol=1e-4)


def test_cli_mesh_writes_one_model_equal_to_single_device(tmp_path):
    res = _launch(["-m", "cuda_recommender_tpu_torch.cli.train", "--mesh",
                   str(N), *CLI_ARGS, "--save-model",
                   str(tmp_path / "model_mesh")], tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["model_mesh"]
    for rank, (_, text) in enumerate(res):
        lines = [ln for ln in text.splitlines()
                 if ln.startswith("[-INFO-] iteration")]
        assert len(lines) == (2 if rank == 0 else 0), text
    assert "golden" not in res[1][1]
    cli.main([*CLI_ARGS, "--save-model", str(tmp_path / "model_one")])
    Wm, Hm = load_model(str(tmp_path / "model_mesh"), entity_major=False)
    W1, H1 = load_model(str(tmp_path / "model_one"), entity_major=False)
    np.testing.assert_allclose(Wm, W1, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(Hm, H1, atol=2e-5, rtol=1e-4)


def test_cli_mesh_other_than_world_size_fails(tmp_path):
    res = _launch(["-m", "cuda_recommender_tpu_torch.cli.train", "--mesh",
                   "3", *CLI_ARGS], tmp_path, ok=False)
    assert all(rc != 0 for rc, _ in res)
    assert any("needs WORLD_SIZE=3, the world has 4 ranks" in text
               for _, text in res)


@pytest.fixture
def world_of_one(monkeypatch):
    """The launcher's environment of a world of one rank in this
    process."""
    for key, val in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                         MASTER_ADDR="localhost",
                         MASTER_PORT=str(free_port())).items():
        monkeypatch.setenv(key, val)


@pytest.mark.parametrize("flags,err,text", [
    (["--backend", "pallas"], NotImplementedError,
     "the Pallas backend is single-chip"),
    (["--backend", "hybrid", "--transpose-stair", "1"], NotImplementedError,
     "hybrid_transpose is single-device-only"),
    (["--backend", "ell", "--phase-timing"], NotImplementedError,
     "phase_timing is single-device in the trainer loop"),
    (["--backend", "hybrid", "--defer-group", "2"], SystemExit,
     "--defer-group is single-device-only"),
])
def test_cli_mesh_refusals(world_of_one, flags, err, text):
    """The JAX package's refusals with a mesh, word for word."""
    import torch.distributed as dist
    argv = ["--dataset", "synthetic:m=40,n=25,nnz=400,seed=3", "-k", "2",
            "-t", "1", "--device", "cpu", "--mesh", "1", *flags]
    with pytest.raises(err, match=text):
        cli.main(argv)
    assert not dist.is_initialized()


def test_initialize_is_a_noop_without_a_launcher(monkeypatch):
    """No launcher's environment: no process group (the JAX package's
    no-op without a coordinator, tests/test_multihost.py:25-26)."""
    import torch.distributed as dist
    from cuda_recommender_tpu_torch.parallel import multihost
    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert multihost.initialize("cpu") is False
    assert not dist.is_initialized()


def test_multihost_blocks_in_a_world_of_one(world_of_one):
    """``local_shard_ids`` is [rank]; ``shard_rows_for_process`` and
    ``assemble_global`` round-trip a rank's block (to every rank and to
    rank 0); the mesh helpers refuse a world of another size
    (tests/test_multihost.py:29-53)."""
    import torch
    from cuda_recommender_tpu_torch.parallel import multihost
    from cuda_recommender_tpu_torch.parallel.mesh import (make_mesh,
                                                          make_mesh_2d)
    assert multihost.initialize("cpu") is True
    try:
        assert multihost.local_shard_ids() == [0]
        full = np.arange(6 * 4, dtype=np.float32).reshape(6, 4)
        (block,) = multihost.shard_rows_for_process(full)
        np.testing.assert_array_equal(block, full)
        got = multihost.assemble_global(torch.from_numpy(block))
        np.testing.assert_array_equal(got.numpy(), full)
        np.testing.assert_array_equal(
            multihost.assemble_global(torch.from_numpy(block), to_all=False),
            full)
        with pytest.raises(ValueError, match="needs WORLD_SIZE=2"):
            make_mesh(2)
        with pytest.raises(ValueError, match="needs WORLD_SIZE=4"):
            make_mesh_2d((2, 2))
        assert make_mesh().size() == 1
    finally:
        multihost.shutdown()


def test_collective_overhead_script_on_the_cpu(capsys):
    """scripts/collective_overhead.py runs its calls and both ELL steps on
    the CPU (gloo, a world of one rank) and reports no time there."""
    import torch.distributed as dist
    from cuda_recommender_tpu_torch.scripts import collective_overhead
    assert collective_overhead.main(["--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["device"]["platform"] == "cpu"
    assert set(rec["gloo"]) == {f"{shape}/{op}"
                                for shape in collective_overhead.SHAPES
                                for op in ("copy", "all_gather_rows",
                                           "all_reduce_pair")}
    assert all(v is None for v in rec["gloo"].values())
    assert rec["ell_step"] == {"one_device": None, "sharded_1_rank": None}
    assert not dist.is_initialized()
