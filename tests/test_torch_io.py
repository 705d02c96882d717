"""Port file layer and CLIs against the JAX package: the reference's binary
dataset and model files byte-identical, the text loaders and the split
array-identical, the ranking metrics equal, and the convert -> train ->
predict sequence, ``-p``, the reference's train flags and bench_serve on
the port (on the CPU)."""

import dataclasses
import io
import json
import os
import re
from contextlib import redirect_stdout

import numpy as np
import pytest

from cuda_recommender_tpu.cli import convert as jconvert
from cuda_recommender_tpu.cli import train as jtrain
from cuda_recommender_tpu.data import binfmt as jbinfmt
from cuda_recommender_tpu.data import datasets as jdatasets
from cuda_recommender_tpu.eval import ranking as jranking
from cuda_recommender_tpu_torch import native as port_native
from cuda_recommender_tpu_torch.cli import bench_serve, convert, predict
from cuda_recommender_tpu_torch.cli import train as cli
from cuda_recommender_tpu_torch.data import binfmt, datasets
from cuda_recommender_tpu_torch.eval import ranking
from cuda_recommender_tpu_torch.serve.scoring import predict_pairs

SPECS = ("synthetic:m=300,n=120,nnz=6000,seed=7",
         "synthetic:m=40,n=25,nnz=400,seed=3")


def _files(d) -> dict:
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d))}


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(fn):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = fn()
    return rc, buf.getvalue()


def _ratings_text(path, n_lines=3000, users=120, items=50, seed=0):
    """A 1-based 'user item rating' file with distinct pairs (the lines of
    tests/test_cli.py::test_convert_then_train_then_predict)."""
    rng = np.random.default_rng(seed)
    lines = [f"{int(rng.integers(1, users))} {int(rng.integers(1, items))} "
             f"{rng.integers(1, 6)}" for _ in range(n_lines)]
    path.write_text("\n".join(dict.fromkeys(lines)) + "\n")
    return str(path)


# ------------------------------------------------------------ binary formats

@pytest.mark.parametrize("spec", SPECS)
def test_binary_dataset_byte_identical(tmp_path, spec):
    """write_binary_dataset: every file of the port's directory equals the
    JAX package's byte for byte, and each package reads the other's."""
    R, T = datasets.synthetic_from_spec(spec)
    jR, jT = jdatasets.synthetic_from_spec(spec)
    binfmt.write_binary_dataset(str(tmp_path / "p"), R, T)
    jbinfmt.write_binary_dataset(str(tmp_path / "j"), jR, jT)
    got, want = _files(tmp_path / "p"), _files(tmp_path / "j")
    assert list(got) == list(want) and len(got) == 13
    assert got == want
    R2, T2 = binfmt.load_binary_dataset(str(tmp_path / "j"))
    jR2, jT2 = jbinfmt.load_binary_dataset(str(tmp_path / "p"))
    for a, b in ((R2, jR2), (T2, jT2), (R2, R), (T2, T)):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype, f.name
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert x == y, f.name


@pytest.mark.parametrize("entity_major", [True, False])
def test_model_file_byte_identical(tmp_path, entity_major):
    """save_model: the same bytes as the JAX package's (int64 header, f32
    payload, entity-major on disk); load_model reads either back
    bit-equal in both layouts."""
    rng = np.random.default_rng(0)
    shape_w, shape_h = ((50, 8), (30, 8)) if entity_major else ((8, 50),
                                                                  (8, 30))
    W = rng.normal(size=shape_w).astype(np.float32)
    H = rng.normal(size=shape_h).astype(np.float32)
    binfmt.save_model(str(tmp_path / "p"), W, H, entity_major=entity_major)
    jbinfmt.save_model(str(tmp_path / "j"), W, H, entity_major=entity_major)
    raw = (tmp_path / "p").read_bytes()
    assert raw == (tmp_path / "j").read_bytes()
    assert len(raw) == 2 * 16 + 4 * (W.size + H.size)
    assert tuple(np.frombuffer(raw[:16], "<i8")) == (50, 8)
    for em in (True, False):
        got = binfmt.load_model(str(tmp_path / "j"), entity_major=em)
        want = jbinfmt.load_model(str(tmp_path / "p"), entity_major=em)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    We, He = binfmt.load_model(str(tmp_path / "p"),
                               entity_major=entity_major)
    np.testing.assert_array_equal(We, W)
    np.testing.assert_array_equal(He, H)


def test_truncated_model_raises(tmp_path):
    p = tmp_path / "m"
    binfmt.save_model(str(p), np.ones((4, 2), np.float32),
                      np.ones((3, 2), np.float32), entity_major=True)
    p.write_bytes(p.read_bytes()[:-4])
    with pytest.raises(ValueError, match="truncated"):
        binfmt.load_model(str(p))


def test_meta_text_dataset_identical(tmp_path):
    (tmp_path / "train.txt").write_text("1 1 4.0\n1 2 3.0\n2 1 5.0\n3 3 1\n")
    (tmp_path / "test.txt").write_text("2 2 2.0\n3 1 4.5\n")
    (tmp_path / "meta").write_text("3 3\n4 train.txt\n2 test.txt\n")
    R, T = binfmt.load_meta_text_dataset(str(tmp_path))
    jR, jT = jbinfmt.load_meta_text_dataset(str(tmp_path))
    np.testing.assert_array_equal(R.to_dense(), jR.to_dense())
    for name in ("row_idx", "col_idx", "val"):
        np.testing.assert_array_equal(getattr(T, name), getattr(jT, name))
    assert (R.rows, R.cols, R.nnz, T.nnz) == (3, 3, 4, 2)


# ------------------------------------------------------ text loader, split

@pytest.mark.parametrize("one_based", [True, False])
def test_load_text_ratings_identical(tmp_path, one_based):
    path = _ratings_text(tmp_path / "r.txt")
    with open(path, "a") as f:
        f.write("7 3 4.5 978300760\n")         # a timestamp column
    got = datasets.load_text_ratings(path, one_based=one_based)
    want = jdatasets.load_text_ratings(path, one_based=one_based)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("frac,seed", [(0.1, 0), (0.25, 3), (0.0, 1)])
def test_train_test_split_identical(tmp_path, frac, seed):
    r, c, v = datasets.load_text_ratings(_ratings_text(tmp_path / "r.txt"))
    rows, cols = int(r.max()) + 1, int(c.max()) + 1
    R, T = datasets.train_test_split_coo(rows, cols, r, c, v,
                                         test_fraction=frac, seed=seed)
    jR, jT = jdatasets.train_test_split_coo(rows, cols, r, c, v,
                                            test_fraction=frac, seed=seed)
    for a, b in zip(R.to_coo() + (T.row_idx, T.col_idx, T.val),
                    jR.to_coo() + (jT.row_idx, jT.col_idx, jT.val)):
        np.testing.assert_array_equal(a, b)
    assert T.nnz == int(len(v) * frac)


# ---------------------------------------------------------------- ranking

@pytest.mark.parametrize("metric", ["recall_at_k", "precision_at_k",
                                    "hit_rate_at_k", "ndcg_at_k"])
def test_ranking_metrics_equal(metric):
    rng = np.random.default_rng(4)
    retrieved = rng.integers(-1, 40, size=(30, 10))
    relevant = [rng.choice(40, size=int(rng.integers(0, 6)), replace=False)
                for _ in range(30)]
    got = getattr(ranking, metric)(retrieved, relevant)
    assert got == getattr(jranking, metric)(retrieved, relevant)
    assert 0.0 < got <= 1.0


# -------------------------------------------------------------------- CLIs

def test_convert_identical_to_jax(tmp_path):
    src = _ratings_text(tmp_path / "ratings.txt")
    rc, out = _run(lambda: convert.main([src, str(tmp_path / "p"),
                                         "--test-fraction", "0.2"]))
    jrc, jout = _run(lambda: jconvert.main([src, str(tmp_path / "j"),
                                            "--test-fraction", "0.2"]))
    assert rc == 0 and jrc == 0
    # both take the native C++ parser where g++ builds it, else NumPy
    parser = ("native C++ parser" if port_native.available()
              else "NumPy fallback")
    assert out.splitlines()[0] == jout.splitlines()[0] == \
        f"[info] parsed with {parser}"
    assert _files(tmp_path / "p") == _files(tmp_path / "j")


def test_convert_then_train_then_predict(tmp_path):
    """tests/test_cli.py::test_convert_then_train_then_predict on the port:
    convert, train from the directory with --save-model, score a test file
    and retrieve top-k from the saved model."""
    src = _ratings_text(tmp_path / "ratings.txt")
    ds = str(tmp_path / "ds")
    assert convert.main([src, ds, "--test-fraction", "0.2"]) == 0
    model = str(tmp_path / "model")
    rc, out = _run(lambda: cli.main([ds, "-k", "4", "-t", "2",
                                     "--save-model", model,
                                     "--device", "cpu"]))
    assert rc == 0 and f"[info] model saved to {model}" in out
    R, _ = binfmt.load_binary_dataset(ds)
    W, H = binfmt.load_model(model)
    assert W.shape == (R.rows, 4) and H.shape == (R.cols, 4)

    test_txt = tmp_path / "t.txt"
    test_txt.write_text("1 1 3.0\n5 2 4.0\n")
    rc, out = _run(lambda: predict.main(["score", model, str(test_txt),
                                         "-o", str(tmp_path / "out"),
                                         "--device", "cpu"]))
    assert rc == 0
    assert re.search(r"^\[FINAL INFO\] Test RMSE = \d+\.\d{6}\. Calculated "
                     r"in \d+\.\d{6}s$", out, re.M)
    got = np.loadtxt(tmp_path / "out", ndmin=1)
    np.testing.assert_allclose(got, [W[0] @ H[0], W[4] @ H[1]], atol=1e-5)

    rc, out = _run(lambda: predict.main(["topk", model, "0,1", "-k", "5",
                                         "--chunk", "16", "--device",
                                         "cpu"]))
    assert rc == 0
    line = [x for x in out.splitlines() if x.startswith("user 0:")][0]
    ids = [int(p.split(":")[0]) for p in line[len("user 0: "):].split(", ")]
    np.testing.assert_array_equal(ids, np.argsort(-(H @ W[0]),
                                                  kind="stable")[:5])


def test_train_meta_text_dir(tmp_path):
    """The positional data_dir also takes the legacy ``meta`` layout."""
    (tmp_path / "train.txt").write_text(
        "".join(f"{u} {i} {1 + (u * i) % 5}\n" for u in range(1, 21)
                for i in range(1, 9) if (u + i) % 3))
    (tmp_path / "test.txt").write_text("1 1 3.0\n2 2 4.0\n")
    nnz = len((tmp_path / "train.txt").read_text().splitlines())
    (tmp_path / "meta").write_text(f"20 8\n{nnz} train.txt\n2 test.txt\n")
    rc, out = _run(lambda: cli.main([str(tmp_path), "-k", "2", "-t", "1",
                                     "--device", "cpu"]))
    assert rc == 0
    assert out.splitlines()[0] == (f"[info] loaded 20 x 8, nnz={nnz}, "
                                   "test nnz=2")


def test_train_without_data_is_an_error():
    with pytest.raises(SystemExit, match="need a data_dir"):
        cli.main(["--device", "cpu"])


def test_train_predict_flag_writes_model_and_output(tmp_path, monkeypatch):
    """-p 1 saves ./model and writes one '%f' prediction per test rating to
    ./output (JAX cli/train.py:227-240)."""
    monkeypatch.chdir(tmp_path)
    spec = "synthetic:m=60,n=30,nnz=900,seed=2"
    rc, out = _run(lambda: cli.main(["--dataset", spec, "-k", "3", "-t", "2",
                                     "-p", "1", "--device", "cpu"]))
    assert rc == 0
    assert "[info] predictions written to ./output" in out
    _, T = datasets.synthetic_from_spec(spec)
    W, H = binfmt.load_model("model")
    lines = (tmp_path / "output").read_text().splitlines()
    assert len(lines) == T.nnz
    assert all(re.fullmatch(r"-?\d+\.\d{6}", x) for x in lines)
    want = predict_pairs(W, H, T.row_idx, T.col_idx, entity_major=True,
                         device="cpu")
    assert lines == ["%f" % x for x in want]


#: argv -> the same Config in both packages
FLAG_ARGVS = {
    "reference": ["-k", "6", "-n", "8", "-l", "0.05", "-t", "3", "-T", "2",
                  "-e", "0.01", "-q", "1", "-N", "1", "-CUDA", "-nBlocks",
                  "64", "-nThreadsPerBlock", "128"],
    "predict": ["-p", "1", "--early-stop", "--fused-iters", "3"],
    "als": ["-ALS", "-OMP", "--als-min-width", "32", "--als-group-mb", "512",
            "--als-gather-tile-mb", "0"],
    "hybrid": ["--backend", "hybrid", "--mask-dtype", "nan", "--panel-kernel",
               "--hybrid-cells", "9000", "--panel-widths", "64,16",
               "--transpose-stair", "auto", "--residual-dtype", "bfloat16",
               "--seed", "3"],
    "io": ["--checkpoint-dir", "ck", "--checkpoint-every", "2",
           "--metrics-file", "m.jsonl", "--phase-timing"],
}


class _Captured(Exception):
    pass


def _asdict(cfg) -> dict:
    return {k: getattr(v, "value", v)
            for k, v in dataclasses.asdict(cfg).items()}


@pytest.mark.parametrize("name", sorted(FLAG_ARGVS))
@pytest.mark.parametrize("data", ["--dataset", "dir"])
def test_train_flags_build_the_jax_config(monkeypatch, tmp_path, name,
                                          data):
    """The port's parser maps every flag of the JAX CLI's that it shares onto
    the same Config, field for field (item 19)."""
    monkeypatch.chdir(tmp_path)            # the JAX CLI opens its metrics file
    argv = FLAG_ARGVS[name] + (
        ["--dataset", "synthetic:m=40,n=25,nnz=400"] if data == "--dataset"
        else ["some_dir"])

    def capture(cfg, *a, **kw):
        raise _Captured(cfg)

    monkeypatch.setattr(jtrain, "train", capture)
    monkeypatch.setattr(jtrain, "load_data", lambda args: (
        jdatasets.synthetic(m=40, n=25, nnz=400)))
    with pytest.raises(_Captured) as exc:
        _run(lambda: jtrain.main(argv))
    want = _asdict(exc.value.args[0])
    got = _asdict(cli.build_config(cli.build_parser().parse_args(argv)))
    assert got == want


@pytest.mark.parametrize("flags,item", [
    (["--checkpoint-dir", "ck"], "item 7"),
    (["--checkpoint-dir", "ck", "--checkpoint-every", "1"], "item 7"),
    (["--resume"], "item 7"),
    (["--phase-timing"], "item 13"),
    (["--phase-timing", "--backend", "hybrid"], "item 13"),
    (["--mesh", "4"], "item 15"),
    (["--mesh2d", "2x2"], "item 15"),
])
def test_unported_train_flags_raise_their_item(monkeypatch, tmp_path, flags,
                                               item):
    """Meshes (item 15), checkpoints (item 7) and phase timing (item 13),
    all in the port now, reach the Config and train() as the JAX CLI
    passes them (cli/train.py:137-139 there): ``--resume`` with no
    checkpoint directory is its ValueError; ``--mesh 4`` and ``--mesh2d
    2x2`` train on 4 ranks (parallel/launch.py, gloo), rank 0 alone
    printing the iteration line."""
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset", "synthetic:m=40,n=25,nnz=400", "-k", "2", "-t", "1",
            "--device", "cpu", *flags]
    if item == "item 15":
        from cuda_recommender_tpu_torch.parallel.launch import run_ranks
        res = run_ranks(["-m", "cuda_recommender_tpu_torch.cli.train",
                         *argv], 4, timeout=240, cwd=ROOT,
                        env={"OMP_NUM_THREADS": "2"})
        for rank, (rc, text) in enumerate(res):
            assert rc == 0, f"rank {rank} exited {rc}:\n{text}"
            assert text.count("[-INFO-] iteration num 1") == (rank == 0)
        return
    cfg = cli.build_config(cli.build_parser().parse_args(argv))
    assert cfg.checkpoint_dir == ("ck" if "--checkpoint-dir" in flags
                                  else None)
    assert cfg.checkpoint_every == (1 if "--checkpoint-every" in flags
                                    else 0)
    assert cfg.phase_timing == ("--phase-timing" in flags)
    if flags == ["--resume"]:
        with pytest.raises(ValueError, match="no checkpoint_dir"):
            _run(lambda: cli.main(argv))
        return
    seen = {}
    real = cli.train

    def spy(cfg, R, T, **kw):
        seen.update(kw)
        return real(cfg, R, T, **kw)

    monkeypatch.setattr(cli, "train", spy)
    rc, out = _run(lambda: cli.main(argv))
    assert rc == 0 and seen["resume_from_checkpoint"] is False
    if cfg.checkpoint_every:
        assert os.path.exists(tmp_path / "ck" / "ckpt_000001.npz")
    if cfg.phase_timing:
        assert "[-INFO-] iteration num 1" in out


def test_bench_serve_cli():
    """tests/test_cli.py::test_bench_serve_cli on the port (the CPU)."""
    rc, out = _run(lambda: bench_serve.main([
        "--dataset", "synthetic:m=300,n=120,nnz=6000", "--queries", "256",
        "--batch", "128", "--chunk", "128", "--topk", "5", "--device",
        "cpu"]))
    assert rc == 0
    lines = out.strip().splitlines()
    rec = json.loads(lines[-1])
    assert len(lines) == 1
    assert rec["value"] > 0 and rec["unit"] == "queries/s/chip"
    assert rec["metric"] == "mips_top5_qps"
    assert 0.11 < rec["detail"]["recall_at_k"] <= 1.0
    assert rec["detail"]["device"] == {"platform": "cpu", "name": "cpu"}
    assert set(rec["detail"]["launches"].values()) == {0}


@pytest.mark.parametrize("extra", [["--int8"], ["--approx", "--int8"]])
def test_bench_serve_latency_cli(extra):
    rc, out = _run(lambda: bench_serve.main([
        "--dataset", "synthetic:m=300,n=120,nnz=6000", "--queries", "64",
        "--latency", "--random-factors", "--device", "cpu", *extra]))
    assert rc == 0
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["unit"] == "ms/query" and rec["value"] > 0
    assert rec["detail"]["p99_ms"] >= rec["value"]
    assert rec["detail"]["int8"] is True
