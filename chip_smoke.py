"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``cuda_recommender_tpu_torch/csrc``
(one nvcc per source, in parallel) and checks each against its plain
PyTorch version on the card; the column sweeps, which move 16-byte vectors,
also at every row alignment (widths of every residue mod 16, W < 8, views
one element off a 16-byte boundary between guard cells, and the transposed
stair's odd-width panel 0); the row sweeps (K2, ``masked_usweep``) at every
case of their plan (``check_row_sweeps``: W = 1, W < 8, odd widths, M = 1,
M under the SM count, one to eight chunks, several segments with a ragged
last one, views at every offset within a 16-byte unit and one row in, and
Yahoo r1_t's 912 x 1,948,883 panel 0), in phases 3, 11 and 42 for every
residual dtype x mask; K5 bit-equal to its plain version at the edges
of every width it instantiates, on separate tensors and on views of the
ALS gram one float off a 16-byte boundary. Then it drives the port's
paths:

* CCD++ on the panel-hybrid backend at Netflix-100M dims (k=40, bf16
  NaN-sentinel panels, the panel kernels K1-K3) through ``train()`` --
  three outer iterations at one inner iteration as bench.py runs it, then
  one at two inner iterations, which also launches the read-only v-sweep
  --, checks each panel kernel again at every panel shape that run gave it,
  times each against its plain version, and runs the CLI with the golden
  check;
* ALS on the ELL backend at ml20M dims (k=40, the batched Gauss-Jordan
  kernel K5) through ``train()`` -- five outer iterations --, holds one
  outer step bit-equal to the same step with the plain solve, times K5
  (k = 10, 40, 128) against its plain version and ``torch.linalg.solve``,
  and runs the ``-ALS`` CLI
  with the golden check;
* CCD++ on the dense backend (K4, the fused masked update + v-sweep, and
  the masked sweeps): checks them against their plain versions, trains the
  JAX README's quick start at ml10M dims (AUTO -> dense, k=10, golden dual
  run; then one iteration at -T 2), holds the pallas backend bit-equal to
  it, trains the README's k=40 bf16-residual row, times the kernels, trains
  the explicit-mask hybrid at Netflix-100M dims with the JAX ``Config``
  defaults, and runs the README's CLI command with no backend flag;
* the measurement layer: checks the probe kernels (the stream controls
  stream_rmw and stream_read, the read on both of its row paths and bit-
  equal to its order of additions on the host, on panels from under one
  16-byte vector to the scripts' shapes and on views at every even offset
  off a 16-byte boundary, K1's
  integer-rounding variant, the three gather forms, A and B
  on both of their paths: the table in shared memory, counted as
  ``gather_smem``, and in L2, counted as ``gather``, at the bench's rows
  tail, at the largest table the card's shared memory takes and one row
  over it, and on views off a 16-byte boundary) against their plain
  versions, runs the port's bench (``python -m
  cuda_recommender_tpu_torch.bench``) at the headline, then with the auto
  stair, the auto orientation and the transposed stair, times the probe
  kernels at the bench's shapes (the streams also at the variant
  matrix's; gathers A and B at both tail sides),
  runs the variant and gather probe scripts and a small ``cli/bench.py``
  grid;
* serving (``serve/``, ``models/``, ``data/binfmt.py`` and the file and
  serving CLIs): writes and reads back the headline run's factors in the
  reference's model format, retrieves top-10 items over its 17,770-item
  catalog and over a 1M-item catalog tiled from it (f32 and int8 item
  tables, each batch path held against the brute force on the card),
  reports QPS, recall@10, the engine's p50/p99 latency and each batch's
  time split, runs ``cli/bench_serve.py`` (ALS training with K5, then
  serving) with its defaults and ``--latency``, and runs convert -> train
  -> predict at ml1m dims. Serving itself launches no hand kernel;
* the rest of single-device training: checkpoint/resume through
  ``train()`` (ALS at ml20M dims with K5, the dense quick start with K4
  and the masked sweeps, the bf16 NaN-panel hybrid at ml10M dims with K1
  and K2): a run of 2 iterations, a checkpoint and a resume to 4 against 4
  straight, bit for bit, the snapshot's bytes and save and load seconds,
  the hybrid's panels in the JAX package's block-padded shapes; phase
  timing at the headline (K3 and K2 in the sweeps, the rank/update split,
  the RMSE on the fused run's trajectory) and through the CLI with ``-q 1``
  (a rank line per rank); the pure-ELL backend through the CLI with the
  golden check, and 2 + 1 iterations resumed bit-equal to the CLI's 3;
* multi-device training and sharded serving (``parallel/``, one process a
  rank over ``torch.distributed``): a world of one rank opened in this
  process over NCCL runs the sharded hybrid at the headline through
  ``train(mesh=...)`` (K1 and K2, 2·k·T all-reduces an outer iteration,
  W, H and the RMSE bit-equal to the single-device run), then sharded ALS
  (K5), dense on a 1-D mesh (K4, the masked sweeps) and ELL, each
  bit-equal to its single-device run, and the sharded top-10; then two
  ranks on the one card over gloo (NCCL allows one rank a GPU) train the
  ml10M hybrid through ``cli.train --mesh 2``, held against the
  single-device run;
* the ALS gram precisions and the native host helpers: the ALS headline
  under ``als_precision`` "high" (bf16x3) and "default" (one bf16 pass)
  through ``train()`` against the "highest" run (RMSE an iteration, s/iter,
  one profiled step split into the gram products, the gathers and K5),
  "highest" again bit-equal to its first run, the bf16 gram products
  against their plain f32 version at every bucket, sharded "default" over
  one rank bit-equal to one device, and the host set-up at Netflix-100M
  dims (data, CSR+CSC build, plan, ELL build) with the native C++ helpers
  against their NumPy paths, byte-equal; every phase before it took the
  native helpers;
* the ml1m trajectories (``scripts/run_trajectories.py``, 3 iterations):
  the ml-1m-calibrated fixture through text, ``cli/convert``, binfmt and
  training on dense CCD++ (K4, ``masked_usweep``), the bf16 int8-mask
  hybrid (K4 and the masked sweeps), the bf16 NaN-panel hybrid (K1, K2)
  and ALS (K5), each iteration's RMSE and golden RMSE held against the JAX
  package's committed records, and each arm against its golden run (dense
  CCD++ and ALS pass golden_compare, the hybrids' RMSE near the golden's);
* the measurement scripts (``scripts/sweep.py``, ``sweep_netflix_hybrid``,
  ``headline_variance``, ``bench_als``, ``scaling_model``): the reference
  grid at ml1m dims (K4, the masked sweeps, K5; repeats bit-equal), one
  flagship row on the headline's data (K1, K2; its group-difference s/iter
  beside the headline's, its RMSE beside the JAX record's), the variance
  probe on that row's state, the ALS golden at "high" and "default" (K5)
  and the scaling model anchored to the headline's s/iter;
* the fp8 residual and the rank-deferred ELL tail: every fp8 instance of
  K1-K4 and the masked sweeps (K1 and K4 stored once and delta-first) x
  NaN / bf16 / int8 masks against its plain version at phase 3's shapes
  and alignments and the headline's panel 0 (stored bytes bit-equal, a
  planted sum past 464 stored NaN, repeats bit-identical) and timed; the
  headline at fp8 (int8 masks; NaN panels with the panel kernels) beside
  the bf16 run; the quick start, the pallas backend and the no-kernel NaN
  hybrid at fp8; the headline's stair with ``hybrid_defer_group=8``
  against G = 0 (W, H within rtol 1e-3, atol 1e-4 at an f32 residual) and
  at bf16 beside the headline run (its RMSE).

Each phase prints its wall seconds. Any failure raises and exits non-zero;
nothing falls back to the CPU.

The last two lines of standard output are one JSON object of per-kernel
results (``{"kernels": [...]}``) and one of the device
(``{"ok": true, "device": {...}}``). Without a CUDA device the script exits
non-zero before printing either.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = "cuda_recommender_tpu_torch/csrc"
PALLAS = "cuda_recommender_tpu/ops/panel_pallas.py"
#: panel kernel -> the Pallas call it replaces (file:line)
KERNELS = {"panel_update_vsweep": f"{PALLAS}:240",
           "panel_usweep": f"{PALLAS}:321",
           "panel_vsweep": f"{PALLAS}:283"}
GJ_REPLACES = "cuda_recommender_tpu/ops/gj_pallas.py:245"
#: K4 and the masked sweeps -> what they replace (file:line)
MASKED_KERNELS = {
    "fused_update_vsweep": "cuda_recommender_tpu/ops/ccd_pallas.py:69",
    "masked_usweep": "cuda_recommender_tpu/solvers/ccd_dense.py:69",
    "masked_vsweep": "cuda_recommender_tpu/solvers/ccd_dense.py:69"}

#: the probe kernels -> (source, the Pallas call each replaces)
PROBES = {
    "stream_rmw": ("probe_kernels.cu", "scripts/panel_floor.py:86"),
    "stream_read": ("probe_kernels.cu", "scripts/panel_floor.py:100"),
    "panel_update_vsweep_irne": ("panel_kernels.cu",
                                 "scripts/panel_kernel_variants.py:95"),
    "gather": ("probe_kernels.cu", "scripts/probe_vmem_gather.py:65"),
    "gather_smem": ("probe_kernels.cu", "scripts/probe_vmem_gather.py:65"),
}
#: probe checks: small and ragged panels (3 x 2 is under one 16-byte
#: vector; 1100 x 264, whose rows start on 16-byte boundaries, is read on
#: the aligned path), then the scripts' own shapes (the headline's two
#: panels; the variant matrix's default)
PROBE_SMALL = ((50, 70), (1537, 300), (3, 2), (1100, 264))
PROBE_SCRIPT_SHAPES = ((330_128, 17_770), (150_061, 4_096),
                       (165_376, 18_432))
#: gather checks: (table rows, index rows): the probe's shape, a ragged
#: small one and the bench's rows tail at the headline; "limit" and "over"
#: stand for the largest 128-lane table the card's shared memory takes
#: (453 rows on the H100) and one row more
GATHER_CHECKS = ((8192, 4096), (37, 19), (417, 22_659), ("limit", 37),
                 ("over", 37))
#: elements (4 bytes each) an index or output view starts into its buffer,
#: (index, output): off a 16-byte boundary alike, and apart
GATHER_VIEWS = ((1, 1), (2, 3))
#: the bench's run lengths: the headline (>= 5 timed after 2 warm-ups) and
#: the two A/B runs
BENCH_ITERS = dict(iters=5, warmup=2)
BENCH_AB_ITERS = dict(iters=3, warmup=1)
#: the A/B runs: the auto stair, the auto orientation, the transposed stair
#: (items as rows; auto keeps users as rows at these dims)
BENCH_AB = (["--panel-widths", "auto"], ["--transpose", "auto"],
            ["--transpose", "1"])
#: the bench's s/iter must lie within this share of phase 4's
BENCH_S_ITER_TOL = 0.03
#: no control may read above this share of the card's peak rate
CONTROL_MAX_SHARE = 1.05

FP8 = torch.float8_e4m3fn
#: the fp8 instances of K1-K4 and the masked sweeps, each under its own
#: launch-count name (ops/panel_kernels.py::instance_name) -> what it
#: replaces: the Pallas call, or for the delta-first instances the XLA
#: update whose rounding order they store in
FP8_KERNELS = {
    "panel_update_vsweep_fp8": KERNELS["panel_update_vsweep"],
    "panel_update_vsweep_fp8_delta_first":
        "cuda_recommender_tpu/solvers/ccd_hybrid.py:621",
    "panel_vsweep_fp8": KERNELS["panel_vsweep"],
    "panel_usweep_fp8": KERNELS["panel_usweep"],
    "fused_update_vsweep_fp8": MASKED_KERNELS["fused_update_vsweep"],
    "fused_update_vsweep_fp8_delta_first":
        "cuda_recommender_tpu/solvers/ccd_dense.py:96",
    "masked_vsweep_fp8": MASKED_KERNELS["masked_vsweep"],
    "masked_usweep_fp8": MASKED_KERNELS["masked_usweep"]}
ORDERS = ("once", "delta_first")
#: phase 42: the K1-K3 panel 0 check (the headline's, at fp8)
FP8_PANEL0 = (330_128, 17_770)
#: phase 42's boundary grid (scripts/fp8_grid.py) at its deltas' own width
#: (None), and odd widths: every row starts at another byte of its 8-byte
#: units, so a pair of cells straddles a row's first and last unit
FP8_GRID_WIDTHS = (None, 1151, 257, 9)
#: phases 43-44: each iteration's fp8 RMSE within this of the bf16 (f32)
#: run's at the same iteration (the JAX package's fp8 bar against the
#: golden run, tests/test_hybrid.py:221-237)
FP8_RMSE_GAP = 0.05
#: phase 43: the fp8 hybrid runs' iterations; phase 44's runs'
FP8_ITERS = 2
#: phase 45: the rank-deferral group and its bars against the G = 0 run
#: (the JAX package's tests/test_hybrid.py:345-365: rtol, atol on W and H;
#: the RMSE an iteration)
DEFER_G = 8
DEFER_TOL = dict(rtol=1e-3, atol=1e-4)
DEFER_RMSE_TOL = 1e-4
#: phase 45 at the bf16 headline: the largest share of W's and of H's
#: entries that may lie beyond DEFER_TOL of phase 4's (measured 3.5e-5 of
#: W's, none of H's; a wrong flush or sign moves most of them)
DEFER_BEYOND_MAX = 1e-3

#: the H100 SXM data sheet's peaks (700 W): HBM bytes/s and f32 FLOP/s
#: outside the tensor cores; a kernel's bound is the larger of its bytes
#: and its operations over them
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12

#: bench.py's headline configuration (Netflix-100M dims)
HEADLINE = dict(m=480_189, n=17_770, nnz=100_000_000, k=40, lam=0.05,
                iters=3, budget=6_500_000_000, widths=(4096, 2048))
CHECK_SHAPES = ((50, 70), (65_536, 17_770))
RTOL = 1e-5            # g/h vs the plain version, scaled by sum(|terms|)
#: the column sweeps' alignment checks: widths of every residue mod 16 (8
#: cells a lane in 16-byte vectors at bf16, 32 bytes at f32, 8 for an int8
#: mask), W < 8 and W = 1 among them, and widths across 256-column strips;
#: a row count that is not a multiple of 8 or 64 (the kernels interleave
#: rows 64 to a band); and a few panels with fewer rows than a block has
#: warps
ALIGN_ROWS = 1031
ALIGN_WIDTHS = tuple(range(1, 18)) + (255, 257, 263, 520, 777)
ALIGN_EXTRA = ((1, 1), (3, 9), (9, 3), (5, 300))
#: elements a checked view starts into its buffer: its base is one element
#: off a 16-byte boundary, and guard cells lie on both sides of it
VIEW_OFFSET = 1
#: the row sweep's checks (K2, masked_usweep; ops/panel_kernels.py::
#: row_sweep_plan), shapes that take every case of its plan: W = 1, W < 8,
#: odd widths (rows start at every byte their cell size allows), M = 1 and
#: M under the SM count, one chunk, 2 and 8 chunks, one segment of 2 spans
#: with a ragged end, several segments with a ragged last one (M = 1
#: among them); each also as views at every offset (elements) that moves
#: its first cell within a 16-byte unit, and one row into its buffer
ROW_SWEEP_SHAPES = ((1, 1), (7, 1), (3, 5), (1, 7), (1031, 9), (130, 1031),
                    (65, 2049), (200, 8193), (37, 24_577), (1, 70_001))
#: ... and r1_t's panel 0 (Yahoo r1 transposed: 912 x 1,948,883, 238
#: segments), no view
ROW_SWEEP_WIDE = (912, 1_948_883)
#: panels whose row 1 ends and row 3 starts with a non-finite cell (NaN
#: beside a mask, where K4 at fp8 stores NaN on overflow; ±inf with the
#: NaN sentinel), as views at every offset: the rows beside them must keep
#: their own sums, one segment and several
ROW_SWEEP_NONFINITE = ((5, 1031), (4, 30_001))
#: the transposed stair's panel 0 (items as rows, 13,464 x 480,189 bf16):
#: an odd width at full size, so that every row starts at its own offset
ODD_PANEL = (13_464, 480_189)

#: the JAX package's ALS headline (scripts/bench_als_tpu.py:76-79): ml20M
#: dims, k=40, lambda=0.1, the gj solver, precision "highest"
ALS_HEADLINE = dict(m=138_493, n=26_744, nnz=20_000_000, k=40, lam=0.1,
                    iters=5)
#: K5 checks: (k, S) -- the edges of every instantiation (widths padded to
#: multiples of 8 up to 64, then 32-column slots) at a ragged S, and the
#: headline's two sides
GJ_CHECKS = tuple((k, 1037) for k in (1, 2, 8, 9, 16, 17, 32, 33, 40, 48, 63,
                                      64, 65, 128)) + ((40, 138_493),
                                                       (40, 26_744))
#: K5 timing (phase 9): k at the ALS headline's rows side
GJ_TIMED_KS = (10, 40, 128)
GJ_F64_TOL = 5e-4      # rtol = atol against the f64 solve (test_pallas.py:87)
GJ_F64_SYSTEMS = 4096  # systems checked against f64 at large S

#: the ALS gram kernel's checks (phase 3): every bucket (E, p) of the ALS
#: cells' layouts (benchmark/traffic ml20m and yahoo_r1 at their auto
#: floors, both sides) at k = 40, the lane-packed, a floor, a split and
#: the heaviest Yahoo item's bucket at every k of ALS_GRAM_KS
ALS_GRAM_SHAPES = (
    (32, 4), (71, 1), (77, 1), (136, 1), (163, 1), (246, 1), (320, 1),
    (410, 1), (504, 1), (537, 1), (653, 1), (1078, 1), (1144, 1),
    (1379, 1), (1398, 1), (2552, 1), (2900, 1), (3602, 1), (3734, 1),
    (6646, 1), (7169, 1), (9839, 1), (14335, 1), (17023, 1), (23683, 1),
    (28764, 1), (42223, 1), (74253, 1), (93337, 1), (121751, 1),
    (321304, 1), (1222764, 1))
ALS_GRAM_EDGES = ((32, 4), (77, 1), (2552, 1), (1222764, 1))
ALS_GRAM_KS = (1, 15, 40, 64, 128)
#: lanes of one check case at most (rows of a shape: as many as fit, at
#: least one), and the rows of the other side's table
ALS_GRAM_LANES = 1 << 21
ALS_GRAM_OTHER = 100_000
#: float32's unit roundoff: an f32 sum of n products by FMA is off the
#: exact one by at most (n - 1)·u·Σ|terms| (each addition rounds once),
#: and adding a slot's m segment sums m - 1 more roundings
F32_U = 2.0 ** -24

#: the JAX README's quick start (README.md:22-31): ml10M dims, k=10,
#: lambda=0.05, golden dual run, every other knob default (AUTO -> dense,
#: f32 residual, bf16 mask); 3 of its 5 iterations (the NumPy golden run
#: takes most of the phase, and the smoke has a time limit)
DENSE_HEADLINE = dict(m=69_878, n=10_677, nnz=10_000_000, k=10, lam=0.05,
                      iters=3)
MASKED_CHECK_SHAPES = ((50, 70), (69_878, 10_677))
#: the README's k=40 dense row (README.md:91): bf16 residual
DENSE_K40 = dict(k=40, iters=3)
#: the explicit-mask hybrid: Netflix-100M dims with the JAX Config defaults
#: (AUTO -> hybrid, auto stair, 2e9-cell budget, f32 residual, bf16 mask)
MASK_HYBRID = dict(k=40, lam=0.05, iters=2)
#: a golden entry that misses the reference's strict 10% bar may pass at
#: atol 1e-3 only as rounding at a near-zero entry: its reference value
#: below GOLDEN_MISS_REF and its error below GOLDEN_MISS_DIFF (a tenth of
#: that atol), so a wrong kernel cannot hide in the atol's slack
GOLDEN_MISS_REF = 1e-3
GOLDEN_MISS_DIFF = 1e-4


_PHASE = {"name": None, "t": 0.0}


def phase(name) -> None:
    """Start phase ``name`` (None: end the last); prints the last phase's
    wall seconds."""
    now = time.perf_counter()
    if _PHASE["name"] is not None:
        print(f"[time] phase {_PHASE['name'].split(' ')[0]}: "
              f"{now - _PHASE['t']:.1f} s", flush=True)
    _PHASE.update(name=name, t=now)
    if name is not None:
        print(f"\n=== {name} ===", flush=True)


def random_panel(M, W, dtype, device, seed):
    """NaN-sentinel panel (30% observed) and its four factor vectors."""
    gen = torch.Generator(device=device).manual_seed(seed)
    R = torch.randn((M, W), generator=gen, device=device, dtype=dtype)
    keep = torch.rand((M, W), generator=gen, device=device, dtype=dtype) < 0.3
    R.masked_fill_(~keep, float("nan"))
    del keep
    vecs = [torch.randn(n, generator=gen, device=device)
            for n in (M, M, W, W)]
    return R, vecs


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view({torch.bfloat16: torch.int16, FP8: torch.uint8}.get(
        x.dtype, torch.int32))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _close(name, got, want, scale, ratios, nonfinite=False) -> float:
    """max |got - want|; raises if any entry exceeds RTOL * scale. Appends
    the largest |got - want| / scale to ``ratios``. ``nonfinite``: got may
    hold NaN and ±inf where want holds the same, and only the entries
    finite in both (and in ``scale``) are held to the bar."""
    if nonfinite:
        same = ((torch.isnan(got) == torch.isnan(want))
                & (torch.isfinite(got) == torch.isfinite(want))
                & (torch.isfinite(got) | torch.isnan(got) | (got == want)))
        if not bool(same.all()):
            i = int(torch.argmin(same.to(torch.int8)))
            raise AssertionError(f"{name}: entry {i} got {float(got[i])} "
                                 f"want {float(want[i])}")
        fin = torch.isfinite(got) & torch.isfinite(want) & torch.isfinite(
            scale)
        if not bool(fin.any()):
            return 0.0
        got, want, scale = got[fin], want[fin], scale[fin]
    err = (got - want).abs()
    bad = err > RTOL * scale + 1e-30
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        i = int(torch.argmax((err - RTOL * scale).nan_to_num(float("inf"))))
        raise AssertionError(f"{name}: entry {i} got {float(got[i])} want "
                             f"{float(want[i])} (|sum terms| "
                             f"{float(scale[i])})")
    ratios.append(float((err / scale.clamp_min(1e-30)).max()))
    return float(err.max())


def check_kernels(device, shapes, dtypes=(torch.float32, torch.bfloat16),
                  worst=None) -> dict:
    """Each kernel vs its plain version on the same inputs: stored residual
    bit-equal, g/h within RTOL of sum(|terms|), repeat runs bit-identical.
    Returns ``worst`` updated to the max abs error of g/h per kernel."""
    from cuda_recommender_tpu_torch.ops import panel_kernels as pk

    worst = dict(worst or {name: 0.0 for name in KERNELS})
    for dtype in dtypes:
        for M, W in shapes:
            t0 = time.perf_counter()
            ratios = []
            Rd, (uo, up, vo, vp) = random_panel(M, W, dtype, device, seed=M)
            Rk, Rp = Rd.clone(), Rd.clone()
            gk, hk = pk.panel_update_vsweep(Rk, uo, up, vo, vp)
            _sync(device)
            gp, hp = pk.panel_update_vsweep_plain(Rp, uo, up, vo, vp)
            _sync(device)
            if not torch.equal(_bits(Rk), _bits(Rp)):
                n_bad = int((_bits(Rk) != _bits(Rp)).sum())
                raise AssertionError(f"K1 {dtype} {M}x{W}: stored residual "
                                     f"differs in {n_bad} cells")
            Rk2 = Rd.clone()
            del Rd
            gk2, hk2 = pk.panel_update_vsweep(Rk2, uo, up, vo, vp)
            _sync(device)
            if not (torch.equal(gk, gk2) and torch.equal(hk, hk2)
                    and torch.equal(_bits(Rk), _bits(Rk2))):
                raise AssertionError(f"K1 {dtype} {M}x{W}: not repeatable")
            del Rk2
            # sum(|terms|): the plain sweeps over |R| and |u|, |v|
            Ra = Rp.abs()
            sg, _ = pk.panel_vsweep_plain(Ra, uo.abs())
            su, _ = pk.panel_usweep_plain(Ra, vo.abs())
            del Ra
            err = max(_close("K1 g", gk, gp, sg, ratios),
                      _close("K1 h", hk, hp, hp, ratios))
            worst["panel_update_vsweep"] = max(worst["panel_update_vsweep"],
                                               err)

            g3, h3 = pk.panel_vsweep(Rk, up)
            _sync(device)
            g3p, h3p = pk.panel_vsweep_plain(Rp, up)
            s3, _ = pk.panel_vsweep_plain(Rp.abs(), up.abs())
            err3 = max(_close("K3 g", g3, g3p, s3, ratios),
                       _close("K3 h", h3, h3p, h3p, ratios))
            g3b, h3b = pk.panel_vsweep(Rk, up)
            if not (torch.equal(g3, g3b) and torch.equal(h3, h3b)):
                raise AssertionError(f"K3 {dtype} {M}x{W}: not repeatable")
            worst["panel_vsweep"] = max(worst["panel_vsweep"], err3)

            g2, h2 = pk.panel_usweep(Rk, vo)
            _sync(device)
            g2p, h2p = pk.panel_usweep_plain(Rp, vo)
            err2 = max(_close("K2 g", g2, g2p, su, ratios),
                       _close("K2 h", h2, h2p, h2p, ratios))
            g2b, h2b = pk.panel_usweep(Rk, vo)
            if not (torch.equal(g2, g2b) and torch.equal(h2, h2b)):
                raise AssertionError(f"K2 {dtype} {M}x{W}: not repeatable")
            worst["panel_usweep"] = max(worst["panel_usweep"], err2)
            _sync(device)
            print(f"[check] {str(dtype):15s} {M:6d}x{W:<6d} residual "
                  f"bit-equal, repeatable; max|dg|,|dh| K1 {err:.3e} "
                  f"K3 {err3:.3e} K2 {err2:.3e}; largest error / sum|terms| "
                  f"{max(ratios):.2e} (bar {RTOL})"
                  f" [{time.perf_counter() - t0:.1f} s]", flush=True)
            del Rk, Rp
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
    return worst


def want_launches(k, iters, inner, parts, masked=False) -> dict:
    """Launches of one CCD++ train() run: per rank and part (a panel, or
    the dense residual), the update + v-sweep kernel on the first inner
    iteration, the read-only v-sweep on each further one, the u-sweep on
    every one; the explicit-mask kernels (K4, masked_vsweep, masked_usweep)
    with ``masked``, else K1, K3, K2; no other kernel."""
    from cuda_recommender_tpu_torch.ops.launches import launch_counts
    want = {name: 0 for name in launch_counts()}
    per = k * iters * parts
    names = (("fused_update_vsweep", "masked_vsweep", "masked_usweep")
             if masked else ("panel_update_vsweep", "panel_vsweep",
                             "panel_usweep"))
    want.update(zip(names, (per, per * (inner - 1), per * inner)))
    return want


def run_headline(device, *, m, n, nnz, k, lam, iters, budget, widths,
                 metrics_file) -> dict:
    """train() at bench.py's headline configuration (-T 1, ``iters`` outer
    iterations), then one outer iteration at -T 2 on the same data. The
    launch counts are set to 0 once, just before the first run, and read
    after each run; returns the numbers of both, the first run's factors
    (rank-major, as CCD++ trains them) and the data's recall sample
    (cli/bench_serve.py's recall_sample), which the serving phases use."""
    from cuda_recommender_tpu_torch import Config, train
    from cuda_recommender_tpu_torch.cli.bench_serve import recall_sample
    from cuda_recommender_tpu_torch.core.metrics_log import MetricsLog
    from cuda_recommender_tpu_torch.data.datasets import synthetic_cached
    from cuda_recommender_tpu_torch.ops import launches as lc

    t0 = time.perf_counter()
    R, T = synthetic_cached(m, n, nnz, seed=1, test_fraction=0.02)
    data_s = time.perf_counter() - t0
    print(f"[headline] data {R.rows} x {R.cols}, train nnz {R.nnz}, test "
          f"nnz {T.nnz}: {data_s:.1f} s (host)", flush=True)

    def config(maxiter, inner):
        return Config(k=k, lambda_=lam, maxiter=maxiter, maxinneriter=inner,
                      backend="hybrid", residual_dtype="bfloat16",
                      mask_dtype="nan", hybrid_panel_kernel=True,
                      hybrid_dense_cells=budget, hybrid_panel_widths=widths,
                      metrics_file=metrics_file)

    log = MetricsLog(metrics_file)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    lc.reset_launch_counts()
    try:
        res = train(config(iters, 1), R, T, device=device, log=log)
        launches = lc.launch_counts()
        peak = (torch.cuda.max_memory_allocated()
                if torch.device(device).type == "cuda" else 0)
        print("[headline] -T 2, one outer iteration:", flush=True)
        res2 = train(config(1, 2), R, T, device=device, log=log)
    finally:
        log.close()
    total = lc.launch_counts()
    launches2 = {name: total[name] - launches[name] for name in total}
    with open(metrics_file) as f:
        events = [json.loads(line) for line in f]
    plan_ev = [e for e in events if e["kind"] == "hybrid_plan"][0]
    P = len(plan_ev["panels"])
    rmse = [st.rmse for st in res.stats]
    it_s = [st.rank_time for st in res.stats]
    steady = it_s[1:] if len(it_s) > 1 else it_s
    s_iter = sum(steady) / len(steady)
    rate = R.nnz * k / s_iter
    print(f"[headline] plan: {P} panels {plan_ev['panels']}, "
          f"{plan_ev['panel_cells']} cells, tail nnz {plan_ev['nnz_light']} "
          f"({100.0 * plan_ev['nnz_light'] / R.nnz:.2f}% of nnz); plan "
          f"{plan_ev['plan_s']:.1f} s (host), device set-up "
          f"{plan_ev['setup_s']:.1f} s", flush=True)
    print(f"[headline] RMSE per iteration {rmse}; s/iter {it_s}", flush=True)
    print(f"[headline] s/iter (iterations 2-{len(it_s)}): {s_iter:.4f}; "
          f"rating-updates/s: {rate:.4e} ({rate / 1e6:.1f} M); peak device "
          f"memory {peak / 2**30:.2f} GiB; launches {launches}", flush=True)
    rmse2 = [st.rmse for st in res2.stats]
    print(f"[headline] -T 2: RMSE {rmse2}, s/iter "
          f"{[st.rank_time for st in res2.stats]}; launches {launches2}",
          flush=True)
    if not all(math.isfinite(r) for r in rmse + rmse2):
        raise AssertionError(f"non-finite RMSE {rmse}, -T 2 {rmse2}")
    if len(rmse) != iters or not all(r < rmse[0] for r in rmse[1:]):
        raise AssertionError(f"RMSE does not fall after iteration 1: {rmse}")
    for got, inner, n_it in ((launches, 1, iters), (launches2, 2, 1)):
        want = want_launches(k, n_it, inner, P)
        if got != want:
            raise AssertionError(f"-T {inner}: launches {got}, want {want} "
                                 f"(k={k}, {n_it} iterations, {P} panels)")
    print(f"[headline] launches in all {total}", flush=True)
    W, H = res.W, res.H
    del res, res2
    torch.cuda.empty_cache()
    return dict(panels=plan_ev["panels"], s_iter=s_iter, rate=rate,
                peak=peak, launches=total, rmse=rmse, W=W, H=H,
                recall=recall_sample(R, T, threshold=4.0), data=(R, T))


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take for work
    that moves ``nbytes`` (each input read once, each output written once)
    and does ``flops`` f32 operations, at the data sheet's peaks."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _sweep_times(calls, what, reps) -> dict:
    """scripts/sweep_timing.py's time_sweeps on ``calls`` (each kernel
    against its plain version, warm, in turns plain, kernel, kernel, plain)
    with each one's bound (``_bounded``)."""
    from cuda_recommender_tpu_torch.scripts import sweep_timing as st

    return _bounded(st.time_sweeps(calls, what, torch.device("cuda"), reps))


def _bounded(got) -> dict:
    """time_sweeps' records with each one's bound, printed: name -> (ms,
    plain_ms, bound_ms, bound_by)."""
    out = {}
    for key, rec in got.items():
        b_ms, b_by = bound(rec["bytes"], rec["flops"])
        out[key.split(" ")[0]] = (rec["ms"], rec["plain_ms"], b_ms, b_by)
        print(f"[timing] {key}: bound {b_ms:.3f} ms ({b_by}), "
              f"{100 * b_ms / rec['ms']:.1f}% of it", flush=True)
    return out


def time_kernels(M, W, reps=5) -> dict:
    """K1, K2 and K3 against their plain versions at one bf16 panel shape
    (scripts/sweep_timing.py::nan_sweeps: the calls, their bytes and
    flops). Returns name -> (ms, plain_ms, bound_ms, bound_by)."""
    from cuda_recommender_tpu_torch.scripts import sweep_timing as st

    calls = st.nan_sweeps(M, W, torch.device("cuda"), seed=7)
    out = _sweep_times(calls, f"{M}x{W} bf16", reps)
    del calls
    torch.cuda.empty_cache()
    return out


#: the CLI run's RMSE must also match the reference's at every iteration
RMSE_TOL = 1e-4


def _check_golden(what, stdout) -> list:
    """The CLI's golden check: W and H each PASS! the reference's strict
    per-entry 10% bar (src/extras.cpp:218-238), or, where a near-zero entry
    misses it by rounding, PASS with atol 1e-3 (the compiled-backend tests'
    bar; PERF.md, Open questions) with every strict miss a rounding miss
    (_check_misses). Returns the two strict verdicts."""
    checks = re.findall(r"^Check\.\.\. (.*)$", stdout, re.M)
    if checks == ["PASS!", "PASS!"]:
        return checks
    near = re.search(r"^\[info\] golden with atol 0\.001: W (.*), H (.*)$",
                     stdout, re.M)
    if not (near and near.groups() == ("PASS", "PASS")):
        raise AssertionError(f"{what} golden check of W and H: {checks}, "
                             f"with atol 1e-3: {near and near.groups()}")
    found = re.search(r"^\[info\] golden misses: W max\|ref\| (\S+) max\|"
                      r"diff\| (\S+), H max\|ref\| (\S+) max\|diff\| (\S+)$",
                      stdout, re.M)
    if found is None:
        raise AssertionError(f"{what}: the CLI printed no golden misses line")
    x = [float(v) for v in found.groups()]
    _check_misses(what, [(x[0], x[1]), (x[2], x[3])])
    return checks + ["with atol 1e-3 PASS, PASS"]


def run_cli() -> None:
    """The CLI at -T 2 with the golden check (_check_golden) and K3
    launched at least once."""
    cmd = [sys.executable, "-m", "cuda_recommender_tpu_torch.cli.train",
           "--dataset", "synthetic:m=6040,n=3706,nnz=900000", "-k", "10",
           "-t", "3", "-T", "2", "--backend", "hybrid", "--mask-dtype", "nan",
           "--panel-kernel", "--residual-dtype", "float32", "--golden",
           "--device", "cuda"]
    print("[cli] " + " ".join(cmd[1:]), flush=True)
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=600)
    print(res.stdout + res.stderr, flush=True)
    if res.returncode != 0:
        raise AssertionError(f"CLI exited {res.returncode}")
    checks = _check_golden("hybrid CLI", res.stdout)
    rmse = [float(x) for x in re.findall(r"RMSE=([0-9.]+)", res.stdout)]
    ours, ref = rmse[:3], rmse[3:6]
    if len(rmse) != 6 or max(abs(a - b) for a, b in zip(ours, ref)) > RMSE_TOL:
        raise AssertionError(f"RMSE hybrid {ours} vs reference {ref}")
    m = re.search(r"^\[info\] kernel launches: (\{.*\})$", res.stdout, re.M)
    launches = json.loads(m.group(1))
    print(f"[cli] panel_vsweep launched {launches['panel_vsweep']} times at "
          f"-T 2", flush=True)
    if launches["panel_vsweep"] <= 0:
        raise AssertionError("panel_vsweep never launched at -T 2")
    print(f"[cli] golden W, H {checks}; RMSE hybrid {ours} = reference "
          f"{ref} within {RMSE_TOL}; launches {launches} "
          f"[{time.perf_counter() - t0:.1f} s]", flush=True)


def gj_layouts(A, b):
    """K5's two input layouts: separate A and b, and views of one
    (S, k+1, k+1) augmented gram as the ALS assembly passes them
    (solvers/als_ell.py), its base one float off a 16-byte boundary."""
    S, k = b.shape
    yield "separate", A, b
    buf = torch.full((S * (k + 1) ** 2 + 2 * VIEW_OFFSET,), -7.0,
                     device=A.device)
    aug = buf[VIEW_OFFSET:VIEW_OFFSET + S * (k + 1) ** 2].view(S, k + 1,
                                                                k + 1)
    aug[:, :k, :k], aug[:, :k, k] = A, b
    aug[:, k, :] = 5.0                  # the gram's last row, never read
    yield "ALS gram", aug[:, :k, :k], aug[:, :k, k]


def check_gj(checks=GJ_CHECKS) -> float:
    """K5 against its plain version on the same systems, on both layouts
    (gj_layouts): x bit-equal (0 entries differ, asserted), repeat runs
    bit-identical, both within GJ_F64_TOL of the f64 solve (all systems,
    or the first GJ_F64_SYSTEMS and the last 37 at large S). Returns the
    largest |x - x_plain| (0 when every check passed)."""
    from cuda_recommender_tpu_torch.ops import gj_kernels as gk
    from cuda_recommender_tpu_torch.scripts.sweep_timing import spd_systems

    worst = 0.0
    for k, S in checks:
        t0 = time.perf_counter()
        A, b = spd_systems(k, S, "cuda", seed=k * 7919 + S)
        xp = gk.gj_solve_plain(A, b)
        sub = (torch.arange(S, device=A.device) if S <= GJ_F64_SYSTEMS
               else torch.cat([torch.arange(GJ_F64_SYSTEMS, device=A.device),
                               torch.arange(S - 37, S, device=A.device)]))
        ref = torch.linalg.solve(A[sub].double(), b[sub].double())
        f64 = {}
        for name, Av, bv in gj_layouts(A, b):
            x = gk.gj_solve(Av, bv)
            x2 = gk.gj_solve(Av, bv)
            torch.cuda.synchronize()
            n_bits = int((x.view(torch.int32) != xp.view(torch.int32)).sum())
            worst = max(worst, float((x - xp).abs().max()))
            if n_bits or not (bool(torch.isfinite(x).all()) and torch.equal(
                    x.view(torch.int32), x2.view(torch.int32))):
                raise AssertionError(f"K5 k={k} S={S} {name}: {n_bits} of "
                                     f"{x.numel()} entries differ in bits "
                                     f"from the plain version, or x is not "
                                     f"finite, or a repeat run differs")
            d = (x[sub].double() - ref).abs()
            if bool((d > GJ_F64_TOL * (1 + ref.abs())).any()):
                raise AssertionError(f"K5 k={k} S={S} {name}: off the f64 "
                                     f"solve by {float(d.max()):.3e}")
            f64[name] = float(d.max())
            del x, x2
        print(f"[check] gj_solve k={k:3d} S={S:6d}: 0 of {xp.numel()} "
              f"entries differ in bits from the plain version, separate "
              f"tensors and ALS gram views; repeatable; max|x - f64| "
              f"{f64['separate']:.3e} (bar {GJ_F64_TOL}) "
              f"[{time.perf_counter() - t0:.1f} s]", flush=True)
        del A, b, xp, ref
        torch.cuda.empty_cache()
    return worst


def _gram_case(E, p, k, device, seed, vec=True):
    """One row group of a bucket (E, p) at rank k: as many rows as fit
    ALS_GRAM_LANES lanes (at least one); seeded counts in [0, E], the
    first slot full and the last empty; lanes past a slot's count point at
    the zero slot (row ALS_GRAM_OTHER) with value 0, as data/ell.py fills
    them; ``vec=False`` puts the table 4 bytes past a 16-byte boundary
    (the kernel's 4-byte copies)."""
    rows = max(1, ALS_GRAM_LANES // (E * p))
    S, n = rows * p, ALS_GRAM_OTHER
    gen = torch.Generator(device=device).manual_seed(seed)
    counts = torch.randint(0, E + 1, (S,), generator=gen, device=device)
    counts[0] = E
    if S > 1:
        counts[-1] = 0
    real = torch.arange(E, device=device)[None, :] < counts[:, None]
    idx = torch.where(real, torch.randint(0, n, (S, E), generator=gen,
                                          device=device), n)
    val = torch.where(real, 1 + 4 * torch.rand((S, E), generator=gen,
                                               device=device), 0.0)
    base = torch.randn(n * k + (0 if vec else 1), generator=gen,
                       device=device)
    other = base[(0 if vec else 1):].view(n, k)
    return (idx.reshape(rows, E * p), val.reshape(rows, E * p),
            counts.float(), other)


def check_als_gram(device, shapes=None) -> float:
    """Phase 3: ``als_gram`` (csrc/als_kernels.cu) against an f64 gram of
    the same real lanes: every bucket shape of ALS_GRAM_SHAPES at k = 40
    and ALS_GRAM_EDGES at every k of ALS_GRAM_KS, one on a table off a
    16-byte boundary. Each entry within (lanes + segments)·u·Σ|terms| of
    the f64 gram (the f32 summation's bound, ``F32_U``), the gram
    symmetric bit for bit, empty slots exactly 0, a second run bit-equal,
    and the launches ``launches_per_call`` a call. Returns the largest
    error as a share of its bound."""
    from cuda_recommender_tpu_torch.ops import als_kernels as ak
    from cuda_recommender_tpu_torch.ops import launches as lc

    shapes = ALS_GRAM_SHAPES if shapes is None else shapes
    cases = ([(E, p, 40, True) for E, p in shapes]
             + [(E, p, k, True) for E, p in ALS_GRAM_EDGES
                for k in ALS_GRAM_KS if k != 40]
             + [(E, p, 40, False) for E, p in ALS_GRAM_EDGES[:1]])
    t0 = time.perf_counter()
    worst, calls = 0.0, 0
    lc.reset_launch_counts()
    for i, (E, p, k, vec) in enumerate(cases):
        idx, val, counts, other = _gram_case(E, p, k, device, 100 + i, vec)
        got = ak.als_gram(idx, val, counts, other, E, p)
        again = ak.als_gram(idx, val, counts, other, E, p)
        calls += 2 * ak.launches_per_call(E)
        torch.cuda.synchronize()
        S = counts.shape[0]
        table = torch.cat([other.double(), other.new_zeros((1, k),
                                                           dtype=torch.float64)])
        f = table[idx.reshape(S, E)]
        f = torch.cat([f, val.reshape(S, E, 1).double()], dim=2)
        want = torch.bmm(f.transpose(1, 2), f)
        terms = torch.bmm(f.abs().transpose(1, 2), f.abs())
        del f
        lanes = min(E, ak.SEGMENT_LANES) + ak.segments(E)
        bar = lanes * F32_U * terms
        err = (got.double() - want).abs()
        what = f"als_gram E={E} p={p} k={k}" + ("" if vec else " (4-byte)")
        if bool((err > bar).any()):
            raise AssertionError(f"{what}: off the f64 gram by "
                                 f"{float(err.max()):.3e} over the bar")
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            raise AssertionError(f"{what}: two runs differ in bits")
        if not torch.equal(got.view(torch.int32),
                           got.transpose(1, 2).view(torch.int32)):
            raise AssertionError(f"{what}: not symmetric bit for bit")
        if bool(got[counts == 0].any()):
            raise AssertionError(f"{what}: an empty slot's gram is not 0")
        share = float((err / bar.clamp_min(1e-300)).max())
        worst = max(worst, share)
        print(f"[check] {what}: S {S}, {int(counts.sum())} real lanes of "
              f"{S * E}; max |got - f64| {float(err.max()):.3e}, "
              f"{100 * share:.2f}% of its bound; repeatable, symmetric",
              flush=True)
        del idx, val, counts, other, got, again, want, terms, err, bar
    got = lc.launch_counts()["als_gram"]
    if got != calls:
        raise AssertionError(f"als_gram launches {got}, want {calls}")
    print(f"[check] als_gram: {len(cases)} cases, {calls} launches, "
          f"largest error {100 * worst:.2f}% of its bound "
          f"[{time.perf_counter() - t0:.1f} s]", flush=True)
    torch.cuda.empty_cache()
    return worst


def time_als_gram(reps=3) -> dict:
    """The ALS gram kernel over one outer iteration's groups at the ALS
    headline's layout (phase 8's data; ``sweep_timing.als_assemblies``,
    k = 40) against
    its plain version, which is also the library yardstick (the gather and
    f32 bmm the port ran before the kernel), in turns plain, kernel,
    kernel, plain. Returns ms, plain_ms, library_ms, bound_ms, bound_by."""
    from cuda_recommender_tpu_torch.data.datasets import synthetic_cached
    from cuda_recommender_tpu_torch.data.ell import build_ell_pair
    from cuda_recommender_tpu_torch.scripts import sweep_timing as st

    A = ALS_HEADLINE
    R, _ = synthetic_cached(A["m"], A["n"], A["nnz"], seed=1,
                            test_fraction=0.02)
    calls = st.als_assemblies(build_ell_pair(R, min_width="auto"), A["k"],
                              torch.device("cuda"), seed=13)
    rec = st.time_sweeps(calls, "ALS headline, an iteration",
                         torch.device("cuda"), reps)[
        "als_gram ALS headline, an iteration"]
    b_ms, b_by = bound(rec["bytes"], rec["flops"])
    print(f"[timing] als_gram an iteration: bound {b_ms:.3f} ms ({b_by}), "
          f"{100 * b_ms / rec['ms']:.1f}% of it; kernel "
          f"{rec['flops'] / rec['ms'] / 1e9:.2f} TFLOP/s on the full "
          f"(k+1)^2", flush=True)
    del calls
    torch.cuda.empty_cache()
    return dict(ms=rec["ms"], plain_ms=rec["plain_ms"],
                library_ms=rec["plain_ms"], bound_ms=b_ms, bound_by=b_by)


def run_als_headline(device, *, m, n, nnz, k, lam, iters,
                     metrics_file) -> dict:
    """train() at the ALS headline (ml20M dims, ``iters`` outer
    iterations); the launch counts are set to 0 just before it and read
    just after. Then one outer step from the initial state with the
    kernel (solver gj) and with the plain solve (gj_xla), compared."""
    from cuda_recommender_tpu_torch import Config, train
    from cuda_recommender_tpu_torch.core.init import init_factors_np
    from cuda_recommender_tpu_torch.core.metrics_log import MetricsLog
    from cuda_recommender_tpu_torch.data.datasets import synthetic_cached
    from cuda_recommender_tpu_torch.data.ell import build_ell_pair
    from cuda_recommender_tpu_torch.ops import launches as lc
    from cuda_recommender_tpu_torch.solvers import als_ell
    from cuda_recommender_tpu_torch.solvers.als_state import (
        als_state_from_numpy, slot_payload)

    t0 = time.perf_counter()
    # generated into the cache, then read back: a generated matrix keeps
    # each column's entries in draw order, a cached one is rebuilt in row
    # order, and ALS walks the columns, so the runs held bit-equal to this
    # one (phase 36) read the cached matrix as this one does
    synthetic_cached(m, n, nnz, seed=1, test_fraction=0.02)
    R, T = synthetic_cached(m, n, nnz, seed=1, test_fraction=0.02)
    data_s = time.perf_counter() - t0
    print(f"[als] data {R.rows} x {R.cols}, train nnz {R.nnz}, test nnz "
          f"{T.nnz}: {data_s:.1f} s (host)", flush=True)
    cfg = Config(solver="als", k=k, lambda_=lam, maxiter=iters,
                 als_solver="gj", als_precision="highest",
                 metrics_file=metrics_file)
    log = MetricsLog(metrics_file)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lc.reset_launch_counts()
    try:
        res = train(cfg, R, T, device=device, log=log)
    finally:
        log.close()
    launches = lc.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    with open(metrics_file) as f:
        plan = [e for e in map(json.loads, f) if e["kind"] == "als_plan"][0]
    per_iter = plan["k5_launches_per_iter"]
    rmse = [st.rmse for st in res.stats]
    it_s = [st.rank_time for st in res.stats]
    s_iter = sum(it_s[1:]) / len(it_s[1:])
    rate = R.nnz / s_iter
    for name, side in plan["sides"].items():
        print(f"[als] {name} side: floor {side['min_width']}, widths "
              f"{side['widths']}, rows {side['rows']}, slots "
              f"{side['n_slots']}, padded lanes {side['padded_lanes']}, "
              f"groups {side['groups']}", flush=True)
    print(f"[als] plan {plan['plan_s']:.2f} s (host), device set-up "
          f"{plan['setup_s']:.2f} s; K5 launches per iteration {per_iter}",
          flush=True)
    print(f"[als] RMSE per iteration {rmse}; s/iter {it_s}", flush=True)
    print(f"[als] s/iter (iterations 2-{len(it_s)}): {s_iter:.4f}; "
          f"ratings/s: {rate:.4e}; peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {launches}", flush=True)
    if not all(math.isfinite(r) for r in rmse) or len(rmse) != iters:
        raise AssertionError(f"ALS RMSE {rmse}")
    if not all(r < rmse[0] for r in rmse[1:]):
        raise AssertionError(f"ALS RMSE does not fall after iteration 1: "
                             f"{rmse}")
    want = {name: 0 for name in launches}
    want["gj_solve"] = per_iter * iters
    want["als_gram"] = plan["als_gram_launches_per_iter"] * iters
    if launches != want:
        raise AssertionError(f"ALS launches {launches}, want {want}")

    # one outer step from the initial state: kernel against plain solve
    W0, H0 = init_factors_np(k, R.rows, R.cols, seed=cfg.seed,
                             entity_major=True)
    ell = build_ell_pair(R, min_width=cfg.als_min_width)
    idx_r, vals_r = als_ell.side_tensors(ell.rows_side, device)
    idx_c, vals_c = als_ell.side_tensors(ell.cols_side, device)
    nnz_r = torch.as_tensor(ell.rows_side.slot_nnz, device=device)
    nnz_c = torch.as_tensor(ell.cols_side.slot_nnz, device=device)
    out = {}
    for solver in ("gj", "gj_xla"):
        W, H = als_state_from_numpy(slot_payload(ell, W0, H0), ell, device)
        step = als_ell.make_als_outer_step(ell, lam, solver=solver)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out[solver] = step(idx_r, idx_c, vals_r, vals_c, W, H, nnz_r, nnz_c)
        torch.cuda.synchronize()
        print(f"[als] one outer step, solver {solver}: "
              f"{time.perf_counter() - t1:.4f} s", flush=True)
    for name, a, b in zip("WH", out["gj"], out["gj_xla"]):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"ALS step {name}: gj vs gj_xla not "
                                 f"bit-equal, max|diff| "
                                 f"{float((a - b).abs().max()):.3e}")
        print(f"[als] step {name}: gj bit-equal to gj_xla", flush=True)
    W_em, H_em = res.W, res.H
    del R, T, res, out, idx_r, vals_r, idx_c, vals_c
    torch.cuda.empty_cache()
    return dict(s_iter=s_iter, rate=rate, peak=peak, launches=launches,
                rmse=rmse, per_iter=per_iter, W=W_em, H=H_em)


def time_gj(k, S=ALS_HEADLINE["m"], reps=5) -> dict:
    """K5 against its plain version and the one PyTorch call that computes
    its function (``torch.linalg.solve``, batched LU; the port never calls
    it) at (k, S), warm, in turns plain, library, kernel, kernel, library,
    plain (scripts/sweep_timing.py::gj_solves: the calls, their bytes and
    the elimination's flops). Returns ms, plain_ms, library_ms, bound_ms,
    bound_by."""
    from cuda_recommender_tpu_torch.scripts import sweep_timing as st

    calls = st.gj_solves(k, S, torch.device("cuda"), seed=11)
    rec = st.time_sweeps(calls, f"S={S} k={k}", torch.device("cuda"),
                         reps)[f"gj_solve S={S} k={k}"]
    b_ms, b_by = bound(rec["bytes"], rec["flops"])
    print(f"[timing] gj_solve S={S} k={k}: torch.linalg.solve "
          f"{rec['library_ms']:.3f} ms; bound {b_ms:.3f} ms ({b_by}), "
          f"{100 * b_ms / rec['ms']:.1f}% of it; kernel "
          f"{rec['flops'] / rec['ms'] / 1e9:.2f} TFLOP/s of elimination",
          flush=True)
    del calls
    torch.cuda.empty_cache()
    return dict(ms=rec["ms"], plain_ms=rec["plain_ms"],
                library_ms=rec["library_ms"], bound_ms=b_ms, bound_by=b_by)


#: the ALS CLI run's golden bar: the JAX package's own ALS golden bar
#: (tests/test_trainer.py:29-34), at most 1.0% of entries off by 10%
ALS_GOLDEN_PCT = 1.0


def run_als_cli() -> None:
    """The CLI with -ALS --golden: every iteration's RMSE within RMSE_TOL of
    the reference's, W and H each PASS! or NO PASS! under ALS_GOLDEN_PCT,
    K5 launched."""
    cmd = [sys.executable, "-m", "cuda_recommender_tpu_torch.cli.train",
           "--dataset", "synthetic:m=6040,n=3706,nnz=900000", "-k", "10",
           "-t", "3", "-ALS", "--golden", "--device", "cuda"]
    print("[cli] " + " ".join(cmd[1:]), flush=True)
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=600)
    print(res.stdout + res.stderr, flush=True)
    if res.returncode != 0:
        raise AssertionError(f"ALS CLI exited {res.returncode}")
    checks = re.findall(r"^Check\.\.\. (.*)$", res.stdout, re.M)
    pcts = [0.0 if c == "PASS!" else float(re.search(
        r"NO PASS! \[([0-9.]+)%\]", c).group(1)) for c in checks]
    if len(checks) != 2 or max(pcts) >= ALS_GOLDEN_PCT:
        raise AssertionError(f"ALS golden check of W and H: {checks}")
    rmse = [float(x) for x in re.findall(r"RMSE=([0-9.]+)", res.stdout)]
    ours, ref = rmse[:3], rmse[3:6]
    if len(rmse) != 6 or max(abs(a - b)
                             for a, b in zip(ours, ref)) > RMSE_TOL:
        raise AssertionError(f"RMSE ell {ours} vs reference {ref}")
    m = re.search(r"^\[info\] kernel launches: (\{.*\})$", res.stdout, re.M)
    launches = json.loads(m.group(1))
    if launches["gj_solve"] <= 0:
        raise AssertionError("gj_solve never launched by the ALS CLI")
    print(f"[cli] golden W, H {checks} (bar < {ALS_GOLDEN_PCT}%); RMSE ell "
          f"{ours} = reference {ref} within {RMSE_TOL}; launches {launches} "
          f"[{time.perf_counter() - t0:.1f} s]", flush=True)


def random_masked(m, n, dtype, mask_dtype, device, seed):
    """Residual 0 off a 30% {0,1} mask, the mask, and four factor
    vectors."""
    gen = torch.Generator(device=device).manual_seed(seed)
    keep = torch.rand((m, n), generator=gen, device=device) < 0.3
    R = torch.randn((m, n), generator=gen, device=device, dtype=dtype)
    R.masked_fill_(~keep, 0.0)
    M = keep.to(mask_dtype)
    del keep
    vecs = [torch.randn(x, generator=gen, device=device)
            for x in (m, m, n, n)]
    return R, M, vecs


def check_masked_kernels(device, shapes, worst=None,
                         dtypes=(torch.float32, torch.bfloat16),
                         mask_dtypes=(torch.bfloat16, torch.int8)) -> dict:
    """K4, masked_vsweep and masked_usweep vs their plain versions on the
    same inputs, each residual dtype x each mask dtype: stored residual
    bit-equal, unobserved cells exactly +0, g/h within RTOL of sum(|terms|),
    repeat runs bit-identical. Returns ``worst`` updated to the max abs
    error of g/h per kernel."""
    from cuda_recommender_tpu_torch.ops import ccd_kernels as ck

    worst = dict(worst or {name: 0.0 for name in MASKED_KERNELS})
    for dtype in dtypes:
        for mdt in mask_dtypes:
            for m, n in shapes:
                t0 = time.perf_counter()
                ratios = []
                what = f"{str(dtype)[6:]} residual, {str(mdt)[6:]} mask, " \
                       f"{m}x{n}"
                R, M, (ua, us, va, vs) = random_masked(m, n, dtype, mdt,
                                                       device, seed=m + n)
                Rk, Rp = R.clone(), R.clone()
                gk, hk = ck.fused_update_vsweep(Rk, M, ua, us, va, vs)
                _sync(device)
                gp, hp = ck.fused_update_vsweep_plain(Rp, M, ua, us, va, vs)
                _sync(device)
                if not torch.equal(_bits(Rk), _bits(Rp)):
                    n_bad = int((_bits(Rk) != _bits(Rp)).sum())
                    raise AssertionError(f"K4 {what}: stored residual "
                                         f"differs in {n_bad} cells")
                if bool((_bits(Rk)[M == 0] != 0).any()):
                    raise AssertionError(f"K4 {what}: an unobserved cell "
                                         "is not +0")
                Rk2 = R.clone()
                del R
                gk2, hk2 = ck.fused_update_vsweep(Rk2, M, ua, us, va, vs)
                _sync(device)
                if not (torch.equal(gk, gk2) and torch.equal(hk, hk2)
                        and torch.equal(_bits(Rk), _bits(Rk2))):
                    raise AssertionError(f"K4 {what}: not repeatable")
                del Rk2
                # sum(|terms|): the plain sweeps over |R| and |u|, |v|
                Ra = Rp.abs()
                sg, _ = ck.masked_vsweep_plain(Ra, M, ua.abs())
                s3, _ = ck.masked_vsweep_plain(Ra, M, us.abs())
                su, _ = ck.masked_usweep_plain(Ra, M, va.abs())
                del Ra
                err4 = max(_close("K4 g", gk, gp, sg, ratios),
                           _close("K4 h", hk, hp, hp, ratios))
                g3, h3 = ck.masked_vsweep(Rk, M, us)
                _sync(device)
                g3p, h3p = ck.masked_vsweep_plain(Rp, M, us)
                err3 = max(_close("masked_vsweep g", g3, g3p, s3, ratios),
                           _close("masked_vsweep h", h3, h3p, h3p, ratios))
                g2, h2 = ck.masked_usweep(Rk, M, va)
                _sync(device)
                g2p, h2p = ck.masked_usweep_plain(Rp, M, va)
                err2 = max(_close("masked_usweep g", g2, g2p, su, ratios),
                           _close("masked_usweep h", h2, h2p, h2p, ratios))
                g3b, h3b = ck.masked_vsweep(Rk, M, us)
                g2b, h2b = ck.masked_usweep(Rk, M, va)
                _sync(device)
                if not (torch.equal(g3, g3b) and torch.equal(h3, h3b)
                        and torch.equal(g2, g2b) and torch.equal(h2, h2b)):
                    raise AssertionError(f"masked sweeps {what}: not "
                                         "repeatable")
                for name, err in (("fused_update_vsweep", err4),
                                  ("masked_vsweep", err3),
                                  ("masked_usweep", err2)):
                    worst[name] = max(worst[name], err)
                print(f"[check] {what}: residual bit-equal, unobserved +0, "
                      f"repeatable; max|dg|,|dh| K4 {err4:.3e} masked_vsweep "
                      f"{err3:.3e} masked_usweep {err2:.3e}; largest error / "
                      f"sum|terms| {max(ratios):.2e} (bar {RTOL}) "
                      f"[{time.perf_counter() - t0:.1f} s]", flush=True)
                del Rk, Rp, M
                torch.cuda.empty_cache()
    return worst


#: the guard cells' bits: a NaN with a payload that no arithmetic on the
#: card leaves in place (its NaNs are 0x7FFFFFFF), so a stray store of a
#: guard cell shows even where it writes back what it read
GUARD_BITS = {torch.bfloat16: 0x7F81, torch.float32: 0x7F800001,
              FP8: 0xFF}


def _guarded_view(X: torch.Tensor, offset: int):
    """(buffer, view): X copied into a contiguous view ``offset`` elements
    into a buffer whose other cells hold GUARD_BITS."""
    n = X.numel()
    buf = torch.empty((n + offset + 24,), dtype=X.dtype, device=X.device)
    _bits(buf).fill_(GUARD_BITS[X.dtype])
    view = buf[offset:offset + n].view(X.shape)
    view.copy_(X)
    return buf, view


def _hold(what, kern, plain, scale, X, offset, ratios,
          nonfinite=False, same_view=False) -> float:
    """``kern`` against ``plain`` on copies of the panel X (the kernel's in
    a guarded view ``offset`` elements into its buffer, unless None):
    stored residual bit-equal, guard cells untouched, a second kernel run
    (on a fresh copy; with ``same_view``, a read-only sweep whose sum order
    follows the rows' alignment, on the same view) bit-identical, g and h
    within RTOL of sum(|terms|) (``scale`` of the stored panel for g, h
    itself; ``nonfinite`` as ``_close``). Returns the largest |g, h
    error|."""
    n = X.numel()
    if offset is None:
        buf, Rk = None, X.clone()
    else:
        buf, Rk = _guarded_view(X, offset)
        guard = buf.clone()
    Rp, R2 = X.clone(), X.clone()
    gk, hk = kern(Rk)
    gp, hp = plain(Rp)
    g2, h2 = kern(Rk if same_view else R2)
    _sync(X.device)
    if not torch.equal(_bits(Rk), _bits(Rp)):
        raise AssertionError(f"{what}: stored residual differs in "
                             f"{int((_bits(Rk) != _bits(Rp)).sum())} cells")
    if not (torch.equal(_bits(gk), _bits(g2))
            and torch.equal(_bits(hk), _bits(h2))
            and torch.equal(_bits(Rk), _bits(R2))):
        raise AssertionError(f"{what}: not repeatable")
    if buf is not None and not (
            torch.equal(_bits(buf[:offset]), _bits(guard[:offset])) and
            torch.equal(_bits(buf[offset + n:]), _bits(guard[offset + n:]))):
        raise AssertionError(f"{what}: a guard cell changed")
    return max(_close(f"{what} g", gk, gp, scale(Rp), ratios, nonfinite),
               _close(f"{what} h", hk, hp, hp, ratios, nonfinite))


def check_alignment(device) -> dict:
    """The column sweeps at every row alignment their 16-byte vectors
    branch on: K1, K3 and the rounding variant (NaN sentinel), K4 and
    masked_vsweep (bf16 and int8 masks), at f32 and bf16 residuals, at
    ALIGN_ROWS x ALIGN_WIDTHS and ALIGN_EXTRA, each on the panel itself and
    on a view VIEW_OFFSET elements into a guarded buffer (_hold). Returns
    each kernel's largest |g, h error|."""
    from cuda_recommender_tpu_torch.ops import ccd_kernels as ck
    from cuda_recommender_tpu_torch.ops import panel_kernels as pk

    t0 = time.perf_counter()
    worst, ratios = {}, []
    shapes = [(ALIGN_ROWS, w) for w in ALIGN_WIDTHS] + list(ALIGN_EXTRA)
    for M, W in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            R, (uo, up, vo, vp) = random_panel(M, W, dtype, device,
                                               seed=M * W)
            # name, kernel, plain version, sum(|terms|) of g, panel
            cases = [
                ("panel_update_vsweep",
                 lambda X: pk.panel_update_vsweep(X, uo, up, vo, vp),
                 lambda X: pk.panel_update_vsweep_plain(X, uo, up, vo, vp),
                 lambda X: pk.panel_vsweep_plain(X.abs(), uo.abs())[0], R),
                ("panel_vsweep", lambda X: pk.panel_vsweep(X, up),
                 lambda X: pk.panel_vsweep_plain(X, up),
                 lambda X: pk.panel_vsweep_plain(X.abs(), up.abs())[0], R)]
            if dtype == torch.bfloat16:
                cases.append((
                    "panel_update_vsweep_irne",
                    lambda X: pk.panel_update_vsweep_irne(X, uo, up, vo, vp),
                    lambda X: pk.panel_update_vsweep_irne_plain(
                        X, uo, up, vo, vp),
                    lambda X: pk.panel_vsweep_plain(X.abs(), uo.abs())[0],
                    R))
            for mdt in (torch.bfloat16, torch.int8):
                Rm, Mk, (ua, us, va, vs) = random_masked(
                    M, W, dtype, mdt, device, seed=M * W + 1)
                cases += [
                    (f"fused_update_vsweep/{str(mdt)[6:]}",
                     lambda X, Mk=Mk, v=(ua, us, va, vs):
                         ck.fused_update_vsweep(X, Mk, *v),
                     lambda X, Mk=Mk, v=(ua, us, va, vs):
                         ck.fused_update_vsweep_plain(X, Mk, *v),
                     lambda X, Mk=Mk, u=ua: ck.masked_vsweep_plain(
                         X.abs(), Mk, u.abs())[0], Rm),
                    (f"masked_vsweep/{str(mdt)[6:]}",
                     lambda X, Mk=Mk, u=us: ck.masked_vsweep(X, Mk, u),
                     lambda X, Mk=Mk, u=us: ck.masked_vsweep_plain(X, Mk, u),
                     lambda X, Mk=Mk, u=us: ck.masked_vsweep_plain(
                         X.abs(), Mk, u.abs())[0], Rm)]
            for name, kern, plain, scale, X in cases:
                for offset in (None, VIEW_OFFSET):
                    what = (f"{name} {str(dtype)[6:]} {M}x{W}"
                            + (f" view +{offset}" if offset else ""))
                    err = _hold(what, kern, plain, scale, X, offset, ratios)
                    key = name.split("/")[0]
                    worst[key] = max(worst.get(key, 0.0), err)
    print(f"[check] alignment: {len(shapes)} shapes ({ALIGN_ROWS} x "
          f"{ALIGN_WIDTHS}, {ALIGN_EXTRA}) x f32, bf16: K1, K3, K4, "
          f"masked_vsweep (bf16, int8 masks), the rounding variant (bf16), "
          f"each also as a view {VIEW_OFFSET} element into a guarded buffer:"
          f" residual bit-equal, guard cells untouched, repeatable; largest "
          f"error / sum|terms| {max(ratios):.2e} (bar {RTOL}); max|dg|,|dh| "
          f"{ {k: float(f'{v:.3e}') for k, v in worst.items()} } "
          f"[{time.perf_counter() - t0:.1f} s]", flush=True)
    return worst


def _row_cases(dtype, mask_dtype, M, W, device, seed):
    """(name, kernel, plain version, sum(|terms|) of g, panel) of the row
    sweep on a seeded (M, W) panel of ``dtype``: K2 on a NaN-sentinel
    panel (``mask_dtype`` None), else masked_usweep beside a mask of
    ``mask_dtype``."""
    from cuda_recommender_tpu_torch.ops import ccd_kernels as ck
    from cuda_recommender_tpu_torch.ops import panel_kernels as pk

    ab = _fp8_abs if dtype == FP8 else torch.abs
    if dtype == FP8:
        R, Mk, vecs = _fp8_panel(M, W, device, seed, mask_dtype)
    elif mask_dtype is None:
        (R, vecs), Mk = random_panel(M, W, dtype, device, seed), None
    else:
        R, Mk, vecs = random_masked(M, W, dtype, mask_dtype, device, seed)
    v = vecs[2]
    if Mk is None:
        return (pk.instance_name("panel_usweep", dtype),
                lambda X: pk.panel_usweep(X, v),
                lambda X: pk.panel_usweep_plain(X, v),
                lambda X: pk.panel_usweep_plain(ab(X), v.abs())[0], R)
    return (pk.instance_name("masked_usweep", dtype),
            lambda X: ck.masked_usweep(X, Mk, v),
            lambda X: ck.masked_usweep_plain(X, Mk, v),
            lambda X: ck.masked_usweep_plain(ab(X), Mk, v.abs())[0], R)


def _hold_nonfinite_rows(dtype, mdt, views, device, worst, ratios) -> int:
    """The row sweep at ROW_SWEEP_NONFINITE, each panel's row 1 ending and
    row 3 starting with a non-finite cell, against its plain version
    (_hold with ``nonfinite``: rows 1 and 3 as the plain version has them,
    every other row finite and within RTOL), on the panel and as views at
    ``views``' offsets. Not for an fp8 residual with the NaN sentinel,
    whose cells are finite or NaN (skipped). Returns the cases held."""
    from cuda_recommender_tpu_torch.ops.densify import FP8_NAN_BITS

    n = 0
    for M, W in ROW_SWEEP_NONFINITE:
        name, kern, plain, scale, X = _row_cases(dtype, mdt, M, W, device,
                                                 seed=M * W + 9)
        if dtype == FP8:
            X.view(torch.uint8)[1, W - 1] = FP8_NAN_BITS
            X.view(torch.uint8)[3, 0] = FP8_NAN_BITS | 0x80
        else:
            bad = float("nan") if mdt is not None else float("inf")
            X[1, W - 1], X[3, 0] = bad, -bad
        for offset in views + [W]:
            what = (f"{name} {str(dtype)[6:]} {M}x{W} "
                    f"{'NaN' if mdt is None else str(mdt)[6:]} non-finite "
                    f"row ends" + (f" view +{offset}" if offset else ""))
            worst[name] = max(worst.get(name, 0.0), _hold(
                what, kern, plain, scale, X, offset, ratios, nonfinite=True,
                same_view=True))
            n += 1
    return n


def check_row_sweeps(device, dtypes, mask_dtypes, worst) -> dict:
    """The row sweep (K2 with the NaN sentinel, masked_usweep with a
    mask) of each residual dtype x mask dtype (None: the sentinel)
    against its plain version (_hold: g and h within RTOL of
    sum(|terms|), a second run on the same view bit-identical (its sums'
    order follows the rows' alignment), guard cells untouched) at
    ROW_SWEEP_SHAPES, each on the panel itself and as guarded views at
    every offset that moves its first cell within a 16-byte unit and one
    row in, and at ROW_SWEEP_WIDE; and, but for fp8 with the sentinel,
    with non-finite cells at rows' ends (``_hold_nonfinite_rows``).
    Prints each shape's plan (segments, chunks, grid). Updates ``worst``
    (name -> largest |g, h error|) and returns it."""
    from cuda_recommender_tpu_torch.ops import panel_kernels as pk

    t0 = time.perf_counter()
    ratios, n = [], 0
    for dtype in dtypes:
        size = torch.empty((), dtype=dtype).element_size()
        views = [None, *range(1, 16 // size)]
        for mdt in mask_dtypes:
            plans = []
            for M, W in (*ROW_SWEEP_SHAPES, ROW_SWEEP_WIDE):
                name, kern, plain, scale, X = _row_cases(
                    dtype, mdt, M, W, device, seed=M * W + 5)
                p = pk.residual_plan(X)
                plans.append(f"{M}x{W}: {p['segments']} seg, {p['chunks']} "
                             f"chunks, grid {p['grid']}")
                offsets = ([None] if (M, W) == ROW_SWEEP_WIDE
                           else views + [W])
                for offset in offsets:
                    what = (f"{name} {str(dtype)[6:]} {M}x{W} "
                            f"{'NaN' if mdt is None else str(mdt)[6:]}"
                            + (f" view +{offset}" if offset else ""))
                    worst[name] = max(worst.get(name, 0.0), _hold(
                        what, kern, plain, scale, X, offset, ratios,
                        same_view=True))
                    n += 1
                del X
            if dtype != FP8 or mdt is not None:
                n += _hold_nonfinite_rows(dtype, mdt, views, device, worst,
                                          ratios)
            torch.cuda.empty_cache()
            print(f"[check] row sweep {str(dtype)[6:]} "
                  f"{'NaN' if mdt is None else str(mdt)[6:] + ' mask'}: "
                  + "; ".join(plans), flush=True)
    print(f"[check] row sweep: {n} panels and views, within RTOL, "
          f"repeatable, guard cells untouched; largest error / sum|terms| "
          f"{max(ratios):.2e} (bar {RTOL}) "
          f"[{time.perf_counter() - t0:.1f} s]", flush=True)
    return worst


def _events(metrics_file, kind) -> list:
    with open(metrics_file) as f:
        return [e for e in map(json.loads, f) if e["kind"] == kind]


def _steady(stats) -> float:
    """Mean s/iter of iterations 2.. (the first pays the warm-up)."""
    it_s = [st.rank_time for st in stats]
    steady = it_s[1:] if len(it_s) > 1 else it_s
    return sum(steady) / len(steady)


def _check_misses(what, misses) -> None:
    """``misses``: W's and H's (largest |ref|, largest |diff|) over the
    entries that miss the strict golden bar; each must be a rounding miss at
    a near-zero entry (GOLDEN_MISS_REF, GOLDEN_MISS_DIFF)."""
    for name, (ref, diff) in zip("WH", misses):
        if ref >= GOLDEN_MISS_REF or diff >= GOLDEN_MISS_DIFF:
            raise AssertionError(
                f"{what} golden {name}: a strict miss at |ref| {ref:.3e}, "
                f"|diff| {diff:.3e} (a rounding miss stays below "
                f"{GOLDEN_MISS_REF:g} and {GOLDEN_MISS_DIFF:g})")


def _check_rmse(what, rmse, iters) -> None:
    if not all(math.isfinite(r) for r in rmse) or len(rmse) != iters:
        raise AssertionError(f"{what}: RMSE {rmse}")
    if not all(r < rmse[0] for r in rmse[1:]):
        raise AssertionError(f"{what}: RMSE does not fall below iteration "
                             f"1's: {rmse}")


def run_dense_headline(device, *, m, n, nnz, k, lam, iters,
                       metrics_file) -> dict:
    """train() at the JAX README's quick start (AUTO must pick dense),
    ``iters`` outer iterations with the golden dual run, then one outer
    iteration at -T 2 on the same data. The launch counts are set to 0 once,
    just before the first run, and read after each run."""
    from cuda_recommender_tpu_torch import Config, train
    from cuda_recommender_tpu_torch.core.config import Backend
    from cuda_recommender_tpu_torch.core.metrics_log import MetricsLog
    from cuda_recommender_tpu_torch.data.datasets import synthetic_cached
    from cuda_recommender_tpu_torch.ops import launches as lc

    t0 = time.perf_counter()
    R, T = synthetic_cached(m, n, nnz, seed=1)
    print(f"[dense] data {R.rows} x {R.cols}, train nnz {R.nnz}, test nnz "
          f"{T.nnz}: {time.perf_counter() - t0:.1f} s (host)", flush=True)
    cfg = Config(k=k, maxiter=iters, lambda_=lam, golden=True,
                 metrics_file=metrics_file)
    if cfg.resolve_backend(R.rows, R.cols) != Backend.DENSE:
        raise AssertionError("AUTO does not pick dense at the quick start")
    log = MetricsLog(metrics_file)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lc.reset_launch_counts()
    try:
        res = train(cfg, R, T, device=device, log=log)
        launches = lc.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        print("[dense] -T 2, one outer iteration:", flush=True)
        res2 = train(Config(k=k, maxiter=1, maxinneriter=2, lambda_=lam,
                            metrics_file=metrics_file), R, T, device=device,
                     log=log)
    finally:
        log.close()
    total = lc.launch_counts()
    launches2 = {name: total[name] - launches[name] for name in total}
    gold = _events(metrics_file, "golden")[0]
    rmse = [st.rmse for st in res.stats]
    rmse_ref = [st.rmse for st in res.ref_stats]
    s_iter = _steady(res.stats)
    rate = R.nnz * k / s_iter
    cells = R.rows * R.cols
    # per rank K4 reads and writes the f32 residual and reads the bf16 mask
    # (10 B/cell), masked_usweep reads both (6 B/cell)
    b_ms = k * 1e3 * cells * 16 / PEAK_BYTES_S
    print(f"[dense] backend {res.backend}; RMSE per iteration {rmse}; "
          f"reference {rmse_ref}; s/iter {[st.rank_time for st in res.stats]}"
          , flush=True)
    share = 100 * b_ms / 1e3 / s_iter
    print(f"[dense] s/iter (iterations 2-{iters}): {s_iter:.4f}; "
          f"rating-updates/s: {rate:.4e}; bound {b_ms:.2f} ms/iter (16 B/cell"
          f"/rank over {PEAK_BYTES_S / 1e12} TB/s), {share:.1f}% of it; peak "
          f"device memory {peak / 2**30:.2f} GiB; launches {launches}",
          flush=True)
    misses = [(gold[f"{x}_miss_ref"], gold[f"{x}_miss_diff"]) for x in "WH"]
    print(f"[dense] golden: W {res.golden_W.message()} H "
          f"{res.golden_H.message()}; with atol 1e-3: W "
          f"{gold['W_pass_atol']}, H {gold['H_pass_atol']}; strict misses "
          f"(max |ref|, max |diff|): W {misses[0]}, H {misses[1]}",
          flush=True)
    print(f"[dense] -T 2: RMSE {[st.rmse for st in res2.stats]}, s/iter "
          f"{[st.rank_time for st in res2.stats]}; launches {launches2}",
          flush=True)
    if res.backend != "dense" or res2.backend != "dense":
        raise AssertionError(f"backends {res.backend}, {res2.backend}")
    _check_rmse("dense headline", rmse, iters)
    _check_rmse("dense -T 2", [st.rmse for st in res2.stats], 1)
    if max(abs(a - b) for a, b in zip(rmse, rmse_ref)) > 1e-3:
        raise AssertionError(f"RMSE dense {rmse} vs reference {rmse_ref}")
    if not (gold["W_pass_atol"] and gold["H_pass_atol"]):
        raise AssertionError(f"golden with atol 1e-3 fails: {gold}")
    _check_misses("dense headline", misses)
    for got, inner, n_it in ((launches, 1, iters), (launches2, 2, 1)):
        want = want_launches(k, n_it, inner, 1, masked=True)
        if got != want:
            raise AssertionError(f"dense -T {inner}: launches {got}, want "
                                 f"{want}")
    ref = dict(W=res.ref_W, H=res.ref_H, rmse=rmse_ref, iters=iters)
    del res, res2
    torch.cuda.empty_cache()
    return dict(s_iter=s_iter, rate=rate, peak=peak, launches=total,
                rmse=rmse, bound_ms=b_ms, ref=ref)


def profile_dense_iteration(device, *, m, n, nnz, k, lam) -> dict:
    """One steady outer iteration of the dense step (after two untraced
    ones) under torch.profiler (scripts/profile_iteration.py): device time
    per kernel name, the span from the first kernel's start to the last
    one's end, the busy time (union of kernel intervals) and the idle share
    of the span."""
    from cuda_recommender_tpu_torch.scripts import profile_iteration as pi

    step, what = pi.dense_step(device, m, n, nnz, k, lam)
    out = pi.profile_split(step, device)
    del step
    pi.report(what, out)
    torch.cuda.empty_cache()
    return out


def run_pallas_vs_dense(device, *, m, n, nnz, k, lam, iters=2) -> None:
    """The pallas backend runs the dense backend's kernels in the same
    order, so after ``iters`` iterations W and H must be bit-equal."""
    from cuda_recommender_tpu_torch import Config, train
    from cuda_recommender_tpu_torch.core.metrics_log import MetricsLog
    from cuda_recommender_tpu_torch.data.datasets import synthetic_cached

    R, T = synthetic_cached(m, n, nnz, seed=1)
    out = {}
    for backend in ("dense", "pallas"):
        log = MetricsLog(None)
        res = train(Config(k=k, maxiter=iters, lambda_=lam, backend=backend),
                    R, T, device=device, log=log)
        out[backend] = res
        print(f"[pallas] {backend}: RMSE {[st.rmse for st in res.stats]}, "
              f"s/iter {[st.rank_time for st in res.stats]}", flush=True)
    for name in "WH":
        a, b = getattr(out["dense"], name), getattr(out["pallas"], name)
        if not np.array_equal(a, b):
            raise AssertionError(f"pallas vs dense {name}: max|diff| "
                                 f"{float(np.abs(a - b).max()):.3e}")
    print(f"[pallas] W and H bit-equal to the dense run's after {iters} "
          "iterations", flush=True)
    torch.cuda.empty_cache()


def run_dense_k40(device, *, m, n, nnz, lam, k, iters, metrics_file) -> dict:
    """The README's k=40 dense row: bf16 residual, AUTO -> dense."""
    from cuda_recommender_tpu_torch import Config, train
    from cuda_recommender_tpu_torch.core.metrics_log import MetricsLog
    from cuda_recommender_tpu_torch.data.datasets import synthetic_cached
    from cuda_recommender_tpu_torch.ops import launches as lc

    R, T = synthetic_cached(m, n, nnz, seed=1)
    log = MetricsLog(metrics_file)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lc.reset_launch_counts()
    try:
        res = train(Config(k=k, maxiter=iters, lambda_=lam,
                           residual_dtype="bfloat16"), R, T, device=device,
                    log=log)
    finally:
        log.close()
    launches = lc.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    rmse = [st.rmse for st in res.stats]
    s_iter = _steady(res.stats)
    rate = R.nnz * k / s_iter
    b_ms = k * 1e3 * R.rows * R.cols * 10 / PEAK_BYTES_S  # 6 + 4 B/cell/rank
    print(f"[k40] backend {res.backend}; RMSE per iteration {rmse}; s/iter "
          f"{[st.rank_time for st in res.stats]}", flush=True)
    print(f"[k40] s/iter (iterations 2-{iters}): {s_iter:.4f}; "
          f"rating-updates/s: {rate:.4e}; bound {b_ms:.2f} ms/iter (10 B/cell"
          f"/rank), {100 * b_ms / 1e3 / s_iter:.1f}% of it; peak device "
          f"memory {peak / 2**30:.2f} GiB; launches {launches}", flush=True)
    if res.backend != "dense":
        raise AssertionError(f"k=40 backend {res.backend}")
    _check_rmse("dense k=40 bf16", rmse, iters)
    if launches != want_launches(k, iters, 1, 1, masked=True):
        raise AssertionError(f"k=40 launches {launches}")
    del res
    torch.cuda.empty_cache()
    return dict(s_iter=s_iter, rate=rate, peak=peak, bound_ms=b_ms)


def time_masked_kernels(m, n, reps=5) -> dict:
    """K4 and the masked sweeps against their plain versions at (m, n),
    f32 and bf16 residuals with a bf16 mask
    (scripts/sweep_timing.py::masked_sweeps: the calls, their bytes and
    flops). Returns {dtype name: {kernel: (ms, plain_ms, bound_ms,
    bound_by)}}."""
    from cuda_recommender_tpu_torch.scripts import sweep_timing as st

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        calls = st.masked_sweeps(m, n, dtype, torch.bfloat16,
                                 torch.device("cuda"), seed=7)
        out[str(dtype)[6:]] = _sweep_times(
            calls, f"{m}x{n} {str(dtype)[6:]}, bfloat16 mask", reps)
        del calls
        torch.cuda.empty_cache()
    return out


def run_mask_hybrid(device, data, *, k, lam, iters, metrics_file) -> dict:
    """CCD++ at Netflix-100M dims with the JAX Config defaults, on phase
    4's ``data``: AUTO must pick hybrid, and its explicit bf16-mask panels
    run K4 and the masked sweeps (the launch counts are set to 0 just
    before the run and read just after)."""
    from cuda_recommender_tpu_torch import Config, train
    from cuda_recommender_tpu_torch.core.config import Backend
    from cuda_recommender_tpu_torch.core.metrics_log import MetricsLog
    from cuda_recommender_tpu_torch.ops import launches as lc

    R, T = data
    print(f"[mask-hybrid] data {R.rows} x {R.cols}, train nnz {R.nnz} "
          "(phase 4's)", flush=True)
    cfg = Config(k=k, maxiter=iters, lambda_=lam, metrics_file=metrics_file)
    if cfg.resolve_backend(R.rows, R.cols) != Backend.HYBRID:
        raise AssertionError("AUTO does not pick hybrid at Netflix dims")
    log = MetricsLog(metrics_file)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lc.reset_launch_counts()
    try:
        res = train(cfg, R, T, device=device, log=log)
    finally:
        log.close()
    launches = lc.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    plan = _events(metrics_file, "hybrid_plan")[0]
    P = len(plan["panels"])
    rmse = [st.rmse for st in res.stats]
    s_iter = _steady(res.stats)
    rate = R.nnz * k / s_iter
    print(f"[mask-hybrid] plan: {P} panels {plan['panels']}, "
          f"{plan['panel_cells']} cells, {plan['mask_dtype']} masks, tail nnz "
          f"{plan['nnz_light']} ({100.0 * plan['nnz_light'] / R.nnz:.2f}% of "
          f"nnz); plan {plan['plan_s']:.1f} s (host), device set-up "
          f"{plan['setup_s']:.1f} s", flush=True)
    print(f"[mask-hybrid] RMSE per iteration {rmse}; s/iter "
          f"{[st.rank_time for st in res.stats]}; steady {s_iter:.4f}; "
          f"rating-updates/s {rate:.4e}; peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {launches}", flush=True)
    if res.backend != "hybrid" or plan["mask_dtype"] != "bfloat16":
        raise AssertionError(f"backend {res.backend}, masks "
                             f"{plan['mask_dtype']}")
    _check_rmse("explicit-mask hybrid", rmse, iters)
    want = want_launches(k, iters, 1, P, masked=True)
    if launches != want:
        raise AssertionError(f"explicit-mask hybrid launches {launches}, "
                             f"want {want}")
    del res, R, T
    torch.cuda.empty_cache()
    return dict(s_iter=s_iter, rate=rate, peak=peak,
                panels=[tuple(p) for p in plan["panels"]])


def run_dense_cli() -> None:
    """The JAX README's CLI command with --golden and no backend flag: AUTO
    must pick dense; every iteration's RMSE within RMSE_TOL of the
    reference's; the golden check (_check_golden); K4 launched."""
    cmd = [sys.executable, "-m", "cuda_recommender_tpu_torch.cli.train",
           "--dataset", "synthetic:m=6040,n=3706,nnz=900000", "-k", "10",
           "-t", "5", "-l", "0.05", "--golden", "--device", "cuda"]
    print("[cli] " + " ".join(cmd[1:]), flush=True)
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=600)
    print(res.stdout + res.stderr, flush=True)
    if res.returncode != 0:
        raise AssertionError(f"dense CLI exited {res.returncode}")
    if not re.search(r"^\[info\] Backend = dense \|", res.stdout, re.M):
        raise AssertionError("the CLI did not run the dense backend")
    checks = _check_golden("README CLI", res.stdout)
    rmse = [float(x) for x in re.findall(r"RMSE=([0-9.]+)", res.stdout)]
    ours, ref = rmse[:5], rmse[5:10]
    if len(rmse) != 10 or max(abs(a - b) for a, b in zip(ours, ref)) > \
            RMSE_TOL:
        raise AssertionError(f"RMSE dense {ours} vs reference {ref}")
    m = re.search(r"^\[info\] kernel launches: (\{.*\})$", res.stdout, re.M)
    launches = json.loads(m.group(1))
    if launches["fused_update_vsweep"] != 50:
        raise AssertionError(f"dense CLI launches {launches}")
    print(f"[cli] golden W, H {checks}; RMSE dense {ours} = reference "
          f"{ref} within {RMSE_TOL}; launches {launches} "
          f"[{time.perf_counter() - t0:.1f} s]", flush=True)


def check_probe_kernels(device) -> dict:
    """stream_rmw and stream_read (weighted and NaN-skip),
    panel_update_vsweep_irne and the gather forms against their plain
    versions on the same inputs, at PROBE_SMALL and the scripts' shapes,
    the streams also on a view one row in (rows off a 16-byte boundary
    where 2 W is not a multiple of 16) and, at PROBE_SMALL, on views whose
    first cell lies at every even offset 0-14 past a 16-byte boundary: rmw,
    the rounding variant's stored residual and the gathers bit-equal (the
    variant's also to K1's), sums within RTOL of sum(|terms|) and bit-equal
    from one call to the next, the reads at PROBE_SMALL also bit-equal to
    ``stream_read_in_order`` (the kernel's order of additions) under the
    card's plan; each line counts the reads that ran each row path. The
    read's C entry point refuses the aligned path on a view off a 16-byte
    boundary; the gathers through ``check_gathers``. Returns each kernel's
    largest |kernel - plain|."""
    from cuda_recommender_tpu_torch.ops import panel_kernels as pk
    from cuda_recommender_tpu_torch.ops import probe_kernels as pr
    from cuda_recommender_tpu_torch.scripts.panel_kernel_variants import \
        pattern_panel

    def views(R, small):
        """(what, view) pairs of R's cells: R, one row in, and (small)
        M - 1 rows of the flat cells from every even byte offset 0-14 on
        (up to W cells in)."""
        M, W = R.shape
        out = [("", R)] + ([("one row in", R[1:])] if M > 1 else [])
        if small and M > 1:
            flat = R.reshape(-1)
            out += [(f"{2 * k} bytes in", flat[k:k + (M - 1) * W].view(
                M - 1, W)) for k in range(min(8, W + 1))]
        return out

    worst = {name: 0.0 for name in PROBES}
    for M, W in PROBE_SMALL + PROBE_SCRIPT_SHAPES:
        t0 = time.perf_counter()
        ratios = []
        paths = {"aligned": 0, "shifted": 0}
        R, (u, up, v, vp) = random_panel(M, W, torch.bfloat16, device,
                                         seed=M + 1)
        R = torch.nan_to_num(R, nan=0.5)      # the P1 panels are NaN-free
        small = (M, W) in PROBE_SMALL
        Rk, Rp = R.clone(), R.clone()
        for (what, Xk), (_, Xp) in zip(views(Rk, small), views(Rp, small)):
            pr.stream_rmw(Xk)
            pr.stream_rmw_plain(Xp)
            _sync(device)
            if not torch.equal(_bits(Rk), _bits(Rp)):
                raise AssertionError(
                    f"stream_rmw {M}x{W} {what}: "
                    f"{int((_bits(Rk) != _bits(Rp)).sum())} cells differ")
        del Rk, Rp
        Rn, _ = random_panel(M, W, torch.bfloat16, device, seed=M + 2)
        if (M, W) == PROBE_SCRIPT_SHAPES[2]:
            del Rn
            Rn = pattern_panel(M, W, device)
        for X, uu, what in [(X, u[-X.shape[0]:].contiguous(), what)
                            for what, X in views(R, small)] + \
                [(X, None, f"NaN-skip {what}")
                 for what, X in views(Rn, small)]:
            plan = pr.stream_read_plan(X, uu is None)
            paths[plan["path"]] += 1
            g = pr.stream_read(X, uu)
            gp = pr.stream_read_plain(X, uu)
            sg = pr.stream_read_plain(X.abs(), None if uu is None
                                      else uu.abs())
            worst["stream_read"] = max(worst["stream_read"], _close(
                f"stream_read {what} g", g, gp, sg, ratios))
            if not torch.equal(g, pr.stream_read(X, uu)):
                raise AssertionError(f"stream_read {M}x{W} {what}: not "
                                     "repeatable")
            if small and not torch.equal(
                    _bits(g), _bits(pr.stream_read_in_order(X, uu, plan))):
                raise AssertionError(
                    f"stream_read {M}x{W} {what} ({plan['path']} path, "
                    f"{plan['ranges']} ranges): not the bits of its order "
                    "of additions")
        del R
        # the rounding variant on NaN-sentinel panels: random (30%
        # observed) and, at the variant matrix's shape, its own pattern
        Ra, Rp, R1 = Rn.clone(), Rn.clone(), Rn
        ga, ha = pk.panel_update_vsweep_irne(Ra, u, up, v, vp)
        gp, hp = pk.panel_update_vsweep_irne_plain(Rp, u, up, v, vp)
        pk.panel_update_vsweep(R1, u, up, v, vp)
        _sync(device)
        for other, what in ((Rp, "its plain version"), (R1, "K1")):
            if not torch.equal(_bits(Ra), _bits(other)):
                raise AssertionError(
                    f"panel_update_vsweep_irne {M}x{W}: stored residual "
                    f"differs from {what}'s in "
                    f"{int((_bits(Ra) != _bits(other)).sum())} cells")
        del Rp, R1
        sg, _ = pk.panel_vsweep_plain(Ra.abs(), u.abs())
        worst["panel_update_vsweep_irne"] = max(
            worst["panel_update_vsweep_irne"],
            _close("irne g", ga, gp, sg, ratios),
            _close("irne h", ha, hp, hp, ratios))
        del Ra, Rn
        _sync(device)
        torch.cuda.empty_cache()
        print(f"[check] probes {M:6d}x{W:<6d} bf16: stream_rmw "
              f"({'every even offset' if small else 'one row in'}) and the "
              f"rounding variant's residual bit-equal (also to K1's); "
              f"stream_read on the aligned path {paths['aligned']} times, "
              f"the shifted {paths['shifted']}"
              f"{', each bit-equal to its order of additions' if small else ''}"
              f"; sums' largest error / sum|terms| {max(ratios):.2e} (bar "
              f"{RTOL}), repeatable [{time.perf_counter() - t0:.1f} s]",
              flush=True)
    check_read_refusal(device)
    worst.update(check_gathers(device))
    return worst


def check_read_refusal(device) -> None:
    """stream_read's C entry point refuses the aligned row path on a panel
    view that starts 2 bytes past a 16-byte boundary (cudaErrorInvalidValue,
    before any launch), and the wrapper raises."""
    from cuda_recommender_tpu_torch.ops import probe_kernels as pr

    X = torch.zeros(64 * 64 + 1, dtype=torch.bfloat16,
                    device=device)[1:].view(64, 64)
    plan = dict(pr.stream_read_plan(X, True), path="aligned")
    try:
        pr.launch_read(X, None, plan)
    except RuntimeError as err:
        if not str(err).endswith("CUDA error 1"):
            raise
    else:
        raise AssertionError("the aligned path ran on a view 2 bytes off a "
                             "16-byte boundary")
    _sync(device)
    print("[check] stream_read refuses the aligned path 2 bytes off a "
          "16-byte boundary (cudaErrorInvalidValue)", flush=True)


def check_gathers(device) -> dict:
    """P3's forms A, B and C bit-equal to their plain version at each of
    GATHER_CHECKS (out-of-range indices in the first row), and A and B also
    on index and output views off a 16-byte boundary (GATHER_VIEWS, NaN
    guard cells around the output) and on each path the table allows; each
    line names the path that ran, by the launch counts, which must be the
    one ``gather_plan`` picks. At the limit the shared-memory path runs, one
    row over it the C entry point refuses that path (cudaErrorInvalidValue)
    and the wrapper raises. Returns {"gather": 0.0, "gather_smem": 0.0}
    (the largest |kernel - plain|: bit-equal, or AssertionError)."""
    from cuda_recommender_tpu_torch.ops import build
    from cuda_recommender_tpu_torch.ops import probe_kernels as pr
    from cuda_recommender_tpu_torch.ops.launches import launch_counts
    from cuda_recommender_tpu_torch.scripts.probe_gather import L, \
        probe_inputs

    smem_limit = pr.gather_limits(device)[0]
    s_lim = (smem_limit - pr.GATHER_SMEM_RESERVE) // (4 * L)
    sizes = {"limit": s_lim, "over": s_lim + 1}

    def run(tab, idx, form, path=None, views=(0, 0)):
        n = idx.numel()
        ib = torch.empty(n + views[0], dtype=torch.int32, device=device)
        iv = ib[views[0]:].view(idx.shape)
        iv.copy_(idx)
        ob = torch.full((n + views[1] + 1,), float("nan"), device=device)
        ov = ob[views[1]:views[1] + n].view(idx.shape)
        before = launch_counts()
        pr.gather(tab, iv, form, out=ov, path=path)
        _sync(device)
        ran = [k for k in ("gather", "gather_smem")
               if launch_counts()[k] != before[k]]
        want = pr.gather_plain(tab, idx, form)
        guards = torch.cat([ob[:views[1]], ob[views[1] + n:]])
        if not (torch.equal(_bits(ov), _bits(want))
                and bool(torch.isnan(guards).all())):
            raise AssertionError(
                f"gather {form} table {tab.shape[0]} x {L}, index "
                f"{idx.shape[0]} x {L}, path {path}, views {views}: "
                f"{int((_bits(ov) != _bits(want)).sum())} entries differ "
                "from the plain version, or a guard cell was written")
        return ran[0] if len(ran) == 1 else ran

    for S, rows in GATHER_CHECKS:
        S = sizes.get(S, S)
        tab, idx = probe_inputs(S, rows, device, seed=S)
        idx["A"][0, :4] = torch.tensor([-1, S, S + 7, 0], dtype=torch.int32)
        idx["B"][0, :3] = torch.tensor([-1, S * L, S * L - 1],
                                       dtype=torch.int32)
        fits = pr.gather_smem_bytes(S, L) <= smem_limit
        ran = {}
        for form in ("A", "B", "C"):
            ran[form] = run(tab, idx[form], form)
            want = "gather_smem" if fits and form != "C" else "gather"
            if ran[form] != want:
                raise AssertionError(f"gather {form} at table {S}: ran "
                                     f"{ran[form]}, the plan says {want}")
            if form == "C":
                continue
            for views in GATHER_VIEWS:
                run(tab, idx[form], form, views=views)
            if fits:
                run(tab, idx[form], form, path="l2")
        print(f"[check] gather A, B, C at table {S} x {L}, index {rows} x "
              f"{L}: bit-equal (out-of-range indices read 0; A and B also "
              f"on views {list(GATHER_VIEWS)}"
              + (" and on the L2 path" if fits else "")
              + f"); ran A {ran['A']}, B {ran['B']}, C {ran['C']}",
              flush=True)
        if rows == 37 and not fits:
            out = torch.empty(idx["A"].shape, device=device)
            rc = build.load("probe_kernels").crtpu_gather(
                tab.data_ptr(), idx["A"].data_ptr(), out.data_ptr(), rows, L,
                S, 0, 1, torch.cuda.current_stream().cuda_stream)
            if rc != 1:  # cudaErrorInvalidValue
                raise AssertionError(f"crtpu_gather's shared-memory path at "
                                     f"table {S}: rc {rc}, want 1")
            try:
                pr.gather(tab, idx["A"], "A", path="smem")
            except ValueError as err:
                print(f"[check] gather at table {S} x {L}: the shared-memory "
                      f"path refused (C rc {rc}; wrapper: {err})", flush=True)
            else:
                raise AssertionError("the wrapper took the shared-memory "
                                     f"path at table {S}")
        del tab, idx
    return {"gather": 0.0, "gather_smem": 0.0}


def run_bench(extra=(), timeout=900, data=None) -> dict:
    """``python -m cuda_recommender_tpu_torch.bench`` with ``extra``
    arguments, or with ``data`` (the headline's (R, T), already loaded)
    its ``run()`` in this process; returns its one JSON record after
    checking it: the device is the card, 0 < vs_baseline <= 1.05, every
    control at most CONTROL_MAX_SHARE of the peak rate, the training
    launches exactly want_launches, the test RMSE finite."""
    from cuda_recommender_tpu_torch import bench as port_bench

    args = [str(x) for x in extra]
    cmd = [sys.executable, "-m", "cuda_recommender_tpu_torch.bench", *args]
    print("[bench] " + " ".join(cmd[1:])
          + (" (in this process, the data shared)" if data else ""),
          flush=True)
    t0 = time.perf_counter()
    if data is not None:
        rec = port_bench.run(port_bench.build_parser().parse_args(args),
                             data=data)
        lines = [json.dumps(rec)]
    else:
        res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                             timeout=timeout)
        if res.returncode != 0:
            print(res.stdout + res.stderr, flush=True)
            raise AssertionError(f"bench exited {res.returncode}")
        lines = res.stdout.strip().splitlines()
        rec = json.loads(lines[-1])
    d = rec["detail"]
    if len(lines) != 1 or rec["metric"] != "ccd_netflix_scale_throughput":
        raise AssertionError(f"bench printed {len(lines)} lines: {lines[:3]}")
    if d["device"]["platform"] != "gpu":
        raise AssertionError(f"bench device {d['device']}")
    if not (0 < rec["vs_baseline"] <= 1.05):
        raise AssertionError(f"bench vs_baseline {rec['vs_baseline']}")
    from cuda_recommender_tpu_torch.scripts.panel_floor import CONTROLS
    shares = [r[m]["share_of_peak"] for r in d["controls"]["panels"]
              for m in CONTROLS]
    for g in d["controls"]["gathers"].values():
        for form in ("A", "B"):     # index read + output written, 8 B each
            shares.append(8e-3 / g[form]["ns_per_element"] * 1e12
                          / PEAK_BYTES_S)
    if not shares or max(shares) > CONTROL_MAX_SHARE:
        raise AssertionError(f"a control above {CONTROL_MAX_SHARE} of the "
                             f"peak rate: {shares}")
    want = want_launches(d["k"], d["iterations_run"], 1, len(d["panels"]))
    if d["launches"] != want:
        raise AssertionError(f"bench launches {d['launches']}, want {want}")
    if not math.isfinite(d["test_rmse"]):
        raise AssertionError(f"bench RMSE {d['test_rmse']}")
    print(f"[bench] {rec['value']:.1f} {rec['unit']}, median "
          f"{d['outer_iter_s']:.4f} s/iter (samples {d['iter_s_samples']}, "
          f"spread {d['iter_s_spread_pct']:.2f}%), vs_baseline "
          f"{rec['vs_baseline']:.4f}, achievable "
          f"{d['vs_baseline_achievable']:.4f}; {d['orientation']}, panels "
          f"{d['panels']}, tail {100 * d['nnz_light_frac']:.2f}% of nnz; "
          f"RMSE {d['test_rmse']:.6f} after {d['iterations_run']} "
          f"iterations; peak {d['peak_device_memory_bytes'] / 2**30:.2f} "
          f"GiB; host {d['host_s']}; control shares max {max(shares):.3f} "
          f"[{time.perf_counter() - t0:.1f} s]", flush=True)
    for r in d["controls"]["panels"]:
        print("[bench] control " + json.dumps(r), flush=True)
    for name, g in d["controls"]["gathers"].items():
        print(f"[bench] gather {name} side " + json.dumps(g), flush=True)
    print(f"[bench] control launches {d['controls']['launches']}",
          flush=True)
    return rec


def time_probe_kernels(panel, variant_shape, tails, reps=5) -> dict:
    """Each probe kernel against its plain version and, where one exists,
    its PyTorch call, warm, in turns: the streams (``sweep_timing.
    time_streams``: the rmw, ``R.add_(1)``, the u-weighted read,
    ``torch.mv(R.t(), u)`` with u rounded to bf16, and the NaN-skip read,
    ``torch.nansum``) at the
    bench's panel 0 and the variant matrix's shape, the rounding variant
    at the latter, gather forms A and B (and C) at each of the bench's tail
    sides ``tails`` (by graph replays; ``torch.gather``, ``torch.take``,
    ``index_select``). Returns name -> dict(ms, plain_ms, library_ms,
    bound_ms, bound_by) at panel 0 (every stream record, both shapes,
    under "streams"); "gather" and "gather_smem" are form B
    on the side whose path each counts."""
    from cuda_recommender_tpu_torch.ops import panel_kernels as pk
    from cuda_recommender_tpu_torch.ops import probe_kernels as pr
    from cuda_recommender_tpu_torch.scripts import sweep_timing as st
    from cuda_recommender_tpu_torch.scripts.common import time_ms
    from cuda_recommender_tpu_torch.scripts.panel_kernel_variants import \
        pattern_panel
    from cuda_recommender_tpu_torch.scripts.probe_gather import tail_shape
    from cuda_recommender_tpu_torch.scripts.sweep_timing import time_turns

    out = {}
    dev = torch.device("cuda")

    def record(name, fns, nbytes, flops, what):
        got = time_turns(fns, dev, reps)
        ms = [(a + b) / 2 for a, b in got]
        b_ms, b_by = bound(nbytes, flops)
        out[name] = dict(ms=ms[-1], plain_ms=ms[0],
                         library_ms=ms[1] if len(ms) == 3 else None,
                         bound_ms=b_ms, bound_by=b_by)
        print(f"[timing] {name:24s} {what}: kernel {ms[-1]:.3f} ms, plain "
              f"{ms[0]:.3f} ms, library "
              f"{'none' if len(ms) < 3 else f'{ms[1]:.3f} ms'}; bound "
              f"{b_ms:.3f} ms ({b_by}), {100 * b_ms / ms[-1]:.1f}% of it; "
              f"kernel {nbytes / 1e6 / ms[-1]:.0f} GB/s", flush=True)

    # the streams
    streams = st.time_streams(dev, reps, shapes=(panel, variant_shape))
    for i, (M, W) in enumerate((panel, variant_shape)):
        for name in ("stream_rmw", "stream_read", "stream_read_nan_skip"):
            rec = streams[f"{name} {M}x{W}"]
            b_ms, b_by = bound(rec["bytes"], rec["flops"])
            row = dict(ms=rec["ms"], plain_ms=rec["plain_ms"],
                       library_ms=rec["library_ms"], bound_ms=b_ms,
                       bound_by=b_by)
            print(f"[timing] {name:28s} {M}x{W}: kernel {rec['ms']:.3f} "
                  f"ms, plain {rec['plain_ms']:.3f}, library "
                  f"{rec['library_ms']:.3f}; bound {b_ms:.3f} ms ({b_by}), "
                  f"{100 * b_ms / rec['ms']:.1f}% of it", flush=True)
            out.setdefault("streams", {})[f"{name} {M}x{W}"] = row
            if i == 0 and "nan_skip" not in name:
                out[name] = row
    torch.cuda.empty_cache()

    M, W = variant_shape
    cells = M * W
    R = pattern_panel(M, W, "cuda")
    vecs = [0.1 * torch.randn(n, device="cuda") for n in (M, M, W, W)]
    record("panel_update_vsweep_irne", [
        lambda: pk.panel_update_vsweep_irne_plain(R, *vecs),
        lambda: pk.panel_update_vsweep_irne(R, *vecs)],
        4 * cells + 4 * (2 * M + 4 * W), 7 * cells,
        f"{M}x{W} bf16, the variant matrix's NaN pattern")
    k1 = time_ms(lambda: pk.panel_update_vsweep(R, *vecs), dev, reps, 0)
    print(f"[timing] K1 at the same shape: {k1:.3f} ms", flush=True)
    out["panel_update_vsweep_irne"]["k1_ms"] = k1
    del R, vecs
    torch.cuda.empty_cache()

    # P3's gathers A and B at the bench's two tail sides, the rows side on
    # the shared-memory path and the cols side on the L2 path: graph
    # replays with the index cold, in turns with their plain versions and
    # library calls (sweep_timing.gathers, probe_gather's method)
    smem_limit = pr.gather_limits(dev)[0]
    for name, side in tails.items():
        if not side["lanes"]:
            continue
        S, rows = tail_shape(side["lanes"], side["table_rows"], side["width"])
        what = f"{name} side {S}x128, {rows} rows"
        recs = st.time_sweeps(st.gathers(S, rows, dev, seed=5), what, dev,
                              st.GATHER_REPS, graph=True)
        path = pr.gather_plan(S, 128, rows * 128, smem_limit)["path"]
        for form in ("A", "B"):
            rec = recs[f"gather {form} {what}"]
            b_ms, b_by = bound(rec["bytes"], 0)
            print(f"[timing] gather {form} {name} side ({path} path, table "
                  f"{S}x128, index {rows}x128): kernel {rec['ms']:.5f} ms, "
                  f"plain {rec['plain_ms']:.5f} ms, library "
                  f"{rec['library_ms']:.5f} ms; bound {b_ms:.5f} ms "
                  f"({b_by}), {100 * b_ms / rec['ms']:.1f}% of it",
                  flush=True)
        rec = recs[f"gather B {what}"]
        out["gather_smem" if path == "smem" else "gather"] = dict(
            ms=rec["ms"], plain_ms=rec["plain_ms"],
            library_ms=rec["library_ms"], bound_ms=bound(rec["bytes"], 0)[0],
            bound_by="bytes")
    torch.cuda.empty_cache()
    return out


def run_script(args, timeout=600) -> str:
    """``python -m`` one of the port's modules; its stdout (raises on a
    non-zero exit)."""
    cmd = [sys.executable, "-m", *args]
    print("[script] " + " ".join(cmd[1:]), flush=True)
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=timeout)
    print(res.stdout + res.stderr, flush=True)
    if res.returncode != 0:
        raise AssertionError(f"{args[0]} exited {res.returncode}")
    print(f"[script] {args[0]} [{time.perf_counter() - t0:.1f} s]",
          flush=True)
    return res.stdout


#: the serving phases (cli/bench_serve.py's defaults): top-10 of batches of
#: 1024 queries, 8,192 queries a timed run, item chunks of 2048
SERVE = dict(topk=10, batch=1024, queries=8192, chunk=2048)
#: sequential single queries through RetrievalEngine
ENGINE_QUERIES = 1000
#: scripts/serve_from_trained.py's large catalog: the trained item table
#: tiled 57 times with 0.05-sigma Gaussian jitter, cut at 1M items
CATALOG_1M = dict(items=1_000_000, reps=57, sigma=0.05)
SERVE_SEED = 0
#: a batch's top-k scores against the brute force's: relative to the
#: batch's largest |score| (chunked and whole products, gemv and gemm need
#: not round alike)
SERVE_RTOL = 1e-5
#: the CLI chain's ratings file: ml1m dims from the synthetic generator
ML1M = dict(m=6040, n=3706, nnz=900_000, seed=5)


def serve_tables(H_em, device) -> dict:
    """name -> (run one batch: U -> (scores, ids), brute force: U -> all
    scores) for the f32 and the int8 item table on the card."""
    from cuda_recommender_tpu_torch.serve.retrieval import (
        quantize_item_table, topk_mips_device, topk_mips_device_int8)

    Hd = torch.from_numpy(H_em).to(device)
    Hq, scale = quantize_item_table(H_em)
    Hqd, scd = torch.from_numpy(Hq).to(device), torch.from_numpy(scale).to(
        device)
    kw = dict(topk=SERVE["topk"], chunk=SERVE["chunk"])
    return {
        "f32": (lambda U: topk_mips_device(U, Hd, **kw),
                lambda U: U @ Hd.T),
        "int8": (lambda U: topk_mips_device_int8(U, Hqd, scd, **kw),
                 lambda U: (U @ Hqd.to(torch.float32).T) * scd)}


def serve_qps(run_batch, Wd, users_d) -> float:
    """Queries per second of the batch path as bench_serve times it: one
    untimed batch, then every batch of ``users_d`` between two
    synchronize()s, the last batch read back."""
    B = SERVE["batch"]
    s, _ = run_batch(Wd[users_d[:B]])
    s.cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, users_d.shape[0], B):
        s, _ = run_batch(Wd[users_d[lo:lo + B]])
    s.cpu()
    torch.cuda.synchronize()
    return users_d.shape[0] / (time.perf_counter() - t0)


def check_topk(what, s, i, full, want_s) -> tuple:
    """Hold one batch's top-k (scores ``s``, ids ``i`` on the card) against
    the brute force: ``full`` every item's score, ``want_s`` the scores of
    torch.topk over it. Scores agree within SERVE_RTOL; the brute-force
    score of each returned id equals its slot's (so ids agree wherever
    scores differ, and within a tie any tied item may stand); ids are
    int32, real and distinct in each row. Returns (max |score diff|, share
    of slots whose id equals the brute force's)."""
    tol = SERVE_RTOL * max(1.0, want_s.abs().max().item())
    d_s = (s - want_s).abs().max().item()
    d_own = (full.gather(1, i.long()) - want_s).abs().max().item()
    srt = i.sort(dim=1).values
    ok = (i.dtype == torch.int32 and bool((i >= 0).all())
          and bool((srt[:, 1:] != srt[:, :-1]).all()))
    same = (i.long() == torch.topk(full, s.shape[1], dim=1).indices)
    if not ok or d_s > tol or d_own > tol:
        raise AssertionError(f"{what}: top-k off the brute force (score "
                             f"diff {d_s:.3e}, own-score diff {d_own:.3e}, "
                             f"tol {tol:.3e}, ids ok {ok})")
    return d_s, same.float().mean().item()


#: torch.profiler kernel names -> the part of a batch they belong to
_MATMUL = ("gemm", "cutlass", "xmma", "gemv", "dot_kernel")
_MERGE = ("topk", "sort", "radix", "bitonic", "cat", "gather", "scan",
          "compute", "fill")


def batch_split(run_batch, U, device) -> dict:
    """One batch under torch.profiler (scripts/profile_iteration.py's
    profile_split): device ms of the products, of the top-k merge (top-k,
    sort, concatenation, gather) and of the rest (casts, scales, index
    ranges), the kernels' busy ms, and the host's share: wall ms less busy
    ms."""
    from cuda_recommender_tpu_torch.scripts.profile_iteration import (
        profile_split)

    out = profile_split(lambda: run_batch(U), device, warm=1)
    split = {"matmul_ms": 0.0, "merge_ms": 0.0, "other_ms": 0.0}
    for name, ms, _ in out["kernels"]:
        low = name.lower()
        key = ("matmul_ms" if any(x in low for x in _MATMUL) else
               "merge_ms" if any(x in low for x in _MERGE) else "other_ms")
        split[key] += ms
    split.update(wall_ms=out["wall_ms"], busy_ms=out["busy_ms"],
                 span_ms=out["span_ms"], idle_pct=out["idle_pct"],
                 host_ms=out["wall_ms"] - out["busy_ms"],
                 kernels=out["kernels"][:8])
    return split


def serve_catalog(what, We, H_em, device) -> dict:
    """f32 and int8 batch retrieval over ``H_em`` for SERVE's queries:
    QPS, one batch held against the brute force on the card, one batch's
    time split (batch_split)."""
    rng = np.random.default_rng(SERVE_SEED)
    users = rng.integers(0, We.shape[0], SERVE["queries"])
    Wd = torch.from_numpy(We).to(device)
    users_d = torch.from_numpy(users).to(device)
    U0 = Wd[users_d[:SERVE["batch"]]]
    out = {}
    for name, (run_batch, brute) in serve_tables(H_em, device).items():
        qps = serve_qps(run_batch, Wd, users_d)
        s, i = run_batch(U0)
        full = brute(U0)
        want_s = torch.topk(full, SERVE["topk"], dim=1).values
        d_s, same = check_topk(f"{what} {name}", s, i, full, want_s)
        del full
        split = batch_split(run_batch, U0, device)
        batch_ms = 1e3 * SERVE["batch"] / qps
        out[name] = dict(qps=qps, batch_ms=batch_ms, max_score_diff=d_s,
                         same_id_share=same, split=split)
        print(f"[serve] {what} {name}: {qps:.1f} queries/s, {batch_ms:.3f} "
              f"ms a batch (batch {SERVE['batch']}, {SERVE['queries']} "
              f"queries, top-{SERVE['topk']}, chunk {SERVE['chunk']}); one "
              f"batch against the brute force: scores within {d_s:.3e}, "
              f"{100 * same:.2f}% of ids in the same slot; one batch under "
              f"the profiler: wall {split['wall_ms']:.3f} ms, device matmul "
              f"{split['matmul_ms']:.3f}, merge {split['merge_ms']:.3f}, "
              f"other {split['other_ms']:.3f} (busy {split['busy_ms']:.3f}), "
              f"host (wall less busy) {split['host_ms']:.3f}, idle "
              f"{split['idle_pct']:.2f}% of the span", flush=True)
        print(f"[serve]   kernels {json.dumps(split['kernels'])}",
              flush=True)
        torch.cuda.empty_cache()
    return out


def run_serving(device, W, H, recall) -> dict:
    """Serving of phase 4's trained factors (rank-major, k=40 over the
    17,770-item catalog): the model file's round trip, batch retrieval
    (serve_catalog), recall@10 f32 and int8 on the recall sample, and the
    engine's sequential queries, held against the batch path. The launch
    counts are set to 0 before and read after: serving launches no hand
    kernel (its products and top-k are torch.matmul and torch.topk)."""
    from cuda_recommender_tpu_torch.data.binfmt import load_model, save_model
    from cuda_recommender_tpu_torch.eval.ranking import recall_at_k
    from cuda_recommender_tpu_torch.ops import launches as lc
    from cuda_recommender_tpu_torch.serve.engine import RetrievalEngine
    from cuda_recommender_tpu_torch.serve.retrieval import topk_mips

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lc.reset_launch_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model")
        save_model(path, W, H, entity_major=False)
        size = os.path.getsize(path)
        Wr, Hr = load_model(path, entity_major=False)
        We, He = load_model(path, entity_major=True)
    if not (np.array_equal(Wr, W) and np.array_equal(Hr, H)
            and np.array_equal(We, W.T) and np.array_equal(He, H.T)):
        raise AssertionError("the model file does not read back bit-equal")
    print(f"[serve] save_model/load_model: {size} bytes, W {We.shape}, H "
          f"{He.shape}, bit-equal in both layouts "
          f"[{time.perf_counter() - t0:.1f} s]", flush=True)

    out = serve_catalog(f"{He.shape[0]} items", We, He, device)
    sample, relevant, exclude = recall
    for name in ("f32", "int8"):
        _, items = topk_mips(We, He, sample, topk=SERVE["topk"],
                             chunk=SERVE["chunk"], exclude=exclude,
                             int8=name == "int8", device=device)
        out[name]["recall"] = recall_at_k(items, relevant)
        print(f"[serve] recall@{SERVE['topk']} {name}: "
              f"{out[name]['recall']:.4f} ({len(sample)} users, held-out "
              f"ratings >= 4.0, train items excluded)", flush=True)

    rng = np.random.default_rng(SERVE_SEED + 1)
    users = rng.integers(0, We.shape[0], ENGINE_QUERIES)
    Ud = torch.from_numpy(We[users]).to(device)
    for name, (run_batch, brute) in serve_tables(He, device).items():
        eng = RetrievalEngine(We, He, int8=name == "int8", device=device)
        eng.warmup(topk=SERVE["topk"])
        lat, got_s, got_i = [], [], []
        for uid in users:
            t = time.perf_counter()
            s, i = eng.query(user=int(uid), topk=SERVE["topk"])
            lat.append(time.perf_counter() - t)
            got_s.append(s)
            got_i.append(i)
        p50, p99 = np.percentile(lat, [50, 99]) * 1e3
        bs, _ = run_batch(Ud)
        d_s, same = check_topk(
            f"engine {name}", torch.from_numpy(np.stack(got_s)).to(device),
            torch.from_numpy(np.stack(got_i)).to(device), brute(Ud), bs)
        out[name].update(p50_ms=p50, p99_ms=p99)
        print(f"[serve] engine {name}: {ENGINE_QUERIES} sequential queries, "
              f"p50 {p50:.4f} ms, p99 {p99:.4f} ms, mean "
              f"{1e3 * np.mean(lat):.4f} ms; against the batch path: scores "
              f"within {d_s:.3e}, {100 * same:.2f}% of ids in the brute "
              "force's slot", flush=True)
        del eng
    out["peak"] = torch.cuda.max_memory_allocated()
    launches = lc.launch_counts()
    if any(launches.values()):
        raise AssertionError(f"serving launched hand kernels: {launches}")
    print(f"[serve] peak device memory {out['peak'] / 2**30:.3f} GiB; hand "
          "kernel launches 0 (torch.matmul and torch.topk only)",
          flush=True)
    out["factors"] = (We, He)
    return out


def run_catalog_1m(device, We, He) -> dict:
    """The trained item table tiled to 1M items with jitter (CATALOG_1M,
    from a seeded generator), then serve_catalog over it."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SERVE_SEED + 2)
    H1m = np.concatenate([
        He + rng.normal(0, CATALOG_1M["sigma"], He.shape).astype(np.float32)
        for _ in range(CATALOG_1M["reps"])])[:CATALOG_1M["items"]]
    print(f"[serve] catalog {H1m.shape} built in "
          f"{time.perf_counter() - t0:.1f} s (host)", flush=True)
    return serve_catalog(f"{H1m.shape[0]} items", We, H1m, device)


def run_bench_serve(extra=()) -> dict:
    """``python -m cuda_recommender_tpu_torch.cli.bench_serve`` with
    ``extra``: its one JSON line, checked (the card, a positive value, the
    default ALS training's K5 launched)."""
    cmd = [sys.executable, "-m", "cuda_recommender_tpu_torch.cli.bench_serve",
           *extra]
    print("[bench_serve] " + " ".join(cmd[1:]), flush=True)
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=300)
    if res.returncode != 0:
        print(res.stdout + res.stderr, flush=True)
        raise AssertionError(f"bench_serve exited {res.returncode}")
    lines = res.stdout.strip().splitlines()
    rec = json.loads(lines[-1])
    d = rec["detail"]
    print(res.stdout.strip(), flush=True)
    if (len(lines) != 1 or d["device"]["platform"] != "gpu"
            or not rec["value"] > 0 or d["launches"]["gj_solve"] <= 0):
        raise AssertionError(f"bench_serve {extra}: {lines}")
    if "--latency" in extra:
        if not d["p99_ms"] >= rec["value"]:
            raise AssertionError(f"bench_serve latency {d}")
    elif not 0 < d["recall_at_k"] <= 1:
        raise AssertionError(f"bench_serve recall {d['recall_at_k']}")
    print(f"[bench_serve] {rec['value']} {rec['unit']}; K5 launches "
          f"{d['launches']['gj_solve']} [{time.perf_counter() - t0:.1f} s]",
          flush=True)
    return rec


def _main_out(fn, argv) -> str:
    """One CLI's ``main(argv)`` in this process; its standard output
    (printed too). Raises on a non-zero return."""
    import contextlib
    import io

    print("[cli] " + fn.__module__ + " " + " ".join(argv), flush=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    print(buf.getvalue(), end="", flush=True)
    if rc != 0:
        raise AssertionError(f"{fn.__module__} returned {rc}")
    return buf.getvalue()


def run_serving_cli(device) -> None:
    """The file and serving CLIs in sequence at ml1m dims: a text ratings
    file from the synthetic generator through cli.convert, cli.train -ALS
    <dir> --save-model (K5), cli.predict score and topk, and cli.train
    <dir> -p 1 (AUTO -> dense: K4 and the masked sweeps) in a temporary
    working directory. Each CLI runs through its main() in this process;
    the launch counts are set to 0 before each training and read after."""
    from cuda_recommender_tpu_torch.cli import convert, predict
    from cuda_recommender_tpu_torch.cli import train as cli_train
    from cuda_recommender_tpu_torch.data import binfmt
    from cuda_recommender_tpu_torch.data.datasets import synthetic
    from cuda_recommender_tpu_torch.ops import launches as lc

    R, T = synthetic(**ML1M)
    rows = [np.concatenate(x) for x in zip(R.to_coo(), (T.row_idx, T.col_idx,
                                                       T.val))]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        txt, ds, model = (os.path.join(tmp, x) for x in ("ratings.txt", "ds",
                                                         "model"))
        np.savetxt(txt, np.stack([rows[0] + 1, rows[1] + 1, rows[2]], 1),
                   fmt="%d %d %.6f")
        print(f"[cli] {len(rows[0])} ratings written at {R.rows} x {R.cols} "
              f"[{time.perf_counter() - t0:.1f} s]", flush=True)
        _main_out(convert.main, [txt, ds, "--test-fraction", "0.1"])
        R2, T2 = binfmt.load_binary_dataset(ds)
        lc.reset_launch_counts()
        out = _main_out(cli_train.main, [ds, "-ALS", "-k", "10", "-t", "3",
                                         "-l", "0.05", "--save-model",
                                         model])
        if lc.launch_counts()["gj_solve"] <= 0 or "RMSE=nan" in out:
            raise AssertionError("train -ALS <dir>: no K5 launch or a NaN")
        W, H = binfmt.load_model(model)
        test_txt = os.path.join(tmp, "test.txt")
        np.savetxt(test_txt, np.stack([T2.row_idx + 1, T2.col_idx + 1,
                                       T2.val], 1), fmt="%d %d %.6f")
        pred_out = os.path.join(tmp, "pred")
        out = _main_out(predict.main, ["score", model, test_txt, "-o",
                                       pred_out])
        pred = np.loadtxt(pred_out)
        want = np.einsum("ek,ek->e", W[T2.row_idx], H[T2.col_idx])
        rmse = float(re.search(r"Test RMSE = (\S+)\.", out).group(1))
        if (pred.shape != (T2.nnz,) or np.abs(pred - want).max() > 1e-4
                or not math.isfinite(rmse)):
            raise AssertionError(f"predict score: {pred.shape}, RMSE {rmse}")
        out = _main_out(predict.main, ["topk", model, "0,1,2", "-k", "10"])
        top0 = [int(x.split(":")[0]) for x in
                out.splitlines()[0].split(": ", 1)[1].split(", ")]
        s0 = H @ W[0]
        if len(out.splitlines()) != 3 or np.abs(
                np.sort(s0)[::-1][:10] - s0[top0]).max() > 1e-4:
            raise AssertionError(f"predict topk: {out}")
        os.chdir(tmp)
        try:
            lc.reset_launch_counts()
            _main_out(cli_train.main, [ds, "-p", "1"])
            launches = lc.launch_counts()
            n_out = len(open("output").read().splitlines())
            ok = os.path.exists("model") and n_out == T2.nnz
        finally:
            os.chdir(cwd)
        if not ok or launches["fused_update_vsweep"] <= 0:
            raise AssertionError(f"train <dir> -p 1: {n_out} lines, "
                                 f"launches {launches}")
    print(f"[cli] convert -> train -ALS --save-model -> predict score, "
          f"topk -> train -p 1: done; predict RMSE {rmse:.6f}, {T2.nnz} "
          f"lines", flush=True)


#: phases 27-29: checkpoint/resume runs — (iterations straight, iterations
#: before the checkpoint); the resumed run goes on to the first number
RESUME_ITERS = (4, 2)
#: phase 29: the hybrid at ml10M dims, bf16 NaN panels with the panel
#: kernels, the headline's hand stair under a 3e8-cell budget (two panels
#: or more, an ELL tail)
RESUME_HYBRID = dict(k=40, lambda_=0.05, backend="hybrid",
                     residual_dtype="bfloat16", mask_dtype="nan",
                     hybrid_panel_kernel=True,
                     hybrid_dense_cells=300_000_000,
                     hybrid_panel_widths=HEADLINE["widths"])
#: phases 30-31: phase timing; the RMSE bar against the fused run at the
#: same iteration (set from the measured gap on an H100, 3.3e-7, with room
#: for the two schedules' bf16 roundings) and the rank-RMSE bar of the CLI
PHASE_ITERS = 2
PHASE_RMSE_TOL = 1e-4
RANK_RMSE_TOL = 1e-5
#: phases 31-32 read phase 12's cached ml10M data through the CLI's spec
ML10M_SPEC = "synthetic:m=69878,n=10677,nnz=10000000,seed=1,cache=1"
#: phase 32: pure-ELL iterations, and those before its checkpoint
ELL_ITERS = (3, 2)


def _count(launches, total) -> None:
    """Add one path's launch counts to ``total``."""
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n


def run_resume(what, device, R, T, cfg_kw, *, iters, split,
               want_kernels) -> dict:
    """train() ``iters`` outer iterations straight, then ``split`` with a
    checkpoint after each, then resumed from the last to ``iters``: W and H
    bit-equal, the resumed run's iterations split+1..iters. The launch
    counts are set to 0 just before the straight run and read just after;
    each of ``want_kernels`` must have launched. Returns the launches, the
    snapshot bytes, the save and load seconds (the trainer's ``checkpoint``
    and ``resume`` events), the plan event (if any), the last snapshot's
    array shapes, the runs' s/iter and RMSE."""
    from cuda_recommender_tpu_torch import Config, train
    from cuda_recommender_tpu_torch.core.metrics_log import MetricsLog
    from cuda_recommender_tpu_torch.ops import launches as lc

    with tempfile.TemporaryDirectory() as tmp:
        mf, ck = os.path.join(tmp, "m.jsonl"), os.path.join(tmp, "ck")
        log = MetricsLog(mf)
        torch.cuda.empty_cache()
        lc.reset_launch_counts()
        try:
            full = train(Config(maxiter=iters, **cfg_kw), R, T,
                         device=device, log=log)
            launches = lc.launch_counts()
            train(Config(maxiter=split, checkpoint_dir=ck,
                         checkpoint_every=1, **cfg_kw), R, T, device=device,
                  log=log)
            res = train(Config(maxiter=iters, checkpoint_dir=ck, **cfg_kw),
                        R, T, device=device, log=log,
                        resume_from_checkpoint=True)
        finally:
            log.close()
        saves, loads = _events(mf, "checkpoint"), _events(mf, "resume")
        plans = _events(mf, "hybrid_plan")
        with np.load(os.path.join(ck, f"ckpt_{split:06d}.npz")) as z:
            shapes = {key: z[key].shape for key in z.files}
    for name in "WH":
        a, b = getattr(full, name), getattr(res, name)
        if not np.array_equal(a.view(np.int32), b.view(np.int32)):
            raise AssertionError(f"{what}: resumed {name} not bit-equal, "
                                 f"max|diff| {float(np.abs(a - b).max())}")
    if [st.oiter for st in res.stats] != list(range(split + 1, iters + 1)):
        raise AssertionError(f"{what}: resumed iterations "
                             f"{[st.oiter for st in res.stats]}")
    if [e["oiter"] for e in saves] != list(range(1, split + 1)) or \
            [e["oiter"] for e in loads] != [split]:
        raise AssertionError(f"{what}: checkpoints {saves}, resume {loads}")
    missing = [k for k in want_kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{what}: {missing} never launched: {launches}")
    _check_rmse(what, [st.rmse for st in full.stats], iters)
    out = dict(launches=launches, bytes=saves[-1]["bytes"],
               save_s=[e["save_s"] for e in saves], load_s=loads[0]["load_s"],
               plan=plans[0] if plans else None, shapes=shapes,
               s_iter=_steady(full.stats),
               rmse=[st.rmse for st in full.stats], W=full.W, H=full.H)
    print(f"[resume] {what}: W, H bit-equal after {split} + "
          f"{iters - split} iterations to {iters} straight; resumed "
          f"iterations {[st.oiter for st in res.stats]}; snapshot "
          f"{out['bytes']} bytes ({out['bytes'] / 1e9:.3f} GB), save "
          f"{[round(x, 3) for x in out['save_s']]} s, load "
          f"{out['load_s']:.3f} s; s/iter {out['s_iter']:.4f}; RMSE "
          f"{out['rmse']}; launches {launches}", flush=True)
    del full, res
    torch.cuda.empty_cache()
    return out


def run_hybrid_resume(device, R, T) -> dict:
    """Phase 29: the bf16 NaN-panel hybrid with the panel kernels at ml10M
    dims; the plan has >= 2 panels and an ELL tail; each snapshot panel
    has the JAX panel-kernel path's block-padded shape."""
    from cuda_recommender_tpu_torch.solvers.hybrid_state import (
        padded_panel_shape)

    out = run_resume("hybrid ml10M k=40 bf16 NaN panels", device, R, T,
                     RESUME_HYBRID, iters=RESUME_ITERS[0],
                     split=RESUME_ITERS[1],
                     want_kernels=("panel_update_vsweep", "panel_usweep"))
    plan = out["plan"]
    panels = [tuple(p) for p in plan["panels"]]
    print(f"[resume] hybrid plan: {len(panels)} panels {panels}, "
          f"{plan['panel_cells']} cells, tail nnz {plan['nnz_light']} "
          f"({100.0 * plan['nnz_light'] / plan['nnz']:.2f}% of nnz)",
          flush=True)
    if len(panels) < 2 or plan["nnz_light"] <= 0:
        raise AssertionError(f"hybrid resume plan {panels}, tail "
                             f"{plan['nnz_light']}")
    for i, (r0, r1, w) in enumerate(panels):
        want = padded_panel_shape(r1 - r0, w)
        got = out["shapes"][f"extra_Rd_{i}"]
        if got != want:
            raise AssertionError(f"snapshot Rd_{i} {got}, JAX's padded "
                                 f"shape {want}")
    print(f"[resume] snapshot panels have the JAX padded shapes "
          f"{[out['shapes'][f'extra_Rd_{i}'] for i in range(len(panels))]}",
          flush=True)
    return out


def run_phase_headline(device, R, T, head) -> dict:
    """Phase 30: train() with phase timing at the headline configuration,
    PHASE_ITERS iterations (the launch counts set to 0 just before and read
    just after): K3 and K2 per rank and panel, no K1; rank_time > 0 every
    iteration and update_time > 0 from iteration 2; the RMSE within
    PHASE_RMSE_TOL of phase 4's at each iteration. Then one phase-mode
    update of a panel of panel 0's shape under torch.profiler
    (``update_split``)."""
    from cuda_recommender_tpu_torch import Config, train
    from cuda_recommender_tpu_torch.core.metrics_log import MetricsLog
    from cuda_recommender_tpu_torch.ops import launches as lc

    cfg = Config(k=HEADLINE["k"], lambda_=HEADLINE["lam"],
                 maxiter=PHASE_ITERS, backend="hybrid",
                 residual_dtype="bfloat16", mask_dtype="nan",
                 hybrid_panel_kernel=True,
                 hybrid_dense_cells=HEADLINE["budget"],
                 hybrid_panel_widths=HEADLINE["widths"], phase_timing=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lc.reset_launch_counts()
    res = train(cfg, R, T, device=device, log=MetricsLog(None))
    launches = lc.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    P = len(head["panels"])
    per = HEADLINE["k"] * PHASE_ITERS * P
    want = {name: 0 for name in launches}
    want.update(panel_vsweep=per, panel_usweep=per)
    if launches != want:
        raise AssertionError(f"phase-timed launches {launches}, want {want}")
    split = [dict(oiter=st.oiter, rank_s=st.rank_time,
                  update_s=st.update_time, rmse_s=st.rmse_time,
                  s_iter=st.rank_time + st.update_time + st.rmse_time,
                  rmse=st.rmse) for st in res.stats]
    for row, fused in zip(split, head["rmse"]):
        if not row["rank_s"] > 0 or (row["oiter"] > 1
                                     and not row["update_s"] > 0):
            raise AssertionError(f"phase split {row}")
        if abs(row["rmse"] - fused) > PHASE_RMSE_TOL:
            raise AssertionError(f"phase-timed RMSE {row['rmse']} vs fused "
                                 f"{fused} at iteration {row['oiter']}")
    print(f"[phase] headline phase split {json.dumps(split)}", flush=True)
    print(f"[phase] s/iter {split[-1]['s_iter']:.4f} at iteration "
          f"{split[-1]['oiter']} (rank {split[-1]['rank_s']:.4f}, update "
          f"{split[-1]['update_s']:.4f}, rmse {split[-1]['rmse_s']:.4f}) "
          f"beside the fused {head['s_iter']:.4f} (phase 4); RMSE "
          f"{[r['rmse'] for r in split]} vs fused {head['rmse'][:PHASE_ITERS]}"
          f"; peak device memory {peak / 2**30:.2f} GiB; launches "
          f"{launches}", flush=True)
    del res
    torch.cuda.empty_cache()
    return dict(split=split, launches=launches, peak=peak,
                update=update_split(device, head["panels"][0]))


def update_split(device, panel) -> dict:
    """One phase-mode update (``rank1_update``, the plain-torch add-back)
    of a bf16 NaN panel of ``panel``'s shape, after one untraced, under
    torch.profiler: device ms per kernel, busy ms, and the ms of a bf16
    read-modify-write of the panel at the card's memory rate (4 B a
    cell), the least any update could take."""
    from cuda_recommender_tpu_torch.scripts.profile_iteration import (
        profile_split)
    from cuda_recommender_tpu_torch.solvers.ccd_dense import rank1_update

    r0, r1, w = panel
    Rd = torch.full((r1 - r0, w), 0.5, dtype=torch.bfloat16, device=device)
    Rd[::7, ::5] = float("nan")
    u = torch.rand(r1 - r0, device=device)
    v = torch.rand(w, device=device)
    out = profile_split(lambda: rank1_update(Rd, None, u, v, 1.0), device,
                        warm=1)
    out["rmw_bound_ms"] = 1e3 * 4 * Rd.numel() / PEAK_BYTES_S
    print(f"[phase] one phase-mode update of a {r1 - r0}x{w} bf16 panel "
          f"(panel 0's shape): wall {out['wall_ms']:.3f} ms, kernels busy "
          f"{out['busy_ms']:.3f} ms, a bf16 RMW at the memory rate "
          f"{out['rmw_bound_ms']:.3f} ms; kernels "
          f"{json.dumps(out['kernels'][:6])}", flush=True)
    del Rd
    torch.cuda.empty_cache()
    return out


def _cli(args, timeout=900) -> str:
    """``python -m cuda_recommender_tpu_torch.cli.train`` with ``args`` on
    the card; its standard output (printed). Raises on a non-zero exit."""
    cmd = [sys.executable, "-m", "cuda_recommender_tpu_torch.cli.train",
           *args, "--device", "cuda"]
    print("[cli] " + " ".join(cmd[1:]), flush=True)
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=timeout)
    print(res.stdout + res.stderr, flush=True)
    if res.returncode != 0:
        raise AssertionError(f"cli exited {res.returncode}")
    print(f"[cli] {time.perf_counter() - t0:.1f} s", flush=True)
    return res.stdout


def _cli_launches(stdout) -> dict:
    found = re.search(r"^\[info\] kernel launches: (\{.*\})$", stdout,
                      re.M)
    return json.loads(found.group(1))


def run_phase_cli() -> dict:
    """Phase 31: the CLI with --phase-timing -q 1 on the dense quick start
    (ml10M dims, k = 10): a rank line per rank, the last rank's RMSE equal
    to its iteration's within RANK_RMSE_TOL, update_time > 0; the masked
    sweeps launched, K4 not (phase mode updates in plain torch)."""
    k = DENSE_HEADLINE["k"]
    out = _cli(["--dataset", ML10M_SPEC, "-k", str(k), "-t",
                str(PHASE_ITERS), "-l", str(DENSE_HEADLINE["lam"]),
                "--phase-timing", "-q", "1"])
    if not re.search(r"^\[info\] Backend = dense \|", out, re.M):
        raise AssertionError("the phase-timed CLI did not run dense")
    ranks = re.findall(r"^iter (\d+) rank (\d+) time \S+ rmse (\S+)$", out,
                       re.M)
    iters = re.findall(r"^\[-INFO-\] iteration num (\d+) .*update_time "
                       r"(\S+)\|.*RMSE=(\S+)", out, re.M)
    if len(ranks) != k * PHASE_ITERS or len(iters) != PHASE_ITERS:
        raise AssertionError(f"{len(ranks)} rank lines, {len(iters)} "
                             "iteration lines")
    for it, upd, rmse in iters:
        last = [float(r) for o, t, r in ranks if o == it][-1]
        if abs(last - float(rmse)) > RANK_RMSE_TOL or not float(upd) > 0:
            raise AssertionError(f"iteration {it}: last rank RMSE {last}, "
                                 f"iteration RMSE {rmse}, update {upd}")
    launches = _cli_launches(out)
    per = k * PHASE_ITERS
    if launches["fused_update_vsweep"] != 0 or launches[
            "masked_vsweep"] != per or launches["masked_usweep"] != per:
        raise AssertionError(f"phase-timed CLI launches {launches}")
    print(f"[phase] CLI: {len(ranks)} rank lines; last rank RMSE = "
          f"iteration RMSE within {RANK_RMSE_TOL}; launches {launches}",
          flush=True)
    return dict(launches=launches)


def _golden_against(what, W, H, ref) -> list:
    """The trainer's golden check (core/trainer.py) of (W, H) against the
    factors of a golden run on the same data, init and settings (``ref``,
    phase 12's): each PASS! the strict per-entry 10% bar, or PASS with atol
    1e-3 with every strict miss a rounding miss (_check_misses); the RMSE
    within 1e-3 of the golden run's is the caller's. Returns the two strict
    verdicts, as _check_golden."""
    from cuda_recommender_tpu_torch.core.trainer import GOLDEN_ATOL
    from cuda_recommender_tpu_torch.eval.metrics import (golden_compare,
                                                         strict_misses)

    pairs = ((W, ref["W"]), (H, ref["H"]))
    strict = [golden_compare(A, B) for A, B in pairs]
    checks = [g.message().removeprefix("Check... ") for g in strict]
    if all(g.passed for g in strict):
        return checks
    near = [golden_compare(A, B, atol=GOLDEN_ATOL).passed for A, B in pairs]
    if not all(near):
        raise AssertionError(f"{what} golden check of W and H: {checks}, "
                             f"with atol {GOLDEN_ATOL}: {near}")
    _check_misses(what, [strict_misses(A, B) for A, B in pairs])
    return checks + ["with atol 1e-3 PASS, PASS"]


def run_ell(device, ref) -> dict:
    """Phase 32: the CLI on the pure-ELL backend with --save-model, its
    model held to phase 12's golden run on the same data and settings
    (``ref``: _golden_against, and the RMSE within 1e-3 an iteration; the
    CLI's --golden would run that reference again); then in this process
    2 iterations with a checkpoint, resumed to 3: W and H bit-equal to the
    CLI's saved model."""
    from cuda_recommender_tpu_torch import Config, train
    from cuda_recommender_tpu_torch.core.metrics_log import MetricsLog
    from cuda_recommender_tpu_torch.data.binfmt import load_model
    from cuda_recommender_tpu_torch.data.datasets import synthetic_from_spec

    iters, split = ELL_ITERS
    if ref["iters"] != iters:
        raise AssertionError(f"phase 12's golden run has {ref['iters']} "
                             f"iterations, phase 32 runs {iters}")
    kw = dict(k=DENSE_HEADLINE["k"], lambda_=DENSE_HEADLINE["lam"],
              backend="ell")
    with tempfile.TemporaryDirectory() as tmp:
        model = os.path.join(tmp, "model")
        out = _cli(["--dataset", ML10M_SPEC, "-k", str(kw["k"]), "-t",
                    str(iters), "-l", str(kw["lambda_"]), "--backend", "ell",
                    "--save-model", model])
        if not re.search(r"^\[info\] Backend = ell \|", out, re.M):
            raise AssertionError("the CLI did not run the ell backend")
        rmse_cli = [float(x) for x in re.findall(
            r"^\[-INFO-\] iteration num \d+ \trank_time .*RMSE=([0-9.]+)",
            out, re.M)]
        _close_rmse("pure-ELL CLI against phase 12's golden run", rmse_cli,
                    ref["rmse"], 1e-3)
        W_cli, H_cli = load_model(model, entity_major=False)
        checks = _golden_against("pure-ELL CLI", W_cli, H_cli, ref)
        rank_s = [float(x) for x in re.findall(
            r"^\[-INFO-\] iteration num \d+ \trank_time ([0-9.]+)\|", out,
            re.M)][:iters]
        s_iter = sum(rank_s[1:]) / len(rank_s[1:])
        R, T = synthetic_from_spec(ML10M_SPEC)
        ck = os.path.join(tmp, "ck")
        log = MetricsLog(None)
        train(Config(maxiter=split, checkpoint_dir=ck,
                     checkpoint_every=split, **kw), R, T, device=device,
              log=log)
        res = train(Config(maxiter=iters, checkpoint_dir=ck, **kw), R, T,
                    device=device, log=log, resume_from_checkpoint=True)
    for name, a, b in (("W", res.W, W_cli), ("H", res.H, H_cli)):
        if not np.array_equal(a.view(np.int32), b.view(np.int32)):
            raise AssertionError(f"pure ELL resumed {name} not bit-equal "
                                 f"to the CLI's {iters} iterations")
    print(f"[ell] golden {checks}; s/iter (iterations 2-{iters}) "
          f"{s_iter:.4f} ({rank_s}); resumed {split} + {iters - split} "
          f"bit-equal to the CLI's {iters} iterations", flush=True)
    return dict(s_iter=s_iter, checks=checks, W=res.W, H=res.H,
                rmse=[st.rmse for st in res.stats])

#: phase 34's sharded top-k: the first users of phase 4's factors
SHARDED_TOPK_USERS = 1024
#: phase 35: two ranks on the one card (gloo: NCCL refuses two ranks on
#: one GPU), the phase 29 hybrid run through the CLI
TWO_RANKS = 2
#: phase 35's bar on W and H against the single-device run: relative
#: Frobenius distance (a bf16 residual; see run_two_ranks)
TWO_RANKS_REL_TOL = 1e-2


def _bit_equal(what, got, want) -> None:
    for name, a, b in zip("WH", got, want):
        if a.shape != b.shape or not np.array_equal(a.view(np.int32),
                                                    b.view(np.int32)):
            raise AssertionError(f"{what}: {name} not bit-equal to the "
                                 f"single-device run")


def _close_rmse(what, got, want, tol) -> float:
    d = max(abs(a - b) for a, b in zip(got, want))
    if len(got) != len(want) or d > tol:
        raise AssertionError(f"{what}: RMSE {got} vs {want} (bar {tol})")
    return d


def _sharded_train(what, device, mesh, R, T, cfg, want_kernels) -> tuple:
    """train() over ``mesh`` with the kernel and collective counts set to
    0 just before and read just after; every kernel of ``want_kernels``
    launched. Returns (result, launches, collectives, peak bytes)."""
    from cuda_recommender_tpu_torch import train
    from cuda_recommender_tpu_torch.core.metrics_log import MetricsLog
    from cuda_recommender_tpu_torch.ops import launches as lc
    from cuda_recommender_tpu_torch.parallel import collectives as cc

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lc.reset_launch_counts()
    cc.reset_collective_counts()
    res = train(cfg, R, T, device=device, mesh=mesh, log=MetricsLog(None))
    launches, coll = lc.launch_counts(), cc.collective_counts()
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k in want_kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{what}: {missing} never launched: {launches}")
    print(f"[sharded] {what}: s/iter {_steady(res.stats):.4f}; peak device "
          f"memory {peak / 2**30:.2f} GiB; launches {launches}; "
          f"collectives {coll}", flush=True)
    return res, launches, coll, peak


def run_sharded_headline(device, R, T, head) -> dict:
    """Phase 33: the sharded hybrid (parallel/ccd_hybrid_sharded.py) at the
    headline over a world of one rank (NCCL), through train(mesh=...): K1
    and K2 launch as in phase 4, one all-reduce of (g, h) per half-sweep
    (2·k·T an outer iteration), and W, H and the RMSE bit-equal to phase
    4's single-device run (at world size 1 the schedules are the same)."""
    from cuda_recommender_tpu_torch import Config
    from cuda_recommender_tpu_torch.parallel.mesh import make_mesh

    h = HEADLINE
    cfg = Config(k=h["k"], lambda_=h["lam"], maxiter=h["iters"],
                 maxinneriter=1, backend="hybrid", residual_dtype="bfloat16",
                 mask_dtype="nan", hybrid_panel_kernel=True,
                 hybrid_dense_cells=h["budget"], hybrid_panel_widths=h["widths"])
    res, launches, coll, peak = _sharded_train(
        "hybrid headline, 1 rank", device, make_mesh(1), R, T, cfg,
        ("panel_update_vsweep", "panel_usweep"))
    want = want_launches(h["k"], h["iters"], 1, len(head["panels"]))
    if launches != want:
        raise AssertionError(f"sharded launches {launches}, want {want}")
    want_coll = {"all_reduce": 2 * h["k"] * h["iters"], "all_gather": 0,
                 "gather": 0}
    if coll != want_coll:
        raise AssertionError(f"collectives {coll}, want {want_coll}")
    _bit_equal("sharded hybrid headline", (res.W, res.H),
               (head["W"], head["H"]))
    rmse = [st.rmse for st in res.stats]
    if rmse != head["rmse"]:
        raise AssertionError(f"sharded RMSE {rmse} vs phase 4's "
                             f"{head['rmse']}")
    s_iter = _steady(res.stats)
    print(f"[sharded] headline over 1 rank: W, H and RMSE bit-equal to "
          f"phase 4; s/iter {s_iter:.4f} (phase 4: {head['s_iter']:.4f}); "
          f"peak {peak / 2**30:.2f} GiB (phase 4: {head['peak'] / 2**30:.2f}"
          f"); {coll['all_reduce']} all-reduces = 2·k·T·iterations",
          flush=True)
    return dict(launches=launches, s_iter=s_iter, peak=peak,
                collectives=coll)


def run_sharded_backends(device, head, als_ck, dense_ck, ell) -> dict:
    """Phase 34: the other sharded backends over the same world of one
    rank, each against its single-device run of the same configuration
    (W and H bit-equal, RMSE within 1e-6): ALS at ml20M dims (K5; phase
    27's straight run), the dense quick start on a 1-D mesh (K4 and the
    masked sweeps; phase 28's), pure ELL at ml10M dims (phase 32's resumed
    run); then the sharded top-10 over phase 4's 17,770 items against the
    brute force on the card."""
    from cuda_recommender_tpu_torch import Config
    from cuda_recommender_tpu_torch.data.datasets import synthetic_cached
    from cuda_recommender_tpu_torch.parallel.mesh import make_mesh
    from cuda_recommender_tpu_torch.serve.retrieval_sharded import (
        topk_mips_sharded)

    mesh = make_mesh(1)
    launches, out = {}, {}

    def held(name, what, R, T, kw, kernels, ref, iters) -> None:
        res, ln, coll, peak = _sharded_train(what, device, mesh, R, T,
                                             Config(maxiter=iters, **kw),
                                             kernels)
        _bit_equal(what, (res.W, res.H), (ref["W"], ref["H"]))
        n = len(ref["rmse"])          # phase 32's resumed run: its last
        _close_rmse(what, [st.rmse for st in res.stats][-n:], ref["rmse"],
                    1e-6)
        _count(ln, launches)
        out[name] = dict(s_iter=_steady(res.stats), peak=peak,
                         collectives=coll)

    A, D = ALS_HEADLINE, DENSE_HEADLINE
    R, T = synthetic_cached(A["m"], A["n"], A["nnz"], seed=1,
                            test_fraction=0.02)
    held("als", "ALS ml20M k=40", R, T,
         dict(solver="als", k=A["k"], lambda_=A["lam"], als_solver="gj",
              als_precision="highest"), ("gj_solve",), als_ck,
         RESUME_ITERS[0])
    R, T = synthetic_cached(D["m"], D["n"], D["nnz"], seed=1)
    held("dense", "dense ml10M k=10, 1-D mesh", R, T,
         dict(k=D["k"], lambda_=D["lam"]),
         ("fused_update_vsweep", "masked_usweep"), dense_ck, RESUME_ITERS[0])
    held("ell", "ell ml10M k=10", R, T,
         dict(k=D["k"], lambda_=D["lam"], backend="ell"), (), ell,
         ELL_ITERS[0])
    del R, T
    users = np.arange(SHARDED_TOPK_USERS)
    t0 = time.perf_counter()
    s, i = topk_mips_sharded(head["W"], head["H"], users, mesh,
                             topk=SERVE["topk"], entity_major=False,
                             device=device)
    topk_s = time.perf_counter() - t0
    U = torch.from_numpy(np.ascontiguousarray(head["W"].T[users])).to(device)
    Hd = torch.from_numpy(np.ascontiguousarray(head["H"].T)).to(device)
    full = U @ Hd.T
    d_s, same = check_topk("sharded top-10", torch.from_numpy(s).to(device),
                           torch.from_numpy(i).to(device), full,
                           torch.topk(full, SERVE["topk"], dim=1).values)
    print(f"[sharded] top-{SERVE['topk']} of {len(users)} users over "
          f"{Hd.shape[0]} items, 1 rank: max score diff {d_s:.3e}, ids equal "
          f"to the brute force's in {100 * same:.2f}% of slots (the rest "
          f"ties); {topk_s:.3f} s", flush=True)
    out["topk"] = dict(score_diff=d_s, same_ids=same)
    return dict(launches=launches, runs=out)


def run_two_ranks(hyb_ck) -> dict:
    """Phase 35: phase 29's hybrid (ml10M dims, k=40, bf16 NaN panels, the
    panel kernels, 3e8 cells) through ``cli.train --mesh 2`` in two
    processes on the one card (``parallel/launch.py``; both ranks on
    cuda:0, so gloo, whose all-reduce takes CUDA tensors: NCCL does not
    allow two ranks on one GPU). Held against phase 29's single-device run
    of the same data: each iteration's RMSE within PHASE_RMSE_TOL, and W
    and H within TWO_RANKS_REL_TOL of it in relative Frobenius norm. A
    bf16 residual: the two ranks' f32 partial sums, added in another
    order, move the last bit of a few factor entries, and each such move
    flips bf16 roundings of the residual downstream, so single entries
    drift by up to a few 1e-3 (6.4e-3 at a 400 x 150 CPU run, against
    1.0e-5 at an f32 residual), not the trajectory."""
    from cuda_recommender_tpu_torch.data.binfmt import load_model
    from cuda_recommender_tpu_torch.parallel.launch import run_ranks

    kw = RESUME_HYBRID
    iters = RESUME_ITERS[0]
    with tempfile.TemporaryDirectory() as tmp:
        model = os.path.join(tmp, "model")
        args = ["-m", "cuda_recommender_tpu_torch.cli.train", "--mesh",
                str(TWO_RANKS), "--dist-backend", "gloo", "--dataset",
                ML10M_SPEC, "-k", str(kw["k"]), "-t", str(iters), "-l",
                str(kw["lambda_"]), "--backend", "hybrid",
                "--residual-dtype", "bfloat16", "--mask-dtype", "nan",
                "--panel-kernel", "--hybrid-cells",
                str(kw["hybrid_dense_cells"]), "--panel-widths",
                ",".join(str(w) for w in kw["hybrid_panel_widths"]),
                "--save-model", model, "--device", "cuda"]
        print("[two ranks] gloo over 2 processes on cuda:0: "
              + " ".join(args[1:]), flush=True)
        t0 = time.perf_counter()
        res = run_ranks(args, TWO_RANKS, timeout=600,
                        local_ranks=[0] * TWO_RANKS, cwd=HERE)
        wall = time.perf_counter() - t0
        for rank, (rc, text) in enumerate(res):
            print(f"[two ranks] rank {rank} exited {rc}:\n{text}", flush=True)
        if any(rc != 0 for rc, _ in res):
            raise AssertionError("two ranks on one card failed")
        W, H = load_model(model, entity_major=False)
    out0 = res[0][1]
    rmse = [float(x) for x in re.findall(
        r"^\[-INFO-\] iteration num \d+ .*RMSE=(\S+)", out0, re.M)]
    rank_s = [float(x) for x in re.findall(
        r"^\[-INFO-\] iteration num \d+ \trank_time ([0-9.]+)\|", out0,
        re.M)]
    d = _close_rmse("two ranks", rmse, hyb_ck["rmse"], PHASE_RMSE_TOL)
    rel = {name: float(np.linalg.norm(a - b) / np.linalg.norm(b))
           for name, a, b in (("W", W, hyb_ck["W"]), ("H", H, hyb_ck["H"]))}
    if max(rel.values()) > TWO_RANKS_REL_TOL:
        raise AssertionError(f"two ranks: factors off the single-device "
                             f"run: relative distance {rel}")
    launches = _cli_launches(out0)
    for name in ("panel_update_vsweep", "panel_usweep"):
        if launches[name] <= 0:
            raise AssertionError(f"two ranks: {name} never launched")
    s_iter = sum(rank_s[1:]) / len(rank_s[1:])
    print(f"[two ranks] backend gloo; RMSE {rmse} vs one device "
          f"{hyb_ck['rmse']} (max diff {d:.3e}); relative distance "
          f"{rel}; max |dW| "
          f"{float(np.abs(W - hyb_ck['W']).max()):.3e}, |dH| "
          f"{float(np.abs(H - hyb_ck['H']).max()):.3e}; s/iter {s_iter:.4f} "
          f"(one device {hyb_ck['s_iter']:.4f}); rank 0's launches "
          f"{launches}; {wall:.1f} s", flush=True)
    return dict(launches=launches, s_iter=s_iter, rmse_diff=d, rel=rel)


#: phase 36: the ALS headline's other gram precisions, each held to phase
#: 8's "highest" run an iteration: "high" (bf16x3) within 1e-3, the CPU
#: test's bar (tests/test_torch_als_precision.py); "default" (one bf16
#: pass) within 0.01, the JAX package's own bar for it
#: (tests/test_compiled_solvers.py:146-155)
ALS_PREC_RMSE = {"high": 1e-3, "default": 1e-2}
ALS_PRECISIONS = tuple(ALS_PREC_RMSE)
#: phase 37: the bf16 gram products against their plain version. Products
#: of bf16 values are exact in f32, so the card's product and the plain
#: one differ only in the order of their f32 sums over E lanes; each sum
#: lies within E·eps·Σ|terms| of the exact one (eps = 2^-23, f32's machine
#: epsilon: it also covers an accumulator that truncates), so the two lie
#: within PRODUCT_BAR·E·eps·Σ|terms| of each other
PRODUCT_BAR = 2.0
F32_EPS = 2.0 ** -23


def _als_setup(device):
    """The ALS headline's data (phase 8's cache), its ELL layout (planned
    once) and the trainer's initial slot-space state on ``device``."""
    from cuda_recommender_tpu_torch.core.init import init_factors_np
    from cuda_recommender_tpu_torch.data.datasets import synthetic_cached
    from cuda_recommender_tpu_torch.data.ell import build_ell_pair
    from cuda_recommender_tpu_torch.solvers import als_ell
    from cuda_recommender_tpu_torch.solvers.als_state import (
        als_state_from_numpy, slot_payload)

    A = ALS_HEADLINE
    R, T = synthetic_cached(A["m"], A["n"], A["nnz"], seed=1,
                            test_fraction=0.02)
    W0, H0 = init_factors_np(A["k"], R.rows, R.cols, seed=0,
                             entity_major=True)
    ell = build_ell_pair(R, min_width="auto")
    W, H = als_state_from_numpy(slot_payload(ell, W0, H0), ell, device)
    tiles = (*als_ell.side_tensors(ell.rows_side, device),
             *als_ell.side_tensors(ell.cols_side, device))
    nnz = (torch.as_tensor(ell.rows_side.slot_nnz, device=device),
           torch.as_tensor(ell.cols_side.slot_nnz, device=device))
    return R, T, ell, W, H, tiles, nnz


def run_als_precisions(device, als) -> dict:
    """Phase 36: train() at the ALS headline under "high" and "default"
    (the launch counts set to 0 just before each run and read just after:
    K5 launched per_iter x iterations), each run's s/iter and RMSE per
    iteration against phase 8's "highest" run (ALS_PREC_RMSE); then
    "highest" again, W, H and the RMSE bit-equal to phase 8's run (the
    bf16 runs changed no process-wide matmul flag). After each run one
    profiled outer step at its precision on one ELL layout, planned once:
    the gram products', the gathers' and K5's ms
    (scripts/profile_iteration.py::kernel_split) beside the assembly's
    bound (scripts/common.py::assembly_bound)."""
    from cuda_recommender_tpu_torch import Config, train
    from cuda_recommender_tpu_torch.core.metrics_log import MetricsLog
    from cuda_recommender_tpu_torch.ops import launches as lc
    from cuda_recommender_tpu_torch.scripts.common import assembly_bound
    from cuda_recommender_tpu_torch.scripts.profile_iteration import (
        kernel_split, profile_split)
    from cuda_recommender_tpu_torch.solvers import als_ell

    A = ALS_HEADLINE
    R, T, ell, W, H, tiles, nnz = _als_setup(device)
    idx_r, vals_r, idx_c, vals_c = tiles
    slots = ell.rows_side.n_slots + ell.cols_side.n_slots
    out, launches, factors = {}, {}, {}
    for prec in (*ALS_PRECISIONS, "highest"):
        cfg = Config(solver="als", k=A["k"], lambda_=A["lam"],
                     maxiter=A["iters"], als_solver="gj",
                     als_precision=prec)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        lc.reset_launch_counts()
        res = train(cfg, R, T, device=device, log=MetricsLog(None))
        ln = lc.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        rmse = [st.rmse for st in res.stats]
        per_iter = als_ell.k5_launches_per_iter(ell, A["k"], "gj",
                                                cfg.als_group_mb << 20, prec)
        want = {name: 0 for name in ln}
        want["gj_solve"] = per_iter * A["iters"]
        want["als_gram"] = als_ell.als_gram_launches_per_iter(
            ell, A["k"], cfg.als_group_mb << 20, prec) * A["iters"]
        if ln != want:
            raise AssertionError(f"ALS {prec}: launches {ln}, want {want}")
        _count(ln, launches)
        diff = [a - b for a, b in zip(rmse, als["rmse"])]
        if prec == "highest":
            _bit_equal("ALS highest after high and default", (res.W, res.H),
                       (als["W"], als["H"]))
            if rmse != als["rmse"]:
                raise AssertionError(f"ALS highest RMSE {rmse} vs phase "
                                     f"8's {als['rmse']}")
            print("[als] highest after high and default: W, H and RMSE "
                  "bit-equal to phase 8", flush=True)
        else:
            _check_rmse(f"ALS {prec}", rmse, A["iters"])
            if max(map(abs, diff)) > ALS_PREC_RMSE[prec]:
                raise AssertionError(f"ALS {prec}: RMSE {rmse} vs highest "
                                     f"{als['rmse']} (bar "
                                     f"{ALS_PREC_RMSE[prec]})")
        factors[prec] = dict(W=res.W, H=res.H, rmse=rmse)
        step = als_ell.make_als_outer_step(ell, A["lam"], solver="gj",
                                           precision=prec)
        prof = profile_split(lambda: step(idx_r, idx_c, vals_r, vals_c, W,
                                          H, *nnz), device)
        parts = kernel_split(prof)
        kernels = sorted({name for name, _, _ in prof["kernels"]
                          if re.search(r"gemm|nvjet|xmma|cutlass", name)})
        s_iter = _steady(res.stats)
        b_ms, b_by = assembly_bound(R.nnz, slots, A["k"], prec)
        out[prec] = dict(s_iter=s_iter, rmse=rmse, rmse_vs_highest=diff,
                         k5_per_iter=per_iter, launches=ln["gj_solve"],
                         peak=peak, busy_ms=prof["busy_ms"],
                         idle_pct=prof["idle_pct"], parts_ms=parts,
                         gemm_kernels=kernels, assembly_bound_ms=b_ms,
                         assembly_bound_by=b_by)
        print(f"[als] {prec}: s/iter {s_iter:.4f} (highest "
              f"{als['s_iter']:.4f}); RMSE {rmse}, minus highest's {diff} "
              f"(bar {ALS_PREC_RMSE.get(prec, 0.0)}); K5 {per_iter} an "
              "iteration, "
              f"{ln['gj_solve']} launches; peak {peak / 2**30:.2f} GiB; one "
              f"profiled step: busy {prof['busy_ms']:.3f} ms, idle "
              f"{prof['idle_pct']:.2f}%, " + ", ".join(
                  f"{p} {ms:.3f} ms" for p, ms in parts.items())
              + f"; gram kernels {kernels}; the assembly's bound "
              f"{b_ms:.3f} ms ({b_by}) against its gram kernel, gathers "
              f"and products' "
              f"{parts['gram'] + parts['bmm'] + parts['gather']:.3f}",
              flush=True)
        del res, step
    del R, T, tiles
    torch.cuda.empty_cache()
    return dict(runs=out, launches=launches, factors=factors)


def check_gram_products(device) -> float:
    """Phase 37: the bf16 gram products on the card (``gram_product``:
    ``torch.bmm`` with an f32 result on the tensor cores) against their
    plain version (``gram_product_plain``: widened to f32, one f32 bmm) on
    the ALS headline's operands: both sides, every bucket's first row
    group, each product of "default" and of "high" (hi·hi, hi·lo, lo·hi),
    every entry within PRODUCT_BAR·E·eps·Σ|terms|. Returns the largest
    |card - plain|."""
    from cuda_recommender_tpu_torch.solvers import als_ell

    A = ALS_HEADLINE
    R, T, ell, W, H, tiles, _ = _als_setup(device)
    idx_r, vals_r, idx_c, vals_c = tiles
    worst, ratio, n = 0.0, 0.0, 0
    for prec in ALS_PRECISIONS:
        for side, other, idx_t, val_t in (
                (ell.rows_side, H, idx_r, vals_r),
                (ell.cols_side, W, idx_c, vals_c)):
            tables = als_ell.gram_tables(other, prec)
            for b, idx, val in zip(side.buckets, idx_t, val_t):
                r0, r1 = als_ell._row_groups(b.rows, b.L, b.p, A["k"],
                                             precision=prec)[0]
                F = als_ell.gather_operands(idx[r0:r1], val[r0:r1], tables,
                                            b, A["k"], prec)
                pairs = ((0, 0),) if prec == "default" else (
                    (0, 0), (0, 1), (1, 0))
                for i, j in pairs:
                    got = als_ell.gram_product(F[i], F[j])
                    want = als_ell.gram_product_plain(F[i], F[j])
                    terms = als_ell.gram_product_plain(F[i].abs(),
                                                       F[j].abs())
                    err = (got - want).abs()
                    bar = PRODUCT_BAR * b.E * F32_EPS * terms
                    if got.dtype != torch.float32 or bool((err > bar).any()):
                        raise AssertionError(
                            f"gram product {prec} ({i}, {j}) at bucket E="
                            f"{b.E}: max |diff| {float(err.max()):.3e} over "
                            f"the bar")
                    worst = max(worst, float(err.max()))
                    ratio = max(ratio, float((err / bar.clamp_min(
                        1e-30)).max()))
                    n += 1
    print(f"[gram] {n} bf16 products (default; high's hi·hi, hi·lo, lo·hi) "
          f"on both sides' buckets against the plain f32 product: max "
          f"|diff| {worst:.3e}, at most {100 * ratio:.1f}% of the bar "
          f"{PRODUCT_BAR:g}·E·2^-23·Σ|terms|", flush=True)
    del R, T, tiles
    torch.cuda.empty_cache()
    return worst


def run_sharded_als_default(device, factors) -> dict:
    """Phase 38: sharded ALS under "default" over a world of one rank
    (NCCL) through train(mesh=...), W, H bit-equal and the RMSE within
    1e-6 of phase 36's single-device "default" run; K5 launched."""
    from cuda_recommender_tpu_torch import Config
    from cuda_recommender_tpu_torch.data.datasets import synthetic_cached
    from cuda_recommender_tpu_torch.parallel import multihost
    from cuda_recommender_tpu_torch.parallel.mesh import make_mesh

    A = ALS_HEADLINE
    ref = factors["default"]
    R, T = synthetic_cached(A["m"], A["n"], A["nnz"], seed=1,
                            test_fraction=0.02)
    cfg = Config(solver="als", k=A["k"], lambda_=A["lam"],
                 maxiter=A["iters"], als_solver="gj", als_precision="default")
    multihost.initialize_local("cuda")
    try:
        res, ln, coll, peak = _sharded_train("ALS ml20M default", device,
                                             make_mesh(1), R, T, cfg,
                                             ("gj_solve",))
    finally:
        multihost.shutdown()
    _bit_equal("sharded ALS default", (res.W, res.H), (ref["W"], ref["H"]))
    d = _close_rmse("sharded ALS default", [st.rmse for st in res.stats],
                    ref["rmse"], 1e-6)
    print(f"[sharded] ALS default over 1 rank: W, H bit-equal to phase "
          f"36's run, RMSE within {d:.1e}", flush=True)
    return dict(launches=ln, s_iter=_steady(res.stats), peak=peak)


def run_host_setup() -> dict:
    """Phase 39: the host set-up split at Netflix-100M dims (phase 4's
    cached data), NumPy then native (scripts/host_setup.py, one turn):
    every output byte-equal between the paths; then the native helpers'
    path counts of the whole smoke, which must show the native path."""
    from cuda_recommender_tpu_torch import native
    from cuda_recommender_tpu_torch.scripts import host_setup

    smoke_paths = native.path_counts()
    h = HEADLINE
    out = host_setup.run(h["m"], h["n"], h["nnz"], seed=1, turns=1)
    for helper in ("groupsort", "ellfill"):
        if smoke_paths[helper]["native"] <= 0:
            raise AssertionError(f"the smoke's runs never took the native "
                                 f"{helper}: {smoke_paths}")
    print(f"[host] Netflix-100M dims, NumPy -> native: " + ", ".join(
        f"{step} {out['median_s']['numpy'][step]:.3f} -> "
        f"{out['median_s']['native'][step]:.3f} s" for step in
        host_setup.STEPS) + f"; outputs byte-equal; the smoke's own "
        f"native path counts {smoke_paths}", flush=True)
    out["smoke_paths"] = smoke_paths
    return out


#: phase 40: outer iterations of each ml1m trajectory arm
TRAJ_ITERS = 3


def run_trajectories_phase() -> dict:
    """``scripts/run_trajectories.py`` at TRAJ_ITERS iterations on the card
    (the fixture converted in a temp dir, the records written there): each
    arm launched its kernels (the script asserts it), each iteration's
    RMSE pair lies within the script's bars of the JAX package's committed
    record (``results/rmse_trajectory_ml1m_*.jsonl``), and each arm meets
    its golden run's bar (``run_trajectories.golden_misses``)."""
    from cuda_recommender_tpu_torch.scripts import run_trajectories as rt

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = rt.run(TRAJ_ITERS, os.path.join(tmp, "work"),
                     os.path.join(tmp, "out"), "cuda")
    misses = rt.compare(out, rt.jax_records())
    if misses:
        raise AssertionError("trajectories off the JAX records or the "
                             "golden runs: " + "; ".join(misses))
    print(f"[trajectories] {len(out)} arms, {TRAJ_ITERS} iterations each, "
          f"within the bars {rt.BARS} of the JAX records, dense CCD++ "
          f"golden PASS, ALS under {rt.ALS_GOLDEN_PCT}% off, hybrids within "
          f"{rt.HYBRID_GOLDEN_GAP} of the golden RMSE, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


#: phase 41: the reference grid at ml1m dims (sweep.py), cut
SWEEP_SMOKE = dict(ks="5,10", inners="1,3", repeats=2, iters=3)
SWEEP_SMOKE_DATA = "synthetic:m=6040,n=3706,nnz=900000"
#: phase 41: the variance probe's counts (A, B groups x size, C), cut
VARIANCE_SMOKE = dict(n_a=6, b_groups=2, n_c=2)


def run_measurement_scripts(device, head) -> dict:
    """Phase 41: the measurement scripts, each path with the
    launch counts set to 0 just before it and read just after.

    * ``scripts/sweep.py`` at ml1m dims (CCD++ k 5, 10 x T 1, 3 and ALS,
      2 repeats at a fixed seed, 3 iterations): every repeat bit-equal,
      K4, the masked sweeps and K5 launched;
    * one flagship row (``sweep_netflix_hybrid.run_repeat``: k = 40,
      6.5e9 cells, the hand stair, T = 1, one repeat) on phase 4's cached
      data: its group-difference s/iter within BENCH_S_ITER_TOL of phase
      4's, its RMSE within the script's RMSE_TOL of the JAX record's row;
    * ``headline_variance.probe`` at VARIANCE_SMOKE's counts on that row's
      plan and state;
    * ``bench_als`` part 2 ("high", "default" on the ml1m fixture against
      the NumPy golden; its ``golden_misses``);
    * ``scaling_model`` anchored to phase 4's s/iter (N = 1 equal to it)."""
    from cuda_recommender_tpu_torch.data.datasets import synthetic_cached
    from cuda_recommender_tpu_torch.ops import launches as lc
    from cuda_recommender_tpu_torch.scripts import bench_als, sweep
    from cuda_recommender_tpu_torch.scripts import headline_variance as hv
    from cuda_recommender_tpu_torch.scripts import scaling_model as sm
    from cuda_recommender_tpu_torch.scripts import sweep_netflix_hybrid as snh

    paths = {}
    t0 = time.perf_counter()
    lc.reset_launch_counts()
    recs = sweep.run(SWEEP_SMOKE_DATA, None, device=device, **SWEEP_SMOKE)
    got = lc.launch_counts()
    _count(got, paths)
    bad = sweep.repeat_mismatches(recs)
    if bad or not all(math.isfinite(r["final_rmse"]) for r in recs):
        raise AssertionError(f"sweep repeats differ or RMSE not finite: "
                             f"{bad}")
    for name in ("fused_update_vsweep", "masked_usweep", "masked_vsweep",
                 "gj_solve"):
        if not got[name]:
            raise AssertionError(f"sweep.py: {name} never launched: {got}")
    print(f"[sweep] {len(recs)} cells at {SWEEP_SMOKE_DATA}, repeats "
          f"bit-equal; launches { {k: n for k, n in got.items() if n} }; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    row = snh.GRID[snh.HEADLINE_ROW]
    R, T = synthetic_cached(*snh.DIMS, seed=1, test_fraction=0.02)
    plan, plan_s = snh.make_plan(R, snh.BUDGETS[row[1]], row[2])
    rec, st, step = snh.run_repeat(R, T, plan, plan_s, row, device,
                                   jax=snh.jax_rows())
    rec["row"] = snh.HEADLINE_ROW
    del R, T
    _count(rec["launches"], paths)
    off = abs(rec["iter_s"] - head["s_iter"]) / head["s_iter"]
    misses = snh.rmse_misses([rec])
    print(f"[flagship] row {snh.HEADLINE_ROW}: {rec['iter_s']:.4f} s/iter "
          f"(pairs {rec['iter_s_pair_samples']}), phase 4's "
          f"{head['s_iter']:.4f}: {100 * off:.2f}% apart; RMSE "
          f"{rec['rmse_after_iters']:.6f} (JAX row "
          f"{rec['rmse_after_iters_jax']}); launches {rec['launches']}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if off > BENCH_S_ITER_TOL or misses:
        raise AssertionError(f"flagship row: {100 * off:.2f}% off phase 4 "
                             f"(bar {100 * BENCH_S_ITER_TOL:.0f}%); {misses}")

    t0 = time.perf_counter()
    lc.reset_launch_counts()
    var = hv.probe(lambda: step(st), device, **VARIANCE_SMOKE)
    got = lc.launch_counts()
    _count(got, paths)
    del st, step
    torch.cuda.empty_cache()
    n_it = (VARIANCE_SMOKE["n_a"] + VARIANCE_SMOKE["b_groups"] * hv.B_SIZE
            + VARIANCE_SMOKE["n_c"])
    want = want_launches(row[0], n_it, 1, len(plan.panels))
    if got != want:
        raise AssertionError(f"variance probe launches {got}, want {want}")
    print(f"[variance] A {var['per_iter_fenced_samples']}, events "
          f"{var['per_iter_event_samples']}, B {var['pooled_3x_samples']}, "
          f"C {var['late_per_iter_fenced_samples']}, idle fence "
          f"{var['sync_idle_samples']}; spreads {var['spread']}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    gold = bench_als.golden_run(dev=device)
    for prec in bench_als.GOLDEN_PRECISIONS:
        _count(gold[prec]["launches"], paths)
    misses = bench_als.golden_misses(gold)
    print(f"[bench_als] ml1m golden RMSE {gold['golden_rmse']:.6f}; " +
          "; ".join(f"{prec}: rmse {gold[prec]['rmse']:.6f}, W "
                    f"{gold[prec]['W'].message()} H "
                    f"{gold[prec]['H'].message()}"
                    for prec in bench_als.GOLDEN_PRECISIONS)
          + f"; {time.perf_counter() - t0:.1f} s", flush=True)
    if misses:
        raise AssertionError(f"bench_als golden: {misses}")

    lines = [sm.model(n, sm.Terms(s_iter=head["s_iter"]))
             for n in (1, 2, 4, 8)]
    if lines[0]["iter_s"] != head["s_iter"]:
        raise AssertionError(f"scaling model N = 1: {lines[0]}")
    for line in lines:
        print("[scaling] " + json.dumps(line), flush=True)
    return {"launches": paths, "sweep": recs, "flagship": rec,
            "variance": var, "scaling": lines,
            "bench_als": {prec: {"rmse": gold[prec]["rmse"],
                                 "W_err_pct": gold[prec]["W"]
                                 .error_percentage,
                                 "H_err_pct": gold[prec]["H"]
                                 .error_percentage}
                          for prec in bench_als.GOLDEN_PRECISIONS}}


def _fp8_abs(X: torch.Tensor) -> torch.Tensor:
    """|X| of an fp8 tensor (its sign bit cleared: exact, NaN stays NaN),
    one byte a cell."""
    return (X.view(torch.uint8) & 0x7F).view(FP8)


def _fp8_panel(M, W, device, seed, mask_dtype=None):
    """random_panel (NaN sentinel) or, with ``mask_dtype``, random_masked
    at bf16, rounded to fp8 (round_to_storage, in row blocks)."""
    from cuda_recommender_tpu_torch.scripts.sweep_timing import as_residual

    if mask_dtype is None:
        R, vecs = random_panel(M, W, torch.bfloat16, device, seed)
        return as_residual(R, FP8), None, vecs
    R, Mk, vecs = random_masked(M, W, torch.bfloat16, mask_dtype, device,
                                seed)
    return as_residual(R, FP8), Mk, vecs


def _fp8_cases(R, Mk, vecs) -> list:
    """(instance name, kernel, plain version, sum(|terms|) of g, panel) of
    every fp8 instance on one panel: K1 (both orders), K3, K2 on a NaN
    panel (``Mk`` None), else K4 (both orders), masked_vsweep,
    masked_usweep beside the mask."""
    from cuda_recommender_tpu_torch.ops import ccd_kernels as ck
    from cuda_recommender_tpu_torch.ops import panel_kernels as pk

    a, b, c, d = vecs
    cases = []
    if Mk is None:
        for order in ORDERS:
            cases.append((
                pk.instance_name("panel_update_vsweep", FP8, order),
                lambda X, o=order: pk.panel_update_vsweep(X, a, b, c, d,
                                                          order=o),
                lambda X, o=order: pk.panel_update_vsweep_plain(
                    X, a, b, c, d, order=o),
                lambda X: pk.panel_vsweep_plain(_fp8_abs(X), a.abs())[0], R))
        return cases + [
            ("panel_vsweep_fp8", lambda X: pk.panel_vsweep(X, b),
             lambda X: pk.panel_vsweep_plain(X, b),
             lambda X: pk.panel_vsweep_plain(_fp8_abs(X), b.abs())[0], R),
            ("panel_usweep_fp8", lambda X: pk.panel_usweep(X, c),
             lambda X: pk.panel_usweep_plain(X, c),
             lambda X: pk.panel_usweep_plain(_fp8_abs(X), c.abs())[0], R)]
    for order in ORDERS:
        cases.append((
            pk.instance_name("fused_update_vsweep", FP8, order),
            lambda X, o=order: ck.fused_update_vsweep(X, Mk, a, b, c, d,
                                                      order=o),
            lambda X, o=order: ck.fused_update_vsweep_plain(
                X, Mk, a, b, c, d, order=o),
            lambda X: ck.masked_vsweep_plain(_fp8_abs(X), Mk, a.abs())[0],
            R))
    return cases + [
        ("masked_vsweep_fp8", lambda X: ck.masked_vsweep(X, Mk, b),
         lambda X: ck.masked_vsweep_plain(X, Mk, b),
         lambda X: ck.masked_vsweep_plain(_fp8_abs(X), Mk, b.abs())[0], R),
        ("masked_usweep_fp8", lambda X: ck.masked_usweep(X, Mk, c),
         lambda X: ck.masked_usweep_plain(X, Mk, c),
         lambda X: ck.masked_usweep_plain(_fp8_abs(X), Mk, c.abs())[0], R)]


def check_fp8_overflow(device) -> None:
    """A planted update whose sum passes 464 must store NaN, as JAX's
    astype does (PyTorch's cast would saturate at 448): K1 and K4 in both
    orders, bf16 and int8 masks, against their plain versions. Row 0's
    first cells hold 1.0 and take a delta of 448, 463, 465 and 800
    (stored 448, 448, NaN, NaN in either order: 464 ties to 448)."""
    from cuda_recommender_tpu_torch.ops.densify import FP8_NAN_BITS

    planted = torch.tensor([448.0, 463.0, 465.0, 800.0], device=device)
    for mdt in (None, torch.bfloat16, torch.int8):
        R, Mk, (uo, up, vo, vp) = _fp8_panel(50, 70, device, 5, mdt)
        n = planted.numel()
        _bits(R)[0, :n] = 0x38                      # 1.0
        if Mk is not None:
            Mk[0, :n] = 1
        uo[0], up[0] = 32.0, 0.0
        vo[:n] = planted / 32.0
        for name, kern, plain, _, X in _fp8_cases(R, Mk,
                                                  (uo, up, vo, vp))[:2]:
            Rk, Rp = X.clone(), X.clone()
            kern(Rk)
            plain(Rp)
            _sync(device)
            got = _bits(Rk)[0, :n].tolist()
            if not torch.equal(_bits(Rk), _bits(Rp)) or \
                    got[:2] != [0x7E, 0x7E] or \
                    [x & 0x7F for x in got[2:]] != [FP8_NAN_BITS] * 2:
                raise AssertionError(f"{name} {mdt}: planted sums stored "
                                     f"{[hex(x) for x in got]} (want 448, "
                                     "448, NaN, NaN), kernel and plain "
                                     "equal: "
                                     f"{torch.equal(_bits(Rk), _bits(Rp))}")
    print("[check] fp8 overflow: 1 + 448, 463 store 448; 1 + 465, 800 "
          "store NaN (K1, K4 in both orders, NaN / bf16 / int8 masks), "
          "bit-equal to the plain versions", flush=True)


def check_fp8_grid(device, worst) -> int:
    """The fp8 stores (K1 and K4 in both orders) x NaN / bf16 / int8 masks
    against their plain versions on the boundary grid (scripts/fp8_grid.py:
    every e4m3 byte against deltas on every rounding boundary) at
    FP8_GRID_WIDTHS, each panel also as a view one element into a guarded
    buffer (_hold: stored residual bit-equal, repeats bit-identical; g and
    h hold NaN and ±inf where the plain version does). The sweeps without
    a store are held on phase 3's panels: the grid's deltas, NaN and ±inf
    among them, are no factor vector for them. Updates ``worst``; returns
    the panels run."""
    from cuda_recommender_tpu_torch.scripts import fp8_grid

    n = len(fp8_grid.deltas())
    widths = [n if w is None else w for w in FP8_GRID_WIDTHS]
    ratios = []
    for W in widths:
        for mdt in (None, torch.bfloat16, torch.int8):
            R, Mk, vecs = fp8_grid.grid(W, device, mdt)
            for name, kern, plain, scale, X in _fp8_cases(R, Mk,
                                                          vecs)[:2]:
                for offset in (None, VIEW_OFFSET):
                    what = (f"{name} grid {X.shape[0]}x{W} "
                            f"{'NaN' if mdt is None else str(mdt)[6:]}"
                            + (f" view +{offset}" if offset else ""))
                    worst[name] = max(worst[name], _hold(
                        what, kern, plain, scale, X, offset, ratios,
                        nonfinite=True))
    print(f"[check] fp8 boundary grid: every e4m3 byte x {n} deltas "
          f"(ties, 448-480, ±0, ±inf, NaN) at widths {widths} x NaN / bf16"
          " / int8 masks x K1, K4 in both orders, views 1 element into "
          "guarded buffers: residual bit-equal, repeatable", flush=True)
    return 3 * len(widths)


def check_fp8(device) -> dict:
    """Phase 42: every fp8 instance (K1 and K4 in both store orders, K3,
    K2, the masked sweeps) x NaN / bf16 / int8 masks against its plain
    version (_hold: stored residual bit-equal, g and h within RTOL of
    sum(|terms|), repeat runs bit-identical, the row sweeps' on the same
    view): at phase 3's shapes and row
    alignments (each small panel also as a view one element into a
    guarded buffer), and K1-K3 at the headline's panel 0; then the
    planted overflow (check_fp8_overflow) and the boundary grid
    (check_fp8_grid). Returns each instance's largest |g, h error|."""
    t0 = time.perf_counter()
    worst, ratios = {name: 0.0 for name in FP8_KERNELS}, []
    shapes = (list(CHECK_SHAPES) + [(ALIGN_ROWS, w) for w in ALIGN_WIDTHS]
              + list(ALIGN_EXTRA))
    runs = [(M, W, mdt) for M, W in shapes
            for mdt in (None, torch.bfloat16, torch.int8)]
    runs.append((*FP8_PANEL0, None))
    for M, W, mdt in runs:
        R, Mk, vecs = _fp8_panel(M, W, device, M * W + 2, mdt)
        offsets = (None,) if M * W > 1 << 24 else (None, VIEW_OFFSET)
        for name, kern, plain, scale, X in _fp8_cases(R, Mk, vecs):
            for offset in offsets:
                what = (f"{name} {M}x{W} "
                        f"{'NaN' if mdt is None else str(mdt)[6:]}"
                        + (f" view +{offset}" if offset else ""))
                worst[name] = max(worst[name], _hold(
                    what, kern, plain, scale, X, offset, ratios,
                    same_view="usweep" in name))
        del R, Mk, vecs
        if M * W > 1 << 24:
            torch.cuda.empty_cache()
            print(f"[check] fp8 {M}x{W} {mdt}: bit-equal, repeatable "
                  f"[{time.perf_counter() - t0:.1f} s]", flush=True)
    check_fp8_overflow(device)
    grid_panels = check_fp8_grid(device, worst)
    print(f"[check] fp8: {len(runs) + grid_panels} panels (phase 3's shapes "
          f"and alignments x NaN / bf16 / int8 masks, panel 0 {FP8_PANEL0}, "
          f"the boundary grid) x "
          f"every instance, views {VIEW_OFFSET} element into guarded "
          f"buffers: residual bit-equal, guard cells untouched, repeatable;"
          f" largest error / sum|terms| {max(ratios):.2e} (bar {RTOL}); "
          f"max|dg|,|dh| { {k: float(f'{v:.3e}') for k, v in worst.items()} }"
          f" [{time.perf_counter() - t0:.1f} s]", flush=True)
    return worst


def time_fp8() -> dict:
    """Phase 42's timing of the fp8 instances: scripts/sweep_timing.py's
    time_fp8 (K1-K3 at panel 0, K4 and the masked sweeps at the ml10M
    shape beside a bf16 and an int8 mask; the calls, their bytes and
    flops), 5 calls a turn. Returns {mask: name -> (ms, plain_ms,
    bound_ms, bound_by)}, mask "nan" for K1-K3."""
    from cuda_recommender_tpu_torch.scripts import sweep_timing as st

    out = {mask: _bounded(recs) for mask, recs in
           st.time_fp8(torch.device("cuda"), reps=5).items()}
    torch.cuda.empty_cache()
    return out


def _fp8_want(names, per) -> dict:
    """Launch counts of a run that launches each of ``names`` ``per`` (a
    count each) times and nothing else."""
    from cuda_recommender_tpu_torch.ops.launches import launch_counts
    want = {name: 0 for name in launch_counts()}
    want.update(zip(names, per))
    return want


def _fp8_run(what, device, R, T, cfg, want_fn, ref_rmse) -> dict:
    """train() ``cfg`` on (R, T) with the launch counts set to 0 just
    before and read just after (``want_fn(P)`` the counts for P panels, P
    = 1 without a plan); the RMSE finite, falling after iteration 1 and
    (unless ``ref_rmse`` is None) within FP8_RMSE_GAP of ``ref_rmse`` an
    iteration. Returns the launches, s/iter, peak device memory, RMSE,
    plan and factors."""
    from cuda_recommender_tpu_torch import train
    from cuda_recommender_tpu_torch.core.metrics_log import MetricsLog
    from cuda_recommender_tpu_torch.ops import launches as lc

    with tempfile.TemporaryDirectory() as tmp:
        mf = os.path.join(tmp, "m.jsonl")
        log = MetricsLog(mf)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        lc.reset_launch_counts()
        try:
            res = train(cfg, R, T, device=device, log=log)
        finally:
            log.close()
        launches = lc.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        plans = _events(mf, "hybrid_plan")
    rmse = [st.rmse for st in res.stats]
    s_iter = _steady(res.stats)
    P = len(plans[0]["panels"]) if plans else 1
    print(f"[{what}] {res.backend}: RMSE {rmse} (reference {ref_rmse}); "
          f"s/iter {[st.rank_time for st in res.stats]}, steady "
          f"{s_iter:.4f}; peak device memory {peak / 2**30:.2f} GiB; "
          f"{P} panel(s); launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    _check_rmse(what, rmse, cfg.maxiter)
    gap = max(abs(a - b) for a, b in zip(rmse, ref_rmse or rmse))
    if gap > FP8_RMSE_GAP:
        raise AssertionError(f"{what}: RMSE {rmse} off {ref_rmse} by {gap}")
    want = want_fn(P)
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, want {want}")
    out = dict(launches=launches, s_iter=s_iter, peak=peak, rmse=rmse,
               plan=plans[0] if plans else None, W=res.W, H=res.H)
    del res
    torch.cuda.empty_cache()
    return out


def run_fp8_hybrid(device, data, head) -> dict:
    """Phase 43: the headline (Netflix-100M dims, k = 40, hand stair under
    6.5e9 cells) at an fp8 residual, FP8_ITERS iterations through train(),
    twice: int8 masks (K4 and masked_usweep, delta-first as the JAX einsum
    path stores) and NaN panels with the panel kernels (K1 once, K2). Each
    beside phase 4's bf16 run."""
    from cuda_recommender_tpu_torch import Config

    R, T = data
    h = HEADLINE
    base = dict(k=h["k"], lambda_=h["lam"], maxiter=FP8_ITERS,
                backend="hybrid", residual_dtype="float8_e4m3fn",
                hybrid_dense_cells=h["budget"],
                hybrid_panel_widths=h["widths"])
    per = h["k"] * FP8_ITERS
    runs = {
        "int8": _fp8_run(
            "fp8 hybrid int8 masks", device, R, T,
            Config(mask_dtype="int8", **base),
            lambda P: _fp8_want(("fused_update_vsweep_fp8_delta_first",
                                 "masked_usweep_fp8"), (per * P,) * 2),
            head["rmse"][:FP8_ITERS]),
        "nan_kernel": _fp8_run(
            "fp8 hybrid NaN panels", device, R, T,
            Config(mask_dtype="nan", hybrid_panel_kernel=True, **base),
            lambda P: _fp8_want(("panel_update_vsweep_fp8",
                                 "panel_usweep_fp8"), (per * P,) * 2),
            head["rmse"][:FP8_ITERS])}
    for rec in runs.values():
        rec.pop("W")
        rec.pop("H")
    print("[fp8] headline " + json.dumps({
        "bf16_nan_kernel": {"s_iter": head["s_iter"], "peak": head["peak"],
                            "rmse": head["rmse"][:FP8_ITERS]},
        **{f"fp8_{key}": {k: rec[k] for k in ("s_iter", "peak", "rmse")}
           for key, rec in runs.items()}}), flush=True)
    return runs


def run_fp8_dense(device, dense) -> dict:
    """Phase 44: the JAX README's quick start (ml10M dims, k = 10; AUTO ->
    dense, bf16 mask) at an fp8 residual (K4 delta-first, masked_usweep),
    the pallas backend at fp8 and -T 2 (K4 once, masked_vsweep,
    masked_usweep), and the NaN-panel hybrid without the panel kernel at
    fp8, -T 2 (K1 delta-first, K3, K2; phase 29's stair under 3e8 cells),
    FP8_ITERS iterations each, on phase 12's cached data: the quick start's
    RMSE within FP8_RMSE_GAP of phase 12's f32 run's, the two -T 2 runs'
    of each other's."""
    from cuda_recommender_tpu_torch import Config
    from cuda_recommender_tpu_torch.data.datasets import synthetic_cached

    d = DENSE_HEADLINE
    R, T = synthetic_cached(d["m"], d["n"], d["nnz"], seed=1)
    ref = dense["rmse"][:FP8_ITERS]
    k, it = d["k"], FP8_ITERS
    fp8 = dict(k=k, lambda_=d["lam"], maxiter=it,
               residual_dtype="float8_e4m3fn")
    runs = {
        "dense": _fp8_run(
            "fp8 dense quick start", device, R, T, Config(**fp8),
            lambda P: _fp8_want(("fused_update_vsweep_fp8_delta_first",
                                 "masked_usweep_fp8"), (k * it,) * 2), ref),
        "pallas": _fp8_run(
            "fp8 pallas -T 2", device, R, T,
            Config(backend="pallas", maxinneriter=2, **fp8),
            lambda P: _fp8_want(("fused_update_vsweep_fp8",
                                 "masked_vsweep_fp8", "masked_usweep_fp8"),
                                (k * it, k * it, 2 * k * it)), None),
        "hybrid_nan": _fp8_run(
            "fp8 NaN-panel hybrid -T 2", device, R, T,
            Config(backend="hybrid", mask_dtype="nan", maxinneriter=2,
                   hybrid_dense_cells=RESUME_HYBRID["hybrid_dense_cells"],
                   hybrid_panel_widths=HEADLINE["widths"], **fp8),
            lambda P: _fp8_want(("panel_update_vsweep_fp8_delta_first",
                                 "panel_vsweep_fp8", "panel_usweep_fp8"),
                                (k * it * P, k * it * P, 2 * k * it * P)),
            None)}
    a, b = runs["pallas"]["rmse"], runs["hybrid_nan"]["rmse"]
    if max(abs(x - y) for x, y in zip(a, b)) > FP8_RMSE_GAP:
        raise AssertionError(f"fp8 -T 2: pallas RMSE {a}, NaN-panel hybrid "
                             f"{b}")
    for rec in runs.values():
        rec.pop("W")
        rec.pop("H")
    del R, T
    return runs


def run_defer_group(device, data, head) -> dict:
    """Phase 45: the headline's stair and dims (NaN panels, K1, K2) with
    the rank-deferred ELL tail (hybrid_defer_group = DEFER_G, plain torch).
    At an f32 residual (the JAX package's test of it,
    tests/test_hybrid.py:345-365, runs f32 panels), FP8_ITERS iterations
    undeferred and deferred: W and H within DEFER_TOL, the RMSE within
    DEFER_RMSE_TOL an iteration. At the headline's bf16 residual the two
    tails' f32 sums, a few ULPs apart, tip some bf16 panel roundings the
    other way, which the rank recursion carries into the weakly
    determined factors: that run (HEADLINE's iterations, beside phase 4)
    holds the RMSE to DEFER_RMSE_TOL and the share of W's and of H's
    entries beyond DEFER_TOL to DEFER_BEYOND_MAX. K1 and K2 launch as
    often in every run."""
    from cuda_recommender_tpu_torch import Config

    R, T = data
    h = HEADLINE
    cfg = dict(k=h["k"], lambda_=h["lam"], backend="hybrid",
               mask_dtype="nan", hybrid_panel_kernel=True,
               hybrid_dense_cells=h["budget"],
               hybrid_panel_widths=h["widths"])

    def want(iters):
        return lambda P: _fp8_want(("panel_update_vsweep", "panel_usweep"),
                                   (h["k"] * iters * P,) * 2)

    f32 = dict(cfg, residual_dtype="float32", maxiter=FP8_ITERS)
    ref = head["rmse"][:FP8_ITERS]
    g0 = _fp8_run("headline f32 G=0", device, R, T, Config(**f32),
                  want(FP8_ITERS), ref)
    gd = _fp8_run(f"headline f32 G={DEFER_G}", device, R, T,
                  Config(hybrid_defer_group=DEFER_G, **f32),
                  want(FP8_ITERS), ref)
    for name in "WH":
        np.testing.assert_allclose(gd[name], g0[name], err_msg=name,
                                   **DEFER_TOL)
    off = {name: float(np.abs(gd[name] - g0[name]).max()) for name in "WH"}
    gap = max(abs(a - b) for a, b in zip(gd["rmse"], g0["rmse"]))
    if gap > DEFER_RMSE_TOL:
        raise AssertionError(f"G={DEFER_G}: RMSE {gd['rmse']} against "
                             f"{g0['rmse']}")
    print(f"[defer] f32, G={DEFER_G} against G=0: W, H within {DEFER_TOL} "
          f"(max|diff| {off}), RMSE within {gap:.2e}; s/iter "
          f"{gd['s_iter']:.4f} against {g0['s_iter']:.4f}", flush=True)
    bf = _fp8_run(f"headline bf16 G={DEFER_G}", device, R, T,
                  Config(hybrid_defer_group=DEFER_G, residual_dtype=
                         "bfloat16", maxiter=h["iters"], **cfg),
                  want(h["iters"]), head["rmse"])
    gap_bf = max(abs(a - b) for a, b in zip(bf["rmse"], head["rmse"]))
    if gap_bf > DEFER_RMSE_TOL:
        raise AssertionError(f"bf16 G={DEFER_G}: RMSE {bf['rmse']} against "
                             f"phase 4's {head['rmse']}")
    beyond = {name: float((~np.isclose(bf[name], head[name], **DEFER_TOL))
                          .mean()) for name in "WH"}
    if max(beyond.values()) > DEFER_BEYOND_MAX:
        raise AssertionError(f"bf16 G={DEFER_G}: shares of W, H entries "
                             f"beyond {DEFER_TOL} of phase 4's: {beyond} "
                             f"(bar {DEFER_BEYOND_MAX})")
    print(f"[defer] bf16, G={DEFER_G} against phase 4: RMSE within "
          f"{gap_bf:.2e}; W, H entries beyond {DEFER_TOL}: {beyond} (bar "
          f"{DEFER_BEYOND_MAX}); s/iter "
          f"{bf['s_iter']:.4f} against {head['s_iter']:.4f}; peak "
          f"{bf['peak'] / 2**30:.2f} GiB", flush=True)
    launches = dict(g0["launches"])
    _count(gd["launches"], launches)
    _count(bf["launches"], launches)
    return dict(launches=launches, s_iter=bf["s_iter"], peak=bf["peak"],
                s_iter_f32=gd["s_iter"], s_iter_f32_g0=g0["s_iter"],
                max_diff_f32=off, rmse_gap_f32=gap, rmse_gap_bf16=gap_bf,
                beyond_bf16=beyond)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from cuda_recommender_tpu_torch import native
    from cuda_recommender_tpu_torch.core.device import resolve_device
    from cuda_recommender_tpu_torch.ops import build

    t_all = time.perf_counter()
    native.reset_path_counts()
    phase("1 environment")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, devices {torch.cuda.device_count()}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    print(nvcc.strip().splitlines()[-1], flush=True)
    dev = resolve_device("cuda")

    phase("2 build (one nvcc per source, in parallel)")
    t0 = time.perf_counter()
    built = build.build()
    for name in built:
        build.load(name)
    print(f"[build] {[os.path.relpath(so, HERE) for so, _ in built.values()]}"
          f" in {time.perf_counter() - t0:.1f} s", flush=True)
    for _, log in built.values():
        for line in log.splitlines():
            if re.search(r"Compiling entry|registers|spill", line):
                print("[ptxas] " + line.strip(), flush=True)
    t0 = time.perf_counter()
    so = native.build_library()
    if not native.available():
        raise AssertionError("the native host helpers do not load")
    print(f"[build] native host helpers {os.path.relpath(so, HERE)} (g++ "
          f"{' '.join(native.FLAGS)}) in {time.perf_counter() - t0:.1f} s",
          flush=True)

    phase("3 kernel checks (the row sweep at every case of its plan, the "
          "column sweeps at every row alignment, K5, the ALS gram kernel)")
    worst = check_kernels(dev, CHECK_SHAPES)
    check_row_sweeps(dev, (torch.float32, torch.bfloat16), (None,), worst)
    align = check_alignment(dev)
    for name in worst:
        worst[name] = max(worst[name], align.get(name, 0.0))
    gj_worst = check_gj()
    als_gram_worst = check_als_gram(dev)

    phase("4 headline run (train(), Netflix-100M dims, k=40, bf16, NaN "
          "sentinel, hand stair (4096, 2048), 6.5e9 cells)")
    with tempfile.TemporaryDirectory() as tmp:
        head = run_headline(dev, metrics_file=os.path.join(
            tmp, "headline.jsonl"), **HEADLINE)

    netflix = head["data"]           # phases 43 and 45 train on it again
    phase("5 kernel checks at the headline's panel shapes and the "
          "transposed stair's panel 0 (odd width)")
    torch.cuda.empty_cache()
    shapes = [(r1 - r0, w) for r0, r1, w in head["panels"]]
    worst = check_kernels(dev, shapes + [ODD_PANEL], (torch.bfloat16,),
                          worst)

    phase("6 kernel timing at the headline's panel-0 shape")
    times = time_kernels(*shapes[0])
    print(f"[timing] card: {smi}", flush=True)

    phase("7 CLI with golden check (-T 2)")
    run_cli()

    phase("8 ALS headline run (train(), ml20M dims, k=40, 5 iterations, "
          "K5)")
    with tempfile.TemporaryDirectory() as tmp:
        als = run_als_headline(dev, metrics_file=os.path.join(
            tmp, "als.jsonl"), **ALS_HEADLINE)

    phase("9 K5 timing at the ALS headline's rows side (S=138,493; k=10, "
          "40, 128), against its plain version and torch.linalg.solve; the "
          "ALS gram kernel over an iteration, against its plain version")
    gj_times = {k: time_gj(k) for k in GJ_TIMED_KS}
    gram_times = time_als_gram()
    print(f"[timing] card: {smi}", flush=True)

    phase("10 ALS CLI with golden check")
    run_als_cli()

    phase("11 K4 and masked sweep checks (f32, bf16 residual x bf16, int8 "
          "mask)")
    masked_worst = check_masked_kernels(dev, MASKED_CHECK_SHAPES)
    check_row_sweeps(dev, (torch.float32, torch.bfloat16),
                     (torch.bfloat16, torch.int8), masked_worst)
    for name in masked_worst:
        masked_worst[name] = max(masked_worst[name], align.get(name, 0.0))

    phase("12 dense headline (train(), the README quick start: ml10M dims, "
          "k=10, AUTO -> dense, golden)")
    with tempfile.TemporaryDirectory() as tmp:
        dense = run_dense_headline(dev, metrics_file=os.path.join(
            tmp, "dense.jsonl"), **DENSE_HEADLINE)
    ml10m = {key: DENSE_HEADLINE[key] for key in ("m", "n", "nnz")}
    k10 = {key: DENSE_HEADLINE[key] for key in ("k", "lam")}
    profile_dense_iteration(dev, **ml10m, **k10)

    phase("13 pallas backend against dense (2 iterations, bit-equal W, H)")
    run_pallas_vs_dense(dev, **ml10m, **k10)

    phase("14 dense k=40, bf16 residual (README.md:91)")
    with tempfile.TemporaryDirectory() as tmp:
        run_dense_k40(dev, lam=k10["lam"], metrics_file=os.path.join(
            tmp, "k40.jsonl"), **ml10m, **DENSE_K40)

    phase("15 K4 and masked sweep timing at the ml10M shape")
    masked_times = time_masked_kernels(DENSE_HEADLINE["m"],
                                       DENSE_HEADLINE["n"])
    print(f"[timing] card: {smi}", flush=True)

    phase("16 explicit-mask hybrid (Netflix-100M dims, JAX Config "
          "defaults: auto stair, 2e9 cells, f32 residual, bf16 mask, k=40), "
          "then the masked kernel checks at its panel shapes")
    with tempfile.TemporaryDirectory() as tmp:
        mask_hybrid = run_mask_hybrid(
            dev, head["data"], metrics_file=os.path.join(tmp, "mh.jsonl"),
            **MASK_HYBRID)
    # K4 and the masked sweeps at every panel shape that run gave them (f32
    # residual, bf16 mask): the full-width panel 0 down to the narrowest
    masked_worst = check_masked_kernels(
        dev, [(r1 - r0, w) for r0, r1, w in mask_hybrid["panels"]],
        masked_worst, dtypes=(torch.float32,), mask_dtypes=(torch.bfloat16,))

    phase("17 README CLI with golden check (no backend flag: dense)")
    run_dense_cli()

    phase("18 probe kernel checks (stream_rmw, stream_read, the rounding "
          "variant, gather) at small and the scripts' shapes")
    probe_worst = check_probe_kernels(dev)
    probe_worst["panel_update_vsweep_irne"] = max(
        probe_worst["panel_update_vsweep_irne"],
        align["panel_update_vsweep_irne"])

    phase("19 the port's bench at the headline, then the probe kernels "
          "timed at its shapes")
    bench = run_bench(["--iters", BENCH_ITERS["iters"], "--warmup",
                       BENCH_ITERS["warmup"]])
    bd = bench["detail"]
    off = abs(bd["outer_iter_s"] - head["s_iter"]) / head["s_iter"]
    print(f"[bench] median {bd['outer_iter_s']:.4f} s/iter against phase "
          f"4's {head['s_iter']:.4f}: {100 * off:.2f}% apart (bar "
          f"{100 * BENCH_S_ITER_TOL:.0f}%)", flush=True)
    if off > BENCH_S_ITER_TOL:
        raise AssertionError("the bench's s/iter is off phase 4's")
    r0, r1, w = bd["panels"][0]
    probe_times = time_probe_kernels((r1 - r0, w), PROBE_SCRIPT_SHAPES[2],
                                     bd["tail"])
    print(f"[timing] card: {smi}", flush=True)

    phase("20 the bench with the auto stair, the auto orientation and the "
          "transposed stair (in this process, on phase 4's data)")
    ab = ["--iters", BENCH_AB_ITERS["iters"], "--warmup",
          BENCH_AB_ITERS["warmup"]]
    for extra in BENCH_AB:
        rec = run_bench(ab + extra, data=head["data"])
        want_t = extra == ["--transpose", "1"]
        if rec["detail"]["orientation"].startswith("transposed") != want_t:
            raise AssertionError(f"bench {extra}: orientation "
                                 f"{rec['detail']['orientation']}")

    phase("21 the variant matrix and the gather probe scripts")
    out = run_script(["cuda_recommender_tpu_torch.scripts."
                      "panel_kernel_variants"])
    variants = json.loads(out.strip().splitlines()[-1])
    if variants["A1_vs_A0"]["bit_mismatches"] != 0:
        raise AssertionError(f"A1 vs A0: {variants['A1_vs_A0']}")
    tails = [f"{t['lanes']}:{t['table_rows']}:{t['width']}"
             for t in bd["tail"].values() if t["lanes"]]
    run_script(["cuda_recommender_tpu_torch.scripts.probe_gather",
                *[a for t in tails for a in ("--tail", t)]])

    phase("22 a small cli/bench.py grid (k 10, 40 x ccd, als)")
    out = run_script(["cuda_recommender_tpu_torch.cli.bench", "--ks",
                      "10,40", "--solvers", "ccd,als"])
    recs = [json.loads(x) for x in out.strip().splitlines()]
    if len(recs) != 4 or not all(
            math.isfinite(r["final_rmse"]) and r["device"] == "cuda"
            for r in recs):
        raise AssertionError(f"cli/bench records {recs}")

    phase("23 serving the trained headline factors (17,770 items, k=40): "
          "the model file, batch top-10 f32 and int8 against the brute "
          "force, recall@10, the engine's sequential queries")
    t0 = time.perf_counter()
    serve = run_serving(dev, head["W"], head["H"], head.pop("recall"))
    print(f"[serve] phase 23: {time.perf_counter() - t0:.1f} s; card: {smi}",
          flush=True)

    phase("24 serving a 1M-item catalog (the trained table tiled 57x with "
          "jitter): f32 and int8 against the brute force")
    t0 = time.perf_counter()
    serve_1m = run_catalog_1m(dev, *serve.pop("factors"))
    print(f"[serve] phase 24: {time.perf_counter() - t0:.1f} s; card: {smi}",
          flush=True)

    phase("25 cli/bench_serve.py: the default (ALS training with K5, then "
          "batch QPS and recall@10) and --latency")
    t0 = time.perf_counter()
    bs_rec = [run_bench_serve(), run_bench_serve(["--latency"])]
    print(f"[bench_serve] phase 25: {time.perf_counter() - t0:.1f} s",
          flush=True)

    phase("26 the file and serving CLIs at ml1m dims: convert, train -ALS "
          "<dir> --save-model, predict score and topk, train <dir> -p 1")
    t0 = time.perf_counter()
    run_serving_cli(dev)
    print(f"[cli] phase 26: {time.perf_counter() - t0:.1f} s", flush=True)
    print("[serve] summary " + json.dumps({
        "catalog_17770": {name: {key: serve[name][key] for key in (
            "qps", "batch_ms", "recall", "p50_ms", "p99_ms")}
            for name in ("f32", "int8")},
        "peak_bytes": serve["peak"],
        "catalog_1m": {name: serve_1m[name]["qps"] for name in serve_1m},
        "bench_serve": {"qps": bs_rec[0]["value"],
                        "recall": bs_rec[0]["detail"]["recall_at_k"],
                        "p50_ms": bs_rec[1]["value"],
                        "p99_ms": bs_rec[1]["detail"]["p99_ms"]},
        "card": smi}), flush=True)

    from cuda_recommender_tpu_torch.data.datasets import synthetic_cached
    # each path's launches (counts set to 0 just before it, read just
    # after): the kernels line reports their sums
    paths = {}
    _count(head["launches"], paths)
    _count(als["launches"], paths)
    _count(dense["launches"], paths)

    phase("27 ALS headline checkpoint/resume (ml20M dims, k=40, gj: 4 "
          "iterations straight against 2 + checkpoint + resume to 4, "
          "bit-equal)")
    R, T = synthetic_cached(ALS_HEADLINE["m"], ALS_HEADLINE["n"],
                            ALS_HEADLINE["nnz"], seed=1, test_fraction=0.02)
    als_ck = run_resume(
        "ALS ml20M k=40", dev, R, T,
        dict(solver="als", k=ALS_HEADLINE["k"], lambda_=ALS_HEADLINE["lam"],
             als_solver="gj", als_precision="highest"),
        iters=RESUME_ITERS[0], split=RESUME_ITERS[1],
        want_kernels=("gj_solve",))
    _count(als_ck["launches"], paths)
    del R, T

    phase("28 dense quick start checkpoint/resume (ml10M dims, k=10, K4 "
          "and the masked sweeps, bit-equal)")
    R, T = synthetic_cached(**ml10m, seed=1)
    dense_ck = run_resume(
        "dense ml10M k=10", dev, R, T, dict(k=k10["k"], lambda_=k10["lam"]),
        iters=RESUME_ITERS[0], split=RESUME_ITERS[1],
        want_kernels=("fused_update_vsweep", "masked_usweep"))
    _count(dense_ck["launches"], paths)

    phase("29 hybrid checkpoint/resume (ml10M dims, k=40, bf16 NaN panels, "
          "panel kernels, 3e8 cells: K1, K2; bit-equal; JAX's padded panel "
          "shapes)")
    hyb_ck = run_hybrid_resume(dev, R, T)
    _count(hyb_ck["launches"], paths)
    del R, T

    phase("30 phase timing at the Netflix-100M headline (2 iterations: K3, "
          "K2; rank/update split)")
    phased = run_phase_headline(dev, *head["data"], head)
    _count(phased["launches"], paths)

    phase("31 phase timing through the CLI (--phase-timing -q 1, the dense "
          "quick start at ml10M dims)")
    phase_cli = run_phase_cli()
    _count(phase_cli["launches"], paths)

    phase("32 pure ELL through the CLI (--backend ell, ml10M dims, k=10) "
          "against phase 12's golden run, then 2 + 1 iterations resumed, "
          "bit-equal")
    ell = run_ell(dev, dense.pop("ref"))

    from cuda_recommender_tpu_torch.parallel import multihost
    phase("33 the sharded hybrid at the headline over one rank (NCCL, "
          "train(mesh=...)): K1, K2, 2·k·T all-reduces an iteration, "
          "bit-equal to phase 4")
    multihost.initialize_local("cuda")
    try:
        sh_head = run_sharded_headline(dev, *head.pop("data"), head)
        _count(sh_head["launches"], paths)

        phase("34 sharded ALS (ml20M, K5), dense (ml10M, 1-D mesh: K4, the "
              "masked sweeps), ELL (ml10M) and top-10 over one rank, each "
              "bit-equal to its single-device run")
        sh_rest = run_sharded_backends(dev, head, als_ck, dense_ck, ell)
        _count(sh_rest["launches"], paths)
    finally:
        multihost.shutdown()

    phase("35 two ranks on the one card (gloo): the ml10M hybrid through "
          "cli.train --mesh 2, against phase 29's single-device run")
    two = run_two_ranks(hyb_ck)
    _count(two["launches"], paths)

    phase("36 the ALS headline under als_precision \"high\" (bf16x3) and "
          "\"default\" (one bf16 pass): s/iter, RMSE against phase 8, one "
          "profiled step each; then \"highest\" bit-equal to phase 8")
    prec = run_als_precisions(dev, als)
    _count(prec["launches"], paths)

    phase("37 the bf16 gram products against their plain f32 version at "
          "the ALS headline's buckets")
    gram_worst = check_gram_products(dev)

    phase("38 sharded ALS under \"default\" over one rank (NCCL), "
          "bit-equal to phase 36's run")
    sh_als = run_sharded_als_default(dev, prec["factors"])
    _count(sh_als["launches"], paths)

    phase("39 the host set-up split at Netflix-100M dims, NumPy then the "
          "native helpers, outputs byte-equal")
    host = run_host_setup()

    phase("40 the ml1m trajectories (scripts/run_trajectories.py, 3 "
          "iterations: text -> convert -> binfmt -> dense CCD++, two "
          "hybrids, ALS) against the golden solvers and the JAX records")
    traj = run_trajectories_phase()
    for rec in traj.values():
        _count(rec["launches"], paths)

    phase("41 the measurement scripts: the reference grid at ml1m dims, a "
          "flagship row and the variance probe on phase 4's data, the ALS "
          "golden at \"high\" and \"default\", the scaling model")
    meas = run_measurement_scripts(dev, head)
    _count(meas["launches"], paths)

    phase("42 the fp8 instances of K1-K4 and the masked sweeps (NaN, bf16 "
          "and int8 masks; once and delta-first) against their plain "
          "versions, a planted overflow, and their times")
    fp8_worst = check_fp8(dev)
    check_row_sweeps(dev, (FP8,), (None, torch.bfloat16, torch.int8),
                     fp8_worst)
    fp8_times = time_fp8()
    print(f"[timing] card: {smi}", flush=True)

    phase("43 the fp8 hybrid at the headline (train(), 2 iterations): int8 "
          "masks (K4 delta-first), NaN panels with the panel kernels (K1 "
          "once)")
    fp8_hyb = run_fp8_hybrid(dev, netflix, head)
    for rec in fp8_hyb.values():
        _count(rec["launches"], paths)

    phase("44 fp8 on the dense quick start (K4 delta-first), the pallas "
          "backend (K4 once, -T 2) and the NaN-panel hybrid without the "
          "panel kernel (K1 delta-first, K3, -T 2), ml10M dims")
    fp8_dense = run_fp8_dense(dev, dense)
    for rec in fp8_dense.values():
        _count(rec["launches"], paths)

    phase(f"45 the headline with hybrid_defer_group={DEFER_G}: against G=0 "
          "at an f32 residual (2 iterations each), and at bf16 beside phase "
          "4")
    defer = run_defer_group(dev, netflix, head)
    _count(defer["launches"], paths)
    del netflix
    phase(None)
    print("[resume] summary " + json.dumps({
        name: {key: rec[key] for key in ("bytes", "save_s", "load_s",
                                         "s_iter")}
        for name, rec in (("als_ml20m", als_ck), ("dense_ml10m", dense_ck),
                          ("hybrid_ml10m", hyb_ck))}), flush=True)
    print("[sharded] summary " + json.dumps({
        "headline_1_rank": {key: sh_head[key] for key in ("s_iter", "peak")},
        "headline_single_device": {"s_iter": head["s_iter"],
                                   "peak": head["peak"]},
        "backends_1_rank": sh_rest["runs"],
        "two_ranks_gloo": {key: two[key] for key in ("s_iter", "rmse_diff",
                                                     "rel")},
        "card": smi}), flush=True)
    print("[als-precision] summary " + json.dumps({
        "phase_8_highest": {"s_iter": als["s_iter"], "rmse": als["rmse"]},
        **prec["runs"], "gram_product_max_abs_err": gram_worst,
        "sharded_default_1_rank_s_iter": sh_als["s_iter"], "card": smi}),
        flush=True)
    print("[host] summary " + json.dumps({
        key: host[key] for key in ("data", "median_s", "numpy_over_native",
                                   "smoke_paths", "host_cpus")}),
        flush=True)
    print("[trajectories] summary " + json.dumps({
        arm: {"rmse_compiled": [x["rmse_compiled"] for x in rec["lines"]],
              "rmse_golden": [x["rmse_golden"] for x in rec["lines"]],
              "golden_W": rec["summary"]["golden_W"],
              "golden_H": rec["summary"]["golden_H"],
              "compiled_train_s": rec["summary"]["compiled_train_s"],
              "launches": rec["launches"]}
        for arm, rec in traj.items()}), flush=True)
    fl, var = meas["flagship"], meas["variance"]
    print("[measure] summary " + json.dumps({
        "sweep_cells": len(meas["sweep"]),
        "flagship_row": {key: fl[key] for key in (
            "iter_s", "iter_s_pair_samples", "rmse_after_iters",
            "rmse_after_iters_jax", "panels", "nnz_light_frac")},
        "headline_s_iter": head["s_iter"],
        "variance": {key: var[key] for key in (
            "per_iter_fenced_median_s", "per_iter_event_median_s",
            "pooled_median_s", "late_median_s", "sync_idle_median_s",
            "spread")},
        "bench_als": meas["bench_als"],
        "scaling": [{key: x[key] for key in (
            "n_devices", "iter_s", "efficiency_vs_1_device")}
            for x in meas["scaling"]], "card": smi}), flush=True)
    print("[phase] summary " + json.dumps({
        "headline_split": phased["split"], "fused_s_iter": head["s_iter"],
        "update_busy_ms": phased["update"]["busy_ms"],
        "update_rmw_bound_ms": phased["update"]["rmw_bound_ms"],
        "ell_s_iter": ell["s_iter"], "card": smi}), flush=True)

    print("[fp8] summary " + json.dumps({
        "headline_bf16": {"s_iter": head["s_iter"], "peak": head["peak"],
                          "rmse": head["rmse"]},
        **{f"headline_fp8_{key}": {k: rec[k] for k in ("s_iter", "peak",
                                                       "rmse")}
           for key, rec in fp8_hyb.items()},
        **{f"ml10m_fp8_{key}": {k: rec[k] for k in ("s_iter", "peak",
                                                    "rmse")}
           for key, rec in fp8_dense.items()},
        "ml10m_f32_dense": {"s_iter": dense["s_iter"], "rmse": dense["rmse"]},
        f"headline_defer_{DEFER_G}": {k: v for k, v in defer.items()
                                      if k != "launches"},
        "kernels_ms": {mask: {name: rec[0] for name, rec in t.items()}
                       for mask, t in fp8_times.items()},
        "card": smi}), flush=True)

    print(f"\n[done] all phases passed in {time.perf_counter() - t_all:.0f} s",
          flush=True)
    print(smi, flush=True)
    kernels = [{"name": name, "route": "cuda",
                "source": f"{CSRC}/panel_kernels.cu", "replaces": replaces,
                "launches": paths[name],
                "max_abs_err": worst[name], "ms": times[name][0],
                "plain_ms": times[name][1], "bound_ms": times[name][2],
                "bound_by": times[name][3], "library_ms": None}
               for name, replaces in KERNELS.items()]
    kernels.append({"name": "gj_solve", "route": "cuda",
                    "source": f"{CSRC}/gj_kernels.cu",
                    "replaces": GJ_REPLACES,
                    "launches": paths["gj_solve"],
                    "max_abs_err": gj_worst, **gj_times[40]})
    # the ALS gram kernel replaces no TPU kernel; its error is its largest
    # share of the f32 summation's bound
    kernels.append({"name": "als_gram", "route": "cuda",
                    "source": f"{CSRC}/als_kernels.cu", "replaces": None,
                    "launches": paths["als_gram"],
                    "max_abs_err": als_gram_worst, **gram_times})
    # K4 and the masked sweeps: the dense headline's f32 residual
    kernels += [{"name": name, "route": "cuda",
                 "source": f"{CSRC}/panel_kernels.cu", "replaces": replaces,
                 "launches": paths[name],
                 "max_abs_err": masked_worst[name],
                 "ms": masked_times["float32"][name][0],
                 "plain_ms": masked_times["float32"][name][1],
                 "bound_ms": masked_times["float32"][name][2],
                 "bound_by": masked_times["float32"][name][3],
                 "library_ms": None}
                for name, replaces in MASKED_KERNELS.items()]
    # the probe kernels: launches from the bench's controls (phase 19: the
    # gathers' count their graph replays) and the variant matrix (phase 21)
    probe_launches = dict(bd["controls"]["launches"])
    probe_launches["panel_update_vsweep_irne"] = variants["launches"][
        "panel_update_vsweep_irne"]
    kernels += [{"name": name, "route": "cuda", "source": f"{CSRC}/{src}",
                 "replaces": replaces, "launches": probe_launches[name],
                 "max_abs_err": probe_worst[name],
                 **{key: probe_times[name][key] for key in (
                     "ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms")}}
                for name, (src, replaces) in PROBES.items()]
    # the fp8 instances: K1-K3 at the headline's panel 0, K4 and the masked
    # sweeps at the ml10M shape beside the quick start's bf16 mask
    fp8_rows = dict(fp8_times["nan"], **fp8_times["bfloat16"])
    kernels += [{"name": name, "route": "cuda",
                 "source": f"{CSRC}/panel_kernels.cu", "replaces": replaces,
                 "launches": paths.get(name, 0),
                 "max_abs_err": fp8_worst[name], "ms": fp8_rows[name][0],
                 "plain_ms": fp8_rows[name][1],
                 "bound_ms": fp8_rows[name][2],
                 "bound_by": fp8_rows[name][3], "library_ms": None}
                for name, replaces in FP8_KERNELS.items()]
    for kern in kernels:
        if kern["launches"] <= 0:
            raise AssertionError(f"{kern['name']} never launched on its "
                                 "path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
