"""Measurement and validation scripts of the port: the card's stream and
gather controls, and the runs that hold the port against the golden
solvers and the JAX package's records.

  * ``panel_floor`` — the read-modify-write and read stream controls (P1)
    beside K1 and K2, at the headline's panel shapes;
  * ``panel_kernel_variants`` — the variant matrix of K1 (P2): the rmw and
    read floors, K1, K1 rounded by integer RNE, K2;
  * ``probe_gather`` — the gather forms A, B, C (P3) against their one
    PyTorch call, at the probe's shapes and at the ELL tail's;
  * ``collective_overhead`` — the host cost of one collective of the
    sharded paths (NCCL and gloo, a world of one rank), idle and behind
    queued device work;
  * ``run_trajectories`` — the ml-1m-calibrated fixture through text,
    ``cli/convert``, binfmt and training (dense CCD++, two hybrids, ALS),
    each RMSE trajectory against the NumPy golden solver and the JAX
    package's committed records;
  * ``golden_netflix_scale`` — the NaN-panel hybrid at Netflix-100M (f32
    and bf16 residuals) against the NumPy golden solver, 3 iterations;
  * ``yahoo_robustness`` — the hybrid (both stair orientations) and ALS at
    the reference sweep's Yahoo r1 and c15 geometries: s/iter, share of
    the card's bound, the profiled split, RMSE beside the JAX records;
  * ``sweep`` — the reference's times.sh grid (CCD++ k x T, ALS k, 3
    repeats) through ``cli/bench.py``, each cell against the JAX
    package's ``r2`` records;
  * ``sweep_netflix_hybrid`` — the flagship sweep: the hybrid at
    Netflix-100M dims over k x panel budget x stair (hand against auto,
    in turns), group-difference timing, RMSE beside the JAX records;
  * ``headline_variance`` — the headline's s/iter spread within one
    process (fenced, pooled, late samples; CUDA events) and across fresh
    processes;
  * ``scaling_model`` — the sharded hybrid's s/iter on N cards, modelled
    from one card's s/iter, its profile's split and the all-reduces'
    bytes and host cost;
  * ``bench_als`` — the ALS step at ml20M dims by gram precision, and the
    ml1m golden check of "high" and "default";
  * ``sass_report`` — the column and row sweeps' machine code per
    instance: ptxas' registers and spills, conversions a cell, and whether
    an instance's SASS changed against another checkout's.

``sweep_timing`` and ``fp8_runs`` (each run as a file, with ``--root``)
time the kernels, and the fp8 training runs of the smoke's phases 43-44,
of two checkouts in turns; ``fp8_grid`` builds the fp8 store's boundary
grid that ``chip_smoke.py`` and the tests hold the fp8 stores to.

Each runs as ``python -m cuda_recommender_tpu_torch.scripts.<name>``, on
the card unless ``--device cpu`` is given; ``common`` holds what they and
``cuda_recommender_tpu_torch.bench`` share.
"""
