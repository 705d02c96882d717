"""Kernel timing: K1, K2, K3, K4, the masked sweeps, the rounding variant,
K5 and P3's gathers at the main paths' shapes, each against its plain
version (K5 also against ``torch.linalg.solve``, the gathers against
``torch.gather``, ``torch.take`` and ``index_select``: the one PyTorch call
that computes each function), for one checkout of the port.

    python cuda_recommender_tpu_torch/scripts/sweep_timing.py [--root DIR]
        [--gathers | --fp8 [--outputs FILE] | --streams | --read-levers |
         --row-sweep]

``--root`` imports the package from another checkout (an unpacked copy of
another commit; default: the checkout that holds this file), so that one
script times two versions of the kernels on one card. Run it once per
checkout, in turns (A, B, B, A), each in a fresh process. Each kernel and
its plain version are timed in turns (plain, kernel, kernel, plain; CUDA
events over REPS calls each, after one warm-up call) on panels far larger
than the 50 MB L2; K5 in turns plain, library, kernel, kernel, library,
plain on the ALS headline's rows side (S = 138,493 systems, views of one
augmented gram as the ALS assembly passes them) at each of GJ_KS. With
``--gathers`` it times P3's gathers A, B and C instead, at GATHER_SHAPES,
by graph replays of GATHER_REPS calls with the index cycled through 128
MB of copies (``probe_gather``'s method: a call's device time is below
the host's cost of issuing it), in turns plain, library, kernel, kernel,
library, plain.
With ``--fp8`` it times the fp8 instances instead (``time_fp8``: K1 in
both store orders, K2 and K3 at the headline's panel 0; K4 in both orders
and the masked sweeps at MASKED_SHAPE beside a bf16 and an int8 mask), and
with ``--outputs FILE`` it first runs every fp8 instance once on one
seeded input (``fp8_outputs``) and writes the digests of what each stores
and sums (R', g, h) to FILE, or, where FILE exists (another checkout's,
written by an earlier run), holds them bit-equal to it and exits 1 where
one differs.
With ``--streams`` it times P1/P2's streams instead (``time_streams``: the
rmw, the u-weighted read and the NaN-skip read at STREAM_SHAPES, each the
checkout's own kernel, ``stream_rmw(R)`` / ``stream_read(R[, u])``, beside
its plain version and its PyTorch call, in turns); run an older
checkout's copy of this file to time its streams. With ``--read-levers``
it times ``stream_read`` at the same shapes under its own plan and under
plans that each take one lever of its design away (``read_lever_plans``),
in turns.
With ``--row-sweep`` it times the row sweep instead (``time_row_sweep``:
K2 at bf16 at every panel shape of the Yahoo r1_t and c15_t stairs, read
from ``results/yahoo_robustness.jsonl``, at the headline's panels and at
NAN_SHAPES, K2 at fp8 at the headline's panel 0, and masked_usweep at
MASKED_SHAPE for f32, bf16 and fp8 residuals beside a bf16 and an int8
mask), each beside its bound and its plain version, and for each stair
40 x the sum of its panels' times beside the record's profiled K2 time.
It uses only the wrappers, so ``--root`` times an older checkout's row
sweep too.
``chip_smoke.py`` times its phases 6, 9, 15, 19 and 42 through
``nan_sweeps``, ``gj_solves``, ``masked_sweeps``, ``time_streams``,
``time_fp8`` and ``time_sweeps``, and
checks K5 on ``spd_systems``, so that one place holds the calls, their
bytes and their operations. Prints one line per
kernel and a JSON summary (ms, plain ms, GB/s and share of the HBM rate of
the bytes each call must move) as the last line; on the CPU the times are
null ("not measured").
"""

from __future__ import annotations

import argparse
import json
import os
import sys

#: K1, K2 and K3 (bf16, NaN sentinel, 30% observed): the hybrid headline's
#: panel 0 and the transposed stair's panel 0 (an odd width)
NAN_SHAPES = ((330_128, 17_770), (13_464, 480_189))
#: K4 and the masked sweeps: the dense quick start's residual (ml10M dims),
#: f32 and bf16 residual, bf16 and int8 mask
MASKED_SHAPE = (69_878, 10_677)
#: the fp8 outputs' seeded input: two row bands of the 1-byte sweep's
#: interleave (65,536 rows each at the fewest rows a part) and an odd width
FP8_OUTPUT_SHAPE = (66_001, 1_037)
#: the rounding variant: the variant matrix's panel and NaN pattern
VARIANT_SHAPE = (165_376, 18_432)
#: the streams: the bench's panel 0 (a NaN-sentinel panel, 30% observed),
#: the variant matrix's panel and the bench's panel 1 (the variant
#: matrix's NaN pattern)
STREAM_SHAPES = (NAN_SHAPES[0], VARIANT_SHAPE, (150_061, 4_096))
STREAM_REPS = 5
#: the row sweep's stairs (``--row-sweep``): the Yahoo jobs whose panels it
#: times, and the records that hold their panels and profiled K2 times
ROW_STAIRS = ("r1_t", "c15_t")
ROW_RECORDS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           os.pardir, "results", "yahoo_robustness.jsonl")
#: the headline's panels (the hand stair at Netflix-100M dims)
HEADLINE_PANELS = ((330_128, 17_770), (150_061, 4_096))
#: the rank's K2 launches a stair panel takes an iteration (k = 40)
ROW_K = 40
#: K5: the ALS headline's rows side (ml20M's users) at k = 10, 40 (the
#: headline) and 128 (the kernel's widest)
GJ_S = 138_493
GJ_KS = (10, 40, 128)
#: P3's gathers (table rows, index rows of 128 lanes): the probe's shape
#: and the bench's two tail sides at the headline (``tail_shape`` of
#: 2,900,227 lanes over 17,771 x 3 floats and of 3,027,760 lanes over
#: 480,190 x 2)
GATHER_SHAPES = {"probe": (8192, 4096), "rows tail": (417, 22_659),
                 "cols tail": (7503, 23_655)}
#: calls captured in a gather's timing graph
GATHER_REPS = 100
#: timed calls per kernel and turn, after one untimed
REPS = 10
#: the same for K5 (its plain version takes about 2 s a call at k = 128)
GJ_REPS = 5

_HERE = os.path.dirname(os.path.abspath(__file__))


def _vectors(M, W, device, seed) -> list:
    """u and v of the current and the previous rank: 1e-3 * N(0, 1)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return [1e-3 * torch.randn(n, generator=gen, device=device)
            for n in (M, M, W, W)]


def as_residual(R, dtype):
    """R (bf16) rounded to ``dtype``: R itself at bf16; at fp8 row blocks
    through ``round_to_storage`` (no full-size f32 temporary)."""
    import torch

    from cuda_recommender_tpu_torch.ops.densify import round_to_storage

    if dtype == torch.bfloat16:
        return R
    out = torch.empty(R.shape, dtype=dtype, device=R.device)
    rows = max(1, (1 << 26) // max(1, R.shape[1]))
    for r0 in range(0, R.shape[0], rows):
        out[r0:r0 + rows].copy_(round_to_storage(
            R[r0:r0 + rows].to(torch.float32), dtype))
    return out


def nan_panel(M, W, device, seed, dtype=None):
    """An (M, W) NaN-sentinel panel of ``dtype`` (default bf16; 30%
    observed) and its vectors (uo, up, vo, vp), drawn on the device from
    ``seed``."""
    import torch

    dtype = torch.bfloat16 if dtype is None else dtype
    gen = torch.Generator(device=device).manual_seed(seed)
    R = torch.randn((M, W), generator=gen, device=device, dtype=torch.bfloat16)
    R.masked_fill_(torch.rand((M, W), generator=gen, device=device,
                              dtype=torch.bfloat16) >= 0.3, float("nan"))
    return as_residual(R, dtype), _vectors(M, W, device, seed + 1)


def masked_panel(M, W, dtype, mask_dtype, device, seed):
    """An (M, W) residual of ``dtype`` (30% observed, 0 elsewhere), its
    ``mask_dtype`` mask and its vectors (ua, us, va, vs), drawn on the
    device from ``seed``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    keep = torch.rand((M, W), generator=gen, device=device) < 0.3
    draw = dtype if dtype != torch.float8_e4m3fn else torch.bfloat16
    R = torch.randn((M, W), generator=gen, device=device,
                    dtype=draw).masked_fill_(~keep, 0.0)
    if draw != dtype:
        R = as_residual(R, dtype)
    return R, keep.to(mask_dtype), _vectors(M, W, device, seed + 1)


def nan_sweeps(M, W, device, seed, dtype=None) -> dict:
    """K1, K2 and K3 on an (M, W) NaN-sentinel panel of ``dtype`` (default
    bf16; fp8: K1 in both store orders) (30% observed) drawn on the device
    from ``seed``: name -> (kernel call, plain call, bytes, flops), the
    name the instance's (``panel_kernels.instance_name``). Bytes: each
    reads the panel (its cells' bytes) and its vectors and writes g and h;
    K1 also writes the panel back. Flops a cell: 7 (K1), 3 (K2, K3)."""
    from cuda_recommender_tpu_torch.ops import panel_kernels as pk

    R, (uo, up, vo, vp) = nan_panel(M, W, device, seed, dtype)
    cells, rb = M * W, R.element_size()
    orders = ("once", "delta_first") if rb == 1 else ("once",)
    out = {pk.instance_name("panel_update_vsweep", dtype, order): (
        lambda o=order: pk.panel_update_vsweep(R, uo, up, vo, vp, order=o),
        lambda o=order: pk.panel_update_vsweep_plain(R, uo, up, vo, vp,
                                                     order=o),
        2 * rb * cells + 4 * (2 * M + 4 * W), 7 * cells) for order in orders}
    out[pk.instance_name("panel_usweep", dtype)] = (
        lambda: pk.panel_usweep(R, vo), lambda: pk.panel_usweep_plain(R, vo),
        rb * cells + 4 * (W + 2 * M), 3 * cells)
    out[pk.instance_name("panel_vsweep", dtype)] = (
        lambda: pk.panel_vsweep(R, uo), lambda: pk.panel_vsweep_plain(R, uo),
        rb * cells + 4 * (M + 2 * W), 3 * cells)
    return out


def masked_sweeps(M, W, dtype, mask_dtype, device, seed) -> dict:
    """K4 and the masked sweeps on an (M, W) residual of ``dtype`` (30%
    observed, 0 elsewhere; fp8: K4 in both store orders) and its
    ``mask_dtype`` mask, drawn on the device from ``seed``: name ->
    (kernel call, plain call, bytes, flops), the name the instance's.
    Bytes: K4 reads and writes the residual and reads the mask, the sweeps
    read both; each reads its vectors and writes g and h. Flops a cell: 6
    (K4, as the Pallas kernel's cost estimate), 4 (the sweeps)."""
    from cuda_recommender_tpu_torch.ops import ccd_kernels as ck
    from cuda_recommender_tpu_torch.ops.panel_kernels import instance_name

    R, Mk, (ua, us, va, vs) = masked_panel(M, W, dtype, mask_dtype, device,
                                           seed)
    cells, rb, mb = M * W, R.element_size(), Mk.element_size()
    orders = ("once", "delta_first") if rb == 1 else ("once",)
    out = {instance_name("fused_update_vsweep", dtype, order): (
        lambda o=order: ck.fused_update_vsweep(R, Mk, ua, us, va, vs,
                                               order=o),
        lambda o=order: ck.fused_update_vsweep_plain(R, Mk, ua, us, va, vs,
                                                     order=o),
        cells * (2 * rb + mb) + 4 * (2 * M + 4 * W), 6 * cells)
        for order in orders}
    out[instance_name("masked_usweep", dtype)] = (
        lambda: ck.masked_usweep(R, Mk, va),
        lambda: ck.masked_usweep_plain(R, Mk, va),
        cells * (rb + mb) + 4 * (W + 2 * M), 4 * cells)
    out[instance_name("masked_vsweep", dtype)] = (
        lambda: ck.masked_vsweep(R, Mk, ua),
        lambda: ck.masked_vsweep_plain(R, Mk, ua),
        cells * (rb + mb) + 4 * (M + 2 * W), 4 * cells)
    return out


def variant_sweeps(M, W, device, seed) -> dict:
    """The rounding variant and K1 on the variant matrix's (M, W) panel and
    NaN pattern, as ``nan_sweeps``."""
    from cuda_recommender_tpu_torch.ops import panel_kernels as pk
    from cuda_recommender_tpu_torch.scripts.panel_kernel_variants import \
        pattern_panel

    R = pattern_panel(M, W, device)
    vecs = _vectors(M, W, device, seed)
    nbytes, flops = 4 * M * W + 4 * (2 * M + 4 * W), 7 * M * W
    return {
        "panel_update_vsweep_irne": (
            lambda: pk.panel_update_vsweep_irne(R, *vecs),
            lambda: pk.panel_update_vsweep_irne_plain(R, *vecs),
            nbytes, flops),
        "panel_update_vsweep": (
            lambda: pk.panel_update_vsweep(R, *vecs),
            lambda: pk.panel_update_vsweep_plain(R, *vecs), nbytes, flops)}


def spd_systems(k, S, device, seed):
    """S seeded SPD systems F Fᵀ + 3I, F (S, k, min(k, 16)) standard normal
    (the systems of tests/test_pallas.py:79-87), and right-hand sides."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    F = torch.randn((S, k, min(k, 16)), generator=gen, device=device)
    A = torch.bmm(F, F.transpose(1, 2))
    A.diagonal(dim1=1, dim2=2).add_(3.0)
    b = torch.randn((S, k), generator=gen, device=device)
    return A, b


def gj_solves(k, S, device, seed) -> dict:
    """K5 on S seeded SPD systems of size k, laid out as the ALS assembly
    passes them (solvers/als_ell.py): A and b are views of one
    (S, k+1, k+1) augmented gram. {"gj_solve": (kernel call, plain call,
    bytes, flops, library call)}. Bytes: A and b read, x written. Flops:
    the elimination's live columns, a multiply and a subtract for each of
    k rows × (k - i) columns at step i, S·k²·(k+1) in all (a full sweep of
    every column would be twice that)."""
    import torch

    from cuda_recommender_tpu_torch.ops import gj_kernels as gk

    A, b = spd_systems(k, S, device, seed)
    aug = torch.zeros((S, k + 1, k + 1), device=device)
    aug[:, :k, :k], aug[:, :k, k] = A, b
    A, b = aug[:, :k, :k], aug[:, :k, k]
    return {"gj_solve": (lambda: gk.gj_solve(A, b),
                         lambda: gk.gj_solve_plain(A, b),
                         4 * (A.numel() + 2 * b.numel()), S * k * k * (k + 1),
                         lambda: torch.linalg.solve(A, b))}


def gathers(S, rows, device, seed) -> dict:
    """P3's forms A, B and C over an (S, 128) f32 table and (rows, 128)
    int32 index tiles drawn on the device from ``seed``, each call taking
    the next of the index's cold copies: name -> (kernel call, plain call,
    bytes, flops, library call). Bytes: each index element read and each
    output element written once (4 B each; form C reads one index a row),
    the table read once. The library calls take an int64 copy of the
    index, made here."""
    import torch

    from cuda_recommender_tpu_torch.ops import probe_kernels as pr
    from cuda_recommender_tpu_torch.scripts.common import cold_copies, \
        cycling
    from cuda_recommender_tpu_torch.scripts.probe_gather import \
        library_call, probe_inputs

    tab, idx = probe_inputs(S, rows, device, seed)
    n, table = rows * tab.shape[1], 4 * tab.numel()
    out = {}
    for form in ("A", "B", "C"):
        copies = cold_copies(idx[form])
        wide = cold_copies(idx[form].to(torch.int64))
        out[f"gather {form}"] = (
            cycling([(lambda ix=ix, f=form: pr.gather(tab, ix, f))
                     for ix in copies]),
            cycling([(lambda ix=ix, f=form: pr.gather_plain(tab, ix, f))
                     for ix in copies]),
            (4 * rows if form == "C" else 4 * n) + 4 * n + table, 0,
            cycling([library_call(tab, ix, form) for ix in wide]))
    return out


def time_turns(fns, device, reps: int, graph: bool = False) -> list:
    """Each of ``fns`` warmed up once, then timed in turns forward and back
    (a, b, ..., b, a), each turn ``common.time_ms`` over ``reps`` calls
    (captured in a CUDA graph with ``graph``), so that a drift of the
    card's clock falls on all alike. Returns each one's two readings
    (None, None on the CPU). It lives here, not in ``common``, because this
    file also runs against older checkouts."""
    import torch

    from cuda_recommender_tpu_torch.scripts.common import time_ms

    for fn in fns:
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    first = [time_ms(fn, device, reps, 0, graph=graph) for fn in fns]
    second = [time_ms(fn, device, reps, 0, graph=graph)
              for fn in fns[::-1]][::-1]
    return list(zip(first, second))


def time_sweeps(calls: dict, what: str, device, reps: int = REPS,
                graph: bool = False) -> dict:
    """Each of ``calls`` (name -> (kernel, plain, bytes, flops[, library
    call])) against its plain version, in turns plain, [library,] kernel,
    kernel, [library,] plain (``time_turns``); prints a line each. Returns
    "name what" -> {ms, plain_ms, library_ms (None without one), the two
    turns' ms of each, bytes, flops, GB_s, share_of_peak}."""
    from cuda_recommender_tpu_torch.scripts.common import rate

    def mean(turns):
        return None if turns[0] is None else sum(turns) / 2

    out = {}
    for name, (kern, plain, nbytes, flops, *lib) in calls.items():
        got = time_turns([plain, *lib, kern], device, reps, graph)
        (p1, p2), (k1, k2) = got[0], got[-1]
        ms = mean(got[-1])
        rec = {**rate(nbytes, ms), "plain_ms": mean(got[0]),
               "library_ms": mean(got[1]) if lib else None,
               "turns": [k1, k2], "plain_turns": [p1, p2],
               "library_turns": list(got[1]) if lib else None,
               "bytes": nbytes, "flops": flops}
        out[f"{name} {what}"] = rec
        print(f"{name + ' ' + what:56s}: " + (
            "not measured (cpu)" if ms is None else
            f"kernel {k1:.5f} / {k2:.5f} ms, plain {p1:.5f} / {p2:.5f} ms"
            + (f", library {got[1][0]:.5f} / {got[1][1]:.5f} ms" if lib
               else "") + f"; kernel {rec['GB_s']:.0f} GB/s, "
            f"{100 * rec['share_of_peak']:.1f}% of the HBM rate"), flush=True)
    return out


def time_gathers(device) -> dict:
    """P3's gathers at GATHER_SHAPES (``gathers``, graph replays);
    returns {"gather F shape": rate}."""
    out = {}
    for name, (S, rows) in GATHER_SHAPES.items():
        calls = gathers(S, rows, device, seed=S)
        out.update(time_sweeps(calls, f"{name} {S}x128, {rows} rows",
                               device, GATHER_REPS, graph=True))
        del calls
    return out


def time_fp8(device, reps: int = REPS) -> dict:
    """Every fp8 instance against its plain version (``time_sweeps``): K1
    (both store orders), K2 and K3 at the headline's panel 0, K4 (both
    orders) and the masked sweeps at MASKED_SHAPE beside a bf16 and an
    int8 mask. Returns {"nan" | "bfloat16" | "int8": time_sweeps' dict}."""
    import torch

    fp8 = torch.float8_e4m3fn
    (M, W), out = NAN_SHAPES[0], {}
    calls = nan_sweeps(M, W, device, seed=7, dtype=fp8)
    out["nan"] = time_sweeps(calls, f"{M}x{W} fp8", device, reps)
    del calls
    M, W = MASKED_SHAPE
    for mdt in (torch.bfloat16, torch.int8):
        if device.type == "cuda":
            torch.cuda.empty_cache()
        calls = masked_sweeps(M, W, fp8, mdt, device, seed=7)
        out[str(mdt)[6:]] = time_sweeps(
            calls, f"{M}x{W} fp8, {str(mdt)[6:]} mask", device, reps)
        del calls
    return out


def _stream_panel(i: int, M: int, W: int, device):
    """The streams' i-th panel: a NaN-sentinel panel first, the variant
    matrix's NaN pattern after it."""
    from cuda_recommender_tpu_torch.scripts.panel_kernel_variants import \
        pattern_panel

    return (nan_panel(M, W, device, seed=M)[0] if i == 0 else
            pattern_panel(M, W, device))


def time_streams(device, reps: int = STREAM_REPS, shapes=None) -> dict:
    """P1/P2's streams at each of ``shapes`` (default STREAM_SHAPES; the
    first a NaN-sentinel panel, the others the variant matrix's NaN
    pattern): the rmw (``R.add_(1)``),
    the u-weighted read (``torch.mv(R.t(), u)``, u rounded to bf16) and the
    NaN-skip read (``torch.nansum``), each in turns plain, PyTorch call,
    the checkout's kernel, and back (``time_turns``). Returns {"stream_...
    MxW": {ms (the kernel), plain_ms, library_ms, each one's two turns,
    bytes, flops, bound_ms, GB_s, share_of_peak}}; bytes count each input
    read once and each output written once."""
    import torch

    from cuda_recommender_tpu_torch.ops import probe_kernels as pr
    from cuda_recommender_tpu_torch.scripts.common import PEAK_BYTES_S, \
        PEAK_F32_FLOP_S, rate

    def mean(turns):
        return None if turns[0] is None else sum(turns) / 2

    out = {}
    for i, (M, W) in enumerate(shapes or STREAM_SHAPES):
        R = _stream_panel(i, M, W, device)
        u = torch.randn(M, device=device)
        u_lib = u.to(R.dtype)
        cells = M * W
        calls = {
            "stream_rmw": (lambda: pr.stream_rmw(R),
                           lambda: pr.stream_rmw_plain(R),
                           lambda: R.add_(1), 4 * cells),
            "stream_read": (lambda: pr.stream_read(R, u),
                            lambda: pr.stream_read_plain(R, u),
                            lambda: torch.mv(R.t(), u_lib),
                            2 * cells + 4 * (-(-M // 512) + W)),
            "stream_read_nan_skip": (
                lambda: pr.stream_read(R),
                lambda: pr.stream_read_plain(R),
                lambda: torch.nansum(R, 0, dtype=torch.float32),
                2 * cells + 4 * W)}
        for name, (kern, plain, lib, nbytes) in calls.items():
            got = time_turns([plain, lib, kern], device, reps)
            ms = mean(got[2])
            bound = 1e3 * max(nbytes / PEAK_BYTES_S, cells / PEAK_F32_FLOP_S)
            rec = {**rate(nbytes, ms), "plain_ms": mean(got[0]),
                   "library_ms": mean(got[1]), "turns": list(got[2]),
                   "library_turns": list(got[1]), "bytes": nbytes,
                   "flops": cells, "bound_ms": bound}
            key = f"{name} {M}x{W}"
            out[key] = rec
            if ms is None:
                print(f"{key}: not measured ({device.type})", flush=True)
            else:
                print(f"{key}: kernel {ms:.3f} ms ({100 * bound / ms:.1f}% "
                      f"of its {bound:.3f} ms bound), library "
                      f"{rec['library_ms']:.3f}, plain {rec['plain_ms']:.3f}"
                      f"; turns {rec['turns']}", flush=True)
        del R, u, u_lib, calls
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def read_lever_plans(M: int, W: int, plan: dict, per_sm: int,
                     sms: int) -> dict:
    """stream_read's plan ``plan`` of an (M, W) panel (``read_plan``, on a
    card of ``sms`` SMs that each hold ``per_sm`` of its blocks) and plans
    that change one lever of it: "shifted" (the shifted row path's plan
    where the plan takes the aligned one), "one wave" (the most ranges that
    fit one wave of per_sm x sms blocks) and "k row blocks" (k = 1, 4: k
    512-row blocks a thread block, several waves; at k = 1 the grid is
    sized to the panel as the earlier design's was, and a tile's last
    block adds ceil(M / 512) sums), each where it differs from the
    plan."""
    from cuda_recommender_tpu_torch.ops import probe_kernels as pr

    out = {"design": plan}
    if plan["path"] == "aligned":       # a plan of the shifted path's tiles
        out["shifted"] = pr.read_plan(M, W, 2, sms, per_sm)
    nb, tiles = plan["blocks"], plan["tiles"]
    for name, ranges in (("one wave", max(1, min(nb, per_sm * sms // tiles))),
                         ("1 row block", nb), ("4 row blocks", -(-nb // 4))):
        if ranges != plan["ranges"]:
            out[name] = dict(plan, ranges=ranges, grid=tiles * ranges)
    return out


def time_read_levers(device, reps: int = STREAM_REPS, shapes=None) -> dict:
    """stream_read (weighted and NaN-skip) at each of ``shapes`` (default
    STREAM_SHAPES, on ``time_streams``' panels) under each of
    ``read_lever_plans``, in turns (``time_turns``). Returns {"mode MxW
    lever": {ms, turns, ranges, path}}; on the CPU (no kernel to time) the
    plans with ms None."""
    import torch

    from cuda_recommender_tpu_torch.ops import probe_kernels as pr

    out = {}
    for i, (M, W) in enumerate(shapes or STREAM_SHAPES):
        R = _stream_panel(i, M, W, device)
        u = torch.randn(M, device=device)
        for mode, uu in (("stream_read", u), ("stream_read_nan_skip", None)):
            plan = pr.stream_read_plan(R, uu is None)
            per_sm = pr.read_blocks_per_sm(R.device, uu is None, plan["path"])
            plans = read_lever_plans(M, W, plan, per_sm,
                                     pr.gather_limits(R.device)[1])
            fns = [lambda p=p: pr.launch_read(R, uu, p)
                   for p in plans.values()]
            got = (time_turns(fns, device, reps) if device.type == "cuda"
                   else [(None, None)] * len(fns))
            for (lever, plan), turns in zip(plans.items(), got):
                key = f"{mode} {M}x{W} {lever}"
                ms = None if turns[0] is None else sum(turns) / 2
                out[key] = {"ms": ms, "turns": list(turns),
                            "ranges": plan["ranges"], "path": plan["path"]}
                print(f"{key}: " + ("not measured" if ms is None else
                                    f"{ms:.4f} ms, turns {list(turns)}")
                      + f" ({plan['path']}, {plan['ranges']} ranges)",
                      flush=True)
        del R, u
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def stair_panels(job: str) -> tuple:
    """(the (rows, width) of each panel, the profiled K2 ms an iteration)
    of Yahoo job ``job``'s record in ROW_RECORDS."""
    with open(ROW_RECORDS) as f:
        rec = next(r for r in map(json.loads, f) if r.get("name") == job)
    return ([(r1 - r0, w) for r0, r1, w in rec["panels"]],
            (rec.get("busy_ms_by_part") or {}).get("K2"))


def _row_plan_text(R) -> str:
    """The row sweep's plan of R where the checkout has one."""
    from cuda_recommender_tpu_torch.ops import panel_kernels as pk

    plan_of = getattr(pk, "residual_plan", None)
    if plan_of is None:
        return "the checkout has no row_sweep_plan"
    p = plan_of(R)
    return (f"{p['segments']} segments of {p['segment_spans']} spans, "
            f"{p['chunks']} chunks, grid {p['grid']}")


def _time_row(name, calls, what, device, reps) -> dict:
    """``time_sweeps`` of the row sweep's calls, each record with its
    bound (bytes over the HBM rate) and the plan it ran."""
    from cuda_recommender_tpu_torch.scripts.common import PEAK_BYTES_S

    out = time_sweeps(calls, what, device, reps)
    for rec in out.values():
        rec["bound_ms"] = 1e3 * rec["bytes"] / PEAK_BYTES_S
    return out


def time_row_sweep(device, reps: int = REPS) -> dict:
    """The row sweep (see the file's head) at its shapes, in turns with
    its plain version (``time_sweeps``). Returns {"name shape what":
    record}; with {"stair job": {...}} for each stair: 40 x the sum of its
    panels' ms, the bound's, and the record's profiled K2 ms."""
    import torch

    from cuda_recommender_tpu_torch.ops import ccd_kernels as ck
    from cuda_recommender_tpu_torch.ops import panel_kernels as pk

    fp8 = torch.float8_e4m3fn
    out, stairs = {}, {}

    def k2(M, W, dtype, what):
        R, (_, _, vo, _) = nan_panel(M, W, device, seed=M + W, dtype=dtype)
        name = pk.instance_name("panel_usweep", dtype)
        print(f"[plan] {name} {M}x{W}: {_row_plan_text(R)}", flush=True)
        got = _time_row(name, {name: (
            lambda: pk.panel_usweep(R, vo),
            lambda: pk.panel_usweep_plain(R, vo),
            R.element_size() * M * W + 4 * (W + 2 * M), 3 * M * W)},
            what, device, reps)
        del R
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return next(iter(got.values()))

    for job in ROW_STAIRS:
        shapes, profiled = stair_panels(job)
        recs = []
        for i, (M, W) in enumerate(shapes):
            rec = k2(M, W, torch.bfloat16, f"{M}x{W} bf16, {job} panel {i}")
            out[f"panel_usweep {M}x{W} bf16 {job} panel {i}"] = rec
            recs.append(rec)
        ms = (None if recs[0]["ms"] is None else
              ROW_K * sum(r["ms"] for r in recs))
        bound = ROW_K * sum(r["bound_ms"] for r in recs)
        stairs[f"stair {job}"] = {"ms_per_iter": ms,
                                  "bound_ms_per_iter": bound,
                                  "profiled_ms_per_iter": profiled}
        print(f"[stair] {job}: K2 {ROW_K} x the panels' ms = "
              + ("not measured" if ms is None else f"{ms:.1f} ms")
              + f" an iteration, bound {bound:.1f} ms, the record's "
              f"profiled K2 {profiled} ms", flush=True)
    for M, W in dict.fromkeys(HEADLINE_PANELS + NAN_SHAPES):
        out[f"panel_usweep {M}x{W} bf16"] = k2(M, W, torch.bfloat16,
                                               f"{M}x{W} bf16")
    M, W = NAN_SHAPES[0]
    out[f"panel_usweep_fp8 {M}x{W} fp8"] = k2(M, W, fp8, f"{M}x{W} fp8")
    M, W = MASKED_SHAPE
    for dtype in (torch.float32, torch.bfloat16, fp8):
        for mdt in (torch.bfloat16, torch.int8):
            R, Mk, (_, _, va, _) = masked_panel(M, W, dtype, mdt, device,
                                                seed=7)
            name = pk.instance_name("masked_usweep", dtype)
            print(f"[plan] {name} {M}x{W}: {_row_plan_text(R)}", flush=True)
            out.update(_time_row(name, {name: (
                lambda: ck.masked_usweep(R, Mk, va),
                lambda: ck.masked_usweep_plain(R, Mk, va),
                M * W * (R.element_size() + Mk.element_size())
                + 4 * (W + 2 * M), 4 * M * W)},
                f"{M}x{W} {str(dtype)[6:]}, {str(mdt)[6:]} mask", device,
                reps))
            del R, Mk
            if device.type == "cuda":
                torch.cuda.empty_cache()
    out.update(stairs)
    return out


def fp8_outputs(device, seed: int = 5) -> dict:
    """Each fp8 instance run once on one seeded input at FP8_OUTPUT_SHAPE
    (a NaN panel; a masked residual beside a bf16 and an int8 mask): "name
    mask" -> the sha256 of its stored residual's bytes (the input's for
    the sweeps), g and h."""
    import hashlib

    import torch

    from cuda_recommender_tpu_torch.ops import ccd_kernels as ck
    from cuda_recommender_tpu_torch.ops import panel_kernels as pk

    fp8 = torch.float8_e4m3fn
    M, W = FP8_OUTPUT_SHAPE

    def digest(R, g, h):
        sha = hashlib.sha256()
        for x in (R.view(torch.uint8), g, h):
            sha.update(x.contiguous().cpu().numpy().tobytes())
        return sha.hexdigest()

    R0, (uo, up, vo, vp) = nan_panel(M, W, device, seed, fp8)
    out = {}
    for order in ("once", "delta_first"):
        R = R0.clone()
        out[pk.instance_name("panel_update_vsweep", fp8, order) + " nan"] = \
            digest(R, *pk.panel_update_vsweep(R, uo, up, vo, vp, order=order))
    out["panel_vsweep_fp8 nan"] = digest(R0, *pk.panel_vsweep(R0, uo))
    out["panel_usweep_fp8 nan"] = digest(R0, *pk.panel_usweep(R0, vo))
    for mdt in (torch.bfloat16, torch.int8):
        what = " " + str(mdt)[6:]
        R0, Mk, (ua, us, va, vs) = masked_panel(M, W, fp8, mdt, device, seed)
        for order in ("once", "delta_first"):
            R = R0.clone()
            out[pk.instance_name("fused_update_vsweep", fp8, order) + what] = \
                digest(R, *ck.fused_update_vsweep(R, Mk, ua, us, va, vs,
                                                  order=order))
        out["masked_vsweep_fp8" + what] = digest(
            R0, *ck.masked_vsweep(R0, Mk, ua))
        out["masked_usweep_fp8" + what] = digest(
            R0, *ck.masked_usweep(R0, Mk, va))
    return out


def hold_outputs(got: dict, path: str) -> list:
    """Writes ``got`` (``fp8_outputs``) to ``path``, or where ``path``
    exists, returns the instances whose digests differ from its."""
    if not os.path.exists(path):
        with open(path, "w") as f:
            json.dump(got, f, indent=1)
        print(f"fp8 outputs: {len(got)} digests written to {path}",
              flush=True)
        return []
    with open(path) as f:
        want = json.load(f)
    bad = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
    print(f"fp8 outputs: {len(got) - len(bad)} of {len(got)} instances "
          f"bit-equal to {path}" + (f"; differ: {bad}" if bad else ""),
          flush=True)
    return bad


def run(device) -> dict:
    """Times every kernel but the gathers; returns {"kernel shape": rate}."""
    import torch

    out = {}
    for M, W in NAN_SHAPES:
        calls = nan_sweeps(M, W, device, seed=M)
        out.update(time_sweeps(calls, f"{M}x{W} bf16", device))
        del calls
    M, W = MASKED_SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        for mdt in (torch.bfloat16, torch.int8):
            calls = masked_sweeps(M, W, dtype, mdt, device, seed=7)
            out.update(time_sweeps(
                calls, f"{M}x{W} {str(dtype)[6:]}, {str(mdt)[6:]} mask",
                device))
            del calls
    M, W = VARIANT_SHAPE
    calls = variant_sweeps(M, W, device, seed=9)
    out.update(time_sweeps(calls, f"{M}x{W} bf16, the variant's panel",
                           device))
    del calls
    for k in GJ_KS:
        calls = gj_solves(k, GJ_S, device, seed=11)
        out.update(time_sweeps(calls, f"S={GJ_S} k={k}", device, GJ_REPS))
        del calls
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="sweep_timing.py",
        description="time the column sweeps of one checkout of the port")
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(_HERE)),
                   help="the checkout to import the package from")
    p.add_argument("--device", default="cuda")
    p.add_argument("--gathers", action="store_true",
                   help="time P3's gathers instead of the sweeps and K5")
    p.add_argument("--fp8", action="store_true",
                   help="time the fp8 instances instead of the sweeps and "
                        "K5")
    p.add_argument("--streams", action="store_true",
                   help="time P1/P2's streams instead of the sweeps and K5")
    p.add_argument("--read-levers", action="store_true",
                   help="time stream_read's plan against plans without "
                        "each of its levers instead")
    p.add_argument("--row-sweep", action="store_true",
                   help="time the row sweep (K2, masked_usweep) at the "
                        "Yahoo stairs', the headline's and the dense "
                        "path's shapes instead")
    p.add_argument("--outputs", metavar="FILE",
                   help="with --fp8: write the fp8 outputs' digests to "
                        "FILE, or hold them bit-equal to it where it exists")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import cuda_recommender_tpu_torch as pkg
    from cuda_recommender_tpu_torch.core.device import resolve_device
    from cuda_recommender_tpu_torch.scripts.common import card

    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        raise RuntimeError(f"the package came from {pkg.__file__}, not from "
                           f"{root}: run each checkout in a fresh process")
    device = resolve_device(args.device)
    bad = (hold_outputs(fp8_outputs(device), args.outputs)
           if args.fp8 and args.outputs else [])
    if args.gathers:
        kernels = time_gathers(device)
    elif args.streams:
        kernels = time_streams(device)
    elif args.read_levers:
        kernels = time_read_levers(device)
    elif args.row_sweep:
        kernels = time_row_sweep(device)
    elif args.fp8:
        kernels = {key: rec for recs in time_fp8(device).values()
                   for key, rec in recs.items()}
    else:
        kernels = run(device)
    out = {"root": root, "device": card(device), "reps": REPS,
           "kernels": kernels, "outputs_differ": bad}
    print(json.dumps(out), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
