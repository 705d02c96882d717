"""What the measurement scripts and the bench share: the card's peak rate,
its name and power limit, CUDA-event timing and device-side test panels.

Times come only from the card: on the CPU ``time_ms`` runs the call once,
so that the path is exercised, and returns None ("not measured").
"""

from __future__ import annotations

import itertools
import subprocess

import torch

from ..ops.launches import add_launches, launch_counts

#: the H100 SXM data sheet's HBM rate (700 W); every share is against it
PEAK_BYTES_S = 3.35e12
#: the data sheet's f32 rate outside the tensor cores and dense bf16
#: tensor-core rate (700 W), FLOP/s
PEAK_F32_FLOP_S = 67e12
PEAK_BF16_FLOP_S = 989e12
#: bytes that a timing loop cycles through so that its inputs come from
#: device memory, not the 50 MB L2
COLD_BYTES = 128 << 20


def card(device: torch.device) -> dict:
    """The device a record ran on: platform, name and, on the card, its
    name and power limit as ``nvidia-smi --query-gpu=name,power.limit``
    gives them."""
    if device.type != "cuda":
        return {"platform": "cpu", "name": "cpu"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return {"platform": "gpu", "name": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(), "smi": smi}


def assembly_bound(nnz: int, slots: int, k: int, precision: str) -> tuple:
    """(ms, what bounds it): the least time of one ALS outer iteration's
    gram and rhs assembly (the gathers and the products) at
    ``precision``. Its inputs are each rating's lane index (int64) and
    value (f32) on both sides, read once; its output the (k+1)² augmented
    gram of every slot, f32, written once; its work 2·(k+1)² operations a
    rating and side, in f32 outside the tensor cores ("highest") or bf16
    on them (one pass; three for "high")."""
    nbytes = 2 * nnz * 12 + slots * (k + 1) ** 2 * 4
    flops = 2 * nnz * 2 * (k + 1) ** 2
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = (flops / PEAK_F32_FLOP_S if precision == "highest" else
             flops * (3 if precision == "high" else 1) / PEAK_BF16_FLOP_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, device: torch.device, reps: int = 20, warmup: int = 3,
            graph: bool = False) -> float | None:
    """Mean ms per call of ``fn`` over ``reps`` back-to-back calls after
    ``warmup`` untimed ones, by CUDA events on the card; on the CPU one
    untimed call and None. With ``graph`` the ``reps`` calls are captured
    into one CUDA graph and timed by its replay: for calls whose device
    time is below the host's cost of issuing them (tens of µs through
    Python), where back-to-back calls would time the host. The graph is
    replayed twice (warm, then timed), and the launch counts follow the
    replays: each captured launch counts twice (the capture ran none)."""
    if device.type != "cuda":
        fn()
        return None
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        torch.cuda.synchronize(device)
        g = torch.cuda.CUDAGraph()
        before = launch_counts()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        captured = {name: n - before[name]
                    for name, n in launch_counts().items()}
        g.replay()
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        # the wrappers counted the capture once; the second replay's
        add_launches(captured)
        del g
    else:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / reps


def cold_copies(x: torch.Tensor) -> list:
    """``x`` and copies of it, COLD_BYTES in all on the card (one on the
    CPU), to cycle through in a timing loop."""
    if x.device.type != "cuda":
        return [x]
    n = max(1, -(-COLD_BYTES // (x.numel() * x.element_size())))
    return [x] + [x.clone() for _ in range(n - 1)]


def cycling(calls):
    """A call of the next of ``calls`` each time."""
    it = itertools.cycle(calls)
    return lambda: next(it)()


def rate(nbytes: float, ms: float | None) -> dict:
    """ms, GB/s and share of PEAK_BYTES_S of a call that moves ``nbytes``
    (None where the time was not measured)."""
    if ms is None:
        return {"ms": None, "GB_s": None, "share_of_peak": None}
    bps = nbytes / (ms / 1e3)
    return {"ms": ms, "GB_s": bps / 1e9, "share_of_peak": bps / PEAK_BYTES_S}


def device_panel(M: int, W: int, device: torch.device, seed: int = 0,
                 scale: float = 1e-3) -> torch.Tensor:
    """An (M, W) bfloat16 panel of scaled standard normals, drawn on the
    device from a ``torch.Generator`` seed (a host-side draw of a 6e9-cell
    panel would cost tens of GB of host memory; the streams' cost does not
    depend on the values)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    R = torch.randn((M, W), generator=gen, device=device,
                    dtype=torch.bfloat16)
    return R.mul_(scale)


def device_vector(n: int, device: torch.device, seed: int) -> torch.Tensor:
    """A length-``n`` float32 vector of standard normals from a seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(n, generator=gen, device=device)
