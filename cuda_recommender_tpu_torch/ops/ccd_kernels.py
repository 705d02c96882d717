"""Fused CCD++ passes over an explicit-mask residual (dense backend, and the
hybrid backend's bfloat16/int8-mask panels).

Three kernels, each beside its plain PyTorch version:

  * ``fused_update_vsweep`` (K4) — ONE read-modify-write pass: applies the
    deferred-subtract + add-back delta to the residual IN PLACE (the JAX
    package aliases the buffer; the port writes it),
        s = R + fl(fl(u_add·v_add − u_sub·v_sub)·M),  R' = round(s),
    and returns the v-sweep partials of the UNROUNDED sum:
        g[j] = Σ_i u_add[i]·s[i,j],  h[j] = Σ_i fl(u_add[i]²)·M[i,j].
    At bf16 this differs from K1, which sweeps the stored value.
  * ``masked_vsweep`` — the v-sweep partials alone (inner iterations
    i > 0): g = Rᵀu, h = Mᵀ(u²), one read pass.
  * ``masked_usweep`` — the u-sweep partials: g = R·v, h = M·(v²), one read
    pass.

K4 replaces the Pallas kernel ``cuda_recommender_tpu/ops/ccd_pallas.py::
fused_update_vsweep``; the two sweeps replace the XLA einsums of
``cuda_recommender_tpu/solvers/ccd_dense.py::_half_sweep`` (no TPU kernel:
eager PyTorch has no cross-op fusion, so without them the plain version
would be the main path). The CUDA C++ source is ``csrc/panel_kernels.cu``
(the explicit-mask instances of the NaN-sentinel panel kernels' bodies); it
says what bounds them on an H100. The residual is float32 or bfloat16, the
mask bfloat16 or int8 with {0,1} values and the residual's shape; unobserved
residual cells hold 0 and stay exactly 0. No block padding: the kernels
mask the ragged edge themselves.

The residual may also be float8 e4m3fn. There K4 stores in one of two
orders (``order``): "once", the Pallas kernel's (above; the pallas
backend), or "delta_first", the order of the JAX package's XLA update ``R
+ (delta·M).astype(dtype)`` (the dense backend, the explicit-mask hybrid,
the sharded hybrid without the panel kernel): R' = round(R + round(delta·M))
and the sums read R'. An fp8 store never saturates (ops/densify.py::
round_to_storage); the fp8 instances count under names of their own
(``panel_kernels.instance_name``).

Each wrapper takes the plain version ONLY for a tensor on the CPU; for a
CUDA tensor it launches the kernel (on the current stream) or raises, and
adds one to its count in ``ops/launches.py``.
"""

from __future__ import annotations

import torch

from .panel_kernels import (_MASK_CODE, _check, _check_order, _col_sweep,
                            _row_chunks, _row_sweep, rounded_f32, store)


def _check_mask(R: torch.Tensor, M: torch.Tensor) -> None:
    if M.dtype not in _MASK_CODE:
        raise TypeError(f"mask dtype must be bfloat16 or int8, got {M.dtype}")
    if M.shape != R.shape or M.device != R.device or not M.is_contiguous():
        raise ValueError(f"mask must be contiguous of the residual's shape "
                         f"{tuple(R.shape)} on {R.device}, got "
                         f"{tuple(M.shape)} on {M.device}")


def fused_update_vsweep(R: torch.Tensor, M: torch.Tensor,
                        u_add: torch.Tensor, u_sub: torch.Tensor,
                        v_add: torch.Tensor, v_sub: torch.Tensor, *,
                        order: str = "once"):
    """K4: masked residual update (in place) + v-sweep partials of the
    unrounded sum ("once"; of the stored value, "delta_first": fp8 only).
    R (m, n) float32/bfloat16/float8_e4m3fn, M (m, n) bfloat16/int8, u_*
    (m,) and v_* (n,) float32. Returns (g, h), each (n,) float32."""
    _check(R, (u_add, u_sub), (v_add, v_sub))
    _check_mask(R, M)
    _check_order(R, order)
    if R.device.type == "cpu":
        return fused_update_vsweep_plain(R, M, u_add, u_sub, v_add, v_sub,
                                         order=order)
    return _col_sweep("fused_update_vsweep", R, M, u_add, u_sub, v_add,
                      v_sub, order)


def masked_vsweep(R: torch.Tensor, M: torch.Tensor, u: torch.Tensor):
    """v-sweep partials g = Rᵀu, h = Mᵀ(u²), each (n,) float32."""
    _check(R, (u,))
    _check_mask(R, M)
    if R.device.type == "cpu":
        return masked_vsweep_plain(R, M, u)
    return _col_sweep("masked_vsweep", R, M, u, None, None, None)


def masked_usweep(R: torch.Tensor, M: torch.Tensor, v: torch.Tensor):
    """u-sweep partials g = R·v, h = M·(v²), each (m,) float32."""
    _check(R, (), (v,))
    _check_mask(R, M)
    if R.device.type == "cpu":
        return masked_usweep_plain(R, M, v)
    return _row_sweep("masked_usweep", R, M, v)


# ---- plain PyTorch versions (the CPU path and the kernels' oracle) ----

def fused_update_vsweep_plain(R, M, u_add, u_sub, v_add, v_sub, *,
                              order="once"):
    """Plain version of K4: the delta fl(fl(ua·va) − fl(us·vs)) times the
    mask, added to the residual in f32. "once": the in-place store rounds
    the sum ONCE to the storage dtype, and the sums read the f32 sum
    itself; "delta_first": the delta·mask is rounded to the storage dtype
    first, the sum stored rounded, and the sums read the stored value."""
    m, n = R.shape
    g = torch.zeros(n, dtype=torch.float32, device=R.device)
    h = torch.zeros_like(g)
    for r0, r1 in _row_chunks(m, n):
        blk = R[r0:r1]
        mk = M[r0:r1].to(torch.float32)
        s = torch.outer(u_add[r0:r1], v_add)
        s.sub_(torch.outer(u_sub[r0:r1], v_sub))
        s.mul_(mk)
        if order == "delta_first":
            s = rounded_f32(s, blk.dtype)
        s.add_(blk.to(torch.float32))
        store(blk, s)
        if order == "delta_first":
            s = blk.to(torch.float32)
        u = u_add[r0:r1]
        g += torch.mv(s.t(), u)
        h += torch.mv(mk.t(), u * u)
    return g, h


def masked_vsweep_plain(R, M, u):
    """Plain version of masked_vsweep."""
    m, n = R.shape
    g = torch.zeros(n, dtype=torch.float32, device=R.device)
    h = torch.zeros_like(g)
    for r0, r1 in _row_chunks(m, n):
        uu = u[r0:r1]
        g += torch.mv(R[r0:r1].to(torch.float32).t(), uu)
        h += torch.mv(M[r0:r1].to(torch.float32).t(), uu * uu)
    return g, h


def masked_usweep_plain(R, M, v):
    """Plain version of masked_usweep."""
    m, n = R.shape
    g = torch.empty(m, dtype=torch.float32, device=R.device)
    h = torch.empty_like(g)
    vv = v * v
    for r0, r1 in _row_chunks(m, n):
        g[r0:r1] = torch.mv(R[r0:r1].to(torch.float32), v)
        h[r0:r1] = torch.mv(M[r0:r1].to(torch.float32), vv)
    return g, h
