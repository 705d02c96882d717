"""The panel kernels' share of their roofline: the bytes the panels must
move (for every rank K1 reads and writes each panel cell, K2 reads it;
``peaks.panel_bytes`` over the stair of the run's ``hybrid_plan`` event)
over 3.35 TB/s, against the profiler's device time of K1
(``col_sweep_kernel``, ``col_reduce_kernel``) and K2 (``row_sweep_kernel``)
in the traced window (``ops/panel_kernels.py``, ``csrc/panel_kernels.cu``).
Bytes of padding or of a re-read are not counted, so the share cannot
pass 100% unless the kernels' time leaves out part of their work."""

from benchmark import peaks, trace

LAYER = "panel kernels K1 K2"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "iter_s"


def read(ctx):
    tr = ctx.trace
    if not tr or ctx.panels is None:
        return None
    spent = trace.layer_seconds(tr, "K1") + trace.layer_seconds(tr, "K2")
    if spent <= 0:
        return None
    nbytes = (peaks.panel_bytes(ctx.panels, ctx.k, ctx.residual_dtype)
              * tr["iterations"])
    return 100.0 * nbytes / peaks.PEAK_BYTES_S / spent
