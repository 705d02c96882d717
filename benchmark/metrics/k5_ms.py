"""Device ms an outer iteration of K5, the batched Gauss-Jordan solve
(``gj_rows_kernel``, ``gj_slots_kernel``; ``ops/gj_kernels.py``,
``csrc/gj_kernels.cu``), from the profiler's trace of the traced window."""

from benchmark import trace

LAYER = "K5 Gauss-Jordan solve"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "iter_s"


def read(ctx):
    tr = ctx.trace
    if not tr or not tr["iterations"]:
        return None
    spent = trace.layer_seconds(tr, "K5")
    return 1e3 * spent / tr["iterations"] if spent > 0 else None
