"""Device ms an outer iteration of every CCD++ kernel that is not K1 or K2:
the ELL tail's gathers and scatters (``ops/ell_ops.py``), the remaps, the
half-sweep divisions and the test RMSE, from the profiler's trace of the
traced window."""

from benchmark import trace

LAYER = "ELL tail and step rest"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "iter_s"


def read(ctx):
    tr = ctx.trace
    if not tr or ctx.solver != "ccd" or not tr["iterations"]:
        return None
    total = sum(s for _, s, _ in tr["kernels"])
    rest = total - trace.layer_seconds(tr, "K1") - trace.layer_seconds(tr, "K2")
    return 1e3 * rest / tr["iterations"] if total > 0 else None
