"""The ALS gram assembly's share of its roofline: ``peaks.assembly_bound``
(the port's ``scripts/common.py::assembly_bound``, copied) at the problem's
nnz, its m + n entities and the configuration's precision, against the
device time an iteration of every kernel but K5 in the traced window: the
gathers and the gram ``bmm`` of ``solvers/als_ell.py``, and with them the
casts, the zeroing of empty slots and the test RMSE, which are small."""

from benchmark import peaks, trace

LAYER = "ALS gram assembly"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "iter_s"


def read(ctx):
    tr = ctx.trace
    if not tr or ctx.solver != "als" or not tr["iterations"]:
        return None
    total = sum(s for _, s, _ in tr["kernels"])
    rest = total - trace.layer_seconds(tr, "K5")
    if rest <= 0:
        return None
    bound_ms, _ = peaks.assembly_bound(ctx.nnz, ctx.rows + ctx.cols, ctx.k,
                                       ctx.als_precision)
    return 100.0 * bound_ms / (1e3 * rest / tr["iterations"])
