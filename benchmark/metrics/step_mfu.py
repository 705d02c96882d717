"""The whole outer step's share of the card's peak: the least time of the
PROBLEM's work over the traced window's time an iteration.

The work is counted from nnz, m, n, k and the configuration's dtypes
alone, never from panel cells or padded lanes, so that a change of layout
cannot move it (``peaks.py``):

* CCD++ (memory bound): for every rank each rating's residual is read and
  written by the update and read by the second half-sweep, and its two
  int32 ids are read: k * nnz * (3 * residual bytes + 8) over 3.35 TB/s.
* ALS: on each side every rating's (k+1)^2 augmented outer product, 2 ops
  an entry, plus each entity's k x k solve (2k^3/3 + 2k^2), over 67
  TFLOP/s in float32 ("highest"); the grams over 989 TFLOP/s where the
  configuration runs them in bfloat16.
"""

from benchmark import peaks

LAYER = "outer step"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "iter_s"


def least_seconds(ctx):
    """Least seconds of one outer iteration of the problem on the card."""
    if ctx.solver == "ccd":
        return (peaks.ccd_step_bytes(ctx.nnz, ctx.k, ctx.residual_dtype)
                / peaks.PEAK_BYTES_S)
    grams = 2 * ctx.nnz * 2 * (ctx.k + 1) ** 2
    solves = peaks.als_step_flops(ctx.nnz, ctx.rows, ctx.cols, ctx.k) - grams
    gram_peak = (peaks.PEAK_F32_FLOP_S if ctx.als_precision == "highest"
                 else peaks.PEAK_BF16_FLOP_S)
    return grams / gram_peak + solves / peaks.PEAK_F32_FLOP_S


def read(ctx):
    tr = ctx.trace
    if not tr or not tr["iterations"] or tr["window_s"] <= 0:
        return None
    return 100.0 * least_seconds(ctx) / (tr["window_s"] / tr["iterations"])
