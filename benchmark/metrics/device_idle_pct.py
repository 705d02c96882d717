"""The share of the traced window in which no kernel ran on the card: one
less the union of the profiler's kernel intervals over the window's host
seconds."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "iter_s"


def read(ctx):
    tr = ctx.trace
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
