"""Host seconds of the solver's plan: the hybrid's stair and ELL tail
(``solvers/ccd_hybrid.py::plan_oriented``, ``data/ell.py``, ``native/``),
or ALS's ELL layout (``data/ell.py::build_ell_pair``), summed over the
set-up's calls of the entry: the ``plan_s`` of their ``hybrid_plan`` or
``als_plan`` events."""

LAYER = "host plan"
UNIT = "s"
SOURCE = "program_span"
MOVES = "setup_s"


def read(ctx):
    spans = [e["plan_s"] for e in ctx.plan_events]
    return sum(spans) if spans else None
