"""Host seconds of the solver's device set-up up to its synchronize: the
plan's tensors, the densified panels and the initial state
(``device_plan``, ``densify_panels``, ``initial_state``), or ALS's side
tensors and slot-space factors (``side_tensors``), summed over the
set-up's calls of the entry: the ``setup_s`` of their ``hybrid_plan`` or
``als_plan`` events."""

LAYER = "device set-up"
UNIT = "s"
SOURCE = "program_span"
MOVES = "setup_s"


def read(ctx):
    spans = [e["setup_s"] for e in ctx.plan_events]
    return sum(spans) if spans else None
