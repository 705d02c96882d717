"""One reader a per-layer metric, each in ``<metric name>.py``, found by the
name BENCHMARK.json gives it (``spec.metric_reader``).

A reader module states its ``LAYER``, ``UNIT``, ``SOURCE`` and ``MOVES``
(the end-to-end metric it should move) and defines ``read(ctx)``, which
returns the metric's value or None where the run gave it nothing to read.
``ctx`` (``cell.MetricContext``) carries the problem's sizes and
settings, the solver's set-up events of both calls, and the traced
window's reduction (``trace.reduce_events``) with the iterations it held.
"""
