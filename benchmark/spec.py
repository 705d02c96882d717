"""Where the harness finds a cell: everything is looked up by name.

``BENCHMARK.json`` (at the root of the checkout) names each cell's
configuration and traffic mix, and its metrics. Each of those is a file of
its own under ``benchmark/``:

* ``configs/<config>.json`` (the path BENCHMARK.json gives): the solver's
  settings, the lower-precision settings of its control, the reference
  module that judges it, its source and what was assumed;
* ``traffic/<mix>.json``: the rating matrix's dims, nnz, degree law,
  held-out share and the plan settings that dataset's record used;
* ``metrics/<metric>.py``: one reader a per-layer metric;
* ``limits/<workload>.json``: the limits of the numbers that decide
  ``correct`` in that cell, with the readings they were set from.

Adding a cell, a configuration, a mix or a metric is adding such files
and entries; no file of the harness names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list          # metric entries that this cell reports
    limits: Optional[dict]


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(spec: dict, workload: str, root: str = ROOT,
            bench_dir: str = HERE) -> Cell:
    """The cell ``workload`` of ``spec``: its configuration, traffic mix,
    metrics and limits, read from their files. Raises KeyError for a name
    that BENCHMARK.json does not hold."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have: {', '.join(sorted(cells))})")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"))
    limits_path = os.path.join(bench_dir, "limits", f"{workload}.json")
    limits = _json(limits_path) if os.path.exists(limits_path) else None
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=list(spec["end_to_end"]),
                per_layer=[m for m in spec["per_layer"]
                           if _applies(m, workload)],
                limits=limits)


def metric_reader(name: str, bench_dir: str = HERE):
    """The module of ``metrics/<name>.py``, loaded from its path (a metric
    name may hold dots)."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reference(config: dict):
    """The reference module the configuration names (``reference/<name>``)."""
    return importlib.import_module(f"benchmark.reference.{config['reference']}")
