"""Structured metrics: reference-parity stdout lines + JSONL sink.

The port's copy of ``cuda_recommender_tpu/core/metrics_log.py``; the line
formats are identical, so logs of the two packages compare line by line.

The reference's observability is printf-only (SURVEY.md §5): a per-outer-
iteration line (src/CCD.cpp:158, src/ALS.cpp:229) and [info] phase lines in
the driver (src/main.cpp:100-160). We reproduce those line shapes for
comparability and add a machine-readable JSONL stream.
"""

from __future__ import annotations

import json
import time
from typing import IO, Optional


class MetricsLog:
    def __init__(self, path: Optional[str] = None, *, echo: bool = True):
        self.echo = echo
        self._fp: Optional[IO[str]] = open(path, "a") if path else None

    def event(self, kind: str, **fields) -> None:
        if self._fp:
            rec = {"ts": time.time(), "kind": kind, **fields}
            self._fp.write(json.dumps(rec) + "\n")
            self._fp.flush()

    def info(self, msg: str, **fields) -> None:
        if self.echo:
            print(msg, flush=True)
        self.event("info", msg=msg, **fields)

    def iteration(self, solver: str, backend: str, oiter: int, rmse: float,
                  rank_time: float, rank_time_acc: float,
                  update_time: float = 0.0, update_time_acc: float = 0.0,
                  rmse_time=None) -> None:
        """Reference iteration-line parity: CCD prints rank_time and
        update_time (src/CCD.cpp:158), ALS only update_time (src/ALS.cpp:229).

        ``rmse_time`` is printed only when the caller actually measured it
        (the field is omitted rather than printed as a fake 0)."""
        if self.echo:
            t = "" if rmse_time is None else (" time:%fs" % rmse_time)
            if solver == "ccd":
                print("[-INFO-] iteration num %d \trank_time %.4f|%.4f s "
                      "\tupdate_time %.4f|%.4fs \tRMSE=%f%s"
                      % (oiter, rank_time, rank_time_acc, update_time,
                         update_time_acc, rmse, t), flush=True)
            else:
                print("[-INFO-] iteration num %d \tupdate_time %.4f|%.4fs "
                      "\tRMSE=%f%s"
                      % (oiter, update_time, update_time_acc, rmse, t),
                      flush=True)
        self.event("iteration", solver=solver, backend=backend, oiter=oiter,
                   rmse=rmse, rank_time=rank_time, update_time=update_time,
                   **({} if rmse_time is None else {"rmse_time": rmse_time}))

    def rank(self, solver: str, backend: str, oiter: int, t: int,
             rank_time: float, rmse=None) -> None:
        """Per-rank verbose line (the reference's commented verbose path,
        src/CCD.cpp:141-148: ``iter %d rank %d time %f[ rmse %f]``)."""
        if self.echo:
            line = "iter %d rank %d time %f" % (oiter, t + 1, rank_time)
            if rmse is not None:
                line += " rmse %f" % rmse
            print(line, flush=True)
        self.event("rank", solver=solver, backend=backend, oiter=oiter,
                   rank=t, rank_time=rank_time,
                   **({} if rmse is None else {"rmse": rmse}))

    def close(self) -> None:
        if self._fp:
            self._fp.close()
            self._fp = None
