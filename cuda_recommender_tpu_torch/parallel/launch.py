"""Start N local ranks of a Python command, as ``torchrun --standalone``
does, wait for all of them and return each rank's output (the multi-rank
tests and the smoke's two ranks on one card).

Each rank gets the launcher's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR=localhost``,
``MASTER_PORT``, a free port). When one rank exits non-zero or the time
limit passes, every rank still running is killed: a rank that raised
leaves its peers waiting in a collective, and no rank outlives the call.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

from .multihost import free_port


def run_ranks(args: Sequence[str], world: int, *, timeout: float,
              local_ranks: Optional[Sequence[int]] = None,
              env: Optional[dict] = None,
              cwd: Optional[str] = None) -> list[tuple[int, str]]:
    """Run ``python args...`` as ranks 0..world-1 and return each rank's
    (exit code, stdout + stderr). ``local_ranks`` sets each rank's
    ``LOCAL_RANK`` (its card; default the rank). Raises TimeoutError after
    ``timeout`` seconds, the ranks killed."""
    port = free_port()
    local_ranks = list(local_ranks or range(world))
    outs = [tempfile.TemporaryFile(mode="w+") for _ in range(world)]
    procs = []
    try:
        for r in range(world):
            e = dict(os.environ, **(env or {}), RANK=str(r),
                     WORLD_SIZE=str(world), LOCAL_RANK=str(local_ranks[r]),
                     LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                     MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                [sys.executable, *args], env=e, cwd=cwd, stdout=outs[r],
                stderr=subprocess.STDOUT, text=True))
        t_end = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break                        # a rank failed: stop its peers
            if time.monotonic() > t_end:
                raise TimeoutError(f"ranks still running after {timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    res = []
    for p, f in zip(procs, outs):
        f.seek(0)
        res.append((p.returncode, f.read()))
        f.close()
    return res

