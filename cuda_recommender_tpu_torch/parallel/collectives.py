"""The collectives of the sharded solvers, counted.

Every sharded path reaches ``torch.distributed`` through these wrappers,
and each wrapper adds one to its count per collective it issues, as
``ops/launches.py`` counts kernel launches: ``reset_collective_counts()``
just before a run and ``collective_counts()`` just after show that the run
took the sharded step (the smoke asserts 2·k·T all-reduces per hybrid
outer iteration, at any world size, world size 1 included).
``collective_bytes()`` tallies the bytes the rank passed to each kind
(``scripts/scaling_model.py`` reckons the hybrid's).

The JAX package's collectives map as ``psum`` -> ``all_reduce``,
``all_gather(tiled=True)`` -> ``all_gather_rows`` (the ranks' blocks
concatenated along axis 0, rank order = shard-major slot order); the
checkpoint and result gathers, which JAX's global arrays do implicitly,
are ``gather_rows`` (to rank 0) and ``all_gather_rows``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

#: collectives issued per wrapper since the last ``reset_collective_counts()``
COUNTS = {"all_reduce": 0, "all_gather": 0, "gather": 0}
#: bytes of the tensors this rank passed to each kind since the reset
BYTES = {"all_reduce": 0, "all_gather": 0, "gather": 0}


def _tally(name: str, x: torch.Tensor) -> None:
    COUNTS[name] += 1
    BYTES[name] += x.numel() * x.element_size()


def reset_collective_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0
        BYTES[name] = 0


def collective_counts() -> dict:
    return dict(COUNTS)


def collective_bytes() -> dict:
    return dict(BYTES)


def all_reduce_pair(g: torch.Tensor, h: torch.Tensor, group=None):
    """(g, h) summed over ``group``: ONE all-reduce of their concatenation
    (one collective per half-sweep, as the JAX package's one ``psum`` of
    the pair)."""
    buf = torch.cat([g, h])
    _tally("all_reduce", buf)
    dist.all_reduce(buf, group=group)
    return buf[:g.shape[0]], buf[g.shape[0]:]


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along axis 0, in
    group-rank order, on every rank."""
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    _tally("all_gather", x)
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, x, group=group)
    return out


def gather_rows(x: torch.Tensor, group=None) -> Optional[list]:
    """Every rank's ``x`` (equal shapes) as a list of host numpy arrays in
    group-rank order on the group's first rank; None on the others (the
    checkpoint path: one rank writes the global payload)."""
    x = x.contiguous()
    root = dist.get_global_rank(group, 0) if group is not None else 0
    mine = dist.get_rank(group) == 0
    bufs = [torch.empty_like(x) for _ in range(dist.get_world_size(group))] \
        if mine else None
    _tally("gather", x)
    dist.gather(x, bufs, dst=root, group=group)
    return [b.cpu().numpy() for b in bufs] if mine else None


def gather_arrays(arrays: dict, device, group=None) -> Optional[dict]:
    """``gather_rows`` of each host array of ``arrays`` (moved to ``device``
    for the collective): {key: [rank 0's, rank 1's, ...]} on the group's
    first rank, None on the others."""
    out = {}
    for key, arr in arrays.items():
        got = gather_rows(torch.from_numpy(np.ascontiguousarray(arr))
                          .to(device), group)
        if got is not None:
            out[key] = got
    return out if dist.get_rank(group) == 0 else None
