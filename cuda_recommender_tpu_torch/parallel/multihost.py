"""Process-group set-up and rank-local block placement.

The port of ``cuda_recommender_tpu/parallel/multihost.py``. The JAX package
runs N devices from one process and adds ``jax.distributed`` for more than
one host; the port runs ONE PROCESS PER GPU, started by ``torchrun`` or by
any launcher that sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT`` (``launch.py`` is one for local ranks),
with ``torch.distributed`` over NCCL on the card and gloo on the CPU. Rank r
trains on ``cuda:{LOCAL_RANK}`` unless the caller passes ``device="cpu"``.

Each rank feeds only its own shard's blocks (``local_shard_ids`` is
``[rank]``); ``assemble_global`` gathers the ranks' blocks for results and
checkpoints. The reference has no distributed story (single GPU,
reference cuda_src/CCD_CUDA.cu:170).
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device
from .collectives import all_gather_rows, gather_rows

#: the launcher's environment (torchrun's names)
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT")
#: seconds a collective waits for a missing peer before it fails (a rank
#: that raised leaves its peers in a collective: they fail, not hang)
TIMEOUT_S = 300


def launched() -> bool:
    """Whether a launcher's environment names this process's rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def rank_device(device) -> torch.device:
    """The device of this rank: ``cuda:{LOCAL_RANK}`` for an unindexed
    CUDA ``device``, else ``device`` itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _init(device, backend: Optional[str], **kw) -> torch.device:
    dev = rank_device(resolve_device(device))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)        # before NCCL starts
    dist.init_process_group(backend or default_backend(dev),
                            timeout=datetime.timedelta(seconds=TIMEOUT_S),
                            **kw)
    return dev


def initialize(device="cuda", *, backend: Optional[str] = None) -> bool:
    """``init_process_group`` from the launcher's environment: NCCL for a
    CUDA ``device``, gloo for the CPU (or ``backend``), the collectives'
    timeout ``TIMEOUT_S``. A CUDA device that is missing raises; nothing
    falls back to the CPU or to gloo. No-op (returns False) when the
    group exists already or no launcher's environment is set, as the JAX
    package's ``initialize`` is without a coordinator."""
    if dist.is_initialized() or not launched():
        return False
    _init(device, backend, init_method="env://")
    return True


def free_port() -> int:
    """A free TCP port on localhost (bind to port 0)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize_local(device="cuda", *,
                     backend: Optional[str] = None) -> torch.device:
    """A process group of this one process (world size 1) on a free local
    port, without a launcher: the sharded paths then run their collectives
    over one rank. Returns the rank's device."""
    return _init(device, backend,
                 init_method=f"tcp://localhost:{free_port()}", rank=0,
                 world_size=1)


def shutdown() -> None:
    """Destroy the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_shard_ids(mesh=None) -> list[int]:
    """Global shard indices this process owns: ``[rank]``."""
    return [dist.get_rank()]


def assemble_global(local_block: torch.Tensor, *, to_all: bool = True,
                    group=None):
    """The ranks' blocks (equal shapes, shard-major on axis 0) stitched
    into the global array: a tensor on every rank (``to_all``), or a host
    array on rank 0 and None on the others."""
    if to_all:
        return all_gather_rows(local_block, group)
    parts = gather_rows(local_block, group)
    return None if parts is None else np.concatenate(parts)


def shard_rows_for_process(arr: np.ndarray, num_shards: Optional[int] = None
                           ) -> list[np.ndarray]:
    """A full array's axis-0 block of this process, as a one-element list
    (the JAX package's list of local blocks; testing and single-host
    convenience: real multi-host loaders read only their rows)."""
    n = num_shards or dist.get_world_size()
    if arr.shape[0] % n:
        raise ValueError("axis 0 not divisible by mesh size")
    per = arr.shape[0] // n
    return [arr[i * per:(i + 1) * per] for i in local_shard_ids()]
