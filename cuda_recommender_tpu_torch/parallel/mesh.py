"""Device meshes over the ranks, and the block each rank holds.

The port of ``cuda_recommender_tpu/parallel/mesh.py``. A
``torch.distributed.device_mesh.DeviceMesh`` over the initialized world
takes the place of ``jax.sharding.Mesh``: 1-D (``make_mesh``, one shard a
rank) or 2-D (``make_mesh_2d``, users x items, for the dense residual).
Where the JAX package returns ``NamedSharding``s for XLA to place global
arrays, the layout helpers here describe the block THIS rank holds and the
groups its partial sums are reduced over:

* ``dense_ccd_shardings``: the residual user-row-sharded, W over users, H
  replicated; the v-sweep's column partials are all-reduced over the
  ranks, the u-sweep is local;
* ``dense_ccd_shardings_2d``: an (m/a, n/b) residual block, W over the
  user axis, H over the item axis; the v-sweep's partials are reduced over
  the user axis' group, the u-sweep's over the item axis' group;
* ``ell_shardings``: bucket rows and slot-space factors in shard-major
  order (data/ell.py), so rank s holds slot block s and
  ``collectives.all_gather_rows`` rebuilds a global table by concatenation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

#: the mesh dimension names: 1-D (shards), 2-D (users, items)
AXIS = "d"
AXES_2D = ("u", "i")


def _world(want: int, what: str) -> int:
    if not dist.is_initialized():
        raise ValueError(f"{what} needs torch.distributed initialized: run "
                         "under torchrun (parallel.multihost.initialize) or "
                         "open a local group (initialize_local)")
    world = dist.get_world_size()
    if world != want:
        raise ValueError(f"{what} needs WORLD_SIZE={want}, the world has "
                         f"{world} ranks")
    return world


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n: Optional[int] = None) -> DeviceMesh:
    """1-D mesh over all ranks; ``n``, when given, must be the world
    size."""
    world = _world(n if n is not None else dist.get_world_size(),
                   f"a mesh of {n} ranks")
    return DeviceMesh(_device_type(), torch.arange(world),
                      mesh_dim_names=(AXIS,))


def make_mesh_2d(shape: tuple[int, int]) -> DeviceMesh:
    """2-D (users, items) mesh of a·b ranks for the dense CCD path."""
    a, b = shape
    _world(a * b, f"mesh {tuple(shape)}")
    return DeviceMesh(_device_type(), torch.arange(a * b).reshape(a, b),
                      mesh_dim_names=AXES_2D)


@dataclasses.dataclass(frozen=True)
class DenseBlocks:
    """This rank's block of the dense residual: the mesh splits users in
    ``divs[0]`` and items in ``divs[1]``; the rank holds block ``coord``."""

    divs: tuple[int, int]
    coord: tuple[int, int]
    user_group: object             # ranks of this item block: v-sweep sums
    item_group: Optional[object]   # ranks of this user block: u-sweep sums


def dense_ccd_shardings(mesh: DeviceMesh) -> DenseBlocks:
    """1-D: users sharded, H replicated (JAX: rowmat P(d, None), colvec
    P())."""
    return DenseBlocks(divs=(mesh.size(), 1),
                       coord=(mesh.get_local_rank(0), 0),
                       user_group=mesh.get_group(0), item_group=None)


def dense_ccd_shardings_2d(mesh: DeviceMesh) -> DenseBlocks:
    """2-D: residual blocked (users, items), W over the user axis, H over
    the item axis (JAX: rowmat P(u, i))."""
    a, b = mesh.shape
    return DenseBlocks(divs=(a, b), coord=tuple(mesh.get_coordinate()),
                       user_group=mesh.get_group(0),
                       item_group=mesh.get_group(1))


@dataclasses.dataclass(frozen=True)
class EllBlocks:
    """This rank's shard of a shard-uniform ELL layout (or of a hybrid
    plan's N-aligned panels and tail)."""

    shard: int
    num_shards: int
    group: object


def ell_shardings(mesh: DeviceMesh) -> EllBlocks:
    if mesh.ndim != 1:
        raise ValueError("the ELL, ALS and hybrid backends shard over a "
                         "1-D mesh (make_mesh); a 2-D mesh is for the "
                         "dense backend")
    return EllBlocks(shard=mesh.get_local_rank(0), num_shards=mesh.size(),
                     group=mesh.get_group(0))
