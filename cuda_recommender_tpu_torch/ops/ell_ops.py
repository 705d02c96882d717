"""Device primitives over the degree-bucketed padded-ELL layout (data/ell.py),
for the hybrid backend's sparse tail.

The port of ``extend_zero``, ``stacked_remap``, ``fused_update_sweep`` and
``fused_sweep`` of ``cuda_recommender_tpu/ops/ell_ops.py``, as plain torch
gathers and reductions (the JAX package leaves this tail to XLA too; its
hand kernel is a later item, ROADMAP.md queue 2). They replace the
reference's CSC-segment walks (reference src/CCD.cpp:6-43). Padding is
neutralized by the zero-slot trick: padded idx entries point one past the
other side's table, where ``extend_zero`` appends a 0, so they contribute
exactly 0 with no masks.

Bucket lane geometry: a bucket stores ``p`` slots per physical row, each in a
contiguous E-lane span, L = p*E; a (rows, L) tile reshapes to (rows*p, E)
per-slot lanes. The JAX package's chunked row gathers (a TPU layout
workaround) are not ported: each bucket gathers its whole tile at once.

Index tiles are int64 tensors on the device (``EllSide`` buckets hold
int32 on the host). Residual value tiles are updated IN PLACE where the JAX
package donates them.
"""

from __future__ import annotations

import torch

from ..data.ell import EllSide


def extend_zero(table: torch.Tensor) -> torch.Tensor:
    """Append the zero slot (index n_slots) along axis 0."""
    return torch.cat([table, table.new_zeros((1,) + tuple(table.shape[1:]))])


def stacked_remap(vectors, idx: torch.Tensor) -> list:
    """Gather J equal-length vectors at one shared index ``idx``; index S
    (the vectors' length) reads 0. Returns J (idx.numel(),) tensors."""
    tab = extend_zero(torch.stack(list(vectors), dim=-1))      # (S+1, J)
    out = tab[idx]                                             # (N, J)
    return [out[:, j] for j in range(out.shape[1])]


def _slot_tail(side: EllSide) -> int:
    return side.n_slots - (side.bucket_offsets[-1]
                           + side.buckets[-1].slots_per_shard)


def _bslice(slot_vec: torch.Tensor, side: EllSide, i: int) -> torch.Tensor:
    """Slice a per-slot vector down to bucket i's slots."""
    off = side.bucket_offsets[i]
    return slot_vec[off:off + side.buckets[i].slots_per_shard]


def fused_update_sweep(idx_tiles, val_tiles, side: EllSide,
                       table_ext: torch.Tensor, owns, signs,
                       sweep_col: int):
    """One gather per bucket serving the residual update(s) AND the sweep
    partials:

        val += Σ_j signs[j] · g[..., j] · own_j        (UpdateRating,
                                                        src/CCD.cpp:18-43)
        g_s  = Σ_lanes g[..., sweep_col] · val_new     (RankOneUpdate
        h_s  = Σ_lanes g[..., sweep_col]²               numer/denom partials,
                                                        src/CCD.cpp:6-16)

    where g = table_ext[idx] is the (rows, L, T) gathered tile. ``owns``:
    per-update (n_slots,) slot vectors; ``signs``: matching floats; update
    j reads table column j; the sweep reads the UPDATED values. The value
    tiles are updated in place. Returns (g_slots, h_slots) with zero tails
    for non-bucket slots."""
    dev = table_ext.device
    if not side.buckets:
        z = torch.zeros(side.n_slots, dtype=torch.float32, device=dev)
        return z, z
    gs, hs = [], []
    for i, b in enumerate(side.buckets):
        ix, val = idx_tiles[i], val_tiles[i]
        rows, L = ix.shape
        g = table_ext[ix]                                  # (rows, L, T)
        for j, (s, own) in enumerate(zip(signs, owns)):
            ob = (_bslice(own, side, i).reshape(rows, b.p, 1)
                  .expand(rows, b.p, b.E).reshape(rows, L))
            val.add_(float(s) * g[..., j] * ob)
        sw = g[..., sweep_col]
        gs.append((sw * val).reshape(rows * b.p, b.E).sum(dim=1))
        hs.append((sw * sw).reshape(rows * b.p, b.E).sum(dim=1))
    tail = _slot_tail(side)
    if tail:
        z = torch.zeros(tail, dtype=torch.float32, device=dev)
        gs.append(z)
        hs.append(z)
    return torch.cat(gs), torch.cat(hs)


def fused_sweep(idx_tiles, val_tiles, side: EllSide, table_ext: torch.Tensor,
                sweep_col: int = 0):
    """Sweep partials without a residual update (inner iterations i > 0):
    g = Σ_lanes g_tile·val, h = Σ_lanes g_tile² per slot. Returns
    (g_slots, h_slots)."""
    dev = table_ext.device
    if not side.buckets:
        z = torch.zeros(side.n_slots, dtype=torch.float32, device=dev)
        return z, z
    gs, hs = [], []
    for i, b in enumerate(side.buckets):
        ix, val = idx_tiles[i], val_tiles[i]
        rows, L = ix.shape
        sw = table_ext[:, sweep_col][ix]
        gs.append((sw * val).reshape(rows * b.p, b.E).sum(dim=1))
        hs.append((sw * sw).reshape(rows * b.p, b.E).sum(dim=1))
    tail = _slot_tail(side)
    if tail:
        z = torch.zeros(tail, dtype=torch.float32, device=dev)
        gs.append(z)
        hs.append(z)
    return torch.cat(gs), torch.cat(hs)
