"""Device primitives over the degree-bucketed padded-ELL layout (data/ell.py),
for the hybrid backend's sparse tail.

The port of ``extend_zero``, ``stacked_remap``, ``fused_update_sweep``,
``fused_sweep``, ``deferred_sweep``, ``deferred_flush``,
``fused_remap_combine``, ``lanes_to_slots``, ``slots_to_lanes``,
``bucket_slot_ranges``, ``sweep_partials`` and ``residual_update`` of
``cuda_recommender_tpu/ops/ell_ops.py``, as plain torch gathers and
reductions (the JAX package leaves this tail to XLA too; its hand kernel is
a later item, ROADMAP.md queue 2). The fused pair serves the hybrid tail's
and pure ELL's fused schedule; the deferred three the hybrid's
rank-deferred tail (``hybrid_defer_group``); the unfused ones their
phase-timing mode (solvers/phase_loop.py). They replace the reference's
CSC-segment walks (reference src/CCD.cpp:6-43). Padding is neutralized by
the zero-slot trick: padded idx entries point one past the other side's
table, where ``extend_zero`` appends a 0, so they contribute exactly 0
with no masks.

Bucket lane geometry: a bucket stores ``p`` slots per physical row, each in a
contiguous E-lane span, L = p*E; a (rows, L) tile reshapes to (rows*p, E)
per-slot lanes. The JAX package's chunked row gathers (its ``lax.map``
chunks, a TPU layout workaround) are not ported: each bucket gathers its
whole tile at once.

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


def bucket_slot_ranges(side: EllSide) -> list[tuple[int, int]]:
    """Global slot [start, stop) of each bucket (single-shard layout, where
    bucket slots are contiguous)."""
    assert side.num_shards == 1, "global contiguous ranges need num_shards=1"
    return [(off, off + b.slots_per_shard)
            for off, b in zip(side.bucket_offsets, side.buckets)]


def _slot_tail(side: EllSide) -> int:
    """Slots after the last bucket (padding slots of empty entities)."""
    return side.n_slots - bucket_slot_ranges(side)[-1][1]


def _bslice(slot_vec: torch.Tensor, side: EllSide, i: int) -> torch.Tensor:
    """Slice a per-slot vector down to bucket i's slots."""
    start, stop = bucket_slot_ranges(side)[i]
    return slot_vec[start:stop]


def lanes_to_slots(lanes: torch.Tensor, b) -> torch.Tensor:
    """(rows, L) -> per-slot sums (rows*p,), slot-ordered."""
    return lanes.reshape(lanes.shape[0] * b.p, b.E).sum(dim=1)


def slots_to_lanes(slot_vals: torch.Tensor, b) -> torch.Tensor:
    """Per-slot values (rows*p,) -> (rows, L) with each slot's value
    broadcast across its E lanes."""
    rows = slot_vals.shape[0] // b.p
    return (slot_vals.reshape(rows, b.p, 1).expand(rows, b.p, b.E)
            .reshape(rows, b.L))


def _with_tail(parts: list, side: EllSide, device) -> torch.Tensor:
    """Concatenate per-bucket slot vectors and the zero tail."""
    tail = _slot_tail(side)
    if tail:
        parts = parts + [torch.zeros(tail, dtype=torch.float32,
                                     device=device)]
    return torch.cat(parts)


def sweep_partials(idx_tiles, val_tiles, side: EllSide, other_ext):
    """Per-slot sweep partial sums WITHOUT the division:
    g = Σ other[idx]·val, h = Σ other[idx]² as full slot vectors (zero
    tail for non-bucket slots). Returns (g, h)."""
    dev = other_ext.device
    if not side.buckets:
        z = torch.zeros(side.n_slots, dtype=torch.float32, device=dev)
        return z, z
    gs, hs = [], []
    for i, b in enumerate(side.buckets):
        og = other_ext[idx_tiles[i]]
        gs.append(lanes_to_slots(og * val_tiles[i], b))
        hs.append(lanes_to_slots(og * og, b))
    return _with_tail(gs, side, dev), _with_tail(hs, side, dev)


def residual_update(idx_tiles, val_tiles, side: EllSide, other_ext,
                    own_slots: torch.Tensor, sign: float) -> None:
    """Residual maintenance (UpdateRating, src/CCD.cpp:18-43), IN PLACE:
    val[j, e] += sign · other[idx[j, e]] · own[j] per bucket tile. Padded
    lanes gather 0 so they stay exactly 0."""
    for i, b in enumerate(side.buckets):
        og = other_ext[idx_tiles[i]]
        ob = slots_to_lanes(_bslice(own_slots, side, i), b)
        val_tiles[i].add_(float(sign) * og * ob)


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
        val = val_tiles[i]
        g = table_ext[idx_tiles[i]]                        # (rows, L, T)
        for j, (s, own) in enumerate(zip(signs, owns)):
            ob = slots_to_lanes(_bslice(own, side, i), b)
            val.add_(float(s) * g[..., j] * ob)
        sw = g[..., sweep_col]
        gs.append(lanes_to_slots(sw * val, b))
        hs.append(lanes_to_slots(sw * sw, b))
    return _with_tail(gs, side, dev), _with_tail(hs, side, dev)


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
        val = val_tiles[i]
        sw = table_ext[:, sweep_col][idx_tiles[i]]
        gs.append(lanes_to_slots(sw * val, b))
        hs.append(lanes_to_slots(sw * sw, b))
    return _with_tail(gs, side, dev), _with_tail(hs, side, dev)


def deferred_sweep(idx_tiles, val_tiles, side: EllSide,
                   table_ext: torch.Tensor):
    """Sweep against a FROZEN residual plus deferred rank-1 corrections:
    ``table_ext`` (S+1, T) holds the sweep vector in column 0 and the
    group's deferred update vectors in columns 1..T-1, and per slot

        S_0 = Σ_lanes col0 · val,  S_c = Σ_lanes col0 · col_c,
        h   = Σ_lanes col0²

    (RankOneUpdate's numerator against the frozen values, its
    cross-terms, its denominator; src/CCD.cpp:6-16). The caller rebuilds
    the partials against the current residual as g = S_0 + Σ_c sign_c ·
    own_c · S_c (``fused_remap_combine``). Returns (S_0, [S_1..S_{T-1}],
    h) as full slot vectors with zero tails."""
    T = int(table_ext.shape[1])
    dev = table_ext.device
    if not side.buckets:
        z = torch.zeros(side.n_slots, dtype=torch.float32, device=dev)
        return z, [z] * (T - 1), z
    s0s, cross, hs = [], [], []
    for i, b in enumerate(side.buckets):
        g = table_ext[idx_tiles[i]]                        # (rows, L, T)
        sw = g[..., 0]
        s0s.append(lanes_to_slots(sw * val_tiles[i], b))
        # column 0 of the product is sw², the rest the cross-terms
        prod = (g * sw[..., None]).reshape(-1, b.E, T).sum(dim=1)
        hs.append(prod[:, 0])
        cross.append(prod[:, 1:])
    tail = _slot_tail(side)
    cat = torch.cat(cross)
    if tail:
        cat = torch.cat([cat, cat.new_zeros((tail, T - 1))])
    return (_with_tail(s0s, side, dev), list(cat.unbind(1)),
            _with_tail(hs, side, dev))


def deferred_flush(idx_tiles, val_tiles, side: EllSide,
                   table_ext: torch.Tensor, owns: torch.Tensor,
                   signs) -> None:
    """Apply a group of deferred rank-1 residual updates in ONE pass, IN
    PLACE: val += Σ_c signs[c] · table[idx][..., c] · owns[c][slot] per
    lane (UpdateRating, src/CCD.cpp:18-43, batched over the group), the
    terms added in the order of c. ``owns``: (2G, n_slots) slot-space own
    vectors; ``signs``: length-2G floats."""
    for i, b in enumerate(side.buckets):
        g = table_ext[idx_tiles[i]]                        # (rows, L, 2G)
        val = val_tiles[i]
        for c, sgn in enumerate(signs):
            ob = slots_to_lanes(_bslice(owns[c], side, i), b)
            val.add_(float(sgn) * g[..., c] * ob)


def fused_remap_combine(S_vecs, h_vec: torch.Tensor, idx: torch.Tensor,
                        weights: torch.Tensor, signs) -> tuple:
    """Slot -> entity remap of ``deferred_sweep``'s outputs with the
    corrections combined:

        g_e[e] = S_0[idx[e]]
                 + Σ_c signs[c] · weights[c, e] · S_{c+1}[idx[e]]
        h_e[e] = h[idx[e]]

    ``S_vecs``: the 2G + 1 slot vectors (S_0 first); ``weights``: (2G, N)
    entity-indexed deferred own values; ``idx``: (N,) slot ids (n_slots
    reads the appended zero row). Returns (g_e (N,), h_e (N,))."""
    gt = extend_zero(torch.stack(list(S_vecs) + [h_vec], dim=-1))[idx]
    ge = gt[:, 0]
    for c, sgn in enumerate(signs):
        ge = ge + float(sgn) * weights[c] * gt[:, c + 1]
    return ge, gt[:, -1]
