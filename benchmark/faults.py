"""Faults planted in the program underneath a run, to show that the
comparison that decides ``correct`` catches them. Never used by the
benchmark's own runs: the fault test (``tests/test_benchmark_faults.py``)
and the calibration (``calibrate.py``) plant them.

* ``unchanged``: the outer step returns its state unchanged;
* ``half``: the step leaves half of the users' factors as they were (half
  of the batch left out);
* ``altered``: the answer is altered where it is produced: the entry
  returns the first rank of W with its sign flipped.

One chip, so there is no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half", "altered")


def _ccd_step(make, fault):
    def patched(*args, **kw):
        real = make(*args, **kw)

        def step(state):
            if fault == "unchanged":
                return state.W
            before = state.W.clone()
            out = real(state)
            state.W[:, 1::2] = before[:, 1::2]
            return out
        return step
    return patched


def _als_step(make, fault):
    def patched(*args, **kw):
        real = make(*args, **kw)

        def step(idx_r, idx_c, vals_r, vals_c, W, H, nnz_r, nnz_c):
            if fault == "unchanged":
                return W, H
            Wn, Hn = real(idx_r, idx_c, vals_r, vals_c, W, H, nnz_r, nnz_c)
            Wn = Wn.clone()
            Wn[1::2] = W[1::2]
            return Wn, Hn
        return step
    return patched


def _altered(entry, rank_major):
    def patched(*args, **kw):
        W, H, stats = entry(*args, **kw)
        W = W.copy()
        if rank_major:
            W[0] = -W[0]
        else:
            W[:, 0] = -W[:, 0]
        return W, H, stats
    return patched


@contextlib.contextmanager
def planted(fault, solver: str):
    """Plant ``fault`` (one of FAULTS, or None for none) in the program's
    ``solver`` ("ccd" or "als") for the duration of the block."""
    if fault is None:
        yield
        return
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r} (have {FAULTS})")
    from cuda_recommender_tpu_torch.solvers import als_ell, ccd_hybrid

    if solver == "ccd":
        mod, name = ccd_hybrid, ("ccd_hybrid_train" if fault == "altered"
                                 else "make_hybrid_outer_step")
        new = (_altered(getattr(mod, name), True) if fault == "altered"
               else _ccd_step(getattr(mod, name), fault))
    else:
        mod, name = als_ell, ("als_ell_train" if fault == "altered"
                              else "make_als_outer_step")
        new = (_altered(getattr(mod, name), False) if fault == "altered"
               else _als_step(getattr(mod, name), fault))
    old = getattr(mod, name)
    setattr(mod, name, new)
    try:
        yield
    finally:
        setattr(mod, name, old)
