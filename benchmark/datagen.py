"""The benchmark's rating matrices, made from a seed on the device.

The semantics of the port's ``data/datasets.py::synthetic``, rewritten in
PyTorch so that a Netflix- or Yahoo-sized matrix is drawn in seconds on the
card instead of minutes of NumPy on the host:

* user and item ids follow Zipf marginals (P(rank r) proportional to
  1/r^a, a = ``user_zipf`` over users, ``item_zipf`` over items), drawn by
  inverse CDF (a cumulative sum and ``searchsorted``);
* (user, item) pairs are de-duplicated on packed keys, drawn again (twice
  as many each round) while short, shuffled, and cut to exactly
  ``train_nnz`` + the held-out count, from the mix's fixed
  ``structure_seed``; the run's seed relabels users and items by random
  permutations, so that every seed has the same degrees (the same work, in
  another order; the seed no longer changes the plan's stair or ELL
  buckets);
* each value is a rank-``truth_rank`` truth, N(0, 1/truth_rank) entries,
  plus N(0, ``noise``) plus ``offset``;
* a random ``test_share`` of the pairs is held out, counted as the JAX
  package's records count it: total = int(train / (1 - share)), held out
  = int(total * share).

Every draw comes from ``torch.Generator``s on the device it runs on, so
one seed gives one matrix on one device.
"""

from __future__ import annotations

import dataclasses

import torch

#: pairs drawn in the first round, over those missing; each later round
#: draws twice as many a missing pair (the head of both laws fills up, so
#: later draws collide more often)
OVERDRAW = 1.7
ROUNDS = 12
#: values are formed this many pairs at a time (bounds the gathered rows)
VALUE_CHUNK = 1 << 24


@dataclasses.dataclass
class Ratings:
    """A generated matrix as host COO arrays: train and held-out pairs."""

    rows: int
    cols: int
    train: tuple        # (row int32, col int32, value float32) numpy arrays
    test: tuple

    @property
    def train_nnz(self) -> int:
        return int(self.train[2].shape[0])


def counts(train_nnz: int, test_share: float) -> tuple[int, int]:
    """(total pairs, held-out pairs) for ``train_nnz`` training ratings."""
    total = int(train_nnz / (1.0 - test_share)) if test_share > 0 else train_nnz
    return total, int(total * test_share)


def _zipf_cdf(size: int, exponent: float, device) -> torch.Tensor:
    w = torch.arange(1, size + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(w.pow_(-exponent), 0)
    return cdf.div_(cdf[-1].clone())


def _draw(cdf: torch.Tensor, size: int, gen: torch.Generator) -> torch.Tensor:
    u = torch.rand(size, generator=gen, dtype=torch.float64, device=cdf.device)
    return torch.searchsorted(cdf, u).clamp_(max=cdf.shape[0] - 1)


def generate(mix: dict, seed: int, device) -> Ratings:
    """The matrix of traffic ``mix`` (its ``rows``, ``cols``,
    ``train_nnz``, ``test_share``, ``user_zipf``, ``item_zipf``,
    ``truth_rank``, ``noise``, ``offset``, ``structure_seed``) from
    ``seed`` on ``device``. The pairs and the held-out split are drawn from
    the mix's ``structure_seed``, so that every seed trains on the same
    degree sequences, the same work; ``seed`` relabels the users and the
    items by random permutations and draws the truth, the noise and the
    order of the ratings. Raises ValueError where the dims cannot hold that
    many distinct pairs within the draw rounds."""
    m, n = int(mix["rows"]), int(mix["cols"])
    total, n_test = counts(int(mix["train_nnz"]), float(mix["test_share"]))
    if total > m * n:
        raise ValueError(f"{total} pairs do not fit a {m} x {n} matrix")
    dev = torch.device(device)
    shape = torch.Generator(device=dev).manual_seed(int(mix["structure_seed"]))
    cu = _zipf_cdf(m, float(mix["user_zipf"]), dev)
    ci = _zipf_cdf(n, float(mix["item_zipf"]), dev)
    keys = torch.empty(0, dtype=torch.int64, device=dev)
    for rnd in range(ROUNDS):
        need = total - keys.shape[0]
        if need <= 0:
            break
        size = int(need * OVERDRAW * 2 ** rnd) + 16
        new = _draw(cu, size, shape).mul_(n).add_(_draw(ci, size, shape))
        keys = torch.unique(torch.cat([keys, new]))
        del new
    if keys.shape[0] < total:
        raise ValueError(f"only {keys.shape[0]} distinct pairs of {total} "
                         f"after {ROUNDS} rounds")
    del cu, ci
    # the first n_test pairs of this shuffle are the held-out ones
    keys = keys[torch.randperm(keys.shape[0], generator=shape,
                               device=dev)[:total]]

    gen = torch.Generator(device=dev).manual_seed(int(seed))
    u = torch.randperm(m, generator=gen, device=dev)[keys // n]
    i = torch.randperm(n, generator=gen, device=dev)[keys % n]
    del keys
    r = int(mix["truth_rank"])
    Wt = torch.randn((m, r), generator=gen, device=dev).mul_(r ** -0.5)
    Ht = torch.randn((n, r), generator=gen, device=dev).mul_(r ** -0.5)
    vals = torch.empty(total, dtype=torch.float32, device=dev)
    for s in range(0, total, VALUE_CHUNK):
        e = slice(s, s + VALUE_CHUNK)
        vals[e] = (Wt[u[e]] * Ht[i[e]]).sum(dim=1)
    del Wt, Ht
    vals.add_(torch.randn(total, generator=gen, device=dev),
              alpha=float(mix["noise"])).add_(float(mix["offset"]))
    held = torch.randperm(n_test, generator=gen, device=dev)
    kept = torch.randperm(total - n_test, generator=gen, device=dev) + n_test

    def host(sel):
        return (u[sel].to(torch.int32).cpu().numpy(),
                i[sel].to(torch.int32).cpu().numpy(),
                vals[sel].cpu().numpy())

    out = Ratings(rows=m, cols=n, train=host(kept), test=host(held))
    del u, i, vals, held, kept
    return out
