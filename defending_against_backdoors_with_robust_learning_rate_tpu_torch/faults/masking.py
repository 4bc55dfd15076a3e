"""The participation-mask protocol: aggregation over a fixed [m]-shaped
mask.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
faults/masking.py`. Every rule of ops/aggregate.py runs over an [m] bool
tensor marking which of the m sampled agents delivered a usable update
this round. Masked agents are excluded arithmetically, never by shrinking
tensors, so shapes stay fixed and one captured round serves every fault
draw (no host sync, no boolean indexing):

- sum-based rules (avg, sign, the RLR vote, RFA's weights): masked rows
  and their weights are replaced by zeros with `torch.where`, which also
  drops NaN or garbage payloads (a multiply by 0 would keep a NaN);
- sort-based rules (comed, trmean): masked rows become +inf sentinels
  that sort last; the median index and the trimmed band's start follow
  the effective count on the device;
- krum: masked rows and columns of the distance matrix are +inf, the
  neighbour count follows the effective count, and a masked candidate
  never wins.

Bit parity (JAX faults/masking.py:19-28): with an all-ones mask every
masked rule equals its dense rule in ops/aggregate.py bit for bit.
`where(True, x, s)` is x; every reduction keeps the dense rule's shape
(the trimmed mean's band has the dense band's static length L, read from
a device-side start; krum's score window is the dense slice); and a count
on the device divides by reciprocal-multiply, as the dense rules do.
"""

from __future__ import annotations

import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.aggregate import (
    RFA_EPS, RFA_ITERS, band, krum_k, sq_dist_accum, trmean_k, weiszfeld)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.tree import (
    Params, rows)


def count(mask):
    """The effective participant count, int64 on the mask's device."""
    return torch.sum(mask.to(torch.int64))


def count_f32(mask):
    return torch.sum(mask.to(torch.float32))


def zero_rows(u, mask):
    """Rows of non-participants replaced by exact zeros; `where`, not a
    multiply, so NaN or inf garbage in masked rows cannot propagate."""
    return torch.where(rows(mask, u), u, torch.zeros((), dtype=u.dtype,
                                                     device=u.device))


def zero_masked(stacked_updates: Params, mask) -> Params:
    """`zero_rows` over every leaf of a stacked update dict."""
    return {k: zero_rows(u, mask) for k, u in stacked_updates.items()}


def guard_empty(agg: Params, mask) -> Params:
    """All-invalid round (every sampled agent dropped or its payload
    rejected): the aggregate is undefined (0/0 sums, sentinel medians),
    so it becomes zeros and the round leaves the params as they were.
    Faults/Effective_Voters shows 0 for the round."""
    any_valid = torch.any(mask)
    return {k: torch.where(any_valid, a, torch.zeros_like(a))
            for k, a in agg.items()}


def rlr_threshold(cfg, mask):
    """The mask-aware RLR vote threshold: ``abs`` keeps the paper's count
    (the vote just loses the masked voters); ``scaled`` shrinks it with
    the effective electorate, threshold * n_eff / m (a 0-d tensor), so the
    agreement fraction it asks for is the same under churn."""
    thr = float(cfg.robustLR_threshold)
    if cfg.rlr_threshold_mode == "scaled":
        return thr * count_f32(mask) / mask.shape[0]
    return thr


# ------------------------------------------------------------ array level ---

def _sentinel_sort(u, mask):
    """The [m, ...] stack sorted along the agents with masked rows +inf."""
    inf = torch.full((), float("inf"), dtype=u.dtype, device=u.device)
    return torch.sort(torch.where(rows(mask, u), u, inf), dim=0).values


def median_rows(u, mask, n_eff):
    """Lower median over the participant rows of [m, ...]: the +inf
    sentinels sort last, and the median's index (n_eff-1)//2 stays on the
    device (held at 0 in an all-invalid round, which guard_empty voids)."""
    srt = _sentinel_sort(u, mask)
    idx = torch.clamp((n_eff - 1) // 2, min=0).reshape(1)
    return srt.index_select(0, idx)[0]


def trimmed_mean_rows(u, mask, n_eff, trim_k: int):
    """Coordinate-wise trimmed mean over the participant rows of [m, ...]:
    sort with +inf sentinels, then average the band [k, n_eff - k). The
    band is read as a window of the dense band's static length L from the
    device-side start k, with the positions past the effective band
    zeroed; the mean is a reciprocal-multiply of the count."""
    m = u.shape[0]
    srt = _sentinel_sort(u, mask)
    t = trmean_k(trim_k, m)
    length = m - 2 * t                                 # the dense band
    k = torch.clamp((n_eff - 1) // 2, max=int(trim_k))
    k = torch.clamp(k, min=0)
    win = band(srt, k, length)
    pos = torch.arange(length, device=u.device)
    # the count exceeds L only in the maximal-trim shapes
    # (m <= 2 * trim_k + 2): clamp, so the mean stays a mean
    cnt = torch.clamp(n_eff - 2 * k, max=length)
    inside = rows(pos < cnt, win)
    zero = torch.zeros((), dtype=win.dtype, device=win.device)
    return (torch.sum(torch.where(inside, win, zero), dim=0)
            * torch.reciprocal(cnt.to(torch.float32)))


def krum_best(dist, mask, n_eff, num_corrupt: int):
    """The masked Krum winner ([1] int64 on the device) over a clamped
    [m, m] squared-distance matrix: rows and columns of non-participants
    are +inf, the neighbour count follows the effective electorate
    (clamped to the n_eff - 1 finite neighbours of a valid row, and 0
    when a lone survivor has none), and masked candidates score +inf."""
    m = dist.shape[0]
    pair = mask[:, None] & mask[None, :]
    inf = torch.full((), float("inf"), dtype=dist.dtype, device=dist.device)
    srt = torch.sort(torch.where(pair, dist, inf), dim=1).values
    length = krum_k(m, num_corrupt)                    # the dense window
    k = torch.minimum(torch.clamp(n_eff - num_corrupt - 2,
                                  min=torch.clamp(n_eff - 1, max=1)),
                      torch.clamp(n_eff - 1, min=0))
    win = srt[:, 1:length + 1]
    sel = torch.arange(length, device=dist.device)[None, :] < k
    zero = torch.zeros((), dtype=win.dtype, device=win.device)
    scores = torch.sum(torch.where(sel, win, zero), dim=1)
    return torch.argmin(torch.where(mask, scores, inf)).reshape(1)


# ------------------------------------------------------------- dict level ---

def masked_avg(stacked_updates: Params, data_sizes, mask) -> Params:
    """Weighted FedAvg over the participants."""
    w = torch.where(mask, data_sizes.to(torch.float32),
                    torch.zeros((), device=mask.device))
    total = torch.sum(w)
    return {k: torch.sum(u * rows(w, u), dim=0) / total
            for k, u in zero_masked(stacked_updates, mask).items()}


def masked_sign(stacked_updates: Params, mask) -> Params:
    """Majority sign over the participants: zeroed rows vote sign(0) = 0."""
    return {k: torch.sign(torch.sum(torch.sign(u), dim=0))
            for k, u in zero_masked(stacked_updates, mask).items()}


def masked_comed(stacked_updates: Params, mask) -> Params:
    n_eff = count(mask)
    return {k: median_rows(u, mask, n_eff)
            for k, u in stacked_updates.items()}


def masked_trmean(stacked_updates: Params, mask, trim_k: int) -> Params:
    n_eff = count(mask)
    return {k: trimmed_mean_rows(u, mask, n_eff, trim_k)
            for k, u in stacked_updates.items()}


def masked_krum(stacked_updates: Params, mask, num_corrupt: int) -> Params:
    """Krum over the participants. The distances accumulate over zeroed
    rows, so garbage payloads cannot poison the matrix; the winner's
    update is read from the zeroed stack, its raw update for any
    participant."""
    zeroed = zero_masked(stacked_updates, mask)
    leaves = list(zeroed.values())
    m = leaves[0].shape[0]
    d = torch.zeros((m, m), dtype=torch.float32, device=mask.device)
    for u in leaves:
        d = sq_dist_accum(d, u.reshape(m, -1))
    best = krum_best(torch.clamp(d, min=0.0), mask, count(mask), num_corrupt)
    return {k: u.index_select(0, best)[0] for k, u in zeroed.items()}


def masked_rfa(stacked_updates: Params, mask, iters: int = RFA_ITERS,
               eps: float = RFA_EPS) -> Params:
    """Smoothed-Weiszfeld geometric median over the participants: the
    iterate starts from their mean, and masked agents weigh 0 in every
    step."""
    zeroed = zero_masked(stacked_updates, mask)
    inv_n = torch.reciprocal(count_f32(mask))
    v = {k: torch.sum(u.to(torch.float32), dim=0) * inv_n
         for k, u in zeroed.items()}
    return weiszfeld(zeroed, v, mask.to(torch.float32), iters, eps)


def masked_aggregate(stacked_updates: Params, data_sizes, cfg,
                     mask) -> Params:
    """The mask-aware dispatch of ops/aggregate.aggregate_updates (the
    caller adds the server noise, which does not depend on the mask)."""
    if cfg.aggr == "avg":
        return masked_avg(stacked_updates, data_sizes, mask)
    if cfg.aggr == "comed":
        return masked_comed(stacked_updates, mask)
    if cfg.aggr == "sign":
        return masked_sign(stacked_updates, mask)
    if cfg.aggr == "trmean":
        return masked_trmean(stacked_updates, mask, cfg.num_corrupt)
    if cfg.aggr == "krum":
        return masked_krum(stacked_updates, mask, cfg.num_corrupt)
    if cfg.aggr == "rfa":
        return masked_rfa(stacked_updates, mask)
    raise ValueError(f"unknown aggr {cfg.aggr!r}")
