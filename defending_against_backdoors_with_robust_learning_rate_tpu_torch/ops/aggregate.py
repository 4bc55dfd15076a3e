"""Server aggregation rules + the robust-learning-rate (RLR) defense: the
plain server step, and the oracle of the fused kernel (ops/rlr_fused.py).

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
ops/aggregate.py`; reference src/aggregation.py. Updates arrive as a dict of
per-leaf stacks `[m, ...]` over the sampled agents; every rule reduces
axis 0, leaf by leaf, so the largest leaf bounds a rule's temporaries (a
sort at m = 256 over ResNet-9's 2.36 M-value leaf holds 2.4 GB of values
and twice that of int64 indices).

- `robust_lr` (src/aggregation.py:48-54): per coordinate,
  lr = +server_lr where |sum_k sign(u_k)| >= threshold, else -server_lr.
- `agg_avg` (src/aggregation.py:57-64): data-size-weighted mean.
- `agg_comed` (src/aggregation.py:66-69): per-coordinate lower median
  (torch.median's, index (m-1)//2).
- `agg_sign` (src/aggregation.py:71-75): sign of the sum of signs.
- `agg_trmean`: coordinate-wise mean after trimming `num_corrupt` values
  at each end (Yin et al. 2018; not in the reference).
- `agg_krum`: the update with the least sum of squared distances to its
  m-f-2 nearest others (Blanchard et al. 2017; BASELINE.json configs[4]).
- `agg_rfa`: the geometric median by RFA_ITERS smoothed Weiszfeld steps
  from the unweighted mean (Pillutla et al. 2022).
- server noise (src/aggregation.py:34-35): N(0, noise*clip) on the aggregate.
- `apply_aggregate` (src/aggregation.py:38-40): global += lr * aggregate.

Every rule and `robust_lr` take an optional [m] bool participation `mask`
(faults/masking.py); None is the dense rule. The dense rules build their
windows as the masked twins do (a fresh contiguous band, a
reciprocal-multiply), so that with an all-ones mask each masked rule
equals its dense rule bit for bit. Krum's winner stays a device tensor,
read with `index_select`: no rule syncs with the host, so the server step
can sit in a captured CUDA graph. f32 throughout, as in JAX.
"""

from __future__ import annotations

import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.tree import (
    Params, rows)


def _masking():
    # faults/masking.py builds on this module's distances, as in JAX
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.faults import (
        masking)
    return masking


def rlr_from_sign_sum(sign_sum, threshold, server_lr):
    """+server_lr where |sign_sum| >= threshold, else -server_lr (f32; the
    two values are scalars of the kernel, no copy from the host, so the
    step can sit in a captured CUDA graph). `threshold` may be a 0-d
    tensor (the mask-aware scaled threshold)."""
    return torch.where(torch.abs(sign_sum) >= threshold, float(server_lr),
                       float(-server_lr)).to(torch.float32)


def robust_lr(stacked_updates: Params, threshold, server_lr: float,
              mask=None) -> Params:
    """Per-parameter learning-rate dict from the unweighted sign vote over
    the m sampled agents; with a `mask` only its agents vote (the others'
    rows are zeroed and vote sign 0)."""
    if mask is not None:
        stacked_updates = _masking().zero_masked(stacked_updates, mask)
    return {k: rlr_from_sign_sum(torch.sum(torch.sign(u), dim=0), threshold,
                                 server_lr)
            for k, u in stacked_updates.items()}


def agg_avg(stacked_updates: Params, data_sizes, mask=None) -> Params:
    """Weighted FedAvg: sum_k n_k u_k / sum_k n_k."""
    if mask is not None:
        return _masking().masked_avg(stacked_updates, data_sizes, mask)
    w = data_sizes.to(torch.float32)
    total = torch.sum(w)
    return {k: torch.sum(u * rows(w, u), dim=0) / total
            for k, u in stacked_updates.items()}


def agg_comed(stacked_updates: Params, mask=None) -> Params:
    """Per-coordinate median over the agents: with an even count the lower
    of the two middle values (torch.median's, not numpy's midpoint)."""
    if mask is not None:
        return _masking().masked_comed(stacked_updates, mask)
    # cloned out of the sorted stack, so the stack is freed leaf by leaf
    return {k: torch.sort(u, dim=0).values[(u.shape[0] - 1) // 2].clone()
            for k, u in stacked_updates.items()}


def agg_sign(stacked_updates: Params, mask=None) -> Params:
    """Majority-sign update: sign(sum_k sign(u_k))."""
    if mask is not None:
        return _masking().masked_sign(stacked_updates, mask)
    return {k: torch.sign(torch.sum(torch.sign(u), dim=0))
            for k, u in stacked_updates.items()}


def sq_dist_accum(dist, flat):
    """dist [m, m] + the pairwise squared L2 distances of the rows of flat
    [m, c] (sq-norm expansion; callers clamp negatives after the last
    accumulation)."""
    flat = flat.to(torch.float32)
    sq = torch.sum(flat * flat, dim=1)
    return dist + sq[:, None] + sq[None, :] - 2.0 * (flat @ flat.T)


def _pairwise_sq_dists(stacked_updates: Params):
    """[m, m] squared L2 distances summed over every leaf."""
    leaves = list(stacked_updates.values())
    m = leaves[0].shape[0]
    d = torch.zeros((m, m), dtype=torch.float32, device=leaves[0].device)
    for u in leaves:
        d = sq_dist_accum(d, u.reshape(m, -1))
    return torch.clamp(d, min=0.0)


def trmean_k(trim_k: int, m: int) -> int:
    """The per-end trim clamped so at least one value survives."""
    return max(0, min(int(trim_k), (m - 1) // 2))


def band(srt, start, length: int):
    """Rows start..start+length-1 of a sorted [m, ...] stack as a fresh
    contiguous tensor; `start` an int or a 0-d device tensor (the masked
    trimmed mean's traced trim). The dense and the masked trimmed mean
    both read their band through it, so their sums reduce the same
    buffer shape in the same order."""
    idx = torch.arange(length, device=srt.device) + start
    return srt.index_select(0, idx)


def agg_trmean(stacked_updates: Params, trim_k: int, mask=None) -> Params:
    """Coordinate-wise trimmed mean: drop the trim_k smallest and largest
    values per coordinate, average the rest; trim_k=0 is the unweighted
    mean. The mean is a sum times the reciprocal of the count, as the
    masked twin's traced count must take it."""
    if mask is not None:
        return _masking().masked_trmean(stacked_updates, mask, trim_k)
    out = {}
    for k, u in stacked_updates.items():
        m = u.shape[0]
        t = trmean_k(trim_k, m)
        win = band(torch.sort(u, dim=0).values, t, m - 2 * t)
        out[k] = torch.sum(win, dim=0) * (1.0 / (m - 2 * t))
    return out


def krum_k(m: int, num_corrupt: int) -> int:
    """Krum's neighbour count k = max(m - f - 2, 1)."""
    return max(m - num_corrupt - 2, 1)


def agg_krum(stacked_updates: Params, num_corrupt: int = 0,
             mask=None) -> Params:
    """Krum: the update with the least sum of squared distances to its
    k nearest others. A row's own distance (0) sorts first, so the score
    sums sorted columns 1..k, copied out contiguous as the masked twin's
    window is."""
    if mask is not None:
        return _masking().masked_krum(stacked_updates, mask, num_corrupt)
    d = _pairwise_sq_dists(stacked_updates)
    k = krum_k(d.shape[0], num_corrupt)
    srt = torch.sort(d, dim=1).values
    scores = torch.sum(srt[:, 1:k + 1].contiguous(), dim=1)
    best = torch.argmin(scores).reshape(1)
    return {name: u.index_select(0, best)[0]
            for name, u in stacked_updates.items()}


RFA_ITERS = 4       # fixed smoothed-Weiszfeld iterations (JAX's constant)
RFA_EPS = 1e-6      # smoothing floor on per-agent distances


def agent_sq_dists(stacked_updates: Params, center: Params):
    """[m] squared L2 distance of each stacked update to `center`, summed
    over every leaf."""
    total = None
    for k, u in stacked_updates.items():
        diff = u.to(torch.float32) - center[k][None].to(torch.float32)
        part = torch.sum(torch.square(diff).reshape(u.shape[0], -1), dim=1)
        total = part if total is None else total + part
    return total


def weiszfeld(stacked_updates: Params, v: Params, w0, iters: int,
              eps: float) -> Params:
    """`iters` smoothed Weiszfeld steps from `v`: agents reweighted by
    w0 / max(||u_k - v||, eps), then the weighted mean (w0 is 1, or the
    mask's 0/1 in the masked twin)."""
    for _ in range(iters):
        w = w0 * torch.reciprocal(torch.clamp(
            torch.sqrt(agent_sq_dists(stacked_updates, v)), min=eps))
        wsum = torch.sum(w)
        v = {k: torch.sum(u * rows(w, u), dim=0) / wsum
             for k, u in stacked_updates.items()}
    return v


def agg_rfa(stacked_updates: Params, iters: int = RFA_ITERS,
            eps: float = RFA_EPS, mask=None) -> Params:
    """Geometric median of the updates by the smoothed Weiszfeld algorithm
    (RFA), from the unweighted mean, for a fixed number of steps."""
    if mask is not None:
        return _masking().masked_rfa(stacked_updates, mask, iters, eps)
    m = next(iter(stacked_updates.values())).shape[0]
    v = {k: torch.sum(u.to(torch.float32), dim=0) * (1.0 / m)
         for k, u in stacked_updates.items()}
    return weiszfeld(stacked_updates, v, 1.0, iters, eps)


def gaussian_noise_like(params_like: Params, gen: torch.Generator,
                        std: float) -> Params:
    """Server DP noise N(0, std) per coordinate, drawn from `gen`."""
    return {k: torch.randn(x.shape, generator=gen, device=x.device,
                           dtype=torch.float32) * std
            for k, x in params_like.items()}


def draw_noise(params_like: Params, cfg, gen: torch.Generator):
    """The round's server noise N(0, noise * clip), drawn before the server
    step (None without noise): a captured round takes it as an input."""
    if cfg.noise <= 0:
        return None
    return gaussian_noise_like(params_like, gen, cfg.noise * cfg.clip)


def aggregate_updates(stacked_updates: Params, data_sizes, cfg,
                      noise: Params | None = None, mask=None) -> Params:
    """Dispatch on cfg.aggr, plus the server noise (src/aggregation.py:
    26-35), drawn beforehand by `draw_noise`. A `mask` routes every rule
    through its masked twin (faults/masking.masked_aggregate); the noise
    is added after either."""
    if mask is not None:
        agg = _masking().masked_aggregate(stacked_updates, data_sizes, cfg,
                                          mask)
    elif cfg.aggr == "avg":
        agg = agg_avg(stacked_updates, data_sizes)
    elif cfg.aggr == "comed":
        agg = agg_comed(stacked_updates)
    elif cfg.aggr == "sign":
        agg = agg_sign(stacked_updates)
    elif cfg.aggr == "trmean":
        agg = agg_trmean(stacked_updates, cfg.num_corrupt)
    elif cfg.aggr == "krum":
        agg = agg_krum(stacked_updates, cfg.num_corrupt)
    elif cfg.aggr == "rfa":
        agg = agg_rfa(stacked_updates)
    else:
        raise ValueError(f"unknown aggr {cfg.aggr!r}")
    if cfg.noise > 0:
        if noise is None:
            raise ValueError("--noise > 0: the round draws the server noise "
                             "first (draw_noise)")
        agg = {k: agg[k] + noise[k] for k in agg}
    return agg


def apply_aggregate(params: Params, lr, aggregated: Params) -> Params:
    """global <- global + lr * aggregate, f32; `lr` is a float or a dict."""
    if isinstance(lr, dict):
        new = {k: p + lr[k] * aggregated[k] for k, p in params.items()}
    else:
        new = {k: p + lr * aggregated[k] for k, p in params.items()}
    return {k: v.to(torch.float32) for k, v in new.items()}
