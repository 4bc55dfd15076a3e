"""Server aggregation rules + the robust-learning-rate (RLR) defense: the
plain server step, and the oracle of the fused kernel (ops/rlr_fused.py).

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
ops/aggregate.py`; reference src/aggregation.py. Updates arrive as a dict of
per-leaf stacks `[m, ...]` over the sampled agents; every rule reduces
axis 0.

- `robust_lr` (src/aggregation.py:48-54): per coordinate,
  lr = +server_lr where |sum_k sign(u_k)| >= threshold, else -server_lr.
- `agg_avg` (src/aggregation.py:57-64): data-size-weighted mean.
- `agg_sign` (src/aggregation.py:71-75): sign of the sum of signs.
- server noise (src/aggregation.py:34-35): N(0, noise*clip) on the aggregate.
- `apply_aggregate` (src/aggregation.py:38-40): global += lr * aggregate.

comed, trmean, krum and rfa are later slices. f32 throughout, as in JAX.
"""

from __future__ import annotations

import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.tree import (
    Params)


def rlr_from_sign_sum(sign_sum, threshold, server_lr):
    """+server_lr where |sign_sum| >= threshold, else -server_lr (f32; the
    two values are scalars of the kernel, no copy from the host, so the
    step can sit in a captured CUDA graph)."""
    return torch.where(torch.abs(sign_sum) >= threshold, float(server_lr),
                       float(-server_lr)).to(torch.float32)


def robust_lr(stacked_updates: Params, threshold, server_lr: float) -> Params:
    """Per-parameter learning-rate dict from the unweighted sign vote over
    the m sampled agents."""
    return {k: rlr_from_sign_sum(torch.sum(torch.sign(u), dim=0), threshold,
                                 server_lr)
            for k, u in stacked_updates.items()}


def agg_avg(stacked_updates: Params, data_sizes) -> Params:
    """Weighted FedAvg: sum_k n_k u_k / sum_k n_k."""
    w = data_sizes.to(torch.float32)
    total = torch.sum(w)
    out = {}
    for k, u in stacked_updates.items():
        wshape = (-1,) + (1,) * (u.ndim - 1)
        out[k] = torch.sum(u * w.reshape(wshape), dim=0) / total
    return out


def agg_sign(stacked_updates: Params) -> Params:
    """Majority-sign update: sign(sum_k sign(u_k))."""
    return {k: torch.sign(torch.sum(torch.sign(u), dim=0))
            for k, u in stacked_updates.items()}


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
                      noise: Params | None = None) -> Params:
    """Dispatch on cfg.aggr, plus the server noise (src/aggregation.py:
    26-35), drawn beforehand by `draw_noise`."""
    if cfg.aggr == "avg":
        agg = agg_avg(stacked_updates, data_sizes)
    elif cfg.aggr == "sign":
        agg = agg_sign(stacked_updates)
    else:
        raise ValueError(f"aggr {cfg.aggr!r} is not ported yet")
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
