"""The FL round: sample m of K agents, train each locally, run the server
step.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
fl/rounds.py` — the dense device-resident path (`_make_sample_step`,
`_round_core`, `make_round_fn`) and `_pallas_applicable`. The JAX round is
one jitted program with the m agents vmapped; here the agents train one
after another in a Python loop over views of the device-resident
[K, max_n, ...] stacks, and the server step reads the stacked [m, ...]
updates.

Server step: the fused RLR kernel (ops/rlr_fused.py) wherever
`_fused_applicable` holds, which is the default; ops/aggregate.py
otherwise.

Randomness comes from a `RoundRNG` seeded from --seed: the sampled ids from
a CPU generator (they are needed on the host to loop over the agents), the
shuffles, dropout masks and server noise from a generator on the round's
device. torch cannot reproduce jax.random streams, so the tests inject the
sampled ids and permutations and turn dropout off.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl.client import (
    draw_perms, make_local_train)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.aggregate import (
    aggregate_updates, apply_aggregate, robust_lr)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.rlr_fused import (
    fused_rlr_avg_apply)


class RoundRNG:
    """The run's random streams, seeded from the run's seed: `host` (CPU)
    draws the sampled agent ids, `device` the shuffles, dropout masks and
    server noise."""

    def __init__(self, seed: int, device):
        self.host = torch.Generator().manual_seed(seed)
        self.device = torch.Generator(device=device).manual_seed(seed + 1)


def _fused_applicable(cfg) -> bool:
    """`_pallas_applicable` reduced to the fields the port has: the fused
    kernel covers weighted FedAvg or signSGD (with or without the RLR vote)
    with no server noise."""
    return cfg.use_fused and cfg.aggr in ("avg", "sign") and cfg.noise == 0


def sample_agents(cfg, gen: torch.Generator) -> torch.Tensor:
    """m distinct agent ids out of K (reference src/federated.py:68)."""
    return torch.randperm(cfg.num_agents, generator=gen)[:cfg.agents_per_round]


def server_step(params, updates, sizes, cfg,
                gen: Optional[torch.Generator] = None):
    """New params from the stacked [m, ...] updates and their data sizes
    [m]: the fused kernel, or robust_lr + aggregate + apply."""
    thr = float(cfg.robustLR_threshold)
    slr = cfg.effective_server_lr
    if _fused_applicable(cfg):
        return fused_rlr_avg_apply(params, updates, sizes.to(torch.float32),
                                   thr, slr, mode=cfg.aggr)
    lr = robust_lr(updates, thr, slr) if thr > 0 else slr
    return apply_aggregate(params, lr,
                           aggregate_updates(updates, sizes, cfg, gen))


def train_agents(local_train, params, images, labels, sizes_host, sampled,
                 perms, dropout_gen):
    """Local training of each sampled agent; returns (updates stacked
    [m, ...] per leaf, losses [m])."""
    updates, losses = [], []
    for slot, a in enumerate(sampled):
        up, loss = local_train(params, images[a], labels[a],
                               int(sizes_host[a]), perms[slot], dropout_gen)
        updates.append(up)
        losses.append(loss)
    stacked = {k: torch.stack([u[k] for u in updates]) for k in params}
    return stacked, torch.stack(losses)


def make_round_fn(cfg, model, normalize, images, labels, sizes):
    """Device-resident round fn:
    round(params, rng, sampled=None, perms=None, dropout=True)
    -> (params, {"train_loss", "sampled"}).

    images [K, max_n, H, W, C] and labels [K, max_n] (int64) are tensors on
    the round's device; sizes is the [K] numpy array of true shard sizes.
    `sampled` ([m] ids) and `perms` (per sampled slot, cfg.local_ep
    permutations) replace the draws from `rng`; dropout=False runs local
    training without dropout."""
    local_train = make_local_train(model, cfg, normalize)
    device = images.device
    sizes_host = np.asarray(sizes)
    sizes_dev = torch.as_tensor(sizes_host, dtype=torch.int32, device=device)
    n_total = images.shape[1]

    def round_fn(params, rng: RoundRNG, sampled=None,
                 perms: Optional[Sequence] = None, dropout: bool = True):
        if sampled is None:
            sampled = sample_agents(cfg, rng.host)
        sampled = [int(a) for a in sampled]
        if perms is None:
            perms = [draw_perms(int(sizes_host[a]), n_total, cfg.local_ep,
                                rng.device, device) for a in sampled]
        updates, losses = train_agents(
            local_train, params, images, labels, sizes_host, sampled, perms,
            rng.device if dropout else None)
        idx = torch.as_tensor(sampled, device=device)
        new_params = server_step(params, updates, sizes_dev[idx], cfg,
                                 rng.device)
        return new_params, {"train_loss": torch.mean(losses),
                            "sampled": sampled}

    return round_fn
