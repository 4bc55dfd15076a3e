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
a CPU generator (they are needed on the host to loop over the agents); each
sampled slot's shuffles and dropout masks from a generator on the round's
device seeded from (seed, round, slot) alone, as JAX splits one key per
slot (parallel/rounds.py:1038), so the dense round and a sharded round on
any number of ranks draw the same for the same slot; the server noise from
one more device generator. torch cannot reproduce jax.random streams, so
the tests inject the sampled ids and permutations and turn dropout off.

With the health lanes on (--health, the default), the round's info also
holds the hlth_* lanes of health/sentinel.py.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl.client import (
    draw_perms, make_local_train)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.health import (
    sentinel as health_sentinel)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.aggregate import (
    aggregate_updates, apply_aggregate, robust_lr)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.rlr_fused import (
    fused_rlr_avg_apply)


class RoundRNG:
    """The run's random streams, seeded from the run's seed: `host` (CPU)
    draws the sampled agent ids, `slot(rnd, i)` gives sampled slot i's
    generator of round rnd (its shuffles, then its dropout masks), `noise`
    draws the server noise. `next_round` numbers the rounds from 1."""

    def __init__(self, seed: int, device):
        self.seed = seed
        self.device = torch.device(device)
        self.host = torch.Generator().manual_seed(seed)
        self.noise = torch.Generator(device=device).manual_seed(seed + 1)
        self.round = 0

    def next_round(self) -> int:
        self.round += 1
        return self.round

    def slot(self, rnd: int, slot: int) -> torch.Generator:
        state = np.random.SeedSequence([self.seed, rnd, slot]).generate_state(
            2, np.uint32)
        seed = (int(state[0]) << 31) ^ int(state[1])    # 63 bits
        return torch.Generator(device=self.device).manual_seed(seed)


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


def make_block_trainer(cfg, model, normalize, images, labels, sizes_host):
    """train_block(params, rng, rnd, sampled, lo, hi, perms=None,
    dropout=True) -> (updates [hi-lo, ...], losses [hi-lo]): local training
    of the sampled slots lo..hi-1 of round rnd, each with its own slot
    generator. `perms`, when given, holds every sampled slot's epoch
    permutations. The dense round trains slots 0..m-1; a rank of the
    sharded round its block."""
    local_train = make_local_train(model, cfg, normalize)
    device = images.device
    n_total = images.shape[1]

    def train_block(params, rng: RoundRNG, rnd: int, sampled, lo: int,
                    hi: int, perms: Optional[Sequence] = None,
                    dropout: bool = True):
        updates, losses = [], []
        for s in range(lo, hi):
            a, gen = sampled[s], rng.slot(rnd, s)
            size = int(sizes_host[a])
            slot_perms = (draw_perms(size, n_total, cfg.local_ep, gen, device)
                          if perms is None else perms[s])
            up, loss = local_train(params, images[a], labels[a], size,
                                   slot_perms, gen if dropout else None)
            updates.append(up)
            losses.append(loss)
        stacked = {k: torch.stack([u[k] for u in updates]) for k in params}
        return stacked, torch.stack(losses)

    return train_block


def make_round_fn(cfg, model, normalize, images, labels, sizes):
    """Device-resident round fn:
    round(params, rng, sampled=None, perms=None, dropout=True)
    -> (params, {"train_loss", "sampled", hlth_* lanes}).

    images [K, max_n, H, W, C] and labels [K, max_n] (int64) are tensors on
    the round's device; sizes is the [K] numpy array of true shard sizes.
    `sampled` ([m] ids) and `perms` (per sampled slot, cfg.local_ep
    permutations) replace the draws from `rng`; dropout=False runs local
    training without dropout."""
    sizes_host = np.asarray(sizes)
    device = images.device
    sizes_dev = torch.as_tensor(sizes_host, dtype=torch.int32, device=device)
    train_block = make_block_trainer(cfg, model, normalize, images, labels,
                                     sizes_host)

    def round_fn(params, rng: RoundRNG, sampled=None,
                 perms: Optional[Sequence] = None, dropout: bool = True):
        rnd = rng.next_round()
        if sampled is None:
            sampled = sample_agents(cfg, rng.host)
        sampled = [int(a) for a in sampled]
        updates, losses = train_block(params, rng, rnd, sampled, 0,
                                      len(sampled), perms, dropout)
        idx = torch.as_tensor(sampled, device=device)
        new_params = server_step(params, updates, sizes_dev[idx], cfg,
                                 rng.noise)
        info = {"train_loss": torch.mean(losses), "sampled": sampled}
        if health_sentinel.health_on(cfg):
            info.update(health_sentinel.sentinel(cfg, updates, new_params))
        return new_params, info

    return round_fn
