"""The sharded FL round: the m sampled agents blocked m/d per rank of an
`agents` process group, the server step as all_reduces.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
parallel/rounds.py`, the leaf layout with no participation mask:
`_sharded_pallas_apply` (:557-593), the avg and sign branches of
`_sharded_aggregate` (:77-211), `_sharded_sign_shared` (:214-259),
`_sharded_robust_lr` (:262-293), `_loss_and_health` (:596-615), the round
body (`_build_sharded_body` :616-1011), `_make_sample_step` (:1013-1073)
and `make_sharded_round_fn` (:1076). JAX's `shard_map` over the `agents`
mesh axis becomes d ranks each running this module's round fn; each psum
is one `AgentsGroup.all_reduce_sum_`.

Every rank draws the same sampled ids from the same seeded host generator,
so sampling needs no collective, and each rank trains only its block of
slots, each slot with the generator the dense round gives it
(fl/rounds.RoundRNG.slot), so the sharded round equals the dense one for
the same seed. The new params come out replicated on every rank.

Server step, leaf layout: with the fused step (`--no_fused` not given, the
default) it is `_sharded_fused_apply`: kernel K2 (ops/rlr_fused.
partial_vote_avg_flat) per leaf on the rank's block, all_reduces of the
partials, then the elementwise lr / apply. Otherwise the plain
`_sharded_robust_lr` / `_sharded_aggregate` / `_sharded_sign_shared`, the
fused step's oracle. The loss and the health lanes share one all_reduce.
Not ported: the bucket layout, comed/trmean/krum/rfa (all_to_all), server
noise, faults, churn, quarantine, attack strategies, tenants, buffered
mode, diagnostics and telemetry.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl.rounds import (
    RoundRNG, _fused_applicable, make_block_trainer, sample_agents)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.health import (
    sentinel as health_sentinel)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.aggregate import (
    apply_aggregate, rlr_from_sign_sum)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.rlr_fused import (
    partial_vote_avg_flat)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.tree import (
    Params)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.mesh import (
    AgentsGroup)


def _weight_total(sizes, group: AgentsGroup):
    """(this rank's f32 weights, their all_reduced total [1])."""
    w = sizes.to(torch.float32)
    return w, group.all_reduce_sum_(torch.sum(w).reshape(1))


def _sign_sum(u, group: AgentsGroup) -> torch.Tensor:
    return group.all_reduce_sum_(torch.sum(torch.sign(u), dim=0))


def _sharded_fused_apply(params: Params, updates: Params, sizes, cfg,
                         group: AgentsGroup) -> Params:
    """The fused server step over the group: K2 per leaf on the rank's
    [m/d, n_leaf] block (a view, no copy), all_reduce of the sign sum and,
    for avg, of the weighted sum, then lr = +-server_lr by |s| >= thr and
    p + lr * agg as plain torch ops."""
    w, total = _weight_total(sizes, group)
    wn = w / total
    slr = cfg.effective_server_lr
    thr = float(cfg.robustLR_threshold)
    out = {}
    for k, p in params.items():
        u = updates[k]
        ssum, wsum = partial_vote_avg_flat(u.view(u.shape[0], -1), wn)
        group.all_reduce_sum_(ssum)
        agg = (torch.sign(ssum) if cfg.aggr == "sign"
               else group.all_reduce_sum_(wsum))
        lr = rlr_from_sign_sum(ssum, thr, slr) if thr > 0 else slr
        out[k] = (p.reshape(-1).to(torch.float32) + lr * agg).view(p.shape)
    return out


def _sharded_aggregate(updates: Params, sizes, cfg,
                       group: AgentsGroup) -> Params:
    """The avg and sign rules as all_reduces of the local block's partial
    sums; returns the replicated aggregate."""
    if cfg.aggr == "avg":
        w, total = _weight_total(sizes, group)
        out = {}
        for k, u in updates.items():
            wshape = (-1,) + (1,) * (u.ndim - 1)
            out[k] = group.all_reduce_sum_(
                torch.sum(u * w.reshape(wshape), dim=0)) / total
        return out
    if cfg.aggr == "sign":
        return {k: torch.sign(_sign_sum(u, group)) for k, u in updates.items()}
    raise ValueError(f"aggr {cfg.aggr!r} on the sharded round is not ported "
                     f"yet (it needs the all_to_all transpose plan)")


def _sharded_sign_shared(updates: Params, cfg, group: AgentsGroup):
    """aggr='sign' + RLR: one sign-sum all_reduce per leaf, read twice (the
    vote takes |s|, the aggregate sign(s)). Returns (lr, agg)."""
    thr = float(cfg.robustLR_threshold)
    slr = cfg.effective_server_lr
    lr, agg = {}, {}
    for k, u in updates.items():
        s = _sign_sum(u, group)
        lr[k] = rlr_from_sign_sum(s, thr, slr)
        agg[k] = torch.sign(s)
    return lr, agg


def _sharded_robust_lr(updates: Params, cfg, group: AgentsGroup) -> Params:
    """The RLR vote over the m sampled agents as one all_reduce per leaf."""
    thr = float(cfg.robustLR_threshold)
    slr = cfg.effective_server_lr
    return {k: rlr_from_sign_sum(_sign_sum(u, group), thr, slr)
            for k, u in updates.items()}


def sharded_server_step(params: Params, updates: Params, sizes, cfg,
                        group: AgentsGroup) -> Params:
    """New replicated params from this rank's [m/d, ...] update block and
    its data sizes [m/d]."""
    if _fused_applicable(cfg):
        return _sharded_fused_apply(params, updates, sizes, cfg, group)
    if cfg.robustLR_threshold > 0 and cfg.aggr == "sign":
        lr, agg = _sharded_sign_shared(updates, cfg, group)
        return apply_aggregate(params, lr, agg)
    lr = (_sharded_robust_lr(updates, cfg, group)
          if cfg.robustLR_threshold > 0 else cfg.effective_server_lr)
    return apply_aggregate(params, lr,
                           _sharded_aggregate(updates, sizes, cfg, group))


def _loss_and_health(cfg, losses, updates_local: Params, new_params: Params,
                     group: AgentsGroup):
    """The mean train loss over the m agents, with the health lanes packed
    into the same all_reduce when they are on: a [3] vector (loss, bad
    count, normsq) instead of a scalar, never a second collective."""
    lanes = torch.mean(losses).reshape(1)
    health = health_sentinel.health_on(cfg)
    if health:
        lanes = torch.cat([lanes, health_sentinel.local_lanes(updates_local)])
    group.all_reduce_sum_(lanes)
    extras = (health_sentinel.finish_sharded(lanes[1], lanes[2], new_params)
              if health else {})
    return lanes[0] / group.size, extras


def _check_sharded(cfg, group: AgentsGroup) -> int:
    """Refuse what the sharded round does not run; returns m/d."""
    m, d = cfg.agents_per_round, group.size
    if m % d:
        raise ValueError(f"agents_per_round={m} is not divisible by the "
                         f"{d} ranks of the `agents` group")
    if cfg.agg_layout != "leaf":
        raise ValueError(f"--agg_layout {cfg.agg_layout!r} on the sharded "
                         f"round is not ported yet (leaf only)")
    if cfg.aggr not in ("avg", "sign"):
        raise ValueError(f"aggr {cfg.aggr!r} on the sharded round is not "
                         f"ported yet (avg and sign only)")
    if cfg.noise > 0:
        raise ValueError("server noise on the sharded round is not ported "
                         "yet (it needs one replicated noise draw)")
    return m // d


def make_sharded_round_fn(cfg, model, normalize, group: AgentsGroup, images,
                          labels, sizes):
    """This rank's round fn:
    round(params, rng, sampled=None, perms=None, dropout=True)
    -> (replicated params, {"train_loss", "sampled", hlth_* lanes}).

    images/labels are the full K-agent stacks on the rank's device (every
    rank holds the same seeded data); sizes the [K] numpy shard sizes. The
    rank trains slots [rank * m/d, (rank + 1) * m/d) of the sampled ids.
    `sampled` and `perms` (for all m slots) replace the draws as in
    fl/rounds.make_round_fn."""
    mb = _check_sharded(cfg, group)
    lo, hi = group.rank * mb, (group.rank + 1) * mb
    sizes_host = np.asarray(sizes)
    sizes_dev = torch.as_tensor(sizes_host, dtype=torch.int32,
                                device=images.device)
    train_block = make_block_trainer(cfg, model, normalize, images, labels,
                                     sizes_host)

    def round_fn(params, rng: RoundRNG, sampled=None,
                 perms: Optional[Sequence] = None, dropout: bool = True):
        rnd = rng.next_round()
        if sampled is None:
            sampled = sample_agents(cfg, rng.host)
        sampled = [int(a) for a in sampled]
        updates, losses = train_block(params, rng, rnd, sampled, lo, hi,
                                      perms, dropout)
        idx = torch.as_tensor(sampled[lo:hi], device=images.device)
        new_params = sharded_server_step(params, updates, sizes_dev[idx],
                                         cfg, group)
        loss, extras = _loss_and_health(cfg, losses, updates, new_params,
                                        group)
        return new_params, {"train_loss": loss, "sampled": sampled, **extras}

    return round_fn
