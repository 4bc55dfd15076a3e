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
slots as one batched program (fl/rounds.BlockTrainer, the dense round's
trainer), each slot with the draws the dense round gives it
(fl/rounds.RoundRNG.slot), so the sharded round equals the dense one for
the same seed. The new params come out replicated on every rank. The
round runs eagerly: its gloo all_reduces cannot sit in a captured CUDA
graph, and the sharded chained and captured round is not ported yet.

Server step, leaf layout (`sharded_server_step`): every leaf's partials go
into one packed buffer (`PackedPlan`) and the round makes one all_reduce
of the part the step reads, as XLA's combiner merges JAX's per-leaf psums
into one tuple all-reduce; then the elementwise lr / apply. The partials
come from one K2 launch over all leaves (ops/rlr_fused.rlr_partial_leaves)
with the fused step (`--no_fused` not given, the default), or from plain
torch ops, the fused step's oracle. A round's all_reduces, fused or plain:
the weight total (avg only), the packed buffer, and the loss with the
health lanes: 3 for avg, 2 for sign (parallel/multihost.
leaf_plan_collectives).

Attack (`--attack boost|signflip`): each rank scales its own block of rows,
the slots [lo, hi) of the round's [m] attacked slots, before the server
step (JAX parallel/rounds.py:636-667, :745). The slots come from the
sampled ids and the schedule gate, which every rank computes alike on the
host, so the attack adds no collective; K2 then reads the scaled block.

Not ported: the bucket layout, comed/trmean/krum/rfa (all_to_all), server
noise, faults, churn, quarantine, tenants, buffered mode (ROADMAP queue 1
item 11; refused by name), diagnostics,
telemetry (JAX obs/telemetry.compute_sharded, shard_vote_stats) and the
reputation lanes (``--reputation on`` is refused; train.run resolves
``auto`` off here and refuses checkpoints).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.attack import (
    registry as attack_registry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    BUFFERED_SHARDED_NOT_PORTED)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    buffered)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl.rounds import (
    RoundRNG, _fused_applicable, make_block_trainer, sample_agents)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.health import (
    sentinel as health_sentinel)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.obs import (
    reputation)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.aggregate import (
    rlr_from_sign_sum)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.rlr_fused import (
    packed_offsets, put_padded, rlr_partial_leaves)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.tree import (
    Params)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.mesh import (
    AgentsGroup)


@dataclasses.dataclass(frozen=True)
class PackedPlan:
    """The layout of a round's one server-step all_reduce: a flat f32
    buffer [weighted sums of every leaf | sign sums of every leaf], each
    half `width` floats, each leaf at an offset rounded up to ALIGN floats
    (16 bytes) with zeros in its pad lanes. Only the halves the step reads
    are written and reduced: the weighted half for avg, the sign half where
    RLR is on or aggr is sign; `reduced` is that contiguous slice."""

    numels: Tuple[int, ...]
    offsets: Tuple[int, ...]
    width: int
    wsum: bool
    sign: bool

    @property
    def reduced(self) -> slice:
        return slice(0 if self.wsum else self.width,
                     2 * self.width if self.sign else self.width)

    @property
    def sign_at(self) -> Optional[int]:
        """Where the sign half starts, or None where it is not read."""
        return self.width if self.sign else None

    @property
    def wsum_at(self) -> Optional[int]:
        return 0 if self.wsum else None


def packed_plan(cfg, params: Params) -> PackedPlan:
    numels = tuple(p.numel() for p in params.values())
    offsets, width = packed_offsets(numels)
    return PackedPlan(numels, offsets, width, wsum=cfg.aggr == "avg",
                      sign=cfg.aggr == "sign" or cfg.robustLR_threshold > 0)


def sharded_partials(params: Params, updates: Params, sizes, cfg,
                     group: AgentsGroup):
    """This rank's partials of every leaf in the round's packed buffer,
    then its one all_reduce. Returns (plan, buf): buf[plan.reduced] summed
    over the group, the weighted half already the global FedAvg.

    Fused (the default): one K2 launch over all leaves with weights divided
    by the all_reduced weight total. Plain (--no_fused): the same sums as
    torch ops into the same views, the weighted half divided by the total
    after the all_reduce, as JAX's `_sharded_aggregate` does. The weight
    total is all_reduced only for avg, where it is read."""
    if cfg.aggr not in ("avg", "sign"):
        raise ValueError(f"aggr {cfg.aggr!r} on the sharded round is not "
                         f"ported yet (it needs the all_to_all transpose "
                         f"plan)")
    plan = packed_plan(cfg, params)
    fused = _fused_applicable(cfg)
    w = sizes.to(torch.float32)
    total = (group.all_reduce_sum_(torch.sum(w).reshape(1)) if plan.wsum
             else None)
    buf = torch.empty(2 * plan.width, dtype=torch.float32, device=w.device)
    us = [updates[k] for k in params]
    if fused:
        rlr_partial_leaves(us, w / total if plan.wsum else w, buf,
                           plan.offsets, plan.sign_at, plan.wsum_at)
    else:
        for u, at in zip(us, plan.offsets):
            u = u.view(u.shape[0], -1)
            if plan.sign:
                put_padded(buf, plan.sign_at + at,
                           torch.sum(torch.sign(u), dim=0))
            if plan.wsum:
                put_padded(buf, plan.wsum_at + at,
                           torch.sum(u * w[:, None], dim=0))
    group.all_reduce_sum_(buf[plan.reduced])
    if plan.wsum and not fused:
        buf[:plan.width] /= total
    return plan, buf


def sharded_server_step(params: Params, updates: Params, sizes, cfg,
                        group: AgentsGroup) -> Params:
    """New replicated params from this rank's [m/d, ...] update block and
    its data sizes [m/d]: the packed partials and their all_reduce, then
    lr = +-server_lr by |s| >= thr and agg over the whole buffer, and
    p + lr * agg per leaf on views of it."""
    plan, buf = sharded_partials(params, updates, sizes, cfg, group)
    thr = float(cfg.robustLR_threshold)
    slr = cfg.effective_server_lr
    s = buf[plan.width:] if plan.sign else None
    agg = torch.sign(s) if cfg.aggr == "sign" else buf[:plan.width]
    step = (rlr_from_sign_sum(s, thr, slr) if thr > 0 else slr) * agg
    return {k: (p.reshape(-1).to(torch.float32) + step[o:o + n]).view(p.shape)
            for (k, p), o, n in zip(params.items(), plan.offsets, plan.numels,
                                    strict=True)}


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
    if buffered.is_buffered(cfg):
        raise ValueError(BUFFERED_SHARDED_NOT_PORTED)
    if cfg.faults_enabled:
        raise ValueError("faults (--dropout_rate, --straggler_rate, "
                         "--corrupt_rate, --payload_norm_cap) on the sharded "
                         "round are not ported yet (the participation mask "
                         "over the agents group)")
    if health_sentinel.has_quarantine(cfg):
        raise ValueError("--quarantine on the sharded round is not ported "
                         "yet (the participation mask over the agents "
                         "group)")
    if cfg.telemetry != "off":
        raise ValueError(f"--telemetry {cfg.telemetry} on the sharded round "
                         f"is not ported yet (obs/telemetry.compute_sharded,"
                         f" shard_vote_stats)")
    if cfg.reputation == "on":
        raise ValueError(reputation.NOT_PORTED_SHARDED)
    if cfg.diagnostics:
        raise ValueError("--diagnostics on the sharded round is not ported "
                         "yet (the diag round's explicit lr and agent norms "
                         "over the agents group)")
    return m // d


def make_sharded_round_fn(cfg, model, normalize, group: AgentsGroup, images,
                          labels, sizes):
    """This rank's round fn:
    round(params, rng, sampled=None, perms=None, dropout=True)
    -> (replicated params, {"train_loss", "sampled", hlth_* lanes}).

    images/labels are the full K-agent stacks on the rank's device (every
    rank holds the same seeded data); sizes the [K] numpy shard sizes. The
    rank trains slots [rank * m/d, (rank + 1) * m/d) of the sampled ids,
    and scales the rows the round's update attack hits.
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
        hits = attack_registry.attacked_slots(cfg, sampled, rnd)
        if hits is not None:
            updates = attack_registry.apply_update_attack(
                cfg, updates, hits[lo:hi].to(images.device))
        idx = torch.as_tensor(sampled[lo:hi], device=images.device)
        new_params = sharded_server_step(params, updates, sizes_dev[idx],
                                         cfg, group)
        loss, extras = _loss_and_health(cfg, losses, updates, new_params,
                                        group)
        return new_params, {"train_loss": loss, "sampled": sampled, **extras}

    return round_fn
