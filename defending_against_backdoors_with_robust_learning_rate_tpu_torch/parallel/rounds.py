"""The sharded FL round: the m sampled agents blocked m/d per rank of an
`agents` process group, the server step as collectives.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
parallel/rounds.py`: `_to_param_shards` / `_from_param_shard` (:57-74),
`_sharded_aggregate` (:77-211), `_sharded_sign_shared` (:214-259),
`_sharded_robust_lr` (:262-293), `_bucket_applicable` (:296),
`_BucketInfo` (:308), `_bucketed_apply` (:328-466) without the
reputation payload, `_sharded_pallas_apply` (:557-593), `_loss_and_health`
(:596-615), the round body (`_build_sharded_body` :616-1011),
`_make_sample_step` (:1013-1073) and `make_sharded_round_fn` (:1076).
JAX's `shard_map` over the `agents` mesh axis becomes d ranks each running
this module's round fn; each collective is one call of `AgentsGroup`
(parallel/mesh.py), which counts it by kind.

Every rank draws the same sampled ids from the same seeded host generator,
so sampling needs no collective, and each rank trains only its block of
slots as one batched program (fl/rounds.BlockTrainer, the dense round's
trainer), each slot with the draws the dense round gives it
(fl/rounds.RoundRNG.slot), so the sharded round equals the dense one for
the same seed. The new params come out replicated on every rank. The
round runs eagerly: its gloo collectives cannot sit in a captured CUDA
graph, and the sharded chained and captured round is not ported yet.

Server step, leaf layout, avg and sign (`sharded_server_step`): every
leaf's partials go into one packed buffer (`PackedPlan`) and the round
makes one all_reduce of the part the step reads, as XLA's combiner merges
JAX's per-leaf psums into one tuple all-reduce; then the elementwise
lr / apply. The partials come from one K2 launch over all leaves
(ops/rlr_fused.rlr_partial_leaves) with the fused step (`--no_fused` not
given, and nothing below that turns it off), or from plain torch ops.

The robust rules on the leaf layout (`_transpose_aggregate`): comed and
trmean transpose the block to the param-sharded layout with one all_to_all
(every rank then holds all m agents for 1/d of the coordinates), sort
locally and all_gather the chunk's result; krum sums chunk-partial
distances with one all_reduce of [m, m] and all_gathers the winner's
chunk; rfa runs a replicated Weiszfeld iterate, one all_reduce for the
mean and two an iteration. JAX transposes and gathers leaf by leaf; the
port packs the leaves into one flat block, so each rule makes one
all_to_all and one all_gather a round (the coordinates a rank holds
differ, the value of each coordinate does not). With RLR on (or full
telemetry, whose margins read them) the vote's sign sums are one more
packed all_reduce.

Server step, bucket layout (`--agg_layout bucket`, avg and sign,
`bucketed_apply`, parallel/buckets.py): the weight total (avg), the
stacked [weighted sum; sign sum] rows reduce_scattered bucket by bucket,
avg or sign, RLR, the noise and the empty guard on the scattered shard,
then one all_gather of the LR-scaled shard (widened under telemetry). The
port's fused step (K2) is on by default where JAX's Pallas step is
opt-in, and JAX checks its Pallas step before the bucket path: here
`--agg_layout bucket` always takes the bucket path.

Server noise: every rank draws the round's noise from the same replicated
generator (RoundRNG.noise, ops/aggregate.draw_noise), so the sharded round
adds the dense round's noise bit for bit; on the bucket layout the noise
is drawn per leaf and relaid through `flatten_tree` and `device_shard`.

The participation mask (JAX :722-765): every rank draws the round's fault
draw on the host from the same `RoundRNG` (fl/rounds.draw_faults_host) and
takes its block of it: the stragglers' epoch budgets go to the block's
trainer, the corrupt payloads are injected into the block, and one
all_gather of the block's [m/d] payload-validity bits (uint8) gives every
rank mask = participate & valid. The quarantine set and the churn and
traffic presence (fl/rounds.presence) of the sampled ids are replicated
and AND into it with no collective. The rules then run masked
(faults/masking.py), the RLR threshold follows the electorate, and an
all-invalid round is a no-op (`guard_empty`). The Faults/* and Churn/*
values are the dense round's.

Telemetry (`--telemetry basic|full`, obs/telemetry.compute_sharded and
compute_sharded_bucket): the norms' all_gather, and under full the two
cosine accumulators'; the margins re-read the vote's sign sums. The
corrupt flags come replicated from the host (fl/rounds.corrupt_slots).

Attack (`--attack boost|signflip`): each rank scales its own block of rows,
the slots [lo, hi) of the round's [m] attacked slots, before the server
step (JAX parallel/rounds.py:636-667, :745); no collective.

A round's collectives, per kind, are `parallel/multihost.plan_collectives`.

Not ported (refused by name, ROADMAP queue 1 item 11): the sharded
chained and captured round, the sharded host-sampled and cohort rounds,
buffered mode, checkpoints, `--diagnostics` and the reputation lanes
(``--reputation on`` is refused; train.run resolves ``auto`` off here),
and tenant packs (item 15).
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
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.faults import (
    masking, model as fmodel)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    buffered)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl.rounds import (
    RoundRNG, _fused_applicable, corrupt_slots, draw_faults_host,
    join_presence, make_block_trainer, presence, sample_agents)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.health import (
    sentinel as health_sentinel)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.obs import (
    reputation, telemetry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.aggregate import (
    RFA_EPS, RFA_ITERS, agent_sq_dists, apply_aggregate, band, draw_noise,
    krum_k, rlr_from_sign_sum, sq_dist_accum, trmean_k)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.rlr_fused import (
    packed_offsets, put_padded, rlr_partial_leaves)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.tree import (
    Params)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel import (
    buckets)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.mesh import (
    AgentsGroup)

# JAX's refusal, word for word (parallel/rounds.py:688-695)
BUCKET_DIAGNOSTICS = (
    "--agg_layout bucket does not support --diagnostics (the lr tree is "
    "never materialized on the scattered path); re-run with --agg_layout "
    "leaf — the per-leaf psum plan keeps the full lr tree and supports "
    "every diagnostic")


@dataclasses.dataclass(frozen=True)
class PackedPlan:
    """The layout of a round's one server-step all_reduce: a flat f32
    buffer [weighted sums of every leaf | sign sums of every leaf], each
    half `width` floats, each leaf at an offset rounded up to ALIGN floats
    (16 bytes) with zeros in its pad lanes. Only the halves the step reads
    are written and reduced: the weighted half for avg, the sign half where
    RLR is on, aggr is sign or full telemetry reads the margins; `reduced`
    is that contiguous slice."""

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

    def views(self, flat: torch.Tensor, params: Params) -> Params:
        """Each leaf's view of one packed half (pad lanes left out)."""
        return {k: flat[o:o + n].view(p.shape)
                for (k, p), o, n in zip(params.items(), self.offsets,
                                        self.numels, strict=True)}


def reads_sign_sums(cfg) -> bool:
    """Whether the server step sums the sign votes: for the sign
    aggregate, the RLR vote, or full telemetry's margins."""
    return (cfg.aggr == "sign" or cfg.robustLR_threshold > 0
            or cfg.telemetry == "full")


def packed_plan(cfg, params: Params) -> PackedPlan:
    numels = tuple(p.numel() for p in params.values())
    offsets, width = packed_offsets(numels)
    return PackedPlan(numels, offsets, width, wsum=cfg.aggr == "avg",
                      sign=reads_sign_sums(cfg))


def bucket_applicable(cfg) -> bool:
    """The bucket layout covers avg and sign, RLR on or off (JAX
    `_bucket_applicable`); the robust rules keep the leaf layout's plan."""
    return cfg.agg_layout == "bucket" and cfg.aggr in ("avg", "sign")


@dataclasses.dataclass
class Terms:
    """What the server step hands the telemetry: the replicated lr dict
    (None with RLR off), the aggregate dict and the vote's all_reduced
    sign-sum dict (None where no vote was summed)."""
    lr: Optional[Params]
    agg: Params
    sign_sums: Optional[Params]


@dataclasses.dataclass
class BucketInfo:
    """What the bucket layout hands the telemetry (JAX `_BucketInfo`
    without the reputation lanes): the replicated aggregate dict (full
    level; it rode the result all_gather), the summed shard_vote_stats
    vector (None with telemetry off) and the real coordinate count."""
    agg: Optional[Params] = None
    stats: Optional[torch.Tensor] = None
    total_coords: int = 0


def sharded_partials(params: Params, updates: Params, sizes, cfg,
                     group: AgentsGroup, mask_local=None):
    """This rank's partials of every leaf in the round's packed buffer,
    then its one all_reduce. Returns (plan, buf): buf[plan.reduced] summed
    over the group, the weighted half already the global FedAvg.

    Fused (`_fused_applicable`): one K2 launch over all leaves with
    weights divided by the all_reduced weight total. Plain: the same sums
    as torch ops into the same views, the weighted half divided by the
    total after the all_reduce, as JAX's `_sharded_aggregate` does. The
    weight total is all_reduced only for avg, where it is read. With a
    participation `mask_local` ([m/d] bool) the block's masked rows and
    weights are zeros first (JAX's zero_masked), so they vote sign 0."""
    plan = packed_plan(cfg, params)
    fused = _fused_applicable(cfg)
    w = sizes.to(torch.float32)
    if mask_local is not None:
        w = torch.where(mask_local, w, torch.zeros((), device=w.device))
        updates = masking.zero_masked(updates, mask_local)
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


def _threshold(cfg, mask_full):
    """The RLR threshold, scaled to the electorate under a mask."""
    if mask_full is None:
        return float(cfg.robustLR_threshold)
    return masking.rlr_threshold(cfg, mask_full)


def _guard(agg: torch.Tensor, mask_full) -> torch.Tensor:
    """`masking.guard_empty` of one flat tensor."""
    if mask_full is None:
        return agg
    return torch.where(torch.any(mask_full), agg, torch.zeros_like(agg))


def _packed_step(params: Params, updates: Params, sizes, cfg,
                 group: AgentsGroup, noise=None, mask_local=None,
                 mask_full=None):
    """avg or sign on the leaf layout: the packed partials and their
    all_reduce, then lr = +-server_lr by |s| >= thr and agg (+ noise,
    guarded) over the whole buffer, and p + lr * agg per leaf on views of
    it. Returns (new params, Terms)."""
    plan, buf = sharded_partials(params, updates, sizes, cfg, group,
                                 mask_local)
    rlr = cfg.robustLR_threshold > 0
    slr = cfg.effective_server_lr
    s = buf[plan.width:] if plan.sign else None
    agg = torch.sign(s) if cfg.aggr == "sign" else buf[:plan.width]
    if noise is not None:
        flat = torch.zeros(plan.width, dtype=torch.float32, device=agg.device)
        for v, at in zip(noise.values(), plan.offsets):
            put_padded(flat, at, v.reshape(-1))
        agg = agg + flat
    agg = _guard(agg, mask_full)
    lr = rlr_from_sign_sum(s, _threshold(cfg, mask_full), slr) if rlr else None
    step = (lr if rlr else slr) * agg
    new = {k: (p.reshape(-1).to(torch.float32) + step[o:o + n]).view(p.shape)
           for (k, p), o, n in zip(params.items(), plan.offsets, plan.numels,
                                   strict=True)}
    return new, Terms(None if lr is None else plan.views(lr, params),
                      plan.views(agg, params),
                      None if s is None else plan.views(s, params))


def sharded_server_step(params: Params, updates: Params, sizes, cfg,
                        group: AgentsGroup) -> Params:
    """New replicated params from this rank's [m/d, ...] update block and
    its data sizes [m/d], avg or sign on the leaf layout, with no mask and
    no noise (the fused step's path)."""
    return _packed_step(params, updates, sizes, cfg, group)[0]


def _flat_block(updates: Params) -> torch.Tensor:
    """[m/d, ...] leaves -> one [m/d, total] f32 block, the leaves in
    order (no padding)."""
    mb = next(iter(updates.values())).shape[0]
    return torch.cat([u.reshape(mb, -1).to(torch.float32)
                      for u in updates.values()], dim=1)


def _to_param_shards(flat: torch.Tensor, group: AgentsGroup) -> torch.Tensor:
    """[m/d, total] block -> [m, c]: every agent's row of this rank's
    column chunk (the flat block zero-padded to d * c columns), rows in
    rank order = slot order (JAX `_to_param_shards`, one all_to_all)."""
    pad = -flat.shape[1] % group.size
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return group.all_to_all(flat)


def _from_param_shard(chunk: torch.Tensor, params: Params,
                      group: AgentsGroup) -> Params:
    """[c] chunk of a per-coordinate result -> the replicated leaves (one
    all_gather, JAX `_from_param_shard`)."""
    full = group.all_gather(chunk.contiguous())
    return _unflat(full, params)


def _unflat(flat: torch.Tensor, params: Params) -> Params:
    """Views of a flat vector (leaves in order, no padding) as params."""
    out, at = {}, 0
    for k, p in params.items():
        out[k] = flat[at:at + p.numel()].view(p.shape)
        at += p.numel()
    return out


def _transpose_aggregate(params: Params, updates: Params, cfg,
                         group: AgentsGroup, mask_local=None,
                         mask_full=None) -> Params:
    """comed, trmean, krum or rfa over the agents group (JAX
    `_sharded_aggregate`'s branches), each the dense rule's arithmetic
    (ops/aggregate.py, faults/masking.py) on the transposed chunk or the
    replicated iterate; masked with `mask_full` where given."""
    m = cfg.agents_per_round
    masked = mask_full is not None
    n_eff = masking.count(mask_full) if masked else None
    if cfg.aggr in ("comed", "trmean"):
        chunk = _to_param_shards(_flat_block(updates), group)   # [m, c]
        if cfg.aggr == "comed":
            out = (masking.median_rows(chunk, mask_full, n_eff) if masked
                   else torch.sort(chunk, dim=0).values[(m - 1) // 2])
        elif masked:
            out = masking.trimmed_mean_rows(chunk, mask_full, n_eff,
                                            cfg.num_corrupt)
        else:
            t = trmean_k(cfg.num_corrupt, m)
            win = band(torch.sort(chunk, dim=0).values, t, m - 2 * t)
            out = torch.sum(win, dim=0) * (1.0 / (m - 2 * t))
        return _from_param_shard(out, params, group)
    if masked:
        # garbage payloads must not reach the distances or the iterate
        updates = masking.zero_masked(updates, mask_local)
    if cfg.aggr == "krum":
        chunk = _to_param_shards(_flat_block(updates), group)   # [m, c]
        dist = sq_dist_accum(torch.zeros((m, m), dtype=torch.float32,
                                         device=chunk.device), chunk)
        dist = torch.clamp(group.all_reduce_sum_(dist), min=0.0)
        if masked:
            best = masking.krum_best(dist, mask_full, n_eff, cfg.num_corrupt)
        else:
            k = krum_k(m, cfg.num_corrupt)
            srt = torch.sort(dist, dim=1).values
            best = torch.argmin(torch.sum(srt[:, 1:k + 1].contiguous(),
                                          dim=1)).reshape(1)
        return _from_param_shard(chunk.index_select(0, best)[0], params,
                                 group)
    if cfg.aggr == "rfa":
        # the replicated smoothed-Weiszfeld iterate: distances on the local
        # block, one all_reduce for the weight total and one for the
        # weighted sums an iteration (ops/aggregate.weiszfeld)
        flat = _flat_block(updates)
        if masked:
            inv_n = torch.reciprocal(masking.count_f32(mask_full))
            w0 = mask_local.to(torch.float32)
        else:
            inv_n, w0 = 1.0 / m, 1.0
        v = group.all_reduce_sum_(torch.sum(flat, dim=0)) * inv_n
        for _ in range(RFA_ITERS):
            w = w0 * torch.reciprocal(torch.clamp(torch.sqrt(
                agent_sq_dists(updates, _unflat(v, params))), min=RFA_EPS))
            wsum = group.all_reduce_sum_(torch.sum(w).reshape(1))
            v = group.all_reduce_sum_(torch.sum(flat * w[:, None], dim=0)) \
                / wsum
        return _unflat(v, params)
    raise ValueError(f"unknown aggr {cfg.aggr!r}")


def _rule_step(params: Params, updates: Params, sizes, cfg,
               group: AgentsGroup, noise=None, mask_local=None,
               mask_full=None):
    """A robust rule on the leaf layout: the vote's packed sign-sum
    all_reduce where RLR or full telemetry reads it (JAX
    `_sharded_robust_lr`), the rule, the noise and the empty guard, then
    the dense apply. Returns (new params, Terms)."""
    sign_sums = lr = None
    slr = cfg.effective_server_lr
    if reads_sign_sums(cfg):
        plan, buf = sharded_partials(params, updates, sizes, cfg, group,
                                     mask_local)
        sign_sums = plan.views(buf[plan.width:], params)
    if cfg.robustLR_threshold > 0:
        thr = _threshold(cfg, mask_full)
        lr = {k: rlr_from_sign_sum(s, thr, slr) for k, s in sign_sums.items()}
    agg = _transpose_aggregate(params, updates, cfg, group, mask_local,
                               mask_full)
    if noise is not None:
        agg = {k: agg[k] + noise[k] for k in agg}
    if mask_full is not None:
        agg = masking.guard_empty(agg, mask_full)
    new = apply_aggregate(params, slr if lr is None else lr, agg)
    return new, Terms(lr, agg, sign_sums)


def bucketed_apply(params: Params, updates: Params, sizes, cfg,
                   group: AgentsGroup, noise=None, mask_local=None,
                   mask_full=None):
    """avg or sign (+ RLR) on the bucket layout (JAX `_bucketed_apply`):
    the weight total (avg, one all_reduce), the stacked [weighted sum;
    sign sum] rows of the flat block reduce_scattered one bucket at a
    time, the average or the sign, the noise's shard, the empty guard and
    the RLR vote on this rank's shard, then one all_gather of the
    LR-scaled shard, which carries under telemetry the unscaled aggregate
    (full) and the vote statistics too. Padding coordinates are zeros:
    margin 0, aggregate 0, masked out of every statistic. Returns
    (new params, BucketInfo)."""
    d = group.size
    rlr = cfg.robustLR_threshold > 0
    if mask_local is not None:
        updates = masking.zero_masked(updates, mask_local)
    slr = cfg.effective_server_lr
    layout = buckets.layout_for_stacked(updates, d)
    flat = buckets.flatten_stacked(layout, updates)       # [m/d, padded]
    want_sign = reads_sign_sums(cfg)
    rows = []
    total = None
    if cfg.aggr == "avg":
        w = sizes.to(torch.float32)
        if mask_local is not None:
            w = torch.where(mask_local, w, torch.zeros((), device=w.device))
        total = group.all_reduce_sum_(torch.sum(w).reshape(1))
        rows.append(torch.sum(flat * w[:, None], dim=0))
    if want_sign:
        rows.append(torch.sum(torch.sign(flat), dim=0))
    stacked = torch.stack(rows)                           # [r, padded]
    bsz = layout.bucket
    scat = torch.cat([group.reduce_scatter_sum(stacked[:, b * bsz:
                                                       (b + 1) * bsz])
                      for b in range(layout.n_buckets)], dim=1)
    sign_s = scat[-1] if want_sign else None
    agg_s = scat[0] / total if cfg.aggr == "avg" else torch.sign(sign_s)
    if noise is not None:
        agg_s = agg_s + buckets.device_shard(
            layout, buckets.flatten_tree(layout, noise), group.rank)
    agg_s = _guard(agg_s, mask_full)
    lr_s = (rlr_from_sign_sum(sign_s, _threshold(cfg, mask_full), slr)
            if rlr else None)
    payload = [(lr_s if rlr else slr) * agg_s]
    if cfg.telemetry == "full":
        payload.append(agg_s)
    stats_len = 0
    if cfg.telemetry != "off":
        real = buckets.shard_coord_index(layout, group.rank,
                                         agg_s.device) < layout.total
        stats = telemetry.shard_vote_stats(cfg, sign_s, real, lr_s,
                                           cfg.agents_per_round)
        if stats is not None:
            payload.append(stats)
            stats_len = stats.shape[0]
    gathered = group.all_gather(torch.cat(payload) if len(payload) > 1
                                else payload[0]).reshape(d, -1)
    dl = layout.device_len
    delta = buckets.unflatten(
        layout, buckets.gathered_to_flat(layout, gathered[:, :dl]), params)
    new_params = {k: (p + delta[k]).to(torch.float32)
                  for k, p in params.items()}
    info = BucketInfo(total_coords=layout.total)
    if cfg.telemetry == "full":
        info.agg = buckets.unflatten(
            layout, buckets.gathered_to_flat(layout, gathered[:, dl:2 * dl]),
            params)
    if stats_len:
        info.stats = torch.sum(gathered[:, -stats_len:], dim=0)
    return new_params, info


def _participation(cfg, group: AgentsGroup, updates: Params, draw=None,
                   qmask=None):
    """The block's share of fl/rounds._participation: with a fault draw
    ([m], replicated) the block's corrupt payloads injected, one
    all_gather of the block's payload-validity bits, mask = participate &
    valid and the Faults/* values; then fl/rounds.join_presence with the
    replicated quarantine and presence mask. Returns (updates, mask_full,
    mask_local, info); the masks are None without either."""
    mb = next(iter(updates.values())).shape[0]
    lo, hi = group.rank * mb, (group.rank + 1) * mb
    mask, info = None, {}
    if draw is not None:
        if cfg.corrupt_rate > 0:
            updates = fmodel.inject_corrupt(updates, draw.corrupt[lo:hi],
                                            cfg.corrupt_mode)
        valid = group.all_gather(fmodel.payload_valid(
            updates, cfg.payload_norm_cap).to(torch.uint8)).to(torch.bool)
        mask = draw.participate & valid
        info.update(fmodel.fault_scalars(draw, mask))
    mask = join_presence(cfg, mask, qmask, info)
    return updates, mask, None if mask is None else mask[lo:hi], info


def sharded_server_path(params: Params, updates: Params, sizes, cfg,
                        group: AgentsGroup, noise=None, draw=None,
                        qmask=None, flags=None):
    """The sharded counterpart of fl/rounds.server_path, from this rank's
    [m/d, ...] block (after the attack) and its sizes [m/d]: the
    participation mask, the server step of cfg's layout and rule, and the
    telemetry. `noise` is the round's noise dict (every rank's the same),
    `draw` the round's [m] FaultDraw, `qmask` the [m] quarantine and
    presence mask, `flags` the [m] corrupt-slot flags. Returns (new
    params, {fault_*, churn_away, tel_*}, the block after the injection,
    its [m/d] mask or None)."""
    updates, mask_full, mask_local, info = _participation(
        cfg, group, updates, draw, qmask)
    bucket_info = terms = None
    if bucket_applicable(cfg):
        new_params, bucket_info = bucketed_apply(
            params, updates, sizes, cfg, group, noise, mask_local, mask_full)
    elif cfg.aggr in ("avg", "sign"):
        new_params, terms = _packed_step(params, updates, sizes, cfg, group,
                                         noise, mask_local, mask_full)
    else:
        new_params, terms = _rule_step(params, updates, sizes, cfg, group,
                                       noise, mask_local, mask_full)
    if cfg.telemetry != "off":
        if bucket_info is not None:
            info.update(telemetry.compute_sharded_bucket(
                cfg, updates, bucket_info, group, mask_local, mask_full,
                flags))
        else:
            info.update(telemetry.compute_sharded(
                cfg, updates, terms.lr, terms.agg, group, mask_local,
                mask_full, flags, terms.sign_sums))
    return new_params, info, updates, mask_local


def _loss_and_health(cfg, losses, updates_local: Params, new_params: Params,
                     group: AgentsGroup, mask_local=None):
    """The mean train loss over the m agents, with the health lanes packed
    into the same all_reduce when they are on: a [3] vector (loss, bad
    count, normsq) instead of a scalar, never a second collective."""
    lanes = torch.mean(losses).reshape(1)
    health = health_sentinel.health_on(cfg)
    if health:
        lanes = torch.cat([lanes, health_sentinel.local_lanes(updates_local,
                                                              mask_local)])
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
    if cfg.agg_layout == "bucket" and cfg.diagnostics:
        raise ValueError(BUCKET_DIAGNOSTICS)
    if buffered.is_buffered(cfg):
        raise ValueError(BUFFERED_SHARDED_NOT_PORTED)
    if cfg.reputation == "on":
        raise ValueError(reputation.NOT_PORTED_SHARDED)
    if cfg.diagnostics:
        raise ValueError("--diagnostics on the sharded round is not ported "
                         "yet (ROADMAP queue 1 item 11: the diag round's "
                         "explicit lr and agent norms over the agents "
                         "group)")
    return m // d


def make_sharded_round_fn(cfg, model, normalize, group: AgentsGroup, images,
                          labels, sizes):
    """This rank's round fn:
    round(params, rng, sampled=None, perms=None, dropout=True, faults=None)
    -> (replicated params, {"train_loss", "sampled", hlth_*, fault_*,
    churn_away and tel_* lanes}).

    images/labels are the full K-agent stacks on the rank's device (every
    rank holds the same seeded data); sizes the [K] numpy shard sizes. The
    rank trains slots [rank * m/d, (rank + 1) * m/d) of the sampled ids,
    and scales the rows the round's update attack hits. `sampled`,
    `perms` (for all m slots) and `faults` (an [m] FaultDraw on the host)
    replace the draws as in fl/rounds.make_round_fn."""
    mb = _check_sharded(cfg, group)
    lo, hi = group.rank * mb, (group.rank + 1) * mb
    device = images.device
    sizes_host = np.asarray(sizes)
    sizes_dev = torch.as_tensor(sizes_host, dtype=torch.int32, device=device)
    train_block = make_block_trainer(cfg, model, normalize, images, labels,
                                     sizes_host)
    qset = health_sentinel.quarantine_set(cfg, device)

    def round_fn(params, rng: RoundRNG, sampled=None,
                 perms: Optional[Sequence] = None, dropout: bool = True,
                 faults: Optional[fmodel.FaultDraw] = None):
        rnd = rng.next_round()
        if sampled is None:
            sampled = sample_agents(cfg, rng.host)
        sampled = [int(a) for a in sampled]
        draws = train_block.draw(rng, rnd, sampled, lo, hi, perms, dropout)
        noise = draw_noise(params, cfg, rng.noise)
        if faults is None:
            faults = draw_faults_host(cfg, rng, rnd, sampled)
        draw = None if faults is None else fmodel.draw_to(faults, device)
        ids = torch.as_tensor(sampled, device=device)
        qmask = health_sentinel.quarantine_mask(cfg, ids, qset)
        here = presence(cfg, sampled, rnd)
        if here is not None:
            here = here.to(device)
            qmask = here if qmask is None else here & qmask
        ep_local = (draw.ep_budget[lo:hi]
                    if draw is not None and cfg.straggler_rate > 0 else None)
        updates, losses = train_block.run(params, *draws, ep_budget=ep_local)
        hits = attack_registry.attacked_slots(cfg, sampled, rnd)
        if hits is not None:
            updates = attack_registry.apply_update_attack(
                cfg, updates, hits[lo:hi].to(device))
        flags = (corrupt_slots(cfg, sampled).to(device)
                 if cfg.telemetry == "full" else None)
        new_params, info, updates, mask_local = sharded_server_path(
            params, updates, sizes_dev[ids[lo:hi]], cfg, group, noise, draw,
            qmask, flags)
        loss, extras = _loss_and_health(cfg, losses, updates, new_params,
                                        group, mask_local)
        return new_params, {"train_loss": loss, "sampled": sampled, **info,
                            **extras}

    return round_fn
