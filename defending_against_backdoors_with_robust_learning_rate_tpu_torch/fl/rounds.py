"""The FL round: sample m of K agents, train them locally as one batched
program, run the server step; on a CUDA device the round's device work is
one captured CUDA graph.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
fl/rounds.py` — the dense device-resident path (`vmap_agents`,
`megabatch_agents`, `_run_chunked`, the layout-dispatched
`make_block_trainer`, `_make_sample_step`, `_round_core`, `make_round_fn`,
`make_chained`, `make_chained_round_fn`), the host-sampled and cohort
rounds (`make_host_step`, `make_round_fn_host`, `make_chained_host`,
`make_chained_round_fn_host`, `make_cohort_step`, `make_cohort_round_fn`,
`make_chained_cohort_round_fn`), `step_takes_round` and
`_pallas_applicable`. The JAX
round is one jitted program with the m agents vmapped and `--chain N`
rounds scanned in one dispatch. Here the m agents train as one batched
program (fl/client.make_local_train_batched, layout `--train_layout`, in
sequential groups of `--agent_chunk`), and on a CUDA device the round's
device work — the row gathers, the `local_ep x nb` batched steps, the
server step, the loss mean and the health lanes — is captured once per run
as one CUDA graph and replayed every round (utils/compile_cache.
RoundGraph); `make_chained` replays N rounds with no host sync between
them. On the CPU the round runs eagerly.

The host-sampled round (`make_round_fn_host`, JAX `make_host_step` /
`make_round_fn_host`, the fedemnist path: 3,383 users, 1% sampled a round,
reference src/runner.sh:34-38) takes the round's sampled shards gathered
on the host into [m, max_n, ...] stacks (train.py, data/prefetch.py) and
runs the same device work over them: on a CUDA device one captured graph
whose static input buffers each round refills.

Server step: the fused RLR kernel (ops/rlr_fused.py) wherever
`_fused_applicable` holds, which is the default; ops/aggregate.py
otherwise (a rule other than avg or sign, server noise, faults, churn,
diurnal traffic, the cohort round, a quarantine set, `--telemetry`, or
the snap rounds of `--diagnostics`).

Attack (`--attack boost|signflip`, attack/registry.py): the update
strategy scales the corrupt rows of the stacked updates right after local
training, before the fault injection and the payload check, as JAX's
`_round_core` does (fl/rounds.py:273-292), so `--payload_norm_cap` and
the robust rules see the attacker's payload. The [m] attacked slots are
marked on the host each round from the sampled ids (`id < num_corrupt`)
and the schedule gate (attack/schedule.active of the round's 1-based
index), and enter the device work as an input, as the fault draw and the
noise do, where attack/registry.apply_update_attack scales their rows: a
captured round replays the attack of the round it runs, never round 1's.
The host-sampled round refuses a scheduled attack with JAX's error.

Telemetry (`--telemetry basic|full`, obs/telemetry.py): computed in the
device work over the updates after the attack and the mask, with the
round's corrupt flags (an input, under `full`); its tel_* values are
lanes of the round's info, cloned by `make_chained` like the hlth_* lanes.

Faults (`Config.faults_enabled`, faults/): the round's fault draw
(faults/model.sample_faults: participate, straggler, ep_budget, corrupt,
each [m]) is drawn on the host from `RoundRNG.faults` and enters the
device work as an input, as the noise does. The stragglers' epoch budgets
ride the agents axis of the trainer (`vmap_agents`, `megabatch_agents`,
`_run_chunked`), and `server_path` runs JAX `_round_core`'s faults branch
in its order: inject the corrupt payloads, mask = participate &
payload_valid, the Faults/* scalars, the mask-aware RLR threshold and
vote, the masked rule and the noise, `guard_empty`, apply, and the
health lanes over the mask. The masked path has no host sync (krum's
winner and comed's index stay on the device), so it is captured with
the rest of the round.

Quarantine (`--quarantine`, health/sentinel.py): the device-resident
round ANDs `quarantine_mask` of its sampled ids into the participation
mask after the fault mask (JAX fl/rounds.py:525-531, :325-341), with or
without faults. The id set is a device tensor made when the round is
built, and the membership test runs inside the captured round. The
host-sampled round never sees the ids and refuses it, as JAX's does.

Randomness comes from a `RoundRNG` seeded from --seed, and is drawn on
the host's order before the device work: the sampled ids from a CPU
generator; with faults, the round's fault draw from a CPU generator
seeded from (seed, round, FAULTS_KEY_TAG); each sampled slot's shuffles
and dropout keep-masks
(fl/client.draw_slot) from a generator on the round's device seeded from
(seed, round, slot) alone, as JAX splits one key per slot
(parallel/rounds.py:1038), so the dense round and a sharded round on any
number of ranks draw the same for the same slot; the server noise from one
more device generator. torch cannot reproduce jax.random streams, so the
tests inject the sampled ids and permutations and turn dropout off.

With the health lanes on (--health, the default), the round's info also
holds the hlth_* lanes of health/sentinel.py; with faults, the
FAULT_INFO_KEYS of faults/model.fault_scalars.

Reputation (`--reputation`, obs/reputation.py; on by default whenever a
sign vote exists): `_device_round` computes the [m] rep_agree and rep_norm
lanes from the stack after the attack, masked slots zeroed, before the
server step (K1 stays on), inside the captured graph; `make_chained`
stacks them like the other lanes.

Presence (`--churn_available`, `--traffic diurnal`, service/churn.py,
data/traffic.py): the dense round's [m] presence mask of its sampled ids
is drawn on the host for each round (`presence`) and enters the device
work as an input, where it joins the participation mask with the
quarantine's (JAX `_make_sample_step`'s churn_active); under churn the
round adds `churn_away` (Churn/Sampled_Away) and, without faults, JAX's
churn-only Faults/* scalars. The kernel is off under both.

The cohort-sampled round (`make_cohort_round_fn`, JAX `make_cohort_step`
/ `make_cohort_round_fn`: the population axis, a seeded cohort of m
clients a round from a client bank of up to millions, data/bank.py and
data/cohort.py) runs the host round's device work over the cohort's
gathered rows, with the cohort's ids and `active` mask as inputs of the
one captured graph. The chained host-sampled and cohort rounds
(`make_chained_host`) run a gathered [chain, m, ...] block one replay a
row.

Diagnostics (`--diagnostics`, fl/diagnostics.py): a round fn built from a
config with `diagnostics` set runs the plain server step (K1 never makes
the lr) and adds "agent_norms" ([m]) and, with RLR on, "lr_flat" (the
flat lr) to its info. The driver (train.py) builds that round fn beside
the plain one and runs it on the snap rounds only (JAX's plain/diag
program pair, train.py:340-342); on a card each is its own captured graph.

Buffered-async aggregation (`--agg_mode buffered`, fl/buffered.py): the
dense round, the cohort round and their chained forms become ticks. The
round's "params" are then the carry of fl/buffered.join_carry, the model
params and the buffer state in one dict, so a captured round replays
from the buffer the previous replay left and `make_chained` threads it
like the params. The stragglers train full epochs; each tick's [m]
latency T is drawn on the host from the straggler flags of the fault
draw (`tick_inputs`, fl/buffered.latency) and enters the device work as
an input; `buffered_path` runs JAX `_round_core`'s buffered tail in its
order (fl/rounds.py:323-362): the participation mask as in
`server_path`, `tick_contributions` over the masked stack, `fold_commit`,
then the telemetry over the buffer's vote, the reputation lanes against
the buffer's accumulated vote and the health lanes over the committed
params. The fused kernel is off (`_fused_applicable`). The host-sampled
round refuses buffered, as JAX's does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.attack import (
    registry as attack_registry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    BUFFERED_HOST_SAMPLED)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data import (
    traffic)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.faults import (
    masking, model as fmodel)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    buffered, diagnostics)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl.client import (
    draw_slot, make_local_train_batched)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.health import (
    sentinel as health_sentinel)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.obs import (
    reputation, telemetry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.aggregate import (
    aggregate_updates, apply_aggregate, draw_noise, robust_lr)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.rlr_fused import (
    fused_rlr_avg_apply)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.service import (
    churn)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils import (
    compile_cache)

# the fault scalars (faults/model.fault_scalars) a chained block carries
# beside train_loss and the hlth_* lanes (JAX fl/rounds.py:39)
FAULT_INFO_KEYS = fmodel.INFO_KEYS
# everything a chained block stacks besides train_loss and the hlth_*,
# tel_* and rep_* lanes: the fault counters, the churn away count and the
# buffered path's fill, commit and staleness values (JAX
# CHAINED_INFO_KEYS)
CHAINED_INFO_KEYS = (FAULT_INFO_KEYS + ("churn_away",)
                     + buffered.ASYNC_INFO_KEYS)


class RoundRNG:
    """The run's random streams, seeded from the run's seed: `host` (CPU)
    draws the sampled agent ids, `slot(rnd, i)` gives sampled slot i's
    generator of round rnd (its shuffles, then its dropout masks), `noise`
    draws the server noise, `faults(rnd)` gives round rnd's fault
    generator (CPU), `latency(rnd)` its buffered-arrival generator (CPU).
    `next_round` numbers the rounds from 1.

    `host` and `noise` are stateful and `round` is a counter; `slot` and
    `faults` are functions of (seed, round, slot). `state_dict` /
    `load_state` carry the three, the port's counterpart of the PRNG key
    JAX's checkpoint saves: a resumed run draws the ids and the noise the
    uninterrupted run draws."""

    def __init__(self, seed: int, device):
        self.seed = seed
        self.device = torch.device(device)
        self.host = torch.Generator().manual_seed(seed)
        self.noise = torch.Generator(device=device).manual_seed(seed + 1)
        self.round = 0

    def next_round(self) -> int:
        self.round += 1
        return self.round

    def state_dict(self) -> dict:
        """The stateful part: the round counter and the host and noise
        generators' states, with the device type that wrote them."""
        return {"device": self.device.type, "round": self.round,
                "host": self.host.get_state(),
                "noise": self.noise.get_state()}

    def load_state(self, state: dict) -> None:
        """Continue from `state_dict`'s state; a state written on another
        device type raises (a generator's state does not carry across)."""
        if state["device"] != self.device.type:
            raise ValueError(
                f"random streams written on {state['device']} cannot "
                f"continue on {self.device.type}")
        self.round = int(state["round"])
        self.host.set_state(state["host"])
        self.noise.set_state(state["noise"])

    def slot(self, rnd: int, slot: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            _seed_of(self.seed, rnd, slot))

    def faults(self, rnd: int) -> torch.Generator:
        return torch.Generator().manual_seed(
            _seed_of(self.seed, rnd, fmodel.FAULTS_KEY_TAG))

    def latency(self, rnd: int) -> torch.Generator:
        return torch.Generator().manual_seed(
            _seed_of(self.seed, rnd, buffered.ASYNC_KEY_TAG))


def _seed_of(*words: int) -> int:
    """A 63-bit generator seed from a tuple of words."""
    state = np.random.SeedSequence(list(words)).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def _fused_applicable(cfg) -> bool:
    """`_pallas_applicable` reduced to the fields the port has: the fused
    kernel covers weighted FedAvg or signSGD (with or without the RLR vote)
    with no server noise; the faults path and a quarantine set need the
    mask threaded through the vote, which the kernel does not take; the
    telemetry reads the explicit lr and aggregate trees, which the kernel
    never makes (JAX's `cfg.telemetry == "off"` clause).

    Unlike JAX, the kernel stays on under an update attack (boost,
    signflip). JAX turns its Pallas kernel off there because the attack
    transforms the updates before the server step, "which the fused
    kernel's one-pass read would skip" (JAX fl/rounds.py:63-64). Here the
    attack scales the stacked [m, n] rows first (`_device_round`), and K1
    reads those scaled rows: it computes exactly what the plain step
    computes on them, the vote sign(-b*u) = -sign(u) and the weighted sum
    of the scaled rows (tests/test_torch_attack_round.py holds both
    steps against JAX's).

    The reputation lanes (obs/reputation.py) leave the kernel on: they are
    computed from the stack before it runs. `--diagnostics` turns it off
    in the config it is set in, the snap rounds' round fn (train.py): that
    round reads the explicit lr, as JAX's `not cfg.diagnostics` clause
    says.

    Churn, diurnal traffic and the cohort-sampled round carry a presence
    mask into the vote, which the kernel does not take: it is off there,
    as JAX's `not cfg.churn_enabled` and `not compile_cache.is_cohort_mode`
    clauses say (fl/rounds.py:60-75). JAX has no traffic clause: under
    `--use_pallas --traffic diurnal` on its dense round its kernel skips
    the presence mask; the port turns the kernel off there too.

    `--dtype bf16` and `--remat` leave the kernel on, as JAX's
    `_pallas_applicable` has no clause for either: the params, grads and
    updates stay f32 (models/layers.py), so K1 reads what it always
    reads.

    `--agg_mode buffered` turns it off, as JAX's `not
    buffered.is_buffered(cfg)` clause does: the kernel applies the round's
    updates at once, and the buffer must hold them until its commit."""
    return (cfg.use_fused and cfg.aggr in ("avg", "sign") and cfg.noise == 0
            and not buffered.is_buffered(cfg)
            and not cfg.diagnostics and not cfg.faults_enabled
            and not cfg.churn_enabled and not cfg.traffic_enabled
            and not compile_cache.is_cohort_mode(cfg)
            and not health_sentinel.has_quarantine(cfg)
            and cfg.telemetry == "off")


def step_takes_round(cfg) -> bool:
    """Whether the round's work reads the round index (JAX
    `step_takes_round`): the churn lifecycle and the diurnal presence are
    functions of time, and so is a scheduled update attack. The port draws
    all three on the host from the round index it always knows; this says
    which configs make the round's inputs depend on it (the cohort round
    always does: its draw reads it)."""
    return (cfg.churn_enabled or cfg.traffic_enabled
            or attack_registry.needs_round(cfg))


def presence(cfg, sampled, rnd: int) -> Optional[torch.Tensor]:
    """[m] bool on the host: each sampled client churn-present and
    traffic-present at round rnd (service/churn.py, data/traffic.py), or
    None when neither is on (JAX `_make_sample_step`'s churn_active before
    the quarantine)."""
    ok = None
    if cfg.churn_enabled:
        ok = churn.active_slots(cfg, sampled, rnd)
    if cfg.traffic_enabled:
        here = traffic.present_slots(cfg, sampled, rnd)
        ok = here if ok is None else ok & here
    return None if ok is None else torch.from_numpy(ok)


def sample_agents(cfg, gen: torch.Generator) -> torch.Tensor:
    """m distinct agent ids out of K (reference src/federated.py:68)."""
    return torch.randperm(cfg.num_agents, generator=gen)[:cfg.agents_per_round]


def server_terms(updates, sizes, cfg, noise=None, mask=None):
    """(lr, agg) of the plain server step: the robust lr dict (or the
    scalar server lr with RLR off) and the aggregate (+ the pre-drawn
    server noise, ops/aggregate.draw_noise). With a participation `mask`
    ([m] bool), the mask-aware threshold and vote, the masked rule, and
    `guard_empty`."""
    thr = float(cfg.robustLR_threshold)
    slr = cfg.effective_server_lr
    if thr > 0:
        t = thr if mask is None else masking.rlr_threshold(cfg, mask)
        lr = robust_lr(updates, t, slr, mask=mask)
    else:
        lr = slr
    agg = aggregate_updates(updates, sizes, cfg, noise, mask=mask)
    if mask is not None:
        # every payload dropped or rejected: a zero aggregate, a no-op round
        agg = masking.guard_empty(agg, mask)
    return lr, agg


def server_step(params, updates, sizes, cfg, noise=None, mask=None):
    """New params from the stacked [m, ...] updates and their data sizes
    [m]: the fused kernel, or `server_terms` + apply."""
    if _fused_applicable(cfg):
        return fused_rlr_avg_apply(params, updates, sizes.to(torch.float32),
                                   float(cfg.robustLR_threshold),
                                   cfg.effective_server_lr, mode=cfg.aggr)
    return apply_aggregate(params, *server_terms(updates, sizes, cfg, noise,
                                                 mask))


def server_path(params, updates, sizes, cfg, noise=None, draw=None,
                qmask=None, flags=None, lanes: bool = False):
    """The round after local training and the attack, in JAX
    `_round_core`'s order (fl/rounds.py:293-428): with a fault draw, the
    corrupt payloads injected, mask = participate & payload_valid and the
    Faults/* scalars; with a presence mask `qmask` ([m] bool: JAX's
    churn_active, True = the slot's client is not quarantined, is churn-
    and traffic-present, and on the cohort round is no shortfall padding),
    mask &= qmask and the effective voters recounted, and under churn the
    away count (with no fault draw, JAX's churn-only Faults/* scalars); with
    `lanes`, the reputation lanes over the masked stack, before the server
    step reads it; then `server_step` over the mask, the telemetry (with
    the corrupt-slot `flags`, [m] bool or None), under `--diagnostics` the
    agent norms and (RLR on) the flat lr, and the health lanes over it.
    Returns (new params, {fault_*, rep_*, tel_*, agent_norms, lr_flat and
    hlth_* lanes})."""
    updates, mask, info = _participation(cfg, updates, draw, qmask)
    if lanes:
        info.update(reputation.lanes(updates, mask))
    if cfg.telemetry == "off" and not cfg.diagnostics:
        new_params = server_step(params, updates, sizes, cfg, noise, mask)
    else:
        lr, agg = server_terms(updates, sizes, cfg, noise, mask)
        new_params = apply_aggregate(params, lr, agg)
        if cfg.telemetry != "off":
            info.update(telemetry.compute(
                cfg, updates, lr if cfg.robustLR_threshold > 0 else None,
                agg, mask=mask, corrupt_flags=flags))
        if cfg.diagnostics:
            info["agent_norms"] = diagnostics.per_agent_norms(updates)
            if cfg.robustLR_threshold > 0:
                info["lr_flat"] = diagnostics.flat(lr)
    if health_sentinel.health_on(cfg):
        info.update(health_sentinel.sentinel(cfg, updates, new_params,
                                             mask=mask))
    return new_params, info


def _participation(cfg, updates, draw=None, qmask=None):
    """(updates, mask, info) of `server_path`'s first steps: with a fault
    draw the corrupt payloads injected, mask = participate &
    payload_valid and the Faults/* scalars; mask &= qmask and the churn
    counts. mask is None when neither is given."""
    mask, info = None, {}
    if draw is not None:
        if cfg.corrupt_rate > 0:
            updates = fmodel.inject_corrupt(updates, draw.corrupt,
                                            cfg.corrupt_mode)
        mask = draw.participate & fmodel.payload_valid(
            updates, cfg.payload_norm_cap)
        info.update(fmodel.fault_scalars(draw, mask))
    return updates, join_presence(cfg, mask, qmask, info), info


def join_presence(cfg, mask, qmask, info):
    """mask (the fault mask, or None without a fault draw) &= qmask (the
    [m] quarantine and presence mask, or None), with the effective voters
    recounted in `info` and, under churn, the away count (without a fault
    draw, JAX's churn-only Faults/* scalars). Returns the joined mask."""
    if qmask is None:
        return mask
    faulted = mask is not None
    mask = qmask if mask is None else mask & qmask
    if faulted:
        info["fault_voters"] = masking.count_f32(mask)
        if cfg.churn_enabled:
            info["churn_away"] = churn.churn_away(qmask)
    elif cfg.churn_enabled:
        info.update(churn.churn_only_scalars(qmask, mask))
    return mask


def buffered_path(carry, updates, sizes, cfg, noise=None, draw=None,
                  qmask=None, flags=None, lanes: bool = False, lat=None):
    """The buffered tick after local training and the attack, in JAX
    `_round_core`'s order (fl/rounds.py:323-362): the participation mask
    as in `server_path`; the tick's contributions by arrival level (`lat`,
    the [m] latency draw, or None: everything arrives now); the fold and
    the commit gate (fl/buffered.fold_commit); the Async/* values; the
    telemetry over the commit decision, with the buffer's sign sums as
    its electorate; with `lanes`, rep_agree against the buffer's
    accumulated vote and rep_norm, over the masked stack; the health
    lanes over the committed params. `carry` and the returned carry are
    fl/buffered.join_carry's."""
    params, state = buffered.split_carry(carry)
    updates, mask, info = _participation(cfg, updates, draw, qmask)
    m = next(iter(updates.values())).shape[0]
    contribs = buffered.tick_contributions(cfg, updates, sizes, mask, lat)
    new_params, new_state, lr, agg, extras, vote_sign = \
        buffered.fold_commit(cfg, params, state, contribs, noise, m)
    info.update(extras)
    if cfg.telemetry != "off":
        info.update(telemetry.compute(
            cfg, updates, lr if cfg.robustLR_threshold > 0 else None, agg,
            mask=mask, corrupt_flags=flags, sign_sums=vote_sign,
            vote_range=buffered.vote_range(cfg)))
    if lanes:
        # agreement with the buffer's accumulated vote, the electorate the
        # commit thresholds, not with this tick's own sign sums
        u_rep = updates if mask is None else masking.zero_masked(updates,
                                                                 mask)
        info["rep_agree"] = reputation.agree_rows(u_rep, vote_sign,
                                                  mask=mask)
        info["rep_norm"] = reputation.norm_rows(u_rep, mask=mask)
    if health_sentinel.health_on(cfg):
        info.update(health_sentinel.sentinel(cfg, updates, new_params,
                                             mask=mask))
    return buffered.join_carry(new_params, new_state), info


def corrupt_slots(cfg, sampled) -> torch.Tensor:
    """[m] bool on the host: the sampled slot holds a malicious agent (the
    first num_corrupt ids), for --faults_spare_corrupt and the telemetry's
    cosine split."""
    return torch.as_tensor(np.asarray(sampled) < cfg.num_corrupt)


def adversary_inputs(cfg, rnd: int, sampled, device, active=None):
    """Round rnd's (hits, flags) inputs of the device work on `device`:
    the [m] slots the update attack hits (attack/registry.attacked_slots:
    the sampled ids' corrupt flags and the schedule gate of round rnd), or
    None without an update strategy; the [m] corrupt-slot flags under
    `--telemetry full` (its cosine split), else None. On the cohort round
    both are ANDed with its `active` mask ([m] bool on the host), JAX's
    `(ids < num_corrupt) & active`."""
    hits = attack_registry.attacked_slots(cfg, sampled, rnd)
    flags = (corrupt_slots(cfg, sampled) if cfg.telemetry == "full"
             else None)
    if active is not None:
        act = torch.as_tensor(np.asarray(active, dtype=bool))
        hits, flags = (None if t is None else t & act for t in (hits, flags))
    return tuple(None if t is None else t.to(device) for t in (hits, flags))


def draw_faults_host(cfg, rng: RoundRNG, rnd: int, sampled, active=None):
    """Round rnd's fault draw for the sampled ids on the host, or None
    when cfg has no faults (the dense round as before). The spared
    attackers are the sampled corrupt ids (on the cohort round, the
    active ones)."""
    if not cfg.faults_enabled:
        return None
    corrupt = corrupt_slots(cfg, sampled)
    if active is not None:
        corrupt = corrupt & torch.as_tensor(np.asarray(active, dtype=bool))
    return fmodel.sample_faults(cfg, rng.faults(rnd), len(sampled), corrupt)


def draw_faults(cfg, rng: RoundRNG, rnd: int, sampled, device, active=None):
    """`draw_faults_host`'s draw on `device`."""
    draw = draw_faults_host(cfg, rng, rnd, sampled, active)
    return None if draw is None else fmodel.draw_to(draw, device)


def tick_inputs(cfg, rng: RoundRNG, rnd: int, sampled, device, faults=None,
                active=None):
    """(fault draw, latency) of round rnd on `device`: the fault draw
    (`faults` when given), and under --agg_mode buffered the [m] int32
    arrival latency drawn from its straggler flags (fl/buffered.latency,
    on the host before the flags go to the card), else None."""
    host = None
    if faults is None:
        host = draw_faults_host(cfg, rng, rnd, sampled, active)
        faults = None if host is None else fmodel.draw_to(host, device)
    if not buffered.is_buffered(cfg) or faults is None:
        return faults, None
    lat = buffered.latency(cfg, rng.latency(rnd), (
        faults if host is None else host).straggler)
    return faults, None if lat is None else _to_device(lat, device)


def _run_chunked(block_fn, params, agents, perms, keep, chunk: int,
                 ep_budget=None):
    """block_fn(params, agents, perms, keep, ep_budget) over the whole [m]
    block, or over sequential [chunk] groups of it with the results
    concatenated: peak activation memory scales with the agents trained at
    once, and the results do not depend on the chunking (each agent trains
    alone). `ep_budget` ([m], faults/) rides the agents axis."""
    m = agents.shape[0]
    if 0 < chunk < m and m % chunk != 0:
        raise ValueError(
            f"--agent_chunk {chunk} does not divide the agent block of {m} "
            f"(per-device agent count); pick a divisor or 0 for the full "
            f"block")
    if chunk <= 0 or chunk >= m:
        return block_fn(params, agents, perms, keep, ep_budget)
    parts = [block_fn(params, agents[lo:lo + chunk], perms[lo:lo + chunk],
                      None if keep is None
                      else tuple(site[lo:lo + chunk] for site in keep),
                      None if ep_budget is None
                      else ep_budget[lo:lo + chunk])
             for lo in range(0, m, chunk)]
    updates = {k: torch.cat([u[k] for u, _ in parts]) for k in parts[0][0]}
    return updates, torch.cat([loss for _, loss in parts])


def vmap_agents(train, params, agents, perms, keep, chunk: int = 0,
                ep_budget=None):
    """The vmap layout's block (fl/client.make_local_train_batched, layout
    'vmap'), optionally in sequential chunks of `chunk` agents."""
    return _run_chunked(train, params, agents, perms, keep, chunk, ep_budget)


def megabatch_agents(train, params, agents, perms, keep, chunk: int = 0,
                     ep_budget=None):
    """The megabatch layout's block (layout 'megabatch'), optionally in
    sequential chunks, each chunk folding its own [chunk*bs] batch."""
    return _run_chunked(train, params, agents, perms, keep, chunk, ep_budget)


class BlockTrainer:
    """The layout-dispatched block trainer over the device-resident
    [K, max_n, ...] stacks:

    train_block(params, rng, rnd, sampled, lo, hi, perms=None,
    dropout=True) -> (updates [hi-lo, ...], losses [hi-lo])

    trains the sampled slots lo..hi-1 of round rnd, each with its own slot
    generator's draws. `perms`, when given, holds every sampled slot's
    epoch permutations. The dense round trains slots 0..m-1; a rank of the
    sharded round its block. `draw` (host loop over slots, draws on the
    device) and `run` (device work only) split the call for the captured
    round."""

    def __init__(self, cfg, model, normalize, images, labels, sizes_host, *,
                 device=None, n_total: Optional[int] = None):
        self.cfg = cfg
        self.layout = compile_cache.resolved_train_layout(cfg)
        self.sites = model.dropout_sites
        self.images, self.labels = images, labels
        # with no stacks of its own (the host round's trainer, whose
        # gathered stacks come with each `run`) the caller names the device
        # and the padded shard length
        self.device = torch.device(device) if images is None else images.device
        self.n_total = n_total if images is None else images.shape[1]
        self.sizes_host = np.asarray(sizes_host)
        self.sizes_dev = torch.as_tensor(self.sizes_host, device=self.device)
        self._train = make_local_train_batched(model, cfg, normalize,
                                               self.layout)

    def draw(self, rng: RoundRNG, rnd: int, sampled, lo: int, hi: int,
             perms: Optional[Sequence] = None, dropout: bool = True,
             slot_sizes=None):
        """(agents [hi-lo] on the device, perms [hi-lo, local_ep, n_total],
        keep: per dropout site [hi-lo, local_ep, nb, bs, F] bool, or
        None). Slot by slot, so one slot's f32 temporaries are alive at a
        time. A slot's shard size is sizes_host[its id], or slot_sizes[slot]
        when given (the cohort round's gathered sizes, on the host)."""
        device, n_total = self.device, self.n_total
        shapes = self.sites if dropout else ()
        perm_rows, keep = [], None
        for i, s in enumerate(range(lo, hi)):
            slot_perms = slot_keep = None
            if perms is None or shapes:
                size = (self.sizes_host[sampled[s]] if slot_sizes is None
                        else slot_sizes[s])
                slot_perms, slot_keep = draw_slot(
                    rng.slot(rnd, s), int(size), n_total, self.cfg, shapes)
            if perms is not None:
                slot_perms = torch.stack([torch.as_tensor(q) for q in
                                          perms[s]]).to(device)
            perm_rows.append(slot_perms)
            if slot_keep is not None:
                if keep is None:
                    keep = tuple(torch.empty((hi - lo,) + k.shape,
                                             dtype=k.dtype, device=device)
                                 for k in slot_keep)
                for block, k in zip(keep, slot_keep):
                    block[i].copy_(k)
        agents = torch.tensor(list(sampled[lo:hi]), dtype=torch.int64)
        if device.type == "cuda":
            # from pinned memory without a sync, so the host can draw the
            # next round while the card still runs this one
            agents = agents.pin_memory().to(device, non_blocking=True)
        return agents, torch.stack(perm_rows), keep

    def run(self, params, agents, perms, keep, data=None, ep_budget=None):
        """Train the block: `agents` index the trainer's stacks, or the
        (images, labels, sizes) of `data` when given (the host round's
        gathered [m, ...] stacks, indexed by slot); `ep_budget` ([m]) cuts
        the stragglers' epochs."""
        images, labels, sizes = data or (self.images, self.labels,
                                         self.sizes_dev)

        def train(params, agents, perms, keep, ep_budget):
            return self._train(params, images, labels, agents, sizes[agents],
                               perms, keep, ep_budget)
        block = vmap_agents if self.layout == "vmap" else megabatch_agents
        return block(train, params, agents, perms, keep,
                     self.cfg.agent_chunk, ep_budget)

    def __call__(self, params, rng: RoundRNG, rnd: int, sampled, lo: int,
                 hi: int, perms: Optional[Sequence] = None,
                 dropout: bool = True):
        return self.run(params, *self.draw(rng, rnd, sampled, lo, hi, perms,
                                           dropout))


def make_block_trainer(cfg, model, normalize, images, labels, sizes_host,
                       **kw):
    """The layout-dispatched block trainer (`BlockTrainer`)."""
    return BlockTrainer(cfg, model, normalize, images, labels, sizes_host,
                        **kw)


def _device_round(cfg, trainer, qset=None):
    """The round's device work: local training of the block (the
    stragglers' budgets from the fault draw when --straggler_rate > 0),
    the update attack, the server path, the loss mean. `draw` is the
    round's FaultDraw or None, `data` as in `BlockTrainer.run`, `hits`
    and `flags` as `adversary_inputs` gives them; `qset` the quarantined
    ids on the device (health/sentinel.quarantine_set), matched against
    `ids` (the cohort's client ids on the device), else `agents`, the
    sampled ids; `active` the [m] presence mask of churn, traffic and the
    cohort's padding (None without), ANDed with the quarantine's into
    JAX's churn_active. With the reputation lanes on
    (obs/reputation.reputation_on), the round's info holds rep_agree and
    rep_norm ([m] each). Under --agg_mode buffered `params` is the carry
    (fl/buffered.join_carry), `lat` the tick's latency draw, the
    stragglers train full epochs and `buffered_path` is the tail."""
    lanes = reputation.reputation_on(cfg)
    is_buffered = buffered.is_buffered(cfg)

    def device_round(params, agents, perms, keep, noise, draw=None,
                     data=None, hits=None, flags=None, active=None,
                     ids=None, lat=None):
        # buffered mode turns the straggler flags into late uploads of
        # full epochs (JAX fl/rounds.py:258-266)
        ep_budget = (draw.ep_budget
                     if draw is not None and cfg.straggler_rate > 0
                     and not is_buffered else None)
        updates, losses = trainer.run(buffered.model_params(params), agents,
                                      perms, keep, data, ep_budget)
        updates = attack_registry.apply_update_attack(cfg, updates, hits)
        sizes = (trainer.sizes_dev if data is None else data[2])[agents]
        qmask = (None if qset is None else health_sentinel.quarantine_mask(
            cfg, agents if ids is None else ids, qset))
        if active is not None:
            qmask = active if qmask is None else active & qmask
        if is_buffered:
            new_params, info = buffered_path(params, updates, sizes, cfg,
                                             noise, draw, qmask, flags,
                                             lanes, lat)
        else:
            new_params, info = server_path(params, updates, sizes, cfg,
                                           noise, draw, qmask, flags, lanes)
        return new_params, {"train_loss": torch.mean(losses), **info}
    return device_round


def make_round_fn(cfg, model, normalize, images, labels, sizes,
                  capture: Optional[bool] = None):
    """Device-resident round fn:
    round(params, rng, sampled=None, perms=None, dropout=True, faults=None)
    -> (params, {"train_loss", "sampled", hlth_*, tel_* and fault_*
    lanes}).

    images [K, max_n, H, W, C] and labels [K, max_n] (int64) are tensors on
    the round's device; sizes is the [K] numpy array of true shard sizes.
    `sampled` ([m] ids) and `perms` (per sampled slot, cfg.local_ep
    permutations) replace the draws from `rng`; dropout=False runs local
    training without dropout; `faults` (a FaultDraw) replaces the round's
    fault draw (and under --agg_mode buffered the stragglers the latency is
    drawn for). A `--quarantine` set leaves its clients out of every vote.
    An update attack scales the rows of the slots it hits
    (`adversary_inputs`, made for each round on the host). Under
    --agg_mode buffered `params` is the carry (fl/buffered.join_carry) and
    so is what it returns.

    `capture` (default: on a CUDA device) runs the round's device work as
    one CUDA graph (utils/compile_cache.RoundGraph): the first round
    eagerly as warm-up, then every round a replay. The params it returns
    are then the graph's static buffers, which the next round overwrites;
    clone them to keep them. capture=False runs every round eagerly, the
    replay's oracle."""
    device = images.device
    trainer = make_block_trainer(cfg, model, normalize, images, labels,
                                 sizes)
    device_round = _device_round(
        cfg, trainer, health_sentinel.quarantine_set(cfg, device))
    if capture is None:
        capture = device.type == "cuda"
    step = compile_cache.RoundGraph(device_round) if capture else device_round

    def round_fn(params, rng: RoundRNG, sampled=None,
                 perms: Optional[Sequence] = None, dropout: bool = True,
                 faults: Optional[fmodel.FaultDraw] = None):
        rnd = rng.next_round()
        if sampled is None:
            sampled = sample_agents(cfg, rng.host)
        sampled = [int(a) for a in sampled]
        draws = trainer.draw(rng, rnd, sampled, 0, len(sampled), perms,
                             dropout)
        noise = draw_noise(buffered.model_params(params), cfg, rng.noise)
        faults, lat = tick_inputs(cfg, rng, rnd, sampled, device, faults)
        here = presence(cfg, sampled, rnd)
        new_params, info = step(params, *draws, noise, faults, None,
                                *adversary_inputs(cfg, rnd, sampled, device),
                                None if here is None
                                else _to_device(here, device), None, lat)
        return new_params, {**info, "sampled": sampled}

    round_fn.graph = step if capture else None
    return round_fn


def make_host_step(cfg, model, normalize, sizes, n_total: int, device):
    """The host-sampled round's device work (JAX `make_host_step`):
    step(params, imgs, lbls, slot_sizes, perms, keep, noise, draw=None,
    hits=None, flags=None)
    -> (params, {"train_loss", hlth_*, tel_* and fault_* lanes}) over the
    gathered stacks
    imgs [m, n_total, H, W, C], lbls [m, n_total] (int64) and slot_sizes
    [m], slot i training row i with its draws perms[i] and keep, and with
    the round's FaultDraw `draw` (or None without faults), `hits` and
    `flags` as `adversary_inputs` gives them. sizes is
    the [K] numpy array of true shard sizes the draws read;
    `step.trainer` draws them (`BlockTrainer.draw`). The refusals of JAX's
    host step (fl/rounds.py:625-671): churn, diurnal traffic, quarantine
    and a scheduled attack are refused with JAX's errors, as the step has
    no channel for the sampled ids or the round index (train.run routes a
    host-sampled run under churn or traffic to the cohort round instead,
    as JAX's driver does). The update attack itself runs: the driver's
    ids give its flags."""
    if cfg.churn_enabled:
        raise ValueError(
            "client churn (--churn_available < 1) is not supported in "
            "host-sampled mode; run device-resident (--host_sampled off)")
    if cfg.traffic_enabled:
        raise ValueError(
            "diurnal traffic (--traffic diurnal) is not supported in "
            "host-sampled mode; run device-resident or cohort-sampled")
    if buffered.is_buffered(cfg):
        raise ValueError(BUFFERED_HOST_SAMPLED)
    if health_sentinel.has_quarantine(cfg):
        raise ValueError(
            "--quarantine is not supported in host-sampled mode (the "
            "program never sees the sampled client ids); run "
            "device-resident (--host_sampled off) or cohort-sampled")
    if attack_registry.needs_round(cfg):
        raise ValueError(
            f"--attack {cfg.attack} with a schedule "
            f"(attack_start/attack_stop/attack_every) is not supported "
            f"in host-sampled mode; run device-resident "
            f"(--host_sampled off) or cohort-sampled")
    device = torch.device(device)
    trainer = make_block_trainer(cfg, model, normalize, None, None, sizes,
                                 device=device, n_total=n_total)
    slots = torch.arange(cfg.agents_per_round, device=device)
    device_round = _device_round(cfg, trainer)

    def step(params, imgs, lbls, slot_sizes, perms, keep, noise, draw=None,
             hits=None, flags=None):
        return device_round(params, slots, perms, keep, noise, draw,
                            (imgs, lbls, slot_sizes), hits, flags)
    step.trainer = trainer
    return step


def make_round_fn_host(cfg, model, normalize, sizes, n_total: int, device,
                       capture: Optional[bool] = None):
    """Host-sampled round fn (JAX `make_round_fn_host`):
    round(params, rng, ids, imgs, lbls, slot_sizes, perms=None,
    dropout=True, faults=None) -> (params, {"train_loss", "sampled",
    hlth_* and fault_* lanes}).

    The driver samples the ids (train.sample_ids) and gathers their shards
    on the host into the stacks of `make_host_step`, on the round's device.
    Slot i draws from rng.slot(rnd, i) with sizes[ids[i]], as slot i of
    the device-resident round does, and draws the same faults for the same
    ids and round, so both rounds give the same params for the same ids.
    `capture` as in `make_round_fn`: on a CUDA device one
    CUDA graph whose static inputs (the gathered stacks among them) each
    round refills."""
    device = torch.device(device)
    m = cfg.agents_per_round
    host_step = make_host_step(cfg, model, normalize, sizes, n_total, device)
    if capture is None:
        capture = device.type == "cuda"
    step = compile_cache.RoundGraph(host_step) if capture else host_step

    def round_fn(params, rng: RoundRNG, ids, imgs, lbls, slot_sizes,
                 perms: Optional[Sequence] = None, dropout: bool = True,
                 faults: Optional[fmodel.FaultDraw] = None):
        rnd = rng.next_round()
        ids = [int(a) for a in ids]
        if len(ids) != m:
            raise ValueError(f"the host round takes m={m} ids, got "
                             f"{len(ids)}")
        _, slot_perms, keep = host_step.trainer.draw(rng, rnd, ids, 0, m,
                                                     perms, dropout)
        noise = draw_noise(params, cfg, rng.noise)
        if faults is None:
            faults = draw_faults(cfg, rng, rnd, ids, device)
        new_params, info = step(params, imgs, lbls, slot_sizes, slot_perms,
                                keep, noise, faults,
                                *adversary_inputs(cfg, rnd, ids, device))
        return new_params, {**info, "sampled": ids}

    round_fn.graph = step if capture else None
    return round_fn


def _chained_row(info) -> dict:
    """The lanes of one round a chained block keeps, copied out before
    the next replay overwrites them: "train_loss", the hlth_*, tel_* and
    rep_* lanes and the CHAINED_INFO_KEYS."""
    return {k: v.clone() for k, v in info.items()
            if k == "train_loss"
            or k.startswith(("hlth_", telemetry.PREFIX, reputation.PREFIX))
            or k in CHAINED_INFO_KEYS}


def _stacked(rows, sampled) -> dict:
    return {**{k: torch.stack([r[k] for r in rows]) for k in rows[0]},
            "sampled": sampled}


def make_chained(round_fn):
    """chained(params, rng, n) -> (params, info): n rounds of round_fn with
    no host sync between them (on a CUDA device, n graph replays), the
    counterpart of JAX's `lax.scan` over a block of rounds. info["sampled"]
    lists each round's ids; the lanes `_chained_row` keeps are stacked
    [n, ...]."""
    def chained(params, rng: RoundRNG, n: int):
        rows, sampled = [], []
        for _ in range(n):
            params, info = round_fn(params, rng)
            sampled.append(info["sampled"])
            rows.append(_chained_row(info))
        return params, _stacked(rows, sampled)
    return chained


def make_chained_host(round_fn):
    """chained(params, rng, block) -> (params, info) over a gathered block
    (JAX `make_chained_host`): `block` holds one argument tuple of
    round_fn after (params, rng) per round, its rows of the [chain, m,
    ...] stacks the driver gathered for the whole unit (train.py,
    data/prefetch.py). Round r of the block is round_fn on row r: on a
    CUDA device one replay of round_fn's captured graph, its static
    inputs refilled from the row's views, nothing allocated on the card;
    so a chained block equals the same rounds dispatched one at a time.
    The info is stacked as `make_chained` stacks it.

    JAX's chained host scan has no per-round flag channel: its driver
    unchains a host-sampled run under faults or an update attack, which
    the port's driver does too (compile_cache.chain_budget), and under
    `--telemetry full` its cosine split sees every slot as honest. Here
    each round keeps its own flags, so the split stays exact."""
    def chained(params, rng: RoundRNG, block):
        rows, sampled = [], []
        for args in block:
            params, info = round_fn(params, rng, *args)
            sampled.append(info["sampled"])
            rows.append(_chained_row(info))
        return params, _stacked(rows, sampled)
    chained.graph = round_fn.graph
    return chained


def make_chained_round_fn(cfg, model, normalize, images, labels, sizes):
    """chained(params, rng, n) over this config's round (`make_chained`)."""
    return make_chained(make_round_fn(cfg, model, normalize, images, labels,
                                      sizes))


def make_chained_round_fn_host(cfg, model, normalize, sizes, n_total: int,
                               device):
    """chained(params, rng, block) over this config's host-sampled round
    (`make_chained_host`; diagnostics off, as JAX's)."""
    return make_chained_host(make_round_fn_host(
        cfg.replace(diagnostics=False), model, normalize, sizes, n_total,
        device))


# ------------------------------------------------------- cohort-sampled ---

def make_cohort_step(cfg, model, normalize, n_total: int, device):
    """The cohort-sampled round's device work (JAX `make_cohort_step`):
    step(params, ids, active, imgs, lbls, slot_sizes, perms, keep, noise,
    draw=None, hits=None, flags=None) -> (params, {"train_loss", hlth_*,
    tel_*, rep_* and fault_* lanes, churn_away}).

    The data arrives gathered on the host like the host-sampled round's
    ([m, n_total, ...] stacks of the cohort's bank rows, data/bank.py),
    with the cohort's client ids `ids` ([m] int64 on the device) and its
    `active` mask ([m] bool: False on shortfall padding), both drawn on
    the host by data/cohort.sample_cohort and inputs of the captured
    round, so one graph serves every round and every cohort. So, as in
    JAX:

    - the corrupt flags are real client ids, `(ids < num_corrupt) &
      active` (`adversary_inputs`, `draw_faults`): the Defense/* cosine
      split and the Faults/* rates follow cohort membership, not slot
      position;
    - a quarantined member leaves `active` before the corrupt flags are
      made from it (the round fn, JAX fl/rounds.py:794-799): the fault
      draw does not spare it and the attack does not hit it; the device
      round ANDs `quarantine_mask(ids)` into the mask again;
    - `active` always joins the participation mask (the padding is left
      out of aggregation like a dropped client), so the fused kernel is
      off (`_fused_applicable`), and under churn the away count is the
      mask's complement (Churn/Sampled_Away)."""
    device = torch.device(device)
    trainer = make_block_trainer(cfg, model, normalize, None, None,
                                 np.zeros(0, dtype=np.int32), device=device,
                                 n_total=n_total)
    slots = torch.arange(cfg.agents_per_round, device=device)
    device_round = _device_round(
        cfg, trainer, health_sentinel.quarantine_set(cfg, device))

    def step(params, ids, active, imgs, lbls, slot_sizes, perms, keep,
             noise, draw=None, hits=None, flags=None, lat=None):
        return device_round(params, slots, perms, keep, noise, draw,
                            (imgs, lbls, slot_sizes), hits, flags, active,
                            ids, lat)
    step.trainer = trainer
    return step


def make_cohort_round_fn(cfg, model, normalize, n_total: int, device,
                         capture: Optional[bool] = None):
    """Cohort-sampled round fn (JAX `make_cohort_round_fn`):
    round(params, rng, ids, imgs, lbls, slot_sizes, active, host_sizes,
    perms=None, dropout=True, faults=None) -> (params, {"train_loss",
    "sampled", ... lanes}).

    `ids` and `active` are round rng.round + 1's cohort
    (data/cohort.sample_cohort), `imgs`, `lbls`, `slot_sizes` its gathered
    rows on the round's device (CohortData.gather_cohort, or the dense
    host stacks' rows), `host_sizes` the same sizes on the host (the slot
    draws read them). Slot i draws from rng.slot(rnd, i), as slot i of
    every other round does, and the fault draw spares the active corrupt
    members. `capture` as in `make_round_fn`: on a CUDA device one graph
    whose static inputs (the ids, the mask and the stacks among them)
    each round refills."""
    device = torch.device(device)
    m = cfg.agents_per_round
    cohort_step = make_cohort_step(cfg, model, normalize, n_total, device)
    if capture is None:
        capture = device.type == "cuda"
    step = compile_cache.RoundGraph(cohort_step) if capture else cohort_step

    def round_fn(params, rng: RoundRNG, ids, imgs, lbls, slot_sizes, active,
                 host_sizes, perms: Optional[Sequence] = None,
                 dropout: bool = True,
                 faults: Optional[fmodel.FaultDraw] = None):
        rnd = rng.next_round()
        ids = [int(a) for a in ids]
        active = np.array(active, dtype=bool)
        if len(ids) != m or active.shape != (m,):
            raise ValueError(f"the cohort round takes m={m} ids and an "
                             f"[m] mask, got {len(ids)} and "
                             f"{active.shape}")
        if health_sentinel.has_quarantine(cfg):
            # a quarantined member leaves `active` before the corrupt
            # flags are made from it (JAX fl/rounds.py:794-799): the fault
            # draw does not spare it and the attack does not hit it
            active &= ~np.isin(ids, health_sentinel.quarantine_ids(cfg))
        _, slot_perms, keep = cohort_step.trainer.draw(
            rng, rnd, ids, 0, m, perms, dropout, slot_sizes=host_sizes)
        noise = draw_noise(buffered.model_params(params), cfg, rng.noise)
        faults, lat = tick_inputs(cfg, rng, rnd, ids, device, faults,
                                  active)
        ids_dev, act_dev = (_to_device(torch.as_tensor(a), device)
                            for a in (np.asarray(ids, dtype=np.int64),
                                      active))
        new_params, info = step(
            params, ids_dev, act_dev, imgs, lbls, slot_sizes, slot_perms,
            keep, noise, faults,
            *adversary_inputs(cfg, rnd, ids, device, active), lat)
        return new_params, {**info, "sampled": ids}

    round_fn.graph = step if capture else None
    return round_fn


def make_chained_cohort_round_fn(cfg, model, normalize, n_total: int,
                                 device):
    """chained(params, rng, block) over this config's cohort round
    (`make_chained_host`): each row of the block one round's (ids,
    stacks, active, host sizes). Faults, update attacks and the
    telemetry's split keep their flags, as in JAX's chained cohort scan,
    which re-derives them from the scanned round index."""
    return make_chained_host(make_cohort_round_fn(
        cfg.replace(diagnostics=False), model, normalize, n_total, device))


def _to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A small host tensor on `device`: from pinned memory without a sync
    on a card."""
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
