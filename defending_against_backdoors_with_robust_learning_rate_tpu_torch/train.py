"""The experiment driver: seed, data, rounds, eval every `snap` rounds.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
train.py` (`run`, `main`, the `RoundEngine` loop, its `_emit_eval_body`
rows, `_emit_diagnostics` and `save_checkpoint`, `dispatch_schedule`);
reference src/federated.py:21-95. The loop is the JAX one's without its
service hooks: it walks `dispatch_schedule`'s units, one round or a
chained block of `--chain` rounds (fl/rounds.make_chained: on a card,
that many graph replays with no host sync between them), and at each
`snap` boundary the clean and poisoned val sets are evaluated and the
reference's scalars written to metrics.jsonl. The boundary's values come
back in one device-to-host copy (utils/metrics.fetch); with the async
metrics drain (JAX train.py:998-1010, on by default, `--sync_metrics`
turns it off; off under --diagnostics and on the sharded round) that copy
and the rows run on a background thread (utils/metrics.MetricsDrain)
while the next rounds run, and the drain is flushed before each
checkpoint save and at the end. One code path writes the rows in both
modes, so metrics.jsonl is the same apart from its wall-clock rows; a
health abort raises at the next submit, flush or close, as JAX's does.
The boundary is judged as JAX's `_emit_eval_body` judges it
(train.py:1332-1370): the health monitor's `assess` over the health
lanes and the params' finite
bit, then `emit_rows` (the Health/* rows), then `enforce` (the policy:
record warns, abort raises), the reference's rows and a faults run's
Faults/* rows, then the Defense/* rows of `--telemetry` (JAX
train.py:1287-1289, :1387-1389); the monitor's EMA state is committed
last; then the rounds' reputation rows since the last boundary are
folded into the tracker (obs/reputation.py) and its Reputation/* rows
written after the Defense/* rows (JAX train.py:1390-1410). Faults
(`--dropout_rate`, `--straggler_rate`, `--corrupt_rate`,
`--payload_norm_cap`) are drawn inside the round fns (fl/rounds.py), the
corrupt-slot flags from the sampled ids; a `--quarantine` set is printed
at the start (JAX train.py:208-211) and masked inside the round. The
attack config is checked and its banner printed before anything is built
(JAX train.py:212-216), and so is the telemetry's (:242-243); the slots
the update attack hits are marked inside the round fns for each round.

Checkpoint and resume (JAX train.py:826-856, :1483-1525): with
--checkpoint_dir, every eval boundary saves the params, the round, the
`RoundRNG` state, cum_poison_acc and cum_net_mov on the lead after its
rows (utils/checkpoint.save, every checkpoint kept), then journals the
metrics offset, the health EMA and, with the lanes on, the tracker's
state. --resume restores the newest valid checkpoint before the first
round (so the captured round starts from the restored params), the
journal entry's EMA and tracker state, and starts `dispatch_schedule` at
the restored round: a resumed run writes the uninterrupted run's params
and rows, apart from `_run/start` and the Throughput/* rows, which count
the rounds of this life.

Diagnostics (--diagnostics, JAX train.py:340-342, :1217-1247): the snap
rounds run a second round fn (fl/rounds.py: the plain server step, with
the agent norms and the flat lr), dispatched unchained; before one runs,
the params are cloned, and after it the Norms/* and Sign/* rows are
written (the Fisher at the cloned params), before the boundary's rows.
--train_layout megabatch degrades to vmap, with JAX's line.

The run happens on `cfg.device` (default `cuda`). A run on `cuda` with no
card raises; it never carries on on the CPU.

--mesh (JAX train.py:332-391): d = pick_agent_mesh_size(--mesh, m, cards).
On one card d = 1 and the dense round runs, as JAX on one chip. d > 1 is
one process per card over NCCL, launched by `torchrun` (or with
--coordinator/--num_processes/--process_id); every rank runs the sharded
round (parallel/rounds.py) and the lead rank alone evaluates, writes the
metrics and prints. `run(cfg, group=...)` takes an `agents` group that the
caller built (the tests' and chip_smoke.py's ranks sharing one device).
The sharded round runs every rule, the server noise, the faults, the
quarantine, churn and diurnal traffic, the telemetry and `--agg_layout
bucket` (parallel/rounds.py); its `[agg]` line prints the round's
collectives by kind (parallel/multihost.plan_collectives), and the
summary carries the counts the run made (`collectives`).

Host-sampled mode (JAX train.py:299-303, :629-695; `--host_sampled`, by
default when the shard stacks pass utils/compile_cache.
DEVICE_RESIDENT_BYTES): the stacks stay on the host; each round's ids come
from `sample_ids` (a numpy generator seeded from the seed and the round,
JAX's draw exactly), their shards are gathered into [m, ...] stacks and
copied to the card (data/prefetch.HostGather), `--host_prefetch` rounds
ahead on a worker thread (data/prefetch.RoundPrefetcher), and the round
runs on them (fl/rounds.make_round_fn_host). A chained unit's rounds are
gathered as one [chain, m, ...] block and replayed one a row
(fl/rounds.make_chained_host); under faults or an update attack the host
round stays unchained, with JAX's line. The units whose rounds capture a
graph (the first, and the first diagnostics snap round) are gathered in
line. A sharded host-sampled round is not ported yet, nor are
checkpoints, diagnostics or the reputation lanes on the sharded round
(`--reputation auto` resolves off there; ROADMAP queue 1 item 11).

Cohort-sampled mode (JAX train.py:263-330, :392-470; `--cohort_sampled
on`, or auto at 4,096 clients or more with a samplable cohort,
utils/compile_cache.is_cohort_mode, decided from the config before any
data is built): the population lives in a client bank on disk
(data/registry.get_cohort_data, data/bank.py); each round's cohort ids
and `active` mask are drawn on the host (data/cohort.sample_cohort, a
pure function of the seeds and the round, so a resumed run draws the
same cohorts), their rows gathered from the bank, poisoned where the
member is corrupt, and copied to the card like the host round's
(`_host_units`, data/prefetch.HostGather), and the round runs on them
(fl/rounds.make_cohort_round_fn), the ids and mask inputs of its one
captured graph; `--chain` gathers blocks as above. A host-sampled run
under churn or diurnal traffic takes the cohort round over the dense
host stacks, with JAX's line, or raises JAX's error when it cannot.
Churn and traffic on the dense round and on the device-resident sharded
round mask their sampled ids (fl/rounds.presence); under churn the
boundary writes Churn/Sampled_Away after the Faults/* rows (JAX
train.py:1371-1373). Refused with their ROADMAP items: the sharded cohort
round and `--agg_mode buffered` on the sharded round (item 11),
`--tenants` and `--chaos` (item 15).

Buffered-async aggregation (`--agg_mode buffered`, fl/buffered.py; JAX
train.py:219-226, :697-718): checked and its `[async]` banner printed
before anything is built; refused in host-sampled mode and on the sharded
round (JAX's multi-process refusal), with JAX's messages. The loop's
params are then the carry (fl/buffered.join_carry: the model params and
the buffer state in one dict), so the captured round, the chained round
and the checkpoint carry the buffer beside the params, and a run cut
between commits resumes to the straight run's params and rows; eval, the
finite bit and the summary read the bare model params (JAX
train.py:1055-1059). Each boundary writes the Async/Buffer_Fill,
Async/Committed and Async/Staleness_Hist/<b> rows after the Faults/*
rows (JAX train.py:1374-1386).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import numpy as np
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.attack import (
    registry as attack_registry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    BUFFERED_HOST_SAMPLED, BUFFERED_SHARDED_NOT_PORTED, RLR_ADAPT_NOT_PORTED,
    SHARDED_COHORT_NOT_PORTED, Config, args_parser, check_not_ported,
    print_exp_details)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data import (
    cohort as cohort_mod)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data.prefetch import (
    HostGather, RoundPrefetcher)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data.registry import (
    get_cohort_data, get_federated_data)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl.common import (
    make_normalizer)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    buffered, diagnostics)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl.evaluate import (
    make_eval_fn, pad_eval_set)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl.rounds import (
    RoundRNG, make_chained, make_chained_host, make_cohort_round_fn,
    make_round_fn, make_round_fn_host)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.health import (
    monitor as health_monitor, sentinel as health_sentinel)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models.registry import (
    get_model, init_params, param_count)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.obs import (
    reputation as obs_reputation, telemetry as obs_telemetry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel import (
    multihost)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.mesh import (
    AgentsGroup, pick_agent_mesh_size)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.rounds import (
    BUCKET_DIAGNOSTICS, make_sharded_round_fn)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils import (
    checkpoint as ckpt, compile_cache)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils.guards import (
    all_finite_device)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils.metrics import (
    FAULT_TAGS, MetricsDrain, MetricsWriter, async_rows, fault_rows, fetch,
    run_name)


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} asked for, but torch sees no "
                           f"CUDA device")
    return device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dispatch_schedule(start, total, snap, chain_n, diagnostics, chaining):
    """The run loop's dispatch plan (JAX `train.dispatch_schedule`): a list of
    round-id tuples, one per dispatch — a chained block (len == chain_n)
    whenever the budget to the next eval boundary allows, else a single
    round. A chained block never crosses an eval boundary, and a
    diagnostics run keeps its snap rounds unchained."""
    units, rnd = [], start
    while rnd < total:
        to_eval = min(snap - rnd % snap, total - rnd)
        diag_boundary = diagnostics and (rnd + to_eval) % snap == 0
        budget = to_eval - (1 if diag_boundary else 0)
        if chaining and budget >= chain_n:
            units.append(tuple(range(rnd + 1, rnd + chain_n + 1)))
            rnd += chain_n
        else:
            units.append((rnd + 1,))
            rnd += 1
    return units


def sample_ids(cfg: Config, rnd: int, cohort: bool = False) -> np.ndarray:
    """Round rnd's m agent ids in host-sampled mode: m distinct ids from a
    generator per round, so a resumed run continues the same sequence
    (JAX train.py's `sample_ids`, the same draws); on a cohort run the
    round's cohort (data/cohort.sample_cohort, a pure function of
    cohort_seed, churn_seed, traffic_seed and the round), whose `active`
    mask `sample_unit` gives beside it."""
    if cohort:
        return cohort_mod.sample_cohort_host(cfg, rnd)[0]
    rng = np.random.default_rng(cfg.seed * 100_003 + rnd)
    return rng.choice(cfg.num_agents, cfg.agents_per_round, replace=False)


def sample_unit(cfg: Config, unit, cohort: bool = False):
    """(ids, active) of a dispatch unit: one round's [m] or a chained
    block's [chain, m]; active is None off the cohort round."""
    if not cohort:
        ids = np.stack([sample_ids(cfg, r) for r in unit])
        return (ids[0], None) if len(unit) == 1 else (ids, None)
    drawn = [cohort_mod.sample_cohort_host(cfg, r) for r in unit]
    ids = np.stack([d[0] for d in drawn])
    active = np.stack([d[1] for d in drawn])
    return (ids[0], active[0]) if len(unit) == 1 else (ids, active)


def unit_rounds(payload, cohort: bool = False):
    """The round fn's arguments after (params, rng) for each round of a
    gathered unit, in order: (ids, imgs, lbls, sizes), and on the cohort
    round the `active` mask and the host sizes after them; a chained
    block's rows are views of its [chain, m, ...] stacks."""
    cols = list(payload.ready())
    if cohort:
        cols += [payload.active, payload.host_sizes]
    if cols[0].ndim == 1:
        return [tuple(cols)]
    return [tuple(c[r] for c in cols) for r in range(cols[0].shape[0])]


def _host_units(cfg: Config, source, device, units, stack, say,
                inline: int = 1, cohort: bool = False):
    """get_unit(unit) -> the unit's gathered `Payload` in host-sampled or
    cohort mode: its ids drawn (`sample_unit`) and their rows gathered
    from `source` (data/prefetch.HostGather: the dense host stacks, or the
    cohort's `gather_cohort`), a chained unit's as one [chain, m, ...]
    block. The first `inline` units are gathered in line: their rounds
    are the ones whose CUDA graphs are captured (the first unit's, and
    under --diagnostics the first snap round's), and no other thread may
    allocate or copy on the card while a stream captures. From the next
    on, with --host_prefetch N, a worker gathers up to N units ahead;
    `stack` closes it."""
    gather = HostGather(source, device)

    def gather_unit(unit):
        return gather(*sample_unit(cfg, unit, cohort))
    if cfg.host_prefetch <= 0:
        return gather_unit
    say(f"[prefetch] {'cohort gather' if cohort else 'host->device'} "
        f"pipeline, depth {cfg.host_prefetch}")
    prefetcher = None

    def get_unit(unit):
        nonlocal prefetcher
        if unit in units[:inline]:
            return gather_unit(unit)
        if prefetcher is None:
            prefetcher = RoundPrefetcher(gather_unit, units[inline:],
                                         depth=cfg.host_prefetch)
            stack.callback(prefetcher.close)
        return prefetcher.get(unit)
    return get_unit


def _agents_group(cfg: Config) -> Optional[AgentsGroup]:
    """The `agents` group of a multi-card launch, or None for the dense
    round. A --mesh that asks for several cards from one process raises:
    the port runs one process per card."""
    group = multihost.maybe_initialize(cfg.coordinator, cfg.num_processes,
                                       cfg.process_id)
    if group is not None:
        multihost.require_pod_divisible(cfg.agents_per_round, "multi-card",
                                        group.size)
        return group
    cards = (torch.cuda.device_count()
             if torch.device(cfg.device).type == "cuda" else 1)
    d = pick_agent_mesh_size(cfg.mesh, cfg.agents_per_round, cards)
    if d > 1:
        raise ValueError(
            f"--mesh {cfg.mesh} picks {d} cards for m="
            f"{cfg.agents_per_round}; the port runs one process per card: "
            f"torchrun --nproc_per_node {d} -m "
            f"defending_against_backdoors_with_robust_learning_rate_tpu_torch"
            f" --mesh {cfg.mesh} ...")
    return None


def _sharded_cfg(cfg: Config, say) -> Config:
    """cfg for the sharded round: what it has not ported refused, and
    `--reputation auto` resolved off, with a printed line."""
    if buffered.is_buffered(cfg):
        raise ValueError(BUFFERED_SHARDED_NOT_PORTED)
    if compile_cache.is_cohort_mode(cfg):
        raise ValueError(SHARDED_COHORT_NOT_PORTED)
    if cfg.agg_layout == "bucket" and cfg.diagnostics:
        raise ValueError(BUCKET_DIAGNOSTICS)
    for flag, on in (("--diagnostics", cfg.diagnostics),
                     ("--checkpoint_dir", bool(cfg.checkpoint_dir)),
                     ("--resume", cfg.resume)):
        if on:
            raise ValueError(f"{flag} on the sharded round is not ported "
                             f"yet (ROADMAP queue 1 item 11); the dense, "
                             f"chained and host-sampled rounds have it")
    if cfg.reputation == "on":
        raise ValueError(obs_reputation.NOT_PORTED_SHARDED)
    if obs_reputation.reputation_on(cfg):
        say("[reputation] the sharded round does not compute the lanes "
            "(not ported yet): --reputation auto resolves off")
        cfg = cfg.replace(reputation="off")
    return cfg


def _resolve_layout(cfg: Config, say) -> Config:
    """--train_layout megabatch degrades to vmap under --diagnostics, with
    JAX's line (compile_cache.resolved_train_layout is the rule)."""
    resolved = compile_cache.resolved_train_layout(cfg)
    if cfg.train_layout == resolved:
        return cfg
    say(f"[layout] --train_layout {cfg.train_layout} does not support "
        f"--diagnostics (per-client loss curves need the per-client axis); "
        f"degrading this run to --train_layout {resolved} — drop "
        f"--diagnostics to keep the {cfg.train_layout} layout")
    return cfg.replace(train_layout=resolved)


def _emit_diagnostics(cfg: Config, writer, rnd: int, info, params, prev,
                      fisher_fn, pval, cum_net_mov: float) -> float:
    """A snap round's Norms/* and (RLR on) Sign/* rows (JAX
    `_emit_diagnostics`): the Fisher at the params before the round
    (`prev`), on the poisoned val set and on it relabeled to base_class;
    returns the new cumulative net movement."""
    norms = info["agent_norms"].cpu().numpy()
    for tag, v in diagnostics.norm_scalars(norms, info["sampled"],
                                           cfg.num_corrupt).items():
        writer.scalar(tag, v, rnd)
    if "lr_flat" not in info:
        return cum_net_mov
    f_adv = diagnostics.flat(fisher_fn(prev, *pval))
    hon_labels = torch.full_like(pval[1], cfg.base_class)
    f_hon = diagnostics.flat(fisher_fn(prev, pval[0], hon_labels, pval[2]))
    upd = diagnostics.flat(params) - diagnostics.flat(prev)
    scalars, cum_net_mov = diagnostics.sign_agreement(
        *(t.cpu().numpy() for t in (info["lr_flat"], upd, f_adv, f_hon)),
        cfg.top_frac, cfg.effective_server_lr, cum_net_mov)
    for tag, v in scalars.items():
        writer.scalar(tag, v, rnd)
    return cum_net_mov


def _copied(v):
    """A round output kept past the next replay: a tensor is cloned on its
    device (a replay's outputs are the graph's buffers)."""
    return v.clone() if isinstance(v, torch.Tensor) else v


def _fold_pending(tracker, pending) -> None:
    """Fold the rounds' rep rows since the last boundary, in order: each
    (round ids, sampled ids, rep_agree, rep_norm), one round's [m] rows
    or a chained block's [n, m]."""
    for rnds, ids, agrees, norms in pending:
        agrees, norms = agrees.tolist(), norms.tolist()
        if len(rnds) == 1:
            tracker.fold(rnds[0], ids, agrees, norms)
        else:
            for j, r in enumerate(rnds):
                tracker.fold(r, ids[j], agrees[j], norms[j])


def run(cfg: Config, group: Optional[AgentsGroup] = None) -> Dict:
    """Train cfg.rounds rounds; returns the last boundary's summary (on
    every rank of a sharded run: its params and the run's collectives by
    kind; on the lead: the metrics)."""
    obs_telemetry.check_level(cfg.telemetry)
    health_monitor.check(cfg)
    # the attack config, loudly and before any build (attack/registry.py:
    # unknown strategy, bad boost, a schedule on a data-side strategy)
    attack_registry.check(cfg)
    obs_reputation.check(cfg)
    # the buffered compositions JAX refuses, each naming its remedy
    buffered.check(cfg)
    if cfg.rlr_adapt == "on":
        raise ValueError(RLR_ADAPT_NOT_PORTED)
    check_not_ported(cfg)
    if group is None:
        group = _agents_group(cfg)
    device = group.device if group is not None else resolve_device(
        cfg.device)
    lead = multihost.is_lead(group)
    say = print if lead else (lambda *a, **k: None)
    if group is not None:
        cfg = _sharded_cfg(cfg, say)
    cfg = _resolve_layout(cfg, say)
    if lead:
        print_exp_details(cfg)
    if health_sentinel.has_quarantine(cfg):
        say(f"[health] quarantined clients: "
            f"{list(health_sentinel.quarantine_ids(cfg))} "
            f"(excluded via the participation mask)")
    atk_banner = attack_registry.banner(cfg)
    if atk_banner:
        say(atk_banner)
    async_banner = buffered.banner(cfg)
    if async_banner:
        say(async_banner)
    if cfg.telemetry != "off":
        say(f"[telemetry] in-jit defense telemetry: {cfg.telemetry} "
            f"(Defense/* scalars ride the metrics stream)")
    # the config alone decides the cohort round first: a million-client
    # population is never stacked densely to find out (JAX train.py:
    # 263-286); the client bank holds it on disk, and `fed` carries a
    # zero-client shape shim and the eval sets
    cohort_mode = compile_cache.is_cohort_mode(cfg)
    if (not cohort_mode and cfg.cohort_sampled == "auto"
            and cfg.num_agents >= compile_cache.COHORT_AUTO_MIN_POPULATION):
        say(f"[cohort] population {cfg.num_agents:,} is above the auto "
            f"threshold but the implied cohort of {cfg.agents_per_round} "
            f"cannot be sampled (data/cohort.py MAX_CANDIDATES); staying "
            f"on the dense path — set --cohort_size to decouple "
            f"population from cohort")
    cohort_src = None
    if cohort_mode:
        cohort_src = fed = get_cohort_data(cfg)
    else:
        fed = get_federated_data(cfg)
    if fed.synthetic:
        say(f"[data] no {cfg.data} files under {cfg.data_dir!r}: "
            f"synthetic stand-in, {cfg.synth_train_size} train / "
            f"{cfg.synth_val_size} val")
    model = get_model(cfg.data, cfg.image_shape, cfg.n_classes,
                      cfg.model_arch, cfg.dtype, cfg.remat, cfg.remat_policy)
    params = init_params(model, cfg.seed, device)
    say(f"[model] {type(model).__name__}: {param_count(params):,} params "
        f"on {device}")
    normalize = make_normalizer(fed.mean, fed.std, device,
                                fed.raw_is_normalized)
    rng = RoundRNG(cfg.seed, device)
    # the per-client suspicion ledger, on the lead (the writer's process):
    # the host fold of the rounds' rep_agree / rep_norm lanes
    tracker = (obs_reputation.ReputationTracker.for_config(
        cfg, population=cfg.num_agents)
        if obs_reputation.reputation_on(cfg) and lead else None)
    # the ground truth touches only the AUC row, never the ranking
    rep_pred = ((lambda cid: cid < cfg.num_corrupt)
                if cfg.num_corrupt > 0 else None)
    if tracker is not None and tracker.sketch_mode:
        say(f"[reputation] population {cfg.num_agents:,} > cap "
            f"{cfg.rep_population_cap:,}: count-min sketch + "
            f"top-{cfg.rep_topk} heavy-hitter ledger "
            f"(O(cohort + k) RSS)")
    is_buffered = buffered.is_buffered(cfg)
    if is_buffered:
        # the loop's params become the (params, buffer) carry: the
        # captured and chained rounds and the checkpoint carry the buffer
        # beside the params (JAX train.py:709-718)
        params = buffered.join_carry(params,
                                     buffered.init_state(cfg, params, True))
    start_round, cum_poison_acc, cum_net_mov = 0, 0.0, 0.0
    health_ema = None
    if cfg.resume and cfg.checkpoint_dir:
        # before the first round, so the round is captured on these params
        restored = ckpt.restore(cfg.checkpoint_dir, params)
        if restored is not None:
            (start_round, saved, rng_state, cum_poison_acc,
             cum_net_mov) = restored
            params = {k: saved[k].to(device) for k in params}
            rng.load_state(rng_state)
            # the health EMA and the suspicion ledger ride the journal
            # entry of the round restored
            for entry in ckpt.journal_read(cfg.checkpoint_dir):
                if entry["round"] == start_round:
                    health_ema = entry.get("health") or None
                    if tracker is not None:
                        tracker.load_state(entry.get("reputation") or None)
            say(f"[ckpt] resumed from round {start_round}")
    chain_n = compile_cache.chain_budget(cfg)
    host_mode = not cohort_mode and compile_cache.is_host_mode(cfg, fed)
    if host_mode and (cfg.churn_enabled or cfg.traffic_enabled):
        # a host-sampled run under churn or traffic takes the cohort
        # round, its cohorts drawn from the present set over the dense
        # host stacks (JAX train.py:304-330)
        what = "churn" if cfg.churn_enabled else "traffic"
        if not compile_cache.is_cohort_mode(cfg, fed):
            raise ValueError(
                f"host-sampled + {what} needs the cohort program "
                f"(cohorts sampled from the {what}-present set), but "
                "this config cannot take it: --cohort_sampled is "
                "'off', or the implied cohort of "
                f"{cfg.agents_per_round} clients is not samplable "
                "(data/cohort.py MAX_CANDIDATES) — set "
                "--cohort_size, raise availability, or disable "
                f"{what}")
        cohort_mode, host_mode = True, False
        say(f"[cohort] host-sampled + {what}: cohorts are sampled from the "
            f"{what}-present set (the refusal path is retired)")
    if is_buffered and host_mode:
        raise ValueError(BUFFERED_HOST_SAMPLED)
    # the snap rounds of --diagnostics run a second round fn, with the
    # plain server step and the diagnostics' extras; every other round
    # runs the round fn of cfg without them (JAX's plain/diag pair)
    plain_cfg = cfg.replace(diagnostics=False)
    diag_fn = None
    source = None       # what a host-sampled or cohort unit gathers from
    if (host_mode or cohort_mode) and group is not None:
        raise ValueError(SHARDED_COHORT_NOT_PORTED if cohort_mode else
                         "the sharded host-sampled round is not ported yet "
                         "(ROADMAP queue 1 item 11)")
    if cohort_mode:
        m = cfg.agents_per_round
        if cohort_src is not None:
            say(f"[cohort] population {cfg.num_agents:,} clients -> {m}-"
                f"client cohorts ({cfg.partitioner} client bank, "
                f"{cohort_src.max_n} rows/cohort member; drawn on the "
                f"host, cohort_seed {cfg.cohort_seed})")
            source, n_total = cohort_src.gather_cohort, cohort_src.max_n
        else:
            say(f"[cohort] {cfg.num_agents} clients -> {m}-client cohorts "
                f"sampled from the churn-present set over the host shard "
                f"stacks")
            source, n_total = fed.train, fed.train.max_n

        def build(c):
            return make_cohort_round_fn(c, model, normalize, n_total, device)
    elif host_mode:
        say(f"[data] host-sampled mode "
            f"({fed.train.images.nbytes / 2**30:.1f} GiB of shards)")
        if chain_n > 1 and compile_cache.chain_budget(cfg, True) == 1:
            tag, why = (("faults", "faults") if cfg.faults_enabled
                        else ("attack", f"--attack {cfg.attack}"))
            say(f"[{tag}] host-sampled mode: --chain disabled ({why} needs "
                f"per-round corrupt flags riding each dispatch)")
            chain_n = 1
        source = fed.train

        def build(c):
            return make_round_fn_host(c, model, normalize, fed.train.sizes,
                                      fed.train.max_n, device)
    elif group is None:
        images = torch.from_numpy(fed.train.images).to(device)
        labels = torch.from_numpy(fed.train.labels).to(device, torch.int64)
        def build(c):
            return make_round_fn(c, model, normalize, images, labels,
                                 fed.train.sizes)
    elif chain_n > 1:
        raise ValueError("--chain > 1 on the sharded round is not ported "
                         "yet (ROADMAP queue 1 item 11: the sharded round "
                         "runs eagerly, one round a dispatch)")
    else:
        m = cfg.agents_per_round
        say(f"[mesh] {group.size} devices on the `agents` axis "
            f"({m // group.size} agents/device), {group.size} process(es)")
        say(f"[agg] {multihost.agg_plan_note(cfg, params, group)}")
        images = torch.from_numpy(fed.train.images).to(device)
        labels = torch.from_numpy(fed.train.labels).to(device, torch.int64)
        round_fn = make_sharded_round_fn(cfg, model, normalize, group,
                                         images, labels, fed.train.sizes)
    if group is None:
        round_fn = build(plain_cfg)
        diag_fn = build(cfg) if cfg.diagnostics else None
    if group is None:
        say(f"[train] layout {compile_cache.resolved_train_layout(cfg)}, "
            f"agent chunk {cfg.agent_chunk or 'all'}, round "
            + ("captured as one CUDA graph" if round_fn.graph is not None
               else "eager"))
    if diag_fn is not None:
        say("[diagnostics] snap rounds run the plain server step (the "
            "explicit lr vector)"
            + (" as a second CUDA graph" if diag_fn.graph is not None
               else "") + "; the other rounds keep the fused kernel")
    eval_fn = make_eval_fn(model, normalize, cfg.n_classes)
    fisher_fn = (diagnostics.make_fisher_fn(model, normalize)
                 if cfg.diagnostics else None)
    val, pval = (tuple(torch.from_numpy(a).to(device)
                       for a in pad_eval_set(x, y, cfg.eval_bs))
                 for x, y in ((fed.val_images, fed.val_labels),
                              (fed.pval_images, fed.pval_labels)))
    gathered = source is not None
    chained = None
    if chain_n > 1:
        chained = (make_chained_host if gathered else make_chained)(round_fn)
        say(f"[chain] {chain_n} rounds per dispatch"
            + (" (gathered blocks)" if gathered else ""))
    units = dispatch_schedule(start_round, cfg.rounds, cfg.snap, chain_n,
                              cfg.diagnostics, chained is not None)

    def diag_unit(unit):
        return diag_fn is not None and unit[0] % cfg.snap == 0
    # the boundary's state, which `emit` advances: on the drain's thread in
    # async mode, so the main thread reads it only after a flush
    state = {"summary": {}, "cum_poison_acc": cum_poison_acc,
             "health_ema": health_ema}
    clock = {"t_loop": None, "t_steady": None, "r_steady": None}

    def emit(fetched, rnd, rounds_now):
        """One eval boundary's host side: its rows, the health policy, the
        run summary, in JAX's `_emit_eval_body` order. `fetched` is the
        boundary's (values, reputation rows) on the host. Sync mode calls
        it in line, async mode on the drain's thread: one code path, so
        metrics.jsonl is the same in both."""
        host, rep_rows = fetched
        vals = {k: (v.tolist() if getattr(v, "ndim", 0) else float(v))
                for k, v in host.items()}
        now = time.perf_counter()
        elapsed = now - clock["t_loop"]
        # the health policy first, as JAX's _emit_eval_body: its rows, then
        # record warns or abort raises; its EMA state is committed last
        report = health_monitor.assess(cfg, state["health_ema"], vals)
        health_monitor.emit_rows(writer, report, rnd)
        health_monitor.enforce(cfg, report, where=f"round {rnd}")
        cum = state["cum_poison_acc"] + vals["poison_acc"]
        # scalar names preserved from reference src/federated.py:81-91
        writer.scalar("Validation/Loss", vals["val_loss"], rnd)
        writer.scalar("Validation/Accuracy", vals["val_acc"], rnd)
        writer.scalar("Poison/Base_Class_Accuracy", vals["base_acc"], rnd)
        writer.scalar("Poison/Poison_Accuracy", vals["poison_acc"], rnd)
        writer.scalar("Poison/Poison_Loss", vals["poison_loss"], rnd)
        writer.scalar("Poison/Cumulative_Poison_Accuracy_Mean", cum / rnd,
                      rnd)
        writer.scalar("Train/Loss", vals["train_loss"], rnd)
        for tag, value in {**fault_rows(vals), **async_rows(vals)}.items():
            writer.scalar(tag, value, rnd)
        obs_telemetry.emit_scalars(writer, vals, rnd)
        if tracker is not None:
            _fold_pending(tracker, rep_rows)
            obs_reputation.emit_rows(writer, tracker, rnd, rep_pred)
        # the rounds of this life (a resumed run counts from its restore),
        # as JAX's rounds_done
        writer.scalar("Throughput/Rounds_Per_Sec", rounds_now / elapsed, rnd)
        steady = ((rounds_now - clock["r_steady"])
                  / (now - clock["t_steady"])
                  if rounds_now > clock["r_steady"] else None)
        if steady is not None:
            writer.scalar("Throughput/Steady_Rounds_Per_Sec", steady, rnd)
        writer.flush()
        print(f"| Rnd {rnd}: Val_Loss/Val_Acc: {vals['val_loss']:.3f} / "
              f"{vals['val_acc']:.3f} |")
        print(f"| Rnd {rnd}: Poison Loss/Poison Acc: "
              f"{vals['poison_loss']:.3f} / {vals['poison_acc']:.3f} |")
        summary = {"round": rnd, "rounds_per_sec": rounds_now / elapsed,
                   "steady_rounds_per_sec": steady, **vals}
        defense = obs_telemetry.host_summary(vals)
        if defense:
            summary["defense"] = defense
        if tracker is not None:
            summary["suspicion"] = tracker.summary(rep_pred)
        state.update(summary=summary, cum_poison_acc=cum,
                     health_ema=report["new_state"])

    # the async drain (JAX train.py:998-1010): not under --diagnostics,
    # whose rows need host values in line, and on one process only
    drain = (MetricsDrain() if lead and group is None and cfg.async_metrics
             and not cfg.diagnostics else None)
    if drain is not None:
        say("[metrics] async drain: host syncs ride a background thread "
            "(--sync_metrics restores the inline path)")
    rounds_done = 0
    rep_pending = []
    with (MetricsWriter(cfg.log_dir, run_name(cfg), cfg.tensorboard)
          if lead else contextlib.nullcontext()) as writer, \
            contextlib.ExitStack() as stack:
        if drain is not None:
            # on an error the loop's own exception wins; a clean end
            # closes it below and re-raises what the drain hit
            stack.callback(drain.close, raise_errors=False)
        if gathered:
            # gathered in line up to the first snap round of --diagnostics:
            # its round fn's graph is captured there
            inline = 1 + next((i for i, u in enumerate(units)
                               if diag_unit(u)), 0)
            get_unit = _host_units(cfg, source, device, units, stack, say,
                                   inline, cohort_mode)
        _sync(device)
        clock["t_loop"] = time.perf_counter()
        for unit in units:
            want_diag = diag_unit(unit)
            if len(unit) > 1:
                params, stacked = chained(
                    params, rng, unit_rounds(get_unit(unit), cohort_mode)
                    if gathered else len(unit))
                info = {k: v[-1] for k, v in stacked.items()}
                if tracker is not None:
                    rep_pending.append((unit, stacked["sampled"],
                                        stacked["rep_agree"],
                                        stacked["rep_norm"]))
            else:
                fn = diag_fn if want_diag else round_fn
                # the Fisher is taken at the params before the round, which
                # a replay overwrites
                prev = ({k: v.clone() for k, v in params.items()}
                        if want_diag else None)
                if gathered:
                    (args,) = unit_rounds(get_unit(unit), cohort_mode)
                    params, info = fn(params, rng, *args)
                else:
                    params, info = fn(params, rng)
                if tracker is not None:
                    # a replay's outputs are the graph's buffers: copied
                    # out on the device, fetched at the boundary
                    rep_pending.append((unit, info["sampled"],
                                        info["rep_agree"].clone(),
                                        info["rep_norm"].clone()))
            rnd = unit[-1]
            rounds_done += len(unit)
            if clock["t_steady"] is None:
                # the first dispatch pays the one-off costs (kernel build,
                # cuDNN plans, allocator growth, the round's capture);
                # steady time starts after it
                _sync(device)
                clock["t_steady"] = time.perf_counter()
                clock["r_steady"] = rounds_done
            if want_diag and lead:
                cum_net_mov = _emit_diagnostics(cfg, writer, rnd, info,
                                                params, prev, fisher_fn,
                                                pval, cum_net_mov)
            if rnd % cfg.snap or not lead:
                continue
            # eval and the finite bit read the bare model params
            model_params = buffered.model_params(params)
            val_loss, val_acc, per_class = eval_fn(model_params, *val)
            poison_loss, poison_acc, _ = eval_fn(model_params, *pval)
            # the boundary's device values, copied out of the replay's
            # buffers (the next replay overwrites them); every scalar comes
            # back to the host in one copy (`fetch`), in line or on the
            # drain's thread. The defense telemetry rides the same copy.
            dev = {"finite": all_finite_device(model_params),
                   "val_loss": val_loss, "val_acc": val_acc,
                   "base_acc": per_class[cfg.base_class],
                   "poison_loss": poison_loss, "poison_acc": poison_acc,
                   **{k: _copied(info[k]) for k in (
                       "train_loss",
                       *health_sentinel.boundary_keys(cfg),
                       *(k for k in FAULT_TAGS if k in info),
                       *(k for k in ("churn_away",
                                     *buffered.ASYNC_INFO_KEYS)
                         if k in info),
                       *(k for k in info
                         if k.startswith(obs_telemetry.PREFIX)))}}
            if drain is not None:
                drain.submit(emit, (dev, rep_pending), rnd, rounds_done)
            else:
                emit(fetch((dev, rep_pending)), rnd, rounds_done)
            rep_pending = []
            if cfg.checkpoint_dir:
                # after the boundary's rows and state (the drain flushed
                # first, as JAX's save_checkpoint); the one-shot trainer
                # keeps every checkpoint (JAX's keep of 0)
                if drain is not None:
                    drain.flush()
                ckpt.save(cfg.checkpoint_dir, rnd, params, rng.state_dict(),
                          state["cum_poison_acc"], cum_net_mov)
                extra = {"health": state["health_ema"]}
                if tracker is not None:
                    extra["reputation"] = tracker.state_dict()
                ckpt.journal_record(cfg.checkpoint_dir, rnd, writer.offset(),
                                    **extra)
        if drain is not None:
            drain.close()
    summary = state["summary"]
    say("Training has finished!")
    if summary:
        steady = summary["steady_rounds_per_sec"]
        say(f"[throughput] {summary['rounds_per_sec']:.3f} rounds/sec "
            f"on {device}, eval included"
            + (f"; {steady:.3f} steady, after the first dispatch"
               if steady is not None else ""))
    summary["params"], state = buffered.split_carry(params)
    if is_buffered:
        summary["buffer"] = state
    summary["cum_net_mov"] = cum_net_mov
    summary["all_reduces"] = (group.counts["all_reduce"] if group is not None
                              else 0)
    summary["collectives"] = dict(group.counts) if group is not None else {}
    return summary


def main(argv=None) -> int:
    try:
        run(args_parser(argv))
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
