"""Main-path configuration: the JAX CLI's flag names and defaults, cut to
the fields the port runs (slice 1's dense round, slice 2's sharded round
and health lanes, slice 4's batched local training and chained round,
slice 5's cifar10 and fedemnist data, ResNet-9 and host-sampled round,
slice 6's server rules avg|comed|sign|trmean|krum|rfa, the fault model,
the quarantine set and the health monitor's policy, slice 7's attack
registry and schedule, the watermark patterns, the defense telemetry and
the TensorBoard sink, slice 8's checkpoint and resume, the reputation
lanes and tracker, and the reference's diagnostics, slice 9's population
axis: churn, the cohort and its client bank, diurnal traffic, slice 10's
compute dtype, ResNet-9 rematerialization and the async metrics drain,
slice 11's buffered-async aggregation).

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
config.py` (`Config`, `args_parser`, `print_exp_details`). Every field here
keeps the JAX name and default; flags the port does not run yet are not
accepted, so a command line that asks for one fails instead of being
quietly ignored (`--tenants` and `--chaos` are parsed only to be refused
with the ROADMAP item that ports them).

Port-only fields:
- ``device`` (default ``cuda``): where the round runs. A run on ``cuda``
  with no card raises; it never carries on on the CPU.
- ``use_fused`` (default on, ``--no_fused`` turns it off): the fused RLR
  server kernel (`ops/rlr_fused.py`) is the server step wherever
  `fl/rounds._fused_applicable` holds. In JAX the Pallas kernel is the
  opt-in ``--use_pallas``.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from typing import Optional

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.attack import (
    registry as attack_registry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data import (
    native)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data.bank import (
    PARTITIONERS)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data.traffic import (
    TRAFFIC_MODES)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.faults import (
    model as fmodel)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    buffered)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.health import (
    monitor as health_monitor)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.obs import (
    reputation)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.obs.telemetry import (
    LEVELS as TELEMETRY_LEVELS)

AGGRS = ("avg", "comed", "sign", "trmean", "krum", "rfa")   # ops/aggregate.py
RLR_THRESHOLD_MODES = ("abs", "scaled")
DATASETS = ("fmnist", "cifar10", "fedemnist", "synthetic")
ARCHS = ("auto", "cnn", "resnet9")
HOST_SAMPLED = ("auto", "on", "off")
PATTERNS = ("plus", "square", "copyright", "apple")
ATTACKS = tuple(attack_registry.REGISTRY)   # static | dba | boost | signflip
AGG_LAYOUTS = ("leaf", "bucket")    # the sharded round's layouts
TRAIN_LAYOUTS = ("vmap", "megabatch")
COHORT_SAMPLED = ("auto", "on", "off")


@dataclasses.dataclass(frozen=True)
class Config:
    # --- reference flag surface (names + defaults as in the JAX Config) ---
    data: str = "fmnist"            # fmnist | cifar10 | fedemnist | synthetic
    num_agents: int = 10            # K
    agent_frac: float = 1.0         # C, fraction of agents sampled per round
    num_corrupt: int = 0            # first num_corrupt agent ids are malicious
    rounds: int = 200
    aggr: str = "avg"               # avg | comed | sign | trmean | krum | rfa
    local_ep: int = 2
    bs: int = 256
    client_lr: float = 0.1
    client_moment: float = 0.9
    server_lr: float = 1.0          # only used as-is for aggr='sign'
    base_class: int = 5
    target_class: int = 7
    poison_frac: float = 0.0
    pattern_type: str = "plus"      # plus | square | copyright | apple
    robustLR_threshold: int = 0     # >0 enables the RLR defense
    clip: float = 0.0               # >0 enables client-side PGD L2 projection
    noise: float = 0.0              # >0 adds N(0, noise*clip) server noise
    snap: int = 1                   # eval every `snap` rounds
    seed: int = 0
    data_dir: str = "./data"
    log_dir: str = "./logs"
    eval_bs: int = 1024
    synth_train_size: int = 2048
    synth_val_size: int = 512
    synth_hardness: float = 0.0
    arch: str = "auto"              # auto | cnn | resnet9
    dtype: str = "f32"              # f32 | bf16: the models' compute dtype
                                    # (params, grads and updates stay f32)
    remat: bool = False             # ResNet-9's blockwise
                                    # rematerialization (models/remat.py):
                                    # backward recomputes each block's
                                    # activations instead of keeping them
                                    # (exact; the CNNs ignore it)
    remat_policy: str = "block"     # block: recompute everything per block;
                                    # conv: keep the convolutions' outputs
                                    # and recompute only the GroupNorm,
                                    # relu and pool tail
    # --- multi-card (JAX parallel/multihost.py, parallel/mesh.py) ---
    coordinator: str = ""           # host:port of rank 0's rendezvous
    num_processes: int = 0          # total processes (one per card)
    process_id: int = -1            # this process's rank; -1 = from env
    mesh: int = 1                   # ranks on the `agents` axis; 0 = all
    agg_layout: str = "leaf"        # leaf (packed all_reduce) | bucket
    # --- fault injection and participation (JAX faults/) ---
    dropout_rate: float = 0.0       # per-round Bernoulli client dropout
    straggler_rate: float = 0.0     # per-round straggler probability
    straggler_epochs: int = 1       # local epochs a straggler completes
    corrupt_rate: float = 0.0       # per-round corrupt-payload probability
    corrupt_mode: str = "nan"       # nan | huge (1e30 finite constant)
    payload_norm_cap: float = 0.0   # >0: server rejects updates with L2
                                    # norm above the cap (validation mask)
    faults_spare_corrupt: bool = False  # attackers never drop out
    rlr_threshold_mode: str = "abs"  # abs: the paper's vote count; scaled:
                                    # threshold * n_eff / m
    # --- health lanes (JAX health/sentinel.py) and policy (monitor.py) ---
    health: str = "on"              # on | off
    health_policy: str = "record"   # abort | record (recover: not ported)
    health_z_threshold: float = 6.0  # loss z-score above which a boundary
                                    # is an incident
    health_spike_factor: float = 10.0  # update-norm spike: norm > factor x
                                    # its EMA baseline
    quarantine: str = ""            # comma-separated client ids taken out
                                    # of every vote (participation mask)
    # --- adaptive-adversary attack registry (JAX attack/registry.py) ---
    attack: str = "static"          # static | dba | boost | signflip —
                                    # the corrupt cohort's strategy:
                                    # static = the paper's trojan (data
                                    # poisoning only); dba = the full
                                    # pattern dealt across corrupt agents
                                    # (attack/dba.py); boost / signflip =
                                    # update transforms applied in the
                                    # round right after local training
    attack_boost: float = 1.0       # model-replacement scale on corrupt
                                    # updates (boost: x+boost, signflip:
                                    # x-boost); 1.0 = magnitude-preserving
    attack_start: int = 0           # attack schedule (attack/schedule.py;
                                    # rounds are 1-based): dormant before
                                    # this round
    attack_stop: int = 0            # 0 = never stop; start=k, stop=k+1
                                    # is the one-shot attack
    attack_every: int = 1           # intermittent: fire every n-th round
                                    # from attack_start
    # --- online RLR-threshold adaptation (JAX attack/adapt.py) ---
    rlr_adapt: str = "off"          # off | on (on: not ported yet)
    rlr_adapt_every: int = 2        # decide at most every N eval
                                    # boundaries
    # --- observability (JAX obs/telemetry.py, utils/metrics.py) ---
    telemetry: str = "off"          # off | basic | full — defense
                                    # telemetry: norm percentiles + RLR
                                    # flip fraction (basic), + vote-margin
                                    # histogram and honest/corrupt cosine
                                    # split (full). off adds nothing to the
                                    # round: training is bit-identical.
    tensorboard: bool = True        # JSONL metrics always; TB optional
    # --- per-client reputation (JAX obs/reputation.py) ---
    reputation: str = "auto"        # auto | on | off — the rep_agree and
                                    # rep_norm lanes of every round, folded
                                    # into a per-client suspicion ledger
                                    # (Reputation/* rows). auto = on
                                    # whenever a sign vote exists
                                    # (robustLR_threshold > 0 or aggr
                                    # 'sign'); off removes the lanes, and
                                    # training is bit-identical
    rep_population_cap: int = 100000  # dense per-client state up to this
                                    # population; a count-min sketch +
                                    # top-k ledger above it
    rep_topk: int = 64              # heavy-hitter ledger width
    rep_streak: int = 3             # consecutive vote-losing rounds before
                                    # a client counts as a suspect
    # --- research diagnostics (JAX fl/diagnostics.py; reference C13) ---
    diagnostics: bool = False       # Norms/* + Sign/* rows at snap rounds
    top_frac: int = 100             # sign-agreement diagnostic top-k params
    # --- checkpoint and resume (JAX utils/checkpoint.py) ---
    checkpoint_dir: str = ""        # "" disables checkpointing
    resume: bool = False
    # --- local-training layout and dispatch (JAX fl/rounds.py) ---
    train_layout: str = "vmap"      # vmap | megabatch (fl/client.py)
    agent_chunk: int = 0            # >0: train agents in sequential chunks
                                    # of this size; must divide the block
    chain: int = 1                  # rounds per dispatch (capped at snap)
    # --- host-sampled round (JAX fl/rounds.make_round_fn_host) ---
    host_prefetch: int = 2          # rounds gathered and copied ahead of
                                    # the compute (0 = synchronous)
    host_sampled: str = "auto"      # auto: shard stacks above the device-
                                    # resident budget (2 GiB) gather on the
                                    # host per round; on/off forces the mode
    # --- client churn (JAX service/churn.py) ---
    churn_available: float = 1.0    # fraction of lifecycle phases a client
                                    # is present; 1.0 = no churn (the round
                                    # as before); < 1 masks away clients
                                    # out of the participation mask
    churn_period: int = 32          # rounds per lifecycle phase
    churn_seed: int = 0             # seeds the lifecycle draws (not --seed)
    # --- the population axis (JAX data/bank.py, data/cohort.py) ---
    cohort_sampled: str = "auto"    # auto | on | off: train a seeded
                                    # per-round cohort gathered from the
                                    # client bank (auto: on at >= 4096
                                    # clients, utils/compile_cache.
                                    # is_cohort_mode)
    cohort_size: int = 0            # per-round cohort m; 0 = the
                                    # reference's floor(num_agents *
                                    # agent_frac)
    cohort_seed: int = 0            # seeds the cohort draw (not --seed)
    partitioner: str = "label_shards"  # label_shards (the paper's dealing
                                    # scheme) | dirichlet | pathological
    dirichlet_alpha: float = 0.5    # Dir(alpha) class-mixture
                                    # concentration
    classes_per_client: int = 2     # pathological: distinct classes a
                                    # client holds
    samples_per_client: int = 0     # dirichlet / pathological shard size;
                                    # 0 = clamp(n / K, 16, 4096)
    bank_dir: str = ""              # client-bank directory ("" = under
                                    # data_dir/client_banks, else log_dir)
    bank_shard_clients: int = 65536  # clients per bank index file (layout
                                    # only; the content does not depend
                                    # on it)
    bank_build_workers: int = 1     # processes building the bank (the
                                    # published bank is the serial one's)
    bank_verify: bool = False       # check each reused index file against
                                    # its sha256 sidecar
    # --- diurnal traffic (JAX data/traffic.py) ---
    traffic: str = "flat"           # flat | diurnal: seeded per-client
                                    # timezones and a raised-cosine daily
                                    # availability in the participation
                                    # mask
    traffic_seed: int = 0           # seeds the traffic draws (not --seed)
    traffic_peak_frac: float = 0.8  # availability at a client's local peak
    traffic_trough_frac: float = 0.1  # availability at its local trough
    traffic_day_rounds: int = 64    # rounds per simulated day
    traffic_latency_sigma: float = 0.8  # log-normal sigma of the buffered
                                    # path's staleness draw under diurnal
                                    # traffic (data/traffic.py
                                    # latency_quantile)
    # --- buffered-async aggregation (JAX fl/buffered.py) ---
    agg_mode: str = "sync"          # sync | buffered: sync aggregates every
                                    # round; buffered folds each arriving
                                    # update into a carried staleness-
                                    # weighted buffer and commits once
                                    # --async_buffer_k updates arrived; a
                                    # straggler's update lands T ticks late
                                    # (no epoch cut). avg/sign (+- RLR)
    async_buffer_k: int = 0         # arrivals per commit; 0 = the cohort
                                    # size m (staleness 0 then reproduces
                                    # the sync path)
    async_staleness_exp: float = 0.0  # an arrival of staleness T folds with
                                    # weight 1/(1+T)^a; 0 = unweighted
    async_max_staleness: int = 4    # max latency draw T (ticks) of a
                                    # straggler; bounds the pending state
                                    # and the staleness bins
    # --- JAX paths not ported, accepted only to be refused by name ---
    tenants: int = 0                # tenant packs (not ported)
    chaos: str = ""                 # the service driver's drills (not
                                    # ported)
    # --- metrics (JAX utils/metrics.MetricsDrain) ---
    async_metrics: bool = True      # a boundary's scalars are fetched and
                                    # written on a background thread (one
                                    # batched device-to-host copy), so the
                                    # round loop never waits on them;
                                    # --sync_metrics opts out. Diagnostics
                                    # and sharded runs are always
                                    # synchronous
    # --- port-only ---
    device: str = "cuda"
    use_fused: bool = True

    @property
    def effective_server_lr(self) -> float:
        """server_lr is forced to 1.0 unless aggr=='sign' (JAX config.py:510-512,
        reference src/federated.py:23)."""
        return self.server_lr if self.aggr == "sign" else 1.0

    @property
    def faults_enabled(self) -> bool:
        """Any nonzero fault rate, or a payload norm cap (which needs the
        server-side validation and the mask), routes the round through the
        faults path (JAX config.py:487-493); all off keeps the dense round
        as it was."""
        return (self.dropout_rate > 0 or self.straggler_rate > 0
                or self.corrupt_rate > 0 or self.payload_norm_cap > 0)

    @property
    def churn_enabled(self) -> bool:
        """Churn is on when availability is a real fraction; its mask then
        joins the participation mask (JAX config.py:496-500)."""
        return self.churn_available < 1.0

    @property
    def traffic_enabled(self) -> bool:
        """Diurnal traffic is on when the model is not flat (JAX
        config.py:503-507)."""
        return self.traffic != "flat"

    @property
    def agents_per_round(self) -> int:
        """The per-round cohort m: an explicit --cohort_size wins, else the
        reference's floor(K * C) (src/federated.py:68; JAX
        config.py:515-523)."""
        if self.cohort_size > 0:
            return self.cohort_size
        return max(1, math.floor(self.num_agents * self.agent_frac))

    @property
    def n_classes(self) -> int:
        # the reference hardcodes 10 everywhere, fedemnist eval included
        return 10

    @property
    def image_shape(self):
        if self.data in ("fmnist", "fedemnist"):
            return (28, 28, 1)
        if self.data in ("cifar10", "synthetic"):
            return (32, 32, 3) if self.data == "cifar10" else (8, 8, 1)
        raise ValueError(f"unknown dataset {self.data!r}")

    @property
    def model_arch(self) -> str:
        if self.arch != "auto":
            return self.arch
        return "cnn"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def build_parser() -> argparse.ArgumentParser:
    d = Config()
    p = argparse.ArgumentParser(
        description="robust-learning-rate federated learning (PyTorch/CUDA)")
    for f in dataclasses.fields(Config):
        if f.name in ("use_fused", "host_sampled", "aggr", "corrupt_mode",
                      "rlr_threshold_mode", "health_policy",
                      "faults_spare_corrupt", "quarantine", "attack",
                      "attack_boost", "attack_start", "attack_stop",
                      "attack_every", "rlr_adapt", "rlr_adapt_every",
                      "telemetry", "tensorboard", "reputation",
                      "diagnostics", "resume", "cohort_sampled",
                      "partitioner", "bank_verify", "traffic", "agg_mode",
                      "remat", "remat_policy", "async_metrics",
                      "async_buffer_k", "async_staleness_exp",
                      "async_max_staleness", "traffic_latency_sigma"):
            continue
        p.add_argument(f"--{f.name}", type=type(getattr(d, f.name)),
                       default=getattr(d, f.name))
    p.add_argument("--aggr", choices=AGGRS, default=d.aggr,
                   help="aggregation function")
    p.add_argument("--corrupt_mode", choices=fmodel.CORRUPT_MODES,
                   default=d.corrupt_mode,
                   help="corrupt-payload flavor: nan (caught by the finite "
                        "check) or huge (1e30 finite: needs "
                        "--payload_norm_cap or a robust rule)")
    p.add_argument("--faults_spare_corrupt", action="store_true",
                   help="malicious agents (id < num_corrupt) never drop out")
    p.add_argument("--rlr_threshold_mode", choices=RLR_THRESHOLD_MODES,
                   default=d.rlr_threshold_mode,
                   help="RLR vote threshold under faults: abs = the paper's "
                        "count; scaled = threshold * n_eff / m")
    p.add_argument("--health_policy", choices=health_monitor.POLICIES,
                   default=d.health_policy,
                   help="numerics-incident policy (health/monitor.py): "
                        "abort raises, record warns and keeps recording; "
                        "recover (the ladder) is refused: not ported yet")
    p.add_argument("--quarantine", type=str, default=d.quarantine,
                   help="comma-separated client ids excluded from every "
                        "round's participation mask (device-resident "
                        "rounds)")
    p.add_argument("--attack", choices=ATTACKS, default=d.attack,
                   help="adaptive-adversary strategy (attack/registry.py):"
                        " static = the paper's trojan (bitwise the legacy "
                        "poison path); dba = distributed trigger split "
                        "across corrupt agents; boost = model-replacement "
                        "scaling of corrupt updates; signflip = RLR-aware "
                        "anti-vote (corrupt updates negated)")
    p.add_argument("--attack_boost", type=float, default=d.attack_boost,
                   help="corrupt-update scale for the in-jit strategies "
                        "(boost applies +x, signflip applies -x)")
    p.add_argument("--attack_start", type=int, default=d.attack_start,
                   help="attack schedule: dormant before this round "
                        "(late-start; rounds are 1-based; in-jit "
                        "strategies only)")
    p.add_argument("--attack_stop", type=int, default=d.attack_stop,
                   help="attack schedule: inactive from this round on "
                        "(0 = never; start=k stop=k+1 is one-shot)")
    p.add_argument("--attack_every", type=int, default=d.attack_every,
                   help="attack schedule: fire every n-th round from "
                        "--attack_start (intermittent)")
    p.add_argument("--rlr_adapt", choices=("off", "on"),
                   default=d.rlr_adapt,
                   help="service mode: adapt --robustLR_threshold online "
                        "from mid-run Defense/* telemetry at eval "
                        "boundaries (attack/adapt.py; needs --telemetry "
                        "full and --checkpoint_dir; on is refused: not "
                        "ported yet)")
    p.add_argument("--rlr_adapt_every", type=int, default=d.rlr_adapt_every,
                   help="threshold-adaptation cadence: decide at most "
                        "every N eval boundaries")
    p.add_argument("--telemetry", choices=TELEMETRY_LEVELS,
                   default=d.telemetry,
                   help="in-jit defense telemetry (obs/telemetry.py): "
                        "basic = update-norm percentiles + RLR flip "
                        "fraction; full adds the vote-margin histogram "
                        "and honest/corrupt cosine split. off is "
                        "bit-identical to a build without it")
    p.add_argument("--no_tensorboard", action="store_true")
    p.add_argument("--reputation", choices=reputation.MODES,
                   default=d.reputation,
                   help="per-client defense-provenance lanes "
                        "(obs/reputation.py): rep_agree + rep_norm per "
                        "sampled client, folded into a longitudinal "
                        "suspicion ledger (Reputation/* rows). auto = on "
                        "when a sign vote exists; off is bit-identical")
    p.add_argument("--diagnostics", action="store_true",
                   help="log Norms/* and Sign/* research scalars "
                        "(the reference's dead-code diagnostics, C13)")
    p.add_argument("--resume", action="store_true",
                   help="restore the newest valid checkpoint under "
                        "--checkpoint_dir before the first round")
    p.add_argument("--debug_nan", action="store_true",
                   help="JAX's checkify float checks in the round (refused: "
                        "not ported yet)")
    p.add_argument("--host_sampled", choices=HOST_SAMPLED,
                   default=d.host_sampled,
                   help="force host-sampled shard gathering on/off "
                        "(auto: stacks above the 2 GiB device-resident "
                        "budget gather on host per round)")
    p.add_argument("--remat", action="store_true",
                   help="blockwise rematerialization of the model forward "
                        "(ResNet-9): recompute activations in backward "
                        "instead of stashing them — exact, saves HBM")
    p.add_argument("--remat_policy", type=str, default=d.remat_policy,
                   choices=("block", "conv"),
                   help="remat flavor: block = recompute everything; conv "
                        "= save conv (MXU) outputs, recompute only the "
                        "elementwise tail")
    p.add_argument("--sync_metrics", action="store_true",
                   help="force the synchronous metrics path (float() host "
                        "sync every eval boundary) instead of the async "
                        "background drain")
    p.add_argument("--cohort_sampled", choices=COHORT_SAMPLED,
                   default=d.cohort_sampled,
                   help="population/cohort decoupling (data/bank.py + "
                        "data/cohort.py): the round trains a seeded "
                        "per-round cohort gathered from a sharded "
                        "memory-mapped client bank — host/HBM memory is "
                        "constant in population size (auto: on at >= "
                        "4096 clients)")
    p.add_argument("--partitioner", choices=PARTITIONERS,
                   default=d.partitioner,
                   help="client-bank partitioner: label_shards = the "
                        "paper's dealing scheme (exact, small K); "
                        "dirichlet / pathological = per-client-seeded "
                        "non-IID draws that scale to millions of clients")
    p.add_argument("--bank_verify", action="store_true",
                   help="verify the client bank's per-shard sha256 "
                        "sidecars on open; a corrupted indices-*.bin "
                        "fails loudly naming the shard")
    p.add_argument("--traffic", choices=TRAFFIC_MODES, default=d.traffic,
                   help="traffic model (data/traffic.py): flat = every "
                        "path as before; diurnal = seeded per-client "
                        "timezones + raised-cosine daily availability "
                        "into the participation mask")
    p.add_argument("--traffic_latency_sigma", type=float,
                   default=d.traffic_latency_sigma,
                   help="log-normal sigma of the buffered-mode staleness "
                        "draw (clipped to [1, max_staleness])")
    p.add_argument("--agg_mode", choices=("sync", "buffered"),
                   default=d.agg_mode,
                   help="aggregation mode (fl/buffered.py): sync = every "
                        "round barriers on the slowest client (the "
                        "historical path); buffered = FedBuff-shape — "
                        "arriving updates fold into a persistent "
                        "staleness-weighted buffer carried across ticks, "
                        "the server commits when --async_buffer_k have "
                        "arrived, and a straggling client's update lands "
                        "T ticks later with staleness T (avg/sign ± RLR "
                        "only)")
    p.add_argument("--async_buffer_k", type=int, default=d.async_buffer_k,
                   help="buffered mode: arrivals per commit (0 = auto: "
                        "the cohort size m — staleness-0 then reproduces "
                        "the sync path)")
    p.add_argument("--async_staleness_exp", type=float,
                   default=d.async_staleness_exp,
                   help="buffered mode: staleness-weight exponent a — an "
                        "arrival with staleness T folds with weight "
                        "1/(1+T)^a (0 = unweighted)")
    p.add_argument("--async_max_staleness", type=int,
                   default=d.async_max_staleness,
                   help="buffered mode: max latency draw in ticks for a "
                        "straggling client (bounds the carried pending "
                        "state and the staleness telemetry bins)")
    p.add_argument("--no_fused", action="store_true",
                   help="server step through ops/aggregate.py instead of "
                        "the fused RLR kernel")
    return p


def args_parser(argv: Optional[list] = None) -> Config:
    """Parse CLI flags into a Config (JAX `config.args_parser`), refusing
    what the port does not run yet and naming the missing piece."""
    ns = build_parser().parse_args(argv)
    kw = {k: v for k, v in vars(ns).items()
          if k not in ("no_fused", "debug_nan", "no_tensorboard",
                       "sync_metrics")}
    cfg = Config(use_fused=not ns.no_fused,
                 tensorboard=not ns.no_tensorboard,
                 async_metrics=not ns.sync_metrics, **kw)
    if ns.debug_nan:
        raise ValueError("--debug_nan (JAX's checkify float checks in the "
                         "round) is not ported yet; the health lanes and "
                         "--health_policy abort judge every boundary")
    if cfg.agg_layout not in AGG_LAYOUTS:
        raise ValueError(f"--agg_layout must be one of {AGG_LAYOUTS}, got "
                         f"{cfg.agg_layout!r}")
    health_monitor.check(cfg)
    if cfg.train_layout not in TRAIN_LAYOUTS:
        raise ValueError(f"--train_layout must be one of {TRAIN_LAYOUTS}, "
                         f"got {cfg.train_layout!r}")
    if cfg.data not in DATASETS:
        raise ValueError(f"--data must be one of {DATASETS}, got "
                         f"{cfg.data!r}")
    if cfg.arch not in ARCHS:
        raise ValueError(f"--arch must be one of {ARCHS}, got {cfg.arch!r}")
    if cfg.pattern_type not in PATTERNS:
        raise ValueError(f"--pattern_type must be one of {PATTERNS}, got "
                         f"{cfg.pattern_type!r}")
    attack_registry.check(cfg)
    reputation.check(cfg)
    buffered.check(cfg)
    if cfg.rlr_adapt == "on":
        raise ValueError(RLR_ADAPT_NOT_PORTED)
    check_not_ported(cfg)
    return cfg


def check_not_ported(cfg: Config) -> None:
    """Refuse, by name and ROADMAP item, the JAX paths the population
    axis's flags reach that the port has not yet."""
    if cfg.tenants > 0:
        raise ValueError(TENANTS_NOT_PORTED)
    if cfg.chaos:
        raise ValueError(CHAOS_NOT_PORTED)


RLR_ADAPT_NOT_PORTED = (
    "--rlr_adapt on (attack/adapt.py: the service driver's online "
    "threshold adaptation) is not ported yet; it needs the service driver "
    "and checkpoints")
TENANTS_NOT_PORTED = (
    "--tenants (fl/tenancy.py: tenant packs of experiments, run by the "
    "service queue) is not ported yet (ROADMAP queue 1 item 15); run one "
    "experiment a process")
BUFFERED_SHARDED_NOT_PORTED = (
    "--agg_mode buffered on the sharded round is not ported yet (ROADMAP "
    "queue 1 item 11: the buffered fold over the agents group); run the "
    "dense, chained or cohort round on one card")
BUFFERED_HOST_SAMPLED = (
    "--agg_mode buffered is not supported in host-sampled mode (this "
    "dataset is above the device-resident budget and the host step has "
    "no channel for the arrival draw); run cohort-sampled "
    "(--cohort_sampled on) so the round program owns the cohort, or "
    "--agg_mode sync")
CHAOS_NOT_PORTED = (
    "--chaos (service/chaos.py: the service driver's fault drills, "
    "bank_corrupt among them) is not ported yet (ROADMAP queue 1 item 15)")
SHARDED_COHORT_NOT_PORTED = (
    "the sharded cohort round (JAX make_sharded_cohort_round_fn) is not "
    "ported yet (ROADMAP queue 1 item 11); run the cohort-sampled round on "
    "one card, or churn and traffic on the device-resident sharded round")


def print_exp_details(cfg: Config) -> None:
    """Banner matching the JAX driver's (reference src/utils.py:287-303)."""
    print("======================================")
    print(f"    Dataset: {cfg.data}")
    print(f"    Global Rounds: {cfg.rounds}")
    print(f"    Aggregation Function: {cfg.aggr}")
    print(f"    Number of agents: {cfg.num_agents}")
    print(f"    Fraction of agents: {cfg.agent_frac}")
    print(f"    Batch size: {cfg.bs}")
    print(f"    Client_LR: {cfg.client_lr}")
    print(f"    Server_LR: {cfg.effective_server_lr}")
    print(f"    Client_Momentum: {cfg.client_moment}")
    print(f"    RobustLR_threshold: {cfg.robustLR_threshold}")
    print(f"    Noise Ratio: {cfg.noise}")
    print(f"    Number of corrupt agents: {cfg.num_corrupt}")
    print(f"    Poison Frac: {cfg.poison_frac}")
    print(f"    Clip: {cfg.clip}")
    print(f"    Seed: {cfg.seed}  Arch: {cfg.model_arch}  Dtype: {cfg.dtype}"
          f"  Remat: {cfg.remat} ({cfg.remat_policy})  Device: {cfg.device}  "
          f"Fused server step: {cfg.use_fused}  Mesh: {cfg.mesh}")
    print(f"    Train layout: {cfg.train_layout}  Agent chunk: "
          f"{cfg.agent_chunk}  Chain: {cfg.chain}  Aggregation mode: "
          f"{cfg.agg_mode}")
    if cfg.faults_enabled:
        print(f"    Faults: dropout {cfg.dropout_rate}  straggler "
              f"{cfg.straggler_rate} ({cfg.straggler_epochs} ep)  corrupt "
              f"{cfg.corrupt_rate} ({cfg.corrupt_mode})  norm cap "
              f"{cfg.payload_norm_cap}  spare corrupt "
              f"{cfg.faults_spare_corrupt}  RLR threshold "
              f"{cfg.rlr_threshold_mode}")
    print(f"    Health: {cfg.health}  policy {cfg.health_policy}  "
          f"z {cfg.health_z_threshold}  spike x{cfg.health_spike_factor}")
    print(f"    Attack: {cfg.attack}  boost x{cfg.attack_boost}  schedule "
          f"start {cfg.attack_start} stop {cfg.attack_stop} every "
          f"{cfg.attack_every}  Pattern: {cfg.pattern_type}  Telemetry: "
          f"{cfg.telemetry}")
    print(f"    Population: cohort_sampled {cfg.cohort_sampled}  cohort "
          f"{cfg.agents_per_round}  cohort_seed {cfg.cohort_seed}  "
          f"partitioner {cfg.partitioner} (alpha {cfg.dirichlet_alpha}, "
          f"{cfg.classes_per_client} classes, {cfg.samples_per_client} "
          f"samples a client)")
    print(f"    Churn: available {cfg.churn_available}  period "
          f"{cfg.churn_period}  seed {cfg.churn_seed}  Traffic: "
          f"{cfg.traffic} (peak {cfg.traffic_peak_frac}, trough "
          f"{cfg.traffic_trough_frac}, day {cfg.traffic_day_rounds} rounds, "
          f"seed {cfg.traffic_seed})")
    print(f"    Host runtime: {native.status()}")
    print(f"    Reputation: {cfg.reputation}  Diagnostics: "
          f"{cfg.diagnostics} (top {cfg.top_frac})  Checkpoints: "
          f"{cfg.checkpoint_dir or 'off'}  Resume: {cfg.resume}")
    print("======================================")
