"""Main-path configuration: the JAX CLI's flag names and defaults, cut to
the fields the port runs (slice 1's dense round, slice 2's sharded round
and health lanes, slice 4's batched local training and chained round,
slice 5's cifar10 and fedemnist data, ResNet-9 and host-sampled round).

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
config.py` (`Config`, `args_parser`, `print_exp_details`). Every field here
keeps the JAX name and default; flags the port does not run yet are not
accepted, so a command line that asks for one fails instead of being
quietly ignored.

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

AGGRS = ("avg", "sign")     # the rules the port has (ops/aggregate.py)
DATASETS = ("fmnist", "cifar10", "fedemnist", "synthetic")
ARCHS = ("auto", "cnn", "resnet9")
HOST_SAMPLED = ("auto", "on", "off")
PATTERNS = ("plus", "square")   # JAX's copyright/apple are not ported
AGG_LAYOUTS = ("leaf", "bucket")    # JAX's choices; bucket is not ported
HEALTH_LEVELS = ("on", "off")
TRAIN_LAYOUTS = ("vmap", "megabatch")


@dataclasses.dataclass(frozen=True)
class Config:
    # --- reference flag surface (names + defaults as in the JAX Config) ---
    data: str = "fmnist"            # fmnist | cifar10 | fedemnist | synthetic
    num_agents: int = 10            # K
    agent_frac: float = 1.0         # C, fraction of agents sampled per round
    num_corrupt: int = 0            # first num_corrupt agent ids are malicious
    rounds: int = 200
    aggr: str = "avg"               # avg | sign
    local_ep: int = 2
    bs: int = 256
    client_lr: float = 0.1
    client_moment: float = 0.9
    server_lr: float = 1.0          # only used as-is for aggr='sign'
    base_class: int = 5
    target_class: int = 7
    poison_frac: float = 0.0
    pattern_type: str = "plus"      # plus | square
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
    # --- multi-card (JAX parallel/multihost.py, parallel/mesh.py) ---
    coordinator: str = ""           # host:port of rank 0's rendezvous
    num_processes: int = 0          # total processes (one per card)
    process_id: int = -1            # this process's rank; -1 = from env
    mesh: int = 1                   # ranks on the `agents` axis; 0 = all
    agg_layout: str = "leaf"        # leaf (per-leaf all_reduces) | bucket
    # --- in-round health lanes (JAX health/sentinel.py) ---
    health: str = "on"              # on | off
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
    # --- port-only ---
    device: str = "cuda"
    use_fused: bool = True

    @property
    def effective_server_lr(self) -> float:
        """server_lr is forced to 1.0 unless aggr=='sign' (JAX config.py:510-512,
        reference src/federated.py:23)."""
        return self.server_lr if self.aggr == "sign" else 1.0

    @property
    def agents_per_round(self) -> int:
        """The per-round sample m = floor(K * C) (reference src/federated.py:68;
        the JAX port's --cohort_size override is not in this slice)."""
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
        if f.name in ("use_fused", "host_sampled"):
            continue
        p.add_argument(f"--{f.name}", type=type(getattr(d, f.name)),
                       default=getattr(d, f.name))
    p.add_argument("--host_sampled", choices=HOST_SAMPLED,
                   default=d.host_sampled,
                   help="force host-sampled shard gathering on/off "
                        "(auto: stacks above the 2 GiB device-resident "
                        "budget gather on host per round)")
    p.add_argument("--remat", action="store_true",
                   help="JAX's rematerialization of the model forward "
                        "(refused: not ported yet)")
    p.add_argument("--no_fused", action="store_true",
                   help="server step through ops/aggregate.py instead of "
                        "the fused RLR kernel")
    return p


def args_parser(argv: Optional[list] = None) -> Config:
    """Parse CLI flags into a Config (JAX `config.args_parser`), refusing
    what the port does not run yet and naming the missing piece."""
    ns = build_parser().parse_args(argv)
    kw = {k: v for k, v in vars(ns).items()
          if k not in ("no_fused", "remat")}
    cfg = Config(use_fused=not ns.no_fused, **kw)
    if cfg.aggr not in AGGRS:
        raise ValueError(f"--aggr {cfg.aggr!r} is not ported yet "
                         f"(the port has {AGGRS})")
    if cfg.agg_layout not in AGG_LAYOUTS:
        raise ValueError(f"--agg_layout must be one of {AGG_LAYOUTS}, got "
                         f"{cfg.agg_layout!r}")
    if cfg.agg_layout == "bucket":
        raise ValueError("--agg_layout bucket (parallel/buckets.py: "
                         "reduce_scatter + all_gather) is not ported yet; "
                         "the port has the leaf layout")
    if cfg.health not in HEALTH_LEVELS:
        raise ValueError(f"--health must be one of {HEALTH_LEVELS}, got "
                         f"{cfg.health!r}")
    if cfg.train_layout not in TRAIN_LAYOUTS:
        raise ValueError(f"--train_layout must be one of {TRAIN_LAYOUTS}, "
                         f"got {cfg.train_layout!r}")
    if cfg.data not in DATASETS:
        raise ValueError(f"--data must be one of {DATASETS}, got "
                         f"{cfg.data!r}")
    if cfg.arch not in ARCHS:
        raise ValueError(f"--arch must be one of {ARCHS}, got {cfg.arch!r}")
    if cfg.pattern_type not in PATTERNS:
        raise ValueError(f"--pattern_type {cfg.pattern_type!r} is not "
                         f"ported yet (the port has {PATTERNS})")
    if ns.remat:
        raise ValueError("--remat (torch.utils.checkpoint) is not ported "
                         "yet")
    if cfg.chain > 1 and cfg.host_sampled == "on":
        raise ValueError(CHAINED_HOST_NOT_PORTED)
    return cfg


CHAINED_HOST_NOT_PORTED = (
    "--chain > 1 with host sampling (JAX make_chained_round_fn_host) is "
    "not ported yet; the host-sampled round runs one round a dispatch")


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
    print(f"    Seed: {cfg.seed}  Arch: {cfg.model_arch}  "
          f"Device: {cfg.device}  "
          f"Fused server step: {cfg.use_fused}  Mesh: {cfg.mesh}")
    print(f"    Train layout: {cfg.train_layout}  Agent chunk: "
          f"{cfg.agent_chunk}  Chain: {cfg.chain}")
    print("======================================")
