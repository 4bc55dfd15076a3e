"""Multi-card launch: one process per card, joined into one NCCL group.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
parallel/multihost.py` (`maybe_initialize` :44-54, `is_lead` :57,
`require_pod_divisible` :94, `agg_plan_note` :107), and the plan of a
round's collectives by kind (`plan_collectives`). JAX runs one process
per host over all its chips; the port runs one process per card, so the d
ranks of the `agents` axis are d processes, launched by `torchrun` or with
--coordinator/--num_processes/--process_id.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl.rounds import (
    _fused_applicable)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.aggregate import (
    RFA_ITERS)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel import (
    buckets)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.mesh import (
    KINDS, AgentsGroup)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.rounds import (
    bucket_applicable, reads_sign_sums)


def maybe_initialize(coordinator: str = "", num_processes: int = 0,
                     process_id: int = -1) -> Optional[AgentsGroup]:
    """Join this process into the job's NCCL group, one rank per card, and
    return the `agents` group; None for a single-process run.

    With explicit flags (a coordinator, or more than one process) they are
    passed through: the rendezvous is tcp://<coordinator>, the rank
    --process_id (or RANK from the environment when it is -1). With no
    flags, a `torchrun` launch (WORLD_SIZE, RANK, MASTER_ADDR/PORT in the
    environment) is joined through env://."""
    if num_processes > 1 or coordinator:
        rank = process_id if process_id >= 0 else int(os.environ["RANK"])
        world = num_processes or 1
        init = f"tcp://{coordinator}" if coordinator else "env://"
    elif "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init = "env://"
    else:
        return None
    if not torch.cuda.is_available():
        raise RuntimeError("a multi-card run needs CUDA devices (NCCL, one "
                           "rank per card); torch sees none")
    device = torch.device(f"cuda:{rank % torch.cuda.device_count()}")
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method=init, world_size=world,
                            rank=rank)
    return AgentsGroup(dist.group.WORLD, device)


def shutdown() -> None:
    """Leave the job's process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_lead(group: Optional[AgentsGroup] = None) -> bool:
    """True on the rank that writes metrics and prints (rank 0)."""
    return group is None or group.rank == 0


def require_pod_divisible(m: int, what: str, n: int) -> int:
    """The group spans every rank, so the per-round participant count has
    to divide over all n of them. Returns n."""
    if m % n != 0:
        raise ValueError(
            f"agents_per_round={m} must be divisible by the job's {n} "
            f"ranks for a {what} run; adjust --num_agents/--agent_frac")
    return n


def plan_collectives(cfg, params=None, d: int = 1) -> Dict[str, int]:
    """The sharded round's collectives a round, by kind (AgentsGroup's
    kinds), as parallel/rounds.py makes them: the loss all_reduce (the
    health lanes packed in); the payload-validity all_gather under faults;
    the telemetry's norm all_gather, and under full the two cosine
    accumulators'; then the server step's:

    - leaf layout, avg or sign (fused and plain alike): the weight total
      for avg and one packed all_reduce, 3 for avg and 2 for sign in all,
      JAX's compiled count where XLA's combiner merges the per-leaf psums;
    - comed, trmean: one all_to_all and one all_gather; krum: the same
      and the [m, m] all_reduce; rfa: one all_reduce for the mean and two
      an iteration; with RLR (or full telemetry) one packed sign-sum
      all_reduce more;
    - bucket layout (`params`, at `d` ranks, sets its bucket count): the
      weight total for avg, one reduce_scatter a bucket and one
      all_gather. JAX's analysis_baseline.json pins sharded_rlr_avg_bucket
      at psum 2, reduce_scatter 1, all_gather 1, the faults family at
      all_gather 2 and the full telemetry family at all_gather 4."""
    plan = dict.fromkeys(KINDS, 0)
    plan["all_reduce"] = 1
    if cfg.faults_enabled:
        plan["all_gather"] += 1
    if cfg.telemetry != "off":
        plan["all_gather"] += 3 if cfg.telemetry == "full" else 1
    avg = cfg.aggr == "avg"
    if bucket_applicable(cfg):
        if params is None:
            raise ValueError("the bucket layout's plan needs the params "
                             "(its bucket count)")
        plan["all_reduce"] += int(avg)
        plan["reduce_scatter"] += buckets.layout_for_leaves(
            params, d).n_buckets
        plan["all_gather"] += 1
    elif cfg.aggr in ("avg", "sign"):
        plan["all_reduce"] += int(avg) + 1
    else:
        plan["all_reduce"] += int(reads_sign_sums(cfg))
        if cfg.aggr == "rfa":
            plan["all_reduce"] += 1 + 2 * RFA_ITERS
        else:
            plan["all_to_all"] += 1
            plan["all_gather"] += 1
            plan["all_reduce"] += int(cfg.aggr == "krum")
    return plan


def leaf_plan_collectives(cfg) -> int:
    """The leaf layout's collectives a round, all kinds together: 3 for
    avg with or without RLR and 2 for sign with no mask and no telemetry
    (`plan_collectives`)."""
    return sum(plan_collectives(cfg.replace(agg_layout="leaf")).values())


def agg_plan_note(cfg, params, group: AgentsGroup) -> str:
    """The bring-up log line for the aggregation collective plan this
    group runs each round."""
    plan = plan_collectives(cfg, params, group.size)
    if bucket_applicable(cfg):
        n = plan["reduce_scatter"]
        step = (f"bucket layout ({cfg.aggr}): {n} bucket(s) of the flat "
                f"update reduce_scattered, one all_gather of the LR-scaled "
                f"shard")
    elif _fused_applicable(cfg):
        step = (f"fused server step: per-rank partial sums (K2, one launch) "
                f"+ one packed all_reduce of {len(params)} leaves")
    elif cfg.aggr in ("avg", "sign"):
        step = (f"leaf aggregation ({cfg.aggr}) + one packed all_reduce of "
                f"{len(params)} leaves")
    elif cfg.aggr == "rfa":
        step = "leaf aggregation (rfa): a replicated Weiszfeld iterate"
    else:
        step = (f"leaf aggregation ({cfg.aggr}) over the all_to_all "
                f"transpose of {len(params)} leaves")
    kinds = ", ".join(f"{n} {kind}" for kind, n in plan.items() if n)
    return (f"{step}: {kinds} a round over {group.size} rank(s) (the loss "
            f"and health lanes share one all_reduce)")
