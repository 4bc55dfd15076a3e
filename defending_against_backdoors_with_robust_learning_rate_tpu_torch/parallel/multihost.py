"""Multi-card launch: one process per card, joined into one NCCL group.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
parallel/multihost.py` (`maybe_initialize` :44-54, `is_lead` :57,
`require_pod_divisible` :94, `agg_plan_note` :107). JAX runs one process
per host over all its chips; the port runs one process per card, so the d
ranks of the `agents` axis are d processes, launched by `torchrun` or with
--coordinator/--num_processes/--process_id.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl.rounds import (
    _fused_applicable)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.mesh import (
    AgentsGroup)


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


def leaf_plan_collectives(cfg) -> int:
    """all_reduces per round of the sharded round (parallel/rounds.py),
    fused and plain alike: the loss with the health lanes packed in, the
    weight total for avg, and the server step's one packed buffer. 3 for
    avg with or without RLR, 2 for sign: JAX's compiled count, where XLA's
    combiner merges the per-leaf psums into one tuple all-reduce."""
    weight_total = 1 if cfg.aggr == "avg" else 0
    return 1 + weight_total + 1


def agg_plan_note(cfg, params, group: AgentsGroup) -> str:
    """The bring-up log line for the aggregation collective plan this
    group runs each round."""
    step = ("fused server step: per-rank partial sums (K2, one launch)"
            if _fused_applicable(cfg)
            else f"leaf aggregation ({cfg.aggr})")
    return (f"{step} + one packed all_reduce of {len(params)} leaves: "
            f"{leaf_plan_collectives(cfg)} all_reduces/round over "
            f"{group.size} rank(s) (the loss and health lanes share one)")
