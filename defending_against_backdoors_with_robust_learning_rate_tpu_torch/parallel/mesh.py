"""The `agents` axis: how many ranks share a round, and the process group
they reduce over.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
parallel/mesh.py` (`AGENTS_AXIS`, `pick_agent_mesh_size`, `make_mesh`). JAX
blocks the m sampled agents m/d per device of a 1-D mesh and reduces with
psum; here the d devices are d ranks of a torch.distributed process group,
one per card, and `AgentsGroup` is the psum's counterpart.

`run_in_threads` builds d gloo ranks inside one process, one thread each,
over one shared HashStore: the counterpart of JAX's faked 8-device CPU
mesh, used to hold the collective path on the CPU. No CLI flag turns it on.
"""

from __future__ import annotations

import datetime
import threading
import time
from typing import Callable, List

import torch
import torch.distributed as dist

AGENTS_AXIS = "agents"


def pick_agent_mesh_size(requested: int, agents_per_round: int,
                         n_devices: int) -> int:
    """Largest device count <= min(requested or all, available) that divides
    the per-round participant count (JAX parallel/mesh.py:20-29; e.g. m=10
    on 8 devices uses 5, 2 agents per device)."""
    cap = min(requested if requested > 0 else n_devices, n_devices)
    for d in range(cap, 0, -1):
        if agents_per_round % d == 0:
            return d
    return 1


class AgentsGroup:
    """One c10d process group over the `agents` axis, with this rank's
    place in it. `all_reduce_sum_` is JAX's psum over AGENTS_AXIS, in place;
    `calls` counts them, so a run can show its collective plan. A failed
    or timed-out collective raises: no rank carries on alone."""

    def __init__(self, pg, device):
        self.pg = pg
        self.rank = pg.rank()
        self.size = pg.size()
        self.device = torch.device(device)
        self.calls = 0

    def all_reduce_sum_(self, tensor: torch.Tensor) -> torch.Tensor:
        self.calls += 1
        self.pg.allreduce([tensor]).wait()
        return tensor


def run_in_threads(d: int, fn: Callable[[AgentsGroup], object],
                   device="cpu", timeout_s: float = 120.0) -> List[object]:
    """fn(group) on d gloo ranks of one process, one thread per rank;
    returns the ranks' results in rank order. Raises the first error any
    rank met (a peer left waiting on the failed rank's collective times
    out later), or TimeoutError if a rank does not finish within timeout_s.
    Ranks share the process, so each builds its own model:
    `torch.func.functional_call` swaps a module's parameters while it
    runs."""
    store = dist.HashStore()
    results: List[object] = [None] * d
    errors: List[BaseException] = []     # in the order they happened
    timeout = datetime.timedelta(seconds=timeout_s / 2)

    def rank_main(r):
        pg = None
        try:
            pg = dist.ProcessGroupGloo(dist.PrefixStore(AGENTS_AXIS, store),
                                       r, d, timeout)
            results[r] = fn(AgentsGroup(pg, device))
        except BaseException as e:  # noqa: BLE001 — re-raised by the caller
            errors.append(e)
        finally:
            if pg is not None:
                pg.shutdown()

    threads = [threading.Thread(target=rank_main, args=(r,), daemon=True,
                                name=f"{AGENTS_AXIS}-rank{r}")
               for r in range(d)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout_s
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    if any(t.is_alive() for t in threads):
        raise TimeoutError(f"a rank of {d} did not finish in {timeout_s} s")
    if errors:
        raise errors[0]
    return results
