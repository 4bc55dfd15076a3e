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

The collectives are JAX's, tiled as its `shard_map` bodies call them:
`all_reduce_sum_` (psum), `all_gather` (all_gather, axis 0, tiled),
`all_to_all` (all_to_all, split_axis=1, concat_axis=0, tiled) and
`reduce_scatter_sum` (psum_scatter, scatter_dimension=1, tiled). torch's
tensor collectives split and concatenate dim 0, so the column-split ones
lay their input out as [d, rows, cols/d], contiguous, first.
"""

from __future__ import annotations

import datetime
import threading
import time
from typing import Callable, Dict, List

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


# the collective kinds a group counts, in the order its plan prints them
KINDS = ("all_reduce", "all_gather", "all_to_all", "reduce_scatter")


class AgentsGroup:
    """One c10d process group over the `agents` axis, with this rank's
    place in it, and JAX's collectives over it. `counts` counts the
    collectives by kind and `seconds` the host time spent inside each kind
    (the wait for the slowest rank included), so a run can show its
    collective plan; `calls` is their total. A failed or timed-out
    collective raises: no rank carries on alone.

    Staging: gloo's CUDA paths cover all_reduce, and the port uses it
    there as it is; for all_gather, all_to_all and reduce_scatter a group
    of CUDA tensors over gloo (`staged`, decided from the device type and
    the backend when the group is built) copies the input to a pinned host
    buffer, runs the collective on the host and copies the result back.
    NCCL, and gloo on the CPU, take the tensors as they are. Masks are
    gathered as uint8 (gloo has no bool)."""

    def __init__(self, pg, device):
        self.pg = pg
        self.rank = pg.rank()
        self.size = pg.size()
        self.device = torch.device(device)
        self.staged = self.device.type == "cuda" and pg.name() == "gloo"
        self.counts: Dict[str, int] = dict.fromkeys(KINDS, 0)
        self.seconds: Dict[str, float] = dict.fromkeys(KINDS, 0.0)

    @property
    def calls(self) -> int:
        return sum(self.counts.values())

    def reset_counts(self) -> None:
        for k in KINDS:
            self.counts[k] = 0
            self.seconds[k] = 0.0

    def _timed(self, kind: str, run) -> None:
        self.counts[kind] += 1
        t0 = time.perf_counter()
        run()
        self.seconds[kind] += time.perf_counter() - t0

    def _host(self, kind: str, out: torch.Tensor, inp: torch.Tensor, call):
        """call(out, inp).wait() on the tensors, or on pinned host copies
        of them when the group is staged; returns out."""
        def run():
            if not self.staged:
                call(out, inp).wait()
                return
            h_in = torch.empty(inp.shape, dtype=inp.dtype, pin_memory=True)
            h_in.copy_(inp)
            h_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            call(h_out, h_in).wait()
            out.copy_(h_out)
        self._timed(kind, run)
        return out

    def all_reduce_sum_(self, tensor: torch.Tensor) -> torch.Tensor:
        """psum, in place."""
        self._timed("all_reduce", lambda: self.pg.allreduce([tensor]).wait())
        return tensor

    def all_gather(self, tensor: torch.Tensor) -> torch.Tensor:
        """[n, ...] on every rank -> [d * n, ...], rank order (JAX
        all_gather(axis=0, tiled=True))."""
        x = tensor.contiguous()
        out = torch.empty((self.size * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        return self._host("all_gather", out, x, self.pg._allgather_base)

    def all_to_all(self, tensor: torch.Tensor) -> torch.Tensor:
        """[rows, cols] with d | cols -> [d * rows, cols / d]: rank j keeps
        column block j of every rank's rows, stacked in rank order (JAX
        all_to_all(split_axis=1, concat_axis=0, tiled=True))."""
        rows, cols = tensor.shape
        d = self.size
        x = tensor.reshape(rows, d, cols // d).transpose(0, 1).contiguous()
        out = torch.empty_like(x)

        def call(o, i):
            return self.pg.alltoall_base(o, i, [], [],
                                         dist.AllToAllOptions())
        return self._host("all_to_all", out, x, call).reshape(d * rows,
                                                              cols // d)

    def reduce_scatter_sum(self, tensor: torch.Tensor) -> torch.Tensor:
        """[rows, cols] with d | cols -> [rows, cols / d]: column block
        `rank` of the sum over the ranks (JAX psum_scatter(
        scatter_dimension=1, tiled=True))."""
        rows, cols = tensor.shape
        d = self.size
        x = tensor.reshape(rows, d, cols // d).transpose(0, 1).contiguous()
        out = torch.empty((1, rows, cols // d), dtype=x.dtype,
                          device=x.device)
        opts = dist.ReduceScatterOptions()
        opts.reduceOp = dist.ReduceOp.SUM

        def call(o, i):
            return self.pg._reduce_scatter_base(o, i, opts)
        return self._host("reduce_scatter", out, x, call)[0]


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
