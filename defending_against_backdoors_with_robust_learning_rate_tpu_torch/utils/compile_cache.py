"""Program choices of the round, and the round's captured CUDA graph.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
utils/compile_cache.py`, reduced to the fields the port has:
`resolved_train_layout`, `chain_budget`, the host-sampled decision
(`DEVICE_RESIDENT_BYTES`, `is_host_mode`) and the cohort-sampled one
(`COHORT_AUTO_MIN_POPULATION`, `is_cohort_mode`). The JAX module's AOT bank,
fingerprints and program families wait for the port's program cache.

`RoundGraph` holds the counterpart of the JAX round being one jitted XLA
program: the round's device work captured once per run as one CUDA graph
and replayed every later round.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.utils import _pytree as pytree

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.attack import (
    registry as attack_registry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    TRAIN_LAYOUTS)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops import (
    rlr_fused)

# graph replays and captures by this process, for a run to show its rounds
# were replays of one graph
GRAPH_REPLAYS = {"round": 0}
GRAPH_CAPTURES = {"round": 0}

# above this many stacked-array bytes the driver switches to host-side
# per-round shard gathering (the fedemnist path), as JAX decides it
DEVICE_RESIDENT_BYTES = 2 << 30


def resolved_train_layout(cfg) -> str:
    """The local-training layout (config.TRAIN_LAYOUTS): megabatch
    degrades to vmap under --diagnostics, as JAX's does (the snap and
    off-snap rounds must run one layout; train.run prints JAX's line)."""
    if cfg.train_layout not in TRAIN_LAYOUTS:
        raise ValueError(f"train_layout must be one of {TRAIN_LAYOUTS}, "
                         f"got {cfg.train_layout!r}")
    if cfg.train_layout == "megabatch" and cfg.diagnostics:
        return "vmap"
    return cfg.train_layout


def chain_budget(cfg, host_mode: bool = False) -> int:
    """Rounds per dispatch (JAX's budget): --chain capped at --snap, so a
    chained block never crosses an eval boundary, and at snap - 1 under
    --diagnostics, whose snap rounds run unchained; 1 on the host-sampled
    round (`host_mode`) under faults or an update attack, whose per-round
    corrupt flags JAX's chained host scan cannot carry (train.run prints
    why). The cohort round keeps its chain under both."""
    n = max(1, min(cfg.chain, cfg.snap - (1 if cfg.diagnostics else 0)))
    if host_mode and (cfg.faults_enabled or attack_registry.in_jit(cfg)):
        return 1
    return n


def is_host_mode(cfg, fed) -> bool:
    """The driver's host-sampled decision: --host_sampled on, or auto with
    the shard stacks above DEVICE_RESIDENT_BYTES."""
    return (cfg.host_sampled == "on"
            or (cfg.host_sampled == "auto"
                and fed.train.images.nbytes > DEVICE_RESIDENT_BYTES))


# populations at or above this take the cohort-sampled round under
# --cohort_sampled auto: a dense [K, max_n, ...] stack of 4096+ clients is
# the wrong layout, and the paper's configs (K <= 40, Fed-EMNIST's 3,383)
# stay on their dense rounds
COHORT_AUTO_MIN_POPULATION = 4096


def is_cohort_mode(cfg, fed=None) -> bool:
    """The driver's cohort-sampled decision (JAX `is_cohort_mode`). Without
    `fed`, the config alone: on/off as asked, and under auto a population
    of COHORT_AUTO_MIN_POPULATION or more whose implied cohort is smaller
    than the population and samplable (decided before any data is built:
    a million-client population is never stacked densely to find out).
    With `fed`, a host-sampled run under churn or diurnal traffic also
    takes the cohort round, its cohorts drawn from the present set over
    the dense host stacks, when its cohort is samplable."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data import (
        cohort)
    if cfg.cohort_sampled == "on":
        return True
    if cfg.cohort_sampled == "off":
        return False
    if cfg.num_agents >= COHORT_AUTO_MIN_POPULATION:
        return (cfg.agents_per_round < cfg.num_agents
                and cohort.cohort_feasible(cfg))
    if fed is not None and (cfg.churn_enabled or cfg.traffic_enabled) \
            and is_host_mode(cfg, fed):
        return cohort.cohort_feasible(cfg)
    return False


def _spec(x):
    """The structure, shapes and dtypes of a nest of dicts, tuples, None
    and tensors: what a replay must be given to read its buffers."""
    leaves, tree = pytree.tree_flatten(x)
    return tree, [None if t is None else (t.shape, t.dtype) for t in leaves]


def _tensors(x):
    return [t for t in pytree.tree_leaves(x) if t is not None]


class RoundGraph:
    """fn(params, *inputs) -> (new params, outputs) on a CUDA device, run
    as one captured CUDA graph.

    The first call runs fn eagerly on a side stream (the warm-up: cuDNN
    plans, cuBLAS workspaces, the kernels' build, the allocator) and
    returns that result; then it captures fn with `torch.cuda.graph` on
    static copies of the call's arguments. The captured program ends by
    copying the new params into the static params buffers, so a replay
    reads its own output. Every later call copies its arguments into the
    static buffers (params given back as returned are not copied) and
    replays. It returns the static params and the graph's output tensors:
    the next replay overwrites them, as JAX's chained round consumes its
    donated params. The graph is built once; a call with other shapes,
    dtypes or structure raises, and a capture that fails raises: nothing
    falls back to eager on the card.

    The params may be a carry (fl/buffered.join_carry: the buffered
    round's state under `@async/` names beside the params, all f32): the
    capture writes back every entry of the dict fn returns, so the state
    a replay leaves is the next replay's input. fn must return the dict
    with the keys and order it took (the spec check above).

    Kernels launched inside the capture are not counted as they are
    captured (ops/rlr_fused.py counts them as captured); each replay adds
    them to `rlr_fused.LAUNCHES`, since each replay launches them once.
    """

    def __init__(self, fn: Callable):
        self.fn = fn
        self.graph = None
        self._built_for = None
        self._params: Dict[str, torch.Tensor] = {}
        self._inputs = None
        self._outputs = None
        self._per_replay: Dict[str, int] = {}

    def __call__(self, params, *inputs):
        if self.graph is None:
            return self._warm_up_and_capture(params, *inputs)
        spec = _spec((params, inputs))
        if spec != self._built_for:
            raise ValueError(f"the captured round was built for "
                             f"{self._built_for}, not {spec}")
        for k, v in params.items():
            static = self._params[k]
            if v.data_ptr() != static.data_ptr():
                static.copy_(v)
        for static, v in zip(_tensors(self._inputs), _tensors(inputs),
                             strict=True):
            static.copy_(v)
        self.graph.replay()
        GRAPH_REPLAYS["round"] += 1
        for name, n in self._per_replay.items():
            rlr_fused.LAUNCHES[name] += n
        return self._params, self._outputs

    def _warm_up_and_capture(self, params, *inputs):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            result = self.fn(params, *inputs)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        self._built_for = _spec((params, inputs))
        self._params = {k: v.detach().to(torch.float32).clone()
                        for k, v in params.items()}
        self._inputs = pytree.tree_map_only(torch.Tensor, torch.clone,
                                            inputs)
        captured = dict(rlr_fused.CAPTURED)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            new_params, self._outputs = self.fn(self._params, *self._inputs)
            for k, v in new_params.items():
                self._params[k].copy_(v)
        self._per_replay = {k: n - captured[k]
                            for k, n in rlr_fused.CAPTURED.items()
                            if n != captured[k]}
        self.graph = graph
        GRAPH_CAPTURES["round"] += 1
        return result
