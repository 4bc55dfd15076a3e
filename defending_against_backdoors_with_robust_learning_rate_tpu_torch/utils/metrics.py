"""Run naming, the JSONL metrics sink and the async metrics drain.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
utils/metrics.py` (`run_name`, `MetricsWriter`, `MetricsDrain`). The scalar tags are the
reference's TensorBoard names (src/federated.py:81-91); each row is
{"tag", "value", "step"}, and every run opens with a `_run/start` record,
so reruns of one config can append to one file and still be split (a
resumed run appends too, after its own `_run/start`; `offset` gives the
byte offset the checkpoint journal records).
metrics.jsonl is always written; the same scalars also go to a TensorBoard
event file in the run dir (torch.utils.tensorboard.SummaryWriter), as the
JAX writer does, unless `--no_tensorboard` is given or that module does
not import (the `tensorboard` package is not installed): then the writer
says so in one log line and writes the JSONL only, as JAX's does.

The Health/* rows come from health/monitor.emit_rows (its `TAGS` are the
one source of their names), all five of JAX's: the three lanes, the loss
z-score and the norm-spike bit. `FAULT_TAGS` are the Faults/* rows JAX's
train.py:1362-1370 writes from a faults round's scalars
(faults/model.fault_scalars), in that order, and `CHURN_TAG` the row it
writes after them under churn (train.py:1371-1373); `async_rows` the
buffered path's Async/* rows it writes next (train.py:1374-1386).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Optional

import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.attack import (
    schedule as attack_schedule)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.faults.model import (
    INFO_KEYS as FAULT_INFO_KEYS)

FAULT_TAGS = dict(zip(FAULT_INFO_KEYS, ("Faults/Dropped", "Faults/Straggled",
                                        "Faults/Effective_Voters")))


CHURN_TAG = "Churn/Sampled_Away"


def fault_rows(vals) -> dict:
    """{tag: value} of the fault scalars in a boundary's host values
    (empty without faults or churn), then under churn the sampled clients
    away (JAX train.py:1362-1373)."""
    rows = ({} if "fault_voters" not in vals
            else {tag: vals[key] for key, tag in FAULT_TAGS.items()})
    if "churn_away" in vals:
        rows[CHURN_TAG] = vals["churn_away"]
    return rows


def async_rows(vals) -> dict:
    """{tag: value} of the buffered path's values in a boundary's host
    values (empty off that path): the buffer's fill, whether the tick
    committed, and the arrivals per staleness bin since the last commit,
    one Async/Staleness_Hist/<b> row a bin (JAX train.py:1374-1386)."""
    if "async_fill" not in vals:
        return {}
    rows = {"Async/Buffer_Fill": vals["async_fill"],
            "Async/Committed": vals["async_committed"]}
    for i, c in enumerate(vals["async_stale_hist"]):
        rows[f"Async/Staleness_Hist/{i}"] = c
    return rows


def run_name(cfg) -> str:
    """Hyperparam-derived run dir name (reference src/federated.py:27-31,
    without its time prefix): a pure function of the config. Churn,
    diurnal traffic and the cohort round add JAX's `-chrn:`, `-tfc:` and
    `-coh:` cells (population, cohort, partitioner, cohort seed), and a
    non-static attack JAX's `-atk:` cell (strategy, boost, poison_frac,
    and the schedule when it is not trivial), and `--agg_mode buffered`
    JAX's `-agm:` cell (commit threshold, staleness exponent and range)
    and the latency sigma in the traffic cell, so runs differing only in
    those do not share a run dir."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        buffered)
    churn = traffic = cohort = agm = ""
    if cfg.churn_enabled:
        churn = (f"-chrn:a{cfg.churn_available}p{cfg.churn_period}"
                 f"s{cfg.churn_seed}")
    if cfg.traffic_enabled:
        traffic = (f"-tfc:{cfg.traffic}p{cfg.traffic_peak_frac}"
                   f"t{cfg.traffic_trough_frac}d{cfg.traffic_day_rounds}"
                   + (f"l{cfg.traffic_latency_sigma}"
                      if buffered.is_buffered(cfg) else "")
                   + f"s{cfg.traffic_seed}")
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils import (
        compile_cache)
    if compile_cache.is_cohort_mode(cfg) or cfg.churn_enabled:
        part = cfg.partitioner
        if part == "dirichlet":
            part += f":a{cfg.dirichlet_alpha}n{cfg.samples_per_client}"
        elif part == "pathological":
            part += (f":c{cfg.classes_per_client}"
                     f"n{cfg.samples_per_client}")
        cohort = (f"-coh:K{cfg.num_agents}m{cfg.agents_per_round}"
                  f"-{part}-cs{cfg.cohort_seed}")
    atk = ""
    if cfg.attack != "static":
        atk = f"-atk:{cfg.attack}b{cfg.attack_boost}p{cfg.poison_frac}"
        if not attack_schedule.is_trivial(cfg):
            atk += (f"s{cfg.attack_start}e{cfg.attack_every}"
                    + (f"t{cfg.attack_stop}" if cfg.attack_stop else ""))
    if buffered.is_buffered(cfg):
        agm = (f"-agm:bufK{buffered.buffer_k(cfg)}"
               f"a{cfg.async_staleness_exp}S{cfg.async_max_staleness}")
    return (f"clip_val:{cfg.clip}"
            f"-noise_std:{cfg.noise}-aggr:{cfg.aggr}"
            f"-s_lr:{cfg.effective_server_lr}-num_cor:{cfg.num_corrupt}"
            f"-thrs_robustLR:{cfg.robustLR_threshold}"
            f"-pttrn:{cfg.pattern_type}-seed:{cfg.seed}"
            f"{churn}{traffic}{cohort}{atk}{agm}")


def fetch(tree):
    """`tree` (nested dicts, lists and tuples of tensors and host values)
    with every tensor brought to the host in one device-to-host copy per
    device: the tensors are flattened into one float64 buffer on their
    device (exact for f32, ints under 2**53 and bools), copied once, and
    split back into host tensors of their own dtype and shape. Host
    values pass through."""
    leaves = []

    def collect(node):
        if isinstance(node, dict):
            for v in node.values():
                collect(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                collect(v)
        elif isinstance(node, torch.Tensor):
            leaves.append(node)
    collect(tree)
    host = {}
    by_device = collections.defaultdict(list)
    for t in leaves:
        by_device[t.device].append(t)
    for device, ts in by_device.items():
        if device.type == "cpu":
            host.update({id(t): t.detach() for t in ts})
            continue
        flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                          for t in ts]).cpu()
        for t, piece in zip(ts, flat.split([t.numel() for t in ts]),
                            strict=True):
            host[id(t)] = piece.to(t.dtype).reshape(t.shape)

    def rebuild(node):
        if isinstance(node, dict):
            return {k: rebuild(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v) for v in node)
        if isinstance(node, torch.Tensor):
            return host[id(node)]
        return node
    return rebuild(tree)


class MetricsDrain:
    """The async host-sync pipeline (JAX `MetricsDrain`): the round loop
    queues callbacks with their *device* values and moves on; a background
    thread fetches the values (one batched device-to-host copy of
    everything queued at that moment, `fetch`) and runs the callbacks in
    strict FIFO order, so the metrics stream is the synchronous path's
    (tests/test_torch_drain.py holds it).

    Error policy, JAX's: a callback exception stops the drain and is
    re-raised on the submitting thread at the next submit(), flush() or
    close(), whichever comes first; after it is delivered once, later
    submissions are dropped. ``flush(timeout=...)`` raises TimeoutError
    when the drain makes no progress within the budget. ``close()``
    interrupted by KeyboardInterrupt still flushes: the worker drains
    everything already queued before it stops, then the interrupt
    propagates.

    The values a callback gets are host tensors: the caller hands over
    device tensors that nothing overwrites before they are fetched (the
    driver clones a replay's outputs on the device first), and the copy
    runs on the worker's current stream, after the work queued before
    the submit."""

    def __init__(self):
        self._items = collections.deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending = 0
        self._stop = False
        self._error = None
        self._dead = False      # the worker exited on an error
        self._thread = None

    def _raise_pending_locked(self) -> None:
        """Deliver the worker's error exactly once (the caller holds the
        lock)."""
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def submit(self, fn, device_vals, *host_args) -> None:
        """Queue fn(fetched device_vals, *host_args) for the worker,
        re-raising here a pending worker error."""
        with self._cond:
            self._raise_pending_locked()
            if self._dead:
                return
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name="metrics-drain", daemon=True)
                self._thread.start()
            self._items.append((fn, device_vals, host_args))
            self._pending += 1
            self._cond.notify_all()

    def _loop(self):
        while True:
            with self._cond:
                while not self._items and not self._stop:
                    self._cond.wait()
                if self._stop and not self._items:
                    return
                batch = list(self._items)
                self._items.clear()
            try:
                # one copy for everything queued right now
                fetched = fetch([d for _, d, _ in batch])
                for (fn, _, host_args), vals in zip(batch, fetched,
                                                    strict=True):
                    fn(vals, *host_args)
            except BaseException as e:  # noqa: BLE001 — re-raised later
                with self._cond:
                    self._error = e
                    self._dead = True
                    self._pending = 0
                    self._items.clear()
                    self._cond.notify_all()
                return
            with self._cond:
                self._pending -= len(batch)
                self._cond.notify_all()

    def flush(self, timeout: Optional[float] = None) -> None:
        """Block until every queued callback has run; re-raise the first
        worker error here. With a `timeout` (seconds), raise TimeoutError
        when callbacks are still pending past it."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._cond:
            while self._pending > 0 and self._error is None:
                if deadline is None:
                    self._cond.wait()
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"metrics drain stalled: {self._pending} "
                        f"callback(s) still pending after {timeout:.1f}s")
                self._cond.wait(remaining)
            self._raise_pending_locked()

    def _stop_and_join(self, join_timeout: float = 30.0) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)
            self._thread = None

    def close(self, raise_errors: bool = True) -> None:
        try:
            self.flush()
        except KeyboardInterrupt:
            # ^C mid-flush: the worker drains what is queued before it
            # stops, then the interrupt propagates, whatever raise_errors
            self._stop_and_join(join_timeout=5.0)
            raise
        except BaseException:
            self._stop_and_join()
            if raise_errors:
                raise
            return
        self._stop_and_join()


class MetricsWriter:
    """Appends scalar rows to <log_dir>/<name>/metrics.jsonl, and to a
    TensorBoard event file there when `tensorboard` is on and
    torch.utils.tensorboard imports."""

    def __init__(self, log_dir: str, name: Optional[str] = None,
                 tensorboard: bool = True):
        self.dir = os.path.join(log_dir, name) if name else log_dir
        os.makedirs(self.dir, exist_ok=True)
        self.jsonl_path = os.path.join(self.dir, "metrics.jsonl")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                print(f"[metrics] no TensorBoard sink ({e}); metrics.jsonl "
                      f"only, as the JAX package's writer without it")
            else:
                self._tb = SummaryWriter(self.dir)
        self._jsonl = open(self.jsonl_path, "a")
        self._jsonl.write(json.dumps(
            {"tag": "_run/start", "value": time.time(), "step": -1}) + "\n")

    def offset(self) -> int:
        """The flushed byte offset of metrics.jsonl: what the checkpoint
        journal records at a save (utils/checkpoint.py)."""
        self._jsonl.flush()
        return self._jsonl.tell()

    def scalar(self, tag: str, value, step: int) -> None:
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
