"""Run naming and the JSONL metrics sink.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
utils/metrics.py` (`run_name`, `MetricsWriter`). The scalar tags are the
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
writes after them under churn (train.py:1371-1373).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

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


def run_name(cfg) -> str:
    """Hyperparam-derived run dir name (reference src/federated.py:27-31,
    without its time prefix): a pure function of the config. Churn,
    diurnal traffic and the cohort round add JAX's `-chrn:`, `-tfc:` and
    `-coh:` cells (population, cohort, partitioner, cohort seed), and a
    non-static attack JAX's `-atk:` cell (strategy, boost, poison_frac,
    and the schedule when it is not trivial), so runs differing only in
    those do not share a run dir."""
    churn = traffic = cohort = ""
    if cfg.churn_enabled:
        churn = (f"-chrn:a{cfg.churn_available}p{cfg.churn_period}"
                 f"s{cfg.churn_seed}")
    if cfg.traffic_enabled:
        traffic = (f"-tfc:{cfg.traffic}p{cfg.traffic_peak_frac}"
                   f"t{cfg.traffic_trough_frac}d{cfg.traffic_day_rounds}"
                   f"s{cfg.traffic_seed}")
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
    return (f"clip_val:{cfg.clip}"
            f"-noise_std:{cfg.noise}-aggr:{cfg.aggr}"
            f"-s_lr:{cfg.effective_server_lr}-num_cor:{cfg.num_corrupt}"
            f"-thrs_robustLR:{cfg.robustLR_threshold}"
            f"-pttrn:{cfg.pattern_type}-seed:{cfg.seed}"
            f"{churn}{traffic}{cohort}{atk}")


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
