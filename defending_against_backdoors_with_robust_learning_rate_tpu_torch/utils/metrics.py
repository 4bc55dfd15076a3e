"""Run naming and the JSONL metrics sink.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
utils/metrics.py` (`run_name`, `MetricsWriter`). The scalar tags are the
reference's TensorBoard names (src/federated.py:81-91); each row is
{"tag", "value", "step"}, and every run opens with a `_run/start` record,
so reruns of one config can append to one file and still be split.
TensorBoard output is not ported yet.

The Health/* rows come from health/monitor.emit_rows (its `TAGS` are the
one source of their names), all five of JAX's: the three lanes, the loss
z-score and the norm-spike bit. `FAULT_TAGS` are the Faults/* rows JAX's
train.py:1362-1370 writes from a faults round's scalars
(faults/model.fault_scalars), in that order.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.faults.model import (
    INFO_KEYS as FAULT_INFO_KEYS)

FAULT_TAGS = dict(zip(FAULT_INFO_KEYS, ("Faults/Dropped", "Faults/Straggled",
                                        "Faults/Effective_Voters")))


def fault_rows(vals) -> dict:
    """{tag: value} of the fault scalars in a boundary's host values
    (empty without faults)."""
    if "fault_voters" not in vals:
        return {}
    return {tag: vals[key] for key, tag in FAULT_TAGS.items()}


def run_name(cfg) -> str:
    """Hyperparam-derived run dir name (reference src/federated.py:27-31,
    without its time prefix): a pure function of the config."""
    return (f"clip_val:{cfg.clip}"
            f"-noise_std:{cfg.noise}-aggr:{cfg.aggr}"
            f"-s_lr:{cfg.effective_server_lr}-num_cor:{cfg.num_corrupt}"
            f"-thrs_robustLR:{cfg.robustLR_threshold}"
            f"-pttrn:{cfg.pattern_type}-seed:{cfg.seed}")


class MetricsWriter:
    """Appends scalar rows to <log_dir>/<name>/metrics.jsonl."""

    def __init__(self, log_dir: str, name: Optional[str] = None):
        self.dir = os.path.join(log_dir, name) if name else log_dir
        os.makedirs(self.dir, exist_ok=True)
        self.jsonl_path = os.path.join(self.dir, "metrics.jsonl")
        self._jsonl = open(self.jsonl_path, "a")
        self._jsonl.write(json.dumps(
            {"tag": "_run/start", "value": time.time(), "step": -1}) + "\n")

    def scalar(self, tag: str, value, step: int) -> None:
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step)}) + "\n")

    def flush(self) -> None:
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
