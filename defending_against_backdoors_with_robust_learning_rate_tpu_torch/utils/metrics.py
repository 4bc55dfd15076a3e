"""Run naming and the JSONL metrics sink.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
utils/metrics.py` (`run_name`, `MetricsWriter`). The scalar tags are the
reference's TensorBoard names (src/federated.py:81-91); each row is
{"tag", "value", "step"}, and every run opens with a `_run/start` record,
so reruns of one config can append to one file and still be split.
TensorBoard output is not ported yet.

`HEALTH_TAGS` are the Health/* rows JAX's train.py writes from the in-round
health lanes (tag names of JAX health/monitor.py:85-87); the loss z-score
and norm-spike rows wait for the monitor.
"""

from __future__ import annotations

import json
import os
import time
import math
from typing import Optional

HEALTH_TAGS = {
    "nonfinite": "Health/Nonfinite_Updates",
    "params_finite": "Health/Params_Finite",
    "update_norm": "Health/Update_Norm",
}


def health_rows(vals) -> dict:
    """{tag: value} of the health lanes in a boundary's host values (empty
    when the lanes are off): the update norm is the root of the lane's
    summed square, as JAX health/monitor.assess takes it."""
    if "hlth_nonfinite" not in vals:
        return {}
    nsq = vals["hlth_update_normsq"]
    return {HEALTH_TAGS["nonfinite"]: vals["hlth_nonfinite"],
            HEALTH_TAGS["params_finite"]: vals["hlth_params_finite"],
            HEALTH_TAGS["update_norm"]: (math.sqrt(nsq) if nsq >= 0
                                         else nsq)}


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
