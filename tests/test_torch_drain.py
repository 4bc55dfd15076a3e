"""The async metrics drain (utils/metrics.MetricsDrain, `--sync_metrics`)
against JAX's contract (tests/test_async_metrics.py).

The first test runs JAX's six drain cases, one after another (one
collected item): FIFO order through the batched fetch, nested values, an
error re-raised at the next flush and at the next submit exactly once
with later items dropped, `flush(timeout=)` raising TimeoutError on a
wedged callback, and a KeyboardInterrupt during close that still lands
every queued row. The second runs the port's CLI on the CPU twice, with
the drain and with --sync_metrics: metrics.jsonl is the same row for row,
tag, step and value, apart from the rows that read the wall clock
(`_run/start` and Throughput/*, JAX's exclusion list), and a checkpointed
run under the drain resumes with the cumulative poison accuracy of every
boundary before its save (JAX
`test_async_metrics_flushes_at_checkpoint_and_resumes`).

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import json
import os
import threading
import time

import pytest
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch import (
    train)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils.metrics import (
    MetricsDrain)

WALL_CLOCK = ("_run/", "Throughput/")


def _fifo():
    drain, got = MetricsDrain(), []
    for i in range(20):
        drain.submit(lambda v, idx: got.append((idx, float(v))),
                     torch.tensor(i, dtype=torch.float32) * 2.0, i)
    drain.flush()
    assert got == [(i, 2.0 * i) for i in range(20)]
    drain.close()


def _tree():
    drain, out = MetricsDrain(), {}
    drain.submit(lambda v: out.update(v),
                 {"a": torch.tensor(3, dtype=torch.int32),
                  "b": [torch.ones(2), 5], "c": "host"})
    drain.flush()
    assert int(out["a"]) == 3 and out["a"].dtype == torch.int32
    assert torch.equal(out["b"][0], torch.ones(2)) and out["b"][1] == 5
    assert out["c"] == "host"
    drain.close()


def _boom(v):
    raise ValueError("drain callback failed")


def _error_at_flush():
    drain = MetricsDrain()
    drain.submit(_boom, torch.tensor(1.0))
    with pytest.raises(ValueError, match="drain callback failed"):
        drain.flush()
    # dead and delivered: later submissions drop, close does not hang
    drain.submit(lambda v: None, torch.tensor(2.0))
    drain.close(raise_errors=False)


def _error_at_submit():
    drain = MetricsDrain()
    drain.submit(_boom, torch.tensor(1.0))
    deadline = time.monotonic() + 10.0
    while not drain._dead and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(ValueError, match="drain callback failed"):
        drain.submit(lambda v: None, torch.tensor(2.0))
    # delivered once: the next submit is a silent drop, flush is clean
    drain.submit(lambda v: None, torch.tensor(3.0))
    drain.flush()
    drain.close(raise_errors=False)


def _timeout():
    release, ran = threading.Event(), []
    drain = MetricsDrain()
    drain.submit(lambda v: (release.wait(10.0), ran.append(float(v))),
                 torch.tensor(1.0))
    with pytest.raises(TimeoutError, match="drain stalled"):
        drain.flush(timeout=0.1)
    release.set()
    drain.flush()
    assert ran == [1.0]
    drain.close()


def _interrupt():
    got, gate = [], threading.Event()
    drain = MetricsDrain()
    # the gate holds the worker so both rows are pending when close()
    # meets the interrupt
    drain.submit(lambda v: (gate.wait(10.0), got.append(float(v))),
                 torch.tensor(1.0))
    drain.submit(lambda v: got.append(float(v)), torch.tensor(2.0))
    orig_flush, state = drain.flush, {"interrupted": False}

    def interrupted_flush(timeout=None):
        if not state["interrupted"]:
            state["interrupted"] = True
            gate.set()
            raise KeyboardInterrupt
        orig_flush(timeout)
    drain.flush = interrupted_flush
    with pytest.raises(KeyboardInterrupt):
        drain.close()
    assert got == [1.0, 2.0]
    assert drain._thread is None


def test_drain_fifo_and_error_policy():
    for case in (_fifo, _tree, _error_at_flush, _error_at_submit, _timeout,
                 _interrupt):
        case()


def _rows(log_dir):
    (run,) = [d for d in os.listdir(log_dir)
              if os.path.isdir(os.path.join(log_dir, d))]
    with open(os.path.join(log_dir, run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_drain_rows_equal_sync_rows(tmp_path, capsys):
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    base = ["--device", "cpu", "--data", "synthetic", "--num_agents", "6",
            "--bs", "16", "--local_ep", "1", "--synth_train_size", "192",
            "--synth_val_size", "64", "--eval_bs", "64", "--rounds", "4",
            "--snap", "2", "--seed", "5", "--num_corrupt", "1",
            "--poison_frac", "1.0", "--robustLR_threshold", "2",
            "--telemetry", "full", "--dropout_rate", "0.3",
            "--no_tensorboard", "--data_dir", str(tmp_path / "nodata")]
    try:
        train.main(base + ["--log_dir", str(tmp_path / "async")])
        assert "[metrics] async drain" in capsys.readouterr().out
        train.main(base + ["--log_dir", str(tmp_path / "sync"),
                           "--sync_metrics"])
        assert "[metrics] async drain" not in capsys.readouterr().out
        # checkpoints under the drain: the save waits for the boundary's
        # rows, so the resumed run continues the cumulative mean
        ck = ["--checkpoint_dir", str(tmp_path / "ck"), "--log_dir",
              str(tmp_path / "ck_logs")]
        cut = [a if a != "4" else "2" for a in base]
        train.main(cut + ck)
        train.main(base + ck + ["--resume"])
        train.main(base + ["--log_dir", str(tmp_path / "straight")])
    finally:
        torch.set_num_threads(old)
    ra = [r for r in _rows(tmp_path / "async")
          if not r["tag"].startswith(WALL_CLOCK)]
    rs = [r for r in _rows(tmp_path / "sync")
          if not r["tag"].startswith(WALL_CLOCK)]
    assert ra == rs
    tags = {r["tag"] for r in ra}
    assert {"Validation/Accuracy", "Health/Loss_Z", "Faults/Dropped",
            "Reputation/Clients_Tracked"} <= tags
    assert any(t.startswith("Defense/") for t in tags)
    assert {r["step"] for r in ra} == {2, 4}

    def cumulative(rows):
        return [r["value"] for r in rows
                if r["tag"] == "Poison/Cumulative_Poison_Accuracy_Mean"]
    resumed = [r for r in _rows(tmp_path / "ck_logs")
               if not r["tag"].startswith(WALL_CLOCK)]
    straight = [r for r in _rows(tmp_path / "straight")
                if not r["tag"].startswith(WALL_CLOCK)]
    assert resumed == straight
    assert len(cumulative(resumed)) == 2
