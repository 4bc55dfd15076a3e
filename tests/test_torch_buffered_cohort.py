"""The port's cohort-sampled round under --agg_mode buffered, through
`train.run` on a 64-client dirichlet bank with 8-client cohorts.

Degenerate parity (JAX tests/test_buffered.py's vmap pin on the cohort
round): with K = m, no stragglers and the exponent 0 every member of a
cohort arrives in its own tick (no shortfall: every member is active),
the gate fires every tick, and the buffered fold is the cohort round's
masked server step (the cohort always carries its `active` mask): the
params equal the sync cohort run's bit for bit for sign + RLR, and every
metrics.jsonl row the two runs share is the same.

The arrival schedule on the cohort round (JAX
test_cohort_mirror_matches_cohort_program), chained 2 ticks a dispatch,
under diurnal traffic (the log-normal latency of data/traffic.
latency_quantile): a commit gate the run never reaches, and each
boundary's Async/Staleness_Hist rows equal to the cumulative arrivals of
the active members that `fl/buffered.host_latency_draw` predicts from
the cohort (data/cohort.sample_cohort_host) and its fault draw (rounds 2
and 4).

No process is spawned; everything is written under tmp_path.
At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import json

import numpy as np
import pytest
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch import (
    train)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data import (
    cohort as cohort_mod)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    buffered, rounds)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _base(tmp_path, **kw):
    return Config(data="synthetic", num_agents=64, cohort_sampled="on",
                  cohort_size=8, partitioner="dirichlet", bs=32, local_ep=1,
                  rounds=4, snap=2, synth_train_size=1024, synth_val_size=64,
                  device="cpu", num_corrupt=6, poison_frac=0.5,
                  robustLR_threshold=2, tensorboard=False,
                  data_dir=str(tmp_path / "nodata"),
                  bank_dir=str(tmp_path / "bank")).replace(**kw)


def _rows(cfg):
    path = f"{cfg.log_dir}/{train.run_name(cfg)}/metrics.jsonl"
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows
            if not r["tag"].startswith(("_run/", "Throughput/"))]


def test_degenerate_buffered_cohort_equals_sync(tmp_path):
    sync = _base(tmp_path, aggr="sign", log_dir=str(tmp_path / "s"))
    buf = sync.replace(agg_mode="buffered", log_dir=str(tmp_path / "b"))
    want, got = train.run(sync), train.run(buf)
    for k, v in want["params"].items():
        assert torch.equal(got["params"][k], v), k
    assert got["async_committed"] == 1.0
    assert got["async_fill"] == 8.0
    rows_b = _rows(buf)
    assert [r for r in rows_b if not r["tag"].startswith("Async/")] \
        == _rows(sync)
    assert {r["tag"] for r in rows_b if r["tag"].startswith("Async/")} == {
        "Async/Buffer_Fill", "Async/Committed",
        *(f"Async/Staleness_Hist/{b}" for b in range(5))}


def test_cohort_arrivals_match_host_schedule(tmp_path, capsys):
    S, n = 2, 4
    cfg = _base(tmp_path, agg_mode="buffered", straggler_rate=0.7,
                async_max_staleness=S, async_buffer_k=10_000, chain=2,
                traffic="diurnal", telemetry="full",
                log_dir=str(tmp_path / "q"))
    expect = np.zeros((n + 1, S + 1))
    for t in range(1, n + 1):
        ids, active = cohort_mod.sample_cohort_host(cfg, t)
        draw = rounds.draw_faults_host(cfg, rounds.RoundRNG(cfg.seed, "cpu"),
                                       t, ids, active)
        lat = buffered.host_latency_draw(cfg, t, draw.straggler, cfg.seed)
        for T, a in zip(lat.tolist(), active):
            if a and t + T <= n:
                expect[t + T, T] += 1
    assert expect[:, 1:].sum() > 0          # late arrivals landed in the run
    s = train.run(cfg)
    said = capsys.readouterr().out
    assert "[chain] 2 rounds per dispatch (gathered blocks)" in said
    rows = {(r["tag"], r["step"]): r["value"] for r in _rows(cfg)}
    cum = np.cumsum(expect, axis=0)
    for r in (2, 4):
        got = [rows[f"Async/Staleness_Hist/{b}", r] for b in range(S + 1)]
        np.testing.assert_array_equal(got, cum[r], err_msg=f"round {r}")
        assert rows["Async/Buffer_Fill", r] == cum[r].sum()
        assert rows["Async/Committed", r] == 0.0
    assert s["async_stale_hist"] == cum[n].tolist()
