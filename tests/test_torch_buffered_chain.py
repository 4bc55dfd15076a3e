"""The buffer as a carry through the port's `train.run`: chained ticks
against one tick a dispatch, and a run cut between commits and resumed
against the straight run.

The buffered round's params are fl/buffered.join_carry's carry (the
model params and the buffer state in one dict), so `make_chained` threads
the buffer as it threads the params, and the checkpoint saves it beside
them. Both runs use stragglers (pending arrivals up to 3 ticks late,
weighted by 1/(1+T)^0.5), a commit gate of 4 arrivals over cohorts of 6,
RLR and full telemetry; eager on the CPU the same ops meet the same
inputs, so: `--chain 2` equals `--chain 1` bit for bit (the model params,
the buffer, and every metrics.jsonl row apart from `_run/start` and
Throughput/*); and a run cut at round 2 between commits, then resumed
to 4, equals the straight 4 rounds (params and buffer bit for bit, every
row from round 3 on apart from `_run/start` and Throughput/*). The
resumed pair gates at 12 arrivals (2m), so tick 2 ends with a partly
filled buffer (arrivals held, none committed) and a commit falls in the
resumed ticks.

No process is spawned; everything is written under tmp_path.
At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import json

import pytest
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch import (
    train)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _base(tmp_path, **kw):
    return Config(data="synthetic", num_agents=6, bs=16, local_ep=1,
                  rounds=4, snap=2, synth_train_size=192, synth_val_size=32,
                  device="cpu", num_corrupt=1, poison_frac=0.5,
                  robustLR_threshold=2, telemetry="full",
                  agg_mode="buffered", straggler_rate=0.5,
                  async_buffer_k=4, async_staleness_exp=0.5,
                  async_max_staleness=3, tensorboard=False,
                  data_dir=str(tmp_path / "nodata")).replace(**kw)


def _rows(cfg, first=1):
    path = f"{cfg.log_dir}/{train.run_name(cfg)}/metrics.jsonl"
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    start = max(i for i, r in enumerate(rows) if r["tag"] == "_run/start")
    return [r for r in rows[start:] if r["step"] >= first
            and not r["tag"].startswith(("_run/", "Throughput/"))]


def _same(a, b):
    for part in ("params", "buffer"):
        assert a[part].keys() == b[part].keys(), part
        for k, v in a[part].items():
            assert torch.equal(b[part][k], v), (part, k)


def test_chained_buffered_equals_per_tick(tmp_path, capsys):
    runs = {}
    for chain in (1, 2):
        cfg = _base(tmp_path, chain=chain, log_dir=str(tmp_path / f"c{chain}"))
        runs[chain] = (train.run(cfg), _rows(cfg))
    said = capsys.readouterr().out
    assert "[async] buffered aggregation: commit every 4 arrivals" in said
    assert "[chain] 2 rounds per dispatch" in said
    (one, rows1), (two, rows2) = runs[1], runs[2]
    _same(one, two)
    assert rows1 == rows2
    tags = {r["tag"] for r in rows1}
    assert {"Async/Buffer_Fill", "Async/Committed",
            "Async/Staleness_Hist/3", "Defense/Stale_Flip_Fraction/3",
            "Defense/Stale_Cosine_To_Agg/0"} <= tags


def test_resume_mid_buffer_equals_straight(tmp_path, capsys):
    straight = _base(tmp_path, async_buffer_k=12,
                     log_dir=str(tmp_path / "a"),
                     checkpoint_dir=str(tmp_path / "ck_a"))
    cut = straight.replace(rounds=2, log_dir=str(tmp_path / "b"),
                           checkpoint_dir=str(tmp_path / "ck_b"))
    want = train.run(straight)
    part = train.run(cut)
    # cut between commits: arrivals held in the buffer, not yet committed
    assert float(part["buffer"]["count"]) > 0
    got = train.run(cut.replace(rounds=4, resume=True))
    assert "[ckpt] resumed from round 2" in capsys.readouterr().out
    _same(want, got)
    # params move only at commits: the resumed ticks held one
    assert any(not torch.equal(got["params"][k], v)
               for k, v in part["params"].items())
    assert _rows(straight, 3) == _rows(cut, 3)
    assert any(r["tag"] == "Async/Buffer_Fill" for r in _rows(cut, 3))
