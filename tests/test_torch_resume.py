"""Checkpoint and resume through the port's `train.run`: a run cut at round
5 and resumed to 10 against the uninterrupted 10 rounds.

The configuration of JAX's mid-chain resume test (tests/test_checkpoint.
py:131-170): synthetic data, 4 agents, seed 21, snap 5, chain 3, and
with it what a resumed run must carry: agent_frac 0.5 (the host
generator's sampled ids), server noise 0.001 with clip 1.0 (the noise
generator), RLR threshold 1 with `--reputation on` (the tracker's state
in the journal) and `--diagnostics` (cum_net_mov in the checkpoint, the
snap rounds' second round fn). The schedule re-enters mid-chain: rounds
6-8 are one chained block, then 9 and the diagnostics snap round 10
(`dispatch_schedule`). Parametrised over the device-resident round and
the host-sampled round (`--host_sampled on --host_prefetch 2`, one
round a dispatch; tests/test_torch_chain_host.py holds the chained host
round to it).

Held, exactly (eager on the CPU: the same ops on the same inputs): the
final params bit for bit, `[ckpt] resumed from round 5` printed, and
every metrics.jsonl row of rounds 6-10, apart from `_run/start` and
Throughput/* (which count the rounds of each life), equal to the
uninterrupted run's, Health/*, Reputation/*, Norms/* and
Sign/Model_Net_L2_Cumulative among them.

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
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils import (
    checkpoint as ckpt)

BASE = Config(data="synthetic", num_agents=4, agent_frac=0.5, bs=16,
              local_ep=1, synth_train_size=128, synth_val_size=64,
              eval_bs=32, num_corrupt=1, poison_frac=1.0,
              robustLR_threshold=1, noise=0.001, clip=1.0, reputation="on",
              diagnostics=True, snap=5, chain=3, seed=21, tensorboard=False,
              device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _last_life(cfg):
    """Rows of the run's last life (after its last _run/start), from round
    6 on, without the _run/start and Throughput/* rows."""
    path = f"{cfg.log_dir}/{train.run_name(cfg)}/metrics.jsonl"
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    start = max(i for i, r in enumerate(rows) if r["tag"] == "_run/start")
    return [r for r in rows[start:] if r["step"] >= 6
            and not r["tag"].startswith(("_run/", "Throughput/"))]


@pytest.mark.parametrize("host_sampled", ["off", "on"])
def test_resume_continues_the_uninterrupted_run(tmp_path, capsys,
                                                host_sampled):
    base = BASE.replace(host_sampled=host_sampled, host_prefetch=2,
                        chain=3 if host_sampled == "off" else 1)
    straight = base.replace(rounds=10, log_dir=str(tmp_path / "logs_a"),
                            checkpoint_dir=str(tmp_path / "ck_a"))
    cut = base.replace(rounds=5, log_dir=str(tmp_path / "logs_b"),
                       checkpoint_dir=str(tmp_path / "ck_b"))
    want = train.run(straight)
    train.run(cut)
    assert ckpt.saved_rounds(cut.checkpoint_dir) == [5]
    assert 5 % cut.chain != 0 or host_sampled == "on"
    capsys.readouterr()
    got = train.run(cut.replace(rounds=10, resume=True))
    out = capsys.readouterr().out
    assert "[ckpt] resumed from round 5" in out
    assert ckpt.saved_rounds(cut.checkpoint_dir) == [5, 10]
    assert ckpt.saved_rounds(straight.checkpoint_dir) == [5, 10]

    for k, v in want["params"].items():
        assert torch.equal(got["params"][k], v), k
    assert got["cum_net_mov"] == want["cum_net_mov"] != 0.0
    rows_a, rows_b = _last_life(straight), _last_life(cut)
    assert rows_b == rows_a
    tags = {r["tag"] for r in rows_a if r["step"] == 10}
    for tag in ("Health/Loss_Z", "Reputation/Mean_Agree",
                "Reputation/Suspicion_AUC", "Norms/Avg_Honest_L2",
                "Sign/Model_Net_L2_Cumulative",
                "Poison/Cumulative_Poison_Accuracy_Mean"):
        assert tag in tags, tag
    # the journal carries the health EMA and the tracker's state
    (entry,) = [e for e in ckpt.journal_read(cut.checkpoint_dir)
                if e["round"] == 10]
    assert entry["health"]["n"] == 2
    assert entry["reputation"]["rounds"] == 10
    assert got["suspicion"] == want["suspicion"]
