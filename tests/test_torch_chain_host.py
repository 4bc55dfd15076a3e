"""The chained host-sampled and cohort rounds through the port's
`train.run` against their one-round-a-dispatch twins.

A chained unit gathers its rounds as one [chain, m, ...] block (one
payload of the prefetcher) and runs round_fn once per row of it
(fl/rounds.make_chained_host; on a card, one replay of the round's
captured graph per row), as JAX's `make_chained_host` scans the block.
Eager on the CPU the same ops meet the same inputs, so the runs must be
equal bit for bit: the final params, and every metrics.jsonl row apart
from `_run/start` and Throughput/*. The host-sampled run is the
Fed-EMNIST stand-in (K = 40, 10% a round, the RLR vote, the fused server
step's CPU path); the cohort run a 5,000-client dirichlet bank under
churn, diurnal traffic, dropout sparing the attackers, a signflip attack
and full telemetry, whose flags the chained cohort rounds keep.

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
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    rounds)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _rows(cfg):
    path = f"{cfg.log_dir}/{train.run_name(cfg)}/metrics.jsonl"
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows
            if not r["tag"].startswith(("_run/", "Throughput/"))]


def _chain_vs_unchained(base, tmp_path, capsys):
    out = {}
    for chain in (1, 2):
        cfg = base.replace(chain=chain, log_dir=str(tmp_path / f"c{chain}"))
        out[chain] = (train.run(cfg), _rows(cfg), capsys.readouterr().out)
    (one, rows1, _), (two, rows2, said) = out[1], out[2]
    for k, v in one["params"].items():
        assert torch.equal(two["params"][k], v), k
    assert rows1 == rows2
    return rows1, said


def test_chained_host_round_equals_unchained(tmp_path, capsys):
    base = Config(data="fedemnist", num_agents=40, agent_frac=0.1, bs=16,
                  local_ep=2, rounds=4, snap=2, synth_train_size=600,
                  synth_val_size=64, eval_bs=32, num_corrupt=4,
                  poison_frac=0.5, robustLR_threshold=2, host_sampled="on",
                  host_prefetch=2, data_dir=str(tmp_path / "none"),
                  tensorboard=False, device="cpu")
    assert rounds._fused_applicable(base)
    rows, said = _chain_vs_unchained(base, tmp_path, capsys)
    assert "[chain] 2 rounds per dispatch (gathered blocks)" in said
    assert "[data] host-sampled mode" in said
    assert {r["step"] for r in rows if r["tag"] == "Train/Loss"} == {2, 4}
    # under faults the host round stays unchained, with JAX's line
    train.run(base.replace(chain=2, dropout_rate=0.3, rounds=2,
                           log_dir=str(tmp_path / "f")))
    assert ("[faults] host-sampled mode: --chain disabled (faults needs "
            "per-round corrupt flags riding each dispatch)"
            in capsys.readouterr().out)


def test_chained_cohort_round_equals_unchained(tmp_path, capsys):
    base = Config(data="synthetic", num_agents=5000, cohort_size=8,
                  partitioner="dirichlet", bs=16, local_ep=1, rounds=4,
                  snap=2, synth_train_size=512, synth_val_size=64,
                  eval_bs=32, num_corrupt=200, poison_frac=0.5,
                  robustLR_threshold=2, churn_available=0.4,
                  churn_period=3, traffic="diurnal", traffic_day_rounds=6,
                  dropout_rate=0.3, faults_spare_corrupt=True,
                  attack="signflip", attack_boost=2.0, telemetry="full",
                  host_prefetch=2, data_dir=str(tmp_path / "none"),
                  tensorboard=False, device="cpu")
    rows, said = _chain_vs_unchained(base, tmp_path, capsys)
    assert "[cohort] population 5,000 clients -> 8-client cohorts" in said
    assert "[prefetch] cohort gather pipeline, depth 2" in said
    tags = {r["tag"] for r in rows}
    assert {"Churn/Sampled_Away", "Faults/Effective_Voters",
            "Defense/Cosine_Corrupt_To_Agg"} <= tags
