"""The port's chained dispatch: `train.dispatch_schedule` against JAX's,
and a CPU `train.run` with `--chain 2` against `--chain 1`, its steady
rate row, `fl/rounds.make_chained_round_fn`'s stacked lanes, and the
sharded run at d = 2 (gloo thread ranks, dropout on, the seed's own draws)
against the dense run.

CPU only: the round runs eagerly here (the captured CUDA graph is the
card's; chip_smoke.py holds its replays to the eager round). The d ranks
are threads of this process (parallel/mesh.run_in_threads): no process,
no port.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import itertools
import json

import numpy as np
import pytest
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu.train import (
    dispatch_schedule as jax_dispatch_schedule)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch import (
    train)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data.registry import (
    get_federated_data)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    common, rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    registry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.mesh import (
    run_in_threads)

STEADY = "Throughput/Steady_Rounds_Per_Sec"
SPEED = ("Throughput/Rounds_Per_Sec", STEADY)
CFG = Config(data="synthetic", num_agents=4, bs=16, local_ep=1, rounds=4,
             snap=2, synth_train_size=128, synth_val_size=64, eval_bs=32,
             num_corrupt=1, poison_frac=1.0, robustLR_threshold=2,
             device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_dispatch_schedule_matches_jax():
    grid = itertools.product(range(0, 5), range(0, 13), (1, 2, 3, 5),
                             (1, 2, 3, 4), (False, True), (False, True))
    n = 0
    for start, total, snap, chain, diag, chaining in grid:
        args = (start, total, snap, chain, diag, chaining)
        assert (train.dispatch_schedule(*args)
                == jax_dispatch_schedule(*args)), args
        n += 1
    assert n == 5 * 13 * 4 * 4 * 2 * 2


def _rows(log_dir):
    (path,) = log_dir.glob("*/metrics.jsonl")
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return [r for r in rows if not r["tag"].startswith("_run")]


def test_chain_run_matches_unchained_and_sharded(tmp_path):
    runs = {}
    for chain in (1, 2):
        log_dir = tmp_path / f"chain{chain}"
        s = train.run(CFG.replace(chain=chain, log_dir=str(log_dir)))
        runs[chain] = (s, _rows(log_dir))
    (s1, rows1), (s2, rows2) = runs[1], runs[2]
    # the same rounds in the same order, eagerly on the CPU: bit for bit
    for k, v in s1["params"].items():
        torch.testing.assert_close(s2["params"][k], v, atol=0, rtol=0)
    pick = [(r["tag"], r["step"], r["value"]) for r in rows1
            if r["tag"] not in SPEED]
    assert pick == [(r["tag"], r["step"], r["value"]) for r in rows2
                    if r["tag"] not in SPEED]
    assert {r["step"] for r in rows2} == {2, 4}
    # the steady rate after the first dispatch: rounds 2..4 unchained,
    # 3..4 after the first chained block of two
    for rows, steps in ((rows1, {2, 4}), (rows2, {4})):
        steady = {r["step"]: r["value"] for r in rows if r["tag"] == STEADY}
        assert set(steady) == steps
        assert all(np.isfinite(v) and v > 0 for v in steady.values())
    assert s2["steady_rounds_per_sec"] > 0
    with pytest.raises(ValueError, match="agent_chunk 3 does not divide"):
        train.run(CFG.replace(agent_chunk=3, rounds=1,
                              log_dir=str(tmp_path / "chunk3")))

    # the chained fn itself: two rounds in one call, the loss and the
    # health lanes stacked [2], equal to two calls of the round fn
    fed = get_federated_data(CFG)
    model = registry.get_model(CFG.data, CFG.image_shape)
    args = (CFG, model, common.make_normalizer(fed.mean, fed.std, "cpu"),
            torch.from_numpy(fed.train.images),
            torch.from_numpy(fed.train.labels).long(), fed.train.sizes)
    p0 = registry.init_params(model, CFG.seed, "cpu")
    p2, stacked = rounds.make_chained_round_fn(*args)(
        p0, rounds.RoundRNG(CFG.seed, "cpu"), 2)
    round_fn, rng, p = rounds.make_round_fn(*args), rounds.RoundRNG(
        CFG.seed, "cpu"), p0
    for j in range(2):
        p, info = round_fn(p, rng)
        assert stacked["sampled"][j] == info["sampled"]
        for k, v in info.items():
            if k == "train_loss" or k.startswith("hlth_"):
                assert stacked[k].shape == (2,) + v.shape, k
                torch.testing.assert_close(stacked[k][j], v, atol=0, rtol=0)
    for k, v in p.items():
        torch.testing.assert_close(p2[k], v, atol=0, rtol=0)

    # the sharded run at d = 2, dropout on, the seed's draws: each slot
    # draws what the dense round draws, so it follows the dense run
    def rank(group):
        return train.run(CFG.replace(log_dir=str(tmp_path / "sharded")),
                         group=group)

    for s in run_in_threads(2, rank):
        assert s["all_reduces"] == 4 * 3       # the plan's 3 a round
        for k, v in s1["params"].items():
            # the same local training; the server step's sums in another
            # order (partials, then the all_reduce), over four rounds: 1e-5
            np.testing.assert_allclose(s["params"][k].numpy(), v.numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=k)
    sharded = {r["tag"]: r["value"] for r in _rows(tmp_path / "sharded")
               if r["step"] == 4 and r["tag"] not in SPEED}
    # the sharded round does not compute the reputation lanes (auto
    # resolves off there), so the dense run's Reputation/* rows have no
    # sharded twin
    dense = {r["tag"]: r["value"] for r in rows1
             if r["step"] == 4 and r["tag"] not in SPEED
             and not r["tag"].startswith("Reputation/")}
    assert set(sharded) == set(dense)
    for tag, value in dense.items():
        np.testing.assert_allclose(sharded[tag], value, rtol=1e-4, atol=1e-6,
                                   err_msg=tag)
