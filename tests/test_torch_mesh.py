"""The port's `agents` axis helpers (parallel/mesh.py, parallel/multihost.py)
against the JAX package's, and train.run's sharded branch (train.run with
an `agents` group) end to end on the CPU.

The ranks are gloo process groups on threads of this process
(parallel/mesh.run_in_threads): no process, no port, no global process
group.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import json

import numpy as np
import pytest
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu.parallel.mesh import (
    pick_agent_mesh_size as jax_pick_agent_mesh_size)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch import (
    train)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config, args_parser)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel import (
    multihost)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.mesh import (
    pick_agent_mesh_size, run_in_threads)

HEALTH_TAGS = {"Health/Nonfinite_Updates", "Health/Params_Finite",
               "Health/Update_Norm"}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_mesh_helpers(monkeypatch):
    for n in (1, 2, 4, 8):
        for m in range(1, 41):
            for req in range(0, 10):
                assert (pick_agent_mesh_size(req, m, n)
                        == jax_pick_agent_mesh_size(req, m, n_devices=n))
    assert pick_agent_mesh_size(8, 10, 8) == 5     # m=10 on 8 cards

    # the plan: the loss (health lanes packed in), the weight total for
    # avg, and one packed all_reduce of every leaf's partials: 3 for avg
    # + RLR and 2 for sign, fused and plain alike (JAX's compiled count)
    cfg = Config(robustLR_threshold=4, device="cpu")
    assert multihost.leaf_plan_collectives(cfg) == 3
    assert multihost.leaf_plan_collectives(cfg.replace(aggr="sign")) == 2
    assert multihost.leaf_plan_collectives(cfg.replace(use_fused=False)) == 3

    # no flags and no torchrun environment: a single-process run
    for var in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.maybe_initialize() is None
    assert multihost.is_lead(None)
    assert train._agents_group(cfg.replace(mesh=0)) is None
    with pytest.raises(ValueError, match="divisible"):
        multihost.require_pod_divisible(10, "multi-card", 4)
    cli = args_parser(["--mesh", "0", "--health", "off", "--agg_layout",
                       "leaf", "--coordinator", "", "--num_processes", "0"])
    assert (cli.mesh, cli.health, cli.agg_layout) == (0, "off", "leaf")

    # a group counts its all_reduces; a failing rank's error comes out,
    # and the peer left in its collective times out instead of hanging
    def rank(group):
        t = torch.tensor([float(group.rank + 1)])
        group.all_reduce_sum_(group.all_reduce_sum_(t))
        return float(t), group.calls, multihost.is_lead(group)
    assert run_in_threads(3, rank) == [(18.0, 2, True), (18.0, 2, False),
                                       (18.0, 2, False)]

    def failing(group):
        if group.rank == 1:
            raise RuntimeError("rank 1 failed")
        group.all_reduce_sum_(torch.zeros(1))
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        run_in_threads(2, failing, timeout_s=4)


def test_train_run_sharded_matches_dense(tmp_path, capsys):
    """train.run on d=2 ranks: the lead alone prints and writes metrics
    (with the Health/* rows), every rank ends with the dense run's params,
    and a sharded round the run's plan of all_reduces."""
    kw = dict(data="synthetic", num_agents=4, bs=16, local_ep=1, rounds=2,
              snap=1, synth_train_size=128, synth_val_size=64, eval_bs=32,
              num_corrupt=1, poison_frac=1.0, robustLR_threshold=2,
              device="cpu")
    dense = train.run(Config(**kw, log_dir=str(tmp_path / "dense")))
    capsys.readouterr()
    cfg = Config(**kw, log_dir=str(tmp_path / "sharded"))

    def rank(group):
        out = train.run(cfg, group=group)
        return out, group.calls

    results = run_in_threads(2, rank)
    out = capsys.readouterr().out
    assert out.count("[mesh] 2 devices on the `agents` axis") == 1
    assert out.count("[agg] fused server step") == 1
    assert out.count("Training has finished!") == 1
    per_round = multihost.leaf_plan_collectives(cfg)
    for summary, calls in results:
        assert calls == cfg.rounds * per_round
        for k, p in dense["params"].items():
            # the same draws per slot; the server step's sums in another
            # order, over two rounds: 1e-5
            np.testing.assert_allclose(summary["params"][k].numpy(),
                                       p.numpy(), atol=1e-5, rtol=1e-5,
                                       err_msg=k)
    lead = results[0][0]
    np.testing.assert_allclose(lead["train_loss"], dense["train_loss"],
                               rtol=1e-4)
    (path,) = (tmp_path / "sharded").glob("*/metrics.jsonl")
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    for step in (1, 2):
        tags = {r["tag"] for r in rows if r["step"] == step}
        assert HEALTH_TAGS <= tags and "Train/Loss" in tags, step
    assert all(np.isfinite(r["value"]) for r in rows)
