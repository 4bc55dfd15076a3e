"""The port's host-sampled round (fl/rounds.make_host_step /
make_round_fn_host), its driver (train.sample_ids, the host branch of
train.run) and its input pipeline (data/prefetch.py) against the JAX
package's.

Controlled variables as in tests/test_torch_batched.py: a Flax init
carried across, the epoch permutations replayed from the JAX keys and
injected, dropout off. JAX's host step runs under a plain `jax.jit`, on
m = 3 gathered shards of 40/48/17 samples at bs 16 (partial, full and
fully padded batches), CNN_CIFAR at 24x24x3. JAX's per-round sampling is a
closure of its driver; its draw (numpy, seeded from the seed and the
round) is restated here. Every path a test writes is under `tmp_path`.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu.config import (
    Config as JaxConfig, args_parser as jax_args_parser)
from defending_against_backdoors_with_robust_learning_rate_tpu.data.prefetch import (
    RoundPrefetcher as JaxPrefetcher)
from defending_against_backdoors_with_robust_learning_rate_tpu.fl import (
    rounds as jax_rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu.fl.common import (
    make_normalizer as jax_make_normalizer)
from defending_against_backdoors_with_robust_learning_rate_tpu.models.cnn import (
    CNN_CIFAR as JaxCNN)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch import (
    train)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data.prefetch import (
    RoundPrefetcher)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    common, rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    carrier, registry)

SHAPE = (24, 24, 3)
BS, N_TOTAL = 16, 48
SIZES = [48, 30, 17, 40, 24]        # the K = 5 agents' true shard sizes
IDS = [3, 0, 2]                     # the round's sample: 40 / 48 / 17
MEAN, STD = (0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)
KW = dict(data="cifar10", num_agents=5, agent_frac=0.6, bs=BS, local_ep=2,
          client_lr=0.1, client_moment=0.9, aggr="avg")
REFERENCE_TAGS = {
    "Validation/Loss", "Validation/Accuracy", "Poison/Base_Class_Accuracy",
    "Poison/Poison_Accuracy", "Poison/Poison_Loss",
    "Poison/Cumulative_Poison_Accuracy_Mean", "Train/Loss",
    "Throughput/Rounds_Per_Sec"}


class _NoDropout:
    """A Flax module whose train-mode forward runs without dropout."""

    def __init__(self, inner):
        self._inner = inner

    def apply(self, variables, x, train=False, rngs=None):
        del train, rngs
        return self._inner.apply(variables, x, train=False)


def _epoch_perms(key, size, local_ep):
    """fl/client.make_local_train's shuffle, replayed from the agent's key:
    per epoch, split -> uniform -> padding pushed back -> argsort."""
    perms = []
    for ep_key in jax.random.split(key, local_ep):
        shuffle_key, _ = jax.random.split(ep_key)
        r = jax.random.uniform(shuffle_key, (N_TOTAL,))
        r = jnp.where(jnp.arange(N_TOTAL) < size, r, 2.0)
        perms.append(torch.from_numpy(np.array(jnp.argsort(r))).long())
    return perms


def _flat(params):
    return np.concatenate([v.detach().numpy().ravel()
                           for v in params.values()])


def test_host_step_matches_jax():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        rng = np.random.default_rng(42)
        # float pixels, as tests/test_torch_batched.py: on uint8 pixels a
        # few 2x2 max-pool windows hold two values within 1e-5 of each
        # other, f32 reordering can swap which one wins, and the gradient
        # then reaches another input patch (Conv_0 moves by 5e-3 of its
        # scale on the agent with such a window)
        xs = rng.uniform(0, 255, size=(len(SIZES), N_TOTAL) + SHAPE).astype(
            np.float32)
        ys = rng.integers(0, 10, size=(len(SIZES), N_TOTAL)).astype(np.int32)
        sizes = np.asarray(SIZES, np.int32)
        shapes = jax.eval_shape(JaxCNN().init, jax.random.PRNGKey(0),
                                jnp.zeros((1,) + SHAPE))["params"]
        flax_params = {mod: {name: (rng.normal(size=leaf.shape) / np.sqrt(
            np.prod(leaf.shape[:-1]) if name == "kernel" else 10.0)).astype(
                np.float32) for name, leaf in leaves.items()}
            for mod, leaves in shapes.items()}

        # JAX: the host step over the gathered [m] stacks, one jit
        jcfg = JaxConfig(**KW)
        assert jcfg.agents_per_round == len(IDS)
        step = jax.jit(jax_rounds.make_host_step(
            jcfg, _NoDropout(JaxCNN()), jax_make_normalizer(MEAN, STD,
                                                            False)))
        key = jax.random.PRNGKey(11)
        j_new, j_info = step(flax_params, key, jnp.asarray(xs[IDS]),
                             jnp.asarray(ys[IDS]), jnp.asarray(sizes[IDS]))
        # the agent keys the step derives, and each slot's shuffles
        agent_keys = jax.random.split(jax.random.split(key)[0], len(IDS))
        perms = [_epoch_perms(agent_keys[s], SIZES[a], jcfg.local_ep)
                 for s, a in enumerate(IDS)]

        # the port: the host round on the same gathered stacks
        cfg = Config(**KW)
        model = registry.get_model("cifar10", SHAPE)
        norm = common.make_normalizer(MEAN, STD, "cpu")
        params = carrier.params_from_flax(flax_params, "cpu")
        host_round = rounds.make_round_fn_host(cfg, model, norm, sizes,
                                               N_TOTAL, "cpu")
        assert host_round.graph is None         # eager on the CPU
        imgs = torch.from_numpy(xs[IDS])
        lbls = torch.from_numpy(ys[IDS]).long()
        slot_sizes = torch.from_numpy(sizes[IDS])
        new, info = host_round(params, rounds.RoundRNG(0, "cpu"), IDS, imgs,
                               lbls, slot_sizes, perms=perms, dropout=False)
        assert info["sampled"] == IDS
        ours = _flat(new) - _flat(params)
        ref = _flat(carrier.params_from_flax(
            jax.tree_util.tree_map(np.asarray, j_new), "cpu")) - _flat(params)
        scale = np.abs(ref).max()
        assert scale > 1e-3                     # the agents trained
        # f32 on both sides, other conv/matmul summation orders: every
        # coordinate of the round's update within 1e-4 of its scale, 1e-5
        # relative L2
        np.testing.assert_allclose(ours, ref, atol=1e-4 * scale, rtol=0)
        assert np.linalg.norm(ours - ref) / np.linalg.norm(ref) < 1e-5
        np.testing.assert_allclose(float(info["train_loss"]),
                                   float(j_info["train_loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(info["hlth_update_normsq"]),
                                   float(j_info["hlth_update_normsq"]),
                                   rtol=1e-4)
        assert float(info["hlth_nonfinite"]) == 0.0

        # the host round equals the device-resident round on the same ids
        # and slot draws, dropout on: the same kernels on the same rows
        c = cfg.replace(robustLR_threshold=2)
        dense = rounds.make_round_fn(c, model, norm, torch.from_numpy(xs),
                                     torch.from_numpy(ys).long(), sizes)
        host = rounds.make_round_fn_host(c, model, norm, sizes, N_TOTAL,
                                         "cpu")
        p_dense, i_dense = dense(params, rounds.RoundRNG(5, "cpu"),
                                 sampled=IDS)
        p_host, i_host = host(params, rounds.RoundRNG(5, "cpu"), IDS, imgs,
                              lbls, slot_sizes)
        np.testing.assert_allclose(_flat(p_host), _flat(p_dense), rtol=0,
                                   atol=1e-6 * scale)
        assert float(i_host["train_loss"]) == pytest.approx(
            float(i_dense["train_loss"]), rel=1e-6)
    finally:
        torch.set_num_threads(old)


def _prefetch_contract(cls):
    """What a RoundPrefetcher does on order, retry, a failing producer and
    exhaustion: a list of (event, value or error message)."""
    seen = []
    pf = cls(lambda r: {"round": r}, [1, 2, 3], depth=2)
    try:
        first = pf.get(1)
        seen.append(("get 1", first))
        seen.append(("retry 1 is the same payload", pf.get(1) is first))
        seen.append(("get 2", pf.get(2)))
        seen.append(("get 3", pf.get(3)))
        with pytest.raises(RuntimeError) as e:
            pf.get(4)
        seen.append(("exhausted", str(e.value)))
    finally:
        pf.close()

    def produce(r):
        if r == 2:
            raise KeyError("no shard")
        return r
    pf = cls(produce, [1, 2], depth=1)
    try:
        seen.append(("before the failure", pf.get(1)))
        with pytest.raises(RuntimeError) as e:
            pf.get(2)
        seen.append(("failed", (str(e.value), repr(e.value.__cause__))))
    finally:
        pf.close()
    pf = cls(lambda r: r, [1, 2], depth=1)
    try:
        with pytest.raises(RuntimeError) as e:
            pf.get(2)
        seen.append(("order", str(e.value)))
    finally:
        pf.close()
    with pytest.raises(ValueError) as e:
        cls(lambda r: r, [1], depth=0)
    seen.append(("depth", str(e.value)))
    return seen


def _parse_error(parse, argv, capsys):
    with pytest.raises(SystemExit):
        parse(argv)
    return capsys.readouterr().err.strip().splitlines()[-1]


def test_host_sampling_prefetch_and_cli(tmp_path, capsys):
    # the driver's sampled ids: JAX's numpy draws, round by round, at the
    # Fed-EMNIST run's K = 3383 and 1% (m = 33)
    cfg = Config(data="fedemnist", num_agents=3383, agent_frac=0.01, seed=3)
    assert cfg.agents_per_round == 33
    for rnd in range(1, 51):
        want = np.random.default_rng(cfg.seed * 100_003 + rnd).choice(
            cfg.num_agents, cfg.agents_per_round, replace=False)
        got = train.sample_ids(cfg, rnd)
        np.testing.assert_array_equal(got, want)
        assert len(set(got.tolist())) == 33

    # the prefetcher keeps JAX's contract, message for message
    assert _prefetch_contract(RoundPrefetcher) == _prefetch_contract(
        JaxPrefetcher)

    # refusals: what this port has not ported yet, and JAX's own error for
    # a --host_sampled value that is not a choice
    for argv in (["--tenants", "2"], ["--rlr_adapt", "on"]):
        with pytest.raises(ValueError, match="not ported yet"):
            train.args_parser(argv)
    # buffered aggregation is ported (slice 11); its host-sampled step
    # refuses it, as JAX's does
    assert train.args_parser(["--agg_mode", "buffered"]).agg_mode == \
        "buffered"
    for bad in (["--host_sampled", "sometimes"],
                ["--remat", "--remat_policy", "layer"]):
        assert (_parse_error(train.args_parser, bad, capsys)
                == _parse_error(jax_args_parser, bad, capsys))
    # --remat is ported (slice 10): accepted with JAX's choices
    got = train.args_parser(["--remat", "--remat_policy", "conv", "--dtype",
                             "bf16", "--sync_metrics"])
    assert (got.remat, got.remat_policy, got.dtype, got.async_metrics) == (
        True, "conv", "bf16", False)
    assert train.args_parser(["--host_sampled", "on"]).host_prefetch == 2

    # a CPU run of the host-sampled round, 2 rounds, prefetched
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        rc = train.main([
            "--device", "cpu", "--data", "fedemnist", "--num_agents", "40",
            "--agent_frac", "0.1", "--bs", "16", "--local_ep", "2",
            "--rounds", "2", "--snap", "1", "--synth_train_size", "600",
            "--synth_val_size", "64", "--eval_bs", "32", "--num_corrupt",
            "4", "--poison_frac", "0.5", "--robustLR_threshold", "2",
            "--host_sampled", "on", "--data_dir", str(tmp_path / "none"),
            "--log_dir", str(tmp_path / "logs")])
    finally:
        torch.set_num_threads(old)
    assert rc == 0
    out = capsys.readouterr().out
    assert "[data] host-sampled mode" in out
    assert "[prefetch] host->device pipeline, depth 2" in out
    assert "Training has finished!" in out
    (path,) = (tmp_path / "logs").glob("*/metrics.jsonl")
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    for step in (1, 2):
        got = {r["tag"] for r in rows if r["step"] == step}
        assert REFERENCE_TAGS <= got, step
    assert all(np.isfinite(r["value"]) for r in rows)
