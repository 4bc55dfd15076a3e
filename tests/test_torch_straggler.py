"""The straggler lane of the port's local training (fl/client.py: the
per-agent epoch budget `ep_budget`) against JAX's six-argument
`make_local_train`, and the faults path's effect on the dense round.

Controlled variables as in tests/test_torch_batched.py: a Flax init carried
across by models/carrier.py, the epoch permutations replayed from the JAX
keys and injected, the sampled ids injected, dropout off; uneven shards of
96/80/65/33 samples at bs 32, CNN_MNIST at 14x14 inputs, local_ep 2 with
the budgets [2, 1, 1, 2] (the stragglers stop after one epoch). JAX's side
runs under a plain `jax.jit`.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu.config import (
    Config as JaxConfig)
from defending_against_backdoors_with_robust_learning_rate_tpu.fl.client import (
    make_local_train as jax_make_local_train)
from defending_against_backdoors_with_robust_learning_rate_tpu.fl.common import (
    make_normalizer as jax_make_normalizer)
from defending_against_backdoors_with_robust_learning_rate_tpu.models.cnn import (
    CNN_MNIST as JaxCNN)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.faults import (
    model as fmodel)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    client, common, rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    carrier, registry)

SHAPE = (14, 14, 1)
BS, N_TOTAL = 32, 96
SIZES = [96, 80, 65, 33]    # full / partial / partial / fully padded batches
SAMPLED = [2, 0, 3, 1]      # slot order differs from agent order
BUDGETS = [2, 1, 1, 2]      # per slot: slots 1 and 2 straggle
MEAN, STD = (0.5,), (0.5,)
KW = dict(data="fmnist", num_agents=4, bs=BS, local_ep=2, client_lr=0.1,
          client_moment=0.9, clip=3.0)


class _NoDropout:
    """A Flax module whose train-mode forward runs without dropout."""

    def __init__(self, inner):
        self._inner = inner

    def apply(self, variables, x, train=False, rngs=None):
        del train, rngs
        return self._inner.apply(variables, x, train=False)


def _epoch_perms(key, size, local_ep):
    """fl/client.make_local_train's shuffle, replayed from the agent's key."""
    perms = []
    for ep_key in jax.random.split(key, local_ep):
        shuffle_key, _ = jax.random.split(ep_key)
        r = jax.random.uniform(shuffle_key, (N_TOTAL,))
        r = jnp.where(jnp.arange(N_TOTAL) < size, r, 2.0)
        perms.append(torch.from_numpy(np.array(jnp.argsort(r))).long())
    return perms


@pytest.fixture(scope="module")
def setup():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    rng = np.random.default_rng(43)
    xs = rng.uniform(0, 255, size=(len(SIZES), N_TOTAL) + SHAPE).astype(
        np.float32)
    ys = rng.integers(0, 10, size=(len(SIZES), N_TOTAL)).astype(np.int32)
    shapes = jax.eval_shape(JaxCNN().init, jax.random.PRNGKey(0),
                            jnp.zeros((1,) + SHAPE))["params"]
    flax_params = {mod: {name: (rng.normal(size=leaf.shape) / np.sqrt(
        np.prod(leaf.shape[:-1]) if name == "kernel" else 10.0)).astype(
            np.float32) for name, leaf in leaves.items()}
        for mod, leaves in shapes.items()}
    # straggler_rate > 0: JAX's local_train takes the budget as a sixth
    # argument
    jcfg = JaxConfig(**KW, straggler_rate=0.5)
    lt = jax.jit(jax_make_local_train(_NoDropout(JaxCNN()), jcfg,
                                      jax_make_normalizer(MEAN, STD, False)))
    keys = [jax.random.fold_in(jax.random.PRNGKey(8), s)
            for s in range(len(SAMPLED))]
    ups, losses = [], []
    for s, a in enumerate(SAMPLED):
        u, loss = lt(flax_params, jnp.asarray(xs[a]), jnp.asarray(ys[a]),
                     jnp.int32(SIZES[a]), keys[s], jnp.int32(BUDGETS[s]))
        ups.append(np.concatenate([
            v.numpy().ravel() for v in carrier.params_from_flax(
                jax.tree_util.tree_map(np.asarray, u), "cpu").values()]))
        losses.append(float(loss))
    perms = [_epoch_perms(keys[s], SIZES[a], jcfg.local_ep)
             for s, a in enumerate(SAMPLED)]
    yield dict(xs=torch.from_numpy(xs), ys=torch.from_numpy(ys).long(),
               flax_params=flax_params, perms=perms, jax_updates=ups,
               jax_losses=np.asarray(losses))
    torch.set_num_threads(old)


def _rows(stacked):
    return np.concatenate([v.reshape(v.shape[0], -1).numpy()
                           for v in stacked.values()], axis=1)


def _close(ours, ref, what):
    """tests/test_torch_batched.py's tolerance: 1e-4 of the update's scale
    per coordinate, 1e-5 relative L2."""
    scale = np.abs(ref).max()
    assert scale > 1e-3, what                # the agent actually trained
    np.testing.assert_allclose(ours, ref, atol=1e-4 * scale, rtol=0,
                               err_msg=what)
    assert np.linalg.norm(ours - ref) / np.linalg.norm(ref) < 1e-5, what


def test_straggler_lane_matches_jax(setup):
    """The batched trainer with ep_budget, vmap and megabatch layouts,
    whole and in chunks of 2, and the per-agent oracle with its int
    budget, against JAX's six-argument local_train per agent; a budget of
    local_ep everywhere is the trainer without a budget, bit for bit."""
    params = carrier.params_from_flax(setup["flax_params"], "cpu")
    model = registry.get_model("fmnist", SHAPE)
    norm = common.make_normalizer(MEAN, STD, "cpu")
    budget = torch.tensor(BUDGETS, dtype=torch.int32)
    for layout in ("vmap", "megabatch"):
        for chunk in (0, 2):
            cfg = Config(**KW, train_layout=layout, agent_chunk=chunk,
                         straggler_rate=0.5)
            tr = rounds.make_block_trainer(cfg, model, norm, setup["xs"],
                                           setup["ys"], np.asarray(SIZES))
            draws = tr.draw(rounds.RoundRNG(0, "cpu"), 1, SAMPLED, 0,
                            len(SAMPLED), setup["perms"], dropout=False)
            updates, losses = tr.run(params, *draws, ep_budget=budget)
            ours = _rows(updates)
            for s, a in enumerate(SAMPLED):
                _close(ours[s], setup["jax_updates"][s],
                       f"{layout} chunk={chunk} agent {a}")
            # an epoch past the budget has loss 0 and enters the mean
            np.testing.assert_allclose(losses.numpy(), setup["jax_losses"],
                                       rtol=1e-5)
            full = torch.full((len(SAMPLED),), 2, dtype=torch.int32)
            u_full, l_full = tr.run(params, *draws, ep_budget=full)
            u_none, l_none = tr.run(params, *draws)
            assert torch.equal(l_full, l_none)
            for k in u_none:
                assert torch.equal(u_full[k], u_none[k]), (layout, chunk, k)
    oracle = client.make_local_train(model, Config(**KW), norm)
    for s, a in enumerate(SAMPLED):
        up, loss = oracle(params, setup["xs"][a], setup["ys"][a], SIZES[a],
                          setup["perms"][s], None, BUDGETS[s])
        _close(np.concatenate([v.numpy().ravel() for v in up.values()]),
               setup["jax_updates"][s], f"oracle agent {a}")
        np.testing.assert_allclose(float(loss), setup["jax_losses"][s],
                                   rtol=1e-5)


def test_faults_config_and_the_dense_round(setup):
    """A config with every fault knob set but every rate 0 is not a faults
    run: its eager dense round equals the default config's bit for bit.
    A faults round whose draw leaves everyone in (a norm cap far above the
    updates) equals the dense plain round (--no_fused) bit for bit under
    every rule, the masked twins under an all-ones mask; a chained block
    carries the fault lanes; the host-sampled round draws the faults the
    device-resident round draws and lands on its params; an injected
    draw's stragglers reach the trainer; and a --quarantine round equals
    the round whose injected draw drops the quarantined slots, bit for
    bit (tests/test_torch_monitor.py runs it chained through the CLI)."""
    model = registry.get_model("fmnist", SHAPE)
    norm = common.make_normalizer(MEAN, STD, "cpu")
    params0 = carrier.params_from_flax(setup["flax_params"], "cpu")
    base = Config(**KW, num_corrupt=1, robustLR_threshold=2)

    def one_round(cfg, **kw):
        round_fn = rounds.make_round_fn(cfg, model, norm, setup["xs"],
                                        setup["ys"], np.asarray(SIZES))
        assert round_fn.graph is None               # eager on the CPU
        return round_fn(params0, rounds.RoundRNG(1, "cpu"), SAMPLED,
                        setup["perms"], dropout=False, **kw)

    knobs = dict(straggler_epochs=2, corrupt_mode="huge",
                 faults_spare_corrupt=True, rlr_threshold_mode="scaled")
    zero = base.replace(**knobs)
    assert not zero.faults_enabled
    want_p, want_i = one_round(base)
    got_p, got_i = one_round(zero)
    assert set(got_i) == set(want_i)
    assert not any(k.startswith("fault_") for k in got_i)
    for k in want_p:
        assert torch.equal(got_p[k], want_p[k]), k

    for aggr in ("avg", "comed", "sign", "trmean", "krum", "rfa"):
        plain = base.replace(aggr=aggr, use_fused=False)
        faults = plain.replace(payload_norm_cap=1e9, **knobs)
        assert faults.faults_enabled and not rounds._fused_applicable(faults)
        want_p, want_i = one_round(plain)
        got_p, got_i = one_round(faults)
        assert float(got_i["fault_voters"]) == len(SAMPLED), aggr
        assert float(got_i["fault_dropped"]) == 0.0, aggr
        assert torch.equal(got_i["hlth_update_normsq"],
                           want_i["hlth_update_normsq"]), aggr
        for k in want_p:
            assert torch.equal(got_p[k], want_p[k]), (aggr, k)

    # the chained block carries the fault lanes beside train_loss
    cfg = base.replace(dropout_rate=0.5, aggr="comed")
    chained = rounds.make_chained(rounds.make_round_fn(
        cfg, model, norm, setup["xs"], setup["ys"], np.asarray(SIZES)))
    _, info = chained(params0, rounds.RoundRNG(2, "cpu"), 2)
    for k in rounds.FAULT_INFO_KEYS:
        assert info[k].shape == (2,), k
    assert (info["fault_voters"] >= 1).all()
    assert torch.equal(info["fault_voters"] + info["fault_dropped"],
                       torch.full((2,), float(len(SAMPLED))))

    # the host-sampled round draws the same faults for the same ids and
    # round as the device-resident one, and gives the same params (the
    # tolerance of tests/test_torch_host.py: the same kernels on the same
    # rows)
    cfg = base.replace(aggr="comed", dropout_rate=0.5, straggler_rate=0.5,
                       corrupt_rate=0.3, faults_spare_corrupt=True)
    dense = rounds.make_round_fn(cfg, model, norm, setup["xs"], setup["ys"],
                                 np.asarray(SIZES))
    host = rounds.make_round_fn_host(cfg, model, norm, np.asarray(SIZES),
                                     N_TOTAL, "cpu")
    p_dense, i_dense = dense(params0, rounds.RoundRNG(4, "cpu"), SAMPLED)
    p_host, i_host = host(params0, rounds.RoundRNG(4, "cpu"), SAMPLED,
                          setup["xs"][SAMPLED], setup["ys"][SAMPLED],
                          torch.tensor(SIZES)[SAMPLED])
    for k in rounds.FAULT_INFO_KEYS:
        assert torch.equal(i_host[k], i_dense[k]), k
    flat = [torch.cat([p[k].reshape(-1) for k in p]) for p in (p_host,
                                                                p_dense)]
    scale = float((flat[1] - torch.cat([params0[k].reshape(-1)
                                        for k in params0])).abs().max())
    assert scale > 1e-4
    np.testing.assert_allclose(flat[0].numpy(), flat[1].numpy(), rtol=0,
                               atol=1e-6 * scale)

    # an injected draw: slots 1 and 2 straggle, one epoch each
    cfg = base.replace(straggler_rate=0.5, use_fused=False)
    draw = fmodel.FaultDraw(torch.ones(4, dtype=torch.bool),
                            torch.tensor([False, True, True, False]),
                            torch.tensor(BUDGETS, dtype=torch.int32),
                            torch.zeros(4, dtype=torch.bool))
    p_strag, i_strag = one_round(cfg, faults=draw)
    p_full, _ = one_round(cfg.replace(straggler_rate=0.0))
    assert float(i_strag["fault_straggled"]) == 2.0
    assert any(not torch.equal(p_strag[k], p_full[k]) for k in p_full)

    # --quarantine 0,3: sampled ids 0 and 3 sit in slots 1 and 2; the mask
    # is built in the round from the sampled ids on the device
    quar = base.replace(aggr="comed", quarantine="0,3")
    assert not quar.faults_enabled and not rounds._fused_applicable(quar)
    p_quar, i_quar = one_round(quar)
    assert not any(k.startswith("fault_") for k in i_quar)
    keep = torch.tensor([True, False, False, True])
    drop = fmodel.FaultDraw(keep, torch.zeros(4, dtype=torch.bool),
                            torch.full((4,), 2, dtype=torch.int32),
                            torch.zeros(4, dtype=torch.bool))
    p_drop, i_drop = one_round(base.replace(aggr="comed", dropout_rate=0.5),
                               faults=drop)
    assert float(i_drop["fault_voters"]) == 2.0
    p_plain, _ = one_round(base.replace(aggr="comed"))
    assert any(not torch.equal(p_quar[k], p_plain[k]) for k in p_plain)
    for k in p_drop:
        assert torch.equal(p_quar[k], p_drop[k]), k
    for k in ("hlth_nonfinite", "hlth_update_normsq", "hlth_agent_bad"):
        assert torch.equal(i_quar[k], i_drop[k]), k
