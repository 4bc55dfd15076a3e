"""The port's local training (fl/client.py) and its full round
(fl/rounds.py) against the JAX package's, on identical inputs.

Controlled variables, as in tests/test_reference_parity.py: the same
initial weights (a Flax init carried across by models/carrier.py), the
same epoch permutations (replayed from the JAX client's PRNG calls and
injected into the port), the same sampled agent ids (injected), and dropout
off on both sides. Uneven shards of 96/80/65/33 samples at bs 32 cover full,
partial and fully padded batches. CNN_MNIST runs at 14x14 inputs: the same
ops as at 28x28, at a quarter of the CPU time.

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
from defending_against_backdoors_with_robust_learning_rate_tpu.ops import (
    aggregate as jax_aggregate)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    client, common, rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    carrier, registry)

SHAPE = (14, 14, 1)
BS, N_TOTAL = 32, 96
SIZES = [96, 80, 65, 33]    # full / partial / partial / fully padded batches
SAMPLED = [2, 0, 3, 1]      # slot order differs from agent order
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
    """fl/client.make_local_train's shuffle, replayed: per epoch, split ->
    uniform -> padding pushed to the back -> argsort."""
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
    torch.set_num_threads(2)
    rng = np.random.default_rng(42)
    xs = rng.uniform(0, 255, size=(len(SIZES), N_TOTAL) + SHAPE).astype(
        np.float32)
    ys = rng.integers(0, 10, size=(len(SIZES), N_TOTAL)).astype(np.int32)
    # random Flax-layout weights (an abstract init gives the shapes without
    # compiling Flax's initializers)
    shapes = jax.eval_shape(JaxCNN().init, jax.random.PRNGKey(0),
                            jnp.zeros((1,) + SHAPE))["params"]
    flax_params = {mod: {name: (rng.normal(size=leaf.shape) / np.sqrt(
        np.prod(leaf.shape[:-1]) if name == "kernel" else 10.0)).astype(
            np.float32) for name, leaf in leaves.items()}
        for mod, leaves in shapes.items()}
    jcfg = JaxConfig(**KW)
    lt = jax.jit(jax_make_local_train(_NoDropout(JaxCNN()), jcfg,
                                      jax_make_normalizer(MEAN, STD, False)))
    keys = [jax.random.fold_in(jax.random.PRNGKey(7), s)
            for s in range(len(SAMPLED))]
    jax_updates, jax_losses, perms = [], [], []
    for slot, a in enumerate(SAMPLED):
        up, loss = lt(flax_params, jnp.asarray(xs[a]), jnp.asarray(ys[a]),
                      jnp.int32(SIZES[a]), keys[slot])
        jax_updates.append(jax.tree_util.tree_map(np.asarray, up))
        jax_losses.append(float(loss))
        perms.append(_epoch_perms(keys[slot], SIZES[a], jcfg.local_ep))
    yield dict(xs=xs, ys=ys, flax_params=flax_params,
               jax_updates=jax_updates, jax_losses=jax_losses, perms=perms)
    torch.set_num_threads(old)


def _flat(params):
    return np.concatenate([v.detach().numpy().ravel()
                           for v in params.values()])


def test_local_train_updates_match_jax(setup):
    cfg = Config(**KW)
    model = registry.get_model("fmnist", SHAPE)
    lt = client.make_local_train(model, cfg,
                                 common.make_normalizer(MEAN, STD, "cpu"))
    params = carrier.params_from_flax(setup["flax_params"], "cpu")
    for slot, a in enumerate(SAMPLED):
        up, loss = lt(params, torch.from_numpy(setup["xs"][a]),
                      torch.from_numpy(setup["ys"][a]).long(), SIZES[a],
                      setup["perms"][slot])
        ours = _flat(up)
        ref = _flat(carrier.params_from_flax(setup["jax_updates"][slot],
                                            "cpu"))
        scale = np.abs(ref).max()
        assert scale > 1e-3                 # the agent actually trained
        # f32 on both sides, other conv/matmul summation orders: every
        # coordinate within 1e-4 of the update's scale, and 1e-5 in
        # relative L2
        np.testing.assert_allclose(ours, ref, atol=1e-4 * scale, rtol=0,
                                   err_msg=f"agent {a}")
        assert np.linalg.norm(ours - ref) / np.linalg.norm(ref) < 1e-5
        # sample-weighted epoch loss: 1e-5 relative
        np.testing.assert_allclose(float(loss), setup["jax_losses"][slot],
                                   rtol=1e-5)


def test_full_round_matches_jax(setup):
    """One round through the port's round fn (sampled ids and permutations
    injected) vs the JAX client updates + JAX server step, for
    aggr in {avg, sign} x RLR on/off through the fused server step, and
    with RLR on through the ops/aggregate.py server step too."""
    xs = torch.from_numpy(setup["xs"])
    ys = torch.from_numpy(setup["ys"]).long()
    sizes = np.asarray(SIZES, np.int32)
    model = registry.get_model("fmnist", SHAPE)
    norm = common.make_normalizer(MEAN, STD, "cpu")
    params = carrier.params_from_flax(setup["flax_params"], "cpu")
    stacked = jax.tree_util.tree_map(lambda *u: jnp.stack(u),
                                     *setup["jax_updates"])
    szs = jnp.asarray(sizes[SAMPLED])
    for aggr in ("avg", "sign"):
        for thr in (0, 3):
            jcfg = JaxConfig(**KW, aggr=aggr, robustLR_threshold=thr,
                             server_lr=0.5)
            slr = jcfg.effective_server_lr
            lr = (jax_aggregate.robust_lr(stacked, float(thr), slr) if thr
                  else slr)
            agg = jax_aggregate.aggregate_updates(stacked, szs, jcfg, None)
            want = _flat(carrier.params_from_flax(
                jax_aggregate.apply_aggregate(setup["flax_params"], lr, agg),
                "cpu"))
            # the fallback server step once per rule, with the vote on
            for fused in (True, False) if thr else (True,):
                cfg = Config(**KW, aggr=aggr, robustLR_threshold=thr,
                             server_lr=0.5, use_fused=fused)
                assert rounds._fused_applicable(cfg) == fused
                round_fn = rounds.make_round_fn(cfg, model, norm, xs, ys,
                                                sizes)
                new, info = round_fn(params, rounds.RoundRNG(0, "cpu"),
                                     sampled=SAMPLED, perms=setup["perms"],
                                     dropout=False)
                assert info["sampled"] == SAMPLED
                got = _flat(new)
                what = f"aggr={aggr} thr={thr} fused={fused}"
                if aggr == "avg" and not thr:
                    # bounded by the client-side f32 drift above
                    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                               err_msg=what)
                else:
                    # a sign or a vote can flip where an agent's update sits
                    # within that drift of 0: all but 1e-4 of the
                    # coordinates agree to 1e-5, the rest by one lr step
                    close = np.isclose(got, want, atol=1e-5, rtol=0)
                    assert close.mean() > 1 - 1e-4, what
                    assert np.abs(got - want).max() <= 2 * slr + 1e-5, what
                # train loss: 1e-5 relative
                np.testing.assert_allclose(
                    float(info["train_loss"]),
                    np.mean(setup["jax_losses"]), rtol=1e-5, err_msg=what)
