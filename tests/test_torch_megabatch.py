"""The port's batched local training, megabatch layout (fl/client.
make_local_train_batched with the client axis folded into the batch,
through fl/rounds.BlockTrainer), against JAX's `make_local_train_megabatch`
(`--train_layout megabatch`) per agent; and `fl/common.masked_ce_segments`
against JAX's.

Controlled variables as in tests/test_torch_round.py: a Flax init carried
across by models/carrier.py, the epoch permutations replayed from the JAX
keys and injected, the sampled ids injected, dropout off. Uneven shards of
96/80/65/33 samples at bs 32 cover full, partial and fully padded batches
(in the batched trainer the padded ones are masked no-ops, as in JAX).
CNN_MNIST at 14x14 inputs.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu.config import (
    Config as JaxConfig)
from defending_against_backdoors_with_robust_learning_rate_tpu.fl import (
    common as jax_common)
from defending_against_backdoors_with_robust_learning_rate_tpu.fl.client import (
    make_local_train_megabatch as jax_make_local_train_megabatch)
from defending_against_backdoors_with_robust_learning_rate_tpu.models.cnn import (
    CNN_MNIST as JaxCNN)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    common, rounds)
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
    """fl/client.make_local_train_megabatch's shuffle (the vmap layout's),
    replayed from the agent's key:
    per epoch, split -> uniform -> padding pushed back -> argsort."""
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
    shapes = jax.eval_shape(JaxCNN().init, jax.random.PRNGKey(0),
                            jnp.zeros((1,) + SHAPE))["params"]
    flax_params = {mod: {name: (rng.normal(size=leaf.shape) / np.sqrt(
        np.prod(leaf.shape[:-1]) if name == "kernel" else 10.0)).astype(
            np.float32) for name, leaf in leaves.items()}
        for mod, leaves in shapes.items()}
    jcfg = JaxConfig(**KW)
    mb_train = jax_make_local_train_megabatch(
        _NoDropout(JaxCNN()), jcfg,
        jax_common.make_normalizer(MEAN, STD, False))
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(7), s)
                      for s in range(len(SAMPLED))])
    sizes = np.asarray(SIZES, np.int32)
    ups, losses = jax.jit(mb_train)(flax_params, jnp.asarray(xs[SAMPLED]),
                                    jnp.asarray(ys[SAMPLED]),
                                    jnp.asarray(sizes[SAMPLED]), keys)
    perms = [_epoch_perms(keys[s], SIZES[a], jcfg.local_ep)
             for s, a in enumerate(SAMPLED)]
    yield dict(xs=torch.from_numpy(xs), ys=torch.from_numpy(ys).long(),
               flax_params=flax_params, perms=perms,
               jax_updates=jax.tree_util.tree_map(np.asarray, ups),
               jax_losses=np.asarray(losses))
    torch.set_num_threads(old)


def _trainer(setup, **kw):
    cfg = Config(**KW, **kw)
    return rounds.make_block_trainer(
        cfg, registry.get_model("fmnist", SHAPE),
        common.make_normalizer(MEAN, STD, "cpu"), setup["xs"], setup["ys"],
        np.asarray(SIZES))


def _rows(stacked):
    """[m, n_params] from a stacked torch update dict."""
    return np.concatenate([v.reshape(v.shape[0], -1).numpy()
                           for v in stacked.values()], axis=1)


def test_megabatch_layout_matches_jax(setup):
    train_block = _trainer(setup, train_layout="megabatch")
    assert train_block.layout == "megabatch"
    params = carrier.params_from_flax(setup["flax_params"], "cpu")
    updates, losses = train_block(params, rounds.RoundRNG(0, "cpu"), 1,
                                  SAMPLED, 0, len(SAMPLED), setup["perms"],
                                  dropout=False)
    ours = _rows(updates)
    for slot, a in enumerate(SAMPLED):
        ref = np.concatenate([v.numpy().ravel() for v in
                              carrier.params_from_flax(jax.tree_util.tree_map(
                                  lambda u, s=slot: u[s],
                                  setup["jax_updates"]), "cpu").values()])
        scale = np.abs(ref).max()
        assert scale > 1e-3                 # the agent actually trained
        # f32 on both sides, other conv/matmul summation orders: every
        # coordinate within 1e-4 of the update's scale, 1e-5 relative L2
        np.testing.assert_allclose(ours[slot], ref, atol=1e-4 * scale, rtol=0,
                                   err_msg=f"agent {a}")
        assert np.linalg.norm(ours[slot] - ref) / np.linalg.norm(ref) < 1e-5
    # sample-weighted epoch losses: 1e-5 relative
    np.testing.assert_allclose(losses.numpy(), setup["jax_losses"],
                               rtol=1e-5)


def test_masked_ce_segments_matches_jax():
    """The loss-side fold over [m*bs] logits with [m, bs] step masks: a
    full, a partial and an all-masked segment; JAX's
    tests/test_megabatch.py holds its own fold to rtol 1e-6."""
    rng = np.random.default_rng(11)
    m, bs, classes = 3, 8, 10
    logits = rng.normal(size=(m * bs, classes)).astype(np.float32) * 3
    labels = rng.integers(0, classes, size=(m * bs,))
    weights = np.ones((m, bs), bool)
    weights[1, 5:] = False
    weights[2, :] = False
    want = jax_common.masked_ce_segments(
        jnp.asarray(logits), jnp.asarray(labels, jnp.int32),
        jnp.asarray(weights.reshape(-1)), m)
    got = common.masked_ce_segments(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(weights.reshape(-1)), m)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    assert float(got[1][2]) == 0.0 and float(got[2][2]) == 0.0
    # each segment is masked_ce of its own rows
    for i in range(m):
        one = common.masked_ce(torch.from_numpy(logits[i * bs:(i + 1) * bs]),
                               torch.from_numpy(labels[i * bs:(i + 1) * bs]),
                               torch.from_numpy(weights[i]))
        np.testing.assert_allclose(float(got[1][i]), float(one), rtol=1e-6)
