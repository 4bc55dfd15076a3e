"""The boosted attacker against the RLR vote over a trajectory of rounds, in
the port and in the JAX package, on the FMNIST stand-in.

The configuration of `chip_smoke.py`'s phase attack run "boost8": FMNIST
stand-in (uint8 pixels), CNN_MNIST at full width (28x28), K = 10 agents
all sampled each round, one corrupt agent with poison_frac 0.5, `--attack
boost --attack_boost 8`, RLR threshold 4, bs 256, local_ep 2, client lr
0.1 with momentum 0.9; cut to 3,000 training samples (300 an agent), a
1,000-sample val set and 2 rounds, with dropout off. Each round's ids come
from `train.sample_ids` and each slot's epoch permutations from JAX's
keys, injected into both packages. JAX's `_round_core` under a plain
`jax.jit` drives its own trajectory; the port runs (a) its round from
JAX's params of the same round, and (b) its own free-running trajectory.
Both packages' params are scored with the port's eval.

Held, with these tolerances:
- (a) each round's step (new params - params) within 5e-3 relative L2 of
  JAX's (f32 drift in 4 SGD steps from a random start: 1.7e-3 measured in
  round 1, 6.5e-4 in round 2), and the same val and poison accuracy within
  0.01;
- (b) the free-running trajectory's val and poison accuracy within 0.05 of
  JAX's, round by round;
- the outcome: JAX's own trajectory lets the boosted backdoor through
  RLR 4 (poison accuracy >= 0.8 in some round), and so does the port's:
  on this stand-in the vote does not stop one 8x-boosted attacker of 10,
  in the reference as in the port.

Run with `-s` to print both trajectories.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu.config import (
    Config as JaxConfig)
from defending_against_backdoors_with_robust_learning_rate_tpu.fl import (
    rounds as jax_rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu.fl.common import (
    make_normalizer as jax_make_normalizer)
from defending_against_backdoors_with_robust_learning_rate_tpu.models.cnn import (
    CNN_MNIST as JaxCNN)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data.registry import (
    get_federated_data)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    common, rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl.evaluate import (
    make_eval_fn, pad_eval_set)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    carrier, registry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.train import (
    sample_ids)

ROUNDS = 2
KW = dict(data="fmnist", num_agents=10, agent_frac=1.0, local_ep=2, bs=256,
          client_lr=0.1, client_moment=0.9, aggr="avg", pattern_type="plus",
          base_class=5, target_class=7, synth_train_size=3000,
          synth_val_size=1000, num_corrupt=1, poison_frac=0.5,
          robustLR_threshold=4, attack="boost", attack_boost=8.0, seed=0,
          data_dir="/nonexistent-data-dir")


class _NoDropout:
    """A Flax module whose train-mode forward runs without dropout."""

    def __init__(self, inner):
        self._inner = inner

    def apply(self, variables, x, train=False, rngs=None):
        del train, rngs
        return self._inner.apply(variables, x, train=False)


def _epoch_perms(key, size, max_n, local_ep):
    """fl/client.make_local_train's shuffle, replayed from the agent's key:
    per epoch, split -> uniform -> padding pushed back -> argsort."""
    perms = []
    for ep_key in jax.random.split(key, local_ep):
        shuffle_key, _ = jax.random.split(ep_key)
        r = jax.random.uniform(shuffle_key, (max_n,))
        r = jnp.where(jnp.arange(max_n) < size, r, 2.0)
        perms.append(torch.from_numpy(np.array(jnp.argsort(r))).long())
    return perms


def _flat(params):
    return np.concatenate([np.asarray(v.detach()).ravel()
                           for v in params.values()])


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_boosted_rlr_trajectory_matches_jax():
    cfg, jcfg = Config(**KW, device="cpu"), JaxConfig(**KW)
    fed = get_federated_data(cfg)
    imgs, sizes = fed.train.images, fed.train.sizes
    lbls = fed.train.labels.astype(np.int32)
    max_n = lbls.shape[1]
    model = registry.get_model("fmnist", imgs.shape[2:])
    norm = common.make_normalizer(fed.mean, fed.std, "cpu")
    eval_fn = make_eval_fn(model, norm, cfg.n_classes)
    sets = [tuple(torch.from_numpy(a) for a in pad_eval_set(x, y, 500))
            for x, y in ((fed.val_images, fed.val_labels),
                         (fed.pval_images, fed.pval_labels))]

    def accs(p):
        return tuple(float(eval_fn(p, *s)[1]) for s in sets)

    core = jax.jit(functools.partial(
        jax_rounds._round_core,
        train_block=jax_rounds.make_block_trainer(
            _NoDropout(JaxCNN()), jcfg,
            jax_make_normalizer(fed.mean, fed.std, False)),
        cfg=jcfg))
    round_fn = rounds.make_round_fn(cfg, model, norm, torch.from_numpy(imgs),
                                    torch.from_numpy(lbls).long(), sizes)
    p_jax = p_free = registry.init_params(model, 0, "cpu")
    traj = {"jax": [], "port": [], "port from jax": []}
    for rnd in range(1, ROUNDS + 1):
        sampled = [int(a) for a in sample_ids(cfg, rnd)]
        assert sorted(sampled) == list(range(10))
        k_train, k_noise = jax.random.split(jax.random.PRNGKey(100 + rnd))
        perms = [_epoch_perms(key, int(sizes[a]), max_n, cfg.local_ep)
                 for key, a in zip(jax.random.split(k_train, len(sampled)),
                                   sampled)]
        j_new, _, _ = core(
            carrier.flax_from_params(p_jax), k_train, k_noise,
            jnp.asarray(imgs[sampled]), jnp.asarray(lbls[sampled]),
            jnp.asarray(sizes[sampled]),
            corrupt_flags=jnp.asarray(np.asarray(sampled) < cfg.num_corrupt))
        j_new = carrier.params_from_flax(
            jax.tree_util.tree_map(np.asarray, j_new), "cpu")
        one, _ = round_fn(p_jax, rounds.RoundRNG(0, "cpu"), sampled=sampled,
                          perms=perms, dropout=False)
        # the free-running trajectory starts where JAX's does
        p_free = one if rnd == 1 else round_fn(
            p_free, rounds.RoundRNG(0, "cpu"), sampled=sampled, perms=perms,
            dropout=False)[0]
        before = _flat(p_jax)
        want, got = _flat(j_new) - before, _flat(one) - before
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        for key, p in (("jax", j_new), ("port", p_free),
                       ("port from jax", one)):
            traj[key].append(accs(p))
        print(f"round {rnd}: step rel L2 {rel:.3e}; (val, poison) accuracy "
              + "; ".join(f"{k} ({v[-1][0]:.4f}, {v[-1][1]:.4f})"
                          for k, v in traj.items()))
        assert rel <= 5e-3, (rnd, rel)
        np.testing.assert_allclose(traj["port from jax"][-1],
                                   traj["jax"][-1], atol=0.01, rtol=0,
                                   err_msg=f"round {rnd}")
        np.testing.assert_allclose(traj["port"][-1], traj["jax"][-1],
                                   atol=0.05, rtol=0, err_msg=f"round {rnd}")
        p_jax = j_new
    # the outcome, in the reference and in the port: RLR 4 lets one
    # 8x-boosted attacker of 10 in on this stand-in
    assert max(a[1] for a in traj["jax"]) >= 0.8, traj
    assert max(a[1] for a in traj["port"]) >= 0.8, traj
