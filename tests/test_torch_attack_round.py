"""The port's attacked round (fl/rounds.py with attack/registry.py) against
the JAX package's `_round_core`, and its round schedule across a chained
block.

(a) one FMNIST-shaped round (CNN_MNIST at 14x14, m = 4 of K = 4, bs 16,
two corrupt agents, dropout off, the sampled ids and each slot's epoch
permutations injected from JAX's draws) under `--attack boost
--attack_boost 8` and under `--attack signflip`, each with RLR threshold
2, against JAX `_round_core` under a plain `jax.jit`: the port's server
step through K1's plain version (the fused step, which stays on under an
update attack) and through `--no_fused`, at tests/test_torch_round.py's
tolerances. (b) the chained round under the one-shot and the intermittent
schedules against per-round calls that apply the attack exactly where
JAX's `schedule.active` says, round by round and bit for bit; and the
host-sampled round's refusal of a scheduled attack, with JAX's text.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu.attack import (
    schedule as jax_schedule)
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
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    common, rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    carrier, registry)

SHAPE = (14, 14, 1)
BS, N_TOTAL = 16, 48
SIZES = [48, 40, 33, 17]    # full / partial / partial / fully padded batches
SAMPLED = [2, 0, 3, 1]      # corrupt ids 0 and 1 sit in slots 1 and 3
MEAN, STD = (0.5,), (0.5,)
KW = dict(data="fmnist", num_agents=4, bs=BS, local_ep=2, client_lr=0.1,
          client_moment=0.9, num_corrupt=2, robustLR_threshold=2)
ATTACKS = {"boost8": dict(attack="boost", attack_boost=8.0),
           "signflip": dict(attack="signflip")}


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
    return np.concatenate([np.asarray(v.detach()).ravel()
                           for v in params.values()])


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _data(seed=42):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0, 255, size=(len(SIZES), N_TOTAL) + SHAPE).astype(
        np.float32)
    ys = rng.integers(0, 10, size=(len(SIZES), N_TOTAL)).astype(np.int32)
    shapes = jax.eval_shape(JaxCNN().init, jax.random.PRNGKey(0),
                            jnp.zeros((1,) + SHAPE))["params"]
    flax_params = {mod: {name: (rng.normal(size=leaf.shape) / np.sqrt(
        np.prod(leaf.shape[:-1]) if name == "kernel" else 10.0)).astype(
            np.float32) for name, leaf in leaves.items()}
        for mod, leaves in shapes.items()}
    return xs, ys, flax_params


def test_attacked_round_matches_jax():
    xs, ys, flax_params = _data()
    sizes = np.asarray(SIZES, np.int32)
    flags = np.asarray(SAMPLED) < KW["num_corrupt"]
    k_train, k_noise = jax.random.split(jax.random.PRNGKey(9))
    agent_keys = jax.random.split(k_train, len(SAMPLED))
    perms = [_epoch_perms(agent_keys[s], SIZES[a], KW["local_ep"])
             for s, a in enumerate(SAMPLED)]
    model = registry.get_model("fmnist", SHAPE)
    norm = common.make_normalizer(MEAN, STD, "cpu")
    params = carrier.params_from_flax(flax_params, "cpu")
    start = _flat(params)
    tx, ty = torch.from_numpy(xs), torch.from_numpy(ys).long()
    clean = None
    for label, atk in ATTACKS.items():
        jcfg = JaxConfig(**KW, **atk)
        core = jax.jit(functools.partial(
            jax_rounds._round_core,
            train_block=jax_rounds.make_block_trainer(
                _NoDropout(JaxCNN()), jcfg,
                jax_make_normalizer(MEAN, STD, False)),
            cfg=jcfg))
        j_new, j_loss, j_extras = core(
            flax_params, k_train, k_noise, jnp.asarray(xs[SAMPLED]),
            jnp.asarray(ys[SAMPLED]), jnp.asarray(sizes[SAMPLED]),
            corrupt_flags=jnp.asarray(flags))
        want = _flat(carrier.params_from_flax(
            jax.tree_util.tree_map(np.asarray, j_new), "cpu"))
        slr = jcfg.effective_server_lr
        for fused in (True, False):
            cfg = Config(**KW, **atk, use_fused=fused, device="cpu")
            # K1 stays on under an update attack (fl/rounds._fused_applicable)
            assert rounds._fused_applicable(cfg) == fused
            round_fn = rounds.make_round_fn(cfg, model, norm, tx, ty, sizes)
            new, info = round_fn(params, rounds.RoundRNG(0, "cpu"),
                                 sampled=SAMPLED, perms=perms, dropout=False)
            got = _flat(new)
            what = f"{label} fused={fused}"
            # test_torch_round.py's vote tolerance: a vote can flip where
            # an agent's update sits within the client-side f32 drift of
            # 0, so all but 1e-4 of the coordinates agree to 1e-5 and the
            # rest by one lr step
            close = np.isclose(got, want, atol=1e-5, rtol=0)
            assert close.mean() > 1 - 1e-4, what
            assert np.abs(got - want).max() <= 2 * slr + 1e-5, what
            # train loss (before the attack): 1e-5 relative
            np.testing.assert_allclose(float(info["train_loss"]),
                                       float(j_loss), rtol=1e-5,
                                       err_msg=what)
            # the update norm of the attacked stack: 1e-5 relative
            np.testing.assert_allclose(
                float(info["hlth_update_normsq"]),
                float(j_extras["hlth_update_normsq"]), rtol=1e-5,
                err_msg=what)
            if clean is None:
                c = cfg.replace(attack="static", attack_boost=1.0)
                clean = rounds.make_round_fn(c, model, norm, tx, ty, sizes)(
                    params, rounds.RoundRNG(0, "cpu"), sampled=SAMPLED,
                    perms=perms, dropout=False)
            # the attack is live: the round moved away from the clean one
            gap = np.abs(got - _flat(clean[0])).max()
            assert gap > 100 * 1e-5, what
            # boost grows the corrupt rows' norms 8x; the anti-vote keeps
            # every norm and flips the rows' signs
            normsq, clean_normsq = (float(info["hlth_update_normsq"]),
                                    float(clean[1]["hlth_update_normsq"]))
            if cfg.attack == "boost":
                assert normsq > 4 * clean_normsq, what
            else:
                assert normsq == pytest.approx(clean_normsq, rel=1e-6), what
        assert np.abs(got - start).max() > 1e-3


def test_schedule_across_chained_rounds():
    xs, ys, _ = _data(7)
    sizes = np.asarray(SIZES, np.int32)
    tx, ty = torch.from_numpy(xs), torch.from_numpy(ys).long()
    model = registry.get_model("fmnist", SHAPE)
    norm = common.make_normalizer(MEAN, STD, "cpu")
    params = registry.init_params(model, 3, "cpu")
    n = 5
    cases = {
        # the one-shot model replacement of round 2, K1 in the round
        "oneshot": dict(attack="boost", attack_boost=8.0, attack_start=2,
                        attack_stop=3),
        # the low-duty-cycle anti-vote, with the full telemetry's lanes
        "intermittent": dict(attack="signflip", attack_start=1,
                             attack_every=2, telemetry="full"),
    }
    for label, atk in cases.items():
        cfg = Config(**KW, **atk, device="cpu")
        jcfg = JaxConfig(**{k: v for k, v in {**KW, **atk}.items()})
        gates = [bool(jax_schedule.active(jcfg, r)) for r in range(1, n + 1)]
        assert any(gates) and not all(gates), label
        chained = rounds.make_chained(rounds.make_round_fn(
            cfg, model, norm, tx, ty, sizes))
        p_chain, i_chain = chained(params, rounds.RoundRNG(5, "cpu"), n)
        # per-round calls: the always-on attack where JAX's gate is on,
        # the static (unattacked) round elsewhere, on one shared RNG
        always = rounds.make_round_fn(
            cfg.replace(attack_start=0, attack_stop=0, attack_every=1),
            model, norm, tx, ty, sizes)
        static = rounds.make_round_fn(cfg.replace(attack="static"), model,
                                      norm, tx, ty, sizes)
        rng, p = rounds.RoundRNG(5, "cpu"), params
        lanes = []
        for r, on in enumerate(gates, start=1):
            p, info = (always if on else static)(p, rng)
            assert info["sampled"] == i_chain["sampled"][r - 1], label
            lanes.append(info)
        for k, v in p.items():
            assert torch.equal(p_chain[k], v), (label, k)
        keys = [k for k in i_chain if k != "sampled"]
        assert "hlth_update_normsq" in keys
        if cfg.telemetry == "full":
            assert {"tel_cos_corrupt", "tel_margin_hist",
                    "tel_flip_frac"} <= set(keys)
        for k in keys:
            assert i_chain[k].shape[0] == n, (label, k)
            for r in range(n):
                assert torch.equal(i_chain[k][r], lanes[r][k]), (label, k, r)
        # against an unattacked chained run on the same draws: the rounds
        # before the first active one are equal, that one is not
        _, i_static = rounds.make_chained(static)(
            params, rounds.RoundRNG(5, "cpu"), n)
        # (the update norm shows boost; the vote margins show the anti-vote,
        # which keeps every norm)
        lane = ("hlth_update_normsq" if cfg.attack == "boost"
                else "tel_margin_mean")
        first = gates.index(True)
        for r in range(first + 1):
            same = torch.equal(i_chain[lane][r], i_static[lane][r])
            assert same == (r < first), (label, r)

    # the host-sampled round refuses a scheduled attack, with JAX's text
    for atk in (dict(attack="boost", attack_start=2),
                dict(attack="signflip", attack_every=3)):
        with pytest.raises(ValueError) as want:
            jax_rounds.make_host_step(JaxConfig(**atk), None, None)
        with pytest.raises(ValueError) as got:
            rounds.make_round_fn_host(Config(**atk), None, None, [1, 2], 8,
                                      "cpu")
        assert str(got.value) == str(want.value)
        assert "host-sampled mode" in str(got.value)
