"""The port's research diagnostics (fl/diagnostics.py, the snap rounds' diag
round fn and the driver's Norms/* and Sign/* rows) against the JAX
package's.

(a) On the same numpy inputs: `clip_updates` (1e-6 relative),
`norm_scalars` and `sign_agreement` (exact: the same host numpy), and the
Fisher of CNN_MNIST at 14x14 over a padded poisoned set (2 batches of 16,
5 padding rows) in both the adversarial and the honest (relabeled to
base_class) variant: the port's Fisher carried into JAX's layout through
models/carrier.flax_from_params, every leaf within 1e-5 relative to the
leaf's largest value and the flat vectors within 1e-5 relative L2 (a
square of an f32 gradient taken in another order; 1.6e-7 measured); then
the Sign/* scalars of the port's flat vectors, in the port's order,
against JAX's on JAX's ravel of the same values carried over: the top
`top_frac` sets select the same coordinates, so the scalars agree within
1e-6 relative (norms summed in another order).

(b) One snap round under `--diagnostics` (CNN_MNIST at 14x14, m = 4 of 4,
two corrupt agents, RLR threshold 2, dropout off, ids and permutations
injected from JAX's draws, JAX's params through models/carrier): the diag
round fn runs the plain server step (`_fused_applicable` false there, true
for the plain round), and its `agent_norms` (1e-5 relative) and `lr_flat`
(carried into JAX's ravel order; all but 1e-4 of the coordinates equal,
tests/test_torch_round.py's vote tolerance) against JAX's `_round_core`
extras under a plain `jax.jit`. Then a 2-round CLI run with `--diagnostics
--snap 1 --train_layout megabatch`: JAX's layout line, and finite Norms/*
and Sign/* rows at both rounds, written before the boundary's Health/*
rows.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from defending_against_backdoors_with_robust_learning_rate_tpu.config import (
    Config as JaxConfig)
from defending_against_backdoors_with_robust_learning_rate_tpu.fl import (
    diagnostics as jax_diag, rounds as jax_rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu.fl.common import (
    make_normalizer as jax_make_normalizer)
from defending_against_backdoors_with_robust_learning_rate_tpu.models.cnn import (
    CNN_MNIST as JaxCNN)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch import (
    train)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    common, diagnostics, rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl.evaluate import (
    pad_eval_set)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    carrier, registry)

SHAPE = (14, 14, 1)
BS, N_TOTAL = 16, 48
SIZES = [48, 40, 33, 17]
SAMPLED = [2, 0, 3, 1]      # corrupt ids 0 and 1 sit in slots 1 and 3
MEAN, STD = (0.5,), (0.5,)
KW = dict(data="fmnist", num_agents=4, bs=BS, local_ep=2, client_lr=0.1,
          client_moment=0.9, num_corrupt=2, robustLR_threshold=2,
          diagnostics=True, top_frac=50)


class _NoDropout:
    """A Flax module whose train-mode forward runs without dropout."""

    def __init__(self, inner):
        self._inner = inner

    def apply(self, variables, x, train=False, rngs=None):
        del train, rngs
        return self._inner.apply(variables, x, train=False)


def _epoch_perms(key, size, local_ep):
    perms = []
    for ep_key in jax.random.split(key, local_ep):
        shuffle_key, _ = jax.random.split(ep_key)
        r = jax.random.uniform(shuffle_key, (N_TOTAL,))
        r = jnp.where(jnp.arange(N_TOTAL) < size, r, 2.0)
        perms.append(torch.from_numpy(np.array(jnp.argsort(r))).long())
    return perms


def _flax_params(rng):
    shapes = jax.eval_shape(JaxCNN().init, jax.random.PRNGKey(0),
                            jnp.zeros((1,) + SHAPE))["params"]
    return {mod: {name: (rng.normal(size=leaf.shape) / np.sqrt(
        np.prod(leaf.shape[:-1]) if name == "kernel" else 10.0)).astype(
            np.float32) for name, leaf in leaves.items()}
        for mod, leaves in shapes.items()}


def _to_jax_flat(tree):
    """A port-named dict (or a flat vector in the port's order with the
    params' shapes) raveled in JAX's layout and order."""
    return np.asarray(ravel_pytree(jax.tree_util.tree_map(
        jnp.asarray, carrier.flax_from_params(tree)))[0])


def _unflat(vec, like):
    out, at = {}, 0
    for k, v in like.items():
        out[k] = vec[at:at + v.numel()].reshape(v.shape)
        at += v.numel()
    return out


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_diagnostics_pieces_match_jax():
    rng = np.random.default_rng(3)
    u = {"a": rng.normal(size=(5, 3, 4)).astype(np.float32),
         "b": rng.normal(size=(5, 6)).astype(np.float32)}
    u["a"][2] *= 10.0
    got = diagnostics.clip_updates({k: torch.from_numpy(v)
                                    for k, v in u.items()}, 2.0)
    want = jax_diag.clip_updates({k: jnp.asarray(v) for k, v in u.items()},
                                 2.0)
    for k in u:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
    norms = rng.uniform(1, 3, size=6).astype(np.float32)
    for ids, nc in (([3, 0, 5, 1, 2, 4], 2), ([3, 4, 5, 6, 7, 8], 2),
                    ([0, 1, 0, 1, 0, 1], 2)):
        assert (diagnostics.norm_scalars(norms, ids, nc)
                == jax_diag.norm_scalars(norms, ids, nc))
    lr = np.where(rng.uniform(size=200) < 0.3, -0.5, 0.5).astype(np.float32)
    vecs = [rng.normal(size=200).astype(np.float32) for _ in range(3)]
    assert (diagnostics.sign_agreement(lr, *vecs, 40, 0.5, 1.25)
            == jax_diag.sign_agreement(lr, *vecs, 40, 0.5, 1.25))

    # the Fisher, adversarial and honest, at the same params
    flax_params = _flax_params(rng)
    params = carrier.params_from_flax(flax_params, "cpu")
    x = rng.uniform(0, 255, size=(27,) + SHAPE).astype(np.float32)
    y = np.full(27, 7, np.int64)
    images, labels, weights = pad_eval_set(x, y, BS)
    assert weights.sum() == 27 and images.shape[0] == 2
    model = registry.get_model("fmnist", SHAPE)
    fisher = diagnostics.make_fisher_fn(
        model, common.make_normalizer(MEAN, STD, "cpu"))
    j_fisher = jax_diag.make_fisher_fn(JaxCNN(),
                                       jax_make_normalizer(MEAN, STD, False))
    flats = {}
    for label, lbl in (("adv", labels), ("hon", np.full_like(labels, 5))):
        got = fisher(params, *(torch.from_numpy(a)
                               for a in (images, lbl, weights)))
        want = j_fisher(flax_params, jnp.asarray(images),
                        jnp.asarray(lbl.astype(np.int32)),
                        jnp.asarray(weights))
        carried = carrier.flax_from_params(got)
        for mod, leaves in want.items():
            for name, w in leaves.items():
                w = np.asarray(w)
                np.testing.assert_allclose(
                    carried[mod][name], w, rtol=0,
                    atol=1e-5 * np.abs(w).max(), err_msg=f"{label} {mod}")
        g_flat, w_flat = _to_jax_flat(got), np.asarray(ravel_pytree(want)[0])
        assert (np.linalg.norm(g_flat - w_flat)
                <= 1e-5 * np.linalg.norm(w_flat)), label
        flats[label] = (diagnostics.flat(got).numpy(), g_flat)

    # Sign/* of the port's flat vectors, in the port's order, against JAX's
    # of the same values in JAX's order: the same coordinates selected
    n = sum(v.numel() for v in params.values())
    lr_port = torch.from_numpy(
        np.where(rng.uniform(size=n) < 0.4, -1.0, 1.0).astype(np.float32))
    upd_port = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    got, got_cum = diagnostics.sign_agreement(
        lr_port.numpy(), upd_port.numpy(), flats["adv"][0], flats["hon"][0],
        KW["top_frac"], 1.0, 0.5)
    want, want_cum = jax_diag.sign_agreement(
        _to_jax_flat(_unflat(lr_port, params)),
        _to_jax_flat(_unflat(upd_port, params)), flats["adv"][1],
        flats["hon"][1], KW["top_frac"], 1.0, 0.5)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    assert got["Sign/Hon_Maxim_L2"] > 0.0
    np.testing.assert_allclose(got_cum, want_cum, rtol=1e-6)


def test_diag_round_and_cli_rows(tmp_path, capsys):
    rng = np.random.default_rng(42)
    xs = rng.uniform(0, 255, size=(len(SIZES), N_TOTAL) + SHAPE).astype(
        np.float32)
    ys = rng.integers(0, 10, size=(len(SIZES), N_TOTAL)).astype(np.int32)
    flax_params = _flax_params(rng)
    sizes = np.asarray(SIZES, np.int32)
    k_train, k_noise = jax.random.split(jax.random.PRNGKey(9))
    agent_keys = jax.random.split(k_train, len(SAMPLED))
    perms = [_epoch_perms(agent_keys[s], SIZES[a], KW["local_ep"])
             for s, a in enumerate(SAMPLED)]
    jcfg = JaxConfig(**KW)
    core = jax.jit(functools.partial(
        jax_rounds._round_core,
        train_block=jax_rounds.make_block_trainer(
            _NoDropout(JaxCNN()), jcfg,
            jax_make_normalizer(MEAN, STD, False)),
        cfg=jcfg))
    _, _, j_extras = core(
        flax_params, k_train, k_noise, jnp.asarray(xs[SAMPLED]),
        jnp.asarray(ys[SAMPLED]), jnp.asarray(sizes[SAMPLED]))
    cfg = Config(**KW, device="cpu")
    assert not rounds._fused_applicable(cfg)
    assert rounds._fused_applicable(cfg.replace(diagnostics=False))
    params = carrier.params_from_flax(flax_params, "cpu")
    round_fn = rounds.make_round_fn(
        cfg, registry.get_model("fmnist", SHAPE),
        common.make_normalizer(MEAN, STD, "cpu"), torch.from_numpy(xs),
        torch.from_numpy(ys).long(), sizes)
    _, info = round_fn(params, rounds.RoundRNG(0, "cpu"), sampled=SAMPLED,
                       perms=perms, dropout=False)
    np.testing.assert_allclose(info["agent_norms"].numpy(),
                               np.asarray(j_extras["agent_norms"]),
                               rtol=1e-5)
    lr = _to_jax_flat(_unflat(info["lr_flat"], params))
    want = np.asarray(j_extras["lr_flat"])
    assert lr.shape == want.shape
    assert set(np.unique(lr)) <= {-1.0, 1.0}
    assert (lr == want).mean() > 1 - 1e-4

    log_dir = tmp_path / "logs"
    argv = ["--device", "cpu", "--data", "synthetic", "--num_agents", "4",
            "--bs", "16", "--local_ep", "1", "--rounds", "2", "--snap", "1",
            "--synth_train_size", "128", "--synth_val_size", "64",
            "--eval_bs", "32", "--num_corrupt", "1", "--poison_frac", "1.0",
            "--robustLR_threshold", "2", "--diagnostics", "--train_layout",
            "megabatch", "--no_tensorboard", "--data_dir",
            str(tmp_path / "none"), "--log_dir", str(log_dir)]
    assert train.main(argv) == 0
    out = capsys.readouterr().out
    assert ("[layout] --train_layout megabatch does not support "
            "--diagnostics") in out
    (path,) = log_dir.glob("*/metrics.jsonl")
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    for step in (1, 2):
        tags = [r["tag"] for r in rows if r["step"] == step]
        diag = [r for r in rows if r["step"] == step
                and r["tag"].startswith(("Norms/", "Sign/"))]
        assert {r["tag"] for r in diag} == {
            "Norms/Avg_Honest_L2", "Norms/Avg_Corrupt_L2",
            *jax_diag.sign_agreement(np.ones(4), np.ones(4), np.ones(4),
                                     np.ones(4), 1, 1.0, 0.0)[0]}, step
        assert all(np.isfinite(r["value"]) for r in diag), step
        assert tags.index("Sign/Model_Net_L2_Cumulative") < tags.index(
            "Health/Nonfinite_Updates"), step
