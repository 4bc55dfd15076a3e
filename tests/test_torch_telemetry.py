"""The port's defense telemetry (obs/telemetry.py) against the JAX
package's, in isolation and in a round, and the Defense/* rows of its CLI.

(a) `compute` at basic and at full on the same updates, lr, aggregate,
participation mask and corrupt flags: the margin histogram exactly, the
norms, flip fraction, margin mean and cosines within rtol 1e-5; the key
sets, tags, `host_summary` and `emit_scalars` exactly. (b) the tel_* lanes
of one round under `--attack signflip --telemetry full` against JAX
`_round_core` under a plain `jax.jit` (CNN_MNIST at 14x14, the draws
injected as in tests/test_torch_attack_round.py), and the Defense/* rows a
CPU run of the port's CLI writes: every tag at every boundary, finite, in
the order JAX writes them.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import functools
import json

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
from defending_against_backdoors_with_robust_learning_rate_tpu.obs import (
    telemetry as jax_telemetry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch import (
    train)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    common, rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    carrier, registry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.obs import (
    telemetry)

SHAPE = (14, 14, 1)
BS, N_TOTAL = 16, 48
SIZES = [48, 40, 33, 17]
SAMPLED = [2, 0, 3, 1]      # corrupt ids 0 and 1 sit in slots 1 and 3
MEAN, STD = (0.5,), (0.5,)
KW = dict(data="fmnist", num_agents=4, bs=BS, local_ep=2, client_lr=0.1,
          client_moment=0.9, num_corrupt=2, robustLR_threshold=2,
          attack="signflip", telemetry="full")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


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


class _Rows:
    def __init__(self):
        self.rows = []

    def scalar(self, tag, value, step):
        self.rows.append((tag, float(value), int(step)))


def _host(vals):
    return {k: (np.asarray(v).tolist() if np.ndim(v) else float(v))
            for k, v in vals.items()}


def _same(got, want, what):
    assert set(got) == set(want), what
    for k, w in want.items():
        g = got[k].numpy()
        if k == "tel_margin_hist":
            # integer counts over the same total: exact
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=what)
        else:
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{what} {k}")


def test_compute_matches_jax():
    rng = np.random.default_rng(2)
    m = 6
    shapes = {"a": (5, 4), "b": (7,), "c": (3, 3, 2)}
    ups = {k: rng.normal(size=(m,) + s).astype(np.float32)
           for k, s in shapes.items()}
    ups["a"][:, 0, 0] = 0.0             # a zero-margin column
    ups["b"][:, 1] = np.abs(ups["b"][:, 1])     # a unanimous one
    lr = {k: np.where(rng.random(s) < 0.3, -1.0, 1.0).astype(np.float32)
          for k, s in shapes.items()}
    agg = {k: rng.normal(size=s).astype(np.float32)
           for k, s in shapes.items()}
    masks = (None, np.array([True, False, True, True, False, True]),
             np.zeros(m, bool))
    flags = (None, np.array([False, True, False, False, True, True]),
             np.ones(m, bool))
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    n = 0
    for level in ("basic", "full"):
        for thr in (0, 3):
            kw = dict(telemetry=level, robustLR_threshold=thr)
            cfg, jcfg = Config(**kw), JaxConfig(**kw)
            assert telemetry.telemetry_keys(cfg) == \
                jax_telemetry.telemetry_keys(jcfg)
            for mask in masks:
                for fl in flags:
                    what = f"{kw} mask={mask} flags={fl}"
                    want = jax_telemetry.compute(
                        jcfg, ups, lr if thr else None, agg, mask=mask,
                        corrupt_flags=fl)
                    got = telemetry.compute(
                        cfg, t(ups), t(lr) if thr else None, t(agg),
                        mask=None if mask is None else torch.from_numpy(mask),
                        corrupt_flags=(None if fl is None
                                       else torch.from_numpy(fl)))
                    _same(got, want, what)
                    assert set(got) == set(telemetry.telemetry_keys(cfg))
                    n += 1
                    host = _host({k: v.numpy() for k, v in got.items()})
                    assert telemetry.host_summary(host) == \
                        jax_telemetry.host_summary(host)
                    a, b = _Rows(), _Rows()
                    telemetry.emit_scalars(a, host, 4)
                    jax_telemetry.emit_scalars(b, host, 4)
                    assert a.rows == b.rows
                    assert sorted(r[0] for r in a.rows) == sorted(
                        telemetry.tags(cfg))
    assert n == 2 * 2 * len(masks) * len(flags)
    assert telemetry.telemetry_keys(Config()) == ()
    assert telemetry.TAGS == {k: v for k, v in jax_telemetry.TAGS.items()
                              if k in telemetry.TAGS}
    assert telemetry.N_MARGIN_BUCKETS == jax_telemetry.N_MARGIN_BUCKETS
    for mod in (telemetry, jax_telemetry):
        with pytest.raises(ValueError, match="telemetry must be one of"):
            mod.check_level("loud")
    # the buffered path's electorate (ported in slice 11): an accumulated
    # sign-sum dict, bucketized over a widened vote range, as JAX's
    sums = {k: 2 * np.sign(u).sum(axis=0) for k, u in ups.items()}
    _same(telemetry.compute(Config(telemetry="full"), t(ups), None, t(agg),
                            sign_sums=t(sums), vote_range=2 * m + 1),
          jax_telemetry.compute(JaxConfig(telemetry="full"), ups, None, agg,
                                sign_sums=sums, vote_range=2 * m + 1),
          "sign_sums")


def test_round_lanes_and_cli_rows_match_jax(tmp_path):
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
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
        sizes = np.asarray(SIZES, np.int32)
        flags = np.asarray(SAMPLED) < KW["num_corrupt"]
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
            jnp.asarray(ys[SAMPLED]), jnp.asarray(sizes[SAMPLED]),
            corrupt_flags=jnp.asarray(flags))
        cfg = Config(**KW, device="cpu")
        assert not rounds._fused_applicable(cfg)    # telemetry turns K1 off
        round_fn = rounds.make_round_fn(
            cfg, registry.get_model("fmnist", SHAPE),
            common.make_normalizer(MEAN, STD, "cpu"), torch.from_numpy(xs),
            torch.from_numpy(ys).long(), sizes)
        _, info = round_fn(carrier.params_from_flax(flax_params, "cpu"),
                           rounds.RoundRNG(0, "cpu"), sampled=SAMPLED,
                           perms=perms, dropout=False)
        want = {k: np.asarray(v) for k, v in j_extras.items()
                if k.startswith("tel_")}
        got = {k: v.numpy() for k, v in info.items() if k.startswith("tel_")}
        assert set(got) == set(want) == set(telemetry.telemetry_keys(cfg))
        for k, w in want.items():
            if k.startswith("tel_upd_norm"):
                # the client-side f32 drift of tests/test_torch_round.py:
                # 1e-5 relative
                np.testing.assert_allclose(got[k], w, rtol=1e-5, err_msg=k)
            else:
                # vote counts: a sign can flip where an update sits within
                # that drift of 0, so fractions and means agree to 1e-4 (all
                # but 1e-4 of the coordinates), the cosines to 1e-5
                np.testing.assert_allclose(
                    got[k], w, rtol=0,
                    atol=1e-5 if k.startswith("tel_cos") else 1e-4,
                    err_msg=k)
        assert got["tel_flip_frac"] > 0 and got["tel_cos_corrupt"] != 0

        log_dir = tmp_path / "logs"
        argv = ["--device", "cpu", "--data", "synthetic", "--num_agents",
                "4", "--bs", "16", "--local_ep", "1", "--rounds", "2",
                "--snap", "1", "--synth_train_size", "128",
                "--synth_val_size", "32", "--eval_bs", "32",
                "--num_corrupt", "1", "--poison_frac", "0.5",
                "--robustLR_threshold", "2", "--attack", "signflip",
                "--telemetry", "full", "--no_tensorboard",
                "--data_dir", str(tmp_path / "none"), "--log_dir",
                str(log_dir)]
        assert train.main(argv) == 0
        run_cfg = train.args_parser(argv)
        (run_dir,) = log_dir.iterdir()
        assert run_dir.name == train.run_name(run_cfg)
        assert sorted(p.name for p in run_dir.iterdir()) == ["metrics.jsonl"]
        rows = [json.loads(line)
                for line in (run_dir / "metrics.jsonl").read_text()
                .splitlines()]
        tags = telemetry.tags(run_cfg)
        assert len(tags) == 4 + 8 + 3
        for step in (1, 2):
            defense = [r for r in rows if r["step"] == step
                       and r["tag"].startswith("Defense/")]
            # the order of JAX's emit_scalars: sorted keys, bins in order
            ref = _Rows()
            jax_telemetry.emit_scalars(
                ref, {k: (list(range(8)) if k == "tel_margin_hist" else 0.0)
                      for k in jax_telemetry.telemetry_keys(
                          JaxConfig(**{**KW, "num_corrupt": 1}))}, step)
            assert [r["tag"] for r in defense] == [r[0] for r in ref.rows]
            assert all(np.isfinite(r["value"]) for r in defense), step
            hist = [r["value"] for r in defense
                    if "Vote_Margin_Hist" in r["tag"]]
            assert sum(hist) == pytest.approx(1.0, abs=1e-6)
    finally:
        torch.set_num_threads(old)
