"""The port's reputation plane (obs/reputation.py and its lanes in the
round) against the JAX package's.

(a) On the same numpy inputs: the rep_agree / rep_norm lanes of a stacked
update dict (exact zeros among the values, and a participation mask:
masked rows zeroed, `MASKED` in their slots) against JAX's `agree_rows`
over `sign_sums_from` of the zero-masked stack and `norm_rows`, agreement
bit for bit and norms within 1e-6 relative; `ReputationTracker` over one
sequence of folds (masked slots, a boosted and a flipping client), dense
(population 12) and count-min sketch (population 40 over a cap of 8,
ledger of 4): every boundary's rows, summary, suspect count, streak
events and `state_dict` equal to JAX's, exactly, also after each
tracker's state went through JSON and `load_state` mid-sequence;
`rank_auc` on tied scores; `emit_rows` row for row.

(b) The resolution of `--reputation` across flags: the port's
`reputation_on` equals JAX's with JAX's default server step (no
`--use_pallas`), whatever the port's fused kernel does, and the fused
kernel stays the port's server step with the lanes on; `check`'s errors
word for word; on the sharded round `auto` resolves off with a printed
line, and `--reputation on`, `--diagnostics`, `--checkpoint_dir` and
`--resume` are refused ("not ported yet"). Then one CNN_MNIST round at 14x14 (m = 4 of 4, two corrupt
agents under boost x8, RLR threshold 2, dropout off, the ids and each
slot's epoch permutations injected from JAX's draws, JAX's params through
models/carrier) through the port's round (K1's plain version on the CPU)
against JAX's `_round_core` under a plain `jax.jit`: rep_norm within 1e-5
relative, rep_agree within 2e-4 (a coordinate whose update sits within
the client-side f32 drift of 0 can change sign: tests/test_torch_round.
py's tolerance of 1e-4 of the coordinates, twice over, one for the
update and one for the vote), and both packages' boosted slots 8x the
honest median norm.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu.config import (
    Config as JaxConfig)
from defending_against_backdoors_with_robust_learning_rate_tpu.faults import (
    masking as jax_masking)
from defending_against_backdoors_with_robust_learning_rate_tpu.fl import (
    rounds as jax_rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu.fl.common import (
    make_normalizer as jax_make_normalizer)
from defending_against_backdoors_with_robust_learning_rate_tpu.models.cnn import (
    CNN_MNIST as JaxCNN)
from defending_against_backdoors_with_robust_learning_rate_tpu.obs import (
    reputation as jax_rep)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch import (
    train)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    common, rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    carrier, registry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.obs import (
    reputation as rep)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel import (
    rounds as prounds)

M = 6
SHAPES = {"a": (3, 4), "b": (7,), "c": (2, 2, 5)}


class _Rows:
    def __init__(self):
        self.rows = []

    def scalar(self, tag, value, step):
        self.rows.append((tag, float(value), int(step)))


def _stack(rng):
    out = {}
    for k, s in SHAPES.items():
        u = rng.normal(size=(M,) + s).astype(np.float32)
        u[rng.uniform(size=u.shape) < 0.1] = 0.0     # ties: no agreement
        out[k] = u
    out["b"][2] *= 8.0                               # a loud client
    out["a"][4] *= -1.0                              # a flipping client
    return out


def _folds(rng, population, rounds):
    """(round, ids, agree, norm) rows: MASKED slots, a corrupt client 0
    that loses the vote and client 1 shouting 6x."""
    out = []
    for r in range(1, rounds + 1):
        ids = rng.choice(population, M, replace=False)
        ids[:2] = (0, 1) if r % 2 else (1, 0)
        agree = rng.uniform(0.55, 0.75, size=M).astype(np.float32)
        norm = rng.uniform(0.8, 1.2, size=M).astype(np.float32)
        agree[ids == 0] = 0.2
        norm[ids == 1] *= 6.0
        if r % 3 == 0:
            agree[4], norm[4] = rep.MASKED, rep.MASKED
        out.append((r, ids.tolist(), agree.tolist(), norm.tolist()))
    return out


def _tracker_view(t, pred):
    return (t.boundary_rows(pred), t.summary(pred), t.suspect_count(),
            t.drain_events(), json.dumps(t.state_dict()),
            [t.suspicion(c) for c in range(t.population)])


def test_lanes_tracker_and_rows_match_jax():
    rng = np.random.default_rng(0)
    u = _stack(rng)
    mask = np.array([1, 1, 0, 1, 1, 0], bool)
    tu = {k: torch.from_numpy(v) for k, v in u.items()}
    ju = {k: jnp.asarray(v) for k, v in u.items()}
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        j_u = ju if m is None else jax_masking.zero_masked(ju, jm)
        want_a = np.asarray(jax_rep.agree_rows(
            j_u, jax_rep.sign_sums_from(j_u), mask=jm))
        want_n = np.asarray(jax_rep.norm_rows(j_u, mask=jm))
        got = rep.lanes(tu, None if m is None else torch.from_numpy(m))
        np.testing.assert_array_equal(got["rep_agree"].numpy(), want_a)
        np.testing.assert_allclose(got["rep_norm"].numpy(), want_n,
                                   rtol=1e-6)
        if m is not None:
            assert (got["rep_agree"].numpy()[~m] == rep.MASKED).all()
            assert (got["rep_norm"].numpy()[~m] == rep.MASKED).all()
    assert float(got["rep_norm"][2]) == rep.MASKED

    for name in ("PREFIX", "MODES", "EMA_DECAY", "LOSE_THRESHOLD", "MASKED",
                 "SKETCH_DEPTH", "SKETCH_WIDTH", "N_SUSPECT_ROWS", "TAGS",
                 "SUSPECT_EVENT", "_SKETCH_SALTS"):
        assert getattr(rep, name) == getattr(jax_rep, name), name

    for population, cap, topk in ((12, 100, 64), (40, 8, 4)):
        folds = _folds(np.random.default_rng(population), population, 9)
        kw = dict(population=population, cap=cap, topk=topk, streak_thr=2)
        mine, ref = rep.ReputationTracker(**kw), jax_rep.ReputationTracker(
            **kw)
        assert mine.sketch_mode == ref.sketch_mode == (population > cap)

        def pred(cid):
            return cid < 2
        for i, (r, ids, agree, norm) in enumerate(folds):
            mine.fold(r, ids, agree, norm)
            ref.fold(r, ids, agree, norm)
            assert _tracker_view(mine, pred) == _tracker_view(ref, pred), (
                population, r)
            if i == 4:
                # mid-sequence, each tracker's state through JSON
                state = json.loads(json.dumps(mine.state_dict()))
                mine = rep.ReputationTracker(**kw)
                mine.load_state(state)
                j_state = json.loads(json.dumps(ref.state_dict()))
                ref = jax_rep.ReputationTracker(**kw)
                ref.load_state(j_state)
        mine.fold(99, [5, 6], [0.5, 0.5])   # agreement alone
        ref.fold(99, [5, 6], [0.5, 0.5])
        assert _tracker_view(mine, pred) == _tracker_view(ref, pred)
        a, b = _Rows(), _Rows()
        rep.emit_rows(a, mine, 9, pred)
        jax_rep.emit_rows(b, ref, 9, pred)
        assert a.rows == b.rows
        if not mine.sketch_mode:
            assert mine.ranked()[0][0] in (0, 1)
            assert any(t == rep.TAGS["auc"] for t, _, _ in a.rows)
    scores = [0.3, 0.1, 0.3, 0.9, 0.1, 0.5]
    labels = [True, False, False, True, True, False]
    assert rep.rank_auc(scores, labels) == jax_rep.rank_auc(scores, labels)
    assert rep.rank_auc([1.0], [True]) is None


# --- (b) ------------------------------------------------------------------

SHAPE = (14, 14, 1)
BS, N_TOTAL = 16, 48
SIZES = [48, 40, 33, 17]
SAMPLED = [2, 0, 3, 1]      # corrupt ids 0 and 1 sit in slots 1 and 3
MEAN, STD = (0.5,), (0.5,)
KW = dict(data="fmnist", num_agents=4, bs=BS, local_ep=2, client_lr=0.1,
          client_moment=0.9, num_corrupt=2, robustLR_threshold=2,
          attack="boost", attack_boost=8.0)


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


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_resolution_and_round_lanes_match_jax():
    for aggr in ("avg", "sign", "comed"):
        for thr in (0, 2):
            for mode in rep.MODES:
                kw = dict(aggr=aggr, robustLR_threshold=thr, reputation=mode)
                jcfg = JaxConfig(**kw)
                for fused in (True, False):
                    cfg = Config(**kw, use_fused=fused)
                    try:
                        jax_rep.check(jcfg)
                    except ValueError as e:
                        with pytest.raises(ValueError) as got:
                            rep.check(cfg)
                        assert str(got.value) == str(e)
                        continue
                    rep.check(cfg)
                    assert rep.reputation_on(cfg) == jax_rep.reputation_on(
                        jcfg), kw
                    assert rep.rep_keys(cfg) == jax_rep.rep_keys(jcfg)
                    # the lanes leave the fused kernel on
                    assert rounds._fused_applicable(cfg) == (
                        fused and aggr in ("avg", "sign")), kw
    # JAX's Pallas kernel (--use_pallas) turns `auto` off; the port's K1,
    # its default step, does not
    jcfg = JaxConfig(robustLR_threshold=2, use_pallas=True)
    assert not jax_rep.reputation_on(jcfg)
    assert rep.reputation_on(Config(robustLR_threshold=2))
    # the sharded round: auto resolves off with a line, the rest refused
    said = []
    cfg = train._sharded_cfg(Config(robustLR_threshold=2), said.append)
    assert cfg.reputation == "off" and "resolves off" in said[0]
    for kw in (dict(reputation="on"), dict(diagnostics=True),
               dict(checkpoint_dir="ck"), dict(resume=True)):
        with pytest.raises(ValueError, match="not ported yet"):
            train._sharded_cfg(Config(robustLR_threshold=2, **kw),
                               said.append)
    with pytest.raises(ValueError, match="not ported yet"):
        prounds.make_sharded_round_fn(
            Config(robustLR_threshold=2, reputation="on"), None, None,
            types.SimpleNamespace(size=2, rank=0), None, None, None)

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
    assert rounds._fused_applicable(cfg)
    model = registry.get_model("fmnist", SHAPE)
    round_fn = rounds.make_round_fn(
        cfg, model, common.make_normalizer(MEAN, STD, "cpu"),
        torch.from_numpy(xs), torch.from_numpy(ys).long(), sizes)
    _, info = round_fn(carrier.params_from_flax(flax_params, "cpu"),
                       rounds.RoundRNG(0, "cpu"), sampled=SAMPLED,
                       perms=perms, dropout=False)
    want_a = np.asarray(j_extras["rep_agree"])
    want_n = np.asarray(j_extras["rep_norm"])
    got_a, got_n = info["rep_agree"].numpy(), info["rep_norm"].numpy()
    assert np.abs(got_a - want_a).max() <= 2e-4, (got_a, want_a)
    np.testing.assert_allclose(got_n, want_n, rtol=1e-5)
    for norms in (got_n, want_n):
        ratio = norms[flags].min() / np.median(norms[~flags])
        assert 6.0 < ratio < 10.0, norms
