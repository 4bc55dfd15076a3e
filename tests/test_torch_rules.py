"""The port's robust server rules (ops/aggregate.py: comed, trmean, krum,
rfa) and their masked twins (faults/masking.py) against the JAX package's,
on identical numpy inputs over a 3-leaf tree at m = 5 and m = 8; and each
masked rule under an all-ones mask against the port's dense rule, bit for
bit (JAX faults/masking.py:19-28, the port's contract too).

Tolerances: comed and krum select values, so they are equal as numbers
(krum's winner where it stands apart: at k = 1 the mutually nearest pair
ties by construction, and then either of the pair is Krum's answer);
trmean (and avg) sums a band of sorted values in another order (1e-6
relative to the aggregate's scale, and in L2); rfa runs four
Weiszfeld steps of f32 sums (1e-5 relative L2). Krum's updates have
distances well apart (rows at scales 1..m), so no near-tie decides its
argmin. The leaves are keyed in sorted order, the order JAX walks a dict,
so both sides accumulate leaves alike. JAX's side runs under a plain
`jax.jit`.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu.config import (
    Config as JaxConfig)
from defending_against_backdoors_with_robust_learning_rate_tpu.faults import (
    masking as jax_masking)
from defending_against_backdoors_with_robust_learning_rate_tpu.ops import (
    aggregate as jax_aggregate)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.faults import (
    masking)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops import (
    aggregate)

SHAPES = {"a": (7, 3), "b": (5,), "c": (2, 3, 4)}
RULES = ("comed", "trmean", "krum", "rfa")
EXACT = ("comed", "krum", "sign")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _updates(rng, m):
    """[m, ...] leaves, row i at scale 1 + i: krum's scores lie far apart."""
    scale = (1.0 + np.arange(m, dtype=np.float32))
    return {k: (rng.normal(size=(m,) + s) * scale.reshape(
        (-1,) + (1,) * len(s))).astype(np.float32)
        for k, s in SHAPES.items()}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _check(rule, got, want, what):
    """`got` (torch dict) against `want` (JAX dict) at the rule's
    tolerance."""
    assert list(got) == sorted(want), what
    g = {k: got[k].numpy() for k in got}
    w = {k: np.asarray(want[k]) for k in want}
    for k in g:
        assert g[k].shape == w[k].shape, (what, k)
        assert np.isfinite(g[k]).all(), (what, k)
    if rule in EXACT:
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{what} {k}")
    elif rule == "rfa":
        gv = np.concatenate([g[k].ravel() for k in g])
        wv = np.concatenate([w[k].ravel() for k in g])
        assert np.linalg.norm(gv - wv) / np.linalg.norm(wv) < 1e-5, what
    else:
        # relative to the aggregate's scale: a mean of values that cancel
        # keeps only the summands' absolute error (an ulp of their scale)
        gv = np.concatenate([g[k].ravel() for k in g])
        wv = np.concatenate([w[k].ravel() for k in g])
        np.testing.assert_allclose(gv, wv, rtol=0,
                                   atol=1e-6 * np.abs(wv).max(), err_msg=what)
        assert np.linalg.norm(gv - wv) / np.linalg.norm(wv) < 1e-6, what


def _krum_check(got, want, u, mask, f, what):
    """Krum's winner: JAX's row, equal as numbers, wherever the least score
    (f64, over the participants) stands apart from the next; where k = 1
    the mutually nearest pair ties by construction (their one distance),
    and f32 sums in another order may pick either, so the port's row must
    then be one of the tied rows. Returns whether the winner was unique."""
    m = len(mask)
    flat = np.concatenate([u[k].reshape(m, -1) for k in u], 1).astype(
        np.float64)
    d = ((flat[:, None] - flat[None]) ** 2).sum(-1)
    idx = np.flatnonzero(mask)
    n = len(idx)
    k = min(max(n - f - 2, min(n - 1, 1)), max(n - 1, 0))
    scores = np.sort(d[np.ix_(idx, idx)], 1)[:, 1:k + 1].sum(1)
    tied = idx[scores <= scores.min() * (1 + 1e-5)]

    def row(tree):
        r = np.concatenate([np.asarray(tree[k]).ravel() for k in u])
        hits = [i for i in range(m) if np.array_equal(r, flat[i].astype(
            np.float32))]
        assert len(hits) == 1, what
        return hits[0]
    g, w = row(got), row(want)
    if len(tied) == 1:
        assert g == w == tied[0], what
    else:
        assert g in tied and w in tied, what
    return len(tied) == 1


def _jax_rule(rule, f):
    if rule == "comed":
        return jax.jit(jax_aggregate.agg_comed)
    if rule == "trmean":
        return jax.jit(lambda u: jax_aggregate.agg_trmean(u, f))
    if rule == "krum":
        return jax.jit(lambda u: jax_aggregate.agg_krum(u, f))
    return jax.jit(jax_aggregate.agg_rfa)


def _port_rule(rule, u, f, mask=None):
    if rule == "comed":
        return aggregate.agg_comed(u, mask=mask)
    if rule == "trmean":
        return aggregate.agg_trmean(u, f, mask=mask)
    if rule == "krum":
        return aggregate.agg_krum(u, f, mask=mask)
    return aggregate.agg_rfa(u, mask=mask)


def test_dense_rules_match_jax():
    """comed, trmean (trims 0, 1, 2 and the clamp at 9), krum (f = 0, 1,
    2) and rfa at m = 5 and m = 8, and their dispatch through
    aggregate_updates."""
    rng = np.random.default_rng(11)
    for m in (5, 8):
        ju = _updates(rng, m)
        tu = _torch(ju)
        for rule in RULES:
            for f in ((0, 1, 2, 9) if rule == "trmean"
                      else (0, 1) if rule == "krum" else (1,)):
                want = _jax_rule(rule, f)(ju)
                got = _port_rule(rule, tu, f)
                _check(rule, got, want, f"{rule} m={m} f={f}")
                if rule == "krum":
                    # k >= 2 here: the winner stands apart
                    assert _krum_check(got, want, ju, np.ones(m, bool), f,
                                       f"krum m={m} f={f}")
            sizes = rng.integers(10, 100, size=(m,)).astype(np.int32)
            cfg = Config(aggr=rule, num_corrupt=1)
            got = aggregate.aggregate_updates(tu, torch.from_numpy(sizes),
                                              cfg)
            want = jax.jit(lambda u, s, c=JaxConfig(aggr=rule, num_corrupt=1):
                           jax_aggregate.aggregate_updates(
                               u, s, c, jax.random.PRNGKey(0)))(
                ju, jnp.asarray(sizes))
            _check(rule, got, want, f"aggregate_updates {rule} m={m}")
    # comed's lower median at an even count: torch.median's, not numpy's
    u = {"a": torch.tensor([[4.0], [1.0], [3.0], [2.0]])}
    assert float(aggregate.agg_comed(u)["a"]) == 2.0


def test_masked_rules_match_jax_and_dense():
    """Each masked twin (avg, sign, comed, trmean, krum, rfa and the
    masked RLR vote) against JAX faults/masking.py under masks with 1, 2
    and m-1 rows out (a NaN payload in one masked row), at the dense
    tolerances; and under an all-ones mask against the port's dense rule
    bit for bit, directly and through aggregate_updates / robust_lr."""
    rng = np.random.default_rng(12)
    unique = cases = 0
    for m in (5, 8):
        ju = _updates(rng, m)
        tu = _torch(ju)
        sizes = rng.integers(10, 100, size=(m,)).astype(np.int32)
        ts = torch.from_numpy(sizes)
        outs = (rng.permutation(m)[:1], rng.permutation(m)[:2],
                rng.permutation(m)[:m - 1])
        for out in outs:
            mask = np.ones(m, bool)
            mask[out] = False
            bad = {k: v.copy() for k, v in ju.items()}
            bad["b"][out[0]] = np.nan       # garbage a masked row carries
            jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
            tb = _torch(bad)
            for rule in RULES + ("avg", "sign"):
                for f in ((0, 1, 3) if rule in ("trmean", "krum") else (1,)):
                    jcfg = JaxConfig(aggr=rule, num_corrupt=f)
                    want = jax.jit(lambda u, s, k, c=jcfg:
                                   jax_masking.masked_aggregate(u, s, c, k))(
                        bad, jnp.asarray(sizes), jm)
                    got = masking.masked_aggregate(tb, ts, Config(
                        aggr=rule, num_corrupt=f), tm)
                    what = f"masked {rule} m={m} out={out.tolist()} f={f}"
                    if rule == "krum":
                        unique += _krum_check(got, want, ju, mask, f, what)
                        cases += 1
                    else:
                        _check(rule, got, want, what)
            for mode in ("abs", "scaled"):
                jcfg = JaxConfig(robustLR_threshold=3, rlr_threshold_mode=mode)
                jthr = jax_masking.rlr_threshold(jcfg, jm)
                want = jax.jit(lambda u, k, t: jax_aggregate.robust_lr(
                    u, t, 0.5, mask=k))(bad, jm, jnp.float32(jthr))
                thr = masking.rlr_threshold(Config(
                    robustLR_threshold=3, rlr_threshold_mode=mode), tm)
                assert float(thr) == float(jthr), mode
                _check("sign", aggregate.robust_lr(tb, thr, 0.5, mask=tm),
                       want, f"masked robust_lr {mode} m={m}")

        # an all-ones mask: every masked twin is its dense rule, bit for bit
        ones = torch.ones(m, dtype=torch.bool)
        for rule in RULES + ("avg", "sign"):
            for f in (0, 1, 2):
                cfg = Config(aggr=rule, num_corrupt=f)
                dense = aggregate.aggregate_updates(tu, ts, cfg)
                for got in (aggregate.aggregate_updates(tu, ts, cfg,
                                                        mask=ones),
                            masking.masked_aggregate(tu, ts, cfg, ones)):
                    for k in dense:
                        assert torch.equal(got[k], dense[k]), (rule, f, k)
        for mode in ("abs", "scaled"):
            cfg = Config(robustLR_threshold=3, rlr_threshold_mode=mode)
            dense = aggregate.robust_lr(tu, 3.0, 0.5)
            got = aggregate.robust_lr(tu, masking.rlr_threshold(cfg, ones),
                                      0.5, mask=ones)
            for k in dense:
                assert torch.equal(got[k], dense[k]), (mode, k)
    # 12 of the 18 masked krum cases have a winner apart; the other 6 have
    # k = 1 (n_eff - f - 2 <= 1)
    assert (unique, cases) == (12, 18)
