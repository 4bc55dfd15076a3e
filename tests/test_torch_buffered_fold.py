"""The port's buffered fold (fl/buffered.py) against the JAX package's, on
identical numpy inputs and injected latency draws.

Six ticks of `tick_contributions` + `fold_commit` on each side, each
carrying its own state, with pending arrivals (latencies up to S = 3),
the staleness exponent 0.5, the scaled RLR threshold and a commit gate
K = 7 over m = 6 (ticks that commit and ticks that do not), avg and sign.
A masked slot holds a NaN payload each tick: it must stay out of every
sum. After every tick the params and the avg sums match within 1e-6
relative (max abs error over the tensor's scale); the sign sums, the
counts, the staleness bins and the commit flags match exactly. Then the
per-staleness Defense split (`_per_bin_split`) and the telemetry over the
buffer's vote (obs/telemetry.compute's `sign_sums` and `vote_range`)
against JAX's: the counts behind every fraction exact, the fractions and
cosines within 1e-6. JAX's side runs under a plain `jax.jit`; server
noise is 0 (JAX's jax.random noise cannot be matched).

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
    buffered as jax_buffered)
from defending_against_backdoors_with_robust_learning_rate_tpu.obs import (
    telemetry as jax_telemetry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    buffered)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.obs import (
    telemetry)

SHAPES = {"a": (7, 3), "b": (5,), "c": (2, 3, 4)}
M = 6
TICKS = 6
EXACT = ("sign", "pend_sign", "bin_sign", "count", "stale", "pend_cnt")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= 1e-6 * scale, what


def _fractions(got, want, what):
    """Counts over the coordinate total: the counts exact, the quotient
    within an ulp (XLA divides by the constant total through its
    reciprocal)."""
    total = sum(int(np.prod(s)) for s in SHAPES.values())
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.rint(got * total),
                                  np.rint(want * total), err_msg=what)
    np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=what)


def _tick_inputs(rng, S, nan_slot=True):
    """One tick's stacked updates, latency draw and mask; the masked slot
    carries a NaN payload."""
    u = {k: rng.normal(size=(M,) + s).astype(np.float32)
         for k, s in SHAPES.items()}
    T = rng.integers(0, S + 1, size=M).astype(np.int32)
    mask = rng.random(M) > 0.2
    mask[rng.integers(M)] = False
    if nan_slot:
        bad = int(np.flatnonzero(~mask)[0])
        for x in u.values():
            x[bad] = np.nan
    return u, T, mask


def _jax_tick(jcfg, m):
    @jax.jit
    def tick(params, state, u, sizes, mask, T):
        contribs = jax_buffered.tick_contributions(jcfg, u, sizes, mask, T)
        return jax_buffered.fold_commit(jcfg, params, state, contribs,
                                        jax.random.PRNGKey(0), m)
    return tick


def _compare_state(state, jstate, what):
    for key, want in jstate.items():
        if isinstance(want, dict):
            for leaf, w in want.items():
                got = state[f"{key}/{leaf}"].numpy()
                if key in EXACT:
                    np.testing.assert_array_equal(got, np.asarray(w),
                                                  err_msg=f"{what} {key}")
                else:
                    _close(got, w, f"{what} {key}/{leaf}")
        elif key in EXACT:
            np.testing.assert_array_equal(state[key].numpy(),
                                          np.asarray(want),
                                          err_msg=f"{what} {key}")
        else:
            _close(state[key].numpy(), want, f"{what} {key}")
    n = sum(len(v) if isinstance(v, dict) else 1 for v in jstate.values())
    assert len(state) == n, what


def _run_ticks(kw, rng, check_tick):
    """TICKS ticks on both sides from the same inputs; check_tick(t, port,
    jax) after each, where port/jax are (params, state, lr, agg, extras,
    vote_sign, updates, mask)."""
    jcfg, cfg = JaxConfig(**kw), Config(**kw)
    S = cfg.async_max_staleness
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    sizes = rng.integers(10, 100, size=M).astype(np.int32)
    per_bin = cfg.telemetry == "full"
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jax_buffered.init_state(jcfg, jp, per_bin=per_bin)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = buffered.init_state(cfg, tp, per_bin=per_bin)
    tick = _jax_tick(jcfg, M)
    for t in range(TICKS):
        u, T, mask = _tick_inputs(rng, S)
        if not buffered.has_pending(cfg):
            T = None
        jout = tick(jp, js, {k: jnp.asarray(v) for k, v in u.items()},
                    jnp.asarray(sizes), jnp.asarray(mask),
                    None if T is None else jnp.asarray(T))
        tu = {k: torch.from_numpy(v) for k, v in u.items()}
        tmask = torch.from_numpy(mask)
        contribs = buffered.tick_contributions(
            cfg, tu, torch.from_numpy(sizes), tmask,
            None if T is None else torch.from_numpy(T))
        tout = buffered.fold_commit(cfg, tp, ts, contribs, None, M)
        check_tick(t, cfg, jcfg, tout + (tu, tmask), jout + (u, mask))
        jp, js = jout[0], jout[1]
        tp, ts = tout[0], tout[1]


def test_fold_commit_matches_jax():
    """tick_contributions + fold_commit over 6 ticks: the params, every
    state field and the Async/* values against JAX's, avg and sign, with
    pending arrivals, exponent 0.5 and the scaled threshold."""
    rng = np.random.default_rng(7)
    commits = {}

    def check(t, cfg, jcfg, port, jx):
        what = f"{cfg.aggr} tick {t}"
        for k in SHAPES:
            assert np.isfinite(port[0][k].numpy()).all(), what
            if cfg.aggr == "sign":
                np.testing.assert_array_equal(port[0][k].numpy(),
                                              np.asarray(jx[0][k]),
                                              err_msg=what)
            else:
                _close(port[0][k].numpy(), jx[0][k], f"{what} params {k}")
        _compare_state(port[1], jx[1], what)
        for k in buffered.ASYNC_INFO_KEYS:
            np.testing.assert_array_equal(port[4][k].numpy(),
                                          np.asarray(jx[4][k]),
                                          err_msg=f"{what} {k}")
        for k in SHAPES:
            np.testing.assert_array_equal(port[2][k].numpy(),
                                          np.asarray(jx[2][k]),
                                          err_msg=f"{what} lr {k}")
        commits.setdefault(cfg.aggr, []).append(
            float(port[4]["async_committed"]))

    for aggr in ("avg", "sign"):
        kw = dict(aggr=aggr, agg_mode="buffered", num_agents=M,
                  robustLR_threshold=2, rlr_threshold_mode="scaled",
                  server_lr=0.5, straggler_rate=0.5, async_buffer_k=7,
                  async_staleness_exp=0.5, async_max_staleness=3)
        _run_ticks(kw, rng, check)
        # the gate both fired and held over the six ticks
        assert 0.0 in commits[aggr] and 1.0 in commits[aggr], commits


def test_per_bin_split_and_vote_range_telemetry_match_jax():
    """--telemetry full: the per-staleness split (tel_stale_flip exact,
    tel_stale_cos 1e-6) and obs/telemetry.compute over the buffer's sign
    sums with the K + m vote range, against JAX's, with pending arrivals
    and without them (the unstacked contributions padded into bin 0)."""
    rng = np.random.default_rng(11)

    def check(t, cfg, jcfg, port, jx):
        what = f"{cfg.aggr} strag {cfg.straggler_rate} tick {t}"
        pe, je = port[4], jx[4]
        _fractions(pe["tel_stale_flip"], je["tel_stale_flip"], what)
        np.testing.assert_allclose(pe["tel_stale_cos"].numpy(),
                                   np.asarray(je["tel_stale_cos"]),
                                   rtol=1e-6, atol=1e-6, err_msg=what)
        vr = buffered.vote_range(cfg)
        assert vr == jax_buffered.vote_range(jcfg) == 7 + M
        lr = port[2] if cfg.robustLR_threshold > 0 else None
        jlr = jx[2] if cfg.robustLR_threshold > 0 else None
        got = telemetry.compute(cfg, port[6], lr, port[3], mask=port[7],
                                sign_sums=port[5], vote_range=vr)
        want = jax.jit(lambda u, lr, agg, mask, s: jax_telemetry.compute(
            jcfg, u, lr, agg, mask=mask, sign_sums=s, vote_range=vr))(
                {k: jnp.asarray(v) for k, v in jx[6].items()}, jlr, jx[3],
                jnp.asarray(jx[7]), jx[5])
        assert set(got) == set(want), what
        for k in ("tel_margin_hist", "tel_margin_mean", "tel_flip_frac"):
            if k in want:
                _fractions(got[k], want[k], f"{what} {k}")
        for k in set(want) - {"tel_margin_hist", "tel_margin_mean",
                              "tel_flip_frac"}:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{what} {k}")
        # a full buffer stays in range: the margin mean in [0, 1]
        assert 0.0 <= float(got["tel_margin_mean"]) <= 1.0, what

    for aggr, strag in (("avg", 0.5), ("sign", 0.5), ("avg", 0.0)):
        kw = dict(aggr=aggr, agg_mode="buffered", num_agents=M,
                  robustLR_threshold=2, telemetry="full",
                  straggler_rate=strag, async_buffer_k=7,
                  async_staleness_exp=0.5, async_max_staleness=3)
        _run_ticks(kw, rng, check)
