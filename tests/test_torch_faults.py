"""The port's fault model (faults/model.py) and the faults round's server
path (fl/rounds.server_path) against the JAX package's, on identical numpy
inputs and injected fault draws (torch cannot replay `jax.random`, so
JAX's `FaultDraw`s are built here and given to both sides).

The server path is held against JAX's pieces composed in `_round_core`'s
order (fl/rounds.py:296-393): inject_corrupt, mask = participate &
payload_valid, fault_scalars, the mask-aware threshold and vote, the
masked rule, guard_empty, apply_aggregate, the sentinel over the mask.
Tolerances as tests/test_torch_rules.py: selections and sign votes equal,
sums 1e-6 relative, rfa 1e-5 relative L2. JAX's side runs under a plain
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
    masking as jax_masking, model as jax_fmodel)
from defending_against_backdoors_with_robust_learning_rate_tpu.health import (
    monitor as jax_monitor, sentinel as jax_sentinel)
from defending_against_backdoors_with_robust_learning_rate_tpu.ops import (
    aggregate as jax_aggregate)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.faults import (
    masking, model as fmodel)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.health import (
    monitor, sentinel)

SHAPES = {"a": (7, 3), "b": (5,), "c": (2, 3, 4)}
M = 6


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _tree(rng, lead=()):
    """A param-shaped dict, or [m, ...] stacks with row i at scale 1 + i
    (krum's scores far apart)."""
    out = {}
    for k, s in SHAPES.items():
        x = rng.normal(size=lead + s).astype(np.float32)
        if lead:
            x = x * (1.0 + np.arange(lead[0], dtype=np.float32)).reshape(
                (-1,) + (1,) * len(s))
        out[k] = x
    return out


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _draw(participate, straggler, corrupt, local_ep=2, se=1):
    participate, straggler, corrupt = (np.asarray(x, bool) for x in (
        participate, straggler, corrupt))
    budget = np.where(straggler, min(se, local_ep), local_ep).astype(np.int32)
    return (jax_fmodel.FaultDraw(*(jnp.asarray(x) for x in (
        participate, straggler, budget, corrupt))),
        fmodel.FaultDraw(*(torch.from_numpy(x) for x in (
            participate, straggler, budget, corrupt))))


def test_fault_pieces_match_jax():
    """inject_corrupt (nan, huge), payload_valid with and without a cap (a
    1e30 row rejected: its squared norm overflows to inf), fault_scalars,
    rlr_threshold abs and scaled and guard_empty against JAX; the
    quarantine set (its parsing, its refusals and quarantine_mask on
    sampled ids) against JAX's; and the port's own draw keeps JAX's rules
    (one survivor, spared attackers, straggler budgets, the seeded
    stream)."""
    rng = np.random.default_rng(3)
    u = _tree(rng, (M,))
    tu = _torch(u)
    corrupt = np.array([0, 1, 0, 0, 1, 0], bool)
    for mode in ("nan", "huge"):
        want = jax.jit(lambda x, c, md=mode: jax_fmodel.inject_corrupt(
            x, c, md))(u, jnp.asarray(corrupt))
        got = fmodel.inject_corrupt(tu, torch.from_numpy(corrupt), mode)
        for k in u:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        for cap in (0.0, 50.0, 1e15, 1e20):
            want_v = jax.jit(lambda x, c=cap: jax_fmodel.payload_valid(
                x, c))(_np(want))
            got_v = fmodel.payload_valid(got, cap)
            np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v),
                                          err_msg=f"{mode} cap={cap}")
        if mode == "huge":
            # finite, so only a cap rejects it, even a cap far above the
            # honest norms: the sum of squares of 1e30 is inf in f32 (a
            # cap of 1e20 squares to inf as well, and then lets it in, as
            # in JAX)
            assert fmodel.payload_valid(got).all()
            assert not fmodel.payload_valid(got, 1e15)[corrupt].any()
            assert fmodel.payload_valid(got, 1e15)[~corrupt].all()
    with pytest.raises(ValueError, match="nan|huge"):
        fmodel.inject_corrupt(tu, torch.from_numpy(corrupt), "zero")

    jd, td = _draw([1, 0, 1, 1, 0, 1], [0, 1, 1, 0, 0, 0], corrupt)
    mask = np.array([1, 0, 1, 1, 0, 0], bool)
    want = jax.jit(jax_fmodel.fault_scalars)(jd, jnp.asarray(mask))
    got = fmodel.fault_scalars(td, torch.from_numpy(mask))
    assert {k: float(v) for k, v in got.items()} == {
        k: float(v) for k, v in want.items()}
    for mode in ("abs", "scaled"):
        for thr in (0, 4):
            j = jax_masking.rlr_threshold(JaxConfig(
                robustLR_threshold=thr, rlr_threshold_mode=mode),
                jnp.asarray(mask))
            t = masking.rlr_threshold(Config(
                robustLR_threshold=thr, rlr_threshold_mode=mode),
                torch.from_numpy(mask))
            assert float(t) == float(j), (mode, thr)
    agg = _tree(rng)
    for m_ in (mask, np.zeros(M, bool)):
        want = jax.jit(jax_masking.guard_empty)(agg, jnp.asarray(m_))
        got = masking.guard_empty(_torch(agg), torch.from_numpy(m_))
        for k in agg:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))

    # the quarantine set: parsed, validated and matched as JAX's
    sampled = np.array([7, 0, 3, 12, 5, 3], np.int32)
    for q in ("", "3", "0,3", " 12, 3,3,", "99", "1,2,4,6"):
        jcfg, cfg = JaxConfig(quarantine=q), Config(quarantine=q)
        assert sentinel.has_quarantine(cfg) == jax_sentinel.has_quarantine(
            jcfg), q
        assert sentinel.quarantine_ids(cfg) == jax_sentinel.quarantine_ids(
            jcfg), q
        want = jax_sentinel.quarantine_mask(jcfg, jnp.asarray(sampled))
        got = sentinel.quarantine_mask(cfg, torch.from_numpy(sampled))
        if want is None:
            assert got is None and sentinel.quarantine_set(cfg, "cpu") is None
            continue
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=q)
        qset = sentinel.quarantine_set(cfg, "cpu")
        assert torch.equal(sentinel.quarantine_mask(
            cfg, torch.from_numpy(sampled).long(), qset), got), q
    for q in (",", "a,1", "-2"):
        with pytest.raises(ValueError) as want:
            jax_monitor.check(JaxConfig(quarantine=q))
        with pytest.raises(ValueError) as got:
            monitor.check(Config(quarantine=q))
        assert str(got.value) == str(want.value), q

    # the port's own draw: JAX's rules on the port's stream
    cfg = Config(local_ep=2, dropout_rate=1.0, straggler_rate=0.5,
                 straggler_epochs=1, corrupt_rate=0.5)
    gen = rounds.RoundRNG(5, "cpu")
    draws = [fmodel.sample_faults(cfg, gen.faults(r), M) for r in (1, 2)]
    for d in draws:
        assert int(d.participate.sum()) == 1        # everyone drew a drop
        assert d.ep_budget.dtype == torch.int32
        assert torch.equal(d.ep_budget, torch.where(d.straggler, 1, 2).to(
            torch.int32))
    again = fmodel.sample_faults(cfg, rounds.RoundRNG(5, "cpu").faults(1), M)
    assert all(torch.equal(a, b) for a, b in zip(again, draws[0]))
    flags = torch.tensor([True, True, False, False, False, False])
    spare = fmodel.sample_faults(cfg.replace(faults_spare_corrupt=True),
                                 gen.faults(1), M, flags)
    assert spare.participate[:2].all() and not spare.participate[2:].any()


def _jax_server(jcfg, params, updates, sizes, draw, qmask=None):
    """JAX's faults branch of `_round_core`, composed piece by piece; a
    quarantine mask joins as its `churn_active` does (fl/rounds.py:
    319-341)."""
    def run(params, updates, sizes, draw, qmask):
        mask, extras = None, {}
        if draw is not None:
            if jcfg.corrupt_rate > 0:
                updates = jax_fmodel.inject_corrupt(updates, draw.corrupt,
                                                    jcfg.corrupt_mode)
            mask = draw.participate & jax_fmodel.payload_valid(
                updates, jcfg.payload_norm_cap)
            extras = jax_fmodel.fault_scalars(draw, mask)
        if qmask is not None:
            mask = qmask if mask is None else mask & qmask
            if draw is not None:
                extras["fault_voters"] = jax_masking.count_f32(mask)
        slr = jcfg.effective_server_lr
        if jcfg.robustLR_threshold > 0:
            lr = jax_aggregate.robust_lr(
                updates, jax_masking.rlr_threshold(jcfg, mask), slr,
                mask=mask)
        else:
            lr = slr
        agg = jax_aggregate.aggregate_updates(updates, sizes, jcfg,
                                              jax.random.PRNGKey(0),
                                              mask=mask)
        agg = jax_masking.guard_empty(agg, mask)
        new = jax_aggregate.apply_aggregate(params, lr, agg)
        extras.update(jax_sentinel.sentinel(jcfg, updates, new, mask=mask))
        return new, extras
    return jax.jit(run)(params, updates, sizes, draw, qmask)


def test_faults_server_path_matches_jax():
    """fl/rounds.server_path over a fault draw, every rule, against JAX's
    pieces in `_round_core`'s order: NaN and huge payloads, a norm cap,
    abs and scaled thresholds, sign's server lr, and a --quarantine mask
    over the sampled ids alone and after a fault mask; then an
    all-invalid round, which leaves the params as they were bit for
    bit."""
    rng = np.random.default_rng(4)
    params = _tree(rng)
    tp = _torch(params)
    sizes = rng.integers(10, 100, size=(M,)).astype(np.int32)
    ts = torch.from_numpy(sizes)
    cases = (
        dict(corrupt_rate=0.5, corrupt_mode="nan", robustLR_threshold=2),
        dict(corrupt_rate=0.5, corrupt_mode="huge", payload_norm_cap=1e15,
             robustLR_threshold=3, rlr_threshold_mode="scaled"),
        dict(dropout_rate=0.3, robustLR_threshold=0),
        # the quarantined ids 0 and 3 sit in slots 1 and 3
        dict(robustLR_threshold=2, quarantine="0,3"),
        dict(corrupt_rate=0.5, corrupt_mode="nan", robustLR_threshold=2,
             rlr_threshold_mode="scaled", quarantine="0,3"),
    )
    sampled = np.array([4, 0, 5, 3, 1, 2], np.int64)
    draws = (_draw([1, 1, 0, 1, 1, 1], [0, 1, 0, 0, 1, 0],
                   [0, 0, 0, 1, 0, 0]),
             _draw([1, 1, 1, 1, 1, 1], [0, 1, 0, 0, 0, 0],
                   [0, 0, 0, 1, 0, 0]))
    for aggr in ("avg", "comed", "sign", "trmean", "krum", "rfa"):
        for kw in cases:
            # krum at f = 0: k = n_eff - 2 >= 2, so its winner stands apart
            # (at k = 1 the nearest pair ties by construction)
            kw = dict(kw, aggr=aggr, num_corrupt=0 if aggr == "krum" else 1,
                      server_lr=0.5)
            jcfg, cfg = JaxConfig(**kw), Config(**kw)
            assert not rounds._fused_applicable(cfg)
            jd, td = draws[bool(cfg.quarantine)] if cfg.faults_enabled else (
                None, None)
            jq = jax_sentinel.quarantine_mask(jcfg, jnp.asarray(sampled))
            tq = sentinel.quarantine_mask(cfg, torch.from_numpy(sampled))
            u = _tree(rng, (M,))
            want_p, want_x = _jax_server(jcfg, params, u, jnp.asarray(sizes),
                                         jd, jq)
            got_p, got_x = rounds.server_path(tp, _torch(u), ts, cfg,
                                              draw=td, qmask=tq)
            what = f"{aggr} {kw}"
            assert set(got_x) == set(want_x), what
            if td is not None and cfg.quarantine:
                # slot 3 is corrupt and quarantined, slot 1 quarantined
                assert float(got_x["fault_voters"]) == 4.0, what
            for k in set(fmodel.INFO_KEYS) & set(want_x) | {
                    "hlth_nonfinite", "hlth_params_finite"}:
                assert float(got_x[k]) == float(want_x[k]), (what, k)
            np.testing.assert_array_equal(got_x["hlth_agent_bad"].numpy(),
                                          np.asarray(want_x["hlth_agent_bad"]))
            np.testing.assert_allclose(float(got_x["hlth_update_normsq"]),
                                       float(want_x["hlth_update_normsq"]),
                                       rtol=1e-6, err_msg=what)
            g = np.concatenate([got_p[k].numpy().ravel() for k in params])
            w = np.concatenate([np.asarray(want_p[k]).ravel()
                                for k in params])
            assert np.isfinite(g).all(), what
            if aggr in ("comed", "krum", "sign"):
                np.testing.assert_array_equal(g, w, err_msg=what)
            elif aggr == "rfa":
                d = g - np.concatenate([params[k].ravel() for k in params])
                dw = w - np.concatenate([params[k].ravel() for k in params])
                assert np.linalg.norm(d - dw) / np.linalg.norm(dw) < 1e-5, what
            else:
                np.testing.assert_allclose(g, w, rtol=1e-6,
                                           atol=1e-6 * np.abs(w).max(),
                                           err_msg=what)

    # every payload rejected: a zero aggregate, the params bit for bit
    jd0, td0 = _draw([0, 1, 0, 1, 0, 1], np.zeros(M), [0, 1, 0, 1, 0, 1])
    for aggr in ("avg", "comed", "sign", "trmean", "krum", "rfa"):
        kw = dict(aggr=aggr, corrupt_rate=0.5, robustLR_threshold=2,
                  num_corrupt=1)
        u = _tree(rng, (M,))
        got_p, got_x = rounds.server_path(tp, _torch(u), ts, Config(**kw),
                                          draw=td0)
        want_p, want_x = _jax_server(JaxConfig(**kw), params, u,
                                     jnp.asarray(sizes), jd0)
        assert float(got_x["fault_voters"]) == 0.0
        for k in params:
            assert torch.equal(got_p[k], tp[k]), (aggr, k)
            np.testing.assert_array_equal(np.asarray(want_p[k]), params[k])
