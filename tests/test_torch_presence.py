"""The port's churn lifecycles (service/churn.py) and diurnal traffic
(data/traffic.py) against the JAX package's, and their mask on the dense
round.

As tests/test_torch_cohort.py does for the cohort, each draw is split
from its selection: JAX's own per-client offsets and uniforms, drawn here
with `jax.random` as JAX's `active_slots` (service/churn.py:54-76) and
`present_slots` (data/traffic.py:78-97) draw them, go into the port's
`phase_of` / `active_from` and `local_time` / `present_from`, which must
give JAX's phases and masks. Churn compares float32 uniforms with a
float32 probability: bit for bit. The traffic curve is float32 in JAX's
order of operations, but numpy's cosine may differ from XLA's by an ulp,
so the curve is held to 2 ulps and a presence bit may differ only where
the uniform lies within 2 ulps of the curve. Then `churn_away`,
`churn_only_scalars`, `mean_available`, the censuses, the port's own
draws (pure functions of seed, client and round), and the dense round
under churn and traffic: its presence mask in the participation mask
(params equal to the round that quarantines the same absent clients) and
its Faults/* and Churn/Sampled_Away lanes.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu.config import (
    Config as JaxConfig)
from defending_against_backdoors_with_robust_learning_rate_tpu.data import (
    traffic as jax_traffic)
from defending_against_backdoors_with_robust_learning_rate_tpu.service import (
    churn as jax_churn)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data import (
    traffic)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    common, rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    registry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.service import (
    churn)

IDS = np.concatenate([np.arange(0, 600), [999_999, 123_457, 7, 7]])


def _jax_churn_draws(jcfg):
    """rnd -> JAX's (offsets, phases, uniforms, active_slots) of IDS."""
    period = max(1, int(jcfg.churn_period))
    base = jax_churn.churn_key(jcfg)

    @jax.jit
    def draws(rnd):
        def one(cid):
            k_off, k_phase = jax.random.split(jax.random.fold_in(base, cid))
            off = jax.random.randint(k_off, (), 0, period)
            phase = (rnd + off) // period
            return off, phase, jax.random.uniform(
                jax.random.fold_in(k_phase, phase))
        ids = jnp.asarray(IDS, jnp.int32)
        return (*jax.vmap(one)(ids), jax_churn.active_slots(jcfg, ids, rnd))
    return lambda rnd: tuple(np.array(a) for a in draws(jnp.int32(rnd)))


def _jax_traffic_draws(jcfg):
    """rnd -> JAX's (offsets, uniforms, present_slots) of IDS."""
    day = max(1, int(jcfg.traffic_day_rounds))
    base = jax_traffic.traffic_key(jcfg)

    @jax.jit
    def draws(rnd):
        def one(cid):
            k_tz, k_draw = jax.random.split(jax.random.fold_in(base, cid))
            off = jax.random.randint(k_tz, (), 0, day)
            return off, jax.random.uniform(jax.random.fold_in(k_draw, rnd))
        ids = jnp.asarray(IDS, jnp.int32)
        return (*jax.vmap(one)(ids),
                jax_traffic.present_slots(jcfg, ids, rnd))
    return lambda rnd: tuple(np.array(a) for a in draws(jnp.int32(rnd)))


def test_churn_and_traffic_selection_match_jax():
    for kw in (dict(churn_available=0.1), dict(churn_available=0.6,
                                               churn_period=5,
                                               churn_seed=3)):
        cfg, jcfg = Config(**kw), JaxConfig(**kw)
        jax_draws = _jax_churn_draws(jcfg)
        for rnd in (0, 1, 4, 31, 32, 100):
            off, phase, u, want = jax_draws(rnd)
            np.testing.assert_array_equal(churn.phase_of(cfg, rnd, off),
                                          phase)
            np.testing.assert_array_equal(churn.active_from(cfg, u), want)
        # the away count and the churn-only Faults/* scalars
        act = jax_draws(5)[3][:40]
        mask = act & (np.arange(40) % 3 > 0)
        want = jax_churn.churn_only_scalars(jnp.asarray(act),
                                            jnp.asarray(mask))
        got = churn.churn_only_scalars(torch.from_numpy(act),
                                       torch.from_numpy(mask))
        assert {k: float(v) for k, v in got.items()} == {
            k: float(v) for k, v in want.items()}
        # the port's own draw: pure in (seed, client, round), fresh at the
        # period's boundary, per client
        a = churn.active_slots(cfg, IDS, 33)
        np.testing.assert_array_equal(a, churn.active_slots(cfg, IDS, 33))
        np.testing.assert_array_equal(
            a[:10], churn.active_slots(cfg, IDS[:10], 33))
        assert abs(a[:600].mean() - cfg.churn_available) < 0.1
        small = cfg.replace(num_agents=3000)
        assert churn.active_count(small, 9) == int(
            churn.active_slots(small, np.arange(3000), 9).sum())

    for kw in (dict(traffic="diurnal"),
               dict(traffic="diurnal", traffic_peak_frac=0.9,
                    traffic_trough_frac=0.3, traffic_day_rounds=24,
                    traffic_seed=4)):
        cfg, jcfg = Config(**kw), JaxConfig(**kw)
        assert traffic.mean_available(cfg) == jax_traffic.mean_available(
            jcfg)
        t = np.arange(cfg.traffic_day_rounds)
        curve = traffic.availability_curve(cfg, t)
        want_curve = np.asarray(jax_traffic.availability_curve(
            jcfg, jnp.asarray(t)))
        assert curve.dtype == np.float32
        np.testing.assert_array_max_ulp(curve, want_curve, maxulp=2)
        jax_draws = _jax_traffic_draws(jcfg)
        for rnd in (0, 1, 13, 64, 200):
            off, u, want = jax_draws(rnd)
            np.testing.assert_array_equal(
                traffic.local_time(cfg, rnd, off),
                (rnd + off) % cfg.traffic_day_rounds)
            got = traffic.present_from(cfg, rnd, off, u)
            p = want_curve[(rnd + off) % cfg.traffic_day_rounds]
            near = np.abs(u - p) <= 2 * np.spacing(p)
            np.testing.assert_array_equal(got[~near], want[~near])
        small = cfg.replace(num_agents=2000)
        assert traffic.census(small, 3) == int(
            traffic.present_slots(small, np.arange(2000), 3).sum())
        assert jax_traffic.census(JaxConfig(**kw, num_agents=2000), 3) > 0
    assert traffic.TRAFFIC_KEY_TAG == jax_traffic.TRAFFIC_KEY_TAG
    assert churn.CHURN_KEY_TAG == jax_churn.CHURN_KEY_TAG
    assert traffic.TRAFFIC_MODES == jax_traffic.TRAFFIC_MODES


def test_dense_round_presence_mask():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        rng = np.random.default_rng(3)
        K, n_total = 12, 32
        xs = rng.integers(0, 256, size=(K, n_total, 8, 8, 1)).astype(
            np.uint8)
        ys = rng.integers(0, 10, size=(K, n_total)).astype(np.int64)
        sizes = rng.integers(8, n_total + 1, size=K).astype(np.int32)
        model = registry.get_model("synthetic", (8, 8, 1))
        norm = common.make_normalizer((0.5,), (0.5,), "cpu")
        params = registry.init_params(model, 0, "cpu")
        base = Config(data="synthetic", num_agents=K, agent_frac=0.75,
                      bs=16, local_ep=1, robustLR_threshold=2,
                      churn_available=0.5, churn_period=2,
                      traffic="diurnal", traffic_day_rounds=6)
        m = base.agents_per_round
        images, labels = torch.from_numpy(xs), torch.from_numpy(ys)
        sampled = list(range(m))
        rnd = next(r for r in range(1, 40)
                   if 0 < rounds.presence(base, sampled, r).sum() < m - 1)
        here = rounds.presence(base, sampled, rnd).numpy()
        assert not rounds._fused_applicable(base)
        assert rounds.step_takes_round(base)

        def run(cfg):
            fn = rounds.make_round_fn(cfg, model, norm, images, labels,
                                      sizes)
            rng_ = rounds.RoundRNG(0, "cpu")
            rng_.round = rnd - 1
            return fn(params, rng_, sampled=sampled)
        p_churn, i_churn = run(base)
        away = ",".join(str(i) for i in np.flatnonzero(~here))
        p_q, _ = run(base.replace(churn_available=1.0, traffic="flat",
                                  quarantine=away))
        for k in params:
            assert torch.equal(p_churn[k], p_q[k]), k
        assert float(i_churn["churn_away"]) == m - here.sum()
        assert float(i_churn["fault_voters"]) == here.sum()
        assert float(i_churn["fault_dropped"]) == 0.0
        # traffic alone: the mask, no Faults/* or Churn/* lanes (JAX's)
        p_t, i_t = run(base.replace(churn_available=1.0))
        assert "churn_away" not in i_t and "fault_voters" not in i_t
        assert any(not torch.equal(p_t[k], params[k]) for k in params)
    finally:
        torch.set_num_threads(old)
