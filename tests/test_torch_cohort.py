"""The port's cohort sampler (data/cohort.py) against the JAX package's,
and the population axis's CLI surface and refusals.

torch cannot replay `jax.random`, so the port draws its candidates from
its own counter-based stream and the test splits each draw from its
selection: JAX's own candidates and presence, drawn here with
`jax.random` as JAX's `sample_cohort` draws them (data/cohort.py:163-176
single, :186-210 chunked), go into the port's `select_single` /
`select_chunked`, whose ids and `active` mask must equal JAX's
`sample_cohort` bit for bit: the single-matrix draw, the chunked draw
(1M clients, churn 0.1 and diurnal traffic: 11,378 candidates in 3
chunks), and shortfalls on both. Then the port's own draw: a pure
function of (cohort_seed, round), deduplicated, in range, every active
member churn- and traffic-present. JAX runs under a plain `jax.jit`.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from defending_against_backdoors_with_robust_learning_rate_tpu.config import (
    Config as JaxConfig, args_parser as jax_args_parser)
from defending_against_backdoors_with_robust_learning_rate_tpu.data import (
    cohort as jax_cohort)
from defending_against_backdoors_with_robust_learning_rate_tpu.utils import (
    compile_cache as jax_compile_cache)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch import (
    config, train)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data import (
    cohort, traffic)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.service import (
    churn)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils import (
    compile_cache)

POPULATION_FIELDS = (
    "churn_available", "churn_period", "churn_seed", "cohort_sampled",
    "cohort_size", "cohort_seed", "partitioner", "dirichlet_alpha",
    "classes_per_client", "samples_per_client", "bank_dir",
    "bank_shard_clients", "bank_build_workers", "bank_verify", "traffic",
    "traffic_seed", "traffic_peak_frac", "traffic_trough_frac",
    "traffic_day_rounds", "traffic_latency_sigma", "agg_mode", "tenants",
    "chaos")


def _jax_draws(jcfg):
    """rnd -> JAX's candidates [n_chunks, C] and presence (or None) of
    round rnd, drawn as its sample_cohort draws them."""
    C, n_chunks = jax_cohort.draw_plan(jcfg)
    K = jcfg.num_agents

    @jax.jit
    def draw(rnd):
        k = jax.random.fold_in(jax_cohort.cohort_key(jcfg), rnd)
        keys = ([k] if n_chunks == 1 else
                [jax.random.fold_in(k, c) for c in range(n_chunks)])
        cands = jnp.stack([jax.random.randint(kc, (C,), 0, K,
                                              dtype=jnp.int32)
                           for kc in keys])
        oks = [jax_cohort._present(jcfg, c, rnd) for c in cands]
        return cands, (None if oks[0] is None else jnp.stack(oks))

    def draws(rnd):
        cands, oks = draw(jnp.int32(rnd))
        return np.asarray(cands), None if oks is None else np.asarray(oks)
    return draws


def test_selection_matches_jax_sample_cohort():
    cases = {
        # single matrix, no presence: 2m candidates deduplicated
        "single": dict(num_agents=100_000, cohort_size=64),
        # single matrix under churn and traffic, with shortfalls
        "single shortfall": dict(num_agents=40, cohort_size=10,
                                 churn_available=0.3, churn_period=3,
                                 traffic="diurnal", traffic_day_rounds=8),
        # the README run: 1M clients, churn 0.1, diurnal: 3 chunks
        "chunked": dict(num_agents=1_000_000, cohort_size=256,
                        churn_available=0.1, traffic="diurnal"),
        # deep churn over a small population: 7 chunks, id-0 padding
        "chunked shortfall": dict(num_agents=2000, cohort_size=256,
                                  churn_available=0.02, churn_period=5),
    }
    seen_short = set()
    for what, kw in cases.items():
        jcfg = JaxConfig(cohort_sampled="on", **kw)
        cfg = Config(cohort_sampled="on", **kw)
        assert cohort.availability(cfg) == jax_cohort.availability(jcfg)
        assert cohort.oversample_count(cfg) == jax_cohort.oversample_count(
            jcfg)
        assert cohort.draw_plan(cfg) == jax_cohort.draw_plan(jcfg), what
        C, n_chunks = cohort.draw_plan(cfg)
        assert (n_chunks > 1) == what.startswith("chunked")
        jax_draws = _jax_draws(jcfg)
        for rnd in (1, 2, 3, 17, 64, 65):
            want_ids, want_act = jax_cohort.sample_cohort_host(jcfg, rnd)
            cands, oks = jax_draws(rnd)
            if n_chunks == 1:
                ids, act = cohort.select_single(
                    cands[0], None if oks is None else oks[0],
                    cfg.agents_per_round)
            else:
                ids, act = cohort.select_chunked(cands, oks,
                                                 cfg.agents_per_round)
            assert ids.dtype == np.int32 and act.dtype == bool
            np.testing.assert_array_equal(ids, want_ids, err_msg=what)
            np.testing.assert_array_equal(act, want_act, err_msg=what)
            if not act.all():
                seen_short.add(what)
    assert seen_short == {"single shortfall", "chunked shortfall"}

    # the port's own draw: a pure function of (cohort_seed, round), first
    # occurrences only, in range, every active member present
    cfg = Config(cohort_sampled="on", num_agents=1_000_000, cohort_size=256,
                 churn_available=0.1, traffic="diurnal")
    draws = {}
    for rnd in (1, 2, 3):
        ids, act = cohort.sample_cohort(cfg, rnd)
        again = cohort.sample_cohort(cfg, rnd)
        np.testing.assert_array_equal(ids, again[0])
        np.testing.assert_array_equal(act, again[1])
        assert ids.shape == (256,) and act.all()
        assert len(set(ids.tolist())) == 256
        assert ids.min() >= 0 and ids.max() < cfg.num_agents
        assert churn.active_slots(cfg, ids, rnd).all()
        assert traffic.present_slots(cfg, ids, rnd).all()
        draws[rnd] = ids
    assert not np.array_equal(draws[1], draws[2])
    other = cohort.sample_cohort(cfg.replace(cohort_seed=1), 1)[0]
    assert not np.array_equal(other, draws[1])
    # a shortfall pads with inactive slots; on the chunked draw id 0
    short = Config(cohort_sampled="on", num_agents=2000, cohort_size=256,
                   churn_available=0.02, churn_period=5)
    ids, act = cohort.sample_cohort(short, 4)
    assert 0 < act.sum() < 256 and (ids[~act] == 0).all()
    assert len(set(ids[act].tolist())) == act.sum()
    assert train.sample_ids(short, 4, cohort=True).tolist() == ids.tolist()


def _parse_error(parse, argv, capsys):
    with pytest.raises(SystemExit):
        parse(argv)
    return capsys.readouterr().err.strip().splitlines()[-1]


def test_population_cli_and_refusals(capsys):
    # every population field: JAX's name and default
    ours, ref = Config(), JaxConfig()
    for name in POPULATION_FIELDS:
        assert getattr(ours, name) == getattr(ref, name), name
    assert {f.name for f in dataclasses.fields(Config)} >= set(
        POPULATION_FIELDS)
    argv = ["--num_agents", "1000000", "--cohort_size", "256",
            "--partitioner", "dirichlet", "--dirichlet_alpha", "0.5",
            "--traffic", "diurnal", "--churn_available", "0.1", "--chain",
            "2", "--bank_verify", "--bank_build_workers", "2",
            "--cohort_seed", "3", "--traffic_latency_sigma", "1.5"]
    cfg, jcfg = config.args_parser(argv), jax_args_parser(argv)
    for name in POPULATION_FIELDS + ("chain",):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    for prop in ("churn_enabled", "traffic_enabled", "agents_per_round"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    assert cfg.agents_per_round == 256
    # the host-sampled round chains now
    assert config.args_parser(["--chain", "2", "--host_sampled",
                               "on"]).chain == 2
    # argparse's own errors, word for word
    for bad in (["--partitioner", "shards"], ["--traffic", "hourly"],
                ["--cohort_sampled", "maybe"], ["--agg_mode", "eventual"]):
        assert (_parse_error(config.args_parser, bad, capsys)
                == _parse_error(jax_args_parser, bad, capsys)), bad
    # buffered aggregation is ported (slice 11): parsed with JAX's fields
    argv = ["--agg_mode", "buffered", "--async_buffer_k", "5",
            "--async_staleness_exp", "0.5", "--async_max_staleness", "3"]
    cfg, jcfg = config.args_parser(argv), jax_args_parser(argv)
    for name in ("agg_mode", "async_buffer_k", "async_staleness_exp",
                 "async_max_staleness"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    # what stays refused, by its ROADMAP item
    for argv, text in ((["--tenants", "4"], config.TENANTS_NOT_PORTED),
                       (["--chaos", "bank_corrupt@0"],
                        config.CHAOS_NOT_PORTED)):
        with pytest.raises(ValueError) as e:
            config.args_parser(argv)
        assert str(e.value) == text and "not ported yet" in text
    # churn and traffic run on the device-resident sharded round; the
    # sharded cohort round stays refused
    for kw in (dict(churn_available=0.5), dict(traffic="diurnal")):
        assert train._sharded_cfg(Config(**kw), print).replace(
            reputation="auto") == Config(**kw)
    with pytest.raises(ValueError) as e:
        train._sharded_cfg(Config(cohort_sampled="on"), print)
    assert str(e.value) == config.SHARDED_COHORT_NOT_PORTED
    assert "ROADMAP queue 1 item 11" in str(e.value)
    # the oversample's loud cap, JAX's words
    deep = dict(cohort_sampled="on", num_agents=10_000_000,
                cohort_size=4096, churn_available=0.001)
    with pytest.raises(ValueError) as e:
        cohort.oversample_count(Config(**deep))
    with pytest.raises(ValueError) as j:
        jax_cohort.oversample_count(JaxConfig(**deep))
    assert str(e.value) == str(j.value)
    assert not cohort.cohort_feasible(Config(**deep))
    # the cohort decision, the config alone, on a grid
    grid = [dict(num_agents=k, cohort_size=m, cohort_sampled=mode,
                 churn_available=a)
            for k in (10, 4095, 4096, 1_000_000) for m in (0, 8)
            for mode in ("auto", "on", "off") for a in (1.0, 0.001)]
    for kw in grid:
        assert compile_cache.is_cohort_mode(Config(**kw)) == \
            jax_compile_cache.is_cohort_mode(JaxConfig(**kw)), kw
    assert compile_cache.COHORT_AUTO_MIN_POPULATION == \
        jax_compile_cache.COHORT_AUTO_MIN_POPULATION
    for name in ("COHORT_KEY_TAG", "MAX_CANDIDATES", "MAX_DRAW_CHUNKS",
                 "MIN_AVAILABILITY"):
        assert getattr(cohort, name) == getattr(jax_cohort, name), name
