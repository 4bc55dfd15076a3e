"""The port's attack registry (attack/registry.py, schedule.py, boost.py,
signflip.py, dba.py) against the JAX package's, and its run names.

(a) a grid of attack configs: the strategy, `check` (the error texts
too), `in_jit`, `needs_round`, `update_scale`, the schedule gate for
rounds 1-12, `banner` and `run_name`, all exact. The grid crosses the four
strategies with boost 1 and 8 and the scenario vocabulary's schedules
(JAX scripts/sweep_scenarios.py:88-96: late start, one-shot,
intermittent), and adds the invalid ones. (b) the DBA split and the stamp
each corrupt agent gets for every dataset and pattern, and
`poison_agent_shards` under `--attack dba`, bit for bit.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import numpy as np
import pytest
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu.attack import (
    dba as jax_dba, poison as jax_poison, registry as jax_registry,
    schedule as jax_schedule)
from defending_against_backdoors_with_robust_learning_rate_tpu.config import (
    Config as JaxConfig)
from defending_against_backdoors_with_robust_learning_rate_tpu.utils.metrics import (
    run_name as jax_run_name)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.attack import (
    dba, poison, registry, schedule)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils.metrics import (
    run_name)

MID = 6     # the vocabulary's mid-run round for a 12-round sweep
SCHEDULES = {
    "always": {},
    "late": {"attack_start": MID},
    "oneshot": {"attack_start": MID, "attack_stop": MID + 1},
    "intermittent": {"attack_every": 2},
    "intermittent_late": {"attack_start": 3, "attack_every": 3,
                          "attack_stop": 11},
}
INVALID = [
    {"attack": "boost", "attack_start": -1},
    {"attack": "boost", "attack_every": 0},
    {"attack": "signflip", "attack_start": 4, "attack_stop": 4},
    {"attack": "boost", "attack_stop": -2},
    {"attack": "boost", "attack_boost": 0.0},
    {"attack": "signflip", "attack_boost": -3.0},
    {"attack": "static", "attack_start": 2},
    {"attack": "dba", "attack_every": 2},
    {"attack": "trojan"},
]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _outcome(fn):
    """(value, None) or (None, the ValueError's text)."""
    try:
        return fn(), None
    except ValueError as e:
        return None, str(e)


def _grid():
    for attack in ("static", "dba", "boost", "signflip"):
        for boost in (1.0, 8.0):
            for sched in SCHEDULES.values():
                yield dict(attack=attack, attack_boost=boost,
                           num_corrupt=2, poison_frac=0.5, **sched)
    yield from INVALID


def test_registry_schedule_and_names_match_jax():
    flags = np.array([True, False, True, False, False])
    n_checked = 0
    for kw in _grid():
        jcfg, cfg = JaxConfig(**kw), Config(**kw)
        what = repr(kw)
        want = _outcome(lambda: jax_registry.check(jcfg))
        got = _outcome(lambda: registry.check(cfg))
        assert got == want, what
        strat = _outcome(lambda: jax_registry.get(jcfg))
        assert _outcome(lambda: registry.get(cfg))[1] == strat[1], what
        if strat[1] or want[1]:
            continue
        n_checked += 1
        j, p = strat[0], registry.get(cfg)
        assert (p.name, p.data_mode, p.summary, p.in_jit) == (
            j.name, j.data_mode, j.summary, j.in_jit), what
        assert registry.in_jit(cfg) == jax_registry.in_jit(jcfg), what
        assert registry.needs_round(cfg) == jax_registry.needs_round(jcfg)
        assert schedule.is_trivial(cfg) == jax_schedule.is_trivial(jcfg)
        assert registry.banner(cfg) == jax_registry.banner(jcfg), what
        assert run_name(cfg) == jax_run_name(jcfg), what
        for rnd in range(1, 13):
            want_on = bool(jax_schedule.active(jcfg, rnd))
            assert schedule.active(cfg, rnd) is want_on, (what, rnd)
            gate = registry.schedule_active(cfg, rnd)
            jgate = jax_registry.schedule_active(jcfg, rnd)
            assert (gate is None) == (jgate is None), what
            if jgate is not None:
                assert gate == bool(jgate), (what, rnd)
            if not registry.in_jit(cfg):
                continue
            # the row scale, exact: boost or -boost on corrupt rows while
            # active, 1 elsewhere, as f32
            want_s = np.asarray(jax_registry.update_scale(
                jcfg, flags, jgate))
            got_s = registry.update_scale(cfg, torch.from_numpy(flags), gate)
            assert got_s.dtype == torch.float32
            np.testing.assert_array_equal(got_s.numpy(), want_s,
                                          err_msg=f"{what} round {rnd}")
            # the round's host-side attacked slots from the sampled ids
            # (the gate folded in) give JAX's scale of flags and gate
            ids = [0, 4, 1, 3, 2]       # corrupt ids 0, 1: slots 0 and 2
            np.testing.assert_array_equal(
                registry.update_scale(
                    cfg, registry.attacked_slots(cfg, ids, rnd), None
                ).numpy(),
                np.asarray(jax_registry.update_scale(
                    jcfg, np.asarray(ids) < 2, jgate)))
        if not registry.in_jit(cfg):
            assert registry.attacked_slots(cfg, [0, 1], 1) is None
            for mod in (registry, jax_registry):
                with pytest.raises(ValueError, match="no in-jit update"):
                    mod.update_scale(cfg if mod is registry else jcfg,
                                     flags, None)
    assert n_checked == 4 * 2 * len(SCHEDULES) - 2 * 2 * (len(SCHEDULES) - 1)

    # the update hook on stacked rows, in f32, and its refusals
    for attack in ("boost", "signflip"):
        jcfg = JaxConfig(attack=attack, attack_boost=8.0)
        cfg = Config(attack=attack, attack_boost=8.0)
        rng = np.random.default_rng(0)
        ups = {"a": rng.normal(size=(5, 3, 2)).astype(np.float32),
               "b": rng.normal(size=(5,)).astype(np.float32)}
        want = jax_registry.apply_update_attack(jcfg, ups, flags)
        got = registry.apply_update_attack(
            cfg, {k: torch.from_numpy(v) for k, v in ups.items()},
            torch.from_numpy(flags))
        for k in ups:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
        assert (_outcome(lambda: registry.apply_update_attack(
            cfg, ups, None))[1] == _outcome(
                lambda: jax_registry.apply_update_attack(jcfg, ups, None))[1])
        with pytest.raises(ValueError, match="not ported yet"):
            registry.update_scale(cfg, torch.from_numpy(flags), None,
                                  boost=2.0)
    # a data-side strategy leaves the updates as they are
    same = {"a": torch.ones(2, 3)}
    assert registry.apply_update_attack(Config(attack="dba"), same,
                                        None) is same
    # a scheduled update attack on a surface without a round channel
    c, jc = (Config(attack="boost", attack_start=3),
             JaxConfig(attack="boost", attack_start=3))
    assert (_outcome(lambda: registry.schedule_active(c, None))
            == _outcome(lambda: jax_registry.schedule_active(jc, None)))


def test_dba_split_and_poisoning_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    for data, ptypes in (("fmnist", ("plus", "square", "copyright",
                                     "apple")),
                         ("fedemnist", ("plus", "square", "copyright",
                                        "apple")),
                         ("cifar10", ("plus", "square")),
                         ("synthetic", ("plus",))):
        for ptype in ptypes:
            for n_corrupt in (1, 3, 4):
                kw = dict(data=data, pattern_type=ptype, attack="dba",
                          num_corrupt=n_corrupt, data_dir=str(tmp_path))
                jcfg, cfg = JaxConfig(**kw), Config(**kw)
                full = jax_registry.stamp_for_agent(
                    jcfg.replace(attack="static"), -1)
                shards = []
                for agent in range(n_corrupt + 2):
                    what = f"{data}/{ptype}/c{n_corrupt}/agent {agent}"
                    for strat in ("dba", "static", "boost"):
                        w = jax_registry.stamp_for_agent(
                            jcfg.replace(attack=strat), agent)
                        g = registry.stamp_for_agent(
                            cfg.replace(attack=strat), agent)
                        assert g.mode == w.mode, what
                        np.testing.assert_array_equal(g.mask, w.mask,
                                                      err_msg=what)
                        np.testing.assert_array_equal(g.value, w.value,
                                                      err_msg=what)
                    want = jax_dba.split_stamp(full, agent, n_corrupt)
                    got = dba.split_stamp(full, agent, n_corrupt)
                    np.testing.assert_array_equal(got.mask, want.mask)
                    np.testing.assert_array_equal(
                        dba.stamp_for_agent(cfg, agent).mask, want.mask)
                    if agent < n_corrupt:
                        shards.append(got.mask)
                # the corrupt cohort's shards partition the full pattern
                np.testing.assert_array_equal(
                    np.logical_or.reduce(shards), full.mask)
                assert sum(s.sum() for s in shards) == full.mask.sum()
    for mod in (dba, jax_dba):
        with pytest.raises(ValueError, match="n_shards must be positive"):
            mod.split_stamp(full, 0, 0)

    # poison_agent_shards under --attack dba: 5 agents, 3 corrupt, on
    # uint8 cifar10 rows and float fedemnist rows, bit for bit
    for data, shape, dtype in (("cifar10", (32, 32, 3), np.uint8),
                               ("fedemnist", (28, 28, 1), np.float32),
                               ("fmnist", (28, 28, 1), np.uint8)):
        kw = dict(data=data, pattern_type="plus", attack="dba",
                  num_corrupt=3, poison_frac=0.5, base_class=5, seed=4,
                  data_dir=str(tmp_path))
        images = (rng.integers(0, 256, size=(5, 24) + shape).astype(dtype)
                  if dtype == np.uint8 else
                  rng.normal(size=(5, 24) + shape).astype(dtype))
        labels = rng.integers(0, 10, size=(5, 24)).astype(np.int32)
        labels[:, :6] = 5
        sizes = np.array([24, 20, 16, 24, 9])
        want = jax_poison.poison_agent_shards(images, labels, sizes,
                                              JaxConfig(**kw))
        got = poison.poison_agent_shards(images, labels, sizes, Config(**kw))
        for g, w, name in zip(got, want, ("images", "labels", "mask")):
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=f"{data} {name}")
        assert got[2][:3].sum() > 0 and not got[2][3:].any()
        # the dba rows differ from the static rows: the split is live
        static = poison.poison_agent_shards(
            images, labels, sizes, Config(**{**kw, "attack": "static"}))
        assert not np.array_equal(static[0], got[0])
        np.testing.assert_array_equal(static[2], got[2])
