"""The port's sharded round (parallel/rounds.py) against its dense round
(fl/rounds.py, which tests/test_torch_round.py holds against JAX), and its
health lanes (health/sentinel.py) against the JAX package's.

The d ranks are gloo process groups on threads of this process
(parallel/mesh.run_in_threads): no process, no port. The round test is
JAX's tests/test_parallel.py::test_sharded_round_matches_vmap_round carried
over: the same sampled ids and epoch permutations injected, dropout off;
and then the draws left to the run's seed with dropout on, where the
per-slot generators (fl/rounds.RoundRNG.slot) make every d draw what the
dense round draws. CNN_MNIST at 14x14 inputs, as in test_torch_round.py.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from defending_against_backdoors_with_robust_learning_rate_tpu.config import (
    Config as JaxConfig)
from defending_against_backdoors_with_robust_learning_rate_tpu.health import (
    sentinel as jax_sentinel)
from defending_against_backdoors_with_robust_learning_rate_tpu.parallel.compat import (
    shard_map)
from defending_against_backdoors_with_robust_learning_rate_tpu.parallel.mesh import (
    make_mesh)
from defending_against_backdoors_with_robust_learning_rate_tpu.parallel.rounds import (
    _loss_and_health as jax_loss_and_health)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    common, rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.health import (
    sentinel)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    registry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel import (
    multihost)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.mesh import (
    run_in_threads)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.rounds import (
    _loss_and_health, make_sharded_round_fn)

SHAPE = (14, 14, 1)
BS, N_TOTAL = 32, 96
SIZES = [96, 80, 65, 33]    # full / partial / partial / fully padded batches
SAMPLED = [2, 0, 3, 1]      # slot order differs from agent order
KW = dict(data="fmnist", num_agents=4, bs=BS, local_ep=2, client_lr=0.1,
          client_moment=0.9, device="cpu")
HEALTH = ("hlth_nonfinite", "hlth_params_finite", "hlth_update_normsq")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _data():
    rng = np.random.default_rng(42)
    xs = torch.from_numpy(rng.uniform(0, 255, size=(len(SIZES), N_TOTAL)
                                      + SHAPE).astype(np.float32))
    ys = torch.from_numpy(rng.integers(0, 10, size=(len(SIZES), N_TOTAL)))
    perms = [[torch.from_numpy(np.concatenate([
        rng.permutation(SIZES[a]), np.arange(SIZES[a], N_TOTAL)]))
        for _ in range(KW["local_ep"])] for a in SAMPLED]
    return xs, ys, perms


def test_sharded_round_matches_dense_round():
    xs, ys, perms = _data()
    sizes = np.asarray(SIZES, np.int32)
    model = registry.get_model("fmnist", SHAPE)
    norm = common.make_normalizer((0.5,), (0.5,), "cpu")
    params = registry.init_params(model, 3, "cpu")
    cases = [  # (aggr, thr, fused, injected draws)
        ("avg", 3, True, True), ("sign", 2, False, True),
        ("avg", 2, True, False)]
    for aggr, thr, fused, injected in cases:
        cfg = Config(**KW, aggr=aggr, robustLR_threshold=thr, server_lr=0.5,
                     use_fused=fused)
        kw = (dict(sampled=SAMPLED, perms=perms, dropout=False) if injected
              else {})
        dense, dinfo = rounds.make_round_fn(cfg, model, norm, xs, ys, sizes)(
            params, rounds.RoundRNG(5, "cpu"), **kw)

        def rank(group, cfg=cfg, kw=kw):
            # a module of its own: functional_call swaps its parameters
            round_fn = make_sharded_round_fn(
                cfg, registry.get_model("fmnist", SHAPE), norm, group, xs,
                ys, sizes)
            before = group.calls
            new, info = round_fn(params, rounds.RoundRNG(5, "cpu"), **kw)
            return new, info, group.calls - before

        for d in ((2, 4) if injected else (2,)):
            what = f"{aggr} thr={thr} fused={fused} injected={injected} d={d}"
            for new, info, calls in run_in_threads(d, rank):
                assert info["sampled"] == dinfo["sampled"], what
                # the plan: 3 all_reduces for avg (+ RLR), 2 for sign,
                # fused and plain alike
                assert calls == multihost.leaf_plan_collectives(cfg), what
                for k in params:
                    # the same local training; the server step's sums in
                    # another order (partials, then the all_reduce): 1e-5
                    np.testing.assert_allclose(
                        new[k].numpy(), dense[k].numpy(), atol=1e-5,
                        rtol=1e-5, err_msg=f"{what} {k}")
                # the mean loss as a sum of block means over d: 1e-4
                np.testing.assert_allclose(float(info["train_loss"]),
                                           float(dinfo["train_loss"]),
                                           rtol=1e-4, err_msg=what)
                # the same lanes, packed into the loss all_reduce
                for k in HEALTH:
                    np.testing.assert_allclose(float(info[k]),
                                               float(dinfo[k]), rtol=1e-5,
                                               err_msg=f"{what} {k}")
        assert float(dinfo["hlth_update_normsq"]) > 0
        assert "hlth_agent_bad" in dinfo


def test_health_lanes_match_jax():
    """The dense lanes against JAX's sentinel, and the sharded [3] packing
    at d = 4 against JAX's _loss_and_health under shard_map, on updates
    with nonfinite rows; then the host EMA helpers."""
    m, d = 8, 4
    shapes = {"a": (6, 5), "b": (7,)}
    rng = np.random.default_rng(3)
    updates = {k: rng.normal(size=(m,) + s).astype(np.float32)
               for k, s in shapes.items()}
    updates["a"][1, 2, 3] = np.nan
    updates["b"][5, 0] = np.inf
    updates["b"][1, 1] = -np.inf
    losses = rng.uniform(0.5, 2.0, size=(m,)).astype(np.float32)
    for bad_param in (False, True):
        params = {k: rng.normal(size=s).astype(np.float32)
                  for k, s in shapes.items()}
        if bad_param:
            params["b"][2] = np.nan
        jcfg = JaxConfig()
        cfg = Config(device="cpu")
        assert jcfg.health == cfg.health == "on"
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        ju = {k: jnp.asarray(v) for k, v in updates.items()}
        tp = {k: torch.from_numpy(v) for k, v in params.items()}
        tu = {k: torch.from_numpy(v) for k, v in updates.items()}

        want = jax_sentinel.sentinel(jcfg, ju, jp)
        got = sentinel.sentinel(cfg, tu, tp)
        assert set(got) == set(want) == set(sentinel.health_keys(cfg))
        np.testing.assert_array_equal(got["hlth_agent_bad"].numpy(),
                                      np.asarray(want["hlth_agent_bad"]))
        assert float(got["hlth_nonfinite"]) == float(want["hlth_nonfinite"])
        assert float(got["hlth_nonfinite"]) == 2.0
        assert (float(got["hlth_params_finite"])
                == float(want["hlth_params_finite"]) == float(not bad_param))
        # f32 sum of squares in another order: 1e-6 relative
        np.testing.assert_allclose(float(got["hlth_update_normsq"]),
                                   float(want["hlth_update_normsq"]),
                                   rtol=1e-6)

        jloss, jextras = jax.jit(shard_map(
            lambda lo, u, p: jax_loss_and_health(jcfg, lo, u, p, None, d),
            mesh=make_mesh(d), in_specs=(P("agents"), P("agents"), P()),
            out_specs=(P(), {k: P() for k in HEALTH}), check_vma=False))(
                jnp.asarray(losses), ju, jp)
        mb = m // d

        def rank(group, tp=tp):
            lo = group.rank * mb
            out = {}
            for level in ("on", "off"):
                before = group.calls
                loss, extras = _loss_and_health(
                    Config(device="cpu", health=level),
                    torch.from_numpy(losses[lo:lo + mb]),
                    {k: v[lo:lo + mb] for k, v in tu.items()}, tp, group)
                # a [3] or a scalar: one all_reduce either way
                assert group.calls - before == 1
                out[level] = (float(loss), {k: float(v)
                                            for k, v in extras.items()})
            return out

        for out in run_in_threads(d, rank):
            assert out["off"][1] == {}
            # a pmean over d block means, in another order: 1e-6
            for level in ("on", "off"):
                np.testing.assert_allclose(out[level][0], float(jloss),
                                           rtol=1e-6)
            assert set(out["on"][1]) == set(jextras)
            for k in HEALTH:
                np.testing.assert_allclose(out["on"][1][k],
                                           float(jextras[k]), rtol=1e-6,
                                           err_msg=k)

    # the host EMA helpers, on states inside and past the warmup
    for n in (0, 2, 3, 7):
        state = dict(jax_sentinel.ema_init(), n=n, loss_ema=1.2,
                     loss_var=0.04, norm_ema=3.0)
        assert sentinel.ema_init() == jax_sentinel.ema_init()
        for loss in (0.9, 1.5, float("nan")):
            assert sentinel.loss_z(state, loss) == jax_sentinel.loss_z(
                state, loss)
        for norm in (2.0, 9.5, float("inf")):
            assert (sentinel.norm_spike(state, norm, 3.0)
                    == jax_sentinel.norm_spike(state, norm, 3.0))
