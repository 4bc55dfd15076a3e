"""The participation mask on the sharded round (parallel/rounds.py): the
fault draw taken block by block, the one all_gather of the payload
validity bits, the quarantine set and the churn and traffic presence
ANDed in, the mask-aware RLR vote; against the port's dense round fed the
same draws, and the masks and the vote against JAX's sharded body under a
plain `jax.jit` of `shard_map` on the faked CPU mesh.

Every rank draws the round's fault draw from the same RoundRNG as the
dense round (fl/rounds.draw_faults_host), so the two rounds see one draw.
CNN_MNIST at 14x14 inputs, m = 8 of 8 agents, d = 2 and 4, two rounds.
Tolerances: the masks, the Faults/* and Churn/* values and the RLR lr are
equal; the params within 1e-5 (the server step's sums in another order),
the mean loss 1e-4, the health lanes 1e-5.

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
from defending_against_backdoors_with_robust_learning_rate_tpu.faults import (
    model as jax_fmodel)
from defending_against_backdoors_with_robust_learning_rate_tpu.parallel.compat import (
    shard_map)
from defending_against_backdoors_with_robust_learning_rate_tpu.parallel.mesh import (
    make_mesh)
from defending_against_backdoors_with_robust_learning_rate_tpu.parallel.rounds import (
    _sharded_robust_lr, _sharded_sign_shared)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.faults import (
    model as fmodel)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    common, rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    registry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel import (
    multihost)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.mesh import (
    run_in_threads)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.rounds import (
    _packed_step, _participation, _rule_step, make_sharded_round_fn)

SHAPE = (14, 14, 1)
M, BS, N_TOTAL = 8, 32, 64
FAULTS = dict(dropout_rate=0.3, straggler_rate=0.4, straggler_epochs=1,
              corrupt_rate=0.25, corrupt_mode="nan", payload_norm_cap=50.0,
              faults_spare_corrupt=False)
KW = dict(data="fmnist", num_agents=M, bs=BS, local_ep=2, client_lr=0.1,
          client_moment=0.9, device="cpu", num_corrupt=2,
          robustLR_threshold=2, rlr_threshold_mode="scaled")
ROWS = ("fault_dropped", "fault_straggled", "fault_voters", "churn_away")
HEALTH = ("hlth_nonfinite", "hlth_params_finite", "hlth_update_normsq")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _data():
    rng = np.random.default_rng(4)
    xs = torch.from_numpy(rng.uniform(0, 255, size=(M, N_TOTAL) + SHAPE)
                          .astype(np.float32))
    ys = torch.from_numpy(rng.integers(0, 10, size=(M, N_TOTAL)))
    sizes = rng.integers(33, N_TOTAL + 1, size=M).astype(np.int32)
    return xs, ys, sizes


def test_sharded_mask_rounds_match_dense():
    """Two rounds under dropout, stragglers, NaN payloads, a payload cap,
    a quarantine set and churn (avg + scaled RLR; comed; sign + RLR on
    the bucket layout), and under diurnal traffic (krum), on d ranks
    against the dense round with the same seed."""
    xs, ys, sizes = _data()
    model = registry.get_model("fmnist", SHAPE)
    norm = common.make_normalizer((0.5,), (0.5,), "cpu")
    params = registry.init_params(model, 3, "cpu")
    churn = dict(churn_available=0.6, churn_period=1, quarantine="1")
    cases = {
        "avg": Config(**KW, **FAULTS, **churn),
        "comed": Config(**KW, **FAULTS, **churn, aggr="comed"),
        "sign_bucket": Config(**KW, **FAULTS, **churn, aggr="sign",
                              server_lr=0.5, agg_layout="bucket"),
        "krum_traffic": Config(**KW, **FAULTS, aggr="krum",
                               traffic="diurnal", traffic_day_rounds=3),
    }
    for name, cfg in cases.items():
        dense_fn = rounds.make_round_fn(cfg, model, norm, xs, ys, sizes)
        rng = rounds.RoundRNG(5, "cpu")
        dense, p = [], params
        for _ in range(2):
            p, info = dense_fn(p, rng)
            dense.append(({k: v.clone() for k, v in p.items()}, info))
        # the draw is not trivial: someone dropped, straggled, was
        # rejected or away in one of the rounds
        assert any(float(i["fault_voters"]) < M for _, i in dense), name
        assert any(float(i["fault_straggled"]) > 0 for _, i in dense), name

        def rank(group, cfg=cfg):
            fn = make_sharded_round_fn(cfg, registry.get_model("fmnist",
                                                               SHAPE),
                                       norm, group, xs, ys, sizes)
            rng, p, out = rounds.RoundRNG(5, "cpu"), params, []
            for _ in range(2):
                group.reset_counts()
                p, info = fn(p, rng)
                out.append((p, info, dict(group.counts)))
            return out

        for d in (2, 4):
            plan = multihost.plan_collectives(cfg, params, d)
            for out in run_in_threads(d, rank):
                for r, ((dp, di), (sp, si, counts)) in enumerate(
                        zip(dense, out)):
                    what = f"{name} d={d} round {r + 1}"
                    assert counts == plan, (what, counts, plan)
                    for k in ROWS:
                        assert (k in si) == (k in di), (what, k)
                        if k in di:
                            assert float(si[k]) == float(di[k]), (what, k)
                    for k in params:
                        np.testing.assert_allclose(
                            sp[k].numpy(), dp[k].numpy(), atol=1e-5,
                            rtol=1e-5, err_msg=f"{what} {k}")
                    np.testing.assert_allclose(float(si["train_loss"]),
                                               float(di["train_loss"]),
                                               rtol=1e-4, err_msg=what)
                    for k in HEALTH:
                        np.testing.assert_allclose(float(si[k]),
                                                   float(di[k]), rtol=1e-5,
                                                   err_msg=f"{what} {k}")


def test_sharded_masks_and_vote_match_jax():
    """One block of updates per rank: the port's mask (fault draw, the
    injected NaN payloads, the payload cap, the validity all_gather, the
    quarantine AND) and Faults/* values against JAX's sharded body's
    pieces; then the mask-aware RLR lr against JAX's `_sharded_robust_lr`
    (avg, comed) and `_sharded_sign_shared` (sign), abs and scaled, on
    the same masks, an all-invalid mask among them."""
    rng = np.random.default_rng(2)
    shapes = {"a": (6, 5), "b": (11,), "c": (3, 2, 2)}
    updates = {k: rng.normal(size=(M,) + s).astype(np.float32)
               for k, s in shapes.items()}
    updates["a"][6] *= 40.0             # over the payload cap
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    sizes = rng.integers(10, 50, size=M).astype(np.int32)
    draw_np = dict(participate=np.array([1, 1, 0, 1, 1, 1, 0, 1], bool),
                   straggler=np.zeros(M, bool),
                   ep_budget=np.full(M, 2, np.int32),
                   corrupt=np.array([0, 0, 0, 1, 0, 0, 0, 0], bool))
    qmask = np.array([1, 1, 1, 1, 0, 1, 1, 1], bool)
    cap = 30.0
    ax = "agents"
    masks = [np.array([1, 0, 1, 1, 0, 1, 1, 0], bool), np.zeros(M, bool),
             np.ones(M, bool)]
    for d in (2, 4):
        mb = M // d
        jcfg = JaxConfig(corrupt_rate=0.5, corrupt_mode="nan",
                         payload_norm_cap=cap)

        def jbody(u, participate, corrupt):
            pos = jax.lax.axis_index(ax) * mb
            u = jax_fmodel.inject_corrupt(
                u, jax.lax.dynamic_slice_in_dim(corrupt, pos, mb, 0), "nan")
            valid = jax.lax.all_gather(
                jax_fmodel.payload_valid(u, cap), ax, axis=0, tiled=True)
            return participate & valid
        jmask = np.asarray(jax.jit(shard_map(
            jbody, mesh=make_mesh(d), in_specs=(P(ax), P(), P()),
            out_specs=P(), check_vma=False))(
                {k: jnp.asarray(v) for k, v in updates.items()},
                jnp.asarray(draw_np["participate"]),
                jnp.asarray(draw_np["corrupt"]))) & qmask
        jdraw = jax_fmodel.FaultDraw(**{k: jnp.asarray(v)
                                        for k, v in draw_np.items()})
        jscal = jax_fmodel.fault_scalars(jdraw, jnp.asarray(jmask))
        assert not jmask[3] and not jmask[6] and not jmask[4] and jmask[0]

        cases = [(aggr, mode, i) for aggr in ("avg", "comed", "sign")
                 for mode in ("abs", "scaled") for i in range(len(masks))]

        def rank(group):
            lo = group.rank * mb
            block = {k: torch.from_numpy(v[lo:lo + mb])
                     for k, v in updates.items()}
            cfg = Config(corrupt_rate=0.5, corrupt_mode="nan",
                         payload_norm_cap=cap, num_agents=M, device="cpu")
            draw = fmodel.FaultDraw(**{k: torch.from_numpy(v)
                                       for k, v in draw_np.items()})
            _, mask, mask_local, info = _participation(
                cfg, group, block, draw, torch.from_numpy(qmask))
            assert torch.equal(mask_local, mask[lo:lo + mb])
            out = {"mask": mask.numpy(), "info": {k: float(v) for k, v in
                                                  info.items()}}
            tp = {k: torch.from_numpy(v) for k, v in params.items()}
            for aggr, mode, i in cases:
                c = Config(aggr=aggr, robustLR_threshold=3, num_agents=M,
                           rlr_threshold_mode=mode, server_lr=0.5,
                           device="cpu")
                mf = torch.from_numpy(masks[i])
                step = _rule_step if aggr == "comed" else _packed_step
                _, terms = step(tp, block,
                                torch.from_numpy(sizes[lo:lo + mb]), c,
                                group, None, mf[lo:lo + mb], mf)
                out[aggr, mode, i] = {k: v.numpy().copy()
                                      for k, v in terms.lr.items()}
            return out

        results = run_in_threads(d, rank)
        for out in results:
            np.testing.assert_array_equal(out["mask"], jmask)
            assert out["info"] == {k: float(v) for k, v in jscal.items()}
        for aggr, mode, i in cases:
            jc = JaxConfig(aggr=aggr, robustLR_threshold=3, num_agents=M,
                           rlr_threshold_mode=mode, server_lr=0.5)
            if aggr == "sign":
                def body(u, ml, mf, jc=jc):
                    return _sharded_sign_shared(u, jc, None, ml, mf)[0]
            else:
                def body(u, ml, mf, jc=jc):
                    return _sharded_robust_lr(u, jc, ml, mf)[0]
            mask = jnp.asarray(masks[i])
            jlr = jax.jit(shard_map(body, mesh=make_mesh(d),
                                    in_specs=(P(ax), P(ax), P()),
                                    out_specs=P(), check_vma=False))(
                {k: jnp.asarray(v) for k, v in updates.items()}, mask, mask)
            for out in results:
                for k in shapes:
                    np.testing.assert_array_equal(
                        out[aggr, mode, i][k], np.asarray(jlr[k]),
                        err_msg=f"{aggr} {mode} mask {i} d={d} {k}")
