"""The bucket layout of the sharded round (`--agg_layout bucket`,
parallel/buckets.py and parallel/rounds.bucketed_apply): the layout and
its flat maps against JAX's parallel/buckets.py index for index, and the
bucketed server step against the port's leaf layout on the same blocks
and against JAX's `_bucketed_apply` under a plain `jax.jit` of
`shard_map` on the faked CPU mesh.

Parity tiers, as JAX's tests/test_bucket_parity.py: the sign quantities
(the RLR vote, the sign aggregate) sum integers and are equal bit for bit
in fp32; the weighted average crosses an all_reduce on the leaf layout
and a reduce_scatter on the bucket layout, two reductions in another
order, within 1e-6 of the step's scale and one ulp of the param at d = 4
(bit for bit at d = 2, where a sum of two terms has one order); JAX's
bucketed step against the port's within the same bound. Server noise is drawn per leaf
from the round's generator: on the bucket layout it is the leaf layout's
noise, relaid. The leaf layout runs its plain step here (`--no_fused`,
JAX's unfused plan: the weighted sum divided by the total after the
reduction, as the bucket layout divides it); the fused step divides the
weights first. CNN_MNIST's leaves at 14x14, m = 8, d = 2 and 4.

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
from defending_against_backdoors_with_robust_learning_rate_tpu.parallel import (
    buckets as jax_buckets)
from defending_against_backdoors_with_robust_learning_rate_tpu.parallel.compat import (
    shard_map)
from defending_against_backdoors_with_robust_learning_rate_tpu.parallel.mesh import (
    make_mesh)
from defending_against_backdoors_with_robust_learning_rate_tpu.parallel.rounds import (
    _bucketed_apply)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    registry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.aggregate import (
    draw_noise)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel import (
    buckets, multihost)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.mesh import (
    run_in_threads)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.rounds import (
    sharded_server_path)

M = 8
MASK = np.array([1, 1, 0, 1, 0, 1, 1, 1], bool)
FIELDS = ("shapes", "sizes", "offsets", "total", "padded", "n_buckets",
          "bucket", "d", "shard", "device_len")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _shapes():
    model = registry.get_model("fmnist", (14, 14, 1))
    return {k: tuple(p.shape) for k, p in sorted(model.named_parameters())}


def test_bucket_layout_matches_jax():
    """Every field of the layout, and flatten / unflatten / device_shard /
    shard_coord_index / gathered_to_flat, equal to JAX's on an odd tree
    (105 + 13 + 4 coordinates: nothing divides d) and on CNN_MNIST's
    leaves, one bucket and many (64-byte buckets)."""
    rng = np.random.default_rng(5)
    trees = [{"a": (3, 5, 7), "b": (13,), "c": (2, 2)}, _shapes()]
    for shapes in trees:
        tree = {k: rng.normal(size=s).astype(np.float32)
                for k, s in shapes.items()}
        stacked = {k: rng.normal(size=(3,) + s).astype(np.float32)
                   for k, s in shapes.items()}
        tt = {k: torch.from_numpy(v) for k, v in tree.items()}
        ts = {k: torch.from_numpy(v) for k, v in stacked.items()}
        jt = {k: jnp.asarray(v) for k, v in tree.items()}
        js = {k: jnp.asarray(v) for k, v in stacked.items()}
        for d in (1, 2, 4, 8):
            for bucket_bytes in (0, 64):
                what = f"{list(shapes)[:2]} d={d} bytes={bucket_bytes}"
                got = buckets.layout_for_leaves(tt, d, bucket_bytes)
                want = jax_buckets.layout_for_leaves(jt, d, bucket_bytes)
                for f in FIELDS:
                    assert getattr(got, f) == getattr(want, f), (what, f)
                assert buckets.layout_for_stacked(ts, d, bucket_bytes) is got
                assert (got.n_buckets > 1) == bool(bucket_bytes), what
                flat = buckets.flatten_tree(got, tt)
                np.testing.assert_array_equal(
                    flat.numpy(),
                    np.asarray(jax_buckets.flatten_tree(want, jt)))
                np.testing.assert_array_equal(
                    buckets.flatten_stacked(got, ts).numpy(),
                    np.asarray(jax_buckets.flatten_stacked(want, js)))
                back = buckets.unflatten(got, flat, list(tt))
                for k in tt:
                    torch.testing.assert_close(back[k], tt[k], atol=0,
                                               rtol=0)
                rows = []
                for pos in range(d):
                    mine = buckets.device_shard(got, flat, pos)
                    np.testing.assert_array_equal(
                        mine.numpy(), np.asarray(jax_buckets.device_shard(
                            want, jnp.asarray(flat.numpy()), pos)))
                    np.testing.assert_array_equal(
                        buckets.shard_coord_index(got, pos).numpy(),
                        np.asarray(jax_buckets.shard_coord_index(want,
                                                                 pos)))
                    rows.append(mine)
                rows = torch.stack(rows)
                np.testing.assert_array_equal(
                    buckets.gathered_to_flat(got, rows).numpy(),
                    np.asarray(jax_buckets.gathered_to_flat(
                        want, jnp.asarray(rows.numpy()))))
                torch.testing.assert_close(
                    buckets.gathered_to_flat(got, rows), flat, atol=0,
                    rtol=0)


def _jax_bucket(jcfg, d, masked, params, updates, sizes):
    ax = "agents"

    def body(p, u, s, mloc, mfull):
        mloc, mfull = (mloc, mfull) if masked else (None, None)
        return _bucketed_apply(p, u, s, jcfg, jax.random.PRNGKey(0), d,
                               mloc, mfull)[0]
    fn = jax.jit(shard_map(body, mesh=make_mesh(d),
                           in_specs=(P(), P(ax), P(ax), P(ax), P()),
                           out_specs=P(), check_vma=False))
    mask = jnp.asarray(MASK)
    return fn({k: jnp.asarray(v) for k, v in params.items()},
              {k: jnp.asarray(v) for k, v in updates.items()},
              jnp.asarray(sizes), mask, mask)


def test_bucket_matches_leaf_and_jax():
    shapes = _shapes()
    rng = np.random.default_rng(8)
    params = {k: rng.normal(size=s).astype(np.float32) * 0.1
              for k, s in shapes.items()}
    updates = {k: rng.normal(size=(M,) + s).astype(np.float32) * 0.01
               for k, s in shapes.items()}
    sizes = rng.integers(20, 120, size=M).astype(np.int32)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    cases = [(aggr, thr, masked, noise)
             for aggr, thr in (("avg", 0), ("avg", 3), ("sign", 3))
             for masked in (False, True) for noise in (False, True)]

    def cfg_of(aggr, thr, masked, noise, layout):
        return Config(aggr=aggr, robustLR_threshold=thr, num_agents=M,
                      server_lr=0.5, noise=0.01 if noise else 0.0,
                      agg_layout=layout, use_fused=False, device="cpu",
                      health="off",
                      rlr_threshold_mode="scaled" if masked else "abs")

    for d in (2, 4):
        mb = M // d

        def rank(group):
            lo = group.rank * mb
            block = {k: torch.from_numpy(v[lo:lo + mb])
                     for k, v in updates.items()}
            out = {}
            for case in cases:
                for layout in ("leaf", "bucket"):
                    cfg = cfg_of(*case, layout)
                    # every rank draws the same noise from the same seed
                    noise = draw_noise(tp, cfg,
                                       torch.Generator().manual_seed(9))
                    group.reset_counts()
                    new, _, _, _ = sharded_server_path(
                        tp, block, torch.from_numpy(sizes[lo:lo + mb]), cfg,
                        group, noise,
                        qmask=torch.from_numpy(MASK) if case[2] else None)
                    out[case, layout] = (new, dict(group.counts))
            return out

        results = run_in_threads(d, rank)
        for case in cases:
            aggr, thr, masked, noise = case
            what = f"{case} d={d}"
            cfg = cfg_of(*case, "bucket")
            plan = multihost.plan_collectives(cfg, tp, d)
            plan["all_reduce"] -= 1     # the loss's
            for r in results:
                leaf, _ = r[case, "leaf"]
                buck, counts = r[case, "bucket"]
                assert counts == plan, (what, counts, plan)
                for k in tp:
                    if aggr == "sign" or d == 2:
                        torch.testing.assert_close(buck[k], leaf[k], atol=0,
                                                   rtol=0, msg=what)
                    else:
                        step = (leaf[k] - tp[k]).abs().max()
                        torch.testing.assert_close(
                            buck[k], leaf[k], rtol=2.0 ** -23,
                            atol=1e-6 * float(step), msg=what)
            if noise:
                continue
            jnew = _jax_bucket(JaxConfig(
                aggr=aggr, robustLR_threshold=thr, num_agents=M,
                server_lr=0.5, agg_layout="bucket",
                rlr_threshold_mode="scaled" if masked else "abs"),
                d, masked, params, updates, sizes)
            buck = results[0][case, "bucket"][0]
            for k in tp:
                want = np.asarray(jnew[k])
                if aggr == "sign":
                    np.testing.assert_array_equal(buck[k].numpy(), want,
                                                  err_msg=what)
                else:
                    # the step within 1e-6 of its scale; p + step then
                    # rounds once, to one ulp of the param
                    step = np.abs(want - params[k]).max()
                    np.testing.assert_allclose(buck[k].numpy(), want,
                                               rtol=2.0 ** -23,
                                               atol=1e-6 * step,
                                               err_msg=what)
