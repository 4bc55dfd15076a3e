"""The port's packed sharded server step (parallel/rounds.sharded_partials
and sharded_server_step: every leaf's partials in one buffer, one
all_reduce) against the JAX package's step under `shard_map`, and against
the per-leaf plan it replaces (one all_reduce per partial of each leaf).

The JAX side runs its Pallas kernel in interpret mode on the CPU devices
that tests/conftest.py fakes, compiled, so the test also counts the
all-reduces XLA leaves in JAX's compiled step (its combiner merges the
per-leaf psums into one tuple all-reduce) and holds the port's count to
it. The port side runs d gloo ranks as threads of this process
(parallel/mesh.run_in_threads): no process, no port.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from defending_against_backdoors_with_robust_learning_rate_tpu.config import (
    Config as JaxConfig)
from defending_against_backdoors_with_robust_learning_rate_tpu.ops.pallas_rlr import (
    partial_vote_avg_flat as jax_partial_vote_avg_flat)
from defending_against_backdoors_with_robust_learning_rate_tpu.parallel.compat import (
    shard_map)
from defending_against_backdoors_with_robust_learning_rate_tpu.parallel.mesh import (
    AGENTS_AXIS, make_mesh)
from defending_against_backdoors_with_robust_learning_rate_tpu.parallel.rounds import (
    _sharded_pallas_apply)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops import (
    rlr_fused)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel import (
    multihost)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.mesh import (
    run_in_threads)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.rounds import (
    sharded_partials, sharded_server_step)

# one leaf of each pad (n % 4 = 1, 2, 3 and 0)
SHAPES = {"a": (17, 5), "b": (23,), "c": (3, 2, 4), "d": (6,)}
CASES = [("avg", 0), ("avg", 3), ("sign", 0), ("sign", 3)]
M = 8


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jax_sums(p, u, s):
    """JAX's partials of every leaf, psummed: (sign sums, weighted sums)."""
    del p
    w = s.astype(jnp.float32)
    wn = w / jax.lax.psum(jnp.sum(w), AGENTS_AXIS)
    out = {}
    for k, x in u.items():
        ssum, wsum = jax_partial_vote_avg_flat(x.reshape(x.shape[0], -1), wn,
                                               interpret=True)
        out[k] = (jax.lax.psum(ssum, AGENTS_AXIS),
                  jax.lax.psum(wsum, AGENTS_AXIS))
    return out


def _all_reduces(compiled) -> int:
    return sum(1 for line in compiled.as_text().splitlines()
               if re.search(r" all-reduce(-start)?\(", line))


def test_packed_step_matches_jax_and_the_per_leaf_plan():
    """At d = 2 and 4, for avg / sign with RLR on and off, fused and plain:
    the reduced sign sums equal JAX's exactly, the weighted sums and the new
    params are within 1e-6; the packed buffer agrees with the per-leaf
    plan's all_reduces (sign sums exactly); and the step makes as many
    all_reduces as JAX's compiled step, the round's plan less the loss's
    one."""
    rng = np.random.default_rng(11)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    updates = {k: rng.normal(size=(M,) + s).astype(np.float32)
               for k, s in SHAPES.items()}
    updates["b"][:, :3] = 0.0               # zero votes in one leaf
    sizes = rng.integers(10, 100, size=(M,)).astype(np.int32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ju = {k: jnp.asarray(v) for k, v in updates.items()}
    js = jnp.asarray(sizes)
    specs = (P(), P("agents"), P("agents"))
    for d in (2, 4):
        mb = M // d
        mesh = make_mesh(d)
        sums = jax.jit(shard_map(_jax_sums, mesh=mesh, in_specs=specs,
                                 out_specs=P(), check_vma=False))(jp, ju, js)
        want, jax_calls = {}, {}
        for aggr, thr in CASES:
            jcfg = JaxConfig(aggr=aggr, robustLR_threshold=thr,
                             server_lr=0.3)
            step = jax.jit(shard_map(
                lambda p, u, s, jcfg=jcfg: _sharded_pallas_apply(p, u, s,
                                                                 jcfg),
                mesh=mesh, in_specs=specs, out_specs=P(), check_vma=False))
            compiled = step.lower(jp, ju, js).compile()
            jax_calls[aggr, thr] = _all_reduces(compiled)
            want[aggr, thr] = compiled(jp, ju, js)

        def rank(group):
            lo = group.rank * mb
            tp = {k: torch.from_numpy(v) for k, v in params.items()}
            tu = {k: torch.from_numpy(v[lo:lo + mb])
                  for k, v in updates.items()}
            ts = torch.from_numpy(sizes[lo:lo + mb])
            # the per-leaf plan: both partials of every leaf, an
            # all_reduce each
            w = ts.to(torch.float32)
            wn = w / group.all_reduce_sum_(torch.sum(w).reshape(1))
            per_leaf = {}
            for k, u in tu.items():
                s, a = rlr_fused.partial_vote_avg_flat(u.view(mb, -1), wn)
                per_leaf[k] = (group.all_reduce_sum_(s),
                               group.all_reduce_sum_(a))
            out = {}
            for aggr, thr in CASES:
                for fused in (True, False):
                    cfg = Config(aggr=aggr, robustLR_threshold=thr,
                                 server_lr=0.3, use_fused=fused,
                                 device="cpu")
                    before = group.calls
                    plan, buf = sharded_partials(tp, tu, ts, cfg, group)
                    partial_calls = group.calls - before
                    new = sharded_server_step(tp, tu, ts, cfg, group)
                    out[aggr, thr, fused] = (
                        plan, buf.clone(), partial_calls,
                        group.calls - before - partial_calls,
                        {k: v.numpy() for k, v in new.items()})
            return per_leaf, out

        for r, (per_leaf, out) in enumerate(run_in_threads(d, rank)):
            for (aggr, thr, fused), (plan, buf, calls, step_calls,
                                     new) in out.items():
                what = f"d={d} {aggr} thr={thr} fused={fused} rank={r}"
                cfg = Config(aggr=aggr, robustLR_threshold=thr,
                             device="cpu")
                # JAX's compiled count, fused and plain alike: one packed
                # all_reduce, and the weight total for avg
                assert calls == step_calls == jax_calls[aggr, thr] == (
                    multihost.leaf_plan_collectives(cfg) - 1), what
                for k, o, n in zip(SHAPES, plan.offsets, plan.numels):
                    js_, jw_ = (np.asarray(x) for x in sums[k])
                    ps_, pw_ = (x.numpy() for x in per_leaf[k])
                    if plan.sign:
                        got = buf[plan.width + o:plan.width + o + n].numpy()
                        # sums of +-1 and 0: exact
                        np.testing.assert_array_equal(got, js_, err_msg=what)
                        np.testing.assert_array_equal(got, ps_, err_msg=what)
                    if plan.wsum:
                        got = buf[o:o + n].numpy()
                        # f32, summation order only: 1e-6
                        np.testing.assert_allclose(got, jw_, atol=1e-6,
                                                   rtol=1e-6, err_msg=what)
                        if fused:
                            # the same partials, reduced in one call
                            # instead of one per leaf: gloo sums each chunk
                            # of a buffer in a rank order set by the
                            # chunk's place, so above d = 2 an f32 sum may
                            # round the other way: 1e-6
                            np.testing.assert_allclose(got, pw_, atol=1e-6,
                                                       rtol=1e-6,
                                                       err_msg=what)
                    # f32, summation order only: 1e-6
                    np.testing.assert_allclose(
                        new[k], np.asarray(want[aggr, thr][k]), atol=1e-6,
                        rtol=1e-6, err_msg=f"{what} {k}")
