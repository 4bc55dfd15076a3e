"""The port's sharded server step against the JAX package's: K2's plain
version against JAX's `partial_vote_avg_flat`, and the whole step on d
ranks against JAX's `_sharded_pallas_apply` under `shard_map`.

The JAX side runs its Pallas kernel in interpret mode on the 8 CPU devices
that tests/conftest.py fakes; the port side runs d gloo ranks as threads of
this process (parallel/mesh.run_in_threads), so no process is spawned and
no port is opened. On the CPU the port's K2 wrapper runs its plain
version; tests/test_torch_kernel_partial.py holds the CUDA kernel to it on
the card.

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
from defending_against_backdoors_with_robust_learning_rate_tpu.ops.pallas_rlr import (
    partial_vote_avg_flat as jax_partial_vote_avg_flat)
from defending_against_backdoors_with_robust_learning_rate_tpu.parallel.compat import (
    shard_map)
from defending_against_backdoors_with_robust_learning_rate_tpu.parallel.mesh import (
    make_mesh)
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
    sharded_server_step)

# the three (m, n, threshold) cases of tests/test_pallas.py
PALLAS_CASES = [(4, 300, 3.0), (10, 5000, 4.0), (7, 1111, 0.0)]
SHAPES = {"a": (17, 5), "b": (23,), "c": (3, 2, 4)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_partial_plain_version_matches_pallas():
    before = rlr_fused.LAUNCHES["rlr_partial"]
    for m, n, _ in PALLAS_CASES:
        rng = np.random.default_rng(m)
        u = rng.normal(size=(m, n)).astype(np.float32)
        u[0, :7] = 0.0                  # sign(0) = 0 votes for neither side
        w = rng.uniform(1, 5, size=(m,)).astype(np.float32)
        wn = w / w.sum()
        want_s, want_w = jax_partial_vote_avg_flat(
            jnp.asarray(u), jnp.asarray(wn), interpret=True)
        got_s, got_w = rlr_fused.partial_vote_avg_flat(torch.from_numpy(u),
                                                       torch.from_numpy(wn))
        # the sign sum is integer arithmetic on signs: exact
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
        # f32, summation order only: 1e-6
        np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w),
                                   atol=1e-6, rtol=1e-6, err_msg=f"{m, n}")
    # a CPU tensor takes the plain version and counts no launch
    assert rlr_fused.LAUNCHES["rlr_partial"] == before
    with pytest.raises(ValueError):
        rlr_fused.partial_vote_avg_flat(torch.zeros(3, 4), torch.ones(2))


def test_sharded_server_step_matches_jax():
    """K2 + all_reduce + apply on d ranks (and the plain step, --no_fused)
    vs JAX's sharded Pallas step, on the same updates and sizes, for
    d in {2, 4, 8} and avg/sign x RLR on/off."""
    m = 8
    rng = np.random.default_rng(7)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    updates = {k: rng.normal(size=(m,) + s).astype(np.float32)
               for k, s in SHAPES.items()}
    updates["b"][:, :3] = 0.0           # zero votes in one leaf
    sizes = rng.integers(10, 100, size=(m,)).astype(np.int32)
    for d in (2, 4, 8):
        mb = m // d
        jfn = {}
        for aggr in ("avg", "sign"):
            for thr in (0, 3):
                jcfg = JaxConfig(aggr=aggr, robustLR_threshold=thr,
                                 server_lr=0.3)
                step = jax.jit(shard_map(
                    lambda p, u, s, jcfg=jcfg: _sharded_pallas_apply(
                        p, u, s, jcfg),
                    mesh=make_mesh(d), in_specs=(P(), P("agents"),
                                                 P("agents")),
                    out_specs=P(), check_vma=False))
                jfn[aggr, thr] = step(
                    {k: jnp.asarray(v) for k, v in params.items()},
                    {k: jnp.asarray(v) for k, v in updates.items()},
                    jnp.asarray(sizes))

        def rank(group):
            lo = group.rank * mb
            out = {}
            for (aggr, thr) in jfn:
                for fused in (True, False):
                    cfg = Config(aggr=aggr, robustLR_threshold=thr,
                                 server_lr=0.3, use_fused=fused,
                                 device="cpu")
                    before = group.calls
                    new = sharded_server_step(
                        {k: torch.from_numpy(v) for k, v in params.items()},
                        {k: torch.from_numpy(v[lo:lo + mb])
                         for k, v in updates.items()},
                        torch.from_numpy(sizes[lo:lo + mb]), cfg, group)
                    # the round's plan, less the loss all_reduce
                    assert group.calls - before == (
                        multihost.leaf_plan_collectives(cfg) - 1)
                    out[aggr, thr, fused] = {k: v.numpy()
                                             for k, v in new.items()}
            return out

        results = run_in_threads(d, rank)
        for key, want in jfn.items():
            for fused in (True, False):
                for r, got in enumerate(results):
                    for k in SHAPES:
                        # f32, summation order only (partials, then the
                        # all_reduce): 1e-5; the vote is exact
                        np.testing.assert_allclose(
                            got[key + (fused,)][k], np.asarray(want[k]),
                            atol=1e-5, rtol=1e-5,
                            err_msg=f"d={d} {key} fused={fused} rank={r} "
                                    f"{k}")
