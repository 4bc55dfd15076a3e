"""The sharded round's robust rules (parallel/rounds.py: comed and trmean
over the all_to_all transpose, krum's chunk-partial distances, rfa's
replicated Weiszfeld iterate), unmasked and under a participation mask,
against JAX's `_sharded_aggregate` / `_sharded_robust_lr` under a plain
`jax.jit` of `shard_map` on the faked CPU mesh, and against the port's
dense server step (fl/rounds.server_terms) on the concatenated stack.

The d ranks are gloo process groups on threads of this process
(parallel/mesh.run_in_threads). CNN_MNIST's leaves at 14x14 inputs, m = 8
agents, d = 2 and 4, two of them corrupt (the trim and krum's f). Row i of
the stack is at scale 1 + i, so krum's scores stand apart and its winner is
one row on every side. Tolerances: comed, krum, the RLR lr and the sign
sums are equal as numbers; trmean and rfa sum in another order, within
1e-6 of the aggregate's scale.

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
from defending_against_backdoors_with_robust_learning_rate_tpu.parallel.compat import (
    shard_map)
from defending_against_backdoors_with_robust_learning_rate_tpu.parallel.mesh import (
    make_mesh)
from defending_against_backdoors_with_robust_learning_rate_tpu.parallel.rounds import (
    _sharded_aggregate, _sharded_robust_lr)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    registry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.aggregate import (
    apply_aggregate)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel import (
    multihost)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.mesh import (
    run_in_threads)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.rounds import (
    _rule_step)

M, F = 8, 2
RULES = ("comed", "trmean", "krum", "rfa")
EXACT = ("comed", "krum")
MASK = np.array([1, 0, 1, 1, 1, 0, 1, 1], bool)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _inputs():
    """CNN_MNIST's leaves (14x14), keyed in sorted order so that JAX's
    pytree order is the dict's; [M, ...] updates with row i at scale
    1 + i; the agents' data sizes."""
    model = registry.get_model("fmnist", (14, 14, 1))
    shapes = {k: tuple(p.shape) for k, p in sorted(model.named_parameters())}
    rng = np.random.default_rng(11)
    params = {k: rng.normal(size=s).astype(np.float32) * 0.1
              for k, s in shapes.items()}
    scale = 1.0 + np.arange(M, dtype=np.float32)
    updates = {k: (rng.normal(size=(M,) + s).astype(np.float32) * 0.01
                   * scale.reshape((-1,) + (1,) * len(s)))
               for k, s in shapes.items()}
    sizes = rng.integers(20, 120, size=M).astype(np.int32)
    return params, updates, sizes


def _cfgs(rule, thr, masked):
    kw = dict(aggr=rule, robustLR_threshold=thr, num_agents=M,
              num_corrupt=F, server_lr=0.5,
              rlr_threshold_mode="scaled" if masked else "abs")
    return JaxConfig(**kw), Config(**kw, device="cpu", health="off")


def _jax_terms(jcfg, d, masked, params, updates, sizes):
    """(lr tree or None, agg tree) of JAX's sharded body on d devices."""
    ax = "agents"
    rlr = jcfg.robustLR_threshold > 0

    def body(u, s, mloc, mfull):
        mloc, mfull = (mloc, mfull) if masked else (None, None)
        lr = (_sharded_robust_lr(u, jcfg, mloc, mfull)[0] if rlr
              else jnp.zeros(()))
        agg = _sharded_aggregate(u, s, jcfg, d, jax.random.PRNGKey(0),
                                 mloc, mfull)
        return lr, agg
    fn = jax.jit(shard_map(body, mesh=make_mesh(d),
                           in_specs=(P(ax), P(ax), P(ax), P()),
                           out_specs=P(), check_vma=False))
    mask = jnp.asarray(MASK)
    lr, agg = fn({k: jnp.asarray(v) for k, v in updates.items()},
                 jnp.asarray(sizes), mask, mask)
    return (lr if rlr else None), agg


def _close(rule, got, want, what):
    g = np.concatenate([np.asarray(got[k]).ravel() for k in sorted(got)])
    w = np.concatenate([np.asarray(want[k]).ravel() for k in sorted(want)])
    assert np.isfinite(g).all(), what
    if rule in EXACT:
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-6 * np.abs(w).max(), err_msg=what)


def test_sharded_rules_match_jax():
    params, updates, sizes = _inputs()
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    for d in (2, 4):
        mb = M // d
        cases = [(rule, thr, masked) for rule in RULES
                 for thr in (0, 3) for masked in (False, True)]

        def rank(group):
            lo = group.rank * mb
            block = {k: torch.from_numpy(v[lo:lo + mb])
                     for k, v in updates.items()}
            out = {}
            for rule, thr, masked in cases:
                cfg = _cfgs(rule, thr, masked)[1]
                mask = torch.from_numpy(MASK) if masked else None
                group.reset_counts()
                _, terms = _rule_step(
                    tp, block, torch.from_numpy(sizes[lo:lo + mb]), cfg,
                    group, None, None if mask is None else mask[lo:lo + mb],
                    mask)
                out[rule, thr, masked] = (terms, dict(group.counts))
            return out

        results = run_in_threads(d, rank)
        for rule, thr, masked in cases:
            what = f"{rule} thr={thr} masked={masked} d={d}"
            jcfg, cfg = _cfgs(rule, thr, masked)
            jlr, jagg = _jax_terms(jcfg, d, masked, params, updates, sizes)
            for terms, counts in (r[rule, thr, masked] for r in results):
                _close(rule, terms.agg, jagg, what)
                if thr:
                    # +-server_lr from integer vote sums: equal
                    for k in params:
                        np.testing.assert_array_equal(
                            terms.lr[k].numpy(), np.asarray(jlr[k]),
                            err_msg=f"{what} {k}")
                else:
                    assert terms.lr is None
                # the plan less the loss's all_reduce
                plan = multihost.plan_collectives(cfg, tp, d)
                plan["all_reduce"] -= 1
                assert counts == plan, (what, counts, plan)


def test_sharded_rules_match_dense():
    """The same blocks through the sharded step against the dense step on
    the whole stack (fl/rounds.server_terms + apply), every rule with and
    without RLR and the mask: the new params equal for comed and krum
    (the winner's row: the same index), within 1e-6 of the step's scale
    for trmean and rfa."""
    params, updates, sizes = _inputs()
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tu = {k: torch.from_numpy(v) for k, v in updates.items()}
    ts = torch.from_numpy(sizes)
    cases = [(rule, thr, masked) for rule in RULES for thr in (0, 3)
             for masked in (False, True)]
    for d in (2, 4):
        mb = M // d

        def rank(group):
            lo = group.rank * mb
            block = {k: v[lo:lo + mb] for k, v in tu.items()}
            out = {}
            for rule, thr, masked in cases:
                mask = torch.from_numpy(MASK) if masked else None
                new, _ = _rule_step(
                    tp, block, ts[lo:lo + mb], _cfgs(rule, thr, masked)[1],
                    group, None,
                    None if mask is None else mask[lo:lo + mb], mask)
                out[rule, thr, masked] = new
            return out

        results = run_in_threads(d, rank)
        for rule, thr, masked in cases:
            what = f"{rule} thr={thr} masked={masked} d={d}"
            cfg = _cfgs(rule, thr, masked)[1]
            mask = torch.from_numpy(MASK) if masked else None
            lr, agg = rounds.server_terms(tu, ts, cfg, mask=mask)
            dense = apply_aggregate(tp, lr, agg)
            step = {k: dense[k] - tp[k] for k in tp}
            for new in (r[rule, thr, masked] for r in results):
                if rule in EXACT:
                    for k in tp:
                        torch.testing.assert_close(new[k], dense[k], atol=0,
                                                   rtol=0, msg=what)
                else:
                    _close(rule, {k: new[k] - tp[k] for k in tp}, step, what)
            if rule == "krum":
                # the winner stands apart: its row, unmasked or masked
                flat = np.concatenate([updates[k].reshape(M, -1)
                                       for k in sorted(updates)], 1)
                got = np.concatenate([agg[k].numpy().ravel()
                                      for k in sorted(agg)])
                assert sum(np.array_equal(got, r) for r in flat) == 1, what
