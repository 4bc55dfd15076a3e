"""The port's plain server rules (ops/aggregate.py) and client optimizer ops
(ops/sgd.py) against the JAX package's, on identical numpy inputs; and the
fused kernel wrapper's argument checks.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu.config import (
    Config as JaxConfig)
from defending_against_backdoors_with_robust_learning_rate_tpu.ops import (
    aggregate as jax_aggregate, sgd as jax_sgd)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops import (
    aggregate, rlr_fused, sgd)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _tree(rng, shapes, lead=()):
    return {k: rng.normal(size=lead + s).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"k": (40, 3), "b": (3,), "c": (2, 3, 4)}


def test_server_rules_match_jax():
    """robust_lr + aggregate + apply (the fallback server step) vs the JAX
    ops/aggregate.py, and the fused step's plain version vs both."""
    rng = np.random.default_rng(2)
    m = 5
    params, updates = _tree(rng, SHAPES), _tree(rng, SHAPES, (m,))
    sizes = rng.integers(10, 100, size=(m,)).astype(np.int32)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tu = {k: torch.from_numpy(v) for k, v in updates.items()}
    ju = {k: jnp.asarray(v) for k, v in updates.items()}
    for aggr in ("avg", "sign"):
        for thr in (0, 3):
            jcfg = JaxConfig(aggr=aggr, robustLR_threshold=thr, server_lr=0.3)
            cfg = Config(aggr=aggr, robustLR_threshold=thr, server_lr=0.3)
            assert cfg.effective_server_lr == jcfg.effective_server_lr
            slr = cfg.effective_server_lr
            jagg = jax_aggregate.aggregate_updates(ju, jnp.asarray(sizes),
                                                   jcfg, None)
            jlr = jax_aggregate.robust_lr(ju, float(thr), slr) if thr else slr
            want = jax_aggregate.apply_aggregate(
                {k: jnp.asarray(v) for k, v in params.items()}, jlr, jagg)

            tagg = aggregate.aggregate_updates(tu, torch.from_numpy(sizes),
                                               cfg)
            tlr = aggregate.robust_lr(tu, float(thr), slr) if thr else slr
            got = aggregate.apply_aggregate(tp, tlr, tagg)
            fused = rlr_fused.fused_rlr_avg_apply(
                tp, tu, torch.from_numpy(sizes).float(), float(thr), slr,
                mode=aggr)
            for k in params:
                if thr:
                    # the vote: exact
                    np.testing.assert_array_equal(tlr[k].numpy(),
                                                  np.asarray(jlr[k]))
                # f32, summation order only: 1e-6
                np.testing.assert_allclose(
                    got[k].numpy(), np.asarray(want[k]), atol=1e-6,
                    rtol=1e-6, err_msg=f"{aggr} thr={thr} {k}")
                np.testing.assert_allclose(
                    fused[k].numpy(), got[k].numpy(), atol=1e-6, rtol=1e-6,
                    err_msg=f"fused {aggr} thr={thr} {k}")
    with pytest.raises(ValueError, match="unknown aggr"):
        aggregate.aggregate_updates(tu, torch.from_numpy(sizes),
                                    Config(aggr="median"))


def test_client_optimizer_ops_match_jax():
    """clip_by_global_norm, the masked sgd_momentum_step (valid=False is an
    exact no-op, as a bool or as a 0-d tensor) and pgd_project."""
    rng = np.random.default_rng(5)
    p, mom, g, p0 = (_tree(rng, SHAPES) for _ in range(4))
    big = {k: 10.0 * v for k, v in g.items()}       # norm well above 10
    j = lambda t: {k: jnp.asarray(v) for k, v in t.items()}  # noqa: E731
    t = lambda t: {k: torch.from_numpy(v) for k, v in t.items()}  # noqa: E731

    for grads in (g, big):
        want = jax_sgd.clip_by_global_norm(j(grads), 10.0)
        got = sgd.clip_by_global_norm(t(grads), 10.0)
        for k in SHAPES:
            # f32 norm in another summation order: 1e-6 relative
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)

    want_p, want_m = jax_sgd.sgd_momentum_step(j(p), j(mom), j(g), 0.1, 0.9,
                                               jnp.bool_(True))
    for valid in (True, torch.tensor(True)):
        got_p, got_m = sgd.sgd_momentum_step(t(p), t(mom), t(g), 0.1, 0.9,
                                             valid)
        for k in SHAPES:
            # elementwise f32 arithmetic in the same order: 1 ulp
            np.testing.assert_allclose(got_p[k].numpy(), np.asarray(want_p[k]),
                                       rtol=2e-7, atol=0)
            np.testing.assert_allclose(got_m[k].numpy(), np.asarray(want_m[k]),
                                       rtol=2e-7, atol=0)
    for valid in (False, torch.tensor(False)):
        got_p, got_m = sgd.sgd_momentum_step(t(p), t(mom), t(g), 0.1, 0.9,
                                             valid)
        for k in SHAPES:
            # a masked step leaves params and momentum bit for bit
            np.testing.assert_array_equal(got_p[k].numpy(), p[k])
            np.testing.assert_array_equal(got_m[k].numpy(), mom[k])

    for clip in (0.5, 1e3):     # projecting, and inside the ball
        want = jax_sgd.pgd_project(j(p), j(p0), clip)
        got = sgd.pgd_project(t(p), t(p0), clip)
        for k in SHAPES:
            # f32 norm in another summation order: 1e-6 relative
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-6)
