"""The port's fused RLR server step (ops/rlr_fused.py) against the JAX
package's Pallas kernel.

The JAX side runs the Pallas kernel as tests/test_pallas.py does, in
interpret mode on the CPU. On the CPU the port's wrapper runs its plain
PyTorch version, so these tests hold that version (the kernel's oracle) to
the JAX kernel; tests/test_torch_kernel_args.py holds the CUDA kernel to
the plain version on the card.

Each test_torch_* file keeps to at most two tests and loops over its cases:
pytest-xdist's --dist loadfile queues files by descending test count, so
small files queue after every JAX test file and leave the JAX files'
assignment to workers as it was.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu.ops import (
    aggregate as jax_aggregate)
from defending_against_backdoors_with_robust_learning_rate_tpu.ops.pallas_rlr import (
    fused_rlr_avg_apply, fused_rlr_avg_apply_flat)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops import (
    aggregate, rlr_fused)

# the three (m, n, threshold) cases of tests/test_pallas.py
PALLAS_CASES = [(4, 300, 3.0), (10, 5000, 4.0), (7, 1111, 0.0)]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _inputs(seed, m, n):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(m, n)).astype(np.float32)
    w = rng.uniform(1, 5, size=(m,)).astype(np.float32)
    p = rng.normal(size=(n,)).astype(np.float32)
    return u, w, p


def test_plain_version_matches_pallas():
    for m, n, thr in PALLAS_CASES:
        u, w, p = _inputs(0, m, n)
        for mode, slr in (("avg", 1.0), ("sign", 0.05)):
            want = np.asarray(fused_rlr_avg_apply_flat(
                jnp.asarray(p), jnp.asarray(u), jnp.asarray(w), thr, slr,
                interpret=True, mode=mode))
            got = rlr_fused.fused_rlr_avg_apply_flat(
                torch.from_numpy(p), torch.from_numpy(u), torch.from_numpy(w),
                thr, slr, mode=mode).numpy()
            # f32, summation order only: 1e-5 absolute and relative
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5,
                                       err_msg=f"{(m, n, thr, mode)}")
        # the vote is integer arithmetic on signs: exact
        vthr = thr or 1.0
        want_lr = jax_aggregate.robust_lr({"u": jnp.asarray(u)}, vthr, 1.0)
        got_lr = aggregate.robust_lr({"u": torch.from_numpy(u)}, vthr, 1.0)
        np.testing.assert_array_equal(got_lr["u"].numpy(),
                                      np.asarray(want_lr["u"]))

    # the param-dict form: one leaf at a time, [m, ...] stacks viewed as
    # [m, n_leaf]
    rng = np.random.default_rng(1)
    shapes = {"a": (17, 5), "b": (23,), "c": (3, 2, 4)}
    m = 6
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    updates = {k: rng.normal(size=(m,) + s).astype(np.float32)
               for k, s in shapes.items()}
    w = rng.uniform(1, 3, size=(m,)).astype(np.float32)
    want = fused_rlr_avg_apply(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in updates.items()}, jnp.asarray(w),
        4.0, 1.0, interpret=True)
    got = rlr_fused.fused_rlr_avg_apply(
        {k: torch.from_numpy(v) for k, v in params.items()},
        {k: torch.from_numpy(v) for k, v in updates.items()},
        torch.from_numpy(w), 4.0, 1.0)
    for k in shapes:
        assert got[k].shape == shapes[k]
        # f32, summation order only
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=1e-5)
