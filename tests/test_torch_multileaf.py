"""The port's one-launch server step (ops/rlr_fused.fused_rlr_avg_apply: K1
over every leaf, the new params as views of one flat buffer) against the
JAX package's `fused_rlr_avg_apply`, one Pallas call per leaf.

The JAX side runs the Pallas kernel in interpret mode on the CPU, as
tests/test_pallas.py does; on the CPU the port's multi-leaf entry runs
K1's plain version leaf by leaf (tests/test_torch_kernel_multi.py holds
the CUDA kernel to it on the card).

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu.ops.pallas_rlr import (
    fused_rlr_avg_apply as jax_fused_rlr_avg_apply)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    registry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops import (
    rlr_fused)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_multileaf_step_matches_pallas():
    """Every CNN_MNIST leaf shape at m = 3, plus leaves with n % 4 != 0
    (Dense_1.bias is one already), for avg with and without the vote and
    sign + RLR."""
    model = registry.get_model("fmnist", (28, 28, 1))
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    shapes.update({"odd.a": (5, 7), "odd.b": (3,), "odd.c": (1,)})
    m = 3
    rng = np.random.default_rng(5)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    updates = {k: rng.normal(size=(m,) + s).astype(np.float32)
               for k, s in shapes.items()}
    updates["Conv_0.bias"][:, :4] = 0.0     # votes for neither side
    w = rng.uniform(1, 5, size=(m,)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tu = {k: torch.from_numpy(v) for k, v in updates.items()}
    before = dict(rlr_fused.LAUNCHES)
    for mode, thr, slr in (("avg", 2.0, 1.0), ("avg", 0.0, 1.0),
                           ("sign", 2.0, 0.05)):
        want = jax_fused_rlr_avg_apply(
            {k: jnp.asarray(v) for k, v in params.items()},
            {k: jnp.asarray(v) for k, v in updates.items()}, jnp.asarray(w),
            thr, slr, interpret=True, mode=mode)
        got = rlr_fused.fused_rlr_avg_apply(tp, tu, torch.from_numpy(w), thr,
                                            slr, mode=mode)
        assert list(got) == list(shapes)
        # one flat buffer, every leaf on a 16-byte boundary of it
        base = got["Conv_0.weight"]
        for k, v in got.items():
            assert v.shape == shapes[k]
            assert v.untyped_storage().data_ptr() == (
                base.untyped_storage().data_ptr())
            assert (v.data_ptr() - base.data_ptr()) % 16 == 0
            if mode == "sign":
                # p + (+-lr) * (+-1 | 0): exact
                np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]),
                                              err_msg=f"{mode} {thr} {k}")
            else:
                # f32, summation order only: 1e-5
                np.testing.assert_allclose(v.numpy(), np.asarray(want[k]),
                                           atol=1e-5, rtol=1e-5,
                                           err_msg=f"{mode} {thr} {k}")
    # CPU tensors take the plain version: no launch counted
    assert rlr_fused.LAUNCHES == before
