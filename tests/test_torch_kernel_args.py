"""The fused kernel's wrapper (ops/rlr_fused.rlr_fused) refuses what the
kernel does not take and counts only kernel launches; and, on a card, the
CUDA kernel agrees with its plain version.

This file imports no jax, so its CUDA test also runs where only the port is
installed: `python -m pytest --noconftest -m cuda
tests/test_torch_kernel_args.py`.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import math

import numpy as np
import pytest
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    registry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops import (
    rlr_fused)

# the three (m, n, threshold) cases of tests/test_pallas.py
PALLAS_CASES = [(4, 300, 3.0), (10, 5000, 4.0), (7, 1111, 0.0)]


def test_wrapper_refuses_bad_arguments():
    u = torch.zeros(3, 8)
    wn = torch.full((3,), 1 / 3)
    p = torch.zeros(8)
    with pytest.raises(TypeError):
        rlr_fused.rlr_fused(u.double(), wn, p, 1.0, 1.0)
    with pytest.raises(ValueError):
        rlr_fused.rlr_fused(u, wn[:2], p, 1.0, 1.0)
    with pytest.raises(ValueError):
        rlr_fused.rlr_fused(torch.zeros(8, 3).t(), wn, p, 1.0, 1.0)
    with pytest.raises(ValueError):
        rlr_fused.rlr_fused(torch.zeros(3, 0), wn, torch.zeros(0), 1.0, 1.0)
    with pytest.raises(ValueError):
        rlr_fused.rlr_fused(u, wn, p, 1.0, 1.0, mode="comed")
    # a CPU tensor takes the plain version and counts no launch
    before = rlr_fused.LAUNCHES["rlr_fused"]
    out = rlr_fused.rlr_fused(u, wn, p, 1.0, 1.0)
    assert out.shape == (8,)
    assert rlr_fused.LAUNCHES["rlr_fused"] == before


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The CUDA kernel vs the plain version on the card, at the test_pallas
    shapes and at every CNN_MNIST leaf with m = 10."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    model = registry.get_model("fmnist", (28, 28, 1))
    cases = PALLAS_CASES + [(10, math.prod(p.shape), 4.0)
                            for _, p in model.named_parameters()]
    rng = np.random.default_rng(3)
    for m, n, thr in cases:
        u, w, p = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   .cuda() for s in ((m, n), (m,), (n,)))
        w = w.abs() + 1
        wn = w / w.sum()
        for mode in ("avg", "sign"):
            before = rlr_fused.LAUNCHES["rlr_fused"]
            got = rlr_fused.rlr_fused(u, wn, p, thr, 0.5, mode)
            torch.cuda.synchronize()
            assert rlr_fused.LAUNCHES["rlr_fused"] == before + 1
            want = rlr_fused.rlr_fused_reference(u, wn, p, thr, 0.5, mode)
            if mode == "sign":
                # p + (+-lr) * (+-1 | 0) rounds nowhere: the vote is exact
                torch.testing.assert_close(got, want, atol=0, rtol=0)
            else:
                # f32, summation order only
                torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
