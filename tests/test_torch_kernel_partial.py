"""K2's wrapper (ops/rlr_fused.rlr_partial) refuses what the kernel does not
take and counts only kernel launches; and, on a card, the CUDA kernel
agrees with its plain version.

This file imports no jax, so its CUDA test also runs where only the port is
installed: `python -m pytest --noconftest -m cuda
tests/test_torch_kernel_partial.py`.

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

# the three (m, n) shapes of tests/test_pallas.py
PALLAS_SHAPES = [(4, 300), (10, 5000), (7, 1111)]


def test_partial_wrapper_refuses_bad_arguments():
    u = torch.zeros(3, 8)
    wn = torch.full((3,), 1 / 3)
    with pytest.raises(TypeError):
        rlr_fused.rlr_partial(u.double(), wn)
    with pytest.raises(ValueError):
        rlr_fused.rlr_partial(u, wn[:2])
    with pytest.raises(ValueError):
        rlr_fused.rlr_partial(torch.zeros(8, 3).t(), wn)
    with pytest.raises(ValueError):
        rlr_fused.rlr_partial(torch.zeros(3, 0), wn)
    with pytest.raises(ValueError):
        rlr_fused.rlr_partial(u.view(-1), wn)
    # a CPU tensor takes the plain version and counts no launch
    before = rlr_fused.LAUNCHES["rlr_partial"]
    s, w = rlr_fused.rlr_partial(u, wn)
    assert s.shape == w.shape == (8,)
    assert rlr_fused.LAUNCHES["rlr_partial"] == before


@pytest.mark.cuda
def test_cuda_partial_matches_plain():
    """The CUDA kernel vs the plain version on the card, at the test_pallas
    shapes and at every CNN_MNIST leaf with m/d = 2 and 5 (m = 10)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    model = registry.get_model("fmnist", (28, 28, 1))
    cases = PALLAS_SHAPES + [(mb, math.prod(p.shape))
                             for _, p in model.named_parameters()
                             for mb in (2, 5)]
    rng = np.random.default_rng(4)
    for m, n in cases:
        u, w = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                .cuda() for s in ((m, n), (m,)))
        u[0, :5] = 0.0
        wn = (w.abs() + 1) / ((w.abs() + 1).sum() * 2)  # a global total
        before = rlr_fused.LAUNCHES["rlr_partial"]
        got_s, got_w = rlr_fused.rlr_partial(u, wn)
        torch.cuda.synchronize()
        assert rlr_fused.LAUNCHES["rlr_partial"] == before + 1
        want_s, want_w = rlr_fused.rlr_partial_reference(u, wn)
        # sums of +-1 and 0 round nowhere: exact
        torch.testing.assert_close(got_s, want_s, atol=0, rtol=0)
        # f32, summation order only
        torch.testing.assert_close(got_w, want_w, atol=1e-5, rtol=1e-5)
