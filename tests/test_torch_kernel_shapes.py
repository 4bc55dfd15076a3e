"""On a card: K1 (ops/rlr_fused.fused_rlr_avg_apply, one launch over every
leaf) against its plain version at the shapes the cifar10 and fedemnist
runs give it: m = 40 agents on ResNet-9's 26 leaves (6,573,130 values)
and on CNN_CIFAR's 12, and m = 33 on CNN_MNIST's 8. At m = 40 a tile's
stage holds 128 columns of 41 rows (the params' row included), at m = 33
128 columns of 34.

This file imports no jax, so it also runs where only the port is
installed: `python -m pytest --noconftest -m cuda
tests/test_torch_kernel_shapes.py`. On the CPU the test skips: the kernel
has no CPU mode (tests/test_torch_multileaf.py holds the plain version to
JAX).

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import pytest
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    registry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops import (
    rlr_fused)

# (data, image shape, arch, m)
SHAPES = (("cifar10", (32, 32, 3), "resnet9", 40),
          ("cifar10", (32, 32, 3), "cnn", 40),
          ("fedemnist", (28, 28, 1), "cnn", 33))


@pytest.mark.cuda
def test_cuda_k1_at_the_slice_shapes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for data, shape, arch, m in SHAPES:
        model = registry.get_model(data, shape, arch=arch)
        leaves = {n: tuple(p.shape) for n, p in model.named_parameters()}
        params = {n: torch.randn(s, generator=gen, device="cuda")
                  for n, s in leaves.items()}
        ups = {n: torch.randn((m,) + s, generator=gen, device="cuda") * 1e-2
               for n, s in leaves.items()}
        next(iter(ups.values()))[0].view(-1)[:5] = 0.0    # sign(0)
        sizes = torch.rand(m, generator=gen, device="cuda") * 100 + 1
        wn = sizes / sizes.sum()
        for mode, thr in (("avg", 8.0), ("avg", 0.0), ("sign", 8.0)):
            before = rlr_fused.LAUNCHES["rlr_fused"]
            got = rlr_fused.fused_rlr_avg_apply(params, ups, sizes, thr, 1.0,
                                                mode)
            torch.cuda.synchronize()
            assert rlr_fused.LAUNCHES["rlr_fused"] - before == 1
            for n in leaves:
                want = rlr_fused.rlr_fused_reference(
                    ups[n].view(m, -1), wn, params[n].view(-1), thr, 1.0,
                    mode).view(leaves[n])
                what = f"{arch} m={m} {mode} thr={thr} {n}"
                if mode == "sign":
                    # p + (+-lr) * (+-1 | 0) rounds nowhere: exact
                    torch.testing.assert_close(got[n], want, atol=0, rtol=0,
                                               msg=what)
                else:
                    # f32, summation order only
                    torch.testing.assert_close(got[n], want, atol=1e-5,
                                               rtol=1e-5, msg=what)
        del params, ups
