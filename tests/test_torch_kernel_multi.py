"""On a card: the one-launch kernels over many leaves (ops/rlr_fused.
rlr_fused_leaves, K1, and rlr_partial_leaves, K2) against their plain
versions, leaf by leaf: every CNN_MNIST leaf as one table, leaves the bulk
copies cannot take (n % 4 != 0, a pointer off 16 bytes), a block of more
rows than one stage holds, and 70 leaves (two launches).

This file imports no jax, so it also runs where only the port is
installed: `python -m pytest --noconftest -m cuda
tests/test_torch_kernel_multi.py`. On the CPU both tests skip: the kernels
have no CPU mode (tests/test_torch_multileaf.py and
tests/test_torch_packed_step.py hold the plain versions to JAX).

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


def _tables():
    """(m, [n per leaf], unaligned) of the cases: every CNN_MNIST leaf at
    m = 10 and 2, odd widths, one row, 200 rows (several stages a tile),
    leaves off 16 bytes, and 70 leaves."""
    model = registry.get_model("fmnist", (28, 28, 1))
    cnn = [math.prod(p.shape) for _, p in model.named_parameters()]
    rng = np.random.default_rng(8)
    return [(10, cnn, False), (2, cnn, False),
            (7, [1, 2, 3, 5, 10, 1023, 4097, 300], False),
            (1, [12, 7, 5000], False), (200, [5000, 10, 4096], False),
            (10, [4096, 10, 1280], True),
            (3, [int(n) for n in rng.integers(1, 3000, size=70)], False)]


def _leaves(gen, m, sizes, unaligned):
    """Update stacks and params on the card; with `unaligned`, each starts
    4 bytes past a 16-byte boundary, so no leaf can take the bulk copies."""
    def make(*shape):
        n = math.prod(shape)
        flat = torch.randn(n + 1, generator=gen, device="cuda")
        t = (flat[1:] if unaligned else flat[:n]).view(shape)
        if unaligned:
            assert t.data_ptr() % 16 != 0
        return t
    us = [make(m, n) for n in sizes]
    us[0][0, :5] = 0.0                      # sign(0) votes for no side
    return us, [make(n) for n in sizes]


def _check_pads(flat, at, offsets, sizes):
    for o, n in zip(offsets, sizes):
        assert bool((flat[at + o + n:at + o + rlr_fused.padded(n)] == 0).all())


@pytest.mark.cuda
def test_cuda_multileaf_k1_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, sizes, unaligned in _tables():
        us, ps = _leaves(gen, m, sizes, unaligned)
        w = torch.rand(m, generator=gen, device="cuda") + 1
        wn = w / w.sum()
        offsets, total = rlr_fused.packed_offsets(tuple(sizes))
        for mode, thr in (("avg", 4.0), ("avg", 0.0), ("sign", 2.0)):
            flat = torch.full((total,), float("nan"), device="cuda")
            before = rlr_fused.LAUNCHES["rlr_fused"]
            views = rlr_fused.rlr_fused_leaves(us, wn, ps, flat, offsets, thr,
                                               0.5, mode)
            torch.cuda.synchronize()
            assert (rlr_fused.LAUNCHES["rlr_fused"] - before
                    == len(rlr_fused.leaf_chunks(len(sizes))))
            for u, p, got in zip(us, ps, views, strict=True):
                want = rlr_fused.rlr_fused_reference(u, wn, p, thr, 0.5, mode)
                if mode == "sign":
                    # p + (+-lr) * (+-1 | 0) rounds nowhere: exact
                    torch.testing.assert_close(got, want, atol=0, rtol=0)
                else:
                    # f32, summation order only
                    torch.testing.assert_close(got, want, atol=1e-5,
                                               rtol=1e-5)
            _check_pads(flat, 0, offsets, sizes)


@pytest.mark.cuda
def test_cuda_packed_k2_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for m, sizes, unaligned in _tables():
        us, _ = _leaves(gen, m, sizes, unaligned)
        w = torch.rand(m, generator=gen, device="cuda") + 1
        wn = w / (w.sum() * 2)              # a global total over 2 blocks
        offsets, total = rlr_fused.packed_offsets(tuple(sizes))
        # [weighted sums | sign sums], as the sharded step packs them
        for sign_at, wsum_at in ((total, 0), (total, None), (None, 0)):
            buf = torch.full((2 * total,), float("nan"), device="cuda")
            before = rlr_fused.LAUNCHES["rlr_partial"]
            rlr_fused.rlr_partial_leaves(us, wn, buf, offsets, sign_at,
                                         wsum_at)
            torch.cuda.synchronize()
            assert (rlr_fused.LAUNCHES["rlr_partial"] - before
                    == len(rlr_fused.leaf_chunks(len(sizes))))
            for u, o in zip(us, offsets):
                n = u.shape[1]
                want_s, want_w = rlr_fused.rlr_partial_reference(u, wn)
                for at, want, tol in ((sign_at, want_s, 0.0),
                                      (wsum_at, want_w, 1e-5)):
                    if at is not None:
                        # sums of +-1 and 0 round nowhere: exact; the
                        # weighted sum in another order
                        torch.testing.assert_close(
                            buf[at + o:at + o + n], want, atol=tol, rtol=tol)
            for at, half in ((sign_at, total), (wsum_at, 0)):
                if at is None:                  # a half not written
                    assert bool(buf[half:half + total].isnan().all())
                else:
                    _check_pads(buf, at, offsets, sizes)
