"""Layouts of the port: the packed all_reduce buffer of the sharded server
step (parallel/rounds.PackedPlan) with the kernels' leaf chunks
(ops/rlr_fused.leaf_chunks), and the NCHW model input
(fl/common.make_normalizer).

The packing has no JAX counterpart to compare with: XLA's combiner merges
JAX's per-leaf psums into one tuple all-reduce inside the compiled program
(tests/test_torch_packed_step.py holds the packed step against JAX's).

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import numpy as np
import pytest
import torch
from torch.func import functional_call

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    common)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    registry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops import (
    rlr_fused)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.rounds import (
    packed_plan)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_packed_plan_and_leaf_chunks():
    model = registry.get_model("fmnist", (28, 28, 1))
    params = {k: torch.zeros(p.shape) for k, p in model.named_parameters()}
    numels = [p.numel() for p in params.values()]
    cfg = Config(device="cpu")

    # avg, avg + RLR, sign: which half is written and reduced
    width = sum(-(-n // 4) * 4 for n in numels)
    for c, wsum, sign, reduced in (
            (cfg, True, False, slice(0, width)),
            (cfg.replace(robustLR_threshold=4), True, True,
             slice(0, 2 * width)),
            (cfg.replace(aggr="sign"), False, True, slice(width, 2 * width)),
            (cfg.replace(aggr="sign", robustLR_threshold=4), False, True,
             slice(width, 2 * width))):
        plan = packed_plan(c, params)
        assert (plan.wsum, plan.sign, plan.reduced) == (wsum, sign, reduced)
        assert plan.width == width and list(plan.numels) == numels
        # every leaf starts on a 16-byte boundary, and the gap before the
        # next leaf is its pad, fewer than ALIGN lanes
        for i, (o, n) in enumerate(zip(plan.offsets, plan.numels)):
            assert o % rlr_fused.ALIGN == 0
            end = plan.offsets[i + 1] if i + 1 < len(numels) else width
            assert 0 <= end - (o + n) < rlr_fused.ALIGN

    # the pad lanes come out zero whatever the buffer held (K2's plain
    # version writes the same views the kernel does)
    m = 3
    rng = np.random.default_rng(0)
    shapes = {"a": (10,), "b": (5, 7), "c": (12,), "d": (3,)}
    us = [torch.from_numpy(rng.normal(size=(m,) + s).astype(np.float32))
          .view(m, -1) for s in shapes.values()]
    wn = torch.full((m,), 1.0 / m)
    plan = packed_plan(cfg.replace(robustLR_threshold=2),
                       {k: torch.zeros(s) for k, s in shapes.items()})
    assert (plan.sign_at, plan.wsum_at) == (plan.width, 0)
    buf = torch.full((2 * plan.width,), float("nan"))
    rlr_fused.rlr_partial_leaves(us, wn, buf, plan.offsets, plan.sign_at,
                                 plan.wsum_at)
    assert bool(torch.isfinite(buf).all())
    for u, o, n in zip(us, plan.offsets, plan.numels):
        s, w = rlr_fused.rlr_partial_reference(u, wn)
        for base, want in ((plan.width, s), (0, w)):
            torch.testing.assert_close(buf[base + o:base + o + n], want,
                                       atol=0, rtol=0)
            pad = buf[base + o + n:base + o + rlr_fused.padded(n)]
            assert bool((pad == 0).all())

    # more leaves than one launch's table: 70 leaves are two launches, and
    # the multi-leaf entry gives each leaf its one-leaf answer
    assert rlr_fused.leaf_chunks(70) == [(0, 64), (64, 70)]
    assert rlr_fused.leaf_chunks(64) == [(0, 64)]
    assert rlr_fused.leaf_chunks(8) == [(0, 8)]
    sizes = [int(n) for n in rng.integers(1, 40, size=70)]
    us = [torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32))
          for n in sizes]
    ps = [torch.from_numpy(rng.normal(size=(n,)).astype(np.float32))
          for n in sizes]
    offsets, total = rlr_fused.packed_offsets(tuple(sizes))
    flat = torch.full((total,), float("nan"))
    before = dict(rlr_fused.LAUNCHES)
    views = rlr_fused.rlr_fused_leaves(us, wn, ps, flat, offsets, 2.0, 0.5,
                                       "avg")
    assert rlr_fused.LAUNCHES == before     # CPU tensors: the plain version
    for u, p, o, v in zip(us, ps, offsets, views, strict=True):
        assert v.data_ptr() == flat[o:].data_ptr()
        torch.testing.assert_close(v, rlr_fused.rlr_fused(u, wn, p, 2.0, 0.5),
                                   atol=0, rtol=0)
    assert bool(torch.isfinite(flat).all())


def test_normalized_input_gives_nchw_activations():
    """The one-channel NHWC batch comes out of the normalizer with NCHW
    strides, and Conv_0's output under the round's functional_call keeps
    them: (C*H*W, H*W, W, 1). A permuted view would give strides that read
    as channels-last, and Conv_0 would answer channels-last."""
    model = registry.get_model("fmnist", (28, 28, 1))
    params = {k: v.requires_grad_(True)
              for k, v in registry.init_params(model, 0, "cpu").items()}
    norm = common.make_normalizer((0.5,), (0.5,), "cpu")
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, size=(4, 28, 28, 1)).astype(np.uint8))
    seen = []
    hook = model.Conv_0.register_forward_hook(
        lambda mod, args, out: seen.append(out))
    try:
        inp = norm(x)
        functional_call(model, params, (inp,))
    finally:
        hook.remove()
    assert inp.stride() == (28 * 28, 28 * 28, 28, 1)
    (out,) = seen
    assert out.shape == (4, 32, 26, 26)
    assert out.stride() == (32 * 26 * 26, 26 * 26, 26, 1)
    # the values are the reference's (x/255 - mean)/std
    want = (x.permute(0, 3, 1, 2).to(torch.float32) / 255.0 - 0.5) / 0.5
    torch.testing.assert_close(inp, want, atol=0, rtol=0)
