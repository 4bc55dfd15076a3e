"""Flax's compute-dtype semantics, as explicit casts.

Counterpart: the `dtype=` argument of the JAX package's Flax modules
(`models/cnn.py`, `models/resnet.py`; JAX `--dtype f32|bf16`). Params stay
f32; a layer at compute dtype `dt`:

- Conv and Dense (`nn.Conv`, `nn.Dense`): the input, kernel and bias are
  cast to `dt`, the product comes out in `dt`, then the bias is added in
  `dt` (Flax's `y = dot(x, k); y += b`, two roundings);
- GroupNorm (`flax.linen.GroupNorm` with `dtype=dt`, flax 0.12's
  `_compute_stats` and `_normalize`): the input is promoted to f32, the
  statistics and the normalized, scaled and shifted result are computed
  in f32, and the result is cast to `dt`;
- relu, max-pool and dropout run in the dtype they are given.

At f32 every helper is the op the module ran before (`F.conv2d` with its
bias, `F.linear`, `F.group_norm`), so an f32 model computes what it always
did. The casts are differentiable: the grads come back f32, so updates and
the server step stay f32. `torch.autocast` is not used: its per-op cast
lists (GroupNorm in f32 with an f32 output, for one) are not Flax's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# `--dtype` names; an unknown one raises KeyError, as JAX's
# `models/registry._DTYPES[dtype]` does
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
GN_EPS = 1e-6           # flax.linen.GroupNorm's epsilon


def conv(x, weight, bias, dtype: torch.dtype, padding: int = 0):
    """Flax `nn.Conv(dtype=dtype)` on NCHW: stride 1, `padding` on each
    side (0 is VALID, 1 is SAME for 3x3)."""
    if dtype == torch.float32:
        return F.conv2d(x, weight, bias, padding=padding)
    y = F.conv2d(x, weight.to(dtype), padding=padding)
    return y if bias is None else y + bias.to(dtype)[:, None, None]


def conv_backward(grad, x, weight, dtype: torch.dtype, padding: int,
                  need_input: bool):
    """(grad of x or None, grad of weight) of a bias-free `conv(x, weight,
    None, dtype, padding)` whose output's grad is `grad`, without running
    its forward: the one `convolution_backward` call autograd makes for
    it, then the weight grad cast back to the weight's dtype (the cast's
    own backward)."""
    gx, gw, _ = torch.ops.aten.convolution_backward(
        grad, x, weight.to(dtype), None, [1, 1], [padding, padding], [1, 1],
        False, [0, 0], 1, [need_input, True, False])
    return gx, gw.to(weight.dtype)


def dense(x, weight, bias, dtype: torch.dtype):
    """Flax `nn.Dense(dtype=dtype)`."""
    if dtype == torch.float32:
        return F.linear(x, weight, bias)
    return F.linear(x, weight.to(dtype)) + bias.to(dtype)


def group_norm(x, groups: int, scale, bias, dtype: torch.dtype):
    """Flax `nn.GroupNorm(dtype=dtype)`: statistics and affine in f32, the
    result cast to `dtype`."""
    return F.group_norm(x.to(torch.float32), groups, scale, bias,
                        GN_EPS).to(dtype)
