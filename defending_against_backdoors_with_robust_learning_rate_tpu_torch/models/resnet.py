"""ResNet-9 (BASELINE.json configs 3-4: cifar10 at scale) as NCHW torch
modules.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
models/resnet.py` (`ConvGN`, `Residual`, `ResNet9`, Flax, NHWC). The
reference has no ResNet; the JAX package's design is kept:

- GroupNorm, not BatchNorm: all state is parameters, so FedAvg and the
  RLR vote apply to every tensor, and no statistic leaks across clients.
  Flax's GroupNorm takes epsilon 1e-6 (torch's default is 1e-5) and
  min(32, width) groups.
- 3x3 SAME convolutions without bias, 2x2 VALID max-pools, the DAWNBench
  topology: conv(64) -> conv(128)+pool -> residual(128) -> conv(256)+pool
  -> conv(512)+pool -> residual(512) -> global max over H and W -> fc,
  the logits scaled by 0.125. No dropout.

Submodules carry the Flax names, so "ConvGN_1.Conv_0.weight" is the Flax
leaf params["ConvGN_1"]["Conv_0"]["kernel"] in torch layout
(models/carrier.py converts).

`dtype` is JAX's compute dtype (models/layers.py): the input is cast to
it, the convolutions run in it, GroupNorm takes its statistics in f32 and
returns it, and the scaled logits come out f32. `remat` and
`remat_policy` are JAX's blockwise rematerialization (models/remat.py):
each of the six blocks is one `torch.autograd.Function` that saves its
input (`block`) or its input and its convolutions' outputs (`conv`) and
recomputes the rest in backward. The modules and their parameter names do
not change with remat, so a state dict (and the carrier's Flax names) is
the same with it on or off, as JAX names its remat modules for.

A block is a list of stages (a 3x3 convolution, then GroupNorm, relu and
an optional pool) with an optional residual add; its `BlockSpec` runs it
as a pure function of its input and its leaves, the one code path of the
plain and the rematerialized forward.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    remat as remat_mod)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models.layers import (
    GN_EPS, DTYPES, conv, conv_backward, dense, group_norm)

# ResNet9's blocks in call order, which is also their parameters' order
BLOCKS = ("ConvGN_0", "ConvGN_1", "Residual_0", "ConvGN_2", "ConvGN_3",
          "Residual_1")
REMAT_POLICIES = ("block", "conv")      # JAX's --remat_policy choices


class BlockSpec(NamedTuple):
    """The static shape of a block: its compute dtype, each stage's
    (GroupNorm groups, pool), and whether the block adds its input. Called
    with (x, *leaves) it runs the block, `leaves` holding (conv weight,
    GroupNorm scale, GroupNorm bias) for each stage in order."""
    dtype: torch.dtype
    stages: Tuple[Tuple[int, bool], ...]
    residual: bool

    def conv(self, h, weight):
        """A stage's 3x3 SAME convolution."""
        return conv(h, weight, None, self.dtype, padding=1)

    def conv_backward(self, grad, h, weight, need_input: bool):
        return conv_backward(grad, h, weight, self.dtype, 1, need_input)

    def tail(self, i: int, c, scale, bias):
        """Stage i after its convolution: GroupNorm, relu, the optional
        pool (what JAX's `conv` policy recomputes)."""
        groups, pool = self.stages[i]
        y = F.relu(group_norm(c, groups, scale, bias, self.dtype))
        return F.max_pool2d(y, 2) if pool else y

    def __call__(self, x, *leaves):
        h = x
        for i in range(len(self.stages)):
            w, s, b = leaves[3 * i:3 * i + 3]
            h = self.tail(i, self.conv(h, w), s, b)
        return x + h if self.residual else h


class ConvGN(nn.Module):
    def __init__(self, cin: int, width: int, pool: bool = False):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, width, 3, padding=1, bias=False)
        self.GroupNorm_0 = nn.GroupNorm(min(32, width), width, eps=GN_EPS)
        self.pool = pool

    def stages(self):
        return ((self.GroupNorm_0.num_groups, self.pool),)

    def leaves(self):
        return (self.Conv_0.weight, self.GroupNorm_0.weight,
                self.GroupNorm_0.bias)


class Residual(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.ConvGN_0 = ConvGN(width, width)
        self.ConvGN_1 = ConvGN(width, width)

    def stages(self):
        return self.ConvGN_0.stages() + self.ConvGN_1.stages()

    def leaves(self):
        return self.ConvGN_0.leaves() + self.ConvGN_1.leaves()


class ResNet9(nn.Module):
    dropout_sites = ()      # no dropout: `keep` is always None

    def __init__(self, n_classes: int = 10, image_shape=(32, 32, 3),
                 dtype: str = "f32", remat: bool = False,
                 remat_policy: str = "block"):
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of "
                             f"{REMAT_POLICIES}, got {remat_policy!r}")
        c = image_shape[-1]
        self.ConvGN_0 = ConvGN(c, 64)
        self.ConvGN_1 = ConvGN(64, 128, pool=True)
        self.Residual_0 = Residual(128)
        self.ConvGN_2 = ConvGN(128, 256, pool=True)
        self.ConvGN_3 = ConvGN(256, 512, pool=True)
        self.Residual_1 = Residual(512)
        self.Dense_0 = nn.Linear(512, n_classes)
        self.compute_dtype = DTYPES[dtype]
        self.remat = remat
        self.remat_policy = remat_policy

    def forward(self, x, keep: Optional[Sequence[torch.Tensor]] = None):
        del keep
        dt = self.compute_dtype
        x = x.to(dt)
        for name in BLOCKS:
            block = getattr(self, name)
            spec = BlockSpec(dt, block.stages(), isinstance(block, Residual))
            if self.remat:
                x = remat_mod.checkpoint_block(self.remat_policy, spec, x,
                                               block.leaves())
            else:
                x = spec(x, *block.leaves())
        x = torch.amax(x, dim=(2, 3))           # global max pool
        x = dense(x, self.Dense_0.weight, self.Dense_0.bias, dt)
        return (x * 0.125).to(torch.float32)
