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
(models/carrier.py converts). JAX's `remat` is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

GN_EPS = 1e-6           # flax.linen.GroupNorm's epsilon
# ResNet9's blocks in call order, which is also their parameters' order
BLOCKS = ("ConvGN_0", "ConvGN_1", "Residual_0", "ConvGN_2", "ConvGN_3",
          "Residual_1")


class ConvGN(nn.Module):
    def __init__(self, cin: int, width: int, pool: bool = False):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, width, 3, padding=1, bias=False)
        self.GroupNorm_0 = nn.GroupNorm(min(32, width), width, eps=GN_EPS)
        self.pool = pool

    def forward(self, x):
        x = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        return F.max_pool2d(x, 2) if self.pool else x


class Residual(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.ConvGN_0 = ConvGN(width, width)
        self.ConvGN_1 = ConvGN(width, width)

    def forward(self, x):
        return x + self.ConvGN_1(self.ConvGN_0(x))


class ResNet9(nn.Module):
    dropout_sites = ()      # no dropout: `keep` is always None

    def __init__(self, n_classes: int = 10, image_shape=(32, 32, 3)):
        super().__init__()
        c = image_shape[-1]
        self.ConvGN_0 = ConvGN(c, 64)
        self.ConvGN_1 = ConvGN(64, 128, pool=True)
        self.Residual_0 = Residual(128)
        self.ConvGN_2 = ConvGN(128, 256, pool=True)
        self.ConvGN_3 = ConvGN(256, 512, pool=True)
        self.Residual_1 = Residual(512)
        self.Dense_0 = nn.Linear(512, n_classes)

    def forward(self, x, keep: Optional[Sequence[torch.Tensor]] = None):
        del keep
        for name in BLOCKS:
            x = getattr(self, name)(x)
        x = torch.amax(x, dim=(2, 3))           # global max pool
        return self.Dense_0(x) * 0.125
