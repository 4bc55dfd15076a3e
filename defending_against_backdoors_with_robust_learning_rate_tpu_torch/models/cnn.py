"""The reference CNNs as NCHW torch modules.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
models/cnn.py` (Flax, NHWC); reference src/models.py:11-58. Submodules
carry the Flax names (Conv_0, Dense_0, ...), so a parameter "Conv_0.weight"
is the Flax leaf params["Conv_0"]["kernel"] in torch layout
(models/carrier.py converts).

CNN_MNIST (src/models.py:11-31), 1,199,882 params:
  28x28x1 -conv3x3(32)-> 26 -conv3x3(64)-> 24 -pool2-> 12 -> flatten 9216
  -> dropout(.5) -> fc 128 -> relu -> dropout(.5) -> fc 10
CNN_CIFAR (src/models.py:33-58): three conv(3x3)+pool stages of 64/128/256
  -> flatten -> dropout -> fc 128 -> relu -> dropout -> fc 256 -> relu
  -> dropout -> fc 10

Dropout takes its masks as an input: `forward(x, keep)` with `keep` a
tuple of boolean keep-masks, one per dropout site (`dropout_sites` gives
each site's feature count), drawn before the call
(fl/client.draw_slot); None is no dropout, the eval forward. The masks are
inputs because `torch.func.vmap` cannot draw from a `torch.Generator` and a
captured CUDA graph should not draw at all. The flatten is CHW-major
here and HWC-major in Flax; that is the one layout difference the weight
carrier has to undo.

`dtype` is JAX's compute dtype (`--dtype`, models/layers.py): the input is
cast to it, every layer computes in it, and the logits come out f32, as
JAX's `x.astype(jnp.float32)`. The CNNs have no rematerialization, as in
JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models.layers import (
    DTYPES, conv, dense)

DROPOUT_RATE = 0.5


KEEP_PROB = 1.0 - DROPOUT_RATE


def dropout(x: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
    """Flax `nn.Dropout` arithmetic (keep with prob 1-rate, scale by
    1/(1-rate)) under the given keep-mask; identity when keep is None."""
    if keep is None:
        return x
    return torch.where(keep, x / KEEP_PROB, 0.0)


def _site(keep: Optional[Sequence[torch.Tensor]], i: int):
    return None if keep is None else keep[i]


def _flat_features(h: int, w: int, convs: int, pool_each: bool,
                   width: int) -> int:
    for _ in range(convs):
        h, w = h - 2, w - 2
        if pool_each:
            h, w = h // 2, w // 2
    if not pool_each:
        h, w = h // 2, w // 2
    return h * w * width


def _layer(x, mod, dt):
    """A Conv_i or Dense_i at compute dtype dt; at f32 the module itself
    runs (its forward hooks fire, as before the dtype existed)."""
    if dt == torch.float32:
        return mod(x)
    if isinstance(mod, nn.Conv2d):
        return conv(x, mod.weight, mod.bias, dt)
    return dense(x, mod.weight, mod.bias, dt)


class CNN_MNIST(nn.Module):
    def __init__(self, n_classes: int = 10, image_shape=(28, 28, 1),
                 dtype: str = "f32"):
        super().__init__()
        h, w, c = image_shape
        self.Conv_0 = nn.Conv2d(c, 32, 3)
        self.Conv_1 = nn.Conv2d(32, 64, 3)
        self.Dense_0 = nn.Linear(_flat_features(h, w, 2, False, 64), 128)
        self.Dense_1 = nn.Linear(128, n_classes)
        self.dropout_sites = (self.Dense_0.in_features, 128)
        self.compute_dtype = DTYPES[dtype]

    def forward(self, x, keep: Optional[Sequence[torch.Tensor]] = None):
        dt = self.compute_dtype
        x = x.to(dt)
        x = F.relu(_layer(x, self.Conv_0, dt))
        x = F.relu(_layer(x, self.Conv_1, dt))
        x = F.max_pool2d(x, 2)
        x = dropout(x.flatten(1), _site(keep, 0))
        x = dropout(F.relu(_layer(x, self.Dense_0, dt)), _site(keep, 1))
        return _layer(x, self.Dense_1, dt).to(torch.float32)


class CNN_CIFAR(nn.Module):
    def __init__(self, n_classes: int = 10, image_shape=(32, 32, 3),
                 dtype: str = "f32"):
        super().__init__()
        h, w, c = image_shape
        self.Conv_0 = nn.Conv2d(c, 64, 3)
        self.Conv_1 = nn.Conv2d(64, 128, 3)
        self.Conv_2 = nn.Conv2d(128, 256, 3)
        self.Dense_0 = nn.Linear(_flat_features(h, w, 3, True, 256), 128)
        self.Dense_1 = nn.Linear(128, 256)
        self.Dense_2 = nn.Linear(256, n_classes)
        self.dropout_sites = (self.Dense_0.in_features, 128, 256)
        self.compute_dtype = DTYPES[dtype]

    def forward(self, x, keep: Optional[Sequence[torch.Tensor]] = None):
        dt = self.compute_dtype
        x = x.to(dt)
        for c in (self.Conv_0, self.Conv_1, self.Conv_2):
            x = F.max_pool2d(F.relu(_layer(x, c, dt)), 2)
        x = dropout(x.flatten(1), _site(keep, 0))
        x = dropout(F.relu(_layer(x, self.Dense_0, dt)), _site(keep, 1))
        x = dropout(F.relu(_layer(x, self.Dense_1, dt)), _site(keep, 2))
        return _layer(x, self.Dense_2, dt).to(torch.float32)
