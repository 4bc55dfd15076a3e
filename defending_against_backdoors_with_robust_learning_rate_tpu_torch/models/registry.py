"""Model registry.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
models/registry.py` (`get_model`, `init_params`, `param_count`); reference
src/models.py:4-8.

The module is built on the meta device: it holds the architecture only and
draws nothing from torch's global RNG. Parameters live in a separate dict
(name -> tensor) that every caller passes through
`torch.func.functional_call`, as the JAX package passes its param pytree to
`model.apply`.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models.cnn import (
    CNN_CIFAR, CNN_MNIST)

# Flax's lecun_normal: a standard normal truncated to [-2, 2], scaled so the
# truncated distribution has variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def get_model(data: str, image_shape, n_classes: int = 10):
    """fmnist/synthetic -> CNN_MNIST; cifar10 -> CNN_CIFAR (src/models.py:4-8)."""
    with torch.device("meta"):
        if data in ("fmnist", "synthetic"):
            return CNN_MNIST(n_classes, image_shape)
        if data == "cifar10":
            return CNN_CIFAR(n_classes, image_shape)
    raise ValueError(f"no model for data={data!r}")


def init_params(model, seed: int, device) -> Dict[str, torch.Tensor]:
    """Flax's default init in torch layout: kernels lecun_normal, biases 0,
    drawn in parameter order from a CPU generator seeded with `seed` (so the
    values do not depend on the device), then moved to `device`."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in model.named_parameters():
        t = torch.zeros(p.shape, dtype=torch.float32)
        if name.endswith("weight"):
            fan_in = math.prod(p.shape[1:])
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                        generator=gen)
        out[name] = t.to(device)
    return out


def param_count(params) -> int:
    return sum(int(x.numel()) for x in params.values())
