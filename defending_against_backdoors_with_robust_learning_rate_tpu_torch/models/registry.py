"""Model registry.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
models/registry.py` (`get_model` with its `dtype`, `remat` and
`remat_policy`, `init_params`, `param_count`, `flops_per_example`);
reference src/models.py:4-8.

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
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models.resnet import (
    ResNet9)

# Flax's lecun_normal: a standard normal truncated to [-2, 2], scaled so the
# truncated distribution has variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def get_model(data: str, image_shape, n_classes: int = 10,
              arch: str = "cnn", dtype: str = "f32", remat: bool = False,
              remat_policy: str = "block"):
    """fmnist/fedemnist/synthetic -> CNN_MNIST; cifar10 -> CNN_CIFAR
    (src/models.py:4-8); arch 'resnet9' -> ResNet-9 on any dataset.
    `dtype` is the compute dtype (f32 | bf16; params stay f32); `remat`
    turns on ResNet-9's rematerialization under `remat_policy` (block |
    conv), and the CNNs ignore it, as JAX's `get_model` does."""
    with torch.device("meta"):
        if arch == "resnet9":
            return ResNet9(n_classes, image_shape, dtype, remat,
                           remat_policy)
        if data in ("fmnist", "fedemnist", "synthetic"):
            return CNN_MNIST(n_classes, image_shape, dtype)
        if data == "cifar10":
            return CNN_CIFAR(n_classes, image_shape, dtype)
    raise ValueError(f"no model for data={data!r} arch={arch!r}")


def init_params(model, seed: int, device) -> Dict[str, torch.Tensor]:
    """Flax's default init in torch layout: kernels lecun_normal, biases 0,
    GroupNorm scales 1, drawn in parameter order from a CPU generator seeded
    with `seed` (so the values do not depend on the device), then moved to
    `device`."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in model.named_parameters():
        t = torch.zeros(p.shape, dtype=torch.float32)
        if "GroupNorm" in name and name.endswith("weight"):
            t.fill_(1.0)
        elif name.endswith("weight"):
            fan_in = math.prod(p.shape[1:])
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                        generator=gen)
        out[name] = t.to(device)
    return out


def param_count(params) -> int:
    return sum(int(x.numel()) for x in params.values())


def flops_per_example(data: str, arch: str, image_shape,
                      n_classes: int = 10):
    """Analytic forward FLOPs of one example through the registry's model
    (multiply-accumulates count 2, elementwise tails ignored; a training
    step is about 3x the forward). None for resnet9, which has no analytic
    count here, as in JAX."""
    h, w, c = image_shape
    if arch == "resnet9":
        return None

    def conv(h, w, cin, cout, k=3):
        # VALID 3x3 conv: output (h-2)x(w-2), 2*k*k*cin*cout MACs/pixel
        ho, wo = h - (k - 1), w - (k - 1)
        return 2 * k * k * cin * cout * ho * wo, ho, wo

    flops = 0
    if data in ("fmnist", "fedemnist", "synthetic"):
        # CNN_MNIST: conv(32) -> conv(64) -> pool2 -> fc128 -> fc10
        f, h, w = conv(h, w, c, 32)
        flops += f
        f, h, w = conv(h, w, 32, 64)
        flops += f
        h, w = h // 2, w // 2
        flat = h * w * 64
        flops += 2 * flat * 128 + 2 * 128 * n_classes
        return float(flops)
    if data == "cifar10":
        # CNN_CIFAR: [conv(width) -> pool2] x (64, 128, 256) -> fc128
        # -> fc256 -> fc10
        cin = c
        for width in (64, 128, 256):
            f, h, w = conv(h, w, cin, width)
            flops += f
            h, w, cin = h // 2, w // 2, width
        flat = h * w * 256
        flops += 2 * flat * 128 + 2 * 128 * 256 + 2 * 256 * n_classes
        return float(flops)
    return None
