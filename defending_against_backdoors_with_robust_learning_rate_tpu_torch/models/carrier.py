"""The weight carrier: Flax param pytrees <-> this package's param dicts.

Counterpart: the layout conversion in the JAX package's
tests/test_reference_parity.py (`_to_torch_layout`), copied here. Flax keeps
conv kernels as [kh, kw, cin, cout] and dense kernels as [in, out], and
flattens NHWC activations HWC-major; torch keeps [cout, cin, kh, kw] and
[out, in] and flattens CHW-major. So:

- Conv_i.kernel -> Conv_i.weight: transpose (3, 2, 0, 1);
- Dense_0.kernel -> Dense_0.weight: rows permuted from (h, w, c) to (c, h, w)
  order, then transposed;
- any other Dense_i.kernel -> Dense_i.weight: transposed;
- biases as they are.

ResNet-9 (models/resnet.py) nests its leaves one or two modules deep:
"ConvGN_1.Conv_0.weight" is params["ConvGN_1"]["Conv_0"]["kernel"]. Its
convolutions move as above, a GroupNorm's `scale` becomes its `weight`
(the bias stays), and its one dense layer follows a global max pool, so
Dense_0.kernel is only transposed. The leaves come out in the order of
the torch module's parameters, the order K1's leaf table reads them.

Arrays are numpy on both sides of the carrier, so it moves weights between
the frameworks without either importing the other.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models.resnet import (
    BLOCKS)


def _flatten_geometry(flax_params) -> tuple:
    """(side, channels) of the activation the first dense layer flattens:
    channels = the last conv's cout, side = sqrt(fan_in / channels)."""
    convs = sorted(k for k in flax_params if k.startswith("Conv"))
    c = int(np.shape(flax_params[convs[-1]]["kernel"])[-1])
    fan_in = int(np.shape(flax_params["Dense_0"]["kernel"])[0])
    return math.isqrt(fan_in // c), c


def _is_resnet(names) -> bool:
    return any(n.split(".")[0].startswith("Residual") for n in names)


def _resnet_from_flax(flax_params, device) -> Dict[str, torch.Tensor]:
    def conv_gn(tree, prefix):
        gn = tree["GroupNorm_0"]
        return {f"{prefix}.Conv_0.weight": np.asarray(
                    tree["Conv_0"]["kernel"], np.float32).transpose(3, 2, 0, 1),
                f"{prefix}.GroupNorm_0.weight": gn["scale"],
                f"{prefix}.GroupNorm_0.bias": gn["bias"]}

    out = {}
    for block in BLOCKS:
        tree = flax_params[block]
        if block.startswith("Residual"):
            for sub in ("ConvGN_0", "ConvGN_1"):
                out.update(conv_gn(tree[sub], f"{block}.{sub}"))
        else:
            out.update(conv_gn(tree, block))
    out["Dense_0.weight"] = np.asarray(flax_params["Dense_0"]["kernel"]).T
    out["Dense_0.bias"] = flax_params["Dense_0"]["bias"]
    return {k: torch.tensor(np.ascontiguousarray(v, np.float32), device=device)
            for k, v in out.items()}


def _resnet_to_flax(params: Dict[str, torch.Tensor]) -> dict:
    out: dict = {}
    for name, t in params.items():
        *mods, leaf = name.split(".")
        a = t.detach().cpu().numpy()
        if mods[-1].startswith("Conv_"):
            leaf, a = "kernel", a.transpose(2, 3, 1, 0)
        elif mods[-1].startswith("GroupNorm") and leaf == "weight":
            leaf = "scale"
        elif mods[-1].startswith("Dense") and leaf == "weight":
            leaf, a = "kernel", a.T
        node = out
        for mod in mods:
            node = node.setdefault(mod, {})
        node[leaf] = np.ascontiguousarray(a)
    return out


def params_from_flax(flax_params, device) -> Dict[str, torch.Tensor]:
    """{"Conv_0": {"kernel", "bias"}, ...} of numpy -> {"Conv_0.weight": ...}."""
    if _is_resnet(flax_params):
        return _resnet_from_flax(flax_params, device)
    h, c = _flatten_geometry(flax_params)
    out = {}
    for mod in sorted(flax_params, key=lambda k: (not k.startswith("Conv"), k)):
        k = np.asarray(flax_params[mod]["kernel"], np.float32)
        if mod.startswith("Conv"):
            w = k.transpose(3, 2, 0, 1)
        elif mod == "Dense_0":
            w = k.reshape(h, h, c, -1).transpose(2, 0, 1, 3).reshape(
                h * h * c, -1).T
        else:
            w = k.T
        out[f"{mod}.weight"] = torch.tensor(np.ascontiguousarray(w),
                                            device=device)
        out[f"{mod}.bias"] = torch.tensor(
            np.asarray(flax_params[mod]["bias"], np.float32), device=device)
    return out


def flax_from_params(params: Dict[str, torch.Tensor]) -> dict:
    """The inverse of `params_from_flax`: a Flax-layout dict of numpy."""
    if _is_resnet(params):
        return _resnet_to_flax(params)
    mods = sorted({name.split(".")[0] for name in params})
    convs = [m for m in mods if m.startswith("Conv")]
    c = params[f"{convs[-1]}.weight"].shape[0]
    fan_in = params["Dense_0.weight"].shape[1]
    h = math.isqrt(fan_in // c)
    out = {}
    for mod in mods:
        w = params[f"{mod}.weight"].detach().cpu().numpy()
        if mod.startswith("Conv"):
            k = w.transpose(2, 3, 1, 0)
        elif mod == "Dense_0":
            k = w.T.reshape(c, h, h, -1).transpose(1, 2, 0, 3).reshape(
                h * h * c, -1)
        else:
            k = w.T
        out[mod] = {"kernel": np.ascontiguousarray(k),
                    "bias": params[f"{mod}.bias"].detach().cpu().numpy()}
    return out
