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

Arrays are numpy on both sides of the carrier, so it moves weights between
the frameworks without either importing the other.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def _flatten_geometry(flax_params) -> tuple:
    """(side, channels) of the activation the first dense layer flattens:
    channels = the last conv's cout, side = sqrt(fan_in / channels)."""
    convs = sorted(k for k in flax_params if k.startswith("Conv"))
    c = int(np.shape(flax_params[convs[-1]]["kernel"])[-1])
    fan_in = int(np.shape(flax_params["Dense_0"]["kernel"])[0])
    return math.isqrt(fan_in // c), c


def params_from_flax(flax_params, device) -> Dict[str, torch.Tensor]:
    """{"Conv_0": {"kernel", "bias"}, ...} of numpy -> {"Conv_0.weight": ...}."""
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
