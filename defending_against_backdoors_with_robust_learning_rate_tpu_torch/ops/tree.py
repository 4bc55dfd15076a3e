"""Arithmetic over parameter dicts (name -> tensor).

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
ops/tree.py`. The JAX currency is a Flax param pytree; here it is a flat
dict keyed like a module's `state_dict` ("Conv_0.weight", ...), in the
module's parameter order.
"""

from __future__ import annotations

from typing import Dict

import torch

Params = Dict[str, torch.Tensor]


def sq_norm(a: Params) -> torch.Tensor:
    """Sum of squares over every leaf (a 0-d tensor, no host sync)."""
    return sum(torch.sum(torch.square(x)) for x in a.values())


def norm(a: Params) -> torch.Tensor:
    return torch.sqrt(sq_norm(a))


def where(flag, a: Params, b: Params) -> Params:
    """Whole-dict select by a scalar flag: a Python bool picks without
    touching the tensors; a 0-d bool tensor selects elementwise, so a
    False step leaves `b` bit for bit."""
    if isinstance(flag, bool):
        return a if flag else b
    return {k: torch.where(flag, a[k], b[k]) for k in a}
