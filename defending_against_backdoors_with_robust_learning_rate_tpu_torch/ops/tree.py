"""Arithmetic over parameter dicts (name -> tensor).

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
ops/tree.py`. The JAX currency is a Flax param pytree; here it is a flat
dict keyed like a module's `state_dict` ("Conv_0.weight", ...), in the
module's parameter order. A stacked dict holds one such dict per agent
along a leading [m] axis of every leaf (`*_rows` below reduce per agent).
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


def rows(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """An [m] vector shaped to broadcast over a stacked [m, ...] leaf."""
    return v.reshape((-1,) + (1,) * (like.ndim - 1))


def sq_norm_rows(a: Params) -> torch.Tensor:
    """[m] per-agent sums of squares over every leaf of a stacked dict."""
    return sum(torch.sum(torch.square(x.reshape(x.shape[0], -1)), dim=1)
               for x in a.values())


def norm_rows(a: Params) -> torch.Tensor:
    return torch.sqrt(sq_norm_rows(a))


def where_rows(flags: torch.Tensor, a: Params, b: Params) -> Params:
    """Per-agent select by an [m] bool: agent i's rows from `a` where
    flags[i], else from `b` bit for bit."""
    return {k: torch.where(rows(flags, a[k]), a[k], b[k]) for k in a}
