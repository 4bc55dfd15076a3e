"""Client optimizer ops with the reference's torch semantics.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
ops/sgd.py`.

- SGD with momentum, no dampening or nesterov (reference src/agent.py:37-38):
  buf <- mu * buf + g ; p <- p - lr * buf. Callers start every round from
  a zero buffer.
- Global-grad-norm clip (reference src/agent.py:50, `clip_grad_norm_`
  semantics with its 1e-6 epsilon).
- PGD projection of the cumulative update onto the L2 ball of radius `clip`
  (reference src/agent.py:54-60).

`sgd_momentum_step` takes a `valid` flag: a step with valid=False leaves
params and momentum exactly as they were.

The `*_stacked` versions run the same arithmetic per agent over stacked
[m, ...] dicts (fl/client.make_local_train_batched), as JAX vmaps the
one-agent ops over the client axis (fl/client.py `client_opt_step`): the
norm of the clip and of the projection per agent over its leaves, the
step masked per agent by an [m] `valid`. The one-agent versions stay for
the per-agent oracle (fl/client.make_local_train).
"""

from __future__ import annotations

import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops import tree
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.tree import (
    Params)


def clip_by_global_norm(grads: Params, max_norm: float = 10.0) -> Params:
    gnorm = tree.norm(grads)
    scale = torch.clamp(max_norm / (gnorm + 1e-6), max=1.0)
    return {k: g * scale for k, g in grads.items()}


def sgd_momentum_step(params: Params, momentum: Params, grads: Params,
                      lr: float, mu: float, valid):
    """One masked torch-SGD step. `valid` True -> real batch; False -> no-op."""
    new_momentum = {k: mu * momentum[k] + grads[k] for k in momentum}
    new_params = {k: params[k] - lr * new_momentum[k] for k in params}
    return (tree.where(valid, new_params, params),
            tree.where(valid, new_momentum, momentum))


def pgd_project(params: Params, params0: Params, clip: float) -> Params:
    """Project (params - params0) onto the L2 ball of radius `clip`
    (reference src/agent.py:54-60: denom = max(1, ||update|| / clip))."""
    update = {k: params[k] - params0[k] for k in params}
    denom = torch.clamp(tree.norm(update) / clip, min=1.0)
    inv = 1.0 / denom
    return {k: params0[k] + update[k] * inv for k in params}


def clip_by_global_norm_stacked(grads: Params,
                                max_norm: float = 10.0) -> Params:
    gnorm = tree.norm_rows(grads)
    scale = torch.clamp(max_norm / (gnorm + 1e-6), max=1.0)
    return {k: g * tree.rows(scale, g) for k, g in grads.items()}


def sgd_momentum_step_stacked(params: Params, momentum: Params,
                              grads: Params, lr: float, mu: float,
                              valid: torch.Tensor):
    """One masked step per agent; valid [m] bool, False rows untouched."""
    new_momentum = {k: mu * momentum[k] + grads[k] for k in momentum}
    new_params = {k: params[k] - lr * new_momentum[k] for k in params}
    return (tree.where_rows(valid, new_params, params),
            tree.where_rows(valid, new_momentum, momentum))


def pgd_project_stacked(params: Params, params0: Params,
                        clip: float) -> Params:
    """Each agent's (params - params0) onto the L2 ball `clip`; params0 is
    the one unstacked dict every agent started from."""
    update = {k: params[k] - params0[k] for k in params}
    denom = torch.clamp(tree.norm_rows(update) / clip, min=1.0)
    inv = 1.0 / denom
    return {k: params0[k] + update[k] * tree.rows(inv, update[k])
            for k in params}
