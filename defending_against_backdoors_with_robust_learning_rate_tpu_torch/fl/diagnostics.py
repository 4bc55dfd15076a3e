"""The reference's research diagnostics: update norms, the Fisher and the
sign-agreement scalars (C13).

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
fl/diagnostics.py` (`clip_updates`, `per_agent_norms`, `norm_scalars`,
`make_fisher_fn`, `sign_agreement`); reference src/aggregation.py:77-191,
commented out of its round loop and switched on here by
``--diagnostics`` (``--top_frac`` sets the sign-agreement's top k).

- `clip_updates` (aggregation.py:77-81): server-side per-agent L2 clip;
  the reference never calls it, nor does the round.
- `per_agent_norms` and `norm_scalars` (`plot_norms`, aggregation.py:
  83-100): the mean update L2 of the honest and of the corrupt sampled
  agents, the ``Norms/*`` rows. The defense telemetry (obs/telemetry.py)
  reads `per_agent_norms` too.
- `make_fisher_fn` (`comp_diag_fisher`, aggregation.py:102-129): the
  diagonal Fisher over the poisoned val set, with the reference's quirk:
  it differentiates the raw picked logits (times the padding weights,
  summed over a padded batch), not their log-softmax; each batch's
  gradient is squared and summed over the batches, then divided by the
  set's size. The honest variant relabels everything to ``base_class``.
  One `torch.func.grad` over `functional_call` per batch of the padded
  set, as JAX scans its batches.
- `sign_agreement` (`plot_sign_agreement`, aggregation.py:132-191): ranks
  the coordinates by adversarial and by honest Fisher mass, intersects the
  top ``top_frac`` of each with the coordinates the RLR vote kept (lr =
  +server_lr) and flipped (-server_lr), and gives the seven ``Sign/*`` L2
  scalars and the cumulative net movement. Host numpy, a copy of JAX's.

The flat vectors are the params' leaves in the port's order (`flat`); the
set algebra does not depend on the order, as JAX's ravel order is its own.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch.func import functional_call, grad

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.tree import (
    Params, norm_rows, rows)


def clip_updates(stacked_updates: Params, clip: float) -> Params:
    """Server-side per-agent L2 clip (aggregation.py:77-81):
    u <- u / max(1, ||u|| / clip), per agent row."""
    denom = torch.clamp(per_agent_norms(stacked_updates) / clip, min=1.0)
    return {k: u / rows(denom, u) for k, u in stacked_updates.items()}


def per_agent_norms(stacked_updates: Params) -> torch.Tensor:
    """[m] L2 norms of the stacked agent updates."""
    return norm_rows(stacked_updates)


def flat(tree: Params) -> torch.Tensor:
    """Every leaf of a param dict, raveled and concatenated in its order."""
    return torch.cat([v.reshape(-1) for v in tree.values()])


def norm_scalars(norms, sampled_ids, num_corrupt: int) -> Dict[str, float]:
    """The mean honest and corrupt update norms (aggregation.py:83-100);
    a sampled id below num_corrupt is corrupt (agent.py:19)."""
    norms = np.asarray(norms)
    corrupt = np.asarray(sampled_ids) < num_corrupt
    out = {}
    if (~corrupt).any():
        out["Norms/Avg_Honest_L2"] = float(norms[~corrupt].mean())
    if corrupt.any():
        out["Norms/Avg_Corrupt_L2"] = float(norms[corrupt].mean())
    return out


def make_fisher_fn(model, normalize):
    """fisher(params, images [nb, bs, ...], labels [nb, bs], weights
    [nb, bs]) -> {name: diagonal Fisher} (aggregation.py:102-129, the
    quirk in the module doc), on the params' device."""

    def picked_sum(params, x, y, w):
        logits = functional_call(model, params, (normalize(x),))
        picked = torch.gather(logits, 1, y[:, None])[:, 0]
        return torch.sum(picked * w)

    batch_grad = grad(picked_sum)

    def fisher(params, images, labels, weights):
        n = torch.sum(weights)
        params = {k: v.detach() for k, v in params.items()}
        out = {k: torch.zeros_like(v) for k, v in params.items()}
        for x, y, w in zip(images, labels, weights, strict=True):
            g = batch_grad(params, x, y, w)
            out = {k: c + torch.square(g[k]) / n for k, c in out.items()}
        return out

    return fisher


def sign_agreement(lr_flat: np.ndarray, update_flat: np.ndarray,
                   fisher_adv_flat: np.ndarray, fisher_hon_flat: np.ndarray,
                   top_frac: int, server_lr: float,
                   cum_net_mov: float) -> Tuple[Dict[str, float], float]:
    """The Sign/* scalars (aggregation.py:132-191). Returns (scalars,
    new_cum_net_mov)."""
    n_idxs = top_frac
    adv_top = np.argsort(fisher_adv_flat)[-n_idxs:]
    hon_top = np.argsort(fisher_hon_flat)[-n_idxs:]
    min_idxs = np.nonzero(lr_flat == -server_lr)[0]
    max_idxs = np.nonzero(lr_flat == server_lr)[0]

    max_adv = np.intersect1d(adv_top, max_idxs)
    max_hon = np.intersect1d(hon_top, max_idxs)
    min_adv = np.intersect1d(adv_top, min_idxs)
    min_hon = np.intersect1d(hon_top, min_idxs)

    def l2(idxs_a, idxs_b):
        only = np.setdiff1d(idxs_a, idxs_b)
        return float(np.linalg.norm(update_flat[only]))

    max_adv_l2 = l2(max_adv, max_hon)
    max_hon_l2 = l2(max_hon, max_adv)
    min_adv_l2 = l2(min_adv, min_hon)
    min_hon_l2 = l2(min_hon, min_adv)

    net_adv = max_adv_l2 - min_adv_l2
    net_hon = max_hon_l2 - min_hon_l2
    cum_net_mov += net_hon - net_adv
    scalars = {
        "Sign/Hon_Maxim_L2": max_hon_l2,
        "Sign/Adv_Maxim_L2": max_adv_l2,
        "Sign/Adv_Minim_L2": min_adv_l2,
        "Sign/Hon_Minim_L2": min_hon_l2,
        "Sign/Adv_Net_L2": net_adv,
        "Sign/Hon_Net_L2": net_hon,
        "Sign/Model_Net_L2_Cumulative": cum_net_mov,
    }
    return scalars, cum_net_mov
