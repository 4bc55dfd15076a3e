"""Client local training: the reference's `Agent.local_train`
(src/agent.py:33-64) over a param dict.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
fl/client.py` (`make_local_train`). Semantics kept:

- a fresh SGD(momentum) buffer every round, carried across the epochs;
- `local_ep` epochs, each over a permutation of the shard whose first
  `size` entries shuffle the real samples and whose tail is the padding
  (the JAX shuffle sorts real samples in front the same way);
- batches of `bs` rows with a per-sample weight mask, so a partly padded
  batch takes the mean over its real samples; a batch with no real sample
  is an exact no-op (params and momentum untouched), decided on the host
  from the shard size, so it is skipped without a launch;
- per batch, the global-grad-norm clip to 10, the SGD step, then the PGD
  projection onto the L2 ball `clip` when clip > 0;
- the sample-weighted epoch loss, averaged over epochs;
- the update (final - initial params) in f32.

The epoch permutations and the dropout generator are arguments: the round
draws them (`draw_perms`, fl/rounds.RoundRNG), and the tests inject them,
with dropout off, to hold this function against the JAX one.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch.func import functional_call

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl.common import (
    masked_ce)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.sgd import (
    clip_by_global_norm, pgd_project, sgd_momentum_step)


def draw_perms(size: int, n_total: int, local_ep: int, gen: torch.Generator,
               device) -> list:
    """One [n_total] permutation per epoch: the `size` real samples in a
    random order, then the padding rows in place."""
    tail = torch.arange(size, n_total, device=device)
    return [torch.cat([torch.randperm(size, generator=gen, device=device),
                       tail]) for _ in range(local_ep)]


def make_local_train(model, cfg, normalize):
    """Returns local_train(params0, images, labels, size, perms,
    dropout_gen=None) -> (update dict, mean epoch loss as a 0-d tensor).

    images: [n_total, H, W, C] raw pixels with n_total a multiple of cfg.bs;
    labels: [n_total] int64; size: the true shard size (a Python int);
    perms: cfg.local_ep permutations of range(n_total), real samples first;
    dropout_gen: the generator of the dropout masks, or None for none."""
    bs = cfg.bs

    def local_train(params0, images, labels, size: int,
                    perms: Sequence[torch.Tensor],
                    dropout_gen: Optional[torch.Generator] = None):
        n_total = images.shape[0]
        if n_total % bs:
            raise ValueError(f"shard length {n_total} is not a multiple of "
                             f"bs={bs}")
        pos = torch.arange(bs, device=images.device)
        params0 = {k: v.detach().to(torch.float32) for k, v in params0.items()}
        params = params0
        mom = {k: torch.zeros_like(v) for k, v in params0.items()}
        ep_losses = []
        for perm in perms:
            loss_sum = torch.zeros((), device=images.device)
            n_seen = 0
            for b in range(n_total // bs):
                n_real = min(bs, size - b * bs)
                if n_real <= 0:
                    break       # the rest of the epoch is padding: no-ops
                idx = perm[b * bs:(b + 1) * bs]
                x = normalize(images[idx])
                y = labels[idx]
                w = pos < n_real
                p = {k: v.detach().requires_grad_(True)
                     for k, v in params.items()}
                logits = functional_call(model, p, (x,),
                                         {"dropout_gen": dropout_gen})
                loss = masked_ce(logits, y, w)
                grads = dict(zip(p, torch.autograd.grad(loss, list(p.values())),
                                 strict=True))
                with torch.no_grad():
                    grads = clip_by_global_norm(grads, 10.0)
                    params, mom = sgd_momentum_step(
                        params, mom, grads, cfg.client_lr, cfg.client_moment,
                        True)
                    if cfg.clip > 0:
                        params = pgd_project(params, params0, cfg.clip)
                loss_sum = loss_sum + loss.detach() * n_real
                n_seen += n_real
            ep_losses.append(loss_sum / max(n_seen, 1))
        update = {k: (params[k] - params0[k]).detach() for k in params}
        return update, torch.mean(torch.stack(ep_losses))

    return local_train
