"""Client local training: the reference's `Agent.local_train`
(src/agent.py:33-64) over a param dict, one agent at a time (the oracle)
and batched over a block of agents (the round's trainer).

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
fl/client.py` (`make_local_train`, `make_local_train_megabatch`) and the
`jax.vmap(local_train)` of `fl/rounds.vmap_agents`. Semantics kept:

- a fresh SGD(momentum) buffer every round, carried across the epochs;
- `local_ep` epochs, each over a permutation of the shard whose first
  `size` entries shuffle the real samples and whose tail is the padding
  (the JAX shuffle sorts real samples in front the same way);
- batches of `bs` rows with a per-sample weight mask, so a partly padded
  batch takes the mean over its real samples, and a batch with no real
  sample leaves params and momentum exactly as they were;
- per batch, the global-grad-norm clip to 10, the SGD step, then the PGD
  projection onto the L2 ball `clip` when clip > 0;
- the sample-weighted epoch loss, averaged over epochs;
- the update (final - initial params) in f32;
- the straggler lane (JAX fl/client.py:62-140, faults/model.py): an
  optional per-agent epoch budget `ep_budget`; the epochs past it zero
  every batch weight, so their steps are exact no-ops and their epoch
  loss is 0 / max(0, 1) = 0, which still enters the mean over epochs, as
  in JAX. Without a budget the trainers run as before.

Randomness is drawn before training, per sampled slot from the slot's own
generator (`draw_slot`), and passed in: the epoch permutations and the
dropout keep-masks of every step. `torch.func.vmap` cannot draw from a
generator, and the round's captured CUDA graph (fl/rounds.py) replays its
steps on masks copied into its input buffers. The tests inject
permutations replayed from the JAX keys, with dropout off.

`make_local_train` (one agent, a Python loop of steps, all-padding batches
skipped on the host) is the per-agent oracle the tests and chip_smoke.py
hold the batched trainer to. `make_local_train_batched` is the round's
trainer: every agent of a block advances through the same
`local_ep x nb` steps, the grads from one `vmap(grad_and_value)` over the
stacked [m, ...] params, the optimizer tail per agent on the stacked
dicts, padding batches masked no-ops as in JAX, and no host sync inside.
Its two layouts are JAX's `--train_layout` choices: `vmap` gathers each
agent's [bs] rows as one [m, bs] gather; `megabatch` folds the client axis
into the batch (one `index_select` over the flattened agent stack with
per-agent offsets, one normalize over the [m*bs] fold, [m, bs] segment
weights for the loss and the validity bit). The grads come from the
client-batched backward in both, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch.func import functional_call, grad_and_value, vmap

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl.common import (
    masked_ce)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models.cnn import (
    KEEP_PROB)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.sgd import (
    clip_by_global_norm, clip_by_global_norm_stacked, pgd_project,
    pgd_project_stacked, sgd_momentum_step, sgd_momentum_step_stacked)


def draw_slot(gen: torch.Generator, size: int, n_total: int, cfg,
              shapes: Sequence[int]):
    """One sampled slot's draws from its own generator, in a fixed order:
    the `local_ep` epoch permutations ([local_ep, n_total]: the `size` real
    samples in a random order, then the padding rows in place), then for
    each dropout site of feature count F in `shapes` one bulk draw of the
    keep masks of every step, [local_ep, nb, bs, F] bool (keep with probability
    0.5, as Flax). nb = n_total // bs of the padded stack, the same for
    every agent, so a slot's draws never depend on m, on the ranks or on
    the other slots. Empty `shapes` (dropout off) draws no mask and gives
    keep=None."""
    device = gen.device
    tail = torch.arange(size, n_total, device=device)
    perms = torch.stack([
        torch.cat([torch.randperm(size, generator=gen, device=device), tail])
        for _ in range(cfg.local_ep)])
    nb = n_total // cfg.bs
    keep = tuple(torch.rand((cfg.local_ep, nb, cfg.bs, f), generator=gen,
                            device=device) < KEEP_PROB for f in shapes)
    return perms, (keep or None)


def _client_loss(model):
    """loss(p, x, y, w, keep) of one client's batch through functional_call."""
    def loss(p, x, y, w, keep):
        logits = functional_call(model, p, (x,), {"keep": keep})
        return masked_ce(logits, y, w)
    return loss


def make_local_train(model, cfg, normalize):
    """The per-agent oracle. Returns local_train(params0, images, labels,
    size, perms, keep=None, ep_budget=None) -> (update dict, mean epoch
    loss, 0-d tensor).

    images: [n_total, H, W, C] raw pixels with n_total a multiple of cfg.bs;
    labels: [n_total] int64; size: the true shard size (a Python int);
    perms: cfg.local_ep permutations of range(n_total), real samples first;
    keep: the slot's keep-masks from `draw_slot` (one [local_ep, nb, bs, F]
    tensor per dropout site), or None for no dropout; ep_budget: the
    straggler's epoch budget (a Python int), or None for all local_ep. A
    batch with no real sample is skipped on the host: the rest of the
    epoch is padding, or the epoch is past the budget."""
    bs = cfg.bs
    loss_fn = _client_loss(model)

    def local_train(params0, images, labels, size: int,
                    perms: Sequence[torch.Tensor],
                    keep: Optional[Tuple[torch.Tensor, ...]] = None,
                    ep_budget: Optional[int] = None):
        n_total = images.shape[0]
        if n_total % bs:
            raise ValueError(f"shard length {n_total} is not a multiple of "
                             f"bs={bs}")
        pos = torch.arange(bs, device=images.device)
        params0 = {k: v.detach().to(torch.float32) for k, v in params0.items()}
        params = params0
        mom = {k: torch.zeros_like(v) for k, v in params0.items()}
        ep_losses = []
        for e, perm in enumerate(perms):
            loss_sum = torch.zeros((), device=images.device)
            n_seen = 0
            active = ep_budget is None or e < ep_budget
            for b in range(n_total // bs):
                n_real = min(bs, size - b * bs) if active else 0
                if n_real <= 0:
                    break       # padding, or past the budget: no-ops
                idx = perm[b * bs:(b + 1) * bs]
                x = normalize(images[idx])
                y = labels[idx]
                w = pos < n_real
                k_eb = (None if keep is None
                        else tuple(site[e, b] for site in keep))
                p = {k: v.detach().requires_grad_(True)
                     for k, v in params.items()}
                loss = loss_fn(p, x, y, w, k_eb)
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


def make_local_train_batched(model, cfg, normalize, layout: str = "vmap"):
    """The block trainer, JAX's `vmap(local_train)` (layout 'vmap') or
    `make_local_train_megabatch` (layout 'megabatch'). Returns
    train(params0, images, labels, agents, sizes, perms, keep=None,
    ep_budget=None) -> (updates {leaf: [m, ...]}, losses [m]).

    images [K, n_total, H, W, C] and labels [K, n_total] are the whole
    device-resident stacks; agents [m] the block's agent ids and sizes [m]
    their true shard sizes, both on the device; perms [m, local_ep,
    n_total] and keep (one [m, local_ep, nb, bs, F] bool per dropout site,
    or None) the block's draws stacked per slot; ep_budget ([m] int32 on
    the device, or None) the stragglers' epoch budgets. Where JAX takes the
    gathered [m, n_total] block, this gathers each step's rows straight
    from the K-agent stack by agent id. Every step runs for every agent; a
    step with no real sample for an agent leaves its params and momentum
    as they were (JAX's masked step), then PGD projects as in JAX. No host
    sync: the steps can be captured in a CUDA graph. `layout` comes
    validated from utils/compile_cache.resolved_train_layout."""
    bs = cfg.bs
    loss_fn = _client_loss(model)
    grad_clients = {with_keep: vmap(grad_and_value(loss_fn),
                                    in_dims=(0, 0, 0, 0,
                                             0 if with_keep else None))
                    for with_keep in (True, False)}

    def train(params0, images, labels, agents, sizes, perms, keep=None,
              ep_budget=None):
        m, n_total = agents.shape[0], images.shape[1]
        if n_total % bs:
            raise ValueError(f"shard length {n_total} is not a multiple of "
                             f"bs={bs}")
        nb = n_total // bs
        img_shape = images.shape[2:]
        pos = torch.arange(bs, device=images.device)
        params0 = {k: v.detach().to(torch.float32) for k, v in params0.items()}
        params = {k: v.expand((m,) + v.shape).clone()
                  for k, v in params0.items()}
        mom = {k: torch.zeros_like(v) for k, v in params.items()}
        if layout == "megabatch":
            flat_images = images.reshape((-1,) + img_shape)
            flat_labels = labels.reshape(-1)
            offsets = (agents * n_total)[:, None]
        sizes = sizes[:, None]
        grads_of = grad_clients[keep is not None]
        ep_losses = []
        for e in range(cfg.local_ep):
            ep_active = None if ep_budget is None else (e < ep_budget)[:, None]
            loss_sum = torch.zeros(m, device=images.device)
            w_sum = torch.zeros(m, device=images.device)
            for b in range(nb):
                idx = perms[:, e, b * bs:(b + 1) * bs]          # [m, bs]
                if layout == "megabatch":
                    flat_idx = (idx + offsets).reshape(-1)
                    x = normalize(flat_images.index_select(0, flat_idx))
                    y = flat_labels.index_select(0, flat_idx)
                else:
                    rows = agents[:, None]
                    x = normalize(images[rows, idx].reshape(
                        (m * bs,) + img_shape))
                    y = labels[rows, idx]
                x = x.reshape((m, bs) + x.shape[1:])
                y = y.reshape(m, bs)
                w = (b * bs + pos)[None, :] < sizes              # [m, bs]
                if ep_active is not None:
                    w = w & ep_active
                k_eb = (None if keep is None
                        else tuple(site[:, e, b] for site in keep))
                grads, per_client = grads_of(params, x, y, w, k_eb)
                w_n = torch.sum(w.to(torch.float32), dim=1)      # [m]
                with torch.no_grad():
                    grads = clip_by_global_norm_stacked(grads, 10.0)
                    params, mom = sgd_momentum_step_stacked(
                        params, mom, grads, cfg.client_lr, cfg.client_moment,
                        w_n > 0)
                    if cfg.clip > 0:
                        params = pgd_project_stacked(params, params0,
                                                     cfg.clip)
                loss_sum = loss_sum + per_client.detach() * w_n
                w_sum = w_sum + w_n
            ep_losses.append(loss_sum / torch.clamp(w_sum, min=1.0))
        update = {k: (params[k] - params0[k]).detach() for k in params}
        return update, torch.mean(torch.stack(ep_losses), dim=0)

    return train
