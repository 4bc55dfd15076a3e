"""Shared pieces of the train/eval compute path.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
fl/common.py` (`make_normalizer`, `masked_ce`, `masked_ce_segments`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def make_normalizer(mean, std, device, raw_is_normalized: bool = False):
    """Raw NHWC pixels -> normalized NCHW float32 model input:
    (x/255 - mean)/std with the reference constants (src/utils.py:101,
    113-116); fedemnist's inputs come normalized (`raw_is_normalized`) and
    only change layout. The JAX normalizer keeps NHWC for its NHWC model; this one
    moves channels first for the NCHW model. The float conversion copies
    into NCHW strides: for one channel the permuted view's strides
    (H*W, 1, W, 1) read as channels-last, and cuDNN would then run the
    convolutions channels-last and convert layouts around them.
    `.contiguous()` would not do: it takes that view as contiguous and
    returns it unchanged."""
    mean_t = torch.as_tensor(mean, dtype=torch.float32,
                             device=device).reshape(1, -1, 1, 1)
    std_t = torch.as_tensor(std, dtype=torch.float32,
                            device=device).reshape(1, -1, 1, 1)

    def norm(x):
        x = x.permute(0, 3, 1, 2)
        if raw_is_normalized:
            # float32 already: `.to` would hand back the permuted view
            return x.to(torch.float32).clone(
                memory_format=torch.contiguous_format)
        x = x.to(torch.float32, memory_format=torch.contiguous_format)
        return (x / 255.0 - mean_t) / std_t
    return norm


def masked_ce(logits, labels, weights):
    """Cross-entropy mean over the real (unpadded) samples of a batch; the
    batch mean of nn.CrossEntropyLoss (reference src/agent.py:47) when the
    batch is partly padding."""
    ce = F.cross_entropy(logits, labels, reduction="none")
    w = weights.to(torch.float32)
    return torch.sum(ce * w) / torch.clamp(torch.sum(w), min=1.0)


def masked_ce_segments(logits, labels, weights, num_segments: int):
    """`masked_ce` over a client-folded [m*bs, ...] megabatch: one
    cross-entropy pass over the flat batch, then each client's mean from
    the sum over its [bs] segment of the fold. The per-client step masks
    arrive folded into `weights`, so a masked-out sample adds nothing to its
    client's mean; the arithmetic of `masked_ce` per client, reorganized
    (the reduction order may differ in the last bit). The megabatch trainer
    takes its grads and losses from the client-batched `masked_ce`, as JAX
    does; this is their oracle. Returns (total_loss, per_client_loss [m],
    per_client_weight [m])."""
    ce = F.cross_entropy(logits, labels, reduction="none")
    w = weights.to(torch.float32)
    seg_ce = torch.sum((ce * w).reshape(num_segments, -1), dim=1)
    seg_w = torch.sum(w.reshape(num_segments, -1), dim=1)
    per_client = seg_ce / torch.clamp(seg_w, min=1.0)
    return torch.sum(per_client), per_client, seg_w
