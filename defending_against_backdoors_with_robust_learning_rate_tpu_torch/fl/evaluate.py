"""Evaluation: loss, accuracy, per-class accuracy on padded batches.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
fl/evaluate.py` (`pad_eval_set`, `make_eval_fn`); reference
src/utils.py:128-157. The eval set is padded to whole batches of `bs`, and
padding samples carry weight 0. The confusion matrix is a scatter-add of
the weights into the flat [n_classes * n_classes] counts.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call


def pad_eval_set(images: np.ndarray, labels: np.ndarray, bs: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad to a multiple of bs and reshape to [nb, bs, ...] + weight mask."""
    n = len(labels)
    nb = max(1, -(-n // bs))
    pad = nb * bs - n
    if pad:
        images = np.concatenate([images, np.zeros((pad,) + images.shape[1:],
                                                  images.dtype)])
        labels = np.concatenate([labels, np.zeros((pad,), labels.dtype)])
    w = (np.arange(nb * bs) < n).astype(np.float32)
    return (images.reshape((nb, bs) + images.shape[1:]),
            labels.reshape(nb, bs).astype(np.int64),
            w.reshape(nb, bs))


def make_eval_fn(model, normalize, n_classes: int = 10):
    """Returns eval_fn(params, images[nb,bs,...], labels[nb,bs],
    weights[nb,bs]) -> (avg_loss, accuracy, per_class_accuracy[n_classes]),
    as tensors on the params' device."""

    @torch.no_grad()
    def eval_fn(params, images, labels, weights):
        device = weights.device
        loss_sum = torch.zeros((), device=device)
        correct = torch.zeros((), device=device)
        conf = torch.zeros(n_classes * n_classes, device=device)
        for x, y, w in zip(images, labels, weights, strict=True):
            logits = functional_call(model, params, (normalize(x),))
            ce = F.cross_entropy(logits, y, reduction="none")
            pred = torch.argmax(logits, dim=-1)
            loss_sum += torch.sum(ce * w)
            correct += torch.sum((pred == y) * w)
            conf.index_add_(0, y * n_classes + pred, w)
        conf = conf.view(n_classes, n_classes)
        n = torch.sum(weights)
        per_class = torch.diag(conf) / torch.clamp(conf.sum(dim=1), min=1.0)
        # f32 rounding can push correct/n a hair above 1.0; clamp the ratios
        acc = torch.clamp(correct / n, 0.0, 1.0)
        return loss_sum / n, acc, torch.clamp(per_class, 0.0, 1.0)

    return eval_fn
