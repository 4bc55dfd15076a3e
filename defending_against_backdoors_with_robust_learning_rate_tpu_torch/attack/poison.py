"""Backdoor poisoning over agent-stacked arrays.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
attack/poison.py` (`select_poison_idxs`, `poison_client_row`,
`poison_agent_shards`, `build_poisoned_val`); reference src/utils.py:160-178
and src/agent.py:19-25. The first `num_corrupt` agents stamp
floor(poison_frac * |base-class samples|) of their samples, chosen by a
numpy Generator seeded from (seed, agent id), and relabel them to
`target_class`, each with the stamp the attack registry gives it
(attack/registry.stamp_for_agent: under `--attack static`, boost or
signflip the agent's own `build_stamp(..., agent_idx=id)`, on cifar10's
plus its quarter of the trigger; under `--attack dba` its round-robin
shard of the full pattern, attack/dba.py). Every data path stamps through
here: the dense build, the Fed-EMNIST users, and so the rows the host
round gathers, and the cohort's rows (data/registry.CohortData). The poisoned val set is every base-class val sample,
stamped with the full pattern and relabeled. Same seeds, same draws: the
arrays are byte-equal to the JAX package's.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.attack import (
    registry as attack_registry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.attack.patterns import (
    apply_stamp, build_stamp)


def select_poison_idxs(labels: np.ndarray, base_class: int, frac: float,
                       rng: np.random.Generator,
                       valid: np.ndarray | None = None) -> np.ndarray:
    """Uniform sample of floor(frac * count) base-class indices (utils.py:161-166)."""
    cand = labels == base_class
    if valid is not None:
        cand = cand & valid
    cand_idxs = np.nonzero(cand)[0]
    k = math.floor(frac * len(cand_idxs))
    if k == 0:
        return np.zeros((0,), dtype=np.int64)
    return rng.choice(cand_idxs, size=k, replace=False)


def poison_client_row(images_row: np.ndarray, labels_row: np.ndarray,
                      size: int, agent_id: int, cfg,
                      seed_offset: int = 1234, stamp=None) -> np.ndarray:
    """Poison one agent's padded row in place with the stamp
    registry.stamp_for_agent gives it (or `stamp`, that stamp cached by
    the caller: the cohort gather's); returns its [max_n] mask. The index
    choice and the label flip do not depend on the strategy."""
    max_n = labels_row.shape[0]
    mask = np.zeros((max_n,), dtype=bool)
    if stamp is None:
        stamp = attack_registry.stamp_for_agent(cfg, agent_id)
    rng = np.random.default_rng(cfg.seed + seed_offset + agent_id)
    valid = np.arange(max_n) < size
    idxs = select_poison_idxs(labels_row, cfg.base_class, cfg.poison_frac,
                              rng, valid=valid)
    if len(idxs) == 0:
        return mask
    images_row[idxs] = apply_stamp(images_row[idxs], stamp).astype(
        images_row.dtype)
    labels_row[idxs] = cfg.target_class
    mask[idxs] = True
    return mask


def poison_agent_shards(images: np.ndarray, labels: np.ndarray,
                        sizes: np.ndarray, cfg
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Poison the first cfg.num_corrupt agents' rows, on copies.
    Returns (images, labels, poison_mask[K, max_n])."""
    images = images.copy()
    labels = labels.copy()
    K, max_n = labels.shape
    poison_mask = np.zeros((K, max_n), dtype=bool)
    for aid in range(min(cfg.num_corrupt, K)):
        poison_mask[aid] = poison_client_row(images[aid], labels[aid],
                                             int(sizes[aid]), aid, cfg)
    return images, labels, poison_mask


def build_poisoned_val(val_images: np.ndarray, val_labels: np.ndarray,
                       cfg) -> Tuple[np.ndarray, np.ndarray]:
    """All base-class val samples, fully stamped and relabeled
    (reference src/federated.py:42-45, poison_all=True, agent_idx=-1)."""
    idxs = np.nonzero(val_labels == cfg.base_class)[0]
    stamp = build_stamp(cfg.data, cfg.pattern_type, agent_idx=-1,
                        data_dir=cfg.data_dir)
    imgs = apply_stamp(val_images[idxs], stamp).astype(val_images.dtype)
    lbls = np.full((len(idxs),), cfg.target_class, dtype=val_labels.dtype)
    return imgs, lbls
