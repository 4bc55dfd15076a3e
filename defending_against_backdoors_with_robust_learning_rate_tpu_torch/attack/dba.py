"""Distributed trigger splitting (DBA): each corrupt client stamps a shard
of the trojan pattern.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
attack/dba.py` (`split_stamp`, `stamp_for_agent`); "DBA: Distributed
Backdoor Attacks against Federated Learning" (ICLR 2020). The full
pattern's stamped coordinates are dealt round-robin (row-major order)
across all ``num_corrupt`` agents, for every dataset and pattern type,
while the poisoned val set keeps the full pattern (attack/poison.
build_poisoned_val, agent_idx=-1). The reference's hard-coded 4-way split
of the cifar10 plus stays the ``static`` strategy's behavior
(attack/patterns.py). Host-side data poisoning only: the split changes
which pixels each corrupt client's shard stamps when it is built.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.attack.patterns import (
    Stamp, build_stamp)


def split_stamp(stamp: Stamp, shard_idx: int, n_shards: int) -> Stamp:
    """Shard ``shard_idx`` of an ``n_shards``-way round-robin deal of the
    stamp's masked coordinates (row-major order): coordinate j of the
    flattened True-mask positions belongs to shard j % n_shards. The
    shards partition the full pattern exactly."""
    if n_shards <= 0:
        raise ValueError(f"n_shards must be positive, got {n_shards}")
    ys, xs = np.nonzero(stamp.mask)
    keep = np.arange(len(ys)) % n_shards == shard_idx % n_shards
    mask = np.zeros_like(stamp.mask)
    mask[ys[keep], xs[keep]] = True
    return dataclasses.replace(stamp, mask=mask)


def stamp_for_agent(cfg, agent_id: int) -> Stamp:
    """Corrupt agent ``agent_id``'s trigger shard: the full pattern
    (agent_idx=-1 geometry) split num_corrupt ways."""
    full = build_stamp(cfg.data, cfg.pattern_type, agent_idx=-1,
                       data_dir=cfg.data_dir)
    return split_stamp(full, agent_id, max(1, cfg.num_corrupt))
