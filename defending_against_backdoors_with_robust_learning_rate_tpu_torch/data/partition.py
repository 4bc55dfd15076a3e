"""Label-sorted shard partitioner.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
data/partition.py` (kept as this package's own copy: the port imports
nothing of the JAX package). Semantics-parity reimplementation of the
reference's `distribute_data` (src/utils.py:58-92): sort indices by label, split each class's index list
into `slice_size` strided chunks (`seq[i::size]`), then deal `class_per_agent`
chunks to each agent walking classes 0..n_classes-1 round-robin-with-deletion.

Divergence (documented): the reference sorts with `torch.sort`, which is not
stable; we use a stable numpy argsort so partitions are deterministic
(SURVEY.md 2.3.12 — the build adds determinism).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np


def distribute_data(labels: np.ndarray, num_agents: int,
                    n_classes: int = 10,
                    class_per_agent: int = 10) -> Dict[int, List[int]]:
    """Map agent id -> list of dataset indices (src/utils.py:58-92)."""
    n = len(labels)
    if num_agents == 1:
        return {0: list(range(n))}

    order = np.argsort(labels, kind="stable")
    labels_dict: Dict[int, List[List[int]]] = defaultdict(list)
    per_class: Dict[int, List[int]] = defaultdict(list)
    for idx in order:
        per_class[int(labels[idx])].append(int(idx))

    # split each class's indices into `slice_size` strided chunks
    shard_size = n // (num_agents * class_per_agent)
    if shard_size == 0:
        raise ValueError(
            f"dataset too small to partition: {n} samples cannot give "
            f"{num_agents} agents x {class_per_agent} class-shards each "
            f"(need >= {num_agents * class_per_agent}). The reference's "
            f"dealing scheme (src/utils.py:58-92) has the same bound.")
    slice_size = (n // n_classes) // shard_size
    for k, v in per_class.items():
        labels_dict[k] = [v[i::slice_size] for i in range(slice_size)]

    # deal chunks to agents (src/utils.py:82-92, incl. the `j % n_classes` quirk
    # which equals `j` since j < n_classes)
    dict_users: Dict[int, List[int]] = defaultdict(list)
    for user_idx in range(num_agents):
        class_ctr = 0
        for j in range(n_classes):
            if class_ctr == class_per_agent:
                break
            elif len(labels_dict[j]) > 0:
                dict_users[user_idx] += labels_dict[j][0]
                del labels_dict[j % n_classes][0]
                class_ctr += 1
    return dict(dict_users)
