"""Agent-stacked padded arrays: the device-resident data layout.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
data/arrays.py`. Every agent's shard is stacked into one padded array
`[K, max_n, H, W, C]` (raw pixels, the JAX layout) with the true sizes kept
for loss masking and weighted FedAvg. `stack_agent_shards` and
`stack_uneven_shards` are the numpy twins of the native `pack_shards` and
`pack_uneven` (data/native.py; tests/test_torch_native.py holds them
equal), which the registry calls.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np


@dataclasses.dataclass
class AgentShards:
    images: np.ndarray      # [K, max_n, H, W, C] raw pixels
    labels: np.ndarray      # [K, max_n] int32 (padding rows hold label 0)
    sizes: np.ndarray       # [K] int32 true shard sizes
    poison_mask: np.ndarray | None = None  # [K, max_n] bool, set after poisoning

    @property
    def max_n(self) -> int:
        return self.images.shape[1]


def padded_max_n(sizes: np.ndarray, pad_multiple: int = 1) -> int:
    """The stacked shard length: the largest true shard size rounded up to
    `pad_multiple` (the batch size), so [n_batches, bs] reshapes are exact."""
    max_n = int(sizes.max()) if len(sizes) else 0
    if pad_multiple > 1:
        max_n = ((max_n + pad_multiple - 1) // pad_multiple) * pad_multiple
    return max_n


def stack_agent_shards(images: np.ndarray, labels: np.ndarray,
                       user_groups: Dict[int, Sequence[int]],
                       num_agents: int,
                       pad_multiple: int = 1) -> AgentShards:
    """Gather each agent's indices into a padded stacked array."""
    sizes = np.array([len(user_groups.get(a, ())) for a in range(num_agents)],
                     dtype=np.int32)
    max_n = padded_max_n(sizes, pad_multiple)
    shp = images.shape[1:]
    out_img = np.zeros((num_agents, max_n) + shp, dtype=images.dtype)
    out_lbl = np.zeros((num_agents, max_n), dtype=np.int32)
    for a in range(num_agents):
        idxs = np.asarray(list(user_groups.get(a, ())), dtype=np.int64)
        if len(idxs) == 0:
            continue
        out_img[a, :len(idxs)] = images[idxs]
        out_lbl[a, :len(idxs)] = labels[idxs]
    return AgentShards(out_img, out_lbl, sizes)


def stack_uneven_shards(shard_images: List[np.ndarray],
                        shard_labels: List[np.ndarray],
                        pad_multiple: int = 1) -> AgentShards:
    """Stack pre-split per-user shards (fed-emnist style, uneven sizes)."""
    num_agents = len(shard_images)
    sizes = np.array([len(x) for x in shard_images], dtype=np.int32)
    max_n = padded_max_n(sizes, pad_multiple)
    shp = shard_images[0].shape[1:]
    dtype = shard_images[0].dtype
    out_img = np.zeros((num_agents, max_n) + shp, dtype=dtype)
    out_lbl = np.zeros((num_agents, max_n), dtype=np.int32)
    for a in range(num_agents):
        n = sizes[a]
        out_img[a, :n] = shard_images[a]
        out_lbl[a, :n] = shard_labels[a].astype(np.int32)
    return AgentShards(out_img, out_lbl, sizes)
