"""The bucketed flat layout of the sharded round's `--agg_layout bucket`
server step: the update dict flattened once into a few fixed-size
buckets, one reduce_scatter per bucket, the weighted average and the RLR
vote on the scattered shard, one all_gather of the LR-scaled result.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
parallel/buckets.py` (`BUCKET_BYTES`, `BucketLayout`, `layout_for_leaves`,
`layout_for_stacked`, `flatten_stacked`, `flatten_tree`, `unflatten`,
`device_shard`, `shard_coord_index`, `gathered_to_flat`), with its
coordinate order, padding and bucket size, so that a flat index names
the same coordinate in both packages:

- the leaves are flattened in the dict's order (the module's parameter
  order, JAX's pytree order) into `total` real coordinates;
- the flat space is padded with explicit zeros up to `n_buckets *
  bucket`, `bucket` divisible by the d ranks;
- `n_buckets = ceil(total * 4 bytes / BUCKET_BYTES)`: CNN_MNIST takes
  one bucket, ResNet-9 (4.9 M f32 coordinates) two.

A layout is a pure function of (leaf shapes, dtypes, d, bucket bytes) and
is memoized on that key.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence, Tuple

import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.tree import (
    Params)

# per-bucket payload ceiling (JAX's): one bucket up to 4 M f32 coordinates
BUCKET_BYTES = 16 << 20


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """One flattened update space: the leaves' `shapes`, `sizes` and
    `offsets` in order, `total` real coordinates, `padded = n_buckets *
    bucket`, and `bucket % d == 0`, so each rank's per-bucket shard of
    the reduce_scatter is `bucket // d`."""
    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    total: int
    padded: int
    n_buckets: int
    bucket: int
    d: int

    @property
    def shard(self) -> int:
        """Per-bucket, per-rank shard length of the scattered result."""
        return self.bucket // self.d

    @property
    def device_len(self) -> int:
        """Scattered coordinates one rank holds (all buckets)."""
        return self.n_buckets * self.shard


@functools.lru_cache(maxsize=64)
def _layout(leaf_key: Tuple[Tuple[Tuple[int, ...], str], ...], d: int,
            bucket_bytes: int) -> BucketLayout:
    shapes = tuple(s for s, _ in leaf_key)
    sizes = tuple(math.prod(s) for s in shapes)
    offsets, off = [], 0
    for n in sizes:
        offsets.append(off)
        off += n
    total = off
    # 4 bytes a coordinate: the flat space is f32 whatever the leaf dtype
    n_buckets = max(1, -(-total * 4 // bucket_bytes))
    bucket = -(-total // n_buckets)
    bucket += -bucket % max(d, 1)            # divisible by the d ranks
    return BucketLayout(shapes=shapes, sizes=sizes, offsets=tuple(offsets),
                        total=total, padded=n_buckets * bucket,
                        n_buckets=n_buckets, bucket=bucket, d=d)


def _key(shapes: Sequence[Tuple[int, ...]], dtypes) -> tuple:
    return tuple((tuple(s), str(t)) for s, t in zip(shapes, dtypes))


def layout_for_leaves(tree: Params, d: int,
                      bucket_bytes: int = 0) -> BucketLayout:
    """The layout of a params-shaped dict; `bucket_bytes` 0 is
    BUCKET_BYTES (read at the call, so a test can shrink it)."""
    return _layout(_key([v.shape for v in tree.values()],
                        [v.dtype for v in tree.values()]),
                   d, bucket_bytes or BUCKET_BYTES)


def layout_for_stacked(tree: Params, d: int,
                       bucket_bytes: int = 0) -> BucketLayout:
    """The layout of a dict of [mb, ...] stacked leaves: the agent axis is
    stripped, so the stacked and aggregate views share one layout."""
    return _layout(_key([v.shape[1:] for v in tree.values()],
                        [v.dtype for v in tree.values()]),
                   d, bucket_bytes or BUCKET_BYTES)


def flatten_stacked(layout: BucketLayout, tree: Params) -> torch.Tensor:
    """[mb, ...] stacked leaves -> one new [mb, padded] f32 matrix, zeros
    in the padding."""
    leaves = list(tree.values())
    mb = leaves[0].shape[0]
    flat = torch.cat([v.reshape(mb, -1).to(torch.float32) for v in leaves],
                     dim=1)
    pad = layout.padded - layout.total
    return torch.nn.functional.pad(flat, (0, pad)) if pad else flat


def flatten_tree(layout: BucketLayout, tree: Params) -> torch.Tensor:
    """Params-shaped dict -> one [padded] f32 vector, zeros in the padding
    (routes per-leaf values, the server noise, through the layout)."""
    flat = torch.cat([v.reshape(-1).to(torch.float32)
                      for v in tree.values()])
    pad = layout.padded - layout.total
    return torch.nn.functional.pad(flat, (0, pad)) if pad else flat


def unflatten(layout: BucketLayout, flat: torch.Tensor,
              names: Sequence[str]) -> Params:
    """[padded] (or longer; the tail is ignored) flat vector -> a dict of
    f32 leaves named `names`, views of it: `flatten_tree`'s inverse."""
    return {k: flat[o:o + n].view(s)
            for k, o, n, s in zip(names, layout.offsets, layout.sizes,
                                  layout.shapes, strict=True)}


def device_shard(layout: BucketLayout, flat_1d: torch.Tensor,
                 device_pos: int) -> torch.Tensor:
    """Rank `device_pos`'s scattered coordinates of a replicated [padded]
    vector: the [shard] slice of every bucket, concatenated, which is what
    the per-bucket reduce_scatter leaves on that rank."""
    return torch.cat([
        flat_1d[b * layout.bucket + device_pos * layout.shard:
                b * layout.bucket + (device_pos + 1) * layout.shard]
        for b in range(layout.n_buckets)])


def shard_coord_index(layout: BucketLayout, device_pos: int,
                      device=None) -> torch.Tensor:
    """[device_len] global flat index of rank `device_pos`'s scattered
    coordinates; compare with `layout.total` to mask the padding out of
    shard-local statistics."""
    per_bucket = torch.arange(layout.shard, dtype=torch.int64, device=device)
    return torch.cat([b * layout.bucket + device_pos * layout.shard
                      + per_bucket for b in range(layout.n_buckets)])


def gathered_to_flat(layout: BucketLayout,
                     gathered_rows: torch.Tensor) -> torch.Tensor:
    """[d, device_len] all-gathered rank rows -> the replicated [padded]
    flat vector: rank i's row holds its [shard] slice of each bucket back
    to back, so the bucket-major reassembly is a transpose."""
    rows = gathered_rows.reshape(layout.d, layout.n_buckets, layout.shard)
    return rows.transpose(0, 1).reshape(layout.padded)
