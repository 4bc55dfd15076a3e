"""Trojan-pattern stamps on raw pixels.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
attack/patterns.py` (`Stamp`, `build_stamp`, `apply_stamp`), reference
src/utils.py:181-284 `add_pattern_bd`. Same geometry, same (mask, value)
form; numpy only, since stamping happens once on the host at setup.

fmnist (raw uint8 pixels, pre-normalization):
  - square : x[21:26, 21:26] = 255                         (utils.py:227-230)
  - plus   : start=5, size=5; vertical col 5 rows 5..9;
             horizontal row 7 cols 3..7; value 255          (utils.py:244-253)
synthetic (8x8 stand-in images): a 3x3 corner block set to 255.

Both are SET stamps: the value is written where the mask holds. The additive
watermark patterns (copyright, apple) are not in this slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Stamp:
    mask: np.ndarray          # [H, W] bool: where the pattern applies
    value: np.ndarray         # [H, W] float32: the pattern value


def _plus_mask(h: int, w: int, start: int, size: int) -> np.ndarray:
    m = np.zeros((h, w), dtype=bool)
    m[start:start + size, start] = True
    m[start + size // 2, start - size // 2:start + size // 2 + 1] = True
    return m


def build_stamp(data: str, pattern_type: str) -> Stamp:
    """The stamp for a dataset/pattern (the JAX `build_stamp`'s `agent_idx`
    changes the geometry only for cifar10's distributed pattern, which is
    not in this slice)."""
    if data == "fmnist":
        h = w = 28
        if pattern_type == "square":
            m = np.zeros((h, w), dtype=bool)
            m[21:26, 21:26] = True
            return Stamp(m, np.full((h, w), 255.0, np.float32))
        if pattern_type == "plus":
            return Stamp(_plus_mask(h, w, 5, 5),
                         np.full((h, w), 255.0, np.float32))
    elif data == "synthetic":
        m = np.zeros((8, 8), dtype=bool)
        m[:3, :3] = True
        return Stamp(m, np.full((8, 8), 255.0, np.float32))
    raise ValueError(f"no stamp for data={data!r} pattern={pattern_type!r} "
                     f"in this slice")


def apply_stamp(x: np.ndarray, stamp: Stamp) -> np.ndarray:
    """Stamp images shaped [..., H, W, C]; the dtype is kept."""
    mask = stamp.mask[..., None]            # [H, W, 1] broadcast over channels
    val = stamp.value[..., None].astype(x.dtype)
    return np.where(mask, val, x)
