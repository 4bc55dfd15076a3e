"""Trojan-pattern stamps on raw pixels.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
attack/patterns.py` (`Stamp`, `build_stamp`, `apply_stamp`), reference
src/utils.py:181-284 `add_pattern_bd`. Same geometry, same (mask, value)
form; numpy only, since stamping happens once on the host at setup.

fmnist (raw uint8 pixels, pre-normalization):
  - square : x[21:26, 21:26] = 255                         (utils.py:227-230)
  - plus   : start=5, size=5; vertical col 5 rows 5..9;
             horizontal row 7 cols 3..7; value 255          (utils.py:244-253)
fedemnist (float pixels, already normalized):
  - square : x[21:26, 21:26] = 0                           (utils.py:256-259)
  - plus   : start=8, size=5; vertical col 8 rows 8..12;
             horizontal row 10 cols 6..10; value 0          (utils.py:275-282)
cifar10 (raw uint8, all 3 channels; only 'plus' exists, other patterns
stamp nothing but poisoning still flips labels, as the reference's
`add_pattern_bd` falls through and `poison_dataset` relabels anyway):
  - plus, agent_idx == -1 (the full pattern, the poisoned val set):
      vertical col 5 rows 5..11; horizontal row 8 cols 2..8  (utils.py:192-201)
  - the Distributed Backdoor Attack slice of agent_idx % 4 (utils.py:202-224):
      0: vertical rows 5..8      1: vertical rows 9..11
      2: horizontal cols 2..6    3: horizontal cols 5..8
    value 0.
synthetic (8x8 stand-in images): a 3x3 corner block set to 255.

All are SET stamps: the value is written where the mask holds. The additive
watermark patterns (copyright, apple) are not ported yet.
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


def _cifar10_plus_mask(agent_idx: int) -> np.ndarray:
    """The reference's cifar10 plus (start 5, size 6), whole for agent_idx
    -1, else the agent's quarter of it (utils.py:192-224)."""
    start, size = 5, 6
    row = start + size // 2
    m = np.zeros((32, 32), dtype=bool)
    if agent_idx == -1:
        m[start:start + size + 1, start] = True
        m[row, start - size // 2:start + size // 2 + 1] = True
    elif agent_idx % 4 == 0:      # upper vertical (utils.py:205-208)
        m[start:start + size // 2 + 1, start] = True
    elif agent_idx % 4 == 1:      # lower vertical (utils.py:210-214)
        m[start + size // 2 + 1:start + size + 1, start] = True
    elif agent_idx % 4 == 2:      # left horizontal (utils.py:216-219)
        m[row, start - size // 2:start + size // 4 + 1] = True
    else:                          # right horizontal (utils.py:221-224)
        m[row, start - size // 4 + 1:start + size // 2 + 1] = True
    return m


def build_stamp(data: str, pattern_type: str, agent_idx: int = -1) -> Stamp:
    """The stamp for a dataset/pattern. `agent_idx` -1 is the full pattern
    (the poisoned val set, src/federated.py:42-45); a corrupt agent's id
    (src/agent.py:19-25) changes the geometry only for cifar10's plus,
    the DBA slice."""
    if data in ("fmnist", "fedemnist"):
        h = w = 28
        fill = 255.0 if data == "fmnist" else 0.0
        if pattern_type == "square":
            m = np.zeros((h, w), dtype=bool)
            m[21:26, 21:26] = True
            return Stamp(m, np.full((h, w), fill, np.float32))
        if pattern_type == "plus":
            start = 5 if data == "fmnist" else 8
            return Stamp(_plus_mask(h, w, start, 5),
                         np.full((h, w), fill, np.float32))
    elif data == "cifar10":
        m = (_cifar10_plus_mask(agent_idx) if pattern_type == "plus"
             else np.zeros((32, 32), dtype=bool))
        return Stamp(m, np.zeros((32, 32), np.float32))
    elif data == "synthetic":
        m = np.zeros((8, 8), dtype=bool)
        m[:3, :3] = True
        return Stamp(m, np.full((8, 8), 255.0, np.float32))
    raise ValueError(f"no stamp for data={data!r} pattern={pattern_type!r} "
                     f"in this port")


def apply_stamp(x: np.ndarray, stamp: Stamp) -> np.ndarray:
    """Stamp images shaped [..., H, W, C]; the dtype is kept."""
    mask = stamp.mask[..., None]            # [H, W, 1] broadcast over channels
    val = stamp.value[..., None].astype(x.dtype)
    return np.where(mask, val, x)
