"""Trojan-pattern stamps on raw pixels.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
attack/patterns.py` (`Stamp`, `build_stamp`, `apply_stamp`,
`_asset_search_path`, `_load_watermark`, `_procedural_watermark`),
reference src/utils.py:181-284 `add_pattern_bd`. Same geometry, same
(mode, mask, value) form; numpy only, since stamping happens once on the
host at setup.

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
copyright / apple (the watermark and apple marks, utils.py:232-242 and
:261-273): on fmnist an additive inverted mark whose uint8 addition wraps
mod 256 (`ADD_WRAP_U8`, PARITY.md quirk 10, SURVEY.md 2.3.10, reproduced);
on fedemnist x -= mark / 255 (`SUB_FLOAT`).

The other stamps are SET: the value is written where the mask holds.

Watermark assets: the reference loads `../watermark.png` / `../apple.png`
with cv2 (utils.py:233-241). They are looked for on `_asset_search_path`;
where none is found (or cv2 is not installed) the mark is JAX's
deterministic procedural stand-in, seeded from `hash(name)` as JAX seeds
it: string hashes change from process to process (PYTHONHASHSEED), so the
fallback mark is the same only within one process (PARITY.md records it).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

# stamp modes
SET = "set"            # x[mask] = value
ADD_WRAP_U8 = "addu8"  # x = uint8(x + value)  (wraps mod 256, quirk-parity)
SUB_FLOAT = "subf"     # x = x - value


@dataclasses.dataclass(frozen=True)
class Stamp:
    mode: str
    mask: np.ndarray          # [H, W] bool: where the pattern applies
    value: np.ndarray         # [H, W] float32: the pattern value / additive
                              # trojan


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


def _asset_search_path(data_dir: str):
    """Where the watermark/apple PNGs are looked for, in order: the
    `RLR_ASSET_DIR` env var, the data dir, `.`, the data dir's parent (the
    reference loads `../watermark.png` relative to src/, utils.py:233), and
    `assets/` at the repository root, beside both packages."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = os.environ.get("RLR_ASSET_DIR")
    return tuple(p for p in (
        env, data_dir, ".", os.path.dirname(data_dir or "."),
        os.path.join(os.path.dirname(here), "assets")) if p)


def _load_watermark(name: str, data_dir: str) -> Optional[np.ndarray]:
    """cv2-load + invert + cubic resize to 28x28, as utils.py:233-241; None
    where no readable file is found or cv2 is not installed."""
    for base in _asset_search_path(data_dir):
        path = os.path.join(base or ".", name)
        if os.path.exists(path):
            try:
                import cv2
                img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
                if img is None:
                    continue
                img = cv2.bitwise_not(img)
                return cv2.resize(img, dsize=(28, 28),
                                  interpolation=cv2.INTER_CUBIC).astype(
                                      np.float32)
            except Exception:  # noqa: BLE001 — JAX's loader skips the file
                continue
    return None


def _procedural_watermark(name: str) -> np.ndarray:
    """JAX's deterministic stand-in where the PNG assets are absent: a 7x7
    random bit pattern blown up to 28x28, seeded from hash(name)."""
    rng = np.random.default_rng(abs(hash(name)) % (2 ** 31))
    base = (rng.random((7, 7)) > 0.5).astype(np.float32) * 255.0
    return np.kron(base, np.ones((4, 4), dtype=np.float32))


def _watermark(pattern_type: str, data_dir: str) -> np.ndarray:
    name = "watermark.png" if pattern_type == "copyright" else "apple.png"
    troj = _load_watermark(name, data_dir)
    return _procedural_watermark(name) if troj is None else troj


def build_stamp(data: str, pattern_type: str, agent_idx: int = -1,
                data_dir: str = "./data") -> Stamp:
    """The stamp for a dataset/pattern. `agent_idx` -1 is the full pattern
    (the poisoned val set, src/federated.py:42-45); a corrupt agent's id
    (src/agent.py:19-25) changes the geometry only for cifar10's plus,
    the DBA slice. `data_dir` is searched for the watermark assets."""
    if data in ("fmnist", "fedemnist"):
        h = w = 28
        fill = 255.0 if data == "fmnist" else 0.0
        if pattern_type == "square":
            m = np.zeros((h, w), dtype=bool)
            m[21:26, 21:26] = True
            return Stamp(SET, m, np.full((h, w), fill, np.float32))
        if pattern_type == "plus":
            start = 5 if data == "fmnist" else 8
            return Stamp(SET, _plus_mask(h, w, start, 5),
                         np.full((h, w), fill, np.float32))
        if pattern_type in ("copyright", "apple"):
            troj = _watermark(pattern_type, data_dir)
            if data == "fmnist":
                return Stamp(ADD_WRAP_U8, np.ones((h, w), dtype=bool), troj)
            return Stamp(SUB_FLOAT, np.ones((h, w), dtype=bool),
                         troj / 255.0)
    elif data == "cifar10":
        m = (_cifar10_plus_mask(agent_idx) if pattern_type == "plus"
             else np.zeros((32, 32), dtype=bool))
        return Stamp(SET, m, np.zeros((32, 32), np.float32))
    elif data == "synthetic":
        m = np.zeros((8, 8), dtype=bool)
        m[:3, :3] = True
        return Stamp(SET, m, np.full((8, 8), 255.0, np.float32))
    raise ValueError(f"no stamp for data={data!r} pattern={pattern_type!r}")


def apply_stamp(x: np.ndarray, stamp: Stamp) -> np.ndarray:
    """Stamp images shaped [..., H, W, C]. SET and ADD_WRAP_U8 keep the
    dtype; SUB_FLOAT gives float32."""
    mask = stamp.mask[..., None]            # [H, W, 1] broadcast over channels
    if stamp.mode == SET:
        return np.where(mask, stamp.value[..., None].astype(x.dtype), x)
    if stamp.mode == ADD_WRAP_U8:
        troj = stamp.value[..., None].astype(np.uint8)
        out = x.astype(np.uint8) + troj     # uint8 add wraps mod 256
        return np.where(mask, out, x).astype(x.dtype)
    if stamp.mode == SUB_FLOAT:
        troj = stamp.value[..., None].astype(np.float32)
        out = x.astype(np.float32) - troj
        return np.where(mask, out, x.astype(np.float32))
    raise ValueError(stamp.mode)
