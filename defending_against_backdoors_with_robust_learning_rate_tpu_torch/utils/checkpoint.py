"""Checkpoint and resume: the run's state at an eval boundary, on disk.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
utils/checkpoint.py`, its layout on disk and its host logic without orbax:

- ``<ckpt_dir>/round_NNNNNN/state.pt``: one `torch.save` file of CPU
  tensors and plain Python values, loaded with ``weights_only=True``. The
  directory is written under a temporary name and moved into place with
  `os.replace`; then its sidecar ``round_NNNNNN.digest`` (sha256 over the
  directory's file bytes) is written last, through `atomic_write_text`,
  so a sidecar means a complete checkpoint.
- ``<ckpt_dir>/journal.json``: ``{"version": 1, "entries": [...]}``, one
  entry per checkpointed round with the byte offset of metrics.jsonl at
  the save and the host state the trainer carries beside it (the health
  monitor's EMA, the reputation tracker's state).

The state: the params under the port's names, ``round``, the round's
random streams (`fl/rounds.RoundRNG.state_dict`: its round counter and the
host and noise generators' states, with the device type that wrote
them), ``cum_poison_acc`` and ``cum_net_mov`` (the running sum of the
Sign/* diagnostic). It is the counterpart of JAX's (params, round, PRNG
key, cum_poison_acc, cum_net_mov). Under `--agg_mode buffered` the
params are the round's carry (fl/buffered.join_carry): the buffer state
is saved and restored beside the params under its `@async/` names, so a
run cut between commits resumes to the straight run.

`restore` skips a checkpoint whose digest does not match its directory
(truncated or corrupt) and falls back to the newest valid one, printing
JAX's line. A checkpoint whose digest holds but whose state does not fit
the run (other param names or shapes, generators written on another
device type, such as a card's checkpoint resumed on the CPU) raises:
nothing falls back silently.

Not ported: JAX's legacy restore of a checkpoint without ``cum_net_mov``
(no port checkpoint predates it) and the ``checkpoint/*`` ledger events
(the port has no event ledger).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

JOURNAL_NAME = "journal.json"
STATE_NAME = "state.pt"


def _round_path(ckpt_dir: str, rnd: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"round_{rnd:06d}")


def atomic_write_text(path: str, text: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(text)
    os.replace(tmp, path)


# ----------------------------------------------------------------- digests ---

def dir_digest(path: str) -> str:
    """sha256 over a checkpoint directory's (sorted relative path, file
    bytes): corruption shows without loading the state, so a load that
    fails means a mismatch, which must stay loud."""
    h = hashlib.sha256()
    for base, dirs, files in sorted(os.walk(path)):
        dirs.sort()
        for name in sorted(files):
            fp = os.path.join(base, name)
            h.update(os.path.relpath(fp, path).encode())
            with open(fp, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
    return h.hexdigest()


def digest_valid(ckpt_dir: str, rnd: int) -> Optional[bool]:
    """True/False: the sidecar is there and matches / does not match;
    None: no sidecar (unknown, trusted)."""
    path = _round_path(ckpt_dir, rnd)
    try:
        with open(path + ".digest", encoding="utf-8") as f:
            want = f.read().strip()
    except OSError:
        return None
    if not os.path.isdir(path):
        return False
    try:
        return dir_digest(path) == want
    except OSError:
        return False


# ------------------------------------------------------------ save/restore ---

def save(ckpt_dir: str, rnd: int, params, rng_state: Dict[str, Any],
         cum_poison_acc: float, cum_net_mov: float = 0.0,
         keep_last: int = 0) -> str:
    """Write round rnd's checkpoint and its digest sidecar; prune to the
    `keep_last` newest when > 0. Returns the checkpoint's path."""
    path = _round_path(ckpt_dir, rnd)
    state = {
        "params": {k: v.detach().to("cpu", copy=True)
                   for k, v in params.items()},
        "round": int(rnd),
        "rng": rng_state,
        "cum_poison_acc": float(cum_poison_acc),
        "cum_net_mov": float(cum_net_mov),
    }
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state, os.path.join(tmp, STATE_NAME))
    # a round saved again (a resume that re-reaches an unjournaled round)
    # replaces the old directory and its sidecar
    shutil.rmtree(path, ignore_errors=True)
    try:
        os.remove(path + ".digest")
    except OSError:
        pass
    os.replace(tmp, path)
    # the sidecar last: its presence implies the directory is complete
    atomic_write_text(path + ".digest", dir_digest(path) + "\n")
    if keep_last > 0:
        prune(ckpt_dir, keep_last)
    return path


def saved_rounds(ckpt_dir: str) -> List[int]:
    """Complete checkpoint rounds on disk, ascending (a temporary
    directory of a save that was cut is left out by the name)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                  if (m := re.fullmatch(r"round_(\d+)", d)))


def latest_round(ckpt_dir: str) -> Optional[int]:
    rounds = saved_rounds(ckpt_dir)
    return rounds[-1] if rounds else None


def prune(ckpt_dir: str, keep_last: int) -> None:
    """Remove the oldest checkpoints (and sidecars) beyond `keep_last`."""
    for rnd in saved_rounds(ckpt_dir)[:-keep_last]:
        path = _round_path(ckpt_dir, rnd)
        shutil.rmtree(path, ignore_errors=True)
        try:
            os.remove(path + ".digest")
        except OSError:
            pass


def _device_type(params_like) -> str:
    return next(iter(params_like.values())).device.type


def _restore_state(path: str, params_like) -> Dict[str, Any]:
    """One checkpoint's state, held against the run: the same param names
    and shapes as `params_like`, and generators written on the device type
    `params_like` lies on. Raises on a mismatch."""
    state = torch.load(os.path.join(path, STATE_NAME), map_location="cpu",
                       weights_only=True)
    got = {k: tuple(v.shape) for k, v in state["params"].items()}
    want = {k: tuple(v.shape) for k, v in params_like.items()}
    if got != want:
        raise ValueError(
            f"checkpoint {path} holds params {got}, but the run's model has "
            f"{want}; resume with the configuration that wrote it")
    for k, v in state["params"].items():
        if v.dtype != params_like[k].dtype:
            raise ValueError(f"checkpoint {path}: {k} is {v.dtype}, the "
                             f"run's {params_like[k].dtype}")
    written_on = state["rng"]["device"]
    if written_on != _device_type(params_like):
        raise ValueError(
            f"checkpoint {path} holds random streams of a {written_on} run, "
            f"but this run is on {_device_type(params_like)}: a generator's "
            f"state does not carry across device types; resume on the "
            f"device type that wrote it")
    return state


def newest_valid_round(ckpt_dir: str) -> Optional[int]:
    """The round `restore` would resume from: the newest checkpoint whose
    digest is not provably violated."""
    for rnd in reversed(saved_rounds(ckpt_dir)):
        if digest_valid(ckpt_dir, rnd) is not False:
            return rnd
    return None


def newest_resumable_round(ckpt_dir: str) -> Optional[int]:
    """The newest digest-valid round that also has a journal entry (a
    save cut between the checkpoint and its journal entry leaves a newer
    unjournaled checkpoint; resuming from the journaled one keeps the
    metrics splice exact). No journal at all: `newest_valid_round`."""
    journaled = {e["round"] for e in journal_read(ckpt_dir)}
    if not journaled:
        return newest_valid_round(ckpt_dir)
    for rnd in reversed(saved_rounds(ckpt_dir)):
        if rnd in journaled and digest_valid(ckpt_dir, rnd) is not False:
            return rnd
    return None


def restore(ckpt_dir: str, params_like, upto: Optional[int] = None,
            upto_validated: bool = False
            ) -> Optional[Tuple[int, Dict[str, torch.Tensor],
                                Dict[str, Any], float, float]]:
    """(round, params on the CPU, rng state, cum_poison_acc, cum_net_mov)
    of the newest digest-valid checkpoint, or None when there is none.

    A checkpoint whose digest mismatches is skipped with a printed line
    and the next newest is tried; one whose digest holds but whose state
    does not fit `params_like` raises (`_restore_state`). `upto` caps the
    rounds considered; `upto_validated` skips re-hashing round `upto`
    when the caller has just validated it."""
    rounds = saved_rounds(ckpt_dir)
    if upto is not None:
        rounds = [r for r in rounds if r <= upto]
    for rnd in reversed(rounds):
        valid = (True if upto_validated and rnd == upto
                 else digest_valid(ckpt_dir, rnd))
        if valid is False:
            print(f"[ckpt] round_{rnd:06d}: digest mismatch "
                  f"(truncated/corrupt checkpoint) — falling back to the "
                  f"previous one")
            continue
        state = _restore_state(_round_path(ckpt_dir, rnd), params_like)
        return (int(state["round"]), state["params"], state["rng"],
                float(state["cum_poison_acc"]), float(state["cum_net_mov"]))
    return None


# ----------------------------------------------------------- round journal ---

def journal_path(ckpt_dir: str) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), JOURNAL_NAME)


def journal_read(ckpt_dir: str) -> List[Dict[str, Any]]:
    """The journal's entries, ascending rounds; [] when it is absent or
    unreadable."""
    try:
        with open(journal_path(ckpt_dir), encoding="utf-8") as f:
            data = json.load(f)
        return sorted(data.get("entries", []), key=lambda e: e["round"])
    except (OSError, ValueError, KeyError, TypeError):
        return []


def journal_record(ckpt_dir: str, rnd: int, metrics_offset: int,
                   keep_last: int = 0, **extra) -> None:
    """Add or replace round rnd's entry (an atomic rewrite), keeping the
    `keep_last` newest entries when > 0."""
    entries = [e for e in journal_read(ckpt_dir) if e["round"] != rnd]
    entries.append({"round": int(rnd),
                    "metrics_offset": int(metrics_offset),
                    "wall_time": time.time(), **extra})
    entries.sort(key=lambda e: e["round"])
    if keep_last > 0:
        entries = entries[-keep_last:]
    os.makedirs(os.path.abspath(ckpt_dir), exist_ok=True)
    atomic_write_text(journal_path(ckpt_dir),
                      json.dumps({"version": 1, "entries": entries},
                                 indent=1) + "\n")


def journal_offset_for(ckpt_dir: str, rnd: int) -> int:
    """The metrics.jsonl byte offset journaled for round rnd; 0 when it is
    not journaled."""
    for e in journal_read(ckpt_dir):
        if e["round"] == rnd:
            return int(e["metrics_offset"])
    return 0
