"""Seeded client-churn lifecycles: arrive, depart and rejoin as a pure
function of (client id, round).

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
service/churn.py` (`CHURN_KEY_TAG`, `active_slots`, `active_count`,
`churn_away`, `churn_only_scalars`). Time is cut into per-client
lifecycle phases of `churn_period` rounds, each client's phase boundary
shifted by a seeded offset in [0, churn_period); a client is present for
a whole phase when that phase's uniform draw lies below
`churn_available`. Presence at any round is O(1) per client with no
sequential state, so a resumed run sees the lifecycles the uninterrupted
one saw.

The draws are the port's counter-based stream (utils/streams.py) keyed
by (churn_seed, CHURN_KEY_TAG, client, ...), not JAX's `fold_in` chain,
which torch cannot replay. Each function is split into the draw and the
selection: `draw_offsets` and `draw_uniforms` draw, `phase_of` and
`active_from` select, and the tests feed the selection JAX's own offsets
and uniforms and hold it to JAX's `active_slots` bit for bit. The masks
are computed on the host from the round's ids and index; the round takes
them as an input (fl/rounds.py), where they join the participation mask.
"""

from __future__ import annotations

import numpy as np
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils import (
    streams)

# the lifecycle stream's tag (JAX's fold_in tag), disjoint from the cohort
# (0xC0407), traffic (0x7AF1C) and fault (0x5FA17) streams
CHURN_KEY_TAG = 0xC4A21

# the population census walks the ids in blocks of this many
_CENSUS_BLOCK = 1 << 20


def draw_offsets(cfg, client_ids) -> np.ndarray:
    """Each client's phase offset in [0, churn_period)."""
    period = max(1, int(cfg.churn_period))
    return streams.randint(period, cfg.churn_seed, CHURN_KEY_TAG,
                           np.asarray(client_ids), 0)


def phase_of(cfg, rnd: int, offsets) -> np.ndarray:
    """The lifecycle phase each client is in at round `rnd`."""
    period = max(1, int(cfg.churn_period))
    return (int(rnd) + np.asarray(offsets, dtype=np.int64)) // period


def draw_uniforms(cfg, client_ids, phases) -> np.ndarray:
    """float32 uniform of each (client, phase)."""
    return streams.uniform(cfg.churn_seed, CHURN_KEY_TAG,
                           np.asarray(client_ids), 1, np.asarray(phases))


def active_from(cfg, uniforms) -> np.ndarray:
    """[n] bool: the phase's uniform below churn_available (float32, as
    JAX compares)."""
    return np.asarray(uniforms, dtype=np.float32) < np.float32(
        cfg.churn_available)


def active_slots(cfg, client_ids, rnd: int) -> np.ndarray:
    """[n] bool: is each client present at round `rnd`?"""
    ids = np.asarray(client_ids, dtype=np.int64)
    phases = phase_of(cfg, rnd, draw_offsets(cfg, ids))
    return active_from(cfg, draw_uniforms(cfg, ids, phases))


def active_count(cfg, rnd: int) -> int:
    """How many of the K clients are present at round `rnd` (a census,
    O(population); never on a round's path)."""
    n = 0
    for lo in range(0, cfg.num_agents, _CENSUS_BLOCK):
        ids = np.arange(lo, min(lo + _CENSUS_BLOCK, cfg.num_agents))
        n += int(active_slots(cfg, ids, rnd).sum())
    return n


def churn_away(churn_active: torch.Tensor) -> torch.Tensor:
    """Sampled slots whose client is away this round (the
    Churn/Sampled_Away row), on the round's device."""
    return torch.sum((~churn_active).to(torch.float32))


def churn_only_scalars(churn_active: torch.Tensor, mask: torch.Tensor):
    """The Faults/* scalars of a churn round without a fault draw: nothing
    dropped or straggled, the electorate the mask."""
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return {"fault_dropped": zero, "fault_straggled": zero.clone(),
            "fault_voters": torch.sum(mask.to(torch.float32)),
            "churn_away": churn_away(churn_active)}
