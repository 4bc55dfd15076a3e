"""Seeded per-round cohort sampling: which m of the population's clients
train in round r.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
data/cohort.py` (`COHORT_KEY_TAG`, `MAX_CANDIDATES`, `MAX_DRAW_CHUNKS`,
`MIN_AVAILABILITY`, `availability`, `oversample_count`, `draw_plan`,
`cohort_feasible`, `sample_cohort`, `sample_cohort_host`). The sampling
model is JAX's, O(cohort), never O(population): draw C candidate ids
with replacement (C = an oversample of m scaled by the churn and traffic
availability), mark a candidate eligible when it is the first occurrence
of its id and its client is churn-present and traffic-present this
round, and take the first m eligible candidates in draw order. When
fewer than m are eligible the cohort is padded with ineligible
candidates whose `active` is False: the participation mask leaves them
out of aggregation, and the shapes never change. Past MAX_CANDIDATES the
draw is JAX's chunked rejection resample: chunks of MAX_CANDIDATES
candidates, each deduplicated within itself and against the ids already
selected, its eligible candidates written into the next open slots; a
shortfall slot keeps id 0 with `active` False.

JAX computes the cohort inside the round program from the traced round
index and mirrors it on the host with the same ops. The port computes it
once on the host (a vectorised numpy call) and hands the ids and the
`active` mask to the round as inputs (fl/rounds.make_cohort_round_fn),
the same values the gather used. The candidates are the port's
counter-based stream (utils/streams.py), a pure function of (cohort_seed,
COHORT_KEY_TAG, round, chunk, candidate), since torch cannot replay
`jax.random`. The draw (`draw_candidates`, `present`) and the selection
(`select_single`, `select_chunked`) are separate functions: the tests
feed the selection JAX's own candidates and presence and hold it to
JAX's `sample_cohort` bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils import (
    streams)

# the cohort stream's tag (JAX's fold_in tag; churn uses 0xC4A21, faults
# 0x5FA17, traffic 0x7AF1C)
COHORT_KEY_TAG = 0xC0407

# candidates of one draw matrix (JAX bounds its O(C^2) dedup here; past
# it, the chunked draw)
MAX_CANDIDATES = 4096

# at most this many MAX_CANDIDATES chunks a round; past it the refusal
MAX_DRAW_CHUNKS = 64

# the availability floor of the oversample
MIN_AVAILABILITY = 0.005


def availability(cfg) -> float:
    """Expected fraction of the population reachable in a round: churn
    availability x the traffic model's mean availability."""
    avail = float(cfg.churn_available) if cfg.churn_enabled else 1.0
    if cfg.traffic_enabled:
        from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data import (
            traffic)
        avail *= traffic.mean_available(cfg)
    return avail


def oversample_count(cfg) -> int:
    """C, the candidates one round draws: 2m over the availability, at
    least m + 8; past MAX_CANDIDATES * MAX_DRAW_CHUNKS JAX's loud error."""
    m = cfg.agents_per_round
    c = int(np.ceil(2.0 * m / max(availability(cfg), MIN_AVAILABILITY)))
    c = max(c, m + 8)
    if c > MAX_CANDIDATES * MAX_DRAW_CHUNKS:
        raise ValueError(
            f"cohort oversample {c} exceeds MAX_CANDIDATES="
            f"{MAX_CANDIDATES} x MAX_DRAW_CHUNKS={MAX_DRAW_CHUNKS} "
            f"(cohort {m}, availability {availability(cfg):.4f}); "
            f"shrink the cohort or raise availability")
    return c


def draw_plan(cfg) -> Tuple[int, int]:
    """(candidates per chunk, chunks): one chunk up to MAX_CANDIDATES,
    else chunks of MAX_CANDIDATES."""
    c = oversample_count(cfg)
    if c <= MAX_CANDIDATES:
        return c, 1
    return MAX_CANDIDATES, -(-c // MAX_CANDIDATES)


def cohort_feasible(cfg) -> bool:
    """Whether the implied cohort can be sampled at all (the auto decision
    stays dense when it cannot; `--cohort_sampled on` raises)."""
    try:
        oversample_count(cfg)
    except ValueError:
        return False
    return True


def draw_candidates(cfg, rnd: int, chunk: int, n: int) -> np.ndarray:
    """[n] int32 candidate ids in [0, K) of round `rnd`'s chunk `chunk`."""
    return streams.randint(cfg.num_agents, cfg.cohort_seed, COHORT_KEY_TAG,
                           int(rnd), int(chunk),
                           np.arange(n)).astype(np.int32)


def present(cfg, cand, rnd: int) -> Optional[np.ndarray]:
    """[C] bool: the candidate is churn-present and traffic-present this
    round, or None when neither is on."""
    ok = None
    if cfg.churn_enabled:
        from defending_against_backdoors_with_robust_learning_rate_tpu_torch.service import (
            churn)
        ok = churn.active_slots(cfg, cand, rnd)
    if cfg.traffic_enabled:
        from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data import (
            traffic)
        here = traffic.present_slots(cfg, cand, rnd)
        ok = here if ok is None else ok & here
    return ok


def _first_occurrence(cand: np.ndarray) -> np.ndarray:
    first = np.zeros(len(cand), dtype=bool)
    first[np.unique(cand, return_index=True)[1]] = True
    return first


def select_single(cand, ok, m: int) -> Tuple[np.ndarray, np.ndarray]:
    """JAX's single-matrix selection: eligible = first occurrence & `ok`
    (None: everyone present); the eligible candidates first, then the
    rest, each in draw order; the first m. Returns ([m] int32 ids, [m]
    bool active)."""
    cand = np.asarray(cand, dtype=np.int32)
    eligible = _first_occurrence(cand)
    if ok is not None:
        eligible &= np.asarray(ok, dtype=bool)
    order = np.concatenate([np.flatnonzero(eligible),
                            np.flatnonzero(~eligible)])[:m]
    return cand[order], eligible[order]


def select_chunked(cands, oks, m: int) -> Tuple[np.ndarray, np.ndarray]:
    """JAX's chunked rejection resample over `cands` [n_chunks, C] (and
    `oks`, the same shape, or None): each chunk's eligible candidates
    (first in the chunk, not already selected, present) fill the next
    open slots in draw order; slots left open keep id 0, inactive."""
    sel = np.zeros(m, dtype=np.int32)
    sel_ok = np.zeros(m, dtype=bool)
    cnt = 0
    for c, cand in enumerate(np.asarray(cands, dtype=np.int32)):
        eligible = (_first_occurrence(cand)
                    & ~np.isin(cand, sel[sel_ok]))
        if oks is not None:
            eligible &= np.asarray(oks[c], dtype=bool)
        take = np.flatnonzero(eligible)[:m - cnt]
        sel[cnt:cnt + len(take)] = cand[take]
        sel_ok[cnt:cnt + len(take)] = True
        cnt += len(take)
    return sel, sel_ok


def sample_cohort(cfg, rnd: int) -> Tuple[np.ndarray, np.ndarray]:
    """([m] int32 client ids, [m] bool active) of round `rnd`. `active` is
    False only on shortfall padding; the round ANDs it into the
    participation mask."""
    m = cfg.agents_per_round
    c, n_chunks = draw_plan(cfg)
    if n_chunks == 1:
        cand = draw_candidates(cfg, rnd, 0, c)
        return select_single(cand, present(cfg, cand, rnd), m)
    cands = np.stack([draw_candidates(cfg, rnd, k, c)
                      for k in range(n_chunks)])
    oks = None
    if cfg.churn_enabled or cfg.traffic_enabled:
        oks = np.stack([present(cfg, cand, rnd) for cand in cands])
    return select_chunked(cands, oks, m)


def sample_cohort_host(cfg, rnd: int) -> Tuple[np.ndarray, np.ndarray]:
    """The driver's (ids, active) for round `rnd` (JAX's host mirror; here
    the one draw)."""
    return sample_cohort(cfg, rnd)
