"""Diurnal traffic: per-client timezone offsets and a daily availability
curve, every draw a pure function of (client id, round).

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
data/traffic.py` (`TRAFFIC_KEY_TAG`, `TRAFFIC_MODES`, `mean_available`,
`availability_curve`, `present_slots`, `latency_quantile`, `census`).
Each client gets a
seeded timezone offset in [0, traffic_day_rounds); its local time of day
at round r is (r + offset) mod traffic_day_rounds, its availability the
raised cosine between `traffic_trough_frac` and `traffic_peak_frac`
(peak at local time 0), and its presence a per-(client, round) uniform
draw below that availability.

The draws are the port's counter-based stream (utils/streams.py) keyed
by (traffic_seed, TRAFFIC_KEY_TAG, client, ...); the selection
(`local_time`, `availability_curve`, `present_from`) takes the offsets
and uniforms as inputs, and the tests feed it JAX's own. The curve is
computed in float32 in JAX's order of operations; the cosine is numpy's,
which may differ from XLA's by an ulp (tests/test_torch_presence.py).

`latency_quantile` maps the buffered path's straggler uniforms
(fl/buffered.latency) to heavy-tailed staleness under `--traffic diurnal`,
in float32 in JAX's order of operations; its erfinv and exp are torch's,
which may differ from XLA's by an ulp, and so move the ceiling only where
exp(sigma * z) lies within an ulp of an integer
(tests/test_torch_buffered_draw.py holds it to JAX's).
"""

from __future__ import annotations

import numpy as np
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils import (
    streams)

# the traffic stream's tag (JAX's fold_in tag)
TRAFFIC_KEY_TAG = 0x7AF1C

TRAFFIC_MODES = ("flat", "diurnal")

_CENSUS_BLOCK = 1 << 20


def mean_available(cfg) -> float:
    """Day-averaged availability: the raised cosine averages to the
    midpoint of trough and peak (the cohort oversample's scale)."""
    if not cfg.traffic_enabled:
        return 1.0
    return 0.5 * (float(cfg.traffic_peak_frac)
                  + float(cfg.traffic_trough_frac))


def availability_curve(cfg, local_t) -> np.ndarray:
    """float32 availability at local time of day `local_t` (in rounds):
    trough + (peak - trough) * (1 + cos(2 pi t / day)) / 2."""
    day = max(1, int(cfg.traffic_day_rounds))
    lo = np.float32(cfg.traffic_trough_frac)
    hi = np.float32(cfg.traffic_peak_frac)
    phase = (np.float32(2.0 * np.pi)
             * np.asarray(local_t).astype(np.float32) / np.float32(day))
    return lo + (hi - lo) * np.float32(0.5) * (np.float32(1.0)
                                               + np.cos(phase))


def draw_offsets(cfg, client_ids) -> np.ndarray:
    """Each client's timezone offset in [0, traffic_day_rounds)."""
    day = max(1, int(cfg.traffic_day_rounds))
    return streams.randint(day, cfg.traffic_seed, TRAFFIC_KEY_TAG,
                           np.asarray(client_ids), 0)


def draw_uniforms(cfg, client_ids, rnd: int) -> np.ndarray:
    """float32 uniform of each (client, round)."""
    return streams.uniform(cfg.traffic_seed, TRAFFIC_KEY_TAG,
                           np.asarray(client_ids), 1, int(rnd))


def local_time(cfg, rnd: int, offsets) -> np.ndarray:
    day = max(1, int(cfg.traffic_day_rounds))
    return (int(rnd) + np.asarray(offsets, dtype=np.int64)) % day


def present_from(cfg, rnd: int, offsets, uniforms) -> np.ndarray:
    """[n] bool: the round's uniform below the client's availability."""
    p = availability_curve(cfg, local_time(cfg, rnd, offsets))
    return np.asarray(uniforms, dtype=np.float32) < p


def present_slots(cfg, client_ids, rnd: int) -> np.ndarray:
    """[n] bool: is each client traffic-reachable at round `rnd`?"""
    ids = np.asarray(client_ids, dtype=np.int64)
    return present_from(cfg, rnd, draw_offsets(cfg, ids),
                        draw_uniforms(cfg, ids, rnd))


def latency_quantile(cfg, u, max_staleness: int) -> torch.Tensor:
    """[n] int32 staleness in [1, max_staleness] from uniforms `u` in
    [0, 1): the log-normal quantile exp(sigma * PPF(u)), sigma =
    --traffic_latency_sigma, ceiled and clipped; PPF(u) = sqrt(2) *
    erfinv(2u - 1), in float32 (JAX `latency_quantile`)."""
    sigma = torch.tensor(cfg.traffic_latency_sigma, dtype=torch.float32)
    u = (u.to(torch.float32) if isinstance(u, torch.Tensor)
         else torch.tensor(np.asarray(u, dtype=np.float32)))
    z = torch.sqrt(torch.tensor(2.0)) * torch.erfinv(2.0 * u - 1.0)
    t = torch.ceil(torch.exp(sigma * z))
    return torch.clamp(t, 1, max_staleness).to(torch.int32)


def census(cfg, rnd: int) -> int:
    """How many of the K clients are present at round `rnd` (O(population),
    observability only)."""
    n = 0
    for lo in range(0, cfg.num_agents, _CENSUS_BLOCK):
        ids = np.arange(lo, min(lo + _CENSUS_BLOCK, cfg.num_agents))
        n += int(present_slots(cfg, ids, rnd).sum())
    return n
