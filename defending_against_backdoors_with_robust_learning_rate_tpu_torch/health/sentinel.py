"""The in-round health lanes: numerics sentinels computed inside the round.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
health/sentinel.py`, the in-round half (`health_on`, `health_keys`,
`params_finite_bit`, `_row_stats`, `sentinel` :152, `local_lanes` :165,
`finish_sharded` :173) and the host EMA helpers `ema_init`, `loss_z`,
`norm_spike`. The lanes:

- ``hlth_nonfinite``      f32 count of sampled agents whose update carries
                          any NaN/inf coordinate;
- ``hlth_params_finite``  1.0 iff every committed parameter is finite;
- ``hlth_update_normsq``  the cohort's summed squared update norm over the
                          finite coordinates;
- ``hlth_agent_bad``      [m] per-slot nonfinite bits, dense round only:
                          the sharded round would need an all_gather for
                          it.

They cost no collective: the dense round has none, and the sharded round
packs its two partial lanes into the loss all_reduce it already makes (a
[3] vector instead of a scalar, parallel/rounds._loss_and_health).
The health monitor (the ladder) and quarantine are not ported yet.
"""

from __future__ import annotations

import math

import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.tree import (
    Params)

WARMUP_BOUNDARIES = 3       # boundaries before the z-score / spike may fire
_EPS = 1e-12


def health_on(cfg) -> bool:
    return cfg.health == "on"


def health_keys(cfg, sharded: bool = False):
    """The hlth_* keys cfg's round emits."""
    if not health_on(cfg):
        return ()
    keys = ("hlth_nonfinite", "hlth_params_finite", "hlth_update_normsq")
    return keys if sharded else keys + ("hlth_agent_bad",)


def boundary_keys(cfg):
    """The scalar lanes an eval boundary fetches (not the [m] vector)."""
    return health_keys(cfg, sharded=True)


def params_finite_bit(params: Params) -> torch.Tensor:
    """1.0 iff every committed-params coordinate is finite (f32 0-d)."""
    ok = torch.stack([torch.isfinite(p).all() for p in params.values()])
    return ok.all().to(torch.float32)


def _row_stats(updates: Params):
    """([rows] bad bits, [rows] finite-coordinate squared norms) over the
    stacked [rows, ...] update leaves, accumulated leaf by leaf."""
    leaves = list(updates.values())
    rows = leaves[0].shape[0]
    dev = leaves[0].device
    bad = torch.zeros(rows, dtype=torch.bool, device=dev)
    nsq = torch.zeros(rows, dtype=torch.float32, device=dev)
    for u in leaves:
        uf = u.reshape(rows, -1).to(torch.float32)
        finite = torch.isfinite(uf)
        bad = bad | ~finite.all(dim=1)
        safe = torch.where(finite, uf, torch.zeros((), device=dev))
        nsq = nsq + torch.sum(safe * safe, dim=1)
    return bad, nsq


def sentinel(cfg, updates: Params, new_params: Params):
    """The dense round's lanes, from the full [m, ...] update stacks and
    the committed params (cfg: JAX's signature; no lane reads it yet)."""
    del cfg
    bad, nsq = _row_stats(updates)
    return {"hlth_nonfinite": torch.sum(bad.to(torch.float32)),
            "hlth_update_normsq": torch.sum(nsq),
            "hlth_params_finite": params_finite_bit(new_params),
            "hlth_agent_bad": bad}


def local_lanes(updates_local: Params) -> torch.Tensor:
    """[2] f32 (bad count, normsq) partials of this rank's agent block,
    for the sharded round's packed loss all_reduce."""
    bad, nsq = _row_stats(updates_local)
    return torch.stack([torch.sum(bad.to(torch.float32)), torch.sum(nsq)])


def finish_sharded(bad_count, normsq, new_params: Params):
    """The sharded round's lanes from the all_reduced partials and the
    replicated committed params (no hlth_agent_bad)."""
    return {"hlth_nonfinite": bad_count,
            "hlth_update_normsq": normsq,
            "hlth_params_finite": params_finite_bit(new_params)}


# --- host-side pure math (the monitor's EMA baselines) --------------------

def ema_init():
    """Fresh EMA state (a JSON-able dict)."""
    return {"n": 0, "loss_ema": 0.0, "loss_var": 0.0, "norm_ema": 0.0,
            "delta_ema": 0.0}


def loss_z(state, loss: float) -> float:
    """z-score of this boundary's train loss against the EMA baseline; 0.0
    during warmup or for a nonfinite loss."""
    if state["n"] < WARMUP_BOUNDARIES or not math.isfinite(loss):
        return 0.0
    return (loss - state["loss_ema"]) / math.sqrt(state["loss_var"] + _EPS)


def norm_spike(state, norm: float, factor: float) -> bool:
    """True when the update norm exceeds `factor` x its EMA baseline
    (after warmup, finite values only)."""
    return (state["n"] >= WARMUP_BOUNDARIES and math.isfinite(norm)
            and norm > factor * max(state["norm_ema"], _EPS))
