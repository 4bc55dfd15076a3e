"""The in-round health lanes: numerics sentinels computed inside the round.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
health/sentinel.py`, the in-round half (`health_on`, `health_keys`,
`params_finite_bit`, `_row_stats`, `sentinel` :152, `local_lanes` :165,
`finish_sharded` :173), the quarantine set (`has_quarantine`,
`quarantine_ids`, `quarantine_mask` :65-100) and the host EMA helpers the
monitor
(health/monitor.py) judges with: `ema_init`, `loss_z`, `norm_spike`,
`delta_spike` :213, `ema_update` :226. The lanes:

- ``hlth_nonfinite``      f32 count of participating agents whose update
                          carries any NaN/inf coordinate (rows the
                          participation mask leaves out, such as corrupt
                          payloads the faults path rejects, do not
                          count: they are handled, not an incident);
- ``hlth_params_finite``  1.0 iff every committed parameter is finite;
- ``hlth_update_normsq``  the participants' summed squared update norm
                          over the finite coordinates;
- ``hlth_agent_bad``      [m] per-slot nonfinite bits, dense round only:
                          the sharded round would need an all_gather for
                          it.

They cost no collective: the dense round has none, and the sharded round
packs its two partial lanes into the loss all_reduce it already makes (a
[3] vector instead of a scalar, parallel/rounds._loss_and_health).

``--quarantine`` takes a list of client ids out of every vote: the
device-resident round ANDs `quarantine_mask` of its sampled ids into the
participation mask (fl/rounds.py), as a dropped client leaves it. The set
is a device tensor made once when the round is built; the membership test
runs inside the captured round. The monitor's ladder, which would feed
the set from an incident's suspects, is not ported yet.
"""

from __future__ import annotations

import math

import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.tree import (
    Params)

LEVELS = ("on", "off")
# EMA decay of the loss and update-norm baselines (host side, once a
# boundary; Python floats, so a replay gives the same Health/* rows)
EMA_DECAY = 0.9
WARMUP_BOUNDARIES = 3       # boundaries before the z-score / spike may fire
_EPS = 1e-12


def health_on(cfg) -> bool:
    return cfg.health == "on"


def has_quarantine(cfg) -> bool:
    """Judged on the parsed id set, not on the string: a value such as ","
    holds no id and arms no mask (monitor.check refuses it first)."""
    return bool(cfg.quarantine) and bool(quarantine_ids(cfg))


def quarantine_ids(cfg):
    """The quarantined client ids, a sorted tuple of ints."""
    try:
        ids = sorted({int(tok) for tok in cfg.quarantine.split(",") if tok})
    except ValueError as e:
        raise ValueError(
            f"--quarantine must be a comma-separated client-id list, "
            f"got {cfg.quarantine!r}") from e
    if any(i < 0 for i in ids):
        raise ValueError(f"--quarantine ids must be >= 0, got {ids}")
    return tuple(ids)


def quarantine_set(cfg, device):
    """The quarantined ids as an int64 tensor on `device`, made once when a
    round is built (None without a quarantine): a captured round reads it
    as a constant, with no copy from the host."""
    if not has_quarantine(cfg):
        return None
    return torch.tensor(quarantine_ids(cfg), dtype=torch.int64,
                        device=device)


def quarantine_mask(cfg, sampled, qset=None):
    """[m] bool: True where the sampled slot's client is not quarantined
    (None without a quarantine). `sampled` is the [m] id tensor; `qset`
    the `quarantine_set` on its device, built from cfg when not given.
    One broadcast compare, on the device."""
    if qset is None:
        qset = quarantine_set(cfg, sampled.device)
        if qset is None:
            return None
    return ~torch.any(sampled.to(torch.int64)[:, None] == qset[None, :],
                      dim=1)


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


def _row_stats(updates: Params, mask=None):
    """([rows] bad bits, [rows] finite-coordinate squared norms) over the
    stacked [rows, ...] update leaves, accumulated leaf by leaf; rows
    outside `mask` ([rows] bool) are neither bad nor counted."""
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
    if mask is not None:
        bad = bad & mask
        nsq = torch.where(mask, nsq, torch.zeros((), device=dev))
    return bad, nsq


def sentinel(cfg, updates: Params, new_params: Params, mask=None):
    """The dense round's lanes, from the full [m, ...] update stacks, the
    committed params and the round's participation mask (or None; cfg:
    JAX's signature, no lane reads it)."""
    del cfg
    bad, nsq = _row_stats(updates, mask)
    return {"hlth_nonfinite": torch.sum(bad.to(torch.float32)),
            "hlth_update_normsq": torch.sum(nsq),
            "hlth_params_finite": params_finite_bit(new_params),
            "hlth_agent_bad": bad}


def local_lanes(updates_local: Params, mask_local=None) -> torch.Tensor:
    """[2] f32 (bad count, normsq) partials of this rank's agent block
    (rows outside `mask_local`, the block's participation mask, neither
    bad nor counted), for the sharded round's packed loss all_reduce."""
    bad, nsq = _row_stats(updates_local, mask_local)
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


def delta_spike(state, delta: float, factor: float) -> bool:
    """True when the committed-delta norm exceeds `factor` x its own EMA
    baseline. Only the monitor's ladder feeds that baseline (not ported);
    the boundary's assessment passes NaN, and this stays False."""
    return (state["n"] >= WARMUP_BOUNDARIES and math.isfinite(delta)
            and state.get("delta_ema", 0.0) > 0.0
            and delta > factor * max(state.get("delta_ema", 0.0), _EPS))


def ema_update(state, loss: float, norm: float,
               delta: float = float("nan")):
    """Fold one healthy boundary into the EMA baselines (an incident
    boundary is not folded: it must not move the baseline it was judged
    against). Returns a new dict."""
    s = dict(state)
    if math.isfinite(delta):
        s["delta_ema"] = (delta if s.get("delta_ema", 0.0) == 0.0
                          else EMA_DECAY * s.get("delta_ema", 0.0)
                          + (1.0 - EMA_DECAY) * delta)
    if math.isfinite(loss):
        if s["n"] == 0:
            s["loss_ema"], s["loss_var"] = loss, 0.0
        else:
            d = loss - s["loss_ema"]
            s["loss_ema"] = s["loss_ema"] + (1.0 - EMA_DECAY) * d
            s["loss_var"] = (EMA_DECAY * s["loss_var"]
                             + (1.0 - EMA_DECAY) * d * d)
    if math.isfinite(norm):
        s["norm_ema"] = (norm if s["n"] == 0
                         else EMA_DECAY * s["norm_ema"]
                         + (1.0 - EMA_DECAY) * norm)
    s["n"] = s["n"] + 1
    return s
