"""Host-side health policy: one judgement of each eval boundary.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
health/monitor.py`, the policy half: `TAGS`, `POLICIES`, `check` :93,
`resolve_policy` :116, `HealthIncident` :123, `assess` :129, `emit_rows`
:196 and `enforce` :204. At every eval boundary the driver (train.py)
judges the fetched values: `assess` turns the health lanes
(health/sentinel.py) and the boundary's finite bit into the Health/* rows,
a verdict and the next EMA state; `emit_rows` writes the rows; `enforce`
applies the policy:

    abort    raise on an incident (a nonfinite boundary: JAX's
             FloatingPointError from utils/guards.finite_warn, word for
             word; a soft incident, a loss z-score or a norm spike:
             HealthIncident);
    record   warn loudly, write the rows, keep recording (the default).

``recover`` (the ladder: discard, rollback, quarantine, halt) is armed by
JAX's service driver alone (`service/driver.py:289-296`, inside `serve`),
never by its one-shot trainer; it comes with the port's service plane and
is refused as not ported yet, as JAX's ``--debug_nan`` (checkify, which
forces ``abort`` there) is. A
quarantine set given by hand (``--quarantine``) is ported: `check`
validates it as JAX does, and the rounds take it through the
participation mask (health/sentinel.quarantine_mask).
"""

from __future__ import annotations

import math
from typing import Dict

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.health import (
    sentinel)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils.guards import (
    finite_warn)

POLICIES = ("abort", "recover", "record")
PORTED_POLICIES = ("abort", "record")

# the Health/* rows, JAX's tag names (the one source of them in the port)
TAGS = {
    "nonfinite": "Health/Nonfinite_Updates",
    "params_finite": "Health/Params_Finite",
    "update_norm": "Health/Update_Norm",
    "loss_z": "Health/Loss_Z",
    "norm_spike": "Health/Norm_Spike",
}


def check(cfg) -> None:
    """Validate the health flags before any build, refusing what the port
    does not run yet."""
    if cfg.health not in sentinel.LEVELS:
        raise ValueError(f"--health must be one of {sentinel.LEVELS}, "
                         f"got {cfg.health!r}")
    if cfg.health_policy not in POLICIES:
        raise ValueError(f"--health_policy must be one of {POLICIES}, "
                         f"got {cfg.health_policy!r}")
    if cfg.quarantine and not sentinel.quarantine_ids(cfg):
        # a value that parses to no id ("," and the like) is a mistake,
        # not an empty quarantine: refuse it before it half-arms the mask
        raise ValueError(
            f"--quarantine {cfg.quarantine!r} contains no client ids; "
            f"pass a comma-separated id list or leave it empty")
    if cfg.health_policy not in PORTED_POLICIES:
        raise ValueError(
            f"--health_policy {cfg.health_policy} (the recovery ladder: "
            f"discard, rollback, quarantine, halt) is not ported yet: it "
            f"comes with the service plane (JAX service/driver.py arms it "
            f"in serve); the port has {PORTED_POLICIES}")


def resolve_policy(cfg) -> str:
    """The single source of the divergence policy: ``--health_policy``
    (in JAX ``--debug_nan`` forces ``abort``; the port refuses that
    flag)."""
    return cfg.health_policy


class HealthIncident(FloatingPointError):
    """A numerics incident under the ``abort`` policy. FloatingPointError
    keeps the finite check's contract for callers that catch it."""


def assess(cfg, state, vals) -> Dict:
    """Judge one eval boundary's host values against the carried EMA
    state. Pure: returns a report with the Health/* row values, the
    verdict and the post-boundary EMA state; the caller commits
    ``new_state`` last.

    With ``--health off`` (no lanes in vals) only the boundary finite bit
    (vals['finite']) is judged, and no rows are produced."""
    state = state or sentinel.ema_init()
    finite = bool(vals.get("finite", True))
    report = {"rows": {}, "new_state": state, "healthy": True,
              "finite": finite, "why": ""}
    if "hlth_nonfinite" not in vals:
        report["healthy"] = finite
        if not finite:
            report["why"] = "nonfinite parameters"
        return report
    nonfinite = float(vals["hlth_nonfinite"])
    pfinite = float(vals["hlth_params_finite"])
    loss = float(vals["train_loss"])
    nsq = float(vals["hlth_update_normsq"])
    norm = math.sqrt(nsq) if (math.isfinite(nsq) and nsq >= 0) else nsq
    z = sentinel.loss_z(state, loss)
    spike = sentinel.norm_spike(state, norm, cfg.health_spike_factor)
    # the committed-delta lane exists only on the ladder's boundary check
    # (not ported): NaN here, so its spike never fires
    delta = float(vals.get("hlth_delta_norm", float("nan")))
    dspike = sentinel.delta_spike(state, delta, cfg.health_spike_factor)
    bad_params = not finite or pfinite < 1.0
    why = []
    if bad_params:
        why.append("nonfinite parameters")
    if nonfinite > 0:
        why.append(f"{int(nonfinite)} nonfinite client update(s)")
    if z > cfg.health_z_threshold:
        why.append(f"loss z-score {z:.1f} > {cfg.health_z_threshold}")
    if spike:
        why.append(f"update-norm spike (> {cfg.health_spike_factor}x EMA)")
    if dspike:
        why.append(f"committed-delta norm spike "
                   f"(> {cfg.health_spike_factor}x EMA)")
    # a finite burst that overflows the squared-norm sum shows as inf mass
    # with no nonfinite row; the spike tests are finite-gated, so it is an
    # incident of its own
    if not math.isfinite(norm):
        why.append("non-finite update-norm mass (magnitude overflow)")
    if not math.isnan(delta) and not math.isfinite(delta):
        why.append("non-finite committed-delta norm (magnitude overflow)")
    healthy = not why
    report.update(
        healthy=healthy, why="; ".join(why), finite=not bad_params,
        rows={"nonfinite": nonfinite, "params_finite": pfinite,
              "update_norm": norm, "loss_z": z,
              "norm_spike": 1.0 if spike else 0.0},
        # an incident boundary does not move the baseline it was judged
        # against
        new_state=(sentinel.ema_update(state, loss, norm, delta=delta)
                   if healthy else state))
    return report


def emit_rows(writer, report, step: int) -> None:
    """The Health/* rows of a report, in TAGS order."""
    for key, tag in TAGS.items():
        if key in report["rows"]:
            writer.scalar(tag, float(report["rows"][key]), step)


def enforce(cfg, report, where: str = "") -> bool:
    """The warn/abort half of the policy. Non-finiteness goes through
    utils/guards.finite_warn (its message and FloatingPointError word for
    word); a soft incident (z-score, norm spike) warns, and raises
    HealthIncident only under abort. Returns the healthy bit."""
    policy = resolve_policy(cfg)
    finite_warn(report["finite"], where=where,
                raise_error=policy == "abort")
    if not report["healthy"] and report["finite"]:
        # a soft incident: its own loud line, so `record` runs are greppable
        print(f"[health] WARNING: {report['why']}"
              f"{' at ' + where if where else ''}")
        if policy == "abort":
            raise HealthIncident(
                f"health incident{' at ' + where if where else ''}: "
                f"{report['why']}")
    return report["healthy"]
