"""Attack schedules: is the adversary active this round?

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
attack/schedule.py` (`is_trivial`, `check`, `active`). Rounds are 1-based,
as the driver numbers them. Three shapes come from the same three fields:

- late start (``--attack_start r``): dormant until round r;
- one-shot (``--attack_start r --attack_stop r+1``): exactly one round;
- intermittent (``--attack_every n``): every n-th round from
  ``attack_start``.

The schedule gates the update strategies (attack/boost.py,
attack/signflip.py). In JAX the gate is a function of the traced round
index inside the program; here `active` is the host-side mirror its
docstring names: the round fns (fl/rounds.py) evaluate it on the host for
each round and hand the resulting row scale to the device work as an
input, so a captured round never bakes one round's decision in. The
data-poisoning strategies (static, dba) stamp shards at construction time,
so a schedule on them is refused (attack/registry.check).

JAX's `active_traced` (the tenant packs' per-tenant gate) waits for the
port's tenant packs.
"""

from __future__ import annotations


def is_trivial(cfg) -> bool:
    """True when the schedule is the always-on default."""
    return (cfg.attack_start, cfg.attack_stop, cfg.attack_every) == (0, 0, 1)


def check(cfg) -> None:
    """Validate the schedule fields (registry.check calls this)."""
    if cfg.attack_start < 0:
        raise ValueError(f"--attack_start must be >= 0, got "
                         f"{cfg.attack_start}")
    if cfg.attack_every < 1:
        raise ValueError(f"--attack_every must be >= 1, got "
                         f"{cfg.attack_every}")
    if cfg.attack_stop < 0 or (cfg.attack_stop > 0
                               and cfg.attack_stop <= cfg.attack_start):
        raise ValueError(
            f"--attack_stop must be 0 (never) or > --attack_start for a "
            f"non-empty active window, got stop={cfg.attack_stop} "
            f"start={cfg.attack_start}")


def active(cfg, rnd: int) -> bool:
    """Is the attack active at (1-based) round ``rnd``?"""
    on = rnd >= cfg.attack_start
    if cfg.attack_stop > 0:
        on = on and rnd < cfg.attack_stop
    if cfg.attack_every > 1:
        on = on and (rnd - cfg.attack_start) % cfg.attack_every == 0
    return bool(on)
