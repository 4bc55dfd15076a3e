"""The attack registry: config-selected adversary strategies that every
round builder consults through the same predicates.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
attack/registry.py` (`AttackStrategy`, `REGISTRY`, `get`, `check`,
`in_jit`, `needs_round`, `update_scale`, `apply_update_attack`,
`schedule_active`, `stamp_for_agent`, `banner`), with its names, its
strategies and its error texts. ``--attack <name>`` selects a strategy;
each declares two hooks:

- the data hook (``data_mode``): which trigger each corrupt client stamps
  when its shard is built. ``legacy`` is the reference's per-agent stamp
  (the ``static`` strategy is the historical poison path); ``split`` deals
  the full pattern across the corrupt cohort (attack/dba.py).
- the update hook (``scale_rows``): a per-row multiplicative scale on the
  stacked client updates, applied right after local training, before the
  fault injection and the server-side payload check, so norm caps and the
  robust rules see what a real server would. JAX applies it inside the
  jitted round ("in jit"); the port marks the attacked slots on the host
  each round (`attacked_slots`: the sampled ids and `schedule_active`) and
  hands them to the round's device work as an input (fl/rounds.py), where
  `apply_update_attack` scales the rows, so a captured CUDA graph replays
  the attack of the round it runs. The predicate keeps JAX's name,
  `in_jit`.

The ``boost`` override of `update_scale` and `apply_update_attack` is the
JAX tenant packs' traced per-tenant knob; the port has no tenant packs,
so any value other than None is refused.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.attack import (
    boost as boost_mod, schedule, signflip as signflip_mod)


@dataclasses.dataclass(frozen=True)
class AttackStrategy:
    """One registered adversary behavior.

    ``data_mode``: 'legacy' = the reference per-agent stamp, 'split' = the
    DBA round-robin deal of the pattern (attack/dba.py). ``scale_rows``:
    the update hook, ``(corrupt_flags, active, boost) -> [m] f32 row
    scale``, or None for the data-poisoning strategies."""
    name: str
    data_mode: str      # legacy | split
    summary: str        # one-line banner text
    scale_rows: Optional[Callable] = None

    @property
    def in_jit(self) -> bool:
        return self.scale_rows is not None


REGISTRY = {
    "static": AttackStrategy(
        "static", "legacy",
        "the paper's static trojan (data poisoning only; bitwise the "
        "pre-registry path)"),
    "dba": AttackStrategy(
        "dba", "split",
        "distributed trigger: the full pattern dealt round-robin across "
        "the corrupt cohort (attack/dba.py)"),
    "boost": AttackStrategy(
        "boost", "legacy",
        "model-replacement boosting: corrupt updates scaled by "
        "--attack_boost to survive averaging (attack/boost.py)",
        scale_rows=boost_mod.scale_rows),
    "signflip": AttackStrategy(
        "signflip", "legacy",
        "RLR-aware anti-vote: corrupt updates negated (x -boost) to "
        "shrink honest sign margins (attack/signflip.py)",
        scale_rows=signflip_mod.scale_rows),
}

BOOST_OVERRIDE_NOT_PORTED = (
    "a per-call attack boost (the tenant packs' traced knob, "
    "fl/tenancy.py) is not ported yet")


def get(cfg) -> AttackStrategy:
    strat = REGISTRY.get(cfg.attack)
    if strat is None:
        raise ValueError(f"--attack must be one of {sorted(REGISTRY)}, "
                         f"got {cfg.attack!r}")
    return strat


def check(cfg) -> None:
    """Validate the whole attack config once, before anything is built."""
    strat = get(cfg)
    schedule.check(cfg)
    if cfg.attack_boost <= 0:
        raise ValueError(f"--attack_boost must be > 0, got "
                         f"{cfg.attack_boost} (signflip applies the "
                         f"negation itself)")
    if not strat.in_jit and not schedule.is_trivial(cfg):
        raise ValueError(
            f"--attack {strat.name} poisons data at construction time — "
            f"there is no per-round behavior for a schedule to gate; "
            f"attack_start/attack_stop/attack_every compose with the "
            f"in-jit strategies "
            f"({sorted(s.name for s in REGISTRY.values() if s.in_jit)})")


def in_jit(cfg) -> bool:
    """Does this config transform the updates inside the round?"""
    return get(cfg).in_jit


def needs_round(cfg) -> bool:
    """Does the round need its index for the attack (an update strategy
    under a non-trivial schedule)?"""
    return in_jit(cfg) and not schedule.is_trivial(cfg)


def update_scale(cfg, corrupt_flags, active, boost=None) -> torch.Tensor:
    """The strategy's [m] per-row multiplicative scale."""
    if boost is not None:
        raise ValueError(BOOST_OVERRIDE_NOT_PORTED)
    strat = get(cfg)
    if strat.scale_rows is None:
        raise ValueError(f"attack {strat.name!r} has no in-jit update "
                         f"hook")
    return strat.scale_rows(corrupt_flags, active, cfg.attack_boost)


def apply_update_attack(cfg, stacked_updates, corrupt_flags, active=None,
                        boost=None):
    """Apply the update strategy to the [m, ...]-stacked updates (a dict of
    f32 tensors): each row times its entry of `update_scale`, in f32.
    ``corrupt_flags`` marks the rows that hold malicious clients;
    ``active`` is the schedule gate (None = always on). The rounds fold
    the gate into the flags on the host (`attacked_slots`) and pass those
    as an input of their device work. A None flags argument is a wiring
    fault of the caller and raises, with JAX's text."""
    if not in_jit(cfg):
        return stacked_updates
    if corrupt_flags is None:
        raise ValueError(
            f"--attack {cfg.attack} transforms updates in-jit and needs "
            f"the corrupt-slot flags; this dispatch surface has no flag "
            f"channel (host-sampled chained blocks) — run device-resident "
            f"or cohort-sampled")
    scale = update_scale(cfg, corrupt_flags, active, boost=boost)
    return {k: u * scale.reshape((-1,) + (1,) * (u.dim() - 1))
            for k, u in stacked_updates.items()}


def schedule_active(cfg, rnd) -> Optional[bool]:
    """The schedule gate for round ``rnd`` (None when the attack needs no
    gate: always on, or no update strategy)."""
    if not needs_round(cfg):
        return None
    if rnd is None:
        raise ValueError(
            f"--attack {cfg.attack} with a schedule needs the round index "
            f"in-program, but this dispatch surface has no round channel "
            f"(host-sampled mode) — run device-resident or "
            f"cohort-sampled, or drop attack_start/attack_stop/"
            f"attack_every")
    return schedule.active(cfg, rnd)


def attacked_slots(cfg, sampled, rnd: int) -> Optional[torch.Tensor]:
    """Round ``rnd``'s [m] bool on the host: the sampled slot holds a
    corrupt agent (``id < num_corrupt``) and the schedule is on, or None
    without an update strategy. The round fns copy it into the round's
    device work, which hands it to `apply_update_attack` as the flags."""
    if not in_jit(cfg):
        return None
    flags = torch.as_tensor([int(a) < cfg.num_corrupt for a in sampled])
    return flags & (schedule_active(cfg, rnd) is not False)


def stamp_for_agent(cfg, agent_id: int):
    """Corrupt agent ``agent_id``'s trigger stamp under the selected
    strategy: the one stamp source of every data path
    (attack/poison.poison_client_row routes here)."""
    if get(cfg).data_mode == "split":
        from defending_against_backdoors_with_robust_learning_rate_tpu_torch.attack import (
            dba)
        return dba.stamp_for_agent(cfg, agent_id)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.attack.patterns import (
        build_stamp)
    return build_stamp(cfg.data, cfg.pattern_type, agent_idx=agent_id,
                       data_dir=cfg.data_dir)


def banner(cfg) -> Optional[str]:
    """Driver log line for a non-default attack config."""
    strat = get(cfg)
    if strat.name == "static":
        return None
    msg = f"[attack] {strat.name}: {strat.summary}"
    if strat.in_jit:
        msg += f"; boost x{cfg.attack_boost}"
        if not schedule.is_trivial(cfg):
            stop = cfg.attack_stop if cfg.attack_stop else "inf"
            msg += (f"; schedule rounds [{cfg.attack_start}, {stop}) "
                    f"every {cfg.attack_every}")
    return msg
