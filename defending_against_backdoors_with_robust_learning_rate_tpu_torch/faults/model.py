"""Seeded per-round fault draws + server-side payload validation.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
faults/model.py`. Three failure modes, all off by default; any nonzero
rate (or a payload norm cap) turns the faults path on
(`Config.faults_enabled`), and all off leaves the dense round as it was:

- dropout (``--dropout_rate``): Bernoulli per sampled agent; a dropped
  agent's update never reaches aggregation (the participation mask). At
  least one agent always survives.
- stragglers (``--straggler_rate`` / ``--straggler_epochs``): a
  straggler's local training stops after ``straggler_epochs`` epochs
  (fl/client.py: the epochs past its budget are exact no-op steps); its
  partial update still takes part.
- corrupt payloads (``--corrupt_rate`` / ``--corrupt_mode``): the agent's
  update is overwritten with NaN or a huge finite constant;
  `payload_valid` rejects non-finite payloads, and those over
  ``--payload_norm_cap``, before they enter the mask.

torch cannot replay `jax.random`, so `sample_faults` draws from the port's
own stream: a CPU generator per round seeded from (seed, round,
FAULTS_KEY_TAG) (fl/rounds.RoundRNG.faults), drawn on the host before the
device work, in JAX's order: the dropout uniforms, then the straggler
uniforms, then the corrupt uniforms. The [m] draw then goes to the card as
an input of the captured round. The tests inject JAX-drawn `FaultDraw`s.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.tree import (
    Params, rows)

# JAX's fold_in tag of the fault stream; here the third word of the round's
# fault-generator seed, beside the run's seed and the round
FAULTS_KEY_TAG = 0x5FA17

# a large-but-finite f32 payload: it passes the finite check, and so tests
# the norm cap and the robust rules instead
HUGE_PAYLOAD = 1e30

CORRUPT_MODES = ("nan", "huge")


class FaultDraw(NamedTuple):
    participate: torch.Tensor   # [m] bool: survived dropout
    straggler: torch.Tensor     # [m] bool: epochs cut this round
    ep_budget: torch.Tensor     # [m] int32: local epochs each agent runs
    corrupt: torch.Tensor       # [m] bool: payload replaced with garbage


def sample_faults(cfg, gen: torch.Generator, m: int,
                  corrupt_flags=None) -> FaultDraw:
    """One round's fault draw for the m sampled agents, from `gen`.

    `corrupt_flags` ([m] bool: the slot holds a malicious agent) feeds
    ``--faults_spare_corrupt``: attackers never drop out while honest
    voters do, where the RLR vote's honest majority is thinnest."""
    u = torch.rand(m, generator=gen, device=gen.device)
    drop = u < cfg.dropout_rate
    if cfg.faults_spare_corrupt and corrupt_flags is not None:
        drop = drop & ~corrupt_flags.to(drop.device)
    # never lose the whole round: if every agent dropped, keep the one
    # whose draw lay farthest from the dropout region
    keep = torch.argmax(u)
    drop = torch.where(torch.all(drop)
                       & (torch.arange(m, device=u.device) == keep),
                       False, drop)
    straggler = (torch.rand(m, generator=gen, device=gen.device)
                 < cfg.straggler_rate)
    ep_budget = torch.where(
        straggler, min(cfg.straggler_epochs, cfg.local_ep),
        cfg.local_ep).to(torch.int32)
    corrupt = (torch.rand(m, generator=gen, device=gen.device)
               < cfg.corrupt_rate)
    return FaultDraw(~drop, straggler, ep_budget, corrupt)


def draw_to(draw: FaultDraw, device) -> FaultDraw:
    """The draw on the round's device: from pinned memory without a sync
    on a card, so the host can draw the next round meanwhile."""
    device = torch.device(device)
    if device.type != "cuda":
        return FaultDraw(*(t.to(device) for t in draw))
    return FaultDraw(*(t.pin_memory().to(device, non_blocking=True)
                       for t in draw))


def inject_corrupt(stacked_updates: Params, corrupt, mode: str) -> Params:
    """Corrupt agents' rows overwritten with garbage: deterministic
    constants (NaN, or HUGE_PAYLOAD), so every path agrees bit for bit."""
    if mode == "nan":
        val = float("nan")
    elif mode == "huge":
        val = HUGE_PAYLOAD
    else:
        raise ValueError(f"corrupt_mode must be nan|huge, got {mode!r}")
    return {k: torch.where(rows(corrupt, u),
                           torch.full((), val, dtype=u.dtype,
                                      device=u.device), u)
            for k, u in stacked_updates.items()}


def payload_valid(stacked_updates: Params, norm_cap: float = 0.0):
    """[m] bool server-side payload validation: every coordinate finite,
    and with ``norm_cap`` > 0 the global L2 norm within the cap. A huge
    finite payload's squared norm overflows to +inf in f32, which the cap
    rejects too."""
    leaves = list(stacked_updates.values())
    m = leaves[0].shape[0]
    dev = leaves[0].device
    valid = torch.ones(m, dtype=torch.bool, device=dev)
    sumsq = torch.zeros(m, dtype=torch.float32, device=dev)
    for u in leaves:
        flat = u.reshape(m, -1)
        valid = valid & torch.isfinite(flat).all(dim=1)
        if norm_cap > 0:
            f = flat.to(torch.float32)
            sumsq = sumsq + torch.sum(f * f, dim=1)
    if norm_cap > 0:
        cap = torch.tensor(norm_cap, dtype=torch.float32)
        valid = valid & (sumsq <= float(cap * cap))
    return valid


# the keys of fault_scalars (JAX fl/rounds.FAULT_INFO_KEYS)
INFO_KEYS = ("fault_dropped", "fault_straggled", "fault_voters")


def fault_scalars(draw: FaultDraw, mask):
    """The Faults/* values of a round (fault_dropped leaves out payload
    rejections: they show as the gap between m - dropped and the
    effective voters)."""
    return {
        "fault_dropped": torch.sum((~draw.participate).to(torch.float32)),
        "fault_straggled": torch.sum(draw.straggler.to(torch.float32)),
        "fault_voters": torch.sum(mask.to(torch.float32)),
    }
