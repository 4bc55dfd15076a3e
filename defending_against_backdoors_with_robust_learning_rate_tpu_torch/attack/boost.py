"""Model-replacement boosting: scale corrupt updates to survive averaging.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
attack/boost.py` (`scale_rows`); "How To Backdoor Federated Learning",
arXiv:1807.00459. With m clients averaged, one attacker's update is
diluted by about 1/m, so the attacker submits ``boost * u``.

What the defenses see:

- plain FedAvg: the boosted update dominates the weighted sum;
- RLR: the vote is on signs, which boosting cannot change, so backdoor
  coordinates still lack the honest margin, their learning rate flips,
  and the boosted magnitude is applied in the wrong direction;
- ``--payload_norm_cap``: a boosted update's L2 norm grows by exactly
  ``boost``, so the server-side check masks it out; the attack comes
  before the payload check in the round (fl/rounds._device_round), so
  this interaction is real.

The transform is a per-row multiplicative scale on the stacked [m, ...]
updates, elementwise and collective-free.
"""

from __future__ import annotations

import torch


def scale_rows(corrupt_flags: torch.Tensor, active, boost: float
               ) -> torch.Tensor:
    """[m] f32 row scale: ``boost`` on corrupt slots while the schedule is
    active, 1 elsewhere. ``active`` is a bool, or None for always on."""
    hit = corrupt_flags if active is None else corrupt_flags & bool(active)
    return torch.ones(hit.shape, dtype=torch.float32,
                      device=hit.device).masked_fill_(hit, boost)
