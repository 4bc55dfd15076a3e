"""Numerical-health guards: the boundary's finite check and its host-side
endpoint.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
utils/guards.py` (`all_finite_device`, `finite_warn` :66). Both are
endpoints of the health policy: the driver fetches the finite bit with the
boundary's other values, and health/monitor.enforce calls `finite_warn`,
so its message and its FloatingPointError stay JAX's word for word. JAX's
checkify instrumentation behind ``--debug_nan`` (`guard_round_fn`) is not
ported.
"""

from __future__ import annotations

import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.tree import (
    Params)


def all_finite_device(params: Params) -> torch.Tensor:
    """The device half of the post-round guard: a 0-d bool, True iff every
    coordinate of params is finite, with no host sync (the boundary
    fetches it with its other values)."""
    return torch.stack([torch.isfinite(p).all()
                        for p in params.values()]).all()


def finite_warn(finite, where: str = "", raise_error: bool = True) -> bool:
    """Host-side half: act on an already-fetched finite flag. Raises when
    `raise_error`, else prints a loud warning and returns the flag (so
    sweeps record their NaN metrics instead of aborting)."""
    finite = bool(finite)
    if not finite:
        msg = (f"non-finite parameters detected"
               f"{' at ' + where if where else ''}"
               f" — rerun with --debug_nan to locate the producing op")
        if raise_error:
            raise FloatingPointError(msg)
        print(f"[guards] WARNING: {msg}")
    return finite
