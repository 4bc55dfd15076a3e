"""Per-agent update diagnostics.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
fl/diagnostics.py`, reduced to `per_agent_norms`, the part the defense
telemetry (obs/telemetry.py) reads. The rest of that module (`--diagnostics`,
`--top_frac`, the Fisher estimate) waits for its slice.
"""

from __future__ import annotations

import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.tree import (
    Params, norm_rows)


def per_agent_norms(stacked_updates: Params) -> torch.Tensor:
    """[m] L2 norms of the stacked agent updates."""
    return norm_rows(stacked_updates)
