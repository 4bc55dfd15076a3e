"""RLR-aware sign-flip voting: corrupt updates vote against the honest
sign to flip the per-parameter learning rate.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
attack/signflip.py` (`scale_rows`); "Learning to Backdoor Federated
Learning", arXiv:2303.03320. Each corrupt client trains, then submits the
negated update: every coordinate where the honest clients agree loses 2
votes of margin per attacker. With c corrupt of m voters, a unanimous
coordinate drops from margin m to m - 2c, so the attack wins where the
threshold exceeds m - 2c. With ``--poison_frac 0`` it is the pure
untargeted anti-vote. ``--attack_boost`` composes: the scale is -boost.
"""

from __future__ import annotations

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.attack import (
    boost as boost_mod)


def scale_rows(corrupt_flags, active, boost: float):
    """[m] f32 row scale: ``-boost`` on corrupt slots while the schedule
    is active, 1 elsewhere: boost's scale at the negated factor."""
    return boost_mod.scale_rows(corrupt_flags, active, -boost)
