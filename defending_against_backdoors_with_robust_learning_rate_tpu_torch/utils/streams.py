"""Counter-based random streams on the host: every draw a pure function of
its words.

The population axis draws per client and per round: the cohort's
candidates (data/cohort.py), each client's churn phase and presence
(service/churn.py) and its timezone and diurnal presence
(data/traffic.py). JAX derives each from `fold_in` chains of a PRNG key,
which torch cannot replay, so the port keys its own stream by the same
words: (seed, tag, the client or candidate index, the round, ...). A
draw is a hash of its words, never a generator's state, so it costs
O(the ids asked for) whatever the population, needs no sequential state
(a resumed run draws the same), and a vectorised numpy call makes a
whole cohort's draws at once.

The hash chains SplitMix64's finaliser over the words (Steele, Lea and
Flood, "Fast splittable pseudorandom number generators", 2014): each
word is XORed into the state, which is then mixed. `uniform` keeps the
top 24 bits as a float32 in [0, 1) (the draws are compared with float32
probabilities, as JAX's are), `randint` maps the top 32 bits onto
[0, n) by a multiply and a shift.
"""

from __future__ import annotations

import numpy as np

_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)


def _mix(z: np.ndarray) -> np.ndarray:
    z = z + _GAMMA
    z = (z ^ (z >> np.uint64(30))) * _M1
    z = (z ^ (z >> np.uint64(27))) * _M2
    return z ^ (z >> np.uint64(31))


def hash_words(*words) -> np.ndarray:
    """uint64 hash of the words, broadcast against each other (ints or
    int arrays; a negative int is taken modulo 2**64)."""
    arrays = [np.asarray(w).astype(np.int64).astype(np.uint64)
              for w in words]
    h = np.zeros(np.broadcast_shapes(*(a.shape for a in arrays)),
                 dtype=np.uint64)
    with np.errstate(over="ignore"):
        for a in arrays:
            h = _mix(h ^ a)
    return h


def uniform(*words) -> np.ndarray:
    """float32 in [0, 1) from the words: the hash's top 24 bits."""
    return ((hash_words(*words) >> np.uint64(40)).astype(np.float32)
            * np.float32(2.0 ** -24))


def randint(n: int, *words) -> np.ndarray:
    """int64 in [0, n) from the words (n < 2**32)."""
    hi = hash_words(*words) >> np.uint64(32)
    with np.errstate(over="ignore"):
        return ((hi * np.uint64(n)) >> np.uint64(32)).astype(np.int64)
