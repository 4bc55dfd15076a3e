"""Per-client reputation: which clients the RLR vote votes against, round
after round.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
obs/reputation.py` (`PREFIX`, `MODES`, `TAGS`, `MASKED`, `EMA_DECAY`,
`LOSE_THRESHOLD`, the sketch constants, `wants_vote`, `check`,
`reputation_on`, `rep_keys`, `sign_sums_from`, `agree_rows`, `norm_rows`,
`rank_auc`, `ReputationTracker`, `emit_rows`), with its keys, tags and
host arithmetic.

Two halves:

**In the round** (fl/rounds.py `_device_round`): two [m] lanes of the
round's info, computed on the round's device (inside the captured CUDA
graph) from the stacked updates after the attack, with masked slots
zeroed, the electorate the vote counts:

- ``rep_agree``  the fraction of parameter coordinates where the client's
  update sign matches the sign of the vote's per-coordinate sign sum (a
  zero on either side is no match);
- ``rep_norm``   the client's update L2 norm, the magnitude signal the
  sign vote cannot carry (``sign(8u) == sign(u)``).

Masked slots read ``MASKED`` (-1.0), so one lane carries value and
validity.

**On the host** (train.py): `ReputationTracker` folds every round's rows,
keyed by the sampled client ids, into longitudinal per-client state: a
suspicion observation ``max(1 - agree, 1 - med_norm / norm)`` per client
and round (``med_norm`` the row's median norm), its EMA (the ranking), an
agreement EMA and a vote-loss streak. Dense per-client state up to
``--rep_population_cap`` clients, a count-min sketch plus a top-k ledger
above it. Its state is a JSON-able dict that rides the checkpoint journal
(utils/checkpoint.py), so a resumed run writes the same Reputation/* rows.
The ranking never reads a corrupt flag; only the AUC row evaluates it
against the ground truth.

``--reputation auto`` resolves on whenever a sign vote exists (RLR
threshold > 0 or ``--aggr sign``). JAX resolves it off when its Pallas
kernel (the opt-in ``--use_pallas``) runs, because that kernel keeps the
vote's sign sums to itself; the port's fused kernel K1 is its default
server step, standing where JAX's default jnp step stands, so the port
resolves ``auto`` as JAX does under JAX's defaults. The lanes are plain
torch over the same stack K1 reads, computed before K1 runs, and K1 stays
on (``on`` too). The sharded round does not compute them yet: ``auto``
resolves off there (train.py prints so) and ``on`` is refused.

Not ported: `agree_rows_flat` (the bucketed layout, which the port does
not have). `drain_events` is kept, but nothing emits its ``rep/suspect``
events yet (the port has no event ledger).
"""

from __future__ import annotations

import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.faults import (
    masking)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.tree import (
    Params)

PREFIX = "rep_"
MODES = ("auto", "on", "off")
# host EMA decay of the per-client agreement and suspicion
EMA_DECAY = 0.9
# a round whose suspicion observation reaches this is a loss for the
# client: outvoted on a majority of coordinates, or 2x the row's median
# update norm
LOSE_THRESHOLD = 0.5
# the masked-slot sentinel of both [m] lanes
MASKED = -1.0
# count-min sketch geometry (population > rep_population_cap): 4 x 4096
# f64 cells, constant in the population
SKETCH_DEPTH = 4
SKETCH_WIDTH = 4096
# fixed affine-mix salts per sketch row (never Python's hash(): the sketch
# must be the same across interpreters and resumes)
_SKETCH_SALTS = ((0x9E3779B1, 0x85EBCA77), (0xC2B2AE3D, 0x27D4EB2F),
                 (0x165667B1, 0xD3A2646C), (0xFD7046C5, 0xB55A4F09))
# Top_Suspects rows written per boundary
N_SUSPECT_ROWS = 8
# the streak-crossing event's name in JAX's event ledger
SUSPECT_EVENT = "rep/suspect"

TAGS = {
    "clients": "Reputation/Clients_Tracked",
    "mean_agree": "Reputation/Mean_Agree",
    "min_agree": "Reputation/Min_Agree",
    "suspect_count": "Reputation/Suspect_Count",
    "top_score": "Reputation/Top_Suspect_Score",
    "top_suspects": "Reputation/Top_Suspects",
    "auc": "Reputation/Suspicion_AUC",
}

NOT_PORTED_SHARDED = (
    "--reputation on on the sharded round is not ported yet (ROADMAP queue "
    "1 item 11: the lanes against the replicated sign sums of the vote's "
    "all_reduce)")


def wants_vote(cfg) -> bool:
    """A committed sign vote exists to agree with: the RLR threshold vote
    or sign aggregation."""
    return cfg.robustLR_threshold > 0 or cfg.aggr == "sign"


def check(cfg) -> None:
    """Validate the reputation flags before any build (JAX's messages)."""
    if cfg.reputation not in MODES:
        raise ValueError(
            f"--reputation must be one of {MODES}, got {cfg.reputation!r}")
    if cfg.reputation == "on" and not wants_vote(cfg):
        raise ValueError(
            "--reputation on needs a sign vote to measure agreement "
            "against (set robustLR_threshold > 0 or --aggr sign), or use "
            "--reputation auto to resolve off without one")
    if cfg.rep_topk < 1:
        raise ValueError(f"--rep_topk must be >= 1, got {cfg.rep_topk}")
    if cfg.rep_streak < 1:
        raise ValueError(f"--rep_streak must be >= 1, got {cfg.rep_streak}")


def reputation_on(cfg) -> bool:
    """Does cfg's round compute the lanes? ``off`` or no vote: no;
    otherwise yes, ``auto`` as ``on`` (module doc)."""
    return cfg.reputation != "off" and wants_vote(cfg)


def rep_keys(cfg):
    """The rep_* keys cfg's round emits."""
    return ("rep_agree", "rep_norm") if reputation_on(cfg) else ()


# --- in the round ----------------------------------------------------------

def sign_sums_from(updates: Params) -> Params:
    """Per-coordinate signed vote sums of the (masked, zeroed) stacked
    updates."""
    return {k: torch.sum(torch.sign(u.to(torch.float32)), dim=0)
            for k, u in updates.items()}


def agree_rows(updates: Params, sign_sums: Params, mask=None):
    """[rows] rep_agree: each slot's fraction of coordinates whose update
    sign matches the sign of the vote's sum (``sign(u) * sign(s) > 0``;
    ties never count). Masked slots read ``MASKED``. The match counts are
    exact integers in f32 (below 2**24 coordinates), and the quotient is
    IEEE's, so the lane equals JAX's bit for bit."""
    rows = next(iter(updates.values())).shape[0]
    total = sum(u[0].numel() for u in updates.values())
    match = None
    for k, u in updates.items():
        uf = u.reshape(rows, -1).to(torch.float32)
        sf = torch.sign(sign_sums[k].reshape(-1).to(torch.float32))
        hit = torch.sum(((torch.sign(uf) * sf[None, :]) > 0).to(
            torch.float32), dim=1)
        match = hit if match is None else match + hit
    # divided by a tensor: CUDA divides by a Python scalar through its
    # reciprocal, an ulp away from the quotient JAX and the CPU give
    agree = match / torch.full_like(match, total)
    if mask is not None:
        agree = torch.where(mask, agree, MASKED)
    return agree


def norm_rows(updates: Params, mask=None):
    """[rows] rep_norm: each slot's update L2 norm over every coordinate;
    masked slots read ``MASKED``."""
    rows = next(iter(updates.values())).shape[0]
    sq = None
    for u in updates.values():
        uf = u.reshape(rows, -1).to(torch.float32)
        s = torch.sum(uf * uf, dim=1)
        sq = s if sq is None else sq + s
    norm = torch.sqrt(sq)
    if mask is not None:
        norm = torch.where(mask, norm, MASKED)
    return norm


def lanes(updates: Params, mask=None) -> dict:
    """{"rep_agree", "rep_norm"} of one round's stacked updates against
    their own sign vote: masked slots' rows zeroed first, so the
    electorate is the vote's (JAX fl/rounds.py:400-416)."""
    if mask is not None:
        updates = masking.zero_masked(updates, mask)
    return {"rep_agree": agree_rows(updates, sign_sums_from(updates),
                                    mask=mask),
            "rep_norm": norm_rows(updates, mask=mask)}


# --- on the host -----------------------------------------------------------

def _sketch_cols(cid: int):
    """The client's cell column per sketch row: a fixed affine + xorshift
    mix."""
    cols = []
    for a, b in _SKETCH_SALTS:
        h = (a * (cid + 1) + b) & 0xFFFFFFFF
        h ^= h >> 15
        h = (h * 0x2C1B3C6D) & 0xFFFFFFFF
        h ^= h >> 12
        cols.append(h % SKETCH_WIDTH)
    return cols


def rank_auc(scores, labels):
    """Mann-Whitney AUC of ``scores`` (higher = more suspect) against the
    boolean ``labels`` (True = corrupt), average ranks on ties; None when
    either class is empty."""
    pairs = sorted(zip(scores, labels))
    n_pos = sum(1 for _, y in pairs if y)
    n_neg = len(pairs) - n_pos
    if n_pos == 0 or n_neg == 0:
        return None
    rank_sum, i = 0.0, 0
    while i < len(pairs):
        j = i
        while j < len(pairs) and pairs[j][0] == pairs[i][0]:
            j += 1
        avg_rank = (i + 1 + j) / 2.0
        rank_sum += avg_rank * sum(1 for k in range(i, j) if pairs[k][1])
        i = j
    return (rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)


class ReputationTracker:
    """Longitudinal per-client suspicion state folded from the rounds'
    [m] rep_agree and rep_norm rows, keyed by the sampled client ids.

    Dense mode (population <= cap): one entry per client seen,
    ``[agree_ema, n, streak, susp_ema]``. Sketch mode (population > cap):
    a count-min sketch of each client's suspicion mass and fold count,
    and exact entries for the ``topk`` current heavy hitters only; no AUC
    there. Folds are deterministic: slots in row order, ties by client
    id. Observe-only: nothing here feeds the participation mask."""

    def __init__(self, population: int, cap: int, topk: int,
                 streak_thr: int, decay: float = EMA_DECAY):
        self.population = int(population)
        self.cap = int(cap)
        self.topk = int(topk)
        self.streak_thr = int(streak_thr)
        self.decay = float(decay)
        self.sketch_mode = self.population > self.cap
        self.rounds_folded = 0
        self.clients = {}
        self.mass = ([[0.0] * SKETCH_WIDTH for _ in range(SKETCH_DEPTH)]
                     if self.sketch_mode else None)
        self.count = ([[0.0] * SKETCH_WIDTH for _ in range(SKETCH_DEPTH)]
                      if self.sketch_mode else None)
        self._pending_events = []

    @classmethod
    def for_config(cls, cfg, population: int):
        return cls(population, cfg.rep_population_cap, cfg.rep_topk,
                   cfg.rep_streak)

    def fold(self, round_id: int, ids, agrees, norms=None) -> None:
        """Fold one round's row: the [m] sampled ids and their rep_agree
        and rep_norm values (``MASKED`` slots skipped). ``norms=None``
        scores agreement alone."""
        vals = [(int(cid), float(a),
                 None if norms is None else float(r))
                for cid, a, r in zip(
                    ids, agrees,
                    agrees if norms is None else norms)
                if float(a) >= 0.0]
        # the row's own median norm: the scale-free magnitude reference
        med = None
        if norms is not None and vals:
            ns = sorted(r for _, _, r in vals)
            mid = len(ns) // 2
            med = (ns[mid] if len(ns) % 2
                   else 0.5 * (ns[mid - 1] + ns[mid]))
        for cid, a, r in vals:
            dev = 0.0
            if med is not None and r > med:
                dev = 1.0 if med <= 0.0 else 1.0 - med / r
            self._fold_one(cid, a, max(1.0 - a, dev), int(round_id))
        self.rounds_folded += 1

    def _fold_one(self, cid: int, agree: float, susp: float,
                  round_id: int) -> None:
        if self.sketch_mode:
            est = self._sketch_add(cid, susp)
            if cid not in self.clients and not self._admit(cid, est):
                return
        ent = self.clients.get(cid)
        if ent is None:
            ent = [agree, 1, 1 if susp >= LOSE_THRESHOLD else 0, susp]
            self.clients[cid] = ent
        else:
            ent[0] = self.decay * ent[0] + (1.0 - self.decay) * agree
            ent[1] += 1
            ent[2] = ent[2] + 1 if susp >= LOSE_THRESHOLD else 0
            ent[3] = self.decay * ent[3] + (1.0 - self.decay) * susp
        if ent[2] == self.streak_thr:
            # the exact crossing: one event per streak
            self._pending_events.append({
                "client": cid, "streak": ent[2], "round": round_id,
                "score": round(ent[3], 6)})

    def _sketch_add(self, cid: int, susp: float) -> float:
        """Add one observation; the count-min estimate of the client's
        mean suspicion so far."""
        est = float("inf")
        for row, col in enumerate(_sketch_cols(cid)):
            self.mass[row][col] += susp
            self.count[row][col] += 1.0
            est = min(est, self.mass[row][col]
                      / max(self.count[row][col], 1.0))
        return est

    def _admit(self, cid: int, est: float) -> bool:
        """Ledger admission: always below capacity; at capacity only past
        the least suspicion, evicting it (ties by id)."""
        if len(self.clients) < self.topk:
            return True
        worst_id, worst = None, None
        for k, ent in self.clients.items():
            score = ent[3]
            if worst is None or score < worst or (score == worst
                                                  and k > worst_id):
                worst_id, worst = k, score
        if est <= worst:
            return False
        del self.clients[worst_id]
        return True

    def suspicion(self, cid: int) -> float:
        """The client's suspicion in [0, 1]: its EMA, the sketch's
        estimate off the ledger, 0.0 for a client never seen (dense)."""
        ent = self.clients.get(cid)
        if ent is not None:
            return ent[3]
        if not self.sketch_mode:
            return 0.0
        est = float("inf")
        for row, col in enumerate(_sketch_cols(cid)):
            c = self.count[row][col]
            est = min(est, (self.mass[row][col] / c) if c else 0.0)
        return est

    def ranked(self):
        """[(cid, score)], most suspect first, ties by id."""
        return sorted(((cid, ent[3]) for cid, ent in self.clients.items()),
                      key=lambda t: (-t[1], t[0]))

    def suspect_count(self) -> int:
        return sum(1 for ent in self.clients.values()
                   if ent[2] >= self.streak_thr)

    def drain_events(self):
        """The streak crossings since the last drain."""
        out, self._pending_events = self._pending_events, []
        return out

    def boundary_rows(self, corrupt_pred=None):
        """[(tag, value)] of one boundary's Reputation/* rows, in JAX's
        order; ``corrupt_pred`` (cid -> bool, the ground truth) adds the
        AUC row in dense mode."""
        rows = [(TAGS["clients"], float(len(self.clients)))]
        if self.clients:
            emas = [ent[0] for ent in self.clients.values()]
            rows.append((TAGS["mean_agree"], sum(emas) / len(emas)))
            rows.append((TAGS["min_agree"], min(emas)))
        rows.append((TAGS["suspect_count"], float(self.suspect_count())))
        ranked = self.ranked()
        if ranked:
            rows.append((TAGS["top_score"], ranked[0][1]))
            for i, (cid, _) in enumerate(ranked[:N_SUSPECT_ROWS]):
                rows.append((f"{TAGS['top_suspects']}/{i}", float(cid)))
        if corrupt_pred is not None and not self.sketch_mode and ranked:
            auc = rank_auc([s for _, s in ranked],
                           [bool(corrupt_pred(c)) for c, _ in ranked])
            if auc is not None:
                rows.append((TAGS["auc"], auc))
        return rows

    def summary(self, corrupt_pred=None) -> dict:
        """The run summary's ``suspicion`` entry."""
        ranked = self.ranked()
        out = {
            "clients": len(self.clients),
            "rounds": self.rounds_folded,
            "suspect_count": self.suspect_count(),
            "suspects": [cid for cid, _ in ranked[:self.topk]],
            "scores": [round(s, 6) for _, s in ranked[:self.topk]],
            "mode": "sketch" if self.sketch_mode else "dense",
        }
        if corrupt_pred is not None and not self.sketch_mode and ranked:
            auc = rank_auc([s for _, s in ranked],
                           [bool(corrupt_pred(c)) for c, _ in ranked])
            if auc is not None:
                out["auc"] = round(auc, 6)
        return out

    def state_dict(self) -> dict:
        """JSON-able state for the checkpoint journal (ids as strings)."""
        out = {"rounds": self.rounds_folded,
               "clients": {str(cid): ent
                           for cid, ent in self.clients.items()}}
        if self.sketch_mode:
            out["mass"] = self.mass
            out["count"] = self.count
        return out

    def load_state(self, state: dict) -> None:
        """Restore from a journal entry (an empty or missing one leaves
        the fresh state)."""
        if not state:
            return
        self.rounds_folded = int(state.get("rounds", 0))
        self.clients = {
            int(cid): [float(e[0]), int(e[1]), int(e[2]), float(e[3])]
            for cid, e in state.get("clients", {}).items()}
        if self.sketch_mode and "mass" in state:
            self.mass = [[float(x) for x in row] for row in state["mass"]]
            self.count = [[float(x) for x in row] for row in state["count"]]


def emit_rows(writer, tracker, step: int, corrupt_pred=None) -> None:
    """Write one boundary's Reputation/* rows."""
    for tag, val in tracker.boundary_rows(corrupt_pred):
        writer.scalar(tag, float(val), step)
