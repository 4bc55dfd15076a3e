"""Buffered-asynchronous aggregation (FedBuff's shape): `--agg_mode buffered`.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
fl/buffered.py` (`ASYNC_KEY_TAG`, `ASYNC_INFO_KEYS`, `is_buffered`,
`buffer_k`, `wants_sign`, `max_staleness`, `vote_range`, `has_pending`,
`check`, `banner`, `latency`, `host_latency_draw`, `init_state`,
`_level_weights`, `tick_contributions`, `_roll_pend`, `fold_commit`,
`_per_bin_split`), with its state fields, its fold and commit arithmetic
and its refusals word for word.

The round loop becomes a stream of ticks. Each tick trains the sampled
cohort against the committed params, as a sync round does; but the
straggler Bernoulli (`--straggler_rate`) no longer cuts epochs: it picks
who uploads late. A late client trains full epochs and its update lands
T in [1, `--async_max_staleness`] ticks later, with staleness T. The
server folds every arrival into a carried buffer, weighted by 1/(1+T)^a
(`--async_staleness_exp`), with per-staleness counters and sign-vote
accumulators, and commits avg or sign (+- the RLR vote, through
`ops/aggregate.rlr_from_sign_sum`) once `--async_buffer_k` arrivals are
in (0: the cohort size m). Params move only at commits. With K = m, no
stragglers and exponent 0 every tick commits, and the fold is the sync
server step's op sequence: buffered == sync bit for bit for sign, and
for avg (tests/test_torch_buffered_round.py).

The draw (`latency`): T is drawn on the host each tick from its own CPU
generator, seeded from (seed, round, ASYNC_KEY_TAG) (fl/rounds.RoundRNG.
latency), independent of the fault draw's (seed, round, FAULTS_KEY_TAG)
stream, as JAX folds its own tag into the fault key: uniform in [1, S]
for each straggler, or `data/traffic.latency_quantile` of uniforms under
`--traffic diurnal`; 0 for everyone else. It enters the captured round as
an input, as the fault draw does. torch cannot replay jax.random, so the
tests inject T.

The state (`init_state`) is a flat dict of f32 tensors on the params'
device: "count", "stale", "wsum", "pend_wsum", "pend_cnt", and one entry
per parameter leaf under "buf/", "sign/", "pend_buf/", "pend_sign/" and
"bin_sign/" (JAX's trees, flattened by the port's leaf names). The round
carries it beside the params in ONE dict (`join_carry`: every state key
under CARRY_PREFIX, which no parameter name can take), so the captured
round's static params buffers (utils/compile_cache.RoundGraph) carry the
buffer from replay to replay, the chained round threads it with the
params, and the checkpoint saves it beside them (JAX's (params, buffer)
carry, train.py:709-718). `model_params` gives the bare model params
that eval, the summary and the health monitor read.

The commit gate stays on the device: `commit = count >= K`, applied with
`torch.where` (a Python branch would be captured once and replayed
forever). Masked rows (dropped, payload rejected, absent, quarantined)
stay out of every sum by `where` (faults/masking.zero_masked), never by a
zero weight, which would let a rejected NaN payload through.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data import (
    traffic)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.faults import (
    masking)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.aggregate import (
    apply_aggregate, rlr_from_sign_sum)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.tree import (
    Params, rows)

# the third word of the latency generator's seed, beside the run's seed
# and the round (JAX's fold_in tag of the arrival stream)
ASYNC_KEY_TAG = 0xA51C

# the info keys every buffered tick emits (Async/* rows; the chained round
# stacks them like the fault counters)
ASYNC_INFO_KEYS = ("async_fill", "async_committed", "async_stale_hist")

# the carry's names for the buffer state: no parameter name starts so
CARRY_PREFIX = "@async/"


def is_buffered(cfg) -> bool:
    """The mode decision (JAX `is_buffered`)."""
    mode = getattr(cfg, "agg_mode", "sync")
    if mode not in ("sync", "buffered"):
        raise ValueError(f"agg_mode must be 'sync' or 'buffered', "
                         f"got {mode!r}")
    return mode == "buffered"


def buffer_k(cfg) -> int:
    """The commit threshold K; 0 = the cohort size m (the sync cadence at
    staleness 0)."""
    return int(cfg.async_buffer_k) or cfg.agents_per_round


def wants_sign(cfg) -> bool:
    """The buffer carries sign-vote accumulators: the RLR vote, the sign
    aggregate and the full telemetry's per-staleness split read them."""
    return (cfg.robustLR_threshold > 0 or cfg.aggr == "sign"
            or cfg.telemetry == "full")


def max_staleness(cfg) -> int:
    return int(cfg.async_max_staleness)


def vote_range(cfg) -> int:
    """The buffered electorate's vote-margin range, K + m: between commits
    the accumulated sign sums can exceed m."""
    return buffer_k(cfg) + cfg.agents_per_round


def has_pending(cfg) -> bool:
    """Arrivals can be late only with stragglers; without them every T is
    0 and the pending ladder is never made."""
    return cfg.straggler_rate > 0


def check(cfg) -> None:
    """JAX's refusals of the compositions the buffer cannot serve, before
    any build. (JAX's `--use_pallas` refusal has no flag here: the port's
    fused kernel K1 is off under buffered, fl/rounds._fused_applicable.)"""
    if not is_buffered(cfg):
        return
    if cfg.aggr not in ("avg", "sign"):
        raise ValueError(
            f"--agg_mode buffered folds running sums; the order-statistic "
            f"aggregator --aggr {cfg.aggr} needs the individual updates "
            f"a buffer cannot reconstruct — use --aggr avg|sign (± RLR) "
            f"or --agg_mode sync")
    if cfg.diagnostics:
        raise ValueError(
            "--agg_mode buffered does not support --diagnostics (the "
            "Norms/Sign research scalars describe one committed round's "
            "lr/update trees, which a partially-filled buffer never "
            "has); re-run with --agg_mode sync, or drop --diagnostics")
    if int(cfg.async_buffer_k) < 0:
        raise ValueError(f"--async_buffer_k must be >= 0 "
                         f"(0 = auto: the cohort size), got "
                         f"{cfg.async_buffer_k}")
    if cfg.async_staleness_exp < 0:
        raise ValueError(f"--async_staleness_exp must be >= 0, got "
                         f"{cfg.async_staleness_exp}")
    if max_staleness(cfg) < 1:
        raise ValueError(f"--async_max_staleness must be >= 1, got "
                         f"{cfg.async_max_staleness}")


def banner(cfg) -> str:
    if not is_buffered(cfg):
        return ""
    return (f"[async] buffered aggregation: commit every "
            f"{buffer_k(cfg)} arrivals, staleness weight "
            f"1/(1+T)^{cfg.async_staleness_exp}, max latency "
            f"{max_staleness(cfg)} tick(s) "
            f"(straggler_rate {cfg.straggler_rate} drives the arrival "
            f"draw; fl/buffered.py)")


# --------------------------------------------------------------- the draw ---

def latency(cfg, gen: torch.Generator, straggler) -> Optional[torch.Tensor]:
    """[m] int32 arrival latency in ticks on the host, or None when no
    client can be late: uniform in [1, S] from `gen` for each straggler
    ([m] bool, the fault draw's), or under --traffic diurnal
    `latency_quantile` of uniforms from `gen`; 0 for the others."""
    if not has_pending(cfg) or straggler is None:
        return None
    straggler = torch.as_tensor(straggler, dtype=torch.bool).cpu()
    S = max_staleness(cfg)
    if cfg.traffic_enabled:
        t = traffic.latency_quantile(
            cfg, torch.rand(straggler.shape, generator=gen), S)
    else:
        t = torch.randint(1, S + 1, straggler.shape, generator=gen,
                          dtype=torch.int32)
    return torch.where(straggler, t, 0).to(torch.int32)


def host_latency_draw(cfg, rnd: int, straggler, seed: int = 0):
    """Round rnd's latency draw of a run seeded `seed`, from the stragglers
    `straggler` (the draw the round fns make; the scenario tools' mirror).
    An [m] int32 tensor, zeros when no client can be late."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl.rounds import (
        RoundRNG)
    t = latency(cfg, RoundRNG(seed, "cpu").latency(rnd), straggler)
    if t is None:
        return torch.zeros(len(straggler), dtype=torch.int32)
    return t


# ----------------------------------------------------------- carried state ---

def init_state(cfg, params: Params,
               per_bin: bool = False) -> Dict[str, torch.Tensor]:
    """The buffer state, zeros, on the params' device:

      count      []       arrivals since the last commit
      stale      [S+1]    arrivals per staleness bin since the commit
      buf/*      leaf     staleness-weighted update sum         (avg)
      wsum       []       staleness-weighted weight sum         (avg)
      sign/*     leaf     sign-vote accumulator                 (vote)
      pend_*     [S, ..]  not-yet-arrived partial sums, by ticks until
                          arrival; pend_cnt [S, S+1]             (stragglers)
      bin_sign/* [S+1, ..] per-staleness sign accumulators      (per_bin
                          and --telemetry full: the Defense split)"""
    S = max_staleness(cfg)
    device = next(iter(params.values())).device

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def per_leaf(field, lead=()):
        for k, p in params.items():
            state[f"{field}/{k}"] = zeros(*lead, *p.shape)

    state = {"count": zeros(), "stale": zeros(S + 1)}
    avg, sgn = cfg.aggr == "avg", wants_sign(cfg)
    if avg:
        per_leaf("buf")
        state["wsum"] = zeros()
    if sgn:
        per_leaf("sign")
    if has_pending(cfg):
        if avg:
            per_leaf("pend_buf", (S,))
            state["pend_wsum"] = zeros(S)
        if sgn:
            per_leaf("pend_sign", (S,))
        state["pend_cnt"] = zeros(S, S + 1)
    if per_bin and cfg.telemetry == "full":
        per_leaf("bin_sign", (S + 1,))
    return state


def join_carry(params: Params, state: Dict[str, torch.Tensor]) -> Params:
    """The round's carry: the params, then the state under CARRY_PREFIX."""
    return {**params, **{CARRY_PREFIX + k: v for k, v in state.items()}}


def model_params(carry: Params) -> Params:
    """The bare model params of a carry (a plain params dict as it is)."""
    return {k: v for k, v in carry.items() if not k.startswith(CARRY_PREFIX)}


def split_carry(carry: Params):
    """(params, state) of a carry."""
    n = len(CARRY_PREFIX)
    return model_params(carry), {k[n:]: v for k, v in carry.items()
                                 if k.startswith(CARRY_PREFIX)}


def _tree(state, field: str, names) -> Params:
    return {k: state[f"{field}/{k}"] for k in names}


def _put(state, field: str, tree: Params) -> None:
    for k, v in tree.items():
        state[f"{field}/{k}"] = v


# ------------------------------------------------------ tick contributions ---

def _level_weights(cfg, T):
    """Per-slot staleness weight 1/(1+T)^a; None when a == 0 (the weight
    is exactly 1 and the multiply is skipped) or without a draw."""
    a = float(cfg.async_staleness_exp)
    if a == 0.0 or T is None:
        return None
    return torch.pow(1.0 + T.to(torch.float32), -a)


def _sign_sums(updates: Params) -> Params:
    return {k: torch.sum(torch.sign(u), dim=0) for k, u in updates.items()}


def tick_contributions(cfg, updates: Params, sizes, mask, T) -> dict:
    """One tick's arrival contributions from the trained [m, ...] stack:
    `sizes` [m], `mask` the [m] participation mask or None, `T` the [m]
    latency draw or None. Returns {"cnt", "wsum" (avg), "buf" (avg, a
    params dict), "sign" (vote, a params dict)}: plain shapes without `T`
    (everything arrives now, the sync step's op sequence), else stacked
    [S+1, ...] by latency level, leaf by leaf so that one leaf's masked
    copy is alive at a time."""
    avg, sgn = cfg.aggr == "avg", wants_sign(cfg)
    u0 = next(iter(updates.values()))
    w = sizes.to(torch.float32)
    sw = _level_weights(cfg, T)
    if sw is not None:
        w = w * sw
    out = {}
    if T is None:
        if mask is not None:
            updates = masking.zero_masked(updates, mask)
            w = torch.where(mask, w, 0.0)
            out["cnt"] = masking.count_f32(mask)
        else:
            out["cnt"] = torch.full((), float(u0.shape[0]),
                                    dtype=torch.float32, device=u0.device)
        if avg:
            out["wsum"] = torch.sum(w)
            out["buf"] = {k: torch.sum(u * rows(w, u), dim=0)
                          for k, u in updates.items()}
        if sgn:
            out["sign"] = _sign_sums(updates)
        return out

    S = max_staleness(cfg)
    valid = (mask if mask is not None
             else torch.ones(T.shape, dtype=torch.bool, device=T.device))
    levels = [valid & (T == s) for s in range(S + 1)]
    wls = [torch.where(lvl, w, 0.0) for lvl in levels]
    out["cnt"] = torch.stack([masking.count_f32(lvl) for lvl in levels])
    if avg:
        out["wsum"] = torch.stack([torch.sum(wl) for wl in wls])
        out["buf"] = {}
    if sgn:
        out["sign"] = {}
    for k, u in updates.items():
        bufs, signs = [], []
        for lvl, wl in zip(levels, wls):
            zeroed = masking.zero_rows(u, lvl)
            if avg:
                bufs.append(torch.sum(zeroed * rows(wl, zeroed), dim=0))
            if sgn:
                signs.append(torch.sum(torch.sign(zeroed), dim=0))
        if avg:
            out["buf"][k] = torch.stack(bufs)
        if sgn:
            out["sign"][k] = torch.stack(signs)
    return out


# ------------------------------------------------------------ fold + commit ---

def _shift(x):
    """x [S, ...] one tick on: slot i takes slot i+1, the last slot 0."""
    return torch.cat([x[1:], torch.zeros_like(x[:1])])


def _roll_pend(pend: Params, contrib_tail: Params) -> Params:
    """pend [S, ...] advances one tick: slot i holds what arrives i+1
    ticks from now. The head (arriving now) was consumed by the caller;
    the fresh level-(i+1) contribution joins slot i."""
    return {k: _shift(p) + contrib_tail[k] for k, p in pend.items()}


def fold_commit(cfg, params: Params, state, contribs: dict, noise, m: int):
    """Fold one tick's contributions into the buffer, commit when the gate
    fires. Returns (new params, new state, lr, agg, extras, vote_sign):
    `lr` and `agg` the commit decision's (the hypothetical commit on a
    tick that does not commit; telemetry reads them either way), `extras`
    the Async/* values and, with the per-bin state, the per-staleness
    Defense split, `vote_sign` the buffer's accumulated sign sums (None
    without a vote). `noise` is the tick's pre-drawn server noise
    (ops/aggregate.draw_noise) or None."""
    names = list(params)
    S = max_staleness(cfg)
    avg, sgn, pend = cfg.aggr == "avg", wants_sign(cfg), has_pending(cfg)
    stacked = contribs["cnt"].ndim > 0
    if pend and not stacked:
        raise ValueError(
            "buffered fold: pending state requires level-stacked "
            "contributions (a caller passed single-level sums on a "
            "straggler_rate > 0 config)")
    device = contribs["cnt"].device

    # ---- arrivals: this tick's level-0 contribution + the pending head
    head = (lambda x: x[0]) if stacked else (lambda x: x)
    arr_bins = torch.cat([head(contribs["cnt"]).reshape(1),
                          torch.zeros(S, dtype=torch.float32,
                                      device=device)])
    arr_wsum = head(contribs["wsum"]) if avg else None
    arr_buf = ({k: head(c) for k, c in contribs["buf"].items()}
               if avg else None)
    arr_sign = ({k: head(c) for k, c in contribs["sign"].items()}
                if sgn else None)
    new_state = {}
    if pend:
        arr_bins = arr_bins + state["pend_cnt"][0]
        if avg:
            pend_buf = _tree(state, "pend_buf", names)
            arr_wsum = arr_wsum + state["pend_wsum"][0]
            arr_buf = {k: a + pend_buf[k][0] for k, a in arr_buf.items()}
            _put(new_state, "pend_buf", _roll_pend(
                pend_buf, {k: c[1:] for k, c in contribs["buf"].items()}))
            new_state["pend_wsum"] = (_shift(state["pend_wsum"])
                                      + contribs["wsum"][1:])
        if sgn:
            pend_sign = _tree(state, "pend_sign", names)
            arr_sign = {k: a + pend_sign[k][0] for k, a in arr_sign.items()}
            _put(new_state, "pend_sign", _roll_pend(
                pend_sign, {k: c[1:] for k, c in contribs["sign"].items()}))
        # per-(remaining, staleness-bin) counts: a level-s draw arrives s
        # ticks out into bin s, routed by the identity's superdiagonal
        route = (torch.eye(S + 1, dtype=torch.float32, device=device)[1:]
                 * contribs["cnt"][1:, None])
        new_state["pend_cnt"] = _shift(state["pend_cnt"]) + route

    # ---- fold
    count1 = state["count"] + torch.sum(arr_bins)
    stale1 = state["stale"] + arr_bins
    if avg:
        buf0 = _tree(state, "buf", names)
        buf1 = {k: buf0[k] + arr_buf[k] for k in names}
        wsum1 = state["wsum"] + arr_wsum
    sign1 = None
    if sgn:
        sign0 = _tree(state, "sign", names)
        sign1 = {k: sign0[k] + arr_sign[k] for k in names}
    bin1 = None
    if f"bin_sign/{names[0]}" in state:
        # the per-staleness vote accumulators: a contribution's bin is its
        # latency level, known at the draw, so it is added now; unstacked
        # contributions are all level 0 and pad into bin 0
        contrib_sign = (contribs["sign"] if stacked else
                        {k: torch.cat([c[None], c.new_zeros((S,) + c.shape)])
                         for k, c in arr_sign.items()})
        bin0 = _tree(state, "bin_sign", names)
        bin1 = {k: bin0[k] + contrib_sign[k] for k in names}

    # ---- the commit decision, every tick, applied by `where`
    commit = count1 >= float(buffer_k(cfg))
    slr = cfg.effective_server_lr
    thr = float(cfg.robustLR_threshold)
    if cfg.robustLR_threshold > 0 and cfg.rlr_threshold_mode == "scaled":
        # the buffered electorate is the buffer, not the cohort: scale
        # against the arrivals actually voting
        thr = thr * count1 / float(m)
    lr = ({k: rlr_from_sign_sum(s, thr, slr) for k, s in sign1.items()}
          if cfg.robustLR_threshold > 0 else slr)
    filled = count1 > 0
    if avg:
        # the empty buffer guarded (0/0): a zero aggregate, a no-op commit
        agg = {k: torch.where(filled, b / wsum1, torch.zeros_like(b))
               for k, b in buf1.items()}
    else:
        agg = {k: torch.where(filled, torch.sign(s), torch.zeros_like(s))
               for k, s in sign1.items()}
    if cfg.noise > 0:
        if noise is None:
            raise ValueError("--noise > 0: the tick draws the server noise "
                             "first (draw_noise)")
        agg = {k: a + noise[k] for k, a in agg.items()}
    committed = apply_aggregate(params, lr, agg)
    new_params = {k: torch.where(commit, committed[k], p)
                  for k, p in params.items()}

    # ---- reset on commit
    def z(x):
        return torch.where(commit, torch.zeros_like(x), x)

    new_state["count"] = z(count1)
    new_state["stale"] = z(stale1)
    if avg:
        _put(new_state, "buf", {k: z(v) for k, v in buf1.items()})
        new_state["wsum"] = z(wsum1)
    if sgn:
        _put(new_state, "sign", {k: z(v) for k, v in sign1.items()})
    extras = {"async_fill": count1,
              "async_committed": commit.to(torch.float32),
              "async_stale_hist": stale1}
    if bin1 is not None:
        extras.update(_per_bin_split(cfg, bin1, agg, count1, stale1, thr))
        _put(new_state, "bin_sign", {k: z(v) for k, v in bin1.items()})
    if set(new_state) != set(state):
        raise AssertionError(f"buffered fold: state fields "
                             f"{set(state) ^ set(new_state)} not carried")
    # in the state's own order: a captured round is keyed by the carry's
    # structure, and the next tick hands this state back
    new_state = {k: new_state[k] for k in state}
    return new_params, new_state, lr, agg, extras, sign1


def _per_bin_split(cfg, bin_sign: Params, agg: Params, count1, stale1, thr):
    """The per-staleness-bin Defense split (--telemetry full):

    - ``tel_stale_flip`` [S+1]: the fraction of coordinates the RLR vote
      would flip if bin b voted alone, at the threshold scaled to the
      bin's electorate (thr * n_b / n);
    - ``tel_stale_cos``  [S+1]: the cosine of bin b's accumulated sign
      vote to the aggregate (0 for an empty bin)."""
    S = max_staleness(cfg)
    device = count1.device
    total = sum(b.numel() // (S + 1) for b in bin_sign.values())
    n_eff = torch.clamp(count1, min=1.0)
    thr_b = thr * stale1 / n_eff
    flips = torch.zeros(S + 1, dtype=torch.float32, device=device)
    dots = torch.zeros_like(flips)
    bsq = torch.zeros_like(flips)
    asq = torch.zeros((), dtype=torch.float32, device=device)
    for k, b in bin_sign.items():
        bf = b.reshape(S + 1, -1)
        af = agg[k].reshape(-1).to(torch.float32)
        flips = flips + torch.sum(
            (torch.abs(bf) < thr_b[:, None]).to(torch.float32), dim=1)
        dots = dots + bf @ af
        bsq = bsq + torch.sum(bf * bf, dim=1)
        asq = asq + torch.sum(af * af)
    cos = dots * torch.rsqrt(bsq * asq + 1e-12)
    return {"tel_stale_flip": flips / total,
            "tel_stale_cos": torch.where(stale1 > 0, cos, 0.0)}
