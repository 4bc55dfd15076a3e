"""Defense telemetry: cheap scalars of the RLR vote computed in the round.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
obs/telemetry.py` (`check_level`, `telemetry_keys`, `compute` and its pure
pieces, `host_summary`, `emit_scalars`), with its keys, tags and bucketing.
The round computes, on its device and inside the captured CUDA graph:

- ``tel_upd_norm_p50/p95/max``  nearest-rank percentiles of the m
  per-agent update L2 norms;
- ``tel_flip_frac``             fraction of coordinates the RLR vote
  flipped to -server_lr (RLR on only);
- ``tel_margin_mean``           mean sign-vote margin |sum sign(u)| / m;
- ``tel_margin_hist``           [N_MARGIN_BUCKETS] fraction of coordinates
  per bucketized vote margin in [0, m];
- ``tel_cos_honest/corrupt``    mean cosine of honest (resp. corrupt)
  agent updates to the aggregate.

``--telemetry`` ``off`` adds nothing to the round; ``basic`` = the norm
percentiles + flip fraction; ``full`` adds the margin histogram and the
cosine split. The values are tensors of the round's info, lanes of the
captured graph like the health lanes, read at eval boundaries as
``Defense/*`` rows of metrics.jsonl (train.py). Masked agents (faults/,
quarantine) are zeroed before the stats. The telemetry reads the explicit
lr and aggregate trees, so it turns the fused server kernel off, as JAX's
``cfg.telemetry == "off"`` clause of `_pallas_applicable` does.

Under ``--agg_mode buffered`` (fl/buffered.py) `compute` takes the
buffer's accumulated sign sums (`sign_sums`), so the margin histogram
describes the buffered electorate, bucketized over its `vote_range`
(K + m); under ``full`` the fold adds the per-staleness split
``tel_stale_flip`` and ``tel_stale_cos`` ([S+1] each,
fl/buffered._per_bin_split), one Defense/Stale_* row per bin.

The sharded round (parallel/rounds.py) computes the same values over its
agents group: `compute_sharded` on the leaf layout, from each rank's
[m/d] block and the replicated lr and aggregate, with three all_gathers
under ``full`` (the norms and the two cosine accumulators; one, the
norms, under ``basic``) and no all_reduce of its own: the margins re-read
the vote's all_reduced sign sums. On the bucket layout `shard_vote_stats`
packs the flip count and the margin counts of the scattered shard into
the result all_gather, and `compute_sharded_bucket` adds the same norm
and cosine all_gathers (JAX obs/telemetry.py:223-361).
"""

from __future__ import annotations

import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.faults import (
    masking)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl.diagnostics import (
    per_agent_norms)

LEVELS = ("off", "basic", "full")
N_MARGIN_BUCKETS = 8
PREFIX = "tel_"
_EPS = 1e-12

# metrics.jsonl tag per telemetry key; tel_margin_hist expands to one
# Defense/Vote_Margin_Hist/<i> row per bucket (emit_scalars)
TAGS = {
    "tel_upd_norm_p50": "Defense/Update_Norm_P50",
    "tel_upd_norm_p95": "Defense/Update_Norm_P95",
    "tel_upd_norm_max": "Defense/Update_Norm_Max",
    "tel_flip_frac": "Defense/LR_Flip_Fraction",
    "tel_margin_mean": "Defense/Vote_Margin_Mean",
    "tel_margin_hist": "Defense/Vote_Margin_Hist",
    "tel_cos_honest": "Defense/Cosine_Honest_To_Agg",
    "tel_cos_corrupt": "Defense/Cosine_Corrupt_To_Agg",
    # the buffered path's per-staleness-bin split (--telemetry full): one
    # row per staleness bin
    "tel_stale_flip": "Defense/Stale_Flip_Fraction",
    "tel_stale_cos": "Defense/Stale_Cosine_To_Agg",
}


def check_level(level: str) -> str:
    if level not in LEVELS:
        raise ValueError(f"telemetry must be one of {LEVELS}, got {level!r}")
    return level


def telemetry_keys(cfg):
    """The key set cfg's round emits."""
    if cfg.telemetry == "off":
        return ()
    keys = ["tel_upd_norm_p50", "tel_upd_norm_p95", "tel_upd_norm_max"]
    if cfg.robustLR_threshold > 0:
        keys.append("tel_flip_frac")
    if cfg.telemetry == "full":
        keys += ["tel_margin_mean", "tel_margin_hist",
                 "tel_cos_honest", "tel_cos_corrupt"]
    return tuple(keys)


def tags(cfg):
    """Every Defense/* tag a boundary of cfg's run writes."""
    out = []
    for key in telemetry_keys(cfg):
        if key == "tel_margin_hist":
            out += [f"{TAGS[key]}/{i}" for i in range(N_MARGIN_BUCKETS)]
        else:
            out.append(TAGS[key])
    return tuple(out)


def _norm_percentiles(norms):
    """Nearest-rank p50/p95/max of the [m] per-agent norms."""
    m = norms.shape[0]
    srt = torch.sort(norms).values
    return {"tel_upd_norm_p50": srt[(m - 1) // 2],
            "tel_upd_norm_p95": srt[min(m - 1, round(0.95 * (m - 1)))],
            "tel_upd_norm_max": srt[m - 1]}


def _flip_fraction(lr):
    """Fraction of coordinates whose robust lr went negative."""
    neg = sum(torch.sum((leaf < 0).to(torch.float32)) for leaf in lr.values())
    total = sum(leaf.numel() for leaf in lr.values())
    return neg / total


def _bucketize_margins(s, m: int, weights=None):
    """[B] coordinate counts of the vote margins s (values in [0, m]),
    plus their sum: bucket i covers margins in [i*(m+1)/B, (i+1)*(m+1)/B).
    The counts are added with index_add_ (bincount sizes its output from
    the data, a host sync a captured round cannot make); each count is an
    integer below 2**24, exact in f32 in any order. `weights` ([len(s)]
    f32) scales each coordinate's part: the bucket layout's real-coordinate
    mask, so its zero padding (margin 0) counts nowhere."""
    flat = s.reshape(-1)
    idx = torch.clamp(torch.div(flat.to(torch.int64) * N_MARGIN_BUCKETS,
                                m + 1, rounding_mode="floor"),
                      0, N_MARGIN_BUCKETS - 1)
    ones = (torch.ones_like(flat, dtype=torch.float32) if weights is None
            else weights)
    counts = torch.zeros(N_MARGIN_BUCKETS, dtype=torch.float32,
                         device=flat.device).index_add_(0, idx, ones)
    flat = flat.to(torch.float32)
    return counts, torch.sum(flat if weights is None else flat * weights)


def _cosine_accumulators(updates, agg, m: int):
    """([m] dot(u_k, agg), [m] ||u_k||^2), accumulated leaf by leaf."""
    u0 = next(iter(updates.values()))
    dots = torch.zeros(m, dtype=torch.float32, device=u0.device)
    usq = torch.zeros_like(dots)
    for k, u in updates.items():
        uf = u.reshape(m, -1).to(torch.float32)
        af = agg[k].reshape(-1).to(torch.float32)
        dots = dots + uf @ af
        usq = usq + torch.sum(uf * uf, dim=1)
    return dots, usq


def _finish_margins(counts, margin_sum, total_coords: int, m: int):
    return {"tel_margin_hist": counts / total_coords,
            "tel_margin_mean": margin_sum / (total_coords * m)}


def _finish_cosine(dots, usq, asq, corrupt, valid):
    """Mean cosine-to-aggregate over the honest and corrupt slots of the
    `valid` electorate (zero when a group is empty)."""
    cos = dots * torch.rsqrt(usq * asq + _EPS)
    out = {}
    for key, sel in (("tel_cos_honest", valid & ~corrupt),
                     ("tel_cos_corrupt", valid & corrupt)):
        n = torch.sum(sel.to(torch.float32))
        out[key] = torch.where(
            n > 0, torch.sum(torch.where(sel, cos, 0.0))
            / torch.clamp(n, min=1.0), 0.0)
    return out


def _agg_sqnorm(agg):
    return sum(torch.sum(torch.square(a.to(torch.float32)))
               for a in agg.values())


def _split_flags(m: int, device, corrupt_full, mask_full):
    """The [m] corrupt flags and electorate of the cosine split (no flags:
    all honest; no mask: every slot)."""
    corrupt = (torch.zeros(m, dtype=torch.bool, device=device)
               if corrupt_full is None else corrupt_full)
    valid = (torch.ones(m, dtype=torch.bool, device=device)
             if mask_full is None else mask_full)
    return corrupt, valid


def compute(cfg, updates, lr, agg, mask=None, corrupt_flags=None,
            sign_sums=None, vote_range=None):
    """Telemetry dict of the dense round. `updates` are [m, ...] tensors;
    `lr` the robust-lr dict or None (RLR off); `agg` the aggregate dict;
    `mask` the [m] participation mask or None; `corrupt_flags` the [m]
    corrupt-slot flags or None (no split known). `sign_sums`, when given,
    is an accumulated sign-sum dict whose margins the vote thresholds (the
    buffered path's); `vote_range` then widens the bucketization range
    to that electorate's (default: m)."""
    m = next(iter(updates.values())).shape[0]
    vr = vote_range or m
    if mask is not None:
        updates = masking.zero_masked(updates, mask)
    out = _norm_percentiles(per_agent_norms(updates))
    if lr is not None:
        out["tel_flip_frac"] = _flip_fraction(lr)
    if cfg.telemetry != "full":
        return out
    device = out["tel_upd_norm_max"].device
    counts = torch.zeros(N_MARGIN_BUCKETS, dtype=torch.float32,
                         device=device)
    margin_sum = torch.zeros((), dtype=torch.float32, device=device)
    if sign_sums is None:
        sign_sums = {k: torch.sum(torch.sign(u.reshape(m, -1).to(
            torch.float32)), dim=0) for k, u in updates.items()}
    for s in sign_sums.values():
        c, ms = _bucketize_margins(torch.abs(s), vr)
        counts, margin_sum = counts + c, margin_sum + ms
    dots, usq = _cosine_accumulators(updates, agg, m)
    total = sum(u.numel() // m for u in updates.values())
    out.update(_finish_margins(counts, margin_sum, total, vr))
    out.update(_finish_cosine(dots, usq, _agg_sqnorm(agg),
                              *_split_flags(m, device, corrupt_flags, mask)))
    return out


def compute_sharded(cfg, updates_local, lr, agg, group, mask_local=None,
                    mask_full=None, corrupt_full=None, sign_sums=None):
    """Telemetry dict of the sharded round's leaf layout (JAX
    `compute_sharded`). `updates_local` is this rank's [m/d, ...] block,
    `lr` the replicated robust-lr dict or None (RLR off), `agg` the
    replicated aggregate dict, `mask_local`/`mask_full` the block's and
    the round's [m] participation masks, `corrupt_full` the [m]
    corrupt-slot flags, `sign_sums` the vote's all_reduced per-leaf sign
    sums (needed under ``full``). Collectives: the norms' all_gather, and
    under ``full`` the two cosine accumulators' all_gathers."""
    m = cfg.agents_per_round
    if mask_local is not None:
        updates_local = masking.zero_masked(updates_local, mask_local)
    out = _norm_percentiles(group.all_gather(per_agent_norms(updates_local)))
    if lr is not None:
        out["tel_flip_frac"] = _flip_fraction(lr)     # replicated
    if cfg.telemetry != "full":
        return out
    if sign_sums is None:
        raise ValueError("full telemetry on the sharded round reads the "
                         "vote's all_reduced sign sums")
    device = out["tel_upd_norm_max"].device
    counts = torch.zeros(N_MARGIN_BUCKETS, dtype=torch.float32,
                         device=device)
    margin_sum = torch.zeros((), dtype=torch.float32, device=device)
    for s in sign_sums.values():
        c, ms = _bucketize_margins(torch.abs(s), m)
        counts, margin_sum = counts + c, margin_sum + ms
    mb = next(iter(updates_local.values())).shape[0]
    dots_l, usq_l = _cosine_accumulators(updates_local, agg, mb)
    total = sum(u.numel() // mb for u in updates_local.values())
    out.update(_finish_margins(counts, margin_sum, total, m))
    out.update(_finish_cosine(group.all_gather(dots_l),
                              group.all_gather(usq_l), _agg_sqnorm(agg),
                              *_split_flags(m, device, corrupt_full,
                                            mask_full)))
    return out


def shard_vote_stats(cfg, sign_shard, real_mask, lr_shard, m: int):
    """The bucket layout's vote statistics of this rank's scattered
    sign-sum shard, one small f32 vector that rides the result all_gather
    (JAX `shard_vote_stats`): [real coordinates with lr < 0] when RLR is
    on, then under ``full`` [N_MARGIN_BUCKETS counts, margin sum]. Summed
    over the gathered rows they are the global values. None when nothing
    is needed."""
    stats = []
    if lr_shard is not None:
        stats.append(torch.sum(torch.where(real_mask & (lr_shard < 0),
                                           1.0, 0.0)).reshape(1))
    if cfg.telemetry == "full":
        counts, margin_sum = _bucketize_margins(
            torch.abs(sign_shard), m, weights=real_mask.to(torch.float32))
        stats += [counts, margin_sum.reshape(1)]
    return torch.cat(stats) if stats else None


def compute_sharded_bucket(cfg, updates_local, info, group, mask_local=None,
                           mask_full=None, corrupt_full=None):
    """Telemetry dict of the bucket layout (JAX `compute_sharded_bucket`):
    `info` is parallel/rounds.BucketInfo, with the summed
    `shard_vote_stats`, the real coordinate count and, under ``full``,
    the replicated aggregate dict that rode the result all_gather. The
    flip fraction and the margins come with the stats; the norms and the
    cosine accumulators cost the leaf layout's all_gathers."""
    m = cfg.agents_per_round
    if mask_local is not None:
        updates_local = masking.zero_masked(updates_local, mask_local)
    out = _norm_percentiles(group.all_gather(per_agent_norms(updates_local)))
    total = info.total_coords
    i = 0
    if cfg.robustLR_threshold > 0:
        out["tel_flip_frac"] = info.stats[0] / total
        i = 1
    if cfg.telemetry != "full":
        return out
    out.update(_finish_margins(info.stats[i:i + N_MARGIN_BUCKETS],
                               info.stats[i + N_MARGIN_BUCKETS], total, m))
    mb = next(iter(updates_local.values())).shape[0]
    dots_l, usq_l = _cosine_accumulators(updates_local, info.agg, mb)
    device = out["tel_upd_norm_max"].device
    out.update(_finish_cosine(group.all_gather(dots_l),
                              group.all_gather(usq_l),
                              _agg_sqnorm(info.agg),
                              *_split_flags(m, device, corrupt_full,
                                            mask_full)))
    return out


def host_summary(vals) -> dict:
    """JSON-able snapshot of the telemetry values in `vals` (host values):
    tel_* scalars as floats, tel_margin_hist as a float list."""
    out = {}
    for key in sorted(vals):
        if not key.startswith(PREFIX):
            continue
        v = vals[key]
        if getattr(v, "ndim", 0) or isinstance(v, (list, tuple)):
            out[key] = [float(x) for x in v]
        else:
            out[key] = float(v)
    return out


def emit_scalars(writer, vals, step: int) -> None:
    """Write every telemetry value in `vals` (host values) as Defense/*
    scalars; a vector series writes one row per bin."""
    for key in sorted(vals):
        if not key.startswith(PREFIX):
            continue
        tag = TAGS.get(key, f"Defense/{key[len(PREFIX):]}")
        v = vals[key]
        if getattr(v, "ndim", 0) or isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                writer.scalar(f"{tag}/{i}", float(x), step)
        else:
            writer.scalar(tag, float(v), step)
