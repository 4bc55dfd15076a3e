"""The RLR server kernels: the fused vote + FedAvg + apply step (K1) and
the per-rank partial vote + weighted sum of the sharded step (K2).

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
ops/pallas_rlr.py` (`_kernel`, `_fused_leaf`, `fused_rlr_avg_apply_flat`,
`fused_rlr_avg_apply`; `_partial_kernel`, `partial_vote_avg_flat`). K1, per
coordinate j over the m sampled agents' updates:

    s_j   = sum_i sign(U_ij)
    lr_j  = +server_lr if |s_j| >= threshold else -server_lr  (threshold <= 0:
            server_lr everywhere)
    agg_j = sum_i wn_i U_ij   (mode 'avg', wn = w / sum(w))
          | sign(s_j)          (mode 'sign')
    p'_j  = p_j + lr_j * agg_j

K2 gives (s_j, sum_i wn_i U_ij) over one rank's [m/d, n] block, wn already
divided by the global weight total; parallel/rounds.py all_reduces them and
applies.

Both kernels run over a list of leaves, up to MAX_LEAVES of them in one
launch (`rlr_fused_leaves`, `rlr_partial_leaves`): each leaf's [m, ...]
update stack is read in place as [m, n_leaf], and the outputs go into one
flat buffer at 16-byte aligned offsets (`packed_offsets`), each leaf's pad
lanes (fewer than ALIGN) written with zeros. One server step is one launch
for any model of up to MAX_LEAVES leaves, and one call from Python: the
binding makes the checks, the leaf table and K1's output views.
`rlr_fused` and `rlr_partial` are the one-leaf entries, one launch each,
on the same kernels.

On CUDA tensors the entries launch the hand-written kernels of `csrc/`
(built for sm_90a at the first launch, into `build/torch_ext/` at the
repository root) or raise; nothing falls back to the plain version on the
card. On CPU tensors they run `rlr_fused_reference` / `rlr_partial_reference`,
the plain PyTorch versions, leaf by leaf. `LAUNCHES` counts kernel launches
by kernel, so a run can show that its server step went through them. A
call made while a CUDA graph is being captured launches nothing: it
counts in `CAPTURED`, and each replay of that graph adds its launches to
`LAUNCHES` (utils/compile_cache.RoundGraph).

K1 moves (m + 2) * n * 4 bytes, K2 (m + h) * n * 4 for the h halves it
writes; csrc/rlr_columns.cuh says how the design keeps to that.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.aggregate import (
    rlr_from_sign_sum)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.tree import (
    Params)

MODES = ("avg", "sign")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = (CSRC / "rlr_fused_binding.cpp", CSRC / "rlr_fused.cu",
           CSRC / "rlr_partial.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a")
ALIGN = 4               # floats: the 16 bytes of a bulk copy's unit
MAX_LEAVES = 64         # leaves of one launch's table (csrc/rlr_table.h)

LAUNCHES = {"rlr_fused": 0, "rlr_partial": 0}
CAPTURED = {"rlr_fused": 0, "rlr_partial": 0}


def _launched(name: str) -> None:
    """One launch of kernel `name` on the current stream, or one captured
    into the CUDA graph that stream is capturing."""
    if torch.cuda.is_current_stream_capturing():
        CAPTURED[name] += 1
    else:
        LAUNCHES[name] += 1


@functools.cache
def build():
    """Compile and load the extension (once per process)."""
    from torch.utils.cpp_extension import load

    # load() takes a lock file in the build directory and does not create it
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return load(name="rlr_fused_ext", sources=[str(s) for s in SOURCES],
                build_directory=str(BUILD_DIR), extra_cflags=["-O3"],
                extra_cuda_cflags=list(CUDA_FLAGS))


def padded(n: int) -> int:
    """n rounded up to ALIGN floats."""
    return -(-n // ALIGN) * ALIGN


@functools.lru_cache(maxsize=64)
def packed_offsets(numels: Tuple[int, ...]) -> Tuple[Tuple[int, ...], int]:
    """Each leaf's offset in a flat buffer that holds the leaves one after
    another, each rounded up to ALIGN floats, and the buffer's length."""
    offsets, end = [], 0
    for n in numels:
        offsets.append(end)
        end += padded(n)
    return tuple(offsets), end


def leaf_chunks(n_leaves: int) -> List[Tuple[int, int]]:
    """The [lo, hi) leaf ranges of the launches over n_leaves leaves."""
    return [(lo, min(lo + MAX_LEAVES, n_leaves))
            for lo in range(0, n_leaves, MAX_LEAVES)]


def rlr_fused_reference(u: torch.Tensor, wn: torch.Tensor, p: torch.Tensor,
                        threshold: float, server_lr: float,
                        mode: str = "avg") -> torch.Tensor:
    """The plain PyTorch version of K1 on one leaf: out[n] from u[m, n],
    wn[m], p[n]."""
    if mode == "sign" or threshold > 0:
        ssum = torch.sum(torch.sign(u), dim=0)
    agg = (torch.sign(ssum) if mode == "sign"
           else torch.sum(u * wn[:, None], dim=0))
    lr = (rlr_from_sign_sum(ssum, threshold, server_lr) if threshold > 0
          else server_lr)
    return p + lr * agg


def rlr_partial_reference(u: torch.Tensor, wn: torch.Tensor):
    """The plain PyTorch version of K2 on one leaf: (sign_sum[n],
    weighted_sum[n]) from u[m, n] and wn[m]."""
    return torch.sum(torch.sign(u), dim=0), torch.sum(u * wn[:, None], dim=0)


def _check_tensors(what, *ts):
    u = ts[0]
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{what} takes float32, got {t.dtype}")
        if t.device != u.device:
            raise ValueError(f"{what}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, not {u.device}")


def _check_block(what, u, wn):
    _check_tensors(what, u, wn)
    if u.ndim != 2 or wn.shape != (u.shape[0],) or u.numel() == 0:
        raise ValueError(f"{what}: expected u[m, n], wn[m] with m, n > 0; "
                         f"got {tuple(u.shape)}, {tuple(wn.shape)}")


def put_padded(out: torch.Tensor, at: int, value: torch.Tensor) -> None:
    """out[at:at + n] = value[n], and zeros in the pad lanes after it, up to
    padded(n) floats or the buffer's end: what the kernels write."""
    n = value.numel()
    if at < 0 or at + n > out.numel():
        raise ValueError(f"an output of {n} floats at {at} runs past the "
                         f"buffer's {out.numel()}")
    out[at:at + n] = value.reshape(-1)
    out[at + n:at + padded(n)] = 0.0


def _stacks(what, us, wn):
    """The CPU path's checks: each u[m, ...] as its [m, n] view."""
    out = []
    for u in us:
        _check_tensors(what, u, wn)
        if (wn.ndim != 1 or u.ndim < 1 or u.shape[0] != wn.shape[0]
                or u.numel() == 0):
            raise ValueError(f"{what}: expected u[m, ...] and wn[m]; got "
                             f"{tuple(u.shape)}, {tuple(wn.shape)}")
        out.append(u.view(u.shape[0], -1))
    return out


def rlr_fused_leaves(us: Sequence[torch.Tensor], wn: torch.Tensor,
                     ps: Sequence[torch.Tensor], out: torch.Tensor,
                     offsets: Sequence[int], threshold: float,
                     server_lr: float, mode: str = "avg") -> List[torch.Tensor]:
    """K1 over a list of leaves into the flat buffer `out`: leaf i's update
    stack us[i] [m, ...], params ps[i] (n values), normalized weights
    wn[m]; out[offsets[i]:][:n] = p + lr * agg, zeros in the pad lanes.
    Returns each leaf's new params as a view of out in its params' shape.
    One launch per MAX_LEAVES leaves."""
    if mode not in MODES:
        raise ValueError(f"unsupported mode {mode!r}")
    if wn.device.type == "cpu":
        views = []
        for u, p, at in zip(_stacks("rlr_fused", us, wn), ps, offsets,
                            strict=True):
            _check_tensors("rlr_fused", u, p, out)
            if p.numel() != u.shape[1]:
                raise ValueError(f"rlr_fused: p has {p.numel()} values, u's "
                                 f"rows {u.shape[1]}")
            put_padded(out, at, rlr_fused_reference(
                u, wn, p.view(-1), threshold, server_lr, mode))
            views.append(out[at:at + p.numel()].view(p.shape))
        return views
    ext = build()
    views = []
    for lo, hi in leaf_chunks(len(us)):
        views += ext.rlr_fused(us[lo:hi], wn, ps[lo:hi], out, offsets[lo:hi],
                               float(threshold), float(server_lr),
                               threshold > 0, mode == "sign")
        _launched("rlr_fused")
    return views


def rlr_partial_leaves(us: Sequence[torch.Tensor], wn: torch.Tensor,
                       out: torch.Tensor, offsets: Sequence[int],
                       sign_at: Optional[int], wsum_at: Optional[int]) -> None:
    """K2 over a list of leaves into the flat buffer `out`: over leaf i's
    update block us[i] [m, ...] with weights wn[m], the sign sums at
    out[sign_at + offsets[i]:][:n] and the weighted sums at
    out[wsum_at + offsets[i]:][:n], zeros in the pad lanes. A None `_at` is
    a half that is not written. One launch per MAX_LEAVES leaves."""
    if sign_at is None and wsum_at is None:
        raise ValueError("rlr_partial: nothing to write")
    if wn.device.type == "cpu":
        for u, at in zip(_stacks("rlr_partial", us, wn), offsets,
                         strict=True):
            _check_tensors("rlr_partial", u, out)
            s, w = rlr_partial_reference(u, wn)
            if sign_at is not None:
                put_padded(out, sign_at + at, s)
            if wsum_at is not None:
                put_padded(out, wsum_at + at, w)
        return
    ext = build()
    for lo, hi in leaf_chunks(len(us)):
        ext.rlr_partial(us[lo:hi], wn, out, offsets[lo:hi],
                        -1 if sign_at is None else sign_at,
                        -1 if wsum_at is None else wsum_at)
        _launched("rlr_partial")


def rlr_fused(u: torch.Tensor, wn: torch.Tensor, p: torch.Tensor,
              threshold: float, server_lr: float,
              mode: str = "avg") -> torch.Tensor:
    """One leaf of the server step (a one-row table, one launch): out[n]
    from u[m, n], normalized weights wn[m] and params p[n], all float32 and
    contiguous."""
    if mode not in MODES:
        raise ValueError(f"unsupported mode {mode!r}")
    _check_block("rlr_fused", u, wn)
    _check_tensors("rlr_fused", u, p)
    if p.shape != (u.shape[1],):
        raise ValueError(f"rlr_fused: expected p[{u.shape[1]}], got "
                         f"{tuple(p.shape)}")
    (out,) = rlr_fused_leaves([u], wn, [p], torch.empty_like(p), [0],
                              threshold, server_lr, mode)
    return out


def _normalized(weights: torch.Tensor) -> torch.Tensor:
    w = weights.to(torch.float32)
    return w / torch.sum(w)


def fused_rlr_avg_apply_flat(params_flat, updates_flat, weights,
                             threshold: float, server_lr: float,
                             mode: str = "avg"):
    """params' [n] from params [n], updates [m, n] and weights [m] (need not
    be normalized). threshold <= 0 turns the RLR vote off; mode 'avg' is
    weighted FedAvg (reference src/aggregation.py:57-64), 'sign' the signSGD
    majority vote (src/aggregation.py:71-75; weights unused)."""
    return rlr_fused(updates_flat, _normalized(weights), params_flat,
                     threshold, server_lr, mode)


def fused_rlr_avg_apply(params: Params, stacked_updates: Params, weights,
                        threshold: float, server_lr: float,
                        mode: str = "avg") -> Params:
    """Param-dict server step in one launch: every leaf's [m, ...] update
    stack read as an [m, n_leaf] view (no copy), the new params written
    into one flat buffer at 16-byte aligned offsets and returned as views
    of it."""
    ps = list(params.values())
    offsets, width = packed_offsets(tuple(p.numel() for p in ps))
    flat = torch.empty(width, dtype=torch.float32, device=ps[0].device)
    views = rlr_fused_leaves([stacked_updates[k] for k in params],
                             _normalized(weights), ps, flat, offsets,
                             threshold, server_lr, mode)
    return dict(zip(params, views, strict=True))


def rlr_partial(u: torch.Tensor, wn: torch.Tensor):
    """K2 on one leaf of one rank's block (a one-row table, one launch):
    (sign_sum[n], weighted_sum[n]) from u[m_local, n] and wn[m_local],
    float32 and contiguous."""
    _check_block("rlr_partial", u, wn)
    n = u.shape[1]
    out = torch.empty(padded(n) + n, dtype=u.dtype, device=u.device)
    rlr_partial_leaves([u], wn, out, [0], sign_at=0, wsum_at=padded(n))
    return out[:n], out[padded(n):]


def partial_vote_avg_flat(updates_flat, weights_normalized):
    """Per-rank partials of the sharded fused server step (JAX
    `partial_vote_avg_flat`): one pass over the local [m_local, n] update
    block, giving (sign_sum[n], weighted_sum[n]). `weights_normalized` is
    [m_local], already divided by the GLOBAL weight total, so the
    all_reduce of weighted_sum is the global FedAvg."""
    return rlr_partial(updates_flat,
                       weights_normalized.to(torch.float32).contiguous())
