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

`rlr_fused` runs one leaf. On a CUDA tensor it launches the hand-written
kernel in `csrc/rlr_fused.cu` (built for sm_90a at the first launch, into
`build/torch_ext/` at the repository root) or raises; on a CPU tensor it
runs `rlr_fused_reference`, the plain PyTorch version of the same function.
A failed build or launch raises: nothing falls back to the plain version on
the card. `LAUNCHES["rlr_fused"]` counts kernel launches, so a run can show
that its server step went through the kernel.

The kernel reads each leaf's update stack in place, as an [m, n_leaf] view
of the [m, ...] stack, and writes only the new parameters; it is bound by
the (m + 2) * n * 4 bytes it moves (csrc/rlr_fused.cu says how).

K2, `rlr_partial` (public name `partial_vote_avg_flat`, as in JAX), runs one
rank's [m/d, n_leaf] block of the sharded round and returns
(sign_sum[n], weighted_sum[n]) with wn already divided by the global weight
total; parallel/rounds.py all_reduces both and applies. On a CUDA tensor it
launches `csrc/rlr_partial.cu` (same build as K1) or raises; on a CPU tensor
it runs `rlr_partial_reference`. `LAUNCHES["rlr_partial"]` counts its
launches. It moves (m/d + 2) * n * 4 bytes.
"""

from __future__ import annotations

import functools
from pathlib import Path

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

LAUNCHES = {"rlr_fused": 0, "rlr_partial": 0}


@functools.cache
def build():
    """Compile and load the extension (once per process)."""
    from torch.utils.cpp_extension import load

    # load() takes a lock file in the build directory and does not create it
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return load(name="rlr_fused_ext", sources=[str(s) for s in SOURCES],
                build_directory=str(BUILD_DIR), extra_cflags=["-O3"],
                extra_cuda_cflags=list(CUDA_FLAGS))


def rlr_fused_reference(u: torch.Tensor, wn: torch.Tensor, p: torch.Tensor,
                        threshold: float, server_lr: float,
                        mode: str = "avg") -> torch.Tensor:
    """The plain PyTorch version of the kernel: out[n] from u[m, n], wn[m],
    p[n]."""
    if mode == "sign" or threshold > 0:
        ssum = torch.sum(torch.sign(u), dim=0)
    agg = (torch.sign(ssum) if mode == "sign"
           else torch.sum(u * wn[:, None], dim=0))
    lr = (rlr_from_sign_sum(ssum, threshold, server_lr) if threshold > 0
          else server_lr)
    return p + lr * agg


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


def _check(u, wn, p, mode):
    if mode not in MODES:
        raise ValueError(f"unsupported mode {mode!r}")
    _check_tensors("rlr_fused", u, wn, p)
    if (u.ndim != 2 or wn.shape != (u.shape[0],) or p.shape != (u.shape[1],)
            or u.numel() == 0):
        raise ValueError(f"rlr_fused: expected u[m, n], wn[m], p[n] with "
                         f"m, n > 0; got {tuple(u.shape)}, "
                         f"{tuple(wn.shape)}, {tuple(p.shape)}")


def rlr_fused(u: torch.Tensor, wn: torch.Tensor, p: torch.Tensor,
              threshold: float, server_lr: float,
              mode: str = "avg") -> torch.Tensor:
    """One leaf of the server step: out[n] from u[m, n], normalized
    weights wn[m] and params p[n], all float32 and contiguous."""
    _check(u, wn, p, mode)
    if u.device.type == "cpu":
        return rlr_fused_reference(u, wn, p, threshold, server_lr, mode)
    out = build().rlr_fused(u, wn, p, float(threshold), float(server_lr),
                            threshold > 0, mode == "sign")
    LAUNCHES["rlr_fused"] += 1
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
    """Param-dict server step: one launch per leaf, each reading the leaf's
    [m, ...] update stack as an [m, n_leaf] view (no copy)."""
    wn = _normalized(weights)
    out = {}
    for k, p in params.items():
        u = stacked_updates[k]
        out[k] = rlr_fused(u.view(u.shape[0], -1), wn, p.view(-1), threshold,
                           server_lr, mode).view(p.shape)
    return out


def rlr_partial_reference(u: torch.Tensor, wn: torch.Tensor):
    """The plain PyTorch version of K2: (sign_sum[n], weighted_sum[n]) from
    u[m, n] and wn[m]."""
    return torch.sum(torch.sign(u), dim=0), torch.sum(u * wn[:, None], dim=0)


def rlr_partial(u: torch.Tensor, wn: torch.Tensor):
    """K2 on one leaf of one rank's block: u[m_local, n] and wn[m_local],
    float32 and contiguous."""
    _check_tensors("rlr_partial", u, wn)
    if u.ndim != 2 or wn.shape != (u.shape[0],) or u.numel() == 0:
        raise ValueError(f"rlr_partial: expected u[m, n], wn[m] with "
                         f"m, n > 0; got {tuple(u.shape)}, {tuple(wn.shape)}")
    if u.device.type == "cpu":
        return rlr_partial_reference(u, wn)
    sign_sum, weighted_sum = build().rlr_partial(u, wn)
    LAUNCHES["rlr_partial"] += 1
    return sign_sum, weighted_sum


def partial_vote_avg_flat(updates_flat, weights_normalized):
    """Per-rank partials of the sharded fused server step (JAX
    `partial_vote_avg_flat`): one pass over the local [m_local, n] update
    block, giving (sign_sum[n], weighted_sum[n]). `weights_normalized` is
    [m_local], already divided by the GLOBAL weight total, so the
    all_reduce of weighted_sum is the global FedAvg."""
    return rlr_partial(updates_flat,
                       weights_normalized.to(torch.float32).contiguous())
