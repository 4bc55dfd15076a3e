"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (`defending_against_backdoors_with_robust_learning_rate_tpu_torch`,
never the JAX package) through nineteen phases and exits non-zero if any
fails (`--phases a,b` runs the build and just those phases, a rehearsal
that prints no result lines):

1. build: prints the card's name and power limit (nvidia-smi) and builds
   every hand-written kernel (K1 and K2, one build) from the checkout's
   sources, timing the build.
2. kernels: holds K1 against its plain PyTorch version on the card: the
   one-leaf entry at the test_pallas shapes and every CNN_MNIST leaf, and
   the one-launch entry over leaf tables (every CNN_MNIST leaf at once,
   odd widths, one row, 200 rows, leaves off 16 bytes, 70 leaves in two
   launches), sign exact, values within 1e-5, pad lanes zero. Then times
   one round's launch over every leaf, between CUDA events (median over
   50 launches after warm-up, L2 flushed before each, as the round finds
   the updates) and as device time (torch.profiler), and the Dense_0 leaf
   alone, beside the least time the card needs for the bytes the kernel
   must move and the plain version's time.
3. k2: the same for K2 (the sharded round's per-rank partials) at every
   CNN_MNIST leaf with m/d = 2 and 5 and the same tables, writing both
   halves of the packed buffer or one, timed at m/d = 2 with the nearest
   composite of PyTorch calls beside it.
4. batched: one attack + RLR round's local training at full width (m = 10,
   bs 256, 6,000 samples an agent, 28x28): the same slot draws through the
   per-agent oracle (fl/client.make_local_train) and through the batched
   trainer in the vmap layout, the megabatch layout and the vmap layout in
   chunks of 5, each agent's update held to the oracle's in relative L2 and
   in max-abs against the update's scale: after a short round of 4 steps
   (TRAIN_TOL) and after the full round's 48 (ROUND_TOL, beside the
   oracle's own spread when its start point moves by one ulp). Then the
   captured round's replay against the same round run eagerly, with cuDNN
   as the main path runs it and deterministic (held to 1e-5); and one
   batched step against m sequential steps for each layout, eager and as
   a CUDA graph.
5. main path: the FMNIST triple at full width (CNN_MNIST, K=10 agents all
   sampled, 2 local epochs of bs 256, FedAvg; clean, then 1 corrupt agent
   poisoning half its base-class samples, then that attack with RLR
   threshold 4) for a few rounds each through `train.run`, on synthetic
   data at FMNIST's scale when no FMNIST is on disk, TF32 off; then the
   triple again with `--chain 2`. Each round is a replay of the run's
   captured CUDA graph after the first. The kernel launch counts and the
   graph replays are set to 0 just before and read just after: K1 must
   launch exactly once a round (the first round's eager launch, then one
   in each replay) and every round after the first must be a replay.
6. server parity: for one round's real updates, K1's new params vs the
   plain server step's (ops/aggregate.py).
7. profile: one replayed attack + RLR round timed unprofiled, then under
   torch.profiler: its kernels, the card's busy time and idle share, K1's
   one launch, and the kernels that take the most.
8. sharded: the attack + RLR run through `train.run` on d = 5 ranks of 2
   agents each (what pick_agent_mesh_size gives m = 10 on 8 cards), as
   spawned processes sharing cuda:0 over gloo (NCCL takes one rank per
   card), cuDNN deterministic and TF32 off; each rank trains its block as
   one batched program, eagerly. Each rank's counts are set to 0 just
   before its run and read just after: every rank must launch K2 once a
   round and make the plan's 3 all_reduces a round (the loss, the weight
   total, one packed buffer). Then rounds/s and one profiled rank's idle
   share; round 1 from the seed against the dense round trained in chunks
   of a rank's block; one round's updates through the sharded server
   step against K1 on the whole stack; and one signflip round on each
   rank (K2 once, the same 3 all_reduces) with K2 held to its plain
   version on the rank's scaled block. Then the sharded server surface
   on each rank's saved round-1 block (no more training): comed, trmean,
   krum and rfa over the all_to_all transpose, avg + RLR 4 with --noise
   0.001, avg and sign + RLR 4 on the bucket layout, avg + RLR 4 under a
   fixed fault draw (two dropped, a payload cap that rejects the two
   largest updates) with --quarantine 0, and --telemetry full on both
   layouts, each against the dense plain server step
   (fl/rounds.server_path) on the concatenated stack (sign, comed,
   krum, the masks and the Faults/* values exact; avg, trmean, rfa and
   the noise within TOL; the Defense/* values within 1e-5 relative),
   each rank's collectives kind by kind equal to the plan
   (parallel/multihost.plan_collectives); and one 2-round run through
   train.run on the ranks under --agg_layout bucket --telemetry full
   --dropout_rate 0.2 --quarantine 0 (K1 and K2 0 launches, the plan's
   collectives twice, finite rows, its rounds/s), with each rank's host
   time inside the collectives, by kind.
9. nccl d=1: one sharded round at d = 1 over NCCL in a process of its
   own, configured by the flags a multi-card launch passes.
10. cifar10: the paper's CIFAR-10 DBA triple (reference src/runner.sh:
    23-28: 40 agents all sampled, 2 local epochs at bs 256; 4 corrupt
    agents poisoning half their base-class samples, each with its own
    quarter of the plus trigger; RLR threshold 8) through `train.run` with
    CNN_CIFAR for 2 rounds each, then the attack + RLR run on ResNet-9
    for 2 rounds at --agent_chunk 1, on synthetic data at CIFAR-10's scale
    (50,000 / 10,000 at 32x32x3). Each run's counts are set to 0 just
    before it and read just after: K1 once a round, every round after the
    first a graph replay; each run's peak device memory. Then K1 against
    its plain version on one round's real updates of each model at m = 40.
11. fedemnist: the Fed-EMNIST triple (src/runner.sh:34-38: 3,383 users,
    1% a round, m = 33, 10 local epochs at bs 64, 338 corrupt, threshold
    8) on the synthetic per-user shards, 3 rounds each, device-resident
    (what --host_sampled auto picks for 679 MB of stacks) and then
    host-sampled with --host_prefetch 2, counted as above; the host round
    against the device-resident round on the same ids and slot draws,
    eager and captured; wall per round without eval in each mode, and one
    replayed round of each under torch.profiler (idle share, K1 once).
12. k1 shapes: K1 at the shapes of phases 10-11 (ResNet-9 and CNN_CIFAR at
    m = 40, CNN_MNIST at m = 33) against its plain version, timed between
    CUDA events and as device time beside its byte bound and the plain
    version's time.
13. rules: the robust server rules and the fault model. The FMNIST attack
    + RLR run (threshold 4) for 2 rounds under each of comed, trmean, krum
    and rfa, and under avg and comed with the fault regime of
    scripts/sweep_faults.py (dropout 0.3, scaled threshold, attackers
    spared, stragglers 0.2 at 1 epoch, NaN payloads 0.1), comed also with
    --chain 2 (4 rounds), and under comed with --quarantine 0,3 (the
    corrupt agent 0 and one honest agent out of every vote); the
    Fed-EMNIST attack + RLR run host-sampled under comed with the fault
    regime (3 rounds); then
    BASELINE.json config 4 (CIFAR-10 ResNet-9, K = 256 agents all sampled,
    2 local epochs at bs 256, config 3's attack, RLR threshold 8,
    --agent_chunk 1) for 2 rounds under comed and under krum; each through
    `train.run` with its counts set to 0 just before and read just after:
    K1 never launches (the plain server step), every round after the
    first is a replay; the faults runs' Faults/* rows (Effective_Voters <=
    m). The replayed round against the eager round for comed, for the
    comed faults round and for the comed quarantine round (cuDNN
    deterministic, bit for bit). On one round's
    real updates at m = 10 (CNN_MNIST) and m = 256 (ResNet-9): each masked
    rule under an all-ones mask against its dense rule, bit for bit; the
    rules on the card against the same rules on a CPU copy (all six at
    m = 10, comed and krum at m = 256; selections exact, sums 1e-6, rfa
    1e-5 relative L2); each rule's server step between CUDA events, and
    comed's sort alone; config 4's seconds a round and its peak device
    memory.
14. attack: the adversary surface, each run through `train.run` with its
    counts read as above. The FMNIST attack + RLR run (threshold 4, the
    eager warm-up and three replays) under --attack
    boost --attack_boost 8, under --attack signflip --poison_frac 0 and
    under the one-shot boost x8 of round 2: K1 once a round; each
    replayed round against the eager round from the same params and
    draws (cuDNN deterministic, bit for bit); the one-shot rounds 1 and 3
    equal to the static round on the same draws, round 2 not; K1 against
    its plain version on each run's scaled stack, timed beside its bound;
    the boost x8 and signflip runs carry the reputation lanes (on by
    default under RLR) and hold JAX's suspicion drill at their last
    boundary (tests/test_reputation.py:415-427): the corrupt agent first
    in the ranking and Reputation/Suspicion_AUC >= 0.9; each run's folded
    rows are written to build/chip_smoke/logs_attack/rep_rows.json.
    CIFAR-10 --attack dba on CNN_CIFAR (m = 40, 2 rounds, K1 once a round;
    the corrupt agents' poisoned rows carry their round-robin shards of
    the plus), Fed-EMNIST host-sampled under signflip (m = 33, 2 rounds),
    K1 on each one's scaled stack. FMNIST signflip with --telemetry full
    (2 rounds): K1 never, every Defense/* row written and finite.
15. acceptance: JAX's acceptance pair (tests/test_attack.py:216-231,
    synthetic, 8 agents, 2 corrupt, boost x8, 10 rounds, seed 1) through
    `train.run` with cuDNN deterministic: through plain FedAvg poison
    accuracy must reach >= 0.8 at the round-5 boundary, and under RLR 4
    stay <= 0.1 at round 10; FedAvg's round-10 value is printed beside
    JAX's bound of >= 0.8 there, which the JAX package itself does not
    reach at this seed.
16. state: checkpoint and resume, the reputation lanes and the
    diagnostics, on the FMNIST attack + RLR 4 run at full width (cuDNN
    deterministic), each run counted as above: 4 rounds at --chain 2
    --snap 2 against 2 rounds and a --resume to 4
    (final params bit for bit; every metrics row from round 3 on, apart
    from _run/start and Throughput/*, the same; K1 once a round in both
    lives; Reputation/* rows written); the 4 rounds under --reputation
    off (the same params and training rows, no Reputation/* row); one
    round's rep_agree / rep_norm on the card against the CPU (agreement
    exact, norms within 1e-6 relative), timed; --diagnostics for 2 rounds
    at snap 2 (K1 in round 1, not in round 2: the snap round's plain
    server step; finite Norms/* and Sign/* rows); the Fisher on the card
    against the CPU for the same params (FISHER_TOL), timed; one
    checkpoint save, timed.
17. population: the population axis on the FMNIST stand-in at full
    width (60,000 / 10,000 at 28x28x1, CNN_MNIST, bs 256, 2 local
    epochs), cuDNN deterministic, each run counted as above: the
    README's 1M-client dirichlet(0.5) bank built serially and with 2
    spawned workers (content_sha equal), reopened with --bank_verify,
    its build seconds, bytes and one 256-client gather's time; the
    README run (1M clients, 256-client cohorts, --agent_chunk 64) for 4
    rounds at --chain 2 and at --chain 1 (params bit for bit, one
    captured graph each, K1 never: the cohort round carries its active
    mask); the same at 100k clients (peak device memory within 1% of the
    1M run's); churn 0.1 with diurnal traffic at 1M (the 3-chunk draw,
    every member present, Churn/Sampled_Away the shortfall, rows
    finite); an attack at 1M (10,000 corrupt, RLR 8, full telemetry: the
    cosine split follows the active corrupt members, the tracker in
    sketch mode; with dropout 1.0 sparing the attackers the electorate
    is exactly them); the equal cohort (K = m = 10, label_shards: bank
    rows == dense rows, 2 cohort rounds == the dense round on the same
    ids, bit for bit); the chained host round (Fed-EMNIST host-sampled,
    4 rounds at --chain 2 == --chain 1 bit for bit, K1 once a round).
18. precision: the compute dtype, ResNet-9's remat, the metrics drain
    and the native host runtime on BASELINE.json config 3 at full width
    (CIFAR-10 DBA, 40 agents, 4 corrupt, RLR 8, ResNet-9), each run
    counted as above: 2 rounds each of --remat --agent_chunk 10 (JAX's
    ResNet-9 rows), --remat_policy conv and --dtype bf16 (K1 once a
    round, inside the replay); 4 rounds of the FMNIST attack + RLR 4 run
    at --dtype bf16 with the drain and with --sync_metrics (cuDNN
    deterministic: metrics.jsonl the same apart from its wall-clock
    rows); K1 against its plain version on the bf16 round's f32 updates
    (m = 40); one batched ResNet-9 step at m = 10 with block remat, conv
    remat and none (cuDNN deterministic, grads bit for bit), with its
    time and peak memory and one agent's forward stash and backward
    peak, and at m = 40 with and without remat; each
    model's bf16 step against its f32 step; the native library built
    from native/fl_host.cc on the card's host, its partition and pack
    of the FMNIST stand-in equal to the numpy twins', timed.
19. buffered: buffered-async aggregation (--agg_mode buffered) on the
    FMNIST attack + RLR 4 run at full width and on the population
    configuration (100k clients, 256-client cohorts), cuDNN
    deterministic, each run counted as above (K1 0 launches: the buffer
    holds the updates until its commit): 4 ticks of the captured round
    (straggler 0.3, K = m, exponent 0.5) against the same ticks run
    eagerly, params, buffer and info bit for bit across a commit and
    pending arrivals; K = m, no stragglers, exponent 0: 2 ticks equal to
    the sync plain step bit for bit for sign, 1 within 1e-6 for avg; the
    dense run (straggler 0.3, K = 2m) cut at tick 2 with arrivals held
    and none committed, resumed at --chain 1 through a commit == straight
    at --chain 2 (params, buffer, rows from round 3); the population run at --chain 2 == --chain 1, its ticks/s and
    peak device memory; JAX bench.py's --agg_mode both A/B (ticks/s of
    the captured round, sync against buffered at K = m, and at
    straggler 0.3 and 0.5 with K = m/2); one fold's time at m = 10 and
    256.

The last two lines of standard output are one JSON object per kernel
(`{"kernels": [...]}`; K1's `launches` counts every main-path run of
phases 5, 10, 11, 13, 14, 15, 16, 17, 18 and 19, by path in
`launches_by_path` (phase 13's paths, phase 17's `population` and phase
19's `buffered` at 0: their server step is the plain one or the buffered
fold; phase 17's `chain host` once a round), `shapes`
holds phase 12's timings and `attack_stacks` phase 14's; K2's counts the
sharded run's and the signflip round's, and the bucket run's at 0) and
`{"ok": true, "device":
{...}}`. Without a CUDA device it exits with 1 before printing any
result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

PKG = "defending_against_backdoors_with_robust_learning_rate_tpu_torch"
DEVICE = "cuda"
ROUNDS = 4
M = 10                      # agents per round on the main path
TOL = 1e-5                  # avg mode: f32 sums in another order
# batched trainer vs the per-agent oracle, per agent: relative L2 of the
# update difference, and its max-abs over the update's max-abs. A short
# round of 4 steps: f32 with TF32 off, grouped against single convolutions
# and stacked against one-agent reductions summing in other orders. The
# whole round: its 48 steps of SGD amplify any such difference as they
# amplify a one-ulp move of the start point (printed beside it; 6.2e-2
# relative L2 on the H100), so that check only catches a gross fault.
TRAIN_TOL = (1e-4, 1e-3)
ROUND_TOL = (0.25, 0.25)
SHARDED_RANKS = 5           # pick_agent_mesh_size(8, 10, 8): 2 agents each
SHARDED_ROUNDS = 3
SHARDED_DIR = "build/chip_smoke/sharded"
# device memory rate by card name (NVIDIA data sheets); FP32 rate outside
# the tensor cores
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12,
                   "H100": 3.35e12}
FP32_FLOPS = 67e12
# the kernels' names in a profile: rlr::rlr_columns_kernel<...Epilogue>
K1_KERNEL = "FusedEpilogue"
K2_KERNEL = "PartialEpilogue"
# profiled windows in which the profiler may miss a kernel before that fails
PROFILE_TRIES = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S.items():
        if key in name:
            return rate
    raise ValueError(f"no memory rate on record for {name!r}")


def time_ms(fn, flush, reps: int = 50, warmup: int = 5) -> float:
    """Median time of fn() between CUDA events over `reps` runs, L2 flushed
    before each (the host's time to issue the launches is inside)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, flush, kernel: str, reps: int = 20):
    """Device time per call of fn() of the kernels whose name holds
    `kernel`, from torch.profiler, L2 flushed before each call; and their
    launches per call. The profiler can drop a window's device events
    (CUPTI's buffers), so a window in which it sees no such kernel is
    profiled again, up to PROFILE_TRIES windows in all; none seeing it
    fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for window in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush()
                fn()
            torch.cuda.synchronize()
        on_card = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        mine = [e for e in on_card if kernel in e.name]
        if mine:
            break
        log(f"[profiler] window {window} of {PROFILE_TRIES} saw no {kernel} "
            f"kernel ({len(on_card)} device events in all, {reps} calls)")
    else:
        raise AssertionError(f"the profiler saw no {kernel} kernel in "
                             f"{PROFILE_TRIES} windows")
    return (sum(e.time_range.elapsed_us() for e in mine) / 1e3 / reps,
            len(mine) / reps)


def phase_build(rlr_fused) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
        f"device(s)")
    t0 = time.perf_counter()
    rlr_fused.build()
    log(f"[build] rlr_fused ({', '.join(s.name for s in rlr_fused.SOURCES)}; "
        f"{' '.join(rlr_fused.CUDA_FLAGS)}) in "
        f"{time.perf_counter() - t0:.1f} s")


def leaf_shapes():
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
        registry)
    model = registry.get_model("fmnist", (28, 28, 1))
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def leaf_tables(m_main: int):
    """(label, m, [n per leaf], unaligned) of the multi-leaf cases: every
    CNN_MNIST leaf as one table at the main path's m, odd widths, one row,
    200 rows (several stages a tile), leaves off 16 bytes (no bulk copy
    possible), and 70 leaves (two launches)."""
    cnn = [math.prod(s) for s in leaf_shapes().values()]
    gen = torch.Generator().manual_seed(8)
    many = [int(n) for n in torch.randint(1, 3000, (70,), generator=gen)]
    return [(f"CNN_MNIST m={m_main}", m_main, cnn, False),
            ("odd widths m=7", 7, [1, 2, 3, 5, 10, 1023, 4097, 300], False),
            ("m=1", 1, [12, 7, 5000], False),
            ("m=200", 200, [5000, 10, 4096], False),
            ("off 16 bytes m=10", 10, [4096, 10, 1280], True),
            ("70 leaves m=3", 3, many, False)]


def table_tensors(gen, m, sizes, unaligned):
    """Update stacks and params of one table on the card; with
    `unaligned`, each starts 4 bytes past a 16-byte boundary."""
    def make(*shape):
        n = math.prod(shape)
        flat = torch.randn(n + 1, generator=gen, device=DEVICE)
        return (flat[1:] if unaligned else flat[:n]).view(shape)
    us = [make(m, n) for n in sizes]
    us[0][0, :5] = 0.0                      # sign(0) votes for no side
    return us, [make(n) for n in sizes]


def check_pads(rlr_fused, flat, at, offsets, sizes, what) -> None:
    for o, n in zip(offsets, sizes):
        if not bool((flat[at + o + n:at + o + rlr_fused.padded(n)] == 0).all()):
            raise AssertionError(f"{what}: pad lanes not zero")


def check_launches(rlr_fused, name, before, n_leaves, what) -> None:
    want = len(rlr_fused.leaf_chunks(n_leaves))
    if rlr_fused.LAUNCHES[name] - before != want:
        raise AssertionError(f"{what}: {rlr_fused.LAUNCHES[name] - before} "
                             f"launches of {name}, expected {want}")


def phase_kernels(rlr_fused, record) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    err = 0.0
    # one-leaf entry (a one-row table): the test_pallas shapes and every
    # CNN_MNIST leaf, one launch each
    cases = [(4, 300, 3.0), (10, 5000, 4.0), (7, 1111, 0.0)] + [
        (M, math.prod(s), 4.0) for s in leaf_shapes().values()]
    for m, n, thr in cases:
        u = torch.randn(m, n, generator=gen, device=dev)
        w = torch.rand(m, generator=gen, device=dev) * 4 + 1
        p = torch.randn(n, generator=gen, device=dev)
        wn = w / w.sum()
        for mode in ("avg", "sign"):
            before = rlr_fused.LAUNCHES["rlr_fused"]
            got = rlr_fused.rlr_fused(u, wn, p, thr, 0.5, mode)
            want = rlr_fused.rlr_fused_reference(u, wn, p, thr, 0.5, mode)
            torch.cuda.synchronize()
            check_launches(rlr_fused, "rlr_fused", before, 1, "one leaf")
            if mode == "sign":
                # p + (+-lr) * (+-1 | 0): the vote must agree exactly
                torch.testing.assert_close(got, want, atol=0, rtol=0)
            else:
                torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
            err = max(err, float((got - want).abs().max()))
    # the multi-leaf entry, one launch per 64 leaves
    tables = leaf_tables(M)
    for label, m, sizes, unaligned in tables:
        us, ps = table_tensors(gen, m, sizes, unaligned)
        w = torch.rand(m, generator=gen, device=dev) + 1
        wn = w / w.sum()
        offsets, total = rlr_fused.packed_offsets(tuple(sizes))
        for mode, thr in (("avg", 4.0), ("avg", 0.0), ("sign", 2.0)):
            flat = torch.full((total,), float("nan"), device=dev)
            before = rlr_fused.LAUNCHES["rlr_fused"]
            views = rlr_fused.rlr_fused_leaves(us, wn, ps, flat, offsets, thr,
                                               0.5, mode)
            torch.cuda.synchronize()
            check_launches(rlr_fused, "rlr_fused", before, len(sizes), label)
            for u, p, got in zip(us, ps, views, strict=True):
                want = rlr_fused.rlr_fused_reference(u, wn, p, thr, 0.5, mode)
                if mode == "sign":
                    torch.testing.assert_close(got, want, atol=0, rtol=0)
                else:
                    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
                err = max(err, float((got - want).abs().max()))
            check_pads(rlr_fused, flat, 0, offsets, sizes, label)
    log(f"[k1] {2 * len(cases)} one-leaf cases (test_pallas shapes + every "
        f"CNN_MNIST leaf at m={M}; avg and sign) and {3 * len(tables)} "
        f"multi-leaf tables ({'; '.join(t[0] for t in tables)}; avg+RLR4, "
        f"avg, sign+RLR2): max |kernel - plain| = {err:.3e} (sign exact, avg "
        f"within {TOL}), pad lanes zero")

    # one round's server step at the main path's shapes: one launch
    name = torch.cuda.get_device_name(0)
    rate = hbm_rate(name)
    shapes = leaf_shapes()
    params = {k: torch.randn(s, generator=gen, device=dev)
              for k, s in shapes.items()}
    ups = {k: torch.randn((M,) + s, generator=gen, device=dev) * 1e-2
           for k, s in shapes.items()}
    sizes = torch.full((M,), 6000.0, device=dev)
    wn = sizes / sizes.sum()
    scratch = torch.empty(64 * 2 ** 20, device=dev)     # 256 MB > L2

    def flush():
        scratch.zero_()

    def kernel_step():
        return rlr_fused.fused_rlr_avg_apply(params, ups, sizes, 4.0, 1.0)

    def plain_step():
        return {k: rlr_fused.rlr_fused_reference(
            ups[k].view(M, -1), wn, params[k].view(-1), 4.0, 1.0)
            for k in params}

    n_all = sum(math.prod(s) for s in shapes.values())
    total_bytes = 4 * (M * n_all + M + 2 * n_all)
    total_ops = 4 * M * n_all
    k_ms = time_ms(kernel_step, flush)
    dev_ms, per_call = device_ms(kernel_step, flush, K1_KERNEL)
    clean_ms, _ = device_ms(kernel_step, lambda: scratch.sum(), K1_KERNEL)
    p_ms = time_ms(plain_step, flush)
    bound_ms = max(total_bytes / rate, total_ops / FP32_FLOPS) * 1e3
    bound_by = ("bytes" if total_bytes / rate >= total_ops / FP32_FLOPS
                else "operations")
    # Dense_0.weight alone, the one large leaf (a one-row table)
    d_u, d_p = ups["Dense_0.weight"].view(M, -1), params["Dense_0.weight"].view(-1)
    d_n = d_p.numel()
    d_ms = time_ms(lambda: rlr_fused.rlr_fused(d_u, wn, d_p, 4.0, 1.0), flush)
    d_dev, _ = device_ms(lambda: rlr_fused.rlr_fused(d_u, wn, d_p, 4.0, 1.0),
                         flush, K1_KERNEL)
    d_bound = 4 * (M * d_n + M + 2 * d_n) / rate * 1e3
    log(f"[k1-time] per round (m={M}, avg, thr 4, {len(shapes)} leaves, L2 "
        f"flushed; {name}, {rate / 1e12:.2f} TB/s): {per_call:.0f} "
        f"launch(es), between CUDA events {k_ms:.4f} ms, device time "
        f"{dev_ms:.4f} ms (profiler), plain {p_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}, {total_bytes / 1e6:.1f} MB; device "
        f"time at {bound_ms / dev_ms:.0%} of it); no single PyTorch call "
        f"computes K1, and the plain version is the nearest composite")
    log(f"[k1-time] the same launch after a flush that only reads the L2 "
        f"(no dirty line to write back during the kernel): device time "
        f"{clean_ms:.4f} ms ({bound_ms / clean_ms:.0%} of the bound)")
    log(f"[k1-time] Dense_0.weight alone (n={d_n}): between CUDA events "
        f"{d_ms:.4f} ms, device time {d_dev:.4f} ms, bound {d_bound:.4f} ms "
        f"({d_bound / d_dev:.0%} of the memory rate)")
    record.update(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms,
                  bound_by=bound_by, library_ms=None, device_ms=dev_ms)


def partial_bytes_ops(mb: int, n: int, halves: int = 2):
    """K2 on one [mb, n] block: bytes it must move (u and wn read once, the
    `halves` outputs written once) and its operations (sign, add,
    multiply-add)."""
    return 4 * (mb * n + mb + halves * n), 3 * mb * n


def phase_k2(rlr_fused, record) -> None:
    """K2 against its plain version, one leaf and many, then its time at
    the sharded main path's shapes (m/d = 2, one launch over every leaf
    into the packed buffer) beside its bound, the plain version and the
    nearest composite of PyTorch calls."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"
    err = 0.0
    shapes = leaf_shapes()
    cases = [(4, 300), (10, 5000), (7, 1111)] + [
        (mb, math.prod(s)) for s in shapes.values() for mb in (2, 5)]
    for m, n in cases:
        u = torch.randn(m, n, generator=gen, device=dev)
        u[0, :5] = 0.0                      # sign(0) votes for no side
        w = torch.rand(m, generator=gen, device=dev) * 4 + 1
        wn = w / (w.sum() * 2)              # a global total over 2 blocks
        before = rlr_fused.LAUNCHES["rlr_partial"]
        got_s, got_w = rlr_fused.rlr_partial(u, wn)
        want_s, want_w = rlr_fused.rlr_partial_reference(u, wn)
        torch.cuda.synchronize()
        check_launches(rlr_fused, "rlr_partial", before, 1, "one leaf")
        # sums of +-1 and 0 round nowhere: exact
        torch.testing.assert_close(got_s, want_s, atol=0, rtol=0)
        torch.testing.assert_close(got_w, want_w, atol=TOL, rtol=TOL)
        err = max(err, float((got_w - want_w).abs().max()))
    mb = M // SHARDED_RANKS
    tables = leaf_tables(mb) + [(f"CNN_MNIST m={M // 2}", M // 2,
                                 [math.prod(s) for s in shapes.values()],
                                 False)]
    for label, m, sizes, unaligned in tables:
        us, _ = table_tensors(gen, m, sizes, unaligned)
        w = torch.rand(m, generator=gen, device=dev) + 1
        wn = w / (w.sum() * 2)
        offsets, total = rlr_fused.packed_offsets(tuple(sizes))
        # [weighted sums | sign sums], as the sharded step packs them
        for sign_at, wsum_at in ((total, 0), (total, None), (None, 0)):
            buf = torch.full((2 * total,), float("nan"), device=dev)
            before = rlr_fused.LAUNCHES["rlr_partial"]
            rlr_fused.rlr_partial_leaves(us, wn, buf, offsets, sign_at,
                                         wsum_at)
            torch.cuda.synchronize()
            check_launches(rlr_fused, "rlr_partial", before, len(sizes),
                           label)
            for u, o in zip(us, offsets):
                n = u.shape[1]
                want_s, want_w = rlr_fused.rlr_partial_reference(u, wn)
                if sign_at is not None:
                    torch.testing.assert_close(
                        buf[sign_at + o:sign_at + o + n], want_s, atol=0,
                        rtol=0)
                if wsum_at is not None:
                    got = buf[wsum_at + o:wsum_at + o + n]
                    torch.testing.assert_close(got, want_w, atol=TOL,
                                               rtol=TOL)
                    err = max(err, float((got - want_w).abs().max()))
            for at, half in ((sign_at, total), (wsum_at, 0)):
                if at is None:
                    if not bool(buf[half:half + total].isnan().all()):
                        raise AssertionError(f"{label}: a half not asked "
                                             f"for was written")
                else:
                    check_pads(rlr_fused, buf, at, offsets, sizes, label)
    log(f"[k2] {len(cases)} one-leaf cases (test_pallas shapes + every "
        f"CNN_MNIST leaf at m/d = 2 and 5) and {3 * len(tables)} multi-leaf "
        f"tables ({'; '.join(t[0] for t in tables)}; both halves, sign only, "
        f"weighted only): sign sum exact, max |kernel - plain| of the "
        f"weighted sum {err:.3e} (tolerance {TOL}), pad lanes zero, halves "
        f"not asked for untouched")

    name = torch.cuda.get_device_name(0)
    rate = hbm_rate(name)
    ups = {k: torch.randn((mb,) + s, generator=gen, device=dev) * 1e-2
           for k, s in shapes.items()}
    wn = torch.full((mb,), 1.0 / M, device=dev)
    views = [ups[k].view(mb, -1) for k in shapes]
    sizes = [u.shape[1] for u in views]
    offsets, width = rlr_fused.packed_offsets(tuple(sizes))
    buf = torch.empty(2 * width, device=dev)
    stacks = list(ups.values())
    scratch = torch.empty(64 * 2 ** 20, device=dev)     # 256 MB > L2

    def flush():
        scratch.zero_()

    def kernel_step():
        rlr_fused.rlr_partial_leaves(stacks, wn, buf, offsets, width, 0)

    def composite(u):
        return torch.sign(u).sum(0), torch.mv(u.t(), wn)

    total_bytes = total_ops = 0
    for n in sizes:
        nbytes, nops = partial_bytes_ops(mb, n)
        total_bytes += nbytes
        total_ops += nops
    k_ms = time_ms(kernel_step, flush)
    dev_ms, per_call = device_ms(kernel_step, flush, K2_KERNEL)
    clean_ms, _ = device_ms(kernel_step, lambda: scratch.sum(), K2_KERNEL)
    p_ms = time_ms(lambda: [rlr_fused.rlr_partial_reference(u, wn)
                            for u in views], flush)
    c_ms = time_ms(lambda: [composite(u) for u in views], flush)
    bound_ms = max(total_bytes / rate, total_ops / FP32_FLOPS) * 1e3
    bound_by = ("bytes" if total_bytes / rate >= total_ops / FP32_FLOPS
                else "operations")
    d_u = ups["Dense_0.weight"].view(mb, -1)
    d_ms = time_ms(lambda: rlr_fused.rlr_partial(d_u, wn), flush)
    d_dev, _ = device_ms(lambda: rlr_fused.rlr_partial(d_u, wn), flush,
                         K2_KERNEL)
    d_bound = partial_bytes_ops(mb, d_u.shape[1])[0] / rate * 1e3
    d_c = time_ms(lambda: composite(d_u), flush)
    log(f"[k2-time] per round per rank (m/d={mb}, {len(shapes)} leaves into "
        f"the packed buffer, both halves, L2 flushed; {name}, "
        f"{rate / 1e12:.2f} TB/s): {per_call:.0f} launch(es), between CUDA "
        f"events {k_ms:.4f} ms, device time {dev_ms:.4f} ms (profiler), "
        f"plain {p_ms:.4f} ms, composite torch.sign(u).sum(0) + "
        f"torch.mv(u.t(), wn) {c_ms:.4f} ms (two calls a leaf: no single "
        f"PyTorch call computes K2), bound {bound_ms:.4f} ms ({bound_by}, "
        f"{total_bytes / 1e6:.1f} MB; device time at "
        f"{bound_ms / dev_ms:.0%} of it)")
    log(f"[k2-time] the same launch after a flush that only reads the L2: "
        f"device time {clean_ms:.4f} ms ({bound_ms / clean_ms:.0%} of the "
        f"bound)")
    log(f"[k2-time] Dense_0.weight alone (n={d_u.shape[1]}): between CUDA "
        f"events {d_ms:.4f} ms, device time {d_dev:.4f} ms, composite "
        f"{d_c:.4f} ms, bound {d_bound:.4f} ms ({d_bound / d_dev:.0%} of the "
        f"memory rate)")
    record.update(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms,
                  bound_by=bound_by, library_ms=None, composite_ms=c_ms,
                  device_ms=dev_ms)


def graph_ms(fn, reps: int = 20) -> float:
    """Median time of one replay of fn captured as a CUDA graph (after a
    warm-up on a side stream), between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = time_ms(graph.replay, lambda: None, reps=reps, warmup=2)
    del graph
    return ms


def flat_rows(stacked):
    return torch.cat([v.reshape(v.shape[0], -1) for v in stacked.values()],
                     dim=1)


def update_gap(got, want):
    """Worst agent's relative L2 and max-abs (over the update's max-abs)
    between two [m, n] update stacks."""
    rel = ((got - want).norm(dim=1) / want.norm(dim=1)).max().item()
    mx = ((got - want).abs().amax(dim=1)
          / want.abs().amax(dim=1)).max().item()
    return rel, mx


def phase_batched(st) -> None:
    """The batched trainer against the per-agent oracle on the same slot
    draws, in each layout: a short round (held to TRAIN_TOL) and the whole
    round (held to ROUND_TOL, beside the oracle's own spread when its start
    point moves by one ulp); the captured round's replay against the eager
    round; one batched step against m sequential steps, eager and as
    graphs."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        client, rounds)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils import (
        compile_cache)

    cfg, fed, model, norm = st["cfg"], st["fed"], st["model"], st["norm"]
    images, labels, params0 = st["images"], st["labels"], st["params"]
    sizes = fed.train.sizes
    rng = rounds.RoundRNG(cfg.seed, DEVICE)
    rnd = rng.next_round()
    sampled = rounds.sample_agents(cfg, rng.host).tolist()
    m = len(sampled)
    trainer = rounds.make_block_trainer(cfg, model, norm, images, labels,
                                        sizes)
    agents, perms, keep = trainer.draw(rng, rnd, sampled, 0, m)
    nb = images.shape[1] // cfg.bs
    log(f"[batched] m={m}, bs {cfg.bs}, shards {min(sizes)}-{max(sizes)} "
        f"samples padded to {images.shape[1]}, {cfg.local_ep} x {nb} = "
        f"{cfg.local_ep * nb} steps; keep-masks "
        f"{sum(k.numel() for k in keep) / 1e6:.1f} MB a round "
        f"({', '.join(str(tuple(k.shape)) for k in keep)})")
    layouts = (("vmap", cfg),
               ("megabatch", cfg.replace(train_layout="megabatch")),
               ("vmap chunk 5", cfg.replace(agent_chunk=5)))

    # a short round from params0: both epochs over each agent's first two
    # batches, the second partly padding for most agents, on fresh draws
    # for that shape; 4 steps leave f32 differences unamplified
    bs = cfg.bs
    imgs_s = images[:, :2 * bs].contiguous()
    lbls_s = labels[:, :2 * bs].contiguous()
    sizes_s = [2 * bs - (37 * a) % bs for a in range(len(sizes))]
    short = rounds.make_block_trainer(cfg, model, norm, imgs_s, lbls_s,
                                      sizes_s)
    draws_s = short.draw(rounds.RoundRNG(cfg.seed + 3, DEVICE), 1, sampled,
                         0, m)
    want_s = flat_rows({k: torch.stack([u[k] for u, _ in (
        client.make_local_train(model, cfg, norm)(
            params0, imgs_s[a], lbls_s[a], sizes_s[a], draws_s[1][s],
            tuple(k[s] for k in draws_s[2]))
        for s, a in enumerate(sampled))]) for k in params0})
    for label, c in layouts:
        tr = rounds.make_block_trainer(c, model, norm, imgs_s, lbls_s,
                                       sizes_s)
        rel, mx = update_gap(flat_rows(tr.run(params0, *draws_s)[0]), want_s)
        log(f"[batched] short round (2 epochs x 2 batches), {label} vs the "
            f"oracle: worst agent rel L2 {rel:.3e}, max-abs {mx:.3e} of the "
            f"update's scale (tolerances {TRAIN_TOL[0]:g}, "
            f"{TRAIN_TOL[1]:g})")
        if rel > TRAIN_TOL[0] or mx > TRAIN_TOL[1]:
            raise AssertionError(f"{label}: the batched trainer left the "
                                 f"per-agent oracle")

    # the whole round, 48 steps
    oracle = client.make_local_train(model, cfg, norm)

    def run_oracle(p0):
        outs = [oracle(p0, images[a], labels[a], int(sizes[a]), perms[s],
                       tuple(k[s] for k in keep))
                for s, a in enumerate(sampled)]
        return (flat_rows({k: torch.stack([u[k] for u, _ in outs])
                           for k in params0}),
                torch.stack([loss for _, loss in outs]))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, want_loss = run_oracle(params0)
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    nudged = {k: v * (1 + 2.0 ** -23 * torch.randn(v.shape, generator=gen,
                                                    device=DEVICE))
              for k, v in params0.items()}
    spread = update_gap(run_oracle(nudged)[0], want)
    log(f"[batched] the round's conditioning: the oracle from params0 moved "
        f"by one ulp, worst agent rel L2 {spread[0]:.3e}, max-abs "
        f"{spread[1]:.3e} of the update's scale after "
        f"{cfg.local_ep * nb} steps")
    got_by = {}
    for label, c in layouts:
        tr = rounds.make_block_trainer(c, model, norm, images, labels, sizes)
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ups, losses = tr.run(params0, agents, perms, keep)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        got_by[label] = flat_rows(ups)
        rel, mx = update_gap(got_by[label], want)
        lrel = ((losses - want_loss).abs() / want_loss.abs()).max().item()
        log(f"[batched] whole round, {label} vs the oracle: worst agent rel "
            f"L2 {rel:.3e}, max-abs {mx:.3e} of the update's scale, loss rel "
            f"{lrel:.3e} (tolerances {ROUND_TOL[0]:g}, {ROUND_TOL[1]:g}, "
            f"{ROUND_TOL[0]:g}); eager block {times[0]:.3f} s first call, "
            f"{times[1]:.3f} s second, the oracle {oracle_s:.3f} s")
        if rel > ROUND_TOL[0] or mx > ROUND_TOL[1] or lrel > ROUND_TOL[0]:
            raise AssertionError(f"{label}: the batched trainer left the "
                                 f"per-agent oracle")
    same = update_gap(got_by["megabatch"], got_by["vmap"])
    log(f"[batched] whole round, megabatch vs vmap: rel L2 {same[0]:.3e}, "
        f"max-abs {same[1]:.3e} of the update's scale")
    del want, got_by

    # the captured round's replay (round 2) against the eager round 2
    strict = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    for mode in ("default", "deterministic"):
        torch.backends.cudnn.deterministic = mode == "deterministic"
        try:
            out = {}
            for capture in (True, False):
                fn = rounds.make_round_fn(cfg, model, norm, images, labels,
                                          sizes, capture=capture)
                r = rounds.RoundRNG(cfg.seed + 11, DEVICE)
                replays = compile_cache.GRAPH_REPLAYS["round"]
                p, info = fn(params0, r)
                p, info = fn(p, r)
                out[capture] = ({k: v.clone() for k, v in p.items()},
                                float(info["train_loss"]),
                                compile_cache.GRAPH_REPLAYS["round"]
                                - replays)
                del fn, p, info
        finally:
            (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark) = strict
        diff = max(float((out[True][0][k] - v).abs().max())
                   for k, v in out[False][0].items())
        log(f"[batched] round 2, captured replay vs eager (cuDNN {mode}): "
            f"max |params diff| {diff:.3e}, train_loss {out[True][1]:.7f} vs "
            f"{out[False][1]:.7f}; replays {out[True][2]} / {out[False][2]}"
            + (f" (tolerance {TOL})" if mode == "deterministic" else ""))
        if out[True][2] != 1 or out[False][2] != 0:
            raise AssertionError("the captured round did not replay")
        if mode == "deterministic" and diff > TOL:
            raise AssertionError("the replayed round left the eager round")

    # one step: batched (both layouts, and the vmap layout in chunks)
    # against m sequential one-agent steps, eager and as CUDA graphs
    c1 = cfg.replace(local_ep=1)
    imgs1, lbls1 = imgs_s[:, :bs].contiguous(), lbls_s[:, :bs].contiguous()
    full = torch.full((m,), bs, device=DEVICE)
    perms1 = torch.arange(bs, device=DEVICE).expand(m, 1, bs).contiguous()
    keep1 = tuple(k[:, :1, :1].contiguous() for k in keep)
    lt1 = client.make_local_train(model, c1, norm)

    def sequential():
        return [lt1(params0, imgs1[a], lbls1[a], bs, perms1[s],
                    tuple(k[s] for k in keep1))
                for s, a in enumerate(sampled)]

    seq = (time_ms(sequential, lambda: None, reps=10, warmup=2),
           graph_ms(sequential))
    line = []
    chunked = tuple((f"vmap chunk {n}", cfg.replace(agent_chunk=n))
                    for n in (1, 2, 5))
    for label, c in layouts[:2] + chunked:
        tr1 = rounds.make_block_trainer(c.replace(local_ep=1), model, norm,
                                        imgs1, lbls1, [bs] * len(sizes))

        def step(tr1=tr1):
            return tr1.run(params0, agents, perms1, keep1)
        ms = (time_ms(step, lambda: None, reps=10, warmup=2), graph_ms(step))
        line.append(f"{label} {ms[0]:.2f} ms eager / {ms[1]:.2f} ms as a "
                    f"graph ({seq[1] / ms[1]:.2f}x the sequential graph)")
    log(f"[batched] one SGD step of m={m} agents at bs {bs}: "
        f"{'; '.join(line)}; m sequential one-agent steps {seq[0]:.2f} ms "
        f"eager / {seq[1]:.2f} ms as a graph")


def triple():
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
        Config)
    base = Config(data="fmnist", num_agents=10, agent_frac=1.0, local_ep=2,
                  bs=256, client_lr=0.1, client_moment=0.9, aggr="avg",
                  pattern_type="plus", base_class=5, target_class=7,
                  rounds=ROUNDS, snap=2, synth_train_size=60000,
                  synth_val_size=10000, log_dir="build/chip_smoke/logs",
                  device=DEVICE)
    return {"clean": base,
            "attack": base.replace(num_corrupt=1, poison_frac=0.5),
            "attack_rlr4": base.replace(num_corrupt=1, poison_frac=0.5,
                                        robustLR_threshold=4)}


def phase_main_path(rlr_fused) -> int:
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch import (
        train)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils import (
        compile_cache)
    for k in rlr_fused.LAUNCHES:
        rlr_fused.LAUNCHES[k] = 0
    compile_cache.GRAPH_REPLAYS["round"] = 0
    summaries = {}
    for chain in (1, 2):
        for label, cfg in triple().items():
            s = train.run(cfg.replace(chain=chain))
            summaries[label, chain] = s
            log(f"[main] {label} chain {chain}: {s['rounds_per_sec']:.3f} "
                f"rounds/s ({s['steady_rounds_per_sec']:.3f} steady, after "
                f"the first dispatch), train_loss {s['train_loss']:.4f}, "
                f"val_acc {s['val_acc']:.4f}, poison_acc "
                f"{s['poison_acc']:.4f} at round {s['round']}")
    launches = rlr_fused.LAUNCHES["rlr_fused"]
    replays = compile_cache.GRAPH_REPLAYS["round"]
    runs = 2 * len(triple())
    expect = runs * ROUNDS
    log(f"[main] rlr_fused launches on the main path: {launches} (expected "
        f"{expect}: {runs} runs x {ROUNDS} rounds, one launch over all "
        f"{len(leaf_shapes())} leaves a round); round graph replays "
        f"{replays} (expected {runs * (ROUNDS - 1)}: every round after the "
        f"first of a run)")
    for (label, chain), s in summaries.items():
        for key in ("train_loss", "val_acc", "val_loss", "poison_acc",
                    "poison_loss", "rounds_per_sec"):
            if not math.isfinite(s[key]):
                raise AssertionError(f"{label}: {key} = {s[key]}")
        if s["val_acc"] < 0.5:
            raise AssertionError(f"{label}: val_acc {s['val_acc']} after "
                                 f"{ROUNDS} rounds: the model did not learn")
        for k, v in s["params"].items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{label}: non-finite params in {k}")
    for label in triple():
        a, b = summaries[label, 1], summaries[label, 2]
        diff = max(float((a["params"][k] - v).abs().max())
                   for k, v in b["params"].items())
        log(f"[main] {label}: chain 2 vs chain 1 after {ROUNDS} rounds: max "
            f"|params diff| {diff:.3e}, val_acc {b['val_acc']:.4f} vs "
            f"{a['val_acc']:.4f}")
    if launches != expect:
        raise AssertionError(f"rlr_fused launched {launches} times on the "
                             f"main path, expected {expect}")
    if replays != runs * (ROUNDS - 1):
        raise AssertionError(f"{replays} round graph replays on the main "
                             f"path, expected {runs * (ROUNDS - 1)}")
    return launches


def round_setup():
    """The attack + RLR run's data, model, params and round fn on DEVICE."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data.registry import (
        get_federated_data)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        common, rounds)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
        registry)

    cfg = triple()["attack_rlr4"]
    fed = get_federated_data(cfg)
    model = registry.get_model(cfg.data, cfg.image_shape)
    norm = common.make_normalizer(fed.mean, fed.std, DEVICE)
    images = torch.from_numpy(fed.train.images).to(DEVICE)
    labels = torch.from_numpy(fed.train.labels).to(DEVICE, torch.int64)
    return dict(cfg=cfg, fed=fed, model=model, norm=norm, images=images,
                labels=labels, params=registry.init_params(model, cfg.seed,
                                                           DEVICE),
                rng=rounds.RoundRNG(cfg.seed, DEVICE),
                round_fn=rounds.make_round_fn(cfg, model, norm, images,
                                              labels, fed.train.sizes))


def phase_server_parity(rlr_fused, record, st) -> None:
    """One round's real updates: kernel server step vs plain server step."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        rounds)

    cfg, fed, params, rng = st["cfg"], st["fed"], st["params"], st["rng"]
    sampled = rounds.sample_agents(cfg, rng.host).tolist()
    updates, _ = rounds.make_block_trainer(
        cfg, st["model"], st["norm"], st["images"], st["labels"],
        fed.train.sizes)(params, rng, rng.next_round(), sampled, 0,
                         len(sampled))
    sizes = torch.as_tensor(fed.train.sizes[sampled], device=DEVICE)
    worst = 0.0
    for aggr, thr in (("avg", 4), ("avg", 0), ("sign", 4)):
        c = cfg.replace(aggr=aggr, robustLR_threshold=thr)
        fused = rounds.server_step(params, updates, sizes, c)
        plain = rounds.server_step(params, updates, sizes,
                                   c.replace(use_fused=False))
        for k in params:
            torch.testing.assert_close(fused[k], plain[k], atol=TOL, rtol=TOL)
            worst = max(worst, float((fused[k] - plain[k]).abs().max()))
    log(f"[server] one round's real updates (m={len(sampled)}): kernel vs "
        f"ops/aggregate.py server step, avg+RLR4 / avg / sign+RLR4: max "
        f"|diff| {worst:.3e} (tolerance {TOL})")
    record["max_abs_err"] = max(record["max_abs_err"], worst)


def kernel_table(prof):
    """Per kernel name (launches, summed ms) of a profile's device events,
    and the card's busy ms: the union of the kernels' intervals (a graph's
    independent kernels may overlap, so their summed times may exceed the
    wall)."""
    from torch.autograd import DeviceType

    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
            spans.append((e.time_range.start, e.time_range.end))
    busy_us, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    return by_name, busy_us / 1e3


def phase_profile(st) -> None:
    """Where one replayed attack + RLR round's time goes: wall time
    unprofiled, then one round under torch.profiler for its kernels, the
    card's busy time, its idle share, K1's one launch, and the kernels that
    take the most. K1's one launch is held two ways: its wrapper's count
    (each replay adds the launches its graph holds) and the profiler's
    events. The profiler can drop device events of a 15,000-kernel round
    (CUPTI's buffers), so a profiled replay in which it sees no K1 is
    profiled again, up to PROFILE_TRIES in all; none seeing K1 fails, as
    does more than one launch by either count."""
    from torch.profiler import ProfilerActivity, profile

    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops import (
        rlr_fused)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils import (
        compile_cache)

    round_fn, params, rng = st["round_fn"], st["params"], st["rng"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, _ = round_fn(params, rng)           # warm-up and capture
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        params, _ = round_fn(params, rng)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    seen = []                   # K1 launches the profiler kept, by try
    for _ in range(PROFILE_TRIES):
        replays = compile_cache.GRAPH_REPLAYS["round"]
        k1_before = rlr_fused.LAUNCHES["rlr_fused"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, _ = round_fn(params, rng)
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
        if compile_cache.GRAPH_REPLAYS["round"] != replays + 1:
            raise AssertionError("the profiled round was not a graph replay")
        k1_launched = rlr_fused.LAUNCHES["rlr_fused"] - k1_before
        by_name, busy_ms = kernel_table(prof)
        k1 = [(n, t) for name, (n, t) in by_name.items() if K1_KERNEL in name]
        seen.append(sum(n for n, _ in k1))
        if k1_launched != 1 or seen[-1] > 1:
            raise AssertionError(f"the profiled round launched rlr_fused "
                                 f"{k1_launched} times ({seen[-1]} seen by "
                                 f"the profiler), expected once")
        if seen[-1] == 1:
            break
    else:
        raise AssertionError(f"the profiler saw no rlr_fused launch in "
                             f"{PROFILE_TRIES} profiled replays (its "
                             f"wrapper counted one in each)")
    summed_ms = sum(t for _, t in by_name.values())
    launches = sum(n for n, _ in by_name.values())
    k1_ms = sum(t for _, t in k1)
    cfg = st["cfg"]
    steps = cfg.local_ep * (st["images"].shape[1] // cfg.bs)
    log(f"[profile] one attack+RLR round, a graph replay after a first "
        f"round of {first_ms:.1f} ms (eager warm-up + capture): wall "
        f"{statistics.median(walls):.1f} ms unprofiled (median of "
        f"{', '.join(f'{w:.1f}' for w in walls)}), {prof_wall_ms:.1f} ms "
        f"profiled; card busy {busy_ms:.1f} ms (kernel times summed "
        f"{summed_ms:.1f} ms: some overlap) in {launches} kernels "
        f"({launches / steps:.0f} a batched step over {steps} steps, the "
        f"draws included), idle share {1 - busy_ms / prof_wall_ms:.3f} of "
        f"the profiled round; rlr_fused {k1_ms:.4f} ms in 1 launch (its "
        f"wrapper's count and the profiler's, profiled replay "
        f"{len(seen)} of {PROFILE_TRIES}: K1 seen {seen})")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        log(f"[profile]   {t:9.2f} ms {n:6d}x  {name[:90]}")
    if not by_name:
        raise AssertionError("the profiler saw no kernel of the replayed "
                             "round")
    # the same replayed round with the agents trained in chunks (the
    # memory lever; chunk 1 trains one agent at a time, ungrouped)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        rounds)
    # and with cuDNN choosing its algorithms by timing them (benchmark)
    line = []
    for chunk, bench in ((1, False), (2, False), (5, False), (0, True),
                         (1, True)):
        torch.backends.cudnn.benchmark = bench
        try:
            fn = rounds.make_round_fn(cfg.replace(agent_chunk=chunk),
                                      st["model"], st["norm"], st["images"],
                                      st["labels"], st["fed"].train.sizes)
            r = rounds.RoundRNG(cfg.seed, DEVICE)
            p, _ = fn(st["params"], r)
            times = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p, _ = fn(p, r)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        finally:
            torch.backends.cudnn.benchmark = False
        line.append(f"chunk {chunk or 'none'}{', cuDNN benchmark' * bench} "
                    f"{min(times):.1f} ms")
        del fn, p
    log(f"[profile] the replayed round (the faster of two) with "
        f"--agent_chunk: {'; '.join(line)} (whole block "
        f"{statistics.median(walls):.1f} ms)")


# ---------------------------------------------------------- slice 5 ---
# the paper's CIFAR-10 DBA and Fed-EMNIST triples (reference
# src/runner.sh:23-28 and :34-38) at full width, rounds cut

CIFAR_ROUNDS = 2
RESNET_ROUNDS = 2
# ResNet-9 trains one agent at a time inside the graph: PR 7 measured the
# ungrouped convolutions of --agent_chunk 1 at twice the speed of the
# grouped ones, and one agent's activations at bs 256 (about 1.2 GB) keep
# the peak far below the card's 80 GB
RESNET_CHUNK = 1
FED_ROUNDS = 3
FED_SNAP = 3
FED_TIMED = 10              # rounds timed without eval per mode


def cifar10_triple():
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
        Config)
    base = Config(data="cifar10", num_agents=40, agent_frac=1.0, local_ep=2,
                  bs=256, client_lr=0.1, client_moment=0.9, aggr="avg",
                  pattern_type="plus", base_class=5, target_class=7,
                  rounds=CIFAR_ROUNDS, snap=CIFAR_ROUNDS,
                  synth_train_size=50000, synth_val_size=10000,
                  log_dir="build/chip_smoke/logs_cifar10", device=DEVICE)
    attack = base.replace(num_corrupt=4, poison_frac=0.5)
    return {"clean": base, "attack": attack,
            "attack_rlr8": attack.replace(robustLR_threshold=8)}


def resnet9_cfg():
    return cifar10_triple()["attack_rlr8"].replace(
        arch="resnet9", rounds=RESNET_ROUNDS, snap=RESNET_ROUNDS,
        agent_chunk=RESNET_CHUNK)


def fedemnist_triple():
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
        Config)
    # 3,383 users, 1% sampled, 10 local epochs at bs 64; the stand-in's
    # users hold 16-63 samples (JAX's synthetic shards), drawn without
    # repeats from a pool of 140,000
    base = Config(data="fedemnist", num_agents=3383, agent_frac=0.01,
                  local_ep=10, bs=64, client_lr=0.1, client_moment=0.9,
                  aggr="avg", pattern_type="plus", base_class=5,
                  target_class=7, rounds=FED_ROUNDS, snap=FED_SNAP,
                  synth_train_size=140000, synth_val_size=10000,
                  log_dir="build/chip_smoke/logs_fedemnist", device=DEVICE)
    attack = base.replace(num_corrupt=338, poison_frac=0.5)
    return {"clean": base, "attack": attack,
            "attack_rlr8": attack.replace(robustLR_threshold=8)}


def drive(rlr_fused, what, cfg, k1: bool = True, ran=None, k1_expect=None,
          replays=None):
    """One train.run with the kernel counts and graph replays set to 0
    just before and read just after: K1 once a round (the first eagerly,
    then once in each replay), or never where `k1` is False (a rule other
    than avg or sign, or faults: the plain server step), every round after
    the first a replay, no K2. `ran` is the rounds this run dispatches (a
    resumed run's; default cfg.rounds); `k1_expect` and `replays` replace
    the expected counts (a --diagnostics run's). Returns the summary with
    the counts, the run's peak device memory (above what the process held
    before it) and the run's seconds."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch import (
        train)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils import (
        compile_cache)
    for k in rlr_fused.LAUNCHES:
        rlr_fused.LAUNCHES[k] = 0
    compile_cache.GRAPH_REPLAYS["round"] = 0
    compile_cache.GRAPH_CAPTURES["round"] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # by the phases before this run
    t0 = time.perf_counter()
    s = train.run(cfg)
    torch.cuda.synchronize()
    s["seconds"] = time.perf_counter() - t0
    s["launches"] = rlr_fused.LAUNCHES["rlr_fused"]
    s["replays"] = compile_cache.GRAPH_REPLAYS["round"]
    s["captures"] = compile_cache.GRAPH_CAPTURES["round"]
    s["peak_gib"] = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    steady = s["steady_rounds_per_sec"]
    log(f"[{what}] {s['rounds_per_sec']:.3f} rounds/s with eval "
        f"({'no' if steady is None else f'{steady:.3f}'} steady, after the "
        f"first dispatch), train_loss {s['train_loss']:.4f}, val_acc "
        f"{s['val_acc']:.4f}, poison_acc {s['poison_acc']:.4f} at round "
        f"{s['round']}; K1 {s['launches']} launches, {s['replays']} graph "
        f"replays; the run's peak device memory {s['peak_gib']:.2f} GiB; "
        f"{s['seconds']:.1f} s, data built")
    for key in ("train_loss", "val_acc", "val_loss", "poison_acc",
                "poison_loss", "rounds_per_sec"):
        if not math.isfinite(s[key]):
            raise AssertionError(f"{what}: {key} = {s[key]}")
    if s["hlth_nonfinite"] != 0 or s["hlth_params_finite"] != 1:
        raise AssertionError(f"{what}: health lanes {s}")
    for k, v in s["params"].items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{what}: non-finite params in {k}")
    ran = cfg.rounds if ran is None else ran
    if k1_expect is None:
        k1_expect = ran if k1 else 0
    if replays is None:
        replays = ran - 1
    if (s["launches"] != k1_expect or s["replays"] != replays
            or rlr_fused.LAUNCHES["rlr_partial"]):
        raise AssertionError(
            f"{what}: {s['launches']} K1 launches and {s['replays']} "
            f"replays in {ran} rounds, expected {k1_expect} and "
            f"{replays}; K2 {rlr_fused.LAUNCHES['rlr_partial']}")
    return s


def k1_against_plain(rlr_fused, params, updates, sizes, thr):
    """K1 over every leaf of one round's real updates against the plain
    version leaf by leaf, avg+RLR thr / avg / sign+RLR thr: the largest
    |kernel - plain| of avg (sign must be exact)."""
    m = sizes.shape[0]
    wn = sizes.to(torch.float32) / sizes.to(torch.float32).sum()
    worst = 0.0
    for mode, t in (("avg", thr), ("avg", 0.0), ("sign", thr)):
        before = rlr_fused.LAUNCHES["rlr_fused"]
        got = rlr_fused.fused_rlr_avg_apply(params, updates, sizes, t, 1.0,
                                            mode)
        torch.cuda.synchronize()
        check_launches(rlr_fused, "rlr_fused", before, len(params),
                       f"K1 m={m}")
        for k, p in params.items():
            want = rlr_fused.rlr_fused_reference(
                updates[k].reshape(m, -1), wn, p.reshape(-1), t, 1.0,
                mode).view(p.shape)
            if mode == "sign":
                torch.testing.assert_close(got[k], want, atol=0, rtol=0)
            else:
                torch.testing.assert_close(got[k], want, atol=TOL, rtol=TOL)
                worst = max(worst, float((got[k] - want).abs().max()))
    return worst


def phase_cifar10(rlr_fused, record) -> None:
    """The CIFAR-10 DBA triple through train.run with CNN_CIFAR (40 agents
    all sampled, 4 corrupt each stamping its quarter of the plus, RLR
    threshold 8), then the attack + RLR run on ResNet-9; then K1 against
    its plain version on one round's real updates of each model."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data.registry import (
        get_federated_data)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        common, rounds)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
        registry)

    launches = 0
    for label, cfg in cifar10_triple().items():
        launches += drive(rlr_fused, f"cifar10 {label}", cfg)["launches"]
    cfg = resnet9_cfg()
    log(f"[cifar10] ResNet-9, attack + RLR 8, --agent_chunk {cfg.agent_chunk}"
        f" (one agent at a time inside the round's graph)")
    s = drive(rlr_fused, "cifar10 resnet9", cfg)
    launches += s["launches"]
    # every agent sampled: local_ep passes over the real samples (40 x
    # 1,250, padded to 1,280); about 0.76 GFLOP forward an example, 3x that
    # with the backward
    flop = 3 * 0.76e9 * cfg.local_ep * cfg.synth_train_size
    steady_s = 1.0 / s["steady_rounds_per_sec"]
    log(f"[cifar10] ResNet-9 round (eval of 10,000 + "
        f"poisoned val included): {steady_s:.2f} s steady, about "
        f"{flop / 1e12:.0f} TFLOP of real samples at f32 (TF32 off): "
        f"{flop / steady_s / 1e12:.1f} TFLOP/s")
    record["launches_by_path"]["cifar10"] = launches

    # K1 on real updates at m = 40, each model
    cfg = cifar10_triple()["attack_rlr8"]
    fed = get_federated_data(cfg)
    norm = common.make_normalizer(fed.mean, fed.std, DEVICE)
    images = torch.from_numpy(fed.train.images).to(DEVICE)
    labels = torch.from_numpy(fed.train.labels).to(DEVICE, torch.int64)
    worst = 0.0
    for arch, c in (("cnn", cfg), ("resnet9", resnet9_cfg())):
        model = registry.get_model(c.data, c.image_shape, arch=arch)
        params = registry.init_params(model, c.seed, DEVICE)
        rng = rounds.RoundRNG(c.seed, DEVICE)
        sampled = rounds.sample_agents(c, rng.host).tolist()
        updates, _ = rounds.make_block_trainer(
            c, model, norm, images, labels, fed.train.sizes)(
                params, rng, rng.next_round(), sampled, 0, len(sampled))
        sizes = torch.as_tensor(fed.train.sizes[sampled], device=DEVICE)
        err = k1_against_plain(rlr_fused, params, updates, sizes, 8.0)
        log(f"[cifar10] K1 on one round's real updates, {type(model).__name__}"
            f" (m={len(sampled)}, {len(params)} leaves, "
            f"{registry.param_count(params):,} values), avg+RLR8 / avg / "
            f"sign+RLR8: max |kernel - plain| {err:.3e} (sign exact, avg "
            f"within {TOL})")
        worst = max(worst, err)
        del updates
    record["max_abs_err"] = max(record["max_abs_err"], worst)


def host_round_parity(rlr_fused, cfg) -> None:
    """The host round against the device-resident round on the same ids
    and slot draws (cuDNN deterministic, TF32 off): eagerly, and captured
    for two rounds of different ids (round 2 a replay on refilled input
    buffers), within TOL."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch import (
        train)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data.prefetch import (
        HostGather)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data.registry import (
        get_federated_data)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        common, rounds)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
        registry)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils import (
        compile_cache)

    fed = get_federated_data(cfg)
    if compile_cache.is_host_mode(cfg.replace(host_sampled="auto"), fed):
        raise AssertionError("auto picked the host-sampled mode for "
                             f"{fed.train.images.nbytes / 2**20:.0f} MB")
    model = registry.get_model(cfg.data, cfg.image_shape)
    norm = common.make_normalizer(fed.mean, fed.std, DEVICE,
                                  fed.raw_is_normalized)
    images = torch.from_numpy(fed.train.images).to(DEVICE)
    labels = torch.from_numpy(fed.train.labels).to(DEVICE, torch.int64)
    params0 = registry.init_params(model, cfg.seed, DEVICE)
    gather = HostGather(fed.train, DEVICE)
    strict = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    _strict_numerics()
    try:
        line = []
        for capture in (False, True):
            dense = rounds.make_round_fn(cfg, model, norm, images, labels,
                                         fed.train.sizes, capture=capture)
            host = rounds.make_round_fn_host(cfg, model, norm,
                                             fed.train.sizes,
                                             fed.train.max_n, DEVICE,
                                             capture=capture)
            r_dense = rounds.RoundRNG(cfg.seed, DEVICE)
            r_host = rounds.RoundRNG(cfg.seed, DEVICE)
            p_dense = p_host = params0
            replays = compile_cache.GRAPH_REPLAYS["round"]
            for rnd in (1, 2):
                ids = train.sample_ids(cfg, rnd)
                p_dense, i_dense = dense(p_dense, r_dense, sampled=ids)
                p_host, i_host = host(p_host, r_host,
                                      *gather(ids).ready())
                diff = max(float((p_host[k] - v).abs().max())
                           for k, v in p_dense.items())
                ldiff = abs(float(i_host["train_loss"])
                            - float(i_dense["train_loss"]))
                line.append(f"{'captured' if capture else 'eager'} round "
                            f"{rnd}: max |params diff| {diff:.3e}, "
                            f"train_loss diff {ldiff:.3e}")
                if diff > TOL or ldiff > TOL:
                    raise AssertionError("the host round left the "
                                         "device-resident round")
            made = compile_cache.GRAPH_REPLAYS["round"] - replays
            if made != (2 if capture else 0):
                raise AssertionError(f"{made} replays, expected "
                                     f"{2 if capture else 0}")
            del dense, host, p_dense, p_host
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = strict
    log(f"[fedemnist] host round vs device-resident round on the same ids "
        f"and slot draws (cuDNN deterministic; tolerance {TOL}): "
        f"{'; '.join(line)}")


def timed_rounds(round_fn, params, rng, fetch, n, after_first=None):
    """Wall per round of n rounds run back to back after one first round
    (warm-up and capture), eval excluded, one sync at the end; and a
    profile of one more round: its wall, the card's busy time and its
    kernels. fetch(i) gives round i's extra arguments; `after_first` runs
    once the first round is done (nothing may allocate or copy on the card
    from another thread while a stream captures)."""
    from torch.profiler import ProfilerActivity, profile

    params, _ = round_fn(params, rng, *fetch(0))
    torch.cuda.synchronize()
    if after_first is not None:
        after_first()
    t0 = time.perf_counter()
    for i in range(1, n + 1):
        params, _ = round_fn(params, rng, *fetch(i))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, _ = round_fn(params, rng, *fetch(n + 1))
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    by_name, busy_ms = kernel_table(prof)
    return wall_ms, prof_ms, busy_ms, by_name


def phase_fedemnist(rlr_fused, record) -> None:
    """The Fed-EMNIST triple at 3,383 users, m = 33, 10 local epochs at bs
    64: device-resident (--host_sampled auto picks it for the stand-in's
    679 MB of stacks), then host-sampled with --host_prefetch 2; the host
    round against the device-resident one; wall per round without eval
    and a replayed host round's idle share."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch import (
        train)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data.prefetch import (
        HostGather, RoundPrefetcher)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data.registry import (
        get_federated_data)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        common, rounds)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
        registry)

    launches = 0
    for mode, extra in (("device-resident", {}),
                        ("host-sampled", dict(host_sampled="on",
                                              host_prefetch=2))):
        for label, cfg in fedemnist_triple().items():
            launches += drive(rlr_fused, f"fedemnist {mode} {label}",
                              cfg.replace(**extra))["launches"]
    record["launches_by_path"]["fedemnist"] = launches

    cfg = fedemnist_triple()["attack_rlr8"]
    host_round_parity(rlr_fused, cfg)

    # wall per round without eval, each mode; a replayed host round's
    # idle share
    fed = get_federated_data(cfg)
    model = registry.get_model(cfg.data, cfg.image_shape)
    norm = common.make_normalizer(fed.mean, fed.std, DEVICE,
                                  fed.raw_is_normalized)
    params = registry.init_params(model, cfg.seed, DEVICE)
    images = torch.from_numpy(fed.train.images).to(DEVICE)
    labels = torch.from_numpy(fed.train.labels).to(DEVICE, torch.int64)
    dense = rounds.make_round_fn(cfg, model, norm, images, labels,
                                 fed.train.sizes)
    d_wall, d_prof, d_busy, _ = timed_rounds(
        lambda p, r: dense(p, r), params, rounds.RoundRNG(cfg.seed, DEVICE),
        lambda i: (), FED_TIMED)
    del dense, images, labels
    host = rounds.make_round_fn_host(cfg, model, norm, fed.train.sizes,
                                     fed.train.max_n, DEVICE)
    gather = HostGather(fed.train, DEVICE)
    first = gather(train.sample_ids(cfg, 1))
    prefetch = []

    def start():
        prefetch.append(RoundPrefetcher(
            lambda rnd: gather(train.sample_ids(cfg, rnd)),
            range(2, FED_TIMED + 3), depth=2))
    try:
        h_wall, h_prof, h_busy, by_name = timed_rounds(
            host, params, rounds.RoundRNG(cfg.seed, DEVICE),
            lambda i: (first if i == 0 else prefetch[0].get(i + 1)).ready(),
            FED_TIMED, after_first=start)
    finally:
        for p in prefetch:
            p.close()
    stack_mb = first.images.numel() * first.images.element_size() / 2 ** 20
    k1 = [(n, t) for name, (n, t) in by_name.items() if K1_KERNEL in name]
    log(f"[fedemnist] wall per round without eval (m={cfg.agents_per_round},"
        f" {cfg.local_ep} x 1 steps, the mean over {FED_TIMED} "
        f"replays run back to back): device-resident {d_wall:.2f} ms, host-sampled "
        f"{h_wall:.2f} ms ({stack_mb:.1f} MB of gathered images a round, "
        f"pinned, copied on a side stream, depth 2)")
    log(f"[fedemnist] one replayed round under the profiler: "
        f"device-resident wall {d_prof:.2f} ms, card busy {d_busy:.2f} ms, "
        f"idle share {1 - d_busy / d_prof:.3f}; host-sampled wall "
        f"{h_prof:.2f} ms, card busy {h_busy:.2f} ms, idle share "
        f"{1 - h_busy / h_prof:.3f}, K1 {sum(n for n, _ in k1)} launch(es) "
        f"{sum(t for _, t in k1):.4f} ms")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]:
        log(f"[fedemnist]   {t:9.3f} ms {n:6d}x  {name[:90]}")
    if [n for n, _ in k1] != [1]:
        raise AssertionError("the profiled host round did not launch K1 "
                             "once")


def phase_k1_shapes(rlr_fused, record) -> None:
    """K1 (one launch over every leaf) at the slice's three shapes: time
    between CUDA events and device time (L2 flushed before each), beside
    the least time the bytes need and the plain version's time; and the
    kernel against the plain version on each."""
    name = torch.cuda.get_device_name(0)
    rate = hbm_rate(name)
    gen = torch.Generator(device="cuda").manual_seed(3)
    scratch = torch.empty(64 * 2 ** 20, device=DEVICE)     # 256 MB > L2

    def flush():
        scratch.zero_()

    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
        registry)
    shapes = []
    for label, data, image, arch, m in (
            ("ResNet-9", "cifar10", (32, 32, 3), "resnet9", 40),
            ("CNN_CIFAR", "cifar10", (32, 32, 3), "cnn", 40),
            ("CNN_MNIST", "fedemnist", (28, 28, 1), "cnn", 33)):
        model = registry.get_model(data, image, arch=arch)
        leaves = {n: tuple(p.shape) for n, p in model.named_parameters()}
        params = {k: torch.randn(s, generator=gen, device=DEVICE)
                  for k, s in leaves.items()}
        ups = {k: torch.randn((m,) + s, generator=gen, device=DEVICE) * 1e-2
               for k, s in leaves.items()}
        sizes = torch.rand(m, generator=gen, device=DEVICE) * 60 + 16
        err = k1_against_plain(rlr_fused, params, ups, sizes, 8.0)
        wn = sizes / sizes.sum()

        def kernel_step():
            return rlr_fused.fused_rlr_avg_apply(params, ups, sizes, 8.0,
                                                 1.0)

        def plain_step():
            return {k: rlr_fused.rlr_fused_reference(
                ups[k].view(m, -1), wn, params[k].view(-1), 8.0, 1.0)
                for k in params}
        n = sum(math.prod(s) for s in leaves.values())
        nbytes, nops = 4 * (m * n + m + 2 * n), 4 * m * n
        k_ms = time_ms(kernel_step, flush)
        dev_ms, per_call = device_ms(kernel_step, flush, K1_KERNEL)
        p_ms = time_ms(plain_step, flush, reps=20)
        bound_ms = max(nbytes / rate, nops / FP32_FLOPS) * 1e3
        bound_by = ("bytes" if nbytes / rate >= nops / FP32_FLOPS
                    else "operations")
        log(f"[k1-shapes] {label} m={m}, {len(leaves)} leaves, n={n:,} "
            f"({name}, {rate / 1e12:.2f} TB/s): {per_call:.0f} launch(es), "
            f"between CUDA events {k_ms:.4f} ms, device time {dev_ms:.4f} "
            f"ms, plain {p_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
            f"{nbytes / 1e6:.1f} MB; device time at {bound_ms / dev_ms:.0%} "
            f"of it); max |kernel - plain| {err:.3e}")
        shapes.append({"shape": f"{label} m={m}", "leaves": len(leaves),
                       "n": n, "ms": k_ms, "device_ms": dev_ms,
                       "plain_ms": p_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by})
        record["max_abs_err"] = max(record["max_abs_err"], err)
        del params, ups
    record["shapes"] = shapes


# --- phase 13: the robust server rules and the fault model -------------
# BASELINE.json configs[4] ("cifar10 ResNet-9, 256 agents ... comed/krum
# aggregation + RLR") cut from a pod to one card, rounds only; and the
# FMNIST attack + RLR run under each robust rule and under the fault
# regime of scripts/sweep_faults.py

RULES = ("comed", "trmean", "krum", "rfa")
ALL_RULES = ("avg", "sign") + RULES
# two rounds: the first eager, the second a replay (cut from 4 to keep the
# whole script inside its time)
RULES_ROUNDS = 2
CONFIG4_ROUNDS = 2
FAULTS = dict(dropout_rate=0.3, rlr_threshold_mode="scaled",
              faults_spare_corrupt=True, straggler_rate=0.2,
              straggler_epochs=1, corrupt_rate=0.1, corrupt_mode="nan")
RULES_DIR = "build/chip_smoke/logs_rules"


def config4_cfg(aggr):
    """BASELINE.json configs[4] on one card: CIFAR-10 at 50,000 / 10,000,
    ResNet-9, K = 256 agents all sampled (about 195 samples each, padded
    to one batch of 256), 2 local epochs at bs 256, config 3's attack (4
    corrupt agents stamping DBA slices of the plus, poison_frac 0.5, RLR
    threshold 8), one agent at a time inside the round's graph."""
    return resnet9_cfg().replace(
        num_agents=256, aggr=aggr, rounds=CONFIG4_ROUNDS,
        snap=CONFIG4_ROUNDS, log_dir=f"{RULES_DIR}/config4_{aggr}")


def rules_fmnist_cfgs():
    """The FMNIST attack + RLR run (threshold 4) under each robust rule,
    under avg and comed with the fault regime (comed also chained, two
    rounds a dispatch), and under comed with the corrupt agent 0 and the
    honest agent 3 quarantined; and the Fed-EMNIST attack + RLR run under
    comed with the fault regime on the host-sampled round."""
    base = triple()["attack_rlr4"].replace(rounds=RULES_ROUNDS)
    out = {aggr: base.replace(aggr=aggr) for aggr in RULES}
    out.update({f"{aggr}+faults": base.replace(aggr=aggr, **FAULTS)
                for aggr in ("avg", "comed")})
    # four rounds: two chained dispatches, so a steady rate exists
    out["comed+faults chain 2"] = out["comed+faults"].replace(
        chain=2, rounds=4)
    out["comed quarantine 0,3"] = base.replace(aggr="comed",
                                               quarantine="0,3")
    out["fedemnist host comed+faults"] = fedemnist_triple()[
        "attack_rlr8"].replace(aggr="comed", host_sampled="on",
                               host_prefetch=2, rounds=FED_SNAP, **FAULTS)
    return {k: c.replace(log_dir=os.path.join(
        RULES_DIR, k.replace(" ", "_").replace(",", "_")))
        for k, c in out.items()}


def fault_rows_of(cfg):
    """The Faults/* rows of the run's last start in its metrics.jsonl."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils.metrics import (
        run_name)
    with open(os.path.join(cfg.log_dir, run_name(cfg),
                           "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    start = max(i for i, r in enumerate(rows) if r["tag"] == "_run/start")
    return [r for r in rows[start:] if r["tag"].startswith("Faults/")]


def rule_outputs(updates, sizes, cfg, mask=None):
    """Every rule's aggregate of one round's updates (no noise)."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops import (
        aggregate)
    return {rule: aggregate.aggregate_updates(
        updates, sizes, cfg.replace(aggr=rule), mask=mask)
        for rule in ALL_RULES}


def rule_gap(rule, got, want):
    """(ok, text) of a card rule's aggregate against the CPU's, at the
    tests' tolerances: selections and sign votes equal; avg and trmean
    within 1e-6 of the aggregate's scale and 1e-6 relative L2; rfa within
    1e-5 relative L2."""
    g = torch.cat([got[k].cpu().reshape(-1) for k in want])
    w = torch.cat([want[k].reshape(-1) for k in want])
    diff = float((g - w).abs().max())
    rel = float((g - w).norm() / w.norm())
    if rule in ("comed", "krum", "sign"):
        return bool(torch.equal(g, w)), f"{rule} max|diff| {diff:.1e}"
    if rule == "rfa":
        return rel < 1e-5, f"{rule} rel L2 {rel:.2e}"
    return (diff <= 1e-6 * float(w.abs().max()) and rel < 1e-6,
            f"{rule} max|diff| {diff:.2e} rel L2 {rel:.2e}")


def cpu_rules(updates, sizes, cfg, rules):
    """A worker thread computing `rules` on a CPU copy of the updates (the
    copy made here, before it starts); the future gives {rule: aggregate}.
    torch's CPU kernels release the interpreter lock, so the card's work
    goes on meanwhile; they run on half the cores, leaving the rest to the
    thread that launches the card's work."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops import (
        aggregate)
    cpu = {k: v.cpu() for k, v in updates.items()}
    cpu_sizes = sizes.cpu()

    def work():
        threads = torch.get_num_threads()
        torch.set_num_threads(max(1, threads // 2))
        try:
            return {rule: aggregate.aggregate_updates(
                cpu, cpu_sizes, cfg.replace(aggr=rule)) for rule in rules}
        finally:
            torch.set_num_threads(threads)
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    future = pool.submit(work)
    pool.shutdown(wait=False)
    return future


def check_rules(label, params, updates, sizes, cfg, cpu_future):
    """One round's real updates on the card: each masked rule (and the
    masked vote) under an all-ones mask against its dense rule, bit for
    bit; each rule `cpu_future` computed on a CPU copy (`cpu_rules`)
    against the same rule on the card; each rule's server step (vote +
    rule + apply) between CUDA events, and the sort comed and trmean make
    alone."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.faults import (
        masking)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        rounds)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops import (
        aggregate)

    m = sizes.shape[0]
    t0 = time.perf_counter()
    ones = torch.ones(m, dtype=torch.bool, device=DEVICE)
    dense = rule_outputs(updates, sizes, cfg)
    masked = rule_outputs(updates, sizes, cfg, ones)
    for rule in ALL_RULES:
        for k in params:
            if not torch.equal(masked[rule][k], dense[rule][k]):
                raise AssertionError(f"{label}: masked {rule} under an "
                                     f"all-ones mask left the dense rule "
                                     f"at {k}")
    thr = float(cfg.robustLR_threshold)
    vote = aggregate.robust_lr(updates, thr, 1.0)
    mvote = aggregate.robust_lr(updates, masking.rlr_threshold(cfg, ones),
                                1.0, mask=ones)
    if not all(torch.equal(vote[k], mvote[k]) for k in vote):
        raise AssertionError(f"{label}: the masked vote left the dense one")
    del masked, vote, mvote
    log(f"[rules] {label}: every masked rule (avg, sign, comed, trmean, "
        f"krum, rfa) and the masked RLR vote under an all-ones mask equal "
        f"the dense ones bit for bit ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    texts = []
    for rule, want in cpu_future.result().items():
        ok, text = rule_gap(rule, dense[rule], want)
        texts.append(text)
        if not ok:
            raise AssertionError(f"{label}: {rule} on the card left the "
                                 f"CPU's: {text}")
    log(f"[rules] {label}: card vs CPU on the same updates: "
        f"{'; '.join(texts)} (waited {time.perf_counter() - t0:.1f} s for "
        f"the CPU)")
    del dense
    times = {}
    reps = 20 if m <= 64 else 5
    for rule in ALL_RULES:
        c = cfg.replace(aggr=rule, use_fused=False)
        times[rule] = time_ms(lambda c=c: rounds.server_step(
            params, updates, sizes, c), lambda: None, reps=reps, warmup=2)
    times["avg (K1)"] = time_ms(lambda: rounds.server_step(
        params, updates, sizes, cfg.replace(aggr="avg")), lambda: None,
        reps=reps, warmup=2)

    def sort_alone():
        # comed's and trmean's torch.sort along the agents, leaf by leaf,
        # without the vote, the band or the apply
        for u in updates.values():
            torch.sort(u, dim=0)
    times["comed's sort alone"] = time_ms(sort_alone, lambda: None,
                                          reps=reps, warmup=2)
    n = sum(p.numel() for p in params.values())
    log(f"[rules] {label}: server step (RLR vote {thr:g} + rule + apply) "
        f"over m={m} x {n:,} values, median between CUDA events: "
        + ", ".join(f"{r} {t:.3f} ms" for r, t in times.items()))
    return times


def replay_vs_eager(label, cfg, st):
    """The captured round's replay against the eager round, two rounds
    from the seed, cuDNN deterministic: equal bit for bit."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        rounds)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils import (
        compile_cache)

    strict = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    _strict_numerics()
    try:
        out = {}
        for capture in (True, False):
            fn = rounds.make_round_fn(cfg, st["model"], st["norm"],
                                      st["images"], st["labels"],
                                      st["fed"].train.sizes, capture=capture)
            r = rounds.RoundRNG(cfg.seed + 11, DEVICE)
            replays = compile_cache.GRAPH_REPLAYS["round"]
            p, info = fn(st["params"], r)
            p, info = fn(p, r)
            out[capture] = ({k: v.clone() for k, v in p.items()},
                            {k: v.clone() for k, v in info.items()
                             if isinstance(v, torch.Tensor)},
                            compile_cache.GRAPH_REPLAYS["round"] - replays)
            del fn, p, info
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = strict
    same = all(torch.equal(out[True][0][k], v)
               for k, v in out[False][0].items())
    same_info = all(torch.equal(out[True][1][k], v)
                    for k, v in out[False][1].items())
    diff = max(float((out[True][0][k] - v).abs().max())
               for k, v in out[False][0].items())
    log(f"[rules] {label}: round 2 replayed vs eager (cuDNN deterministic):"
        f" params {'equal' if same else 'differ'} (max |diff| {diff:.1e}), "
        f"info lanes {'equal' if same_info else 'differ'} "
        f"({', '.join(sorted(out[True][1]))}); replays {out[True][2]} / "
        f"{out[False][2]}")
    if out[True][2] != 1 or out[False][2] != 0:
        raise AssertionError(f"{label}: the captured round did not replay")
    if not (same and same_info):
        raise AssertionError(f"{label}: the replayed round left the eager "
                             f"round")


def phase_rules(rlr_fused, record, st) -> None:
    """The robust rules and the fault model: the FMNIST attack + RLR run
    under comed, trmean, krum and rfa, under avg and comed with the
    fault regime (comed also chained) and under comed with a quarantine
    set, the Fed-EMNIST run host-sampled
    under comed and faults, then BASELINE.json config 4 (ResNet-9,
    m = 256) under comed and under krum, each through train.run with its
    counts read: K1
    never, every round after the first a replay; the Faults/* rows; the
    replay against the eager round; and the rules on one round's real
    updates at m = 10 and m = 256."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data.registry import (
        get_federated_data)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        common, rounds)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
        registry)

    st = st or round_setup()
    launches = 0
    for label, cfg in rules_fmnist_cfgs().items():
        s = drive(rlr_fused, f"rules {label}", cfg, k1=False)
        launches += s["launches"]
        if cfg.faults_enabled:
            rows = fault_rows_of(cfg)
            steps = sorted({r["step"] for r in rows})
            voters = [r["value"] for r in rows
                      if r["tag"] == "Faults/Effective_Voters"]
            if (steps != list(range(cfg.snap, cfg.rounds + 1, cfg.snap))
                    or len(rows) != 3 * len(steps)
                    or not all(0 <= v <= cfg.agents_per_round
                               for v in voters)):
                raise AssertionError(f"{label}: Faults/* rows {rows}")
            log(f"[rules] {label}: Faults/* rows at rounds {steps}: "
                + "; ".join(f"{r['tag']} {r['value']:g}" for r in rows))
    record["launches_by_path"]["rules"] = launches

    for label in ("comed", "comed+faults", "comed quarantine 0,3"):
        replay_vs_eager(f"fmnist {label}", rules_fmnist_cfgs()[label], st)

    cfg = st["cfg"]
    sampled = rounds.sample_agents(cfg, st["rng"].host).tolist()
    updates, _ = rounds.make_block_trainer(
        cfg, st["model"], st["norm"], st["images"], st["labels"],
        st["fed"].train.sizes)(st["params"], st["rng"], st["rng"].next_round(),
                               sampled, 0, len(sampled))
    sizes = torch.as_tensor(st["fed"].train.sizes[sampled], device=DEVICE)
    times10 = check_rules(f"CNN_MNIST m={len(sampled)}", st["params"],
                          updates, sizes, cfg,
                          cpu_rules(updates, sizes, cfg, ALL_RULES))
    del updates

    # one round's real updates at m = 256, eagerly; the CPU's comed and
    # krum on a copy of them run in a worker thread meanwhile the
    # config 4 runs go on the card
    t0 = time.perf_counter()
    cfg = config4_cfg("comed")
    fed = get_federated_data(cfg)
    model = registry.get_model(cfg.data, cfg.image_shape, arch=cfg.arch)
    norm = common.make_normalizer(fed.mean, fed.std, DEVICE)
    images = torch.from_numpy(fed.train.images).to(DEVICE)
    labels = torch.from_numpy(fed.train.labels).to(DEVICE, torch.int64)
    params = registry.init_params(model, cfg.seed, DEVICE)
    rng = rounds.RoundRNG(cfg.seed, DEVICE)
    sampled = rounds.sample_agents(cfg, rng.host).tolist()
    updates, _ = rounds.make_block_trainer(
        cfg, model, norm, images, labels, fed.train.sizes)(
            params, rng, rng.next_round(), sampled, 0, len(sampled))
    sizes = torch.as_tensor(fed.train.sizes[sampled], device=DEVICE)
    del images, labels, fed
    cpu256 = cpu_rules(updates, sizes, cfg, ("comed", "krum"))
    log(f"[rules] one eager ResNet-9 round's updates at m={len(sampled)} "
        f"for the checks, and their CPU copy: "
        f"{time.perf_counter() - t0:.1f} s, data built")

    launches = 0
    for aggr in ("comed", "krum"):
        cfg = config4_cfg(aggr)
        s = drive(rlr_fused, f"rules config4 {aggr}", cfg, k1=False)
        launches += s["launches"]
        log(f"[rules] config 4 ({aggr}, ResNet-9, m={cfg.agents_per_round},"
            f" {cfg.local_ep} x 1 steps of bs {cfg.bs} an agent, "
            f"--agent_chunk {cfg.agent_chunk}): "
            f"{1.0 / s['steady_rounds_per_sec']:.2f} s a round (round 2, a "
            f"replay, with its eval), the run's peak device memory "
            f"{s['peak_gib']:.2f} GiB, {s['seconds']:.1f} s in all")
    record["launches_by_path"]["rules config4"] = launches

    times256 = check_rules(f"ResNet-9 m={len(sampled)}", params, updates,
                           sizes, config4_cfg("comed"), cpu256)
    record["rules_ms"] = {"m10": times10, "m256": times256}
    del updates


# --- phase 14: the adversary surface -----------------------------------
# the attack registry's update strategies (boost, signflip) and its round
# schedule on the dense, host and (phase sharded) sharded rounds, DBA on
# CIFAR-10 and the defense telemetry; phase 15, JAX's acceptance pair
# (tests/test_attack.py:31-39, :216-231)

ATTACK_ROUNDS = 4           # the eager warm-up and three replays
ATTACK_DIR = "build/chip_smoke/logs_attack"


def attack_fmnist_cfgs():
    """The FMNIST attack + RLR run (threshold 4) under boost x8, under the
    clean anti-vote (signflip, poison_frac 0) and under the one-shot boost
    x8 of round 2 (JAX's `boost_oneshot` scenario, scripts/
    sweep_scenarios.py:92-94; boost 1 would leave round 2 unchanged). All
    agents train as one block: --agent_chunk 1's round is faster, but its
    eager warm-up and capture cost a 4-round run about 3x the time on the
    H100 (PERF.md)."""
    base = triple()["attack_rlr4"].replace(
        rounds=ATTACK_ROUNDS, snap=ATTACK_ROUNDS, log_dir=ATTACK_DIR)
    return {"boost8": base.replace(attack="boost", attack_boost=8.0),
            "signflip": base.replace(attack="signflip", poison_frac=0.0),
            "boost8 one-shot": base.replace(attack="boost",
                                            attack_boost=8.0,
                                            attack_start=2, attack_stop=3)}


def acceptance_cfg(thr):
    """JAX's acceptance pair (tests/test_attack.py:31-39, :216-231):
    synthetic data, 8 agents, 2 corrupt, poison_frac 1.0, boost x8, 10
    rounds, seed 1."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
        Config)
    return Config(data="synthetic", num_agents=8, bs=16, local_ep=2,
                  synth_train_size=512, synth_val_size=128, eval_bs=128,
                  rounds=10, snap=5, num_corrupt=2, poison_frac=1.0,
                  robustLR_threshold=thr, seed=1, attack="boost",
                  attack_boost=8.0, data_dir="/nonexistent_use_synthetic",
                  log_dir=ATTACK_DIR, device=DEVICE)


def attack_rounds(cfg, st, n, capture):
    """n rounds of cfg's round fn on the data of `st` from its params and
    RoundRNG(seed + 11): per round the params, the info tensors (clones)
    and the sampled ids; and the graph replays it made."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        rounds)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils import (
        compile_cache)
    fn = rounds.make_round_fn(cfg, st["model"], st["norm"], st["images"],
                              st["labels"], st["fed"].train.sizes,
                              capture=capture)
    rng = rounds.RoundRNG(cfg.seed + 11, DEVICE)
    replays = compile_cache.GRAPH_REPLAYS["round"]
    p, out = st["params"], []
    for _ in range(n):
        p, info = fn(p, rng)
        out.append(({k: v.clone() for k, v in p.items()},
                    {k: v.clone() for k, v in info.items()
                     if isinstance(v, torch.Tensor)}, info["sampled"]))
    return out, compile_cache.GRAPH_REPLAYS["round"] - replays


def eager_rounds(cfg, st, captured, rnds):
    """Round r of cfg's round fn, eagerly, for each r in rnds: from the
    params the captured run held before round r (st's params before round
    1), on its sampled ids and RoundRNG(seed + 11)'s draws of round r.
    Returns (params, info tensors, sampled) per round, as attack_rounds."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        rounds)
    fn = rounds.make_round_fn(cfg, st["model"], st["norm"], st["images"],
                              st["labels"], st["fed"].train.sizes,
                              capture=False)
    out = []
    for r in rnds:
        rng = rounds.RoundRNG(cfg.seed + 11, DEVICE)
        rng.round = r - 1
        p_prev = st["params"] if r == 1 else captured[r - 2][0]
        p, info = fn(p_prev, rng, sampled=captured[r - 1][2])
        out.append((p, {k: v.clone() for k, v in info.items()
                        if isinstance(v, torch.Tensor)}, info["sampled"]))
    return out


def scaled_stack(cfg, model, norm, images, labels, sizes_host, params, rnd,
                 sampled, seed):
    """Round rnd's updates for the sampled ids from RoundRNG(seed)'s slot
    draws with the rows the attack hits scaled (attack/registry.
    apply_update_attack on the round's attacked_slots), those slots, and
    the sizes, on the card."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.attack import (
        registry as attack_registry)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        rounds)
    rng = rounds.RoundRNG(seed, DEVICE)
    # trained as one block (--agent_chunk 1's eager steps are 3x slower);
    # the same draws, params and attacked slots
    updates, _ = rounds.make_block_trainer(
        cfg.replace(agent_chunk=0), model, norm, images, labels,
        sizes_host)(params, rng, rnd, sampled, 0, len(sampled))
    hits = attack_registry.attacked_slots(cfg, sampled, rnd)
    return (attack_registry.apply_update_attack(cfg, updates,
                                                hits.to(DEVICE)), hits,
            torch.as_tensor(sizes_host[sampled], device=DEVICE))


def k1_on_scaled(rlr_fused, label, params, updates, sizes, thr):
    """K1 on a scaled stack: against its plain version (k1_against_plain),
    then timed between CUDA events (L2 flushed before each) beside its
    byte bound and the plain version's time."""
    name = torch.cuda.get_device_name(0)
    rate = hbm_rate(name)
    err = k1_against_plain(rlr_fused, params, updates, sizes, thr)
    m = sizes.shape[0]
    wn = sizes.to(torch.float32) / sizes.to(torch.float32).sum()
    scratch = torch.empty(64 * 2 ** 20, device=DEVICE)     # 256 MB > L2

    def flush():
        scratch.zero_()

    def kernel_step():
        return rlr_fused.fused_rlr_avg_apply(params, updates, sizes, thr, 1.0)

    def plain_step():
        return {k: rlr_fused.rlr_fused_reference(
            updates[k].reshape(m, -1), wn, p.reshape(-1), thr, 1.0)
            for k, p in params.items()}
    n = sum(p.numel() for p in params.values())
    nbytes, nops = 4 * (m * n + m + 2 * n), 4 * m * n
    # between CUDA events only: late in this long process torch.profiler
    # has returned no kernel events (phases kernels and k1 shapes give
    # K1's device time at these shapes)
    k_ms = time_ms(kernel_step, flush, reps=20)
    p_ms = time_ms(plain_step, flush, reps=10)
    bound_ms = max(nbytes / rate, nops / FP32_FLOPS) * 1e3
    bound_by = "bytes" if nbytes / rate >= nops / FP32_FLOPS else "operations"
    log(f"[attack] K1 on the {label} scaled stack (m={m}, {len(params)} "
        f"leaves, n={n:,}; {name}): max |kernel - plain| {err:.3e} (sign "
        f"exact, avg within {TOL}); between CUDA events {k_ms:.4f} ms, "
        f"plain {p_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
        f"{nbytes / 1e6:.1f} MB)")
    return err, {"stack": label, "m": m, "n": n, "ms": k_ms,
                 "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def check_replay(label, eager, captured, first=2):
    """The captured rounds (from round `first` on: replays) against the
    eager rounds, bit for bit."""
    for r, ((pe, ie, se), (pc, ic, sc)) in enumerate(zip(eager, captured,
                                                         strict=True),
                                                     start=first):
        same = (se == sc and all(torch.equal(pc[k], v)
                                 for k, v in pe.items())
                and all(torch.equal(ic[k], v) for k, v in ie.items()))
        if not same:
            diff = max(float((pc[k] - v).abs().max()) for k, v in pe.items())
            raise AssertionError(f"{label}: replayed round {r} left the "
                                 f"eager round (max |diff| {diff:.1e})")


def defense_rows_of(cfg):
    """The Defense/* rows of the run's last start in its metrics.jsonl."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils.metrics import (
        run_name)
    with open(os.path.join(cfg.log_dir, run_name(cfg),
                           "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    start = max(i for i, r in enumerate(rows) if r["tag"] == "_run/start")
    return [r for r in rows[start:] if r["tag"].startswith("Defense/")]


@contextlib.contextmanager
def recording_folds():
    """Within the block, every ReputationTracker.fold call's (round, ids,
    rep_agree, rep_norm) is kept in the list `with` gives: the rows a run
    folded, for a replay through JAX's tracker on the CPU."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.obs import (
        reputation)
    cls, orig, calls = (reputation.ReputationTracker,
                        reputation.ReputationTracker.fold, [])

    def fold(tracker, round_id, ids, agrees, norms=None):
        calls.append([int(round_id), [int(i) for i in ids],
                      [float(a) for a in agrees],
                      None if norms is None else [float(n) for n in norms]])
        return orig(tracker, round_id, ids, agrees, norms)
    cls.fold = fold
    try:
        yield calls
    finally:
        cls.fold = orig


def suspicion_drill(label, s, calls):
    """JAX's acceptance drill of the reputation plane (tests/
    test_reputation.py:415-427) at the run's last boundary: the ranking,
    which never reads a corrupt flag, puts the corrupt agent (id 0) first,
    and its AUC against the ground truth is >= 0.9."""
    susp = s["suspicion"]
    log(f"[attack] {label}: reputation over {susp['rounds']} rounds "
        f"({len(calls)} folds): AUC {susp.get('auc')}, ranking "
        f"{susp['suspects'][:4]} (scores {susp['scores'][:4]}), "
        f"{susp['suspect_count']} suspects; round 4's rep_norm "
        f"{[round(n, 4) for n in calls[-1][3]]}, rep_agree "
        f"{[round(a, 4) for a in calls[-1][2]]} (ids {calls[-1][1]})")
    if (susp["mode"] != "dense" or susp["rounds"] != ATTACK_ROUNDS
            or len(calls) != ATTACK_ROUNDS):
        raise AssertionError(f"{label}: the tracker folded {susp}")
    if not (susp.get("auc", 0.0) >= 0.9 and susp["suspects"][0] == 0):
        raise AssertionError(f"{label}: the suspicion drill: {susp}")


def phase_attack(rlr_fused, record, st) -> None:
    """The adversary surface through train.run, each run's counts set to 0
    just before and read just after: FMNIST under boost x8, signflip and
    the one-shot boost (K1 once a round, three replays each; the
    suspicion drill on the first two), CIFAR-10
    DBA on CNN_CIFAR (m = 40), Fed-EMNIST host-sampled under signflip
    (m = 33), FMNIST signflip with full telemetry (K1 0 launches, every
    Defense/* row finite). Then each FMNIST round's replay against the
    eager round bit for bit (cuDNN deterministic), the one-shot rounds
    against the static round on the same draws, K1 on the scaled FMNIST,
    CIFAR-10 and Fed-EMNIST stacks against its plain version and its
    bound, and the DBA stamps of the corrupt agents."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch import (
        train)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.attack import (
        dba, patterns)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data.registry import (
        get_federated_data)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        common, rounds)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
        registry)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.obs import (
        telemetry)

    st = st or round_setup()
    t_phase = time.perf_counter()
    launches = 0
    fmnist = attack_fmnist_cfgs()
    folds = {}
    for label, cfg in fmnist.items():
        with recording_folds() as calls:
            s = drive(rlr_fused, f"attack {label}", cfg)
        launches += s["launches"]
        folds[label] = calls
        if label in ("boost8", "signflip"):
            suspicion_drill(label, s, calls)
    os.makedirs(ATTACK_DIR, exist_ok=True)
    with open(os.path.join(ATTACK_DIR, "rep_rows.json"), "w") as f:
        json.dump(folds, f)
    cfg_dba = cifar10_triple()["attack_rlr8"].replace(
        attack="dba", rounds=2, snap=2, log_dir=ATTACK_DIR)
    launches += drive(rlr_fused, "attack cifar10 dba", cfg_dba)["launches"]
    cfg_host = fedemnist_triple()["attack_rlr8"].replace(
        attack="signflip", host_sampled="on", rounds=2, snap=2,
        log_dir=ATTACK_DIR)
    launches += drive(rlr_fused, "attack fedemnist host signflip",
                      cfg_host)["launches"]
    cfg_tel = fmnist["signflip"].replace(rounds=2, snap=1, telemetry="full")
    drive(rlr_fused, "attack telemetry full", cfg_tel, k1=False)
    rows = defense_rows_of(cfg_tel)
    want = [(step, tag) for step in (1, 2)
            for tag in sorted(telemetry.tags(cfg_tel))]
    if (sorted((r["step"], r["tag"]) for r in rows) != want
            or not all(math.isfinite(r["value"]) for r in rows)):
        raise AssertionError(f"the Defense/* rows: {rows}")
    last = {r["tag"]: r["value"] for r in rows if r["step"] == 2}
    log(f"[attack] telemetry full, signflip: {len(rows)} Defense/* rows "
        f"over rounds 1-2, all finite; round 2: flip fraction "
        f"{last['Defense/LR_Flip_Fraction']:.4f}, margin mean "
        f"{last['Defense/Vote_Margin_Mean']:.4f}, cosine honest / corrupt "
        f"{last['Defense/Cosine_Honest_To_Agg']:.4f} / "
        f"{last['Defense/Cosine_Corrupt_To_Agg']:.4f}, update norm p50 / "
        f"max {last['Defense/Update_Norm_P50']:.4f} / "
        f"{last['Defense/Update_Norm_Max']:.4f}")

    log(f"[attack] the runs through train.run: "
        f"{time.perf_counter() - t_phase:.1f} s into the phase")

    # each replayed round against the eager round from the same params and
    # draws, and the one-shot schedule against the static round
    strict = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    _strict_numerics()
    timings, worst = [], 0.0
    try:
        for label, cfg in fmnist.items():
            n = 3 if cfg.attack_stop else 2
            captured, made = attack_rounds(cfg, st, n, capture=True)
            if made != n - 1:
                raise AssertionError(f"{label}: {made} replays")
            eager = eager_rounds(cfg, st, captured, range(2, n + 1))
            check_replay(f"attack {label}", eager, captured[1:])
            line = (f"[attack] {label}: {n - 1} replayed round(s) equal the "
                    f"eager rounds from the same params and draws bit for "
                    f"bit (cuDNN deterministic)")
            if cfg.attack_stop:
                static = eager_rounds(
                    cfg.replace(attack="static", attack_start=0,
                                attack_stop=0, attack_boost=1.0),
                    st, captured, range(1, n + 1))
                same = [all(torch.equal(p[k], v) for k, v in c[0].items())
                        for (p, _, _), c in zip(static, captured)]
                if same != [True, False, True]:
                    raise AssertionError(f"{label}: rounds equal to the "
                                         f"static round: {same}")
                line += ("; rounds 1 and 3 equal the static round on the "
                         "same draws, round 2 (the attack's) does not")
            log(line)
            # K1 on the round's scaled stack (round 2 for the one-shot)
            rnd = 2 if cfg.attack_stop else 1
            sampled = captured[rnd - 1][2]
            p_in = st["params"] if rnd == 1 else captured[rnd - 2][0]
            ups, hits, sizes = scaled_stack(
                cfg, st["model"], st["norm"], st["images"], st["labels"],
                st["fed"].train.sizes, p_in, rnd, sampled, cfg.seed + 11)
            if not bool(hits.any()):
                raise AssertionError(f"{label}: round {rnd} not attacked")
            err, t = k1_on_scaled(rlr_fused, f"FMNIST {label} round {rnd}",
                                  p_in, ups, sizes, 4.0)
            worst = max(worst, err)
            timings.append(t)
            del eager, captured, ups
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = strict
    log(f"[attack] the replay, schedule and FMNIST K1 checks: "
        f"{time.perf_counter() - t_phase:.1f} s into the phase")

    # CIFAR-10 DBA: the corrupt agents' stamps, and K1 on a scaled stack
    fed = get_federated_data(cfg_dba)
    full = patterns.build_stamp("cifar10", "plus", agent_idx=-1)
    masks = []
    for a in range(cfg_dba.num_corrupt):
        shard = dba.split_stamp(full, a, cfg_dba.num_corrupt).mask
        rows = fed.train.poison_mask[a]
        px = fed.train.images[a][rows]          # [n, 32, 32, 3] uint8
        if not rows.any() or (px[:, shard] != 0).any():
            raise AssertionError(f"agent {a}: its DBA shard is not stamped")
        outside = full.mask & ~shard
        if not (px[:, outside] != 0).any():
            raise AssertionError(f"agent {a}: the full plus is stamped")
        masks.append(shard)
    if (np.logical_or.reduce(masks) != full.mask).any() or sum(
            int(s.sum()) for s in masks) != int(full.mask.sum()):
        raise AssertionError("the DBA shards do not partition the plus")
    log(f"[attack] cifar10 dba: the {cfg_dba.num_corrupt} corrupt agents' "
        f"poisoned rows carry their round-robin shards of the "
        f"{int(full.mask.sum())}-pixel plus "
        f"({', '.join(str(int(s.sum())) for s in masks)} pixels), which "
        f"partition it; the poisoned val set the full plus")
    model = registry.get_model(cfg_dba.data, cfg_dba.image_shape)
    norm = common.make_normalizer(fed.mean, fed.std, DEVICE)
    images = torch.from_numpy(fed.train.images).to(DEVICE)
    labels = torch.from_numpy(fed.train.labels).to(DEVICE, torch.int64)
    params = registry.init_params(model, cfg_dba.seed, DEVICE)
    # the dba run's stack is unscaled; boost x8 scales it like FMNIST's
    c = cfg_dba.replace(attack="boost", attack_boost=8.0)
    sampled = rounds.sample_agents(c, rounds.RoundRNG(c.seed, DEVICE).host)
    ups, _, sizes = scaled_stack(c, model, norm, images, labels,
                                 fed.train.sizes, params, 1,
                                 sampled.tolist(), c.seed)
    err, t = k1_on_scaled(rlr_fused, "CNN_CIFAR dba + boost8", params, ups,
                          sizes, 8.0)
    worst, timings = max(worst, err), timings + [t]
    del fed, images, labels, ups
    log(f"[attack] the CIFAR-10 checks: {time.perf_counter() - t_phase:.1f} "
        f"s into the phase")

    # Fed-EMNIST: the host round's signflip stack (its sampled ids)
    fed = get_federated_data(cfg_host)
    model = registry.get_model(cfg_host.data, cfg_host.image_shape)
    norm = common.make_normalizer(fed.mean, fed.std, DEVICE,
                                  fed.raw_is_normalized)
    images = torch.from_numpy(fed.train.images).to(DEVICE)
    labels = torch.from_numpy(fed.train.labels).to(DEVICE, torch.int64)
    params = registry.init_params(model, cfg_host.seed, DEVICE)
    ids = train.sample_ids(cfg_host, 1).tolist()
    ups, hits, sizes = scaled_stack(cfg_host, model, norm, images, labels,
                                    fed.train.sizes, params, 1, ids,
                                    cfg_host.seed)
    log(f"[attack] fedemnist host round 1: {int(hits.sum())} of "
        f"{len(ids)} sampled users corrupt (rows scaled by -1)")
    err, t = k1_on_scaled(rlr_fused, "Fed-EMNIST host signflip", params, ups,
                          sizes, 8.0)
    worst, timings = max(worst, err), timings + [t]
    del fed, images, labels, ups
    record["max_abs_err"] = max(record.get("max_abs_err", 0.0), worst)
    record["attack_stacks"] = timings
    log(f"[attack] the Fed-EMNIST checks: {time.perf_counter() - t_phase:.1f}"
        f" s into the phase")

    record["launches_by_path"]["attack"] = launches
    log(f"[attack] phase time {time.perf_counter() - t_phase:.1f} s")


def poison_at(cfg, rnd: int) -> float:
    """The Poison/Poison_Accuracy row of round rnd in the metrics.jsonl of
    cfg's last run (the rows after its last _run/start)."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils.metrics import (
        run_name)
    with open(os.path.join(cfg.log_dir, run_name(cfg), "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    start = max(i for i, r in enumerate(rows) if r["tag"] == "_run/start")
    return next(r["value"] for r in rows[start:]
                if r["tag"] == "Poison/Poison_Accuracy" and r["step"] == rnd)


def phase_acceptance(rlr_fused, record) -> None:
    """JAX's acceptance pair with its exact config (tests/test_attack.py:
    216-231) through train.run, under cuDNN's deterministic kernels (TF32
    off). Held: plain FedAvg lets the boosted backdoor in, poison accuracy
    >= 0.8 at the round-5 boundary (an attack that did nothing stays near
    0 there), and RLR 4 keeps it out, <= 0.1 at round 10 (JAX's bound).
    JAX's other bound, >= 0.8 through plain FedAvg at round 10, is printed
    and not held: the undefended model degenerates between rounds 5 and
    10, and the outcome at round 10 turns on the run's random draws in
    both packages (PERF.md §6-§7, ROADMAP queue 3 item 3)."""
    strict = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    _strict_numerics()
    try:
        accs, launches = {}, 0
        for thr in (0, 4):
            cfg = acceptance_cfg(thr)
            s = drive(rlr_fused, f"acceptance thr {thr}", cfg)
            accs[thr] = (poison_at(cfg, 5), s["poison_acc"])
            launches += s["launches"]
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = strict
    record["launches_by_path"]["acceptance"] = launches
    log(f"[acceptance] JAX's acceptance pair (tests/test_attack.py:216-231;"
        f" synthetic, 8 agents, 2 corrupt, boost x8, 10 rounds, seed 1; "
        f"cuDNN deterministic): poison accuracy at rounds 5 / 10 through "
        f"plain FedAvg {accs[0][0]:.4f} (bound >= 0.8) / {accs[0][1]:.4f} "
        f"(JAX's bound >= 0.8, not held), under RLR 4 {accs[4][0]:.4f} / "
        f"{accs[4][1]:.4f} (bound <= 0.1)")
    if not (accs[0][0] >= 0.8 and accs[4][1] <= 0.1):
        raise AssertionError(f"the acceptance pair (rounds 5, 10): {accs}")


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def sharded_cfg():
    return triple()["attack_rlr4"].replace(
        rounds=SHARDED_ROUNDS, snap=SHARDED_ROUNDS,
        log_dir="build/chip_smoke/logs_sharded")


def parity_setup(cfg, device):
    """Data, model, normalizer and the round's init params on `device`."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data.registry import (
        get_federated_data)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        common)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
        registry)
    fed = get_federated_data(cfg)
    model = registry.get_model(cfg.data, cfg.image_shape)
    return dict(fed=fed, model=model,
                norm=common.make_normalizer(fed.mean, fed.std, device),
                images=torch.from_numpy(fed.train.images).to(device),
                labels=torch.from_numpy(fed.train.labels).to(device,
                                                             torch.int64),
                params0=registry.init_params(model, cfg.seed, device))


def parity_variants(cfg):
    return {f"{aggr}+rlr{thr}": cfg.replace(aggr=aggr, robustLR_threshold=thr)
            for aggr, thr in (("avg", 4), ("avg", 0), ("sign", 4))}


def _strict_numerics() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def sharded_rank(rank: int, world: int, port: int) -> None:
    """One rank of the sharded phase (a spawned process on cuda:0, gloo):
    the sharded attack + RLR run through train.run with its counts set to
    0 just before and read just after, one timed and (on rank 0) profiled
    round, then round 1 again from the seed and its updates through the
    sharded server step, saved for the parent's comparisons."""
    import datetime

    import torch.distributed as dist

    from defending_against_backdoors_with_robust_learning_rate_tpu_torch import (
        train)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        rounds)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops import (
        rlr_fused)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel import (
        rounds as prounds)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.mesh import (
        AgentsGroup)

    _strict_numerics()
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        group = AgentsGroup(dist.group.WORLD, "cuda:0")
        rlr_fused.build()
        cfg = sharded_cfg()
        for k in rlr_fused.LAUNCHES:
            rlr_fused.LAUNCHES[k] = 0
        group.reset_counts()
        summary = train.run(cfg, group=group)
        out = {"launches": dict(rlr_fused.LAUNCHES), "calls": group.calls,
               "summary": {k: v for k, v in summary.items()
                           if k != "params"}}

        st = parity_setup(cfg, group.device)
        round_fn = prounds.make_sharded_round_fn(
            cfg, st["model"], st["norm"], group, st["images"], st["labels"],
            st["fed"].train.sizes)
        params, rng = summary["params"], rounds.RoundRNG(cfg.seed + 7,
                                                         group.device)
        # host time inside the all_reduces (gloo blocks the host; the
        # wait for the slowest rank is in it)
        group.reset_counts()
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, _ = round_fn(params, rng)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out["round_ms"] = walls
        out["all_reduce_ms"] = (group.seconds["all_reduce"] * 1e3
                                / len(walls))
        if rank == 0:
            out["profile"] = profile_round(lambda: round_fn(params, rng))
        else:
            round_fn(params, rng)

        # round 1 from the seed, as the dense round runs it in the parent
        p1, info1 = round_fn(st["params0"], rounds.RoundRNG(cfg.seed,
                                                            group.device))
        # the same round's updates through the sharded server step
        rng = rounds.RoundRNG(cfg.seed, group.device)
        rnd = rng.next_round()
        sampled = rounds.sample_agents(cfg, rng.host).tolist()
        mb = cfg.agents_per_round // world
        lo, hi = rank * mb, (rank + 1) * mb
        updates, _ = rounds.make_block_trainer(
            cfg, st["model"], st["norm"], st["images"], st["labels"],
            st["fed"].train.sizes)(st["params0"], rng, rnd, sampled, lo, hi)
        sizes = torch.as_tensor(st["fed"].train.sizes[sampled[lo:hi]],
                                device=group.device)
        steps = {label: prounds.sharded_server_step(st["params0"], updates,
                                                    sizes, c, group)
                 for label, c in parity_variants(cfg).items()}
        cpu = lambda t: {k: v.cpu() for k, v in t.items()}  # noqa: E731
        out.update(sampled=sampled, updates=cpu(updates),
                   train_loss1=float(info1["train_loss"]))

        # one signflip round (the adversary surface): this rank scales its
        # block of the round's rows, and K2 reads the scaled block; its
        # launches and all_reduces read around the round
        out["attack"] = signflip_round(rlr_fused, cfg, st, group, updates,
                                       sizes, sampled, lo, hi)
        # the server surface on the same saved block, then its 2-round run
        out["variants"] = server_variants(cfg, st, group, updates, sizes,
                                          sampled, keep=rank == 0)
        out["bucket_run"] = bucket_run(rlr_fused, cfg, group)
        if rank == 0:
            out.update(params1=cpu(p1),
                       steps={k: cpu(v) for k, v in steps.items()})
        torch.save(out, f"{SHARDED_DIR}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def signflip_round(rlr_fused, cfg, st, group, updates, sizes, sampled, lo,
                   hi):
    """One sharded round 1 from the seed under --attack signflip on this
    rank: its K2 launches, all_reduces and loss; and K2 on this rank's
    scaled block of the same round's updates against its plain version."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.attack import (
        registry as attack_registry)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        rounds)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel import (
        rounds as prounds)

    c = cfg.replace(attack="signflip")
    round_fn = prounds.make_sharded_round_fn(
        c, st["model"], st["norm"], group, st["images"], st["labels"],
        st["fed"].train.sizes)
    for k in rlr_fused.LAUNCHES:
        rlr_fused.LAUNCHES[k] = 0
    calls = group.calls
    new, info = round_fn(st["params0"], rounds.RoundRNG(cfg.seed,
                                                        group.device))
    torch.cuda.synchronize()
    res = {"k2": rlr_fused.LAUNCHES["rlr_partial"],
           "calls": group.calls - calls,
           "k1": rlr_fused.LAUNCHES["rlr_fused"],
           "train_loss": float(info["train_loss"]),
           "finite": all(bool(torch.isfinite(v).all())
                         for v in new.values())}
    hits = attack_registry.attacked_slots(c, sampled, 1)[lo:hi]
    block = attack_registry.apply_update_attack(c, updates,
                                                hits.to(group.device))
    us = [block[k].reshape(hi - lo, -1) for k in st["params0"]]
    w = sizes.to(torch.float32)
    wn = w / (w.sum() * group.size)
    offsets, total = rlr_fused.packed_offsets(tuple(u.shape[1] for u in us))
    buf = torch.empty(2 * total, device=group.device)
    rlr_fused.rlr_partial_leaves(us, wn, buf, offsets, total, 0)
    err = 0.0
    for u, o in zip(us, offsets):
        n = u.shape[1]
        want_s, want_w = rlr_fused.rlr_partial_reference(u, wn)
        torch.testing.assert_close(buf[total + o:total + o + n], want_s,
                                   atol=0, rtol=0)
        torch.testing.assert_close(buf[o:o + n], want_w, atol=TOL, rtol=TOL)
        err = max(err, float((buf[o:o + n] - want_w).abs().max()))
    res.update(k2_err=err, negated=int(hits.sum()))
    return res


VARIANT_SEED = 17           # the variants' noise generator, every side
BUCKET_RUN_ROUNDS = 2


def variant_cfgs(cfg, cap: float):
    """The sharded server surface's variants of the attack + RLR 4 config:
    the transpose rules, the noise, the bucket layout, a fault draw with
    a payload cap and a quarantine set, and full telemetry on both
    layouts."""
    out = {rule: cfg.replace(aggr=rule)
           for rule in ("comed", "trmean", "krum", "rfa")}
    out.update({
        "avg noise": cfg.replace(noise=0.001),
        "avg bucket": cfg.replace(agg_layout="bucket"),
        "sign bucket": cfg.replace(aggr="sign", agg_layout="bucket"),
        "avg faults quarantine": cfg.replace(
            dropout_rate=0.3, payload_norm_cap=cap, quarantine="0"),
        "avg telemetry": cfg.replace(telemetry="full"),
        "avg bucket telemetry": cfg.replace(agg_layout="bucket",
                                            telemetry="full")})
    return out


def variant_inputs(c, params, sampled, device):
    """A variant's (noise, fault draw, presence mask, corrupt flags), the
    same on every rank and in the parent: the noise from VARIANT_SEED on
    the card, a fixed draw (slots 3 and 8 dropped), the quarantine of the
    sampled ids, the corrupt flags under full telemetry."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.faults import (
        model as fmodel)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        rounds)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.health import (
        sentinel)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops.aggregate import (
        draw_noise)

    noise = draw_noise(params, c, torch.Generator(device=device).manual_seed(
        VARIANT_SEED))
    draw = None
    if c.faults_enabled:
        m = len(sampled)
        participate = torch.ones(m, dtype=torch.bool)
        participate[[3, 8]] = False
        draw = fmodel.draw_to(fmodel.FaultDraw(
            participate, torch.zeros(m, dtype=torch.bool),
            torch.full((m,), c.local_ep, dtype=torch.int32),
            torch.zeros(m, dtype=torch.bool)), device)
    qmask = sentinel.quarantine_mask(c, torch.as_tensor(sampled,
                                                        device=device))
    flags = (rounds.corrupt_slots(c, sampled).to(device)
             if c.telemetry == "full" else None)
    return noise, draw, qmask, flags


def server_variants(cfg, st, group, updates, sizes, sampled, keep):
    """Each variant's sharded server step on this rank's saved block: its
    collectives by kind, the host time inside them, its wall, its
    Faults/* and Defense/* values, and (`keep`) its new params. The
    payload cap sits between the 8th and 9th largest of the round's
    update norms (one all_gather before the counted steps), so the two
    largest payloads are rejected."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl.diagnostics import (
        per_agent_norms)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel import (
        rounds as prounds)

    norms = sorted(group.all_gather(per_agent_norms(updates)).tolist())
    cap = 0.5 * (norms[-3] + norms[-2])
    res = {"cap": cap}
    for label, c in variant_cfgs(cfg, cap).items():
        noise, draw, qmask, flags = variant_inputs(c, st["params0"], sampled,
                                                   group.device)
        group.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, info, _, _ = prounds.sharded_server_path(
            st["params0"], updates, sizes, c, group, noise, draw, qmask,
            flags)
        torch.cuda.synchronize()
        res[label] = {
            "ms": (time.perf_counter() - t0) * 1e3,
            "counts": dict(group.counts),
            "seconds": dict(group.seconds),
            "info": {k: v.cpu() for k, v in info.items()},
            "new": {k: v.cpu() for k, v in new.items()} if keep else None}
    return res


def bucket_run(rlr_fused, cfg, group):
    """The 2-round run under --agg_layout bucket --telemetry full
    --dropout_rate 0.2 --quarantine 0 through train.run on this rank,
    its counts set to 0 just before and read just after."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch import (
        train)

    c = cfg.replace(rounds=BUCKET_RUN_ROUNDS, snap=BUCKET_RUN_ROUNDS,
                    agg_layout="bucket", telemetry="full", dropout_rate=0.2,
                    quarantine="0",
                    log_dir="build/chip_smoke/logs_sharded_bucket")
    for k in rlr_fused.LAUNCHES:
        rlr_fused.LAUNCHES[k] = 0
    group.reset_counts()
    t0 = time.perf_counter()
    summary = train.run(c, group=group)
    return {"wall_s": time.perf_counter() - t0,
            "launches": dict(rlr_fused.LAUNCHES),
            "counts": dict(group.counts), "seconds": dict(group.seconds),
            "summary": {k: v for k, v in summary.items() if k != "params"}}


def check_variants(cfg, st, ranks, full, sizes):
    """The parent's side of `server_variants`: every variant on every rank
    against the plan, rank 0's params and values against the dense plain
    server step on the concatenated stack. Returns the lines to print."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        rounds)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel import (
        multihost)

    sampled = ranks[0]["sampled"]
    cap = ranks[0]["variants"]["cap"]
    lines = []
    for label, c in variant_cfgs(cfg, cap).items():
        plan = multihost.plan_collectives(c, st["params"], len(ranks))
        plan["all_reduce"] -= 1     # the loss's, outside the server step
        for r, out in enumerate(ranks):
            if out["variants"][label]["counts"] != plan:
                raise AssertionError(
                    f"{label}: rank {r} made {out['variants'][label]['counts']}"
                    f", the plan is {plan}")
        v = ranks[0]["variants"][label]
        noise, draw, qmask, flags = variant_inputs(c, st["params"], sampled,
                                                   DEVICE)
        want, winfo = rounds.server_path(
            st["params"], full, sizes, c.replace(health="off",
                                                 use_fused=False),
            noise, draw, qmask, flags)
        exact = c.aggr in ("sign", "comed", "krum")
        diff = 0.0
        for k, got in v["new"].items():
            got = got.to(DEVICE)
            if exact:
                torch.testing.assert_close(got, want[k], atol=0, rtol=0)
            torch.testing.assert_close(got, want[k], atol=TOL, rtol=TOL)
            diff = max(diff, float((got - want[k]).abs().max()))
        if set(v["info"]) != set(winfo) - {"hlth_nonfinite",
                                           "hlth_params_finite",
                                           "hlth_update_normsq",
                                           "hlth_agent_bad"}:
            raise AssertionError(f"{label}: info {sorted(v['info'])} "
                                 f"against {sorted(winfo)}")
        for k, got in v["info"].items():
            w = winfo[k].cpu()
            if k.startswith("fault_"):
                if not torch.equal(got, w):
                    raise AssertionError(f"{label}: {k} {got} against {w}")
            else:
                torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-6)
        secs = ", ".join(f"{n} {kind} {v['seconds'][kind] * 1e3:.2f} ms"
                         for kind, n in v["counts"].items() if n)
        lines.append(f"[sharded]   {label}: max |diff| {diff:.3e} "
                     f"({'exact' if exact else 'within ' + str(TOL)}); "
                     f"rank 0 {v['ms']:.2f} ms, inside {secs}"
                     + (f"; voters {float(v['info']['fault_voters']):.0f}"
                        if "fault_voters" in v["info"] else ""))
    return lines


def profile_round(fn):
    """Wall time of one call of fn under torch.profiler, this process's card
    busy time in it, its idle share, and the kernels taking the most."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, busy_ms = kernel_table(prof)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "kernels": sum(n for n, _ in by_name.values()),
            "top": sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]}


def run_children(target, args_list, timeout_s: float) -> None:
    """Start one spawned process per args tuple, wait for all within
    timeout_s, stop any left, and fail unless every one exited with 0."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=a) for a in args_list]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise AssertionError(f"child processes exited with {codes}")


def phase_sharded(rlr_fused, record, st) -> None:
    """d = 5 ranks, 2 agents each, as spawned processes on cuda:0 over gloo:
    the full-width attack + RLR run; its kernel launches and all_reduces;
    its round against the dense round; its server step against K1 on the
    same updates; rounds/s and one profiled rank's idle share."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        rounds)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel import (
        multihost)

    st = st or round_setup()
    os.makedirs(SHARDED_DIR, exist_ok=True)
    for f in os.listdir(SHARDED_DIR):
        os.remove(os.path.join(SHARDED_DIR, f))
    cfg = sharded_cfg()
    world = SHARDED_RANKS
    t0 = time.perf_counter()
    port = free_port()
    run_children(sharded_rank, [(r, world, port) for r in range(world)], 600)
    log(f"[sharded] {world} ranks x {M // world} agents on one card (gloo), "
        f"{cfg.rounds} rounds + 4 more: all exited 0 in "
        f"{time.perf_counter() - t0:.1f} s")
    ranks = [torch.load(f"{SHARDED_DIR}/rank{r}.pt") for r in range(world)]

    # the main path: every rank launched K2 once a round over every leaf,
    # never K1, and made the plan's all_reduces
    n_leaves = len(leaf_shapes())
    plan = multihost.leaf_plan_collectives(cfg)
    for r, out in enumerate(ranks):
        log(f"[sharded] rank {r}: {out['launches']} launches, "
            f"{out['calls']} all_reduces in {cfg.rounds} rounds")
        if out["launches"]["rlr_partial"] != cfg.rounds:
            raise AssertionError(f"rank {r} launched rlr_partial "
                                 f"{out['launches']['rlr_partial']} times, "
                                 f"expected {cfg.rounds}, one a round")
        if out["launches"]["rlr_fused"]:
            raise AssertionError(f"rank {r} launched K1 on the sharded path")
        if out["calls"] != cfg.rounds * plan:
            raise AssertionError(f"rank {r}: {out['calls']} all_reduces, "
                                 f"the plan makes {plan} a round")
    lead = ranks[0]["summary"]
    for key in ("train_loss", "val_acc", "val_loss", "poison_acc",
                "poison_loss", "rounds_per_sec"):
        if not math.isfinite(lead[key]):
            raise AssertionError(f"sharded run: {key} = {lead[key]}")
    if lead["hlth_nonfinite"] != 0 or lead["hlth_params_finite"] != 1:
        raise AssertionError(f"sharded run's health lanes: {lead}")
    round_ms = [statistics.mean(out["round_ms"]) for out in ranks]
    prof = ranks[0]["profile"]
    log(f"[sharded] {plan} all_reduces per round (the loss, the weight "
        f"total, one packed buffer of {n_leaves} leaves); rounds/s {lead['rounds_per_sec']:.3f} with eval "
        f"({lead['steady_rounds_per_sec']:.3f} after round 1), "
        f"{1e3 / max(round_ms):.3f} for two more rounds without eval "
        f"(slowest rank {max(round_ms):.1f} ms a round); train_loss "
        f"{lead['train_loss']:.4f}, val_acc {lead['val_acc']:.4f}, "
        f"poison_acc {lead['poison_acc']:.4f}, update norm "
        f"{math.sqrt(lead['hlth_update_normsq']):.4f}")
    reduce_ms = ", ".join(f"{out['all_reduce_ms']:.1f}" for out in ranks)
    log(f"[sharded] host time inside the {plan} all_reduces of a round, "
        f"ranks 0-{world - 1} (the wait for the slowest rank included): "
        f"{reduce_ms} ms")
    log(f"[sharded] profiled rank 0: wall {prof['wall_ms']:.1f} ms, its "
        f"kernels busy {prof['busy_ms']:.1f} ms in {prof['kernels']} "
        f"launches, idle share {1 - prof['busy_ms'] / prof['wall_ms']:.3f} "
        f"(this rank's own kernels; four more ranks share the card)")
    for name, (n, t) in prof["top"]:
        log(f"[sharded]   {t:9.2f} ms {n:6d}x  {name[:90]}")
    record["launches_by_path"] = {
        "sharded": sum(out["launches"]["rlr_partial"] for out in ranks)}

    # round 1 from the seed: sharded vs dense (same slot draws)
    if any(out["sampled"] != ranks[0]["sampled"] for out in ranks):
        raise AssertionError("ranks sampled different agents")
    strict = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    _strict_numerics()
    try:
        # the dense round trained in chunks of a rank's block: each agent
        # then goes through the same batched kernels as on its rank (48
        # steps of SGD would amplify the f32 differences of other group
        # sizes to the round's one-ulp spread, phase batched)
        dense1, dinfo = rounds.make_round_fn(
            cfg.replace(agent_chunk=M // world), st["model"], st["norm"],
            st["images"], st["labels"], st["fed"].train.sizes,
            capture=False)(st["params"], rounds.RoundRNG(cfg.seed, DEVICE))
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = strict
    diff = max(float((dense1[k].cpu() - v).abs().max())
               for k, v in ranks[0]["params1"].items())
    loss_rel = abs(ranks[0]["train_loss1"] - float(dinfo["train_loss"])) / abs(
        float(dinfo["train_loss"]))
    log(f"[sharded] round 1 from the seed, sharded vs dense in chunks of "
        f"{M // world} (the same slot draws, cuDNN deterministic, TF32 off): "
        f"max |params diff| "
        f"{diff:.3e} (tolerance {TOL}), train_loss rel diff {loss_rel:.3e} "
        f"(tolerance 1e-4)")
    # local training runs the same kernels on the same card; only the
    # server step's weighted sum is taken in another order
    if diff > TOL or loss_rel > 1e-4:
        raise AssertionError("the sharded round left the dense round")

    # the same updates: K2 + all_reduce + apply vs K1 on the whole stack
    sampled = ranks[0]["sampled"]
    full = {k: torch.cat([out["updates"][k] for out in ranks]).to(DEVICE)
            for k in ranks[0]["updates"]}
    sizes = torch.as_tensor(st["fed"].train.sizes[sampled], device=DEVICE,
                            dtype=torch.float32)
    worst = 0.0
    for label, c in parity_variants(cfg).items():
        k1 = rlr_fused.fused_rlr_avg_apply(
            st["params"], full, sizes, float(c.robustLR_threshold),
            c.effective_server_lr, mode=c.aggr)
        for k, v in ranks[0]["steps"][label].items():
            got = v.to(DEVICE)
            if c.aggr == "sign":
                torch.testing.assert_close(got, k1[k], atol=0, rtol=0)
            torch.testing.assert_close(got, k1[k], atol=TOL, rtol=TOL)
            worst = max(worst, float((got - k1[k]).abs().max()))
    log(f"[sharded] one round's real updates, K2 + all_reduce + apply on "
        f"{world} ranks vs K1 on the whole stack, avg+RLR4 / avg / "
        f"sign+RLR4: max |diff| {worst:.3e} (sign exact, avg within {TOL})")

    # the signflip round: K2 once on every rank, the plan's all_reduces,
    # the corrupt slot's rank negated its row, K2 on the scaled blocks
    atk = [out["attack"] for out in ranks]
    if (any(a["k2"] != 1 or a["k1"] or a["calls"] != plan
            or not a["finite"] for a in atk)
            or sum(a["negated"] for a in atk) != sum(
                1 for i in ranks[0]["sampled"] if i < cfg.num_corrupt)):
        raise AssertionError(f"the sharded signflip round: {atk}")
    k2_err = max(a["k2_err"] for a in atk)
    log(f"[sharded] signflip round 1 at d={world}: K2 1 launch and {plan} "
        f"all_reduces on every rank (the attack adds none), "
        f"{sum(a['negated'] for a in atk)} row(s) negated, train_loss "
        f"{atk[0]['train_loss']:.4f}; K2 on each rank's scaled block vs "
        f"its plain version: sign sums exact, weighted sums max |diff| "
        f"{k2_err:.3e} (tolerance {TOL})")
    record["launches_by_path"]["sharded signflip"] = sum(a["k2"]
                                                         for a in atk)
    record["max_abs_err"] = max(record.get("max_abs_err", 0.0), worst,
                                k2_err)

    # the server surface on the saved blocks: each variant against the
    # dense plain step on the whole stack and the plan, kind by kind
    lines = check_variants(cfg, st, ranks, full, sizes)
    log(f"[sharded] the server surface on round 1's saved blocks at "
        f"d={world} (payload cap {ranks[0]['variants']['cap']:.4f}) "
        f"against the dense plain step; every rank's collectives the "
        f"plan's, kind by kind:")
    for line in lines:
        log(line)

    # the 2-round bucket + telemetry + faults + quarantine run
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.obs import (
        telemetry)
    runs = [out["bucket_run"] for out in ranks]
    bcfg = cfg.replace(agg_layout="bucket", telemetry="full",
                       dropout_rate=0.2, quarantine="0")
    plan = multihost.plan_collectives(bcfg, st["params"], world)
    want = {k: n * BUCKET_RUN_ROUNDS for k, n in plan.items()}
    lead = runs[0]["summary"]
    for r, run in enumerate(runs):
        if any(run["launches"].values()):
            raise AssertionError(f"rank {r} launched {run['launches']} on "
                                 f"the bucket path")
        if run["counts"] != want:
            raise AssertionError(f"rank {r}: {run['counts']} in the bucket "
                                 f"run, the plan is {want}")
    for key in ("train_loss", "val_acc", "val_loss", "poison_acc",
                "poison_loss", "rounds_per_sec", "fault_voters"):
        if not math.isfinite(lead[key]):
            raise AssertionError(f"bucket run: {key} = {lead[key]}")
    defense = lead.get("defense", {})
    if (lead["hlth_nonfinite"] != 0 or lead["hlth_params_finite"] != 1
            or set(defense) != set(telemetry.telemetry_keys(bcfg))
            or not all(
                math.isfinite(x) for v in defense.values()
                for x in (v if isinstance(v, list) else [v]))):
        raise AssertionError(f"bucket run's lanes: {lead}")
    log(f"[sharded] bucket run ({BUCKET_RUN_ROUNDS} rounds, --agg_layout "
        f"bucket --telemetry full --dropout_rate 0.2 --quarantine 0): K1 "
        f"and K2 0 launches, {want} on every rank; rounds/s "
        f"{lead['rounds_per_sec']:.3f} with eval, {runs[0]['wall_s']:.1f} "
        f"s on rank 0; train_loss {lead['train_loss']:.4f}, voters "
        f"{lead['fault_voters']:.0f}, LR flip fraction "
        f"{defense['tel_flip_frac']:.4f}")
    for r, run in enumerate(runs):
        secs = ", ".join(f"{kind} {run['seconds'][kind] * 1e3:.1f} ms"
                         for kind, n in run["counts"].items() if n)
        log(f"[sharded]   rank {r}: host time inside the collectives of "
            f"its {BUCKET_RUN_ROUNDS} rounds: {secs}")
    record["launches_by_path"]["sharded bucket"] = sum(
        run["launches"]["rlr_partial"] for run in runs)


def nccl_child(port: int) -> None:
    """One round of the sharded run at d = 1 over NCCL, configured by the
    CLI flags a multi-card launch passes (--coordinator, --num_processes,
    --process_id, --mesh)."""
    import torch.distributed as dist

    from defending_against_backdoors_with_robust_learning_rate_tpu_torch import (
        train)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
        args_parser)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops import (
        rlr_fused)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel import (
        multihost)

    _strict_numerics()
    argv = ["--data", "fmnist", "--num_agents", str(M), "--local_ep", "2",
            "--bs", "256", "--num_corrupt", "1", "--poison_frac", "0.5",
            "--robustLR_threshold", "4", "--rounds", "1", "--snap", "1",
            "--synth_train_size", "60000", "--synth_val_size", "10000",
            "--log_dir", "build/chip_smoke/logs_nccl", "--mesh", "0",
            "--coordinator", f"localhost:{port}", "--num_processes", "1",
            "--process_id", "0"]
    for k in rlr_fused.LAUNCHES:
        rlr_fused.LAUNCHES[k] = 0
    try:
        summary = train.run(args_parser(argv))
        out = {"launches": dict(rlr_fused.LAUNCHES),
               "backend": dist.get_backend(),
               "summary": {k: v for k, v in summary.items()
                           if k != "params"}}
    finally:
        multihost.shutdown()
    torch.save(out, f"{SHARDED_DIR}/nccl.pt")


def phase_nccl() -> None:
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel import (
        multihost)

    run_children(nccl_child, [(free_port(),)], 300)
    out = torch.load(f"{SHARDED_DIR}/nccl.pt")
    s = out["summary"]
    plan = multihost.leaf_plan_collectives(sharded_cfg())
    log(f"[nccl] d=1 over {out['backend']}, one round: {out['launches']} "
        f"launches, {s['all_reduces']} all_reduces (plan {plan}), "
        f"train_loss {s['train_loss']:.4f}, val_acc {s['val_acc']:.4f}")
    if (out["backend"] != "nccl" or s["all_reduces"] != plan
            or out["launches"]["rlr_partial"] != 1
            or out["launches"]["rlr_fused"]
            or not math.isfinite(s["train_loss"])):
        raise AssertionError(f"the NCCL d=1 round: {out}")

# checkpoint and resume, the reputation lanes and the diagnostics (the
# state a checkpoint carries and its two producers)

STATE_DIR = "build/chip_smoke/state"
FISHER_TOL = 1e-4           # card vs CPU Fisher: relative L2 of the vector


def state_rows(cfg, first=1):
    """The rows of cfg's last life (after its last _run/start) from round
    `first` on, without the _run/start and Throughput/* rows."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils.metrics import (
        run_name)
    with open(os.path.join(cfg.log_dir, run_name(cfg), "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    start = max(i for i, r in enumerate(rows) if r["tag"] == "_run/start")
    return [r for r in rows[start:] if r["step"] >= first
            and not r["tag"].startswith(("_run/", "Throughput/"))]


def same_params(a, b):
    return all(torch.equal(a[k], v) for k, v in b.items())


def phase_state(rlr_fused, record, st) -> None:
    """The FMNIST attack + RLR 4 run (cuDNN deterministic; all agents as
    one block, as in attack_fmnist_cfgs): 4 rounds at --chain 2 --snap 2
    against 2 rounds and a --resume to 4 (params bit for bit, every row
    from round 3 on the same apart from _run/start and Throughput/*, K1
    once a round, Reputation/* rows written); the 4 rounds under
    --reputation off (the same params and training rows, no Reputation/*
    row); one round's rep lanes on the card against the CPU (agreement
    exact, norms 1e-6 relative) and their time; --diagnostics for 2
    rounds at snap 2 (K1 in round 1 only, finite Norms/* and Sign/*
    rows); the Fisher on the card against the CPU (FISHER_TOL) and its
    time; one save's time."""
    import shutil

    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        common, diagnostics, rounds)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl.evaluate import (
        pad_eval_set)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.obs import (
        reputation)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils import (
        checkpoint as ckpt)

    st = st or round_setup()
    t_phase = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    shutil.rmtree(STATE_DIR, ignore_errors=True)
    base = triple()["attack_rlr4"].replace(rounds=4, snap=2, chain=2)
    straight = base.replace(log_dir=f"{STATE_DIR}/logs_a",
                            checkpoint_dir=f"{STATE_DIR}/ck_a")
    cut = base.replace(rounds=2, log_dir=f"{STATE_DIR}/logs_b",
                       checkpoint_dir=f"{STATE_DIR}/ck_b")
    off = base.replace(reputation="off", log_dir=f"{STATE_DIR}/logs_off")
    diag = base.replace(rounds=2, chain=1, diagnostics=True,
                        log_dir=f"{STATE_DIR}/logs_diag")
    strict = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    _strict_numerics()
    try:
        runs = {"straight": drive(rlr_fused, "state straight 4", straight),
                "cut": drive(rlr_fused, "state cut at 2", cut)}
        runs["resumed"] = drive(rlr_fused, "state resumed to 4",
                                cut.replace(rounds=4, resume=True), ran=2)
        runs["off"] = drive(rlr_fused, "state reputation off", off)
        # 2 rounds at snap 2: round 1 the plain round's graph warms up
        # (K1), round 2 the diag round's (the plain server step)
        runs["diag"] = drive(rlr_fused, "state diagnostics", diag,
                             k1_expect=1, replays=0)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = strict
    launches = sum(s["launches"] for s in runs.values())
    log(f"[state] the runs through train.run: "
        f"{time.perf_counter() - t_phase:.1f} s into the phase; K1 "
        f"{launches} launches (4 + 2 + 2 + 4 + 1)")

    if ckpt.saved_rounds(cut.checkpoint_dir) != [2, 4]:
        raise AssertionError(
            f"checkpoints {ckpt.saved_rounds(cut.checkpoint_dir)}")
    if not same_params(runs["resumed"]["params"], runs["straight"]["params"]):
        raise AssertionError("the resumed run's params left the straight "
                             "run's")
    rows_a, rows_b = state_rows(straight, 3), state_rows(cut, 3)
    if rows_a != rows_b:
        diff = [(a, b) for a, b in zip(rows_a, rows_b) if a != b][:3]
        raise AssertionError(f"rows from round 3 differ: {diff} "
                             f"({len(rows_a)} / {len(rows_b)} rows)")
    rep_rows = [r for r in rows_a if r["tag"].startswith("Reputation/")]
    if not rep_rows:
        raise AssertionError("no Reputation/* rows")
    log(f"[state] resumed at round 2 to 4 (chain 2, snap 2) == 4 rounds "
        f"straight: params bit for bit, {len(rows_a)} rows of rounds 3-4 "
        f"the same ({len(rep_rows)} Reputation/*), K1 once a round in "
        f"both lives")
    training = [r for r in state_rows(straight)
                if not r["tag"].startswith("Reputation/")]
    if (state_rows(off) != training
            or not same_params(runs["off"]["params"],
                               runs["straight"]["params"])):
        raise AssertionError("--reputation off moved the training rows")
    log(f"[state] --reputation off: the same params and {len(training)} "
        f"training rows bit for bit, no Reputation/* row")

    # one round's stack: the lanes on the card against the CPU, timed
    cfg, params = base, st["params"]
    sampled = list(range(cfg.num_agents))
    updates, _ = rounds.make_block_trainer(
        cfg.replace(agent_chunk=0), st["model"], st["norm"], st["images"],
        st["labels"], st["fed"].train.sizes)(
            params, rounds.RoundRNG(cfg.seed, DEVICE), 1, sampled, 0,
            len(sampled))
    lanes = reputation.lanes(updates)
    want = reputation.lanes({k: v.cpu() for k, v in updates.items()})
    if not torch.equal(lanes["rep_agree"].cpu(), want["rep_agree"]):
        gap = (lanes["rep_agree"].cpu() - want["rep_agree"]).abs().max()
        raise AssertionError(f"rep_agree {lanes['rep_agree'].tolist()} vs "
                             f"{want['rep_agree'].tolist()} (max |diff| "
                             f"{float(gap):.3e})")
    norm_err = float(((lanes["rep_norm"].cpu() - want["rep_norm"]).abs()
                      / want["rep_norm"]).max())
    if norm_err > 1e-6:
        raise AssertionError(f"rep_norm {norm_err:.2e} relative")
    scratch = torch.empty(64 * 2 ** 20, device=DEVICE)

    def flush():
        scratch.zero_()
    lanes_ms = time_ms(lambda: reputation.lanes(updates), flush, reps=20)
    n = sum(v[0].numel() for v in updates.values())
    log(f"[state] rep lanes of one round's stack (m={len(sampled)}, "
        f"n={n:,}; {name}): agreement equal to the CPU's, norms within "
        f"{norm_err:.2e} relative; {lanes_ms:.4f} ms between CUDA events "
        f"(L2 flushed); rep_agree "
        f"{[round(a, 4) for a in want['rep_agree'].tolist()]}")
    del updates

    # --diagnostics: finite rows; the Fisher on the card against the CPU
    diag_rows = [r for r in state_rows(diag)
                 if r["tag"].startswith(("Norms/", "Sign/"))]
    if (len(diag_rows) != 9 or {r["step"] for r in diag_rows} != {2}
            or not all(math.isfinite(r["value"]) for r in diag_rows)):
        raise AssertionError(f"the diagnostics rows: {diag_rows}")
    fed = st["fed"]
    pval = [torch.from_numpy(a) for a in pad_eval_set(
        fed.pval_images, fed.pval_labels, cfg.eval_bs)]
    p_card = {k: v.clone() for k, v in runs["diag"]["params"].items()}
    fisher = diagnostics.make_fisher_fn(st["model"], st["norm"])
    fisher_cpu = diagnostics.make_fisher_fn(
        st["model"], common.make_normalizer(fed.mean, fed.std, "cpu"))
    card = [a.to(DEVICE) for a in pval]
    got = diagnostics.flat(fisher(p_card, *card)).cpu()
    want = diagnostics.flat(fisher_cpu({k: v.cpu() for k, v in
                                        p_card.items()}, *pval))
    fisher_err = float(torch.linalg.vector_norm(got - want)
                       / torch.linalg.vector_norm(want))
    if not fisher_err <= FISHER_TOL:
        raise AssertionError(f"the Fisher: {fisher_err:.2e} relative L2")
    fisher_ms = time_ms(lambda: fisher(p_card, *card), flush, reps=10,
                        warmup=2)
    save_s = []
    for i in range(5):
        t0 = time.perf_counter()
        ckpt.save(f"{STATE_DIR}/ck_timed", i + 1, p_card,
                  rounds.RoundRNG(0, DEVICE).state_dict(), 0.0)
        save_s.append(time.perf_counter() - t0)
    save_bytes = os.path.getsize(f"{STATE_DIR}/ck_timed/round_000001/"
                                 f"{ckpt.STATE_NAME}")
    sign = {r["tag"]: r["value"] for r in diag_rows}
    log(f"[state] --diagnostics, 2 rounds at snap 2 (K1 round 1 only; "
        f"{name}): Norms honest / corrupt "
        f"{sign['Norms/Avg_Honest_L2']:.4f} / "
        f"{sign['Norms/Avg_Corrupt_L2']:.4f}, Sign/Model_Net_L2_Cumulative "
        f"{sign['Sign/Model_Net_L2_Cumulative']:.4f}; the Fisher on the "
        f"card within {fisher_err:.2e} relative L2 of the CPU's "
        f"({pval[0].shape[0]} batch(es) of {cfg.eval_bs}), "
        f"{fisher_ms:.3f} ms a pass between CUDA events; one save "
        f"({save_bytes / 1e6:.2f} MB) median "
        f"{statistics.median(save_s) * 1e3:.2f} ms "
        f"(min {min(save_s) * 1e3:.2f})")
    steady = runs["straight"]["steady_rounds_per_sec"]
    log(f"[state] straight run steady {steady:.4f} rounds/s "
        f"({1e3 / steady:.1f} ms a round with eval); the lanes "
        f"{lanes_ms:.4f} ms")
    record["launches_by_path"]["state"] = launches
    log(f"[state] phase time {time.perf_counter() - t_phase:.1f} s")


POP_DIR = "build/chip_smoke/population"
# the cohort trains in groups of 64 agents: 64 x 256 rows at once keeps
# the batched step's activations near 15 GB of the card's 80
POP_CHUNK = 64
POP_PEAK_TOL = 0.01         # 100k run's peak device memory vs the 1M run's


def population_cfg(**kw):
    """The README's population run ("Population scaling") on the FMNIST
    stand-in at full width: 1M clients in a dirichlet(0.5) bank, 256-client
    cohorts, 2 local epochs at bs 256 (each client's 16 samples padded to
    one batch), FedAvg, the bank under POP_DIR."""
    return triple()["clean"].replace(
        num_agents=1_000_000, cohort_size=256, partitioner="dirichlet",
        dirichlet_alpha=0.5, agent_chunk=POP_CHUNK, rounds=4, snap=2,
        bank_dir=f"{POP_DIR}/bank_1m", log_dir=f"{POP_DIR}/logs").replace(
            **kw)


def pop_rows(cfg):
    """{(tag, step): value} of cfg's run (one life)."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils.metrics import (
        run_name)
    with open(os.path.join(cfg.log_dir, run_name(cfg), "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {(r["tag"], r["step"]): r["value"] for r in rows
            if not r["tag"].startswith("_run/")}


def phase_population(rlr_fused, record) -> None:
    """The population axis (slice 9), each run through `train.run` counted
    as `drive` counts it, cuDNN deterministic:

    1. the 1M-client dirichlet(0.5) bank built serially and with 2
       spawned workers (content_sha equal), reopened with --bank_verify;
       its build seconds, bytes on disk and one 256-client gather's time;
    2. the README run (1M clients, --cohort_size 256): 4 rounds at
       --chain 2 and at --chain 1, params bit for bit, one captured graph
       each, K1 0 launches (the cohort round carries its active mask);
    3. the same at 100k clients: peak device memory within 1% of the 1M
       run's;
    4. churn 0.1 and diurnal traffic at 1M (the 3-chunk draw): every
       member present, Churn/Sampled_Away counting only the shortfall,
       every row finite;
    5. an attack at 1M (10,000 corrupt, poison 0.5, RLR 8, --telemetry
       full): the cosine split follows each round's active corrupt
       members, the tracker in sketch mode; with --dropout_rate 1.0
       --faults_spare_corrupt the electorate is exactly those members;
    6. the equal cohort (FMNIST attack + RLR 4, K = m = 10,
       label_shards): the bank rows equal the dense stacks', and 2
       cohort rounds equal the dense round given the same ids, plain
       server step on both sides, bit for bit;
    7. the chained host round: Fed-EMNIST host-sampled attack + RLR 8, 4
       rounds at --chain 2 against --chain 1, params bit for bit, K1 once
       a round."""
    import shutil

    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data import (
        bank as bank_mod, cohort, registry, traffic)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.service import (
        churn)

    t_phase = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    shutil.rmtree(POP_DIR, ignore_errors=True)
    cfg = population_cfg()

    # 1. the bank: serial, 2 workers, reopened and verified
    train_ds, _, _ = registry.get_datasets(cfg)
    kw = dict(population=cfg.num_agents, partitioner=cfg.partitioner,
              samples_per_client=cfg.samples_per_client,
              dirichlet_alpha=cfg.dirichlet_alpha,
              classes_per_client=cfg.classes_per_client, seed=cfg.seed,
              n_classes=cfg.n_classes, shard_clients=cfg.bank_shard_clients)
    built = {}
    for label, workers in (("serial", 1), ("2 workers", 2)):
        path = cfg.bank_dir + ("" if workers == 1 else "_w2")
        t0 = time.perf_counter()
        bank, fresh = bank_mod.get_or_build(path, train_ds.labels,
                                            workers=workers, log=log, **kw)
        built[label] = (bank, time.perf_counter() - t0)
        assert fresh
    (serial, t_serial), (par, t_par) = built["serial"], built["2 workers"]
    if (serial.meta["content_sha"] != par.meta["content_sha"]
            or not np.array_equal(serial.offsets, par.offsets)):
        raise AssertionError("the 2-worker bank is not the serial one")
    t0 = time.perf_counter()
    reopened, fresh = bank_mod.get_or_build(cfg.bank_dir, train_ds.labels,
                                            verify=True, log=log, **kw)
    t_verify = time.perf_counter() - t0
    if fresh or reopened.meta != serial.meta:
        raise AssertionError("the reopened bank was rebuilt")
    nbytes = sum(os.path.getsize(os.path.join(cfg.bank_dir, f))
                 for f in os.listdir(cfg.bank_dir))
    ids, _ = cohort.sample_cohort(cfg, 1)
    max_n = serial.padded_max_n(cfg.bs)
    gather_s = []
    for _ in range(20):
        t0 = time.perf_counter()
        serial.gather(ids, train_ds.images, train_ds.labels, max_n)
        gather_s.append(time.perf_counter() - t0)
    log(f"[population] bank: {cfg.num_agents:,} clients dirichlet("
        f"{cfg.dirichlet_alpha}), {serial.meta['samples_per_client']} "
        f"samples a client, {serial.meta['n_shards']} shard files, "
        f"{nbytes / 1e6:.1f} MB on disk; built serially in {t_serial:.2f} s, "
        f"with 2 workers in {t_par:.2f} s (content_sha "
        f"{serial.meta['content_sha'][:16]} both); reopened and verified "
        f"in {t_verify:.2f} s; one {len(ids)}-client gather ([{len(ids)}, "
        f"{max_n}, 28, 28, 1] uint8) median "
        f"{statistics.median(gather_s) * 1e3:.2f} ms (min "
        f"{min(gather_s) * 1e3:.2f}) on the host")

    strict = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    _strict_numerics()
    runs = {}
    try:
        # 2. the README run, chained and not
        for chain in (2, 1):
            c = cfg.replace(chain=chain, bank_verify=chain == 1,
                            log_dir=f"{POP_DIR}/logs_c{chain}")
            runs[f"1m chain {chain}"] = drive(
                rlr_fused, f"population 1M chain {chain}", c, k1=False)
        # 3. a tenth of the population
        runs["100k"] = drive(rlr_fused, "population 100k", cfg.replace(
            num_agents=cfg.num_agents // 10,
            bank_dir=f"{POP_DIR}/bank_100k", rounds=2,
            log_dir=f"{POP_DIR}/logs_100k"), k1=False)
        # 4. churn and diurnal traffic at 1M
        churned = cfg.replace(churn_available=0.1, traffic="diurnal",
                              rounds=2, snap=1,
                              log_dir=f"{POP_DIR}/logs_churn")
        runs["churn"] = drive(rlr_fused, "population 1M churn + diurnal",
                              churned, k1=False)
        # 5. an attack at 1M, then its electorate alone
        attack = cfg.replace(num_corrupt=10_000, poison_frac=0.5,
                             robustLR_threshold=8, telemetry="full",
                             rounds=2, snap=1,
                             log_dir=f"{POP_DIR}/logs_attack")
        runs["attack"] = drive(rlr_fused, "population 1M attack", attack,
                               k1=False)
        electorate = attack.replace(dropout_rate=1.0,
                                    faults_spare_corrupt=True,
                                    log_dir=f"{POP_DIR}/logs_electorate")
        runs["electorate"] = drive(rlr_fused, "population 1M electorate",
                                   electorate, k1=False)
        # 6. the equal cohort against the dense round
        equal = equal_cohort_check(triple()["attack_rlr4"].replace(
            cohort_sampled="on", cohort_size=10, partitioner="label_shards",
            use_fused=False, bank_dir=f"{POP_DIR}/bank_10"))
        # 7. the chained host round
        host = fedemnist_triple()["attack_rlr8"].replace(
            host_sampled="on", host_prefetch=2, rounds=4, snap=2)
        for chain in (2, 1):
            runs[f"host chain {chain}"] = drive(
                rlr_fused, f"fedemnist host chain {chain}", host.replace(
                    chain=chain, log_dir=f"{POP_DIR}/logs_host_c{chain}"))
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = strict

    for label, s in runs.items():
        if s["captures"] != 1:
            raise AssertionError(f"{label}: {s['captures']} graphs captured")
    for a, b in (("1m chain 2", "1m chain 1"), ("host chain 2",
                                                "host chain 1")):
        if not same_params(runs[a]["params"], runs[b]["params"]):
            gap = max(float((runs[a]["params"][k] - v).abs().max())
                      for k, v in runs[b]["params"].items())
            raise AssertionError(f"{a} vs {b}: params differ by {gap:.3e}")
    log(f"[population] {cfg.num_agents:,} clients, 4 rounds: --chain 2 == "
        f"--chain 1, params bit for "
        f"bit, one captured graph each, K1 0 launches; Fed-EMNIST host: "
        f"--chain 2 == --chain 1 bit for bit, K1 once a round "
        f"({runs['host chain 2']['launches']} + "
        f"{runs['host chain 1']['launches']})")
    p1m, p100k = runs["1m chain 1"]["peak_gib"], runs["100k"]["peak_gib"]
    log(f"[population] peak device memory ({name}): 1M clients "
        f"{p1m:.3f} GiB, 100k {p100k:.3f} GiB (chain 2: "
        f"{runs['1m chain 2']['peak_gib']:.3f} GiB); steady rounds/s 1M "
        f"{runs['1m chain 1']['steady_rounds_per_sec']:.4f} (chain 2 "
        f"{runs['1m chain 2']['steady_rounds_per_sec']:.4f}), 100k "
        f"{runs['100k']['steady_rounds_per_sec']:.4f}")
    if abs(p100k - p1m) > POP_PEAK_TOL * p1m:
        raise AssertionError(f"peak memory 100k {p100k:.3f} vs 1M "
                             f"{p1m:.3f} GiB")

    # 4: members present, the away count the shortfall, rows finite
    per_chunk, n_chunks = cohort.draw_plan(churned)
    rows = pop_rows(churned)
    if not all(math.isfinite(v) for v in rows.values()):
        raise AssertionError("a non-finite row under churn")
    away = []
    for rnd in (1, 2):
        ids, active = cohort.sample_cohort(churned, rnd)
        if not (churn.active_slots(churned, ids[active], rnd).all()
                and traffic.present_slots(churned, ids[active], rnd).all()):
            raise AssertionError(f"round {rnd}: an absent member")
        away.append(rows[("Churn/Sampled_Away", rnd)])
        if away[-1] != float((~active).sum()):
            raise AssertionError(f"round {rnd}: Churn/Sampled_Away "
                                 f"{away[-1]} vs {(~active).sum()} padding")
    log(f"[population] churn 0.1 + diurnal at {churned.num_agents:,}: "
        f"{cohort.oversample_count(churned):,} candidates drawn in "
        f"{n_chunks} chunk(s) of {per_chunk:,}, every member "
        f"churn- and traffic-present, Churn/Sampled_Away {away} (the "
        f"shortfall), {len(rows)} rows finite")

    # 5: the cosine split and the electorate follow the active corrupt
    # members; the tracker folds real ids in sketch mode
    rows, erows = pop_rows(attack), pop_rows(electorate)
    members = []
    for rnd in (1, 2):
        ids, active = cohort.sample_cohort(attack, rnd)
        n = int(((ids < attack.num_corrupt) & active).sum())
        members.append(n)
        cos = rows[("Defense/Cosine_Corrupt_To_Agg", rnd)]
        voters = erows[("Faults/Effective_Voters", rnd)]
        if (cos != 0.0) != (n > 0) or (voters != n if n else voters > 1):
            raise AssertionError(f"round {rnd}: {n} corrupt members, "
                                 f"cosine {cos}, electorate {voters}")
    mode = runs["attack"]["suspicion"]["mode"]
    if mode != "sketch":
        raise AssertionError(f"the tracker in {mode} mode at 1M")
    log(f"[population] attack at 1M: active corrupt members per round "
        f"{members}, Defense/Cosine_Corrupt_To_Agg "
        f"{[round(rows[('Defense/Cosine_Corrupt_To_Agg', r)], 4) for r in (1, 2)]}, "
        f"electorate with dropout 1.0 sparing them "
        f"{[erows[('Faults/Effective_Voters', r)] for r in (1, 2)]}; "
        f"reputation tracker in {mode} mode, "
        f"{runs['attack']['suspicion']['clients']} clients tracked")
    log(f"[population] equal cohort (K = m = 10, label_shards, rounds "
        f"{equal}): bank rows == dense rows, cohort round == dense round "
        f"bit for bit")
    record["launches_by_path"]["population"] = sum(
        s["launches"] for k, s in runs.items() if not k.startswith("host"))
    record["launches_by_path"]["chain host"] = sum(
        s["launches"] for k, s in runs.items() if k.startswith("host"))
    log(f"[population] phase time {time.perf_counter() - t_phase:.1f} s")


def equal_cohort_check(cfg):
    """The equal cohort (JAX bench.py:845-851): at K = m with label_shards
    the cohort's bank rows are the dense stacks' rows, and the cohort round
    equals the dense round given the same ids, both eager with the plain
    server step, bit for bit, over the first 2 rounds whose cohort is
    whole. Returns those rounds."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data import (
        cohort, registry)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        common, rounds)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
        registry as models)

    dense_cfg = cfg.replace(cohort_sampled="off")
    fed = registry.get_federated_data(dense_cfg)
    src = registry.get_cohort_data(cfg)
    model = models.get_model(cfg.data, cfg.image_shape)
    norm = common.make_normalizer(fed.mean, fed.std, DEVICE)
    images = torch.from_numpy(fed.train.images).to(DEVICE)
    labels = torch.from_numpy(fed.train.labels).to(DEVICE, torch.int64)
    dense = rounds.make_round_fn(dense_cfg, model, norm, images, labels,
                                 fed.train.sizes, capture=False)
    coh = rounds.make_cohort_round_fn(cfg, model, norm, src.max_n, DEVICE,
                                      capture=False)
    p_dense = p_coh = models.init_params(model, cfg.seed, DEVICE)
    full = [r for r in range(1, 100)
            if cohort.sample_cohort(cfg, r)[1].all()][:2]
    for rnd in full:
        ids, active = cohort.sample_cohort(cfg, rnd)
        rows = src.gather_cohort(ids)
        for got, want in zip(rows, (fed.train.images[ids],
                                    fed.train.labels[ids],
                                    fed.train.sizes[ids]), strict=True):
            if not np.array_equal(got, want):
                raise AssertionError(f"round {rnd}: bank rows differ")
        rng_d, rng_c = (rounds.RoundRNG(cfg.seed, DEVICE) for _ in "dc")
        rng_d.round = rng_c.round = rnd - 1
        p_dense, _ = dense(p_dense, rng_d, sampled=ids.tolist())
        dev = [torch.from_numpy(a).to(DEVICE) for a in rows]
        p_coh, _ = coh(p_coh, rng_c, ids, dev[0], dev[1].to(torch.int64),
                       dev[2], active, rows[2])
        if not same_params(p_coh, p_dense):
            gap = max(float((p_coh[k] - v).abs().max())
                      for k, v in p_dense.items())
            raise AssertionError(f"round {rnd}: cohort round vs dense "
                                 f"round {gap:.3e}")
    return full


BUF_DIR = "build/chip_smoke/buffered"
BUF_TICKS = 4               # the eager warm-up and three replays
BUF_TIMED = 2               # ticks timed after the warm-up, per A/B cell


def buffered_carry(cfg, params):
    """cfg's buffer state joined to a copy of `params`: the buffered
    round's carry (fl/buffered.join_carry)."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        buffered)
    params = {k: v.clone() for k, v in params.items()}
    return buffered.join_carry(params, buffered.init_state(cfg, params))


def timed_ticks(cfg, st, n):
    """Ticks a second of cfg's captured round on st's data: one warm-up
    tick (eager, then the capture), then n ticks back to back, one sync
    at the end; and the K1 launches of all n + 1."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        buffered, rounds)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops import (
        rlr_fused)
    before = rlr_fused.LAUNCHES["rlr_fused"]
    fn = rounds.make_round_fn(cfg, st["model"], st["norm"], st["images"],
                              st["labels"], st["fed"].train.sizes)
    p = (buffered_carry(cfg, st["params"]) if buffered.is_buffered(cfg)
         else st["params"])
    rng = rounds.RoundRNG(cfg.seed + 17, DEVICE)
    p, _ = fn(p, rng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        p, _ = fn(p, rng)
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0), (rlr_fused.LAUNCHES["rlr_fused"]
                                            - before)


def fold_ms(cfg, m, n, flush):
    """One buffered fold (tick_contributions + fold_commit) at m agents
    over n f32 coordinates in one leaf, a third of the slots late by 1..S
    ticks, between CUDA events."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        buffered)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    params = {"w": torch.zeros(n, device=DEVICE)}
    updates = {"w": torch.randn(m, n, generator=gen, device=DEVICE)}
    sizes = torch.full((m,), 6000, device=DEVICE)
    mask = torch.ones(m, dtype=torch.bool, device=DEVICE)
    S = buffered.max_staleness(cfg)
    lat = torch.where(torch.arange(m, device=DEVICE) % 3 == 0,
                      torch.arange(m, device=DEVICE) % S + 1, 0).to(
        torch.int32)
    state = buffered.init_state(cfg, params)

    def fold():
        contribs = buffered.tick_contributions(cfg, updates, sizes, mask,
                                               lat)
        buffered.fold_commit(cfg, params, state, contribs, None, m)
    ms = time_ms(fold, flush, reps=10, warmup=2)
    del updates
    return ms


def phase_buffered(rlr_fused, record, st) -> None:
    """Buffered-async aggregation (slice 11) on the FMNIST attack + RLR 4
    run at full width and on the population configuration, each run
    counted as `drive` counts it (K1 0 launches: the buffer holds the
    updates until its commit):

    1. replay == eager: 4 ticks of the captured buffered round (K = m,
       --straggler_rate 0.3, exponent 0.5) against the same ticks run
       eagerly, params, buffer and info bit for bit (cuDNN
       deterministic), the ticks spanning a commit and pending arrivals;
    2. degenerate parity: K = m, no stragglers, exponent 0: buffered
       ticks == sync plain-step rounds, 2 bit for bit for --aggr sign, 1
       within 1e-6 relative for avg;
    3. the dense run (4 ticks, straggler 0.3, K = 2m) cut at tick 2
       between commits (arrivals held in the buffer, none committed) and
       resumed to 4 at --chain 1, through a commit, == straight at
       --chain 2 (params, buffer, rows from round 3 on);
    4. the population run (100k clients, 256-client cohorts, straggler
       0.3, K = m/2, 4 ticks) at --chain 2 == --chain 1, its ticks/s and
       peak device memory;
    5. the A/B of JAX's `bench.py --agg_mode both`: ticks/s of the
       captured round, sync against buffered at K = m, and at straggler
       0.3 and 0.5 with K = m/2 (sync cuts the stragglers' epochs,
       buffered delays their uploads);
    6. one fold's time at m = 10 and m = 256 over CNN_MNIST's
       coordinates."""
    import shutil

    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        buffered, rounds)

    st = st or round_setup()
    t_phase = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    shutil.rmtree(BUF_DIR, ignore_errors=True)
    base = triple()["attack_rlr4"].replace(agg_mode="buffered",
                                           log_dir=f"{BUF_DIR}/logs")
    m_main = base.agents_per_round
    launches = 0
    strict = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    _strict_numerics()
    try:
        # 1. the captured round against the eager one, across a commit
        cfg = base.replace(straggler_rate=0.3, async_staleness_exp=0.5)
        st_b = dict(st, params=buffered_carry(cfg, st["params"]))
        before = rlr_fused.LAUNCHES["rlr_fused"]
        captured, replays = attack_rounds(cfg, st_b, BUF_TICKS, True)
        eager = eager_rounds(cfg, st_b, captured, range(2, BUF_TICKS + 1))
        launches += rlr_fused.LAUNCHES["rlr_fused"] - before
        check_replay("buffered", eager, captured[1:])
        commits = [float(i["async_committed"]) for _, i, _ in captured]
        pend = sum(float(i["async_stale_hist"][1:].sum())
                   for _, i, _ in captured)
        if replays != BUF_TICKS - 1 or 1.0 not in commits or pend == 0:
            raise AssertionError(f"buffered replay: {replays} replays, "
                                 f"commits {commits}, {pend} late arrivals")
        log(f"[buffered] replay == eager ({name}): {BUF_TICKS} ticks, "
            f"{replays} replays, params, buffer and info bit for bit; "
            f"committed {commits}, fill "
            f"{[float(i['async_fill']) for _, i, _ in captured]}, late "
            f"arrivals {pend:.0f}")
        del captured, eager

        # 2. degenerate parity against the sync plain step
        gaps = {}
        for aggr in ("sign", "avg"):
            sync = triple()["attack_rlr4"].replace(aggr=aggr,
                                                   use_fused=False)
            buf = sync.replace(agg_mode="buffered")
            fns = [rounds.make_round_fn(c, st["model"], st["norm"],
                                        st["images"], st["labels"],
                                        st["fed"].train.sizes, capture=False)
                   for c in (sync, buf)]
            ps, pb = st["params"], buffered_carry(buf, st["params"])
            rs, rb = (rounds.RoundRNG(sync.seed + 13, DEVICE)
                      for _ in range(2))
            before = rlr_fused.LAUNCHES["rlr_fused"]
            # sign for 2 ticks (the buffer emptied and refilled), avg 1
            for _ in range(2 if aggr == "sign" else 1):
                ps, _ = fns[0](ps, rs)
                pb, info = fns[1](pb, rb)
                if float(info["async_committed"]) != 1.0:
                    raise AssertionError(f"{aggr}: no commit at K = m")
            launches += rlr_fused.LAUNCHES["rlr_fused"] - before
            gap = max(float(((pb[k] - v).abs().max()
                             / v.abs().max().clamp(min=1e-30)))
                      for k, v in ps.items())
            gaps[aggr] = gap
            if (aggr == "sign" and gap != 0.0) or gap > 1e-6:
                raise AssertionError(f"buffered {aggr} vs sync: {gap:.3e}")
        log(f"[buffered] K = m, no stragglers, exponent 0 ({name}): sign "
            f"== sync bit for bit over 2 ticks; avg within "
            f"{gaps['avg']:.3e} relative of sync after 1")

        # 3. the dense run: chained, cut and resumed; K = 2m, so tick 2
        # ends with a partly filled buffer and tick 3 or 4 commits
        dense = base.replace(straggler_rate=0.3, async_buffer_k=2 * m_main,
                             async_staleness_exp=0.5, snap=2)
        straight = dense.replace(log_dir=f"{BUF_DIR}/logs_a",
                                 checkpoint_dir=f"{BUF_DIR}/ck_a")
        cut = dense.replace(rounds=2, log_dir=f"{BUF_DIR}/logs_b",
                            checkpoint_dir=f"{BUF_DIR}/ck_b")
        # the straight run chained, the cut and resumed one not: resumed
        # == straight holds the chain and the resume at once
        runs = {"straight": drive(rlr_fused, "buffered straight chain 2",
                                  straight.replace(chain=2), k1=False),
                "cut": drive(rlr_fused, "buffered cut at 2", cut, k1=False)}
        runs["resumed"] = drive(rlr_fused, "buffered resumed to 4",
                                cut.replace(rounds=4, resume=True), ran=2,
                                k1=False)
        # 4. the population run
        pop = population_cfg(
            num_agents=100_000, bank_dir=f"{POP_DIR}/bank_100k",
            agg_mode="buffered", straggler_rate=0.3,
            async_buffer_k=128, log_dir=f"{BUF_DIR}/logs_pop")
        for chain in (2, 1):
            runs[f"pop chain {chain}"] = drive(
                rlr_fused, f"buffered population 100k chain {chain}",
                pop.replace(chain=chain), k1=False)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = strict
    launches += sum(s["launches"] for s in runs.values())

    def same_carry(a, b):
        return (same_params(a["params"], b["params"])
                and same_params(a["buffer"], b["buffer"]))
    for a, b in (("resumed", "straight"), ("pop chain 2", "pop chain 1")):
        if not same_carry(runs[a], runs[b]):
            raise AssertionError(f"buffered {a} vs {b}: params or buffer "
                                 f"differ")
    held = runs["cut"]["buffer"]
    if float(held["count"]) <= 0:
        raise AssertionError("the cut run's buffer holds no arrivals: it "
                             "was not cut between commits")
    if same_params(runs["cut"]["params"], runs["resumed"]["params"]):
        raise AssertionError("the resumed ticks committed nothing")
    rows_a, rows_b = state_rows(straight, 3), state_rows(cut, 3)
    if rows_a != rows_b or not any(r["tag"] == "Async/Buffer_Fill"
                                   for r in rows_a):
        raise AssertionError("the resumed run's rows left the straight "
                             "run's")
    for label, s in runs.items():
        for key in ("async_fill", "async_committed"):
            if not math.isfinite(s[key]):
                raise AssertionError(f"{label}: {key} = {s[key]}")
    log(f"[buffered] dense run, 4 ticks (straggler 0.3, K = 2m = "
        f"{2 * m_main}): cut at 2 between commits (the buffer held "
        f"{float(held['count']):.0f} arrivals and "
        f"{float(held['pend_cnt'].sum()):.0f} pending uploads) and resumed "
        f"at --chain 1 through a commit == straight at --chain 2: params "
        f"and buffer bit for bit, {len(rows_a)} rows of rounds 3-4 the "
        f"same")
    pop1 = runs["pop chain 1"]
    log(f"[buffered] population 100k, m = 256, K = 128, straggler 0.3 "
        f"({name}): --chain 2 == --chain 1 bit for bit; "
        f"{pop1['steady_rounds_per_sec']:.4f} steady ticks/s with eval "
        f"at snap 2 (chain 2 "
        f"{runs['pop chain 2']['steady_rounds_per_sec']:.4f}); "
        f"peak device memory {pop1['peak_gib']:.2f} / "
        f"{runs['pop chain 2']['peak_gib']:.2f} GiB")

    # 5. the A/B: ticks/s of the captured round
    ab = {}
    for label, cfg in (
            ("sync", triple()["attack_rlr4"]),
            ("buffered K=m", base),
            ("sync straggler 0.3", triple()["attack_rlr4"].replace(
                straggler_rate=0.3)),
            ("buffered K=m/2 straggler 0.3", base.replace(
                straggler_rate=0.3, async_buffer_k=m_main // 2)),
            ("sync straggler 0.5", triple()["attack_rlr4"].replace(
                straggler_rate=0.5)),
            ("buffered K=m/2 straggler 0.5", base.replace(
                straggler_rate=0.5, async_buffer_k=m_main // 2))):
        ab[label], k1 = timed_ticks(cfg, st, BUF_TIMED)
        if label.startswith("buffered"):
            launches += k1
            if k1:
                raise AssertionError(f"{label}: K1 launched {k1} times")
    log(f"[buffered] A/B, ticks (rounds) a second of the captured round, "
        f"{BUF_TIMED} timed after the warm-up ({name}): "
        + "; ".join(f"{k} {v:.4f}" for k, v in ab.items())
        + f"; buffered / sync at K = m {ab['buffered K=m'] / ab['sync']:.4f}")

    # 6. the fold alone
    scratch = torch.empty(64 * 2 ** 20, device=DEVICE)

    def flush():
        scratch.zero_()
    n = sum(v.numel() for v in st["params"].values())
    cfg = base.replace(straggler_rate=0.3, async_staleness_exp=0.5)
    folds = {m: fold_ms(cfg, m, n, flush) for m in (m_main, 256)}
    log(f"[buffered] one fold (S = {cfg.async_max_staleness}, pending, "
        f"n = {n:,}; {name}): "
        + ", ".join(f"m = {m} {ms:.4f} ms" for m, ms in folds.items()))
    if launches:
        raise AssertionError(f"K1 launched {launches} times on the "
                             f"buffered path")
    record["launches_by_path"]["buffered"] = launches
    log(f"[buffered] K1 launches on path buffered: {launches}; phase time "
        f"{time.perf_counter() - t_phase:.1f} s")


# every config field the federated data's build reads (data/registry.py,
# attack/dba.py, attack/patterns.py)
PRECISION_DIR = "build/chip_smoke/precision"
PRECISION_CHUNK = 10        # JAX's ResNet-9 rows: --remat --agent_chunk 10
# JAX's own bf16-to-f32 gap of one step's grads (relative L2), measured
# with the JAX package on the CPU (CNN_MNIST on [8,28,28,1], ResNet-9 on
# [4,32,32,3], seed 0): the scale the card's bf16 step is held to, within
# twice it (other inputs and batch sizes move the gap itself)
BF16_GRAD_GAP = {"CNN_MNIST": 2.0e-2, "ResNet9": 1.3e-1}


@contextlib.contextmanager
def cudnn_deterministic():
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def precision_cfgs():
    """BASELINE.json config 3 (resnet9_cfg) as JAX ran its ResNet-9 rows
    (scripts/run_baselines.py:298-317), under each remat policy and at
    bf16; and the FMNIST attack + RLR 4 run at bf16."""
    base = resnet9_cfg().replace(remat=True, agent_chunk=PRECISION_CHUNK,
                                 log_dir=f"{PRECISION_DIR}/logs")
    fm = triple()["attack_rlr4"].replace(dtype="bf16",
                                         log_dir=f"{PRECISION_DIR}/fmnist")
    return {"resnet9 remat block": base,
            "resnet9 remat conv": base.replace(remat_policy="conv"),
            "resnet9 remat bf16": base.replace(dtype="bf16"),
            "fmnist bf16": fm}


def batched_step(model, params, x, y):
    """One vmap(grad_and_value) step of the batched trainer's loss over the
    stacked [m, ...] params: (grads, losses)."""
    from torch.func import functional_call, grad_and_value, vmap

    def loss(p, x, y):
        return torch.nn.functional.cross_entropy(
            functional_call(model, p, (x,)), y)
    return vmap(grad_and_value(loss))(params, x, y)


def step_inputs(arch, data, image, m, seed=0):
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
        registry)
    model = registry.get_model(data, image, arch=arch)
    params = registry.init_params(model, seed, DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    h, w, c = image
    x = torch.randn((m, 256, c, h, w), generator=gen, device=DEVICE)
    y = torch.randint(0, 10, (m, 256), generator=gen, device=DEVICE)
    stacked = {k: v.expand((m,) + v.shape).clone() for k, v in params.items()}
    return stacked, x, y


def step_peak_gib(model, params, x, y):
    """Peak device memory of one batched step above what was held before
    it, and the step's median time (CUDA events, 5 reps)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    out = batched_step(model, params, x, y)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    del out
    ms = time_ms(lambda: batched_step(model, params, x, y), lambda: None,
                 reps=5, warmup=1)
    return peak, ms


def stash_and_peak_gib(model, params, x, y):
    """One agent's step through torch.func.vjp: (device memory the forward
    leaves live for the backward, peak of the backward above that)."""
    from torch.func import functional_call, vjp

    def loss(p):
        return torch.nn.functional.cross_entropy(
            functional_call(model, p, (x,)), y)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    out, pull = vjp(loss, params)
    torch.cuda.synchronize()
    stash = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = pull(torch.ones_like(out))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - stash
    del out, pull, grads
    return (stash - held) / 2 ** 30, peak / 2 ** 30


def phase_precision(rlr_fused, record) -> None:
    """Slice 10: the compute dtype, ResNet-9's remat, the metrics drain and
    the native host runtime, on BASELINE.json config 3 at full width
    (CIFAR-10 DBA, 40 agents all sampled, 4 corrupt, RLR 8, ResNet-9).
    Each run through train.run with its counts set to 0 just before and
    read just after (K1 once a round, every round after the first a
    replay): 2 rounds each of --remat --agent_chunk 10 (JAX's ResNet-9
    rows), the same with --remat_policy conv and at --dtype bf16; 4 rounds
    of the FMNIST attack + RLR 4 run at --dtype bf16 with the drain and
    with --sync_metrics (cuDNN deterministic: metrics.jsonl the same
    apart from the wall-clock rows). Then K1 against its plain version on
    the bf16 ResNet-9 round's updates (m = 40); one batched ResNet-9 step
    at m = 10 with block remat, conv remat and none (cuDNN deterministic:
    grads bit for bit), its time and peak memory, one agent's forward
    stash and backward peak, and at m = 40 with and without remat; each
    model's bf16 step against its f32 step within twice JAX's
    own bf16-to-f32 gap (BF16_GRAD_GAP); the native host runtime built from
    native/fl_host.cc on the card's host and its partition and pack of
    the FMNIST stand-in equal to the numpy twins', timed."""
    import shutil

    from defending_against_backdoors_with_robust_learning_rate_tpu_torch import (
        closing_check)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data import (
        arrays, native, partition)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data.registry import (
        get_datasets, get_federated_data)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
        common, rounds)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
        registry)

    shutil.rmtree(PRECISION_DIR, ignore_errors=True)
    # the native host runtime, built on this host from the checkout
    t0 = time.perf_counter()
    status = native.status()
    build_s = time.perf_counter() - t0
    if not status.startswith("native ("):
        raise AssertionError(f"native host runtime not used: {status}")
    fm = precision_cfgs()["fmnist bf16"]
    train_set = get_datasets(fm)[0]
    timed = {}
    for label, dist, pack in (("native", native.distribute_data,
                               native.pack_shards),
                              ("numpy", partition.distribute_data,
                               arrays.stack_agent_shards)):
        t0 = time.perf_counter()
        groups = dist(train_set.labels, fm.num_agents)
        t1 = time.perf_counter()
        shards = pack(train_set.images, train_set.labels, groups,
                      fm.num_agents, fm.bs)
        timed[label] = (groups, shards, t1 - t0, time.perf_counter() - t1)
    (g_n, s_n, *t_n), (g_p, s_p, *t_p) = timed["native"], timed["numpy"]
    if g_n != g_p or not all(np.array_equal(getattr(s_n, f), getattr(s_p, f))
                             for f in ("images", "labels", "sizes")):
        raise AssertionError("native partition or pack != numpy twins")
    log(f"[precision] native host runtime: {status}, loaded in "
        f"{build_s:.2f} s; FMNIST stand-in ({len(train_set)} samples, "
        f"K={fm.num_agents}): partition {t_n[0] * 1e3:.1f} ms native / "
        f"{t_p[0] * 1e3:.1f} ms numpy, pack {t_n[1] * 1e3:.1f} / "
        f"{t_p[1] * 1e3:.1f} ms, equal")

    card = closing_check.card()
    launches, runs = 0, {}
    for label, cfg in precision_cfgs().items():
        if label == "fmnist bf16":
            with cudnn_deterministic():
                s = drive(rlr_fused, f"precision {label}", cfg)
                launches += s["launches"]
                sync_cfg = cfg.replace(async_metrics=False,
                                       log_dir=f"{PRECISION_DIR}/fmnist_sync")
                s_sync = drive(rlr_fused, f"precision {label} sync",
                               sync_cfg)
                launches += s_sync["launches"]
            rows, rows_sync = state_rows(cfg), state_rows(sync_cfg)
            if rows != rows_sync or len(rows) < 14:
                raise AssertionError(
                    f"drain rows != --sync_metrics rows ({len(rows)} / "
                    f"{len(rows_sync)})")
            log(f"[precision] FMNIST bf16: metrics.jsonl with the drain == "
                f"with --sync_metrics, {len(rows)} rows (wall-clock rows "
                f"aside)")
        else:
            s = drive(rlr_fused, f"precision {label}", cfg)
            launches += s["launches"]
        runs[label] = s
    for label, s in runs.items():
        log(f"[precision] {label}: {s['steady_rounds_per_sec']:.4f} steady "
            f"rounds/s (eval included), run peak {s['peak_gib']:.2f} GiB, "
            f"val_acc {s['val_acc']:.4f}, poison_acc {s['poison_acc']:.4f} "
            f"({card})")
    record["launches_by_path"]["precision"] = launches

    # K1 on the bf16 ResNet-9 round's updates (the params stay f32)
    cfg = precision_cfgs()["resnet9 remat bf16"]
    fed = get_federated_data(cfg)
    norm = common.make_normalizer(fed.mean, fed.std, DEVICE)
    images = torch.from_numpy(fed.train.images).to(DEVICE)
    labels = torch.from_numpy(fed.train.labels).to(DEVICE, torch.int64)
    model = registry.get_model(cfg.data, cfg.image_shape, arch=cfg.arch,
                               dtype=cfg.dtype, remat=True)
    params = registry.init_params(model, cfg.seed, DEVICE)
    rng = rounds.RoundRNG(cfg.seed, DEVICE)
    sampled = rounds.sample_agents(cfg, rng.host).tolist()
    updates, _ = rounds.make_block_trainer(
        cfg, model, norm, images, labels, fed.train.sizes)(
            params, rng, rng.next_round(), sampled, 0, len(sampled))
    if any(u.dtype != torch.float32 for u in updates.values()):
        raise AssertionError("bf16 updates are not f32")
    sizes = torch.as_tensor(fed.train.sizes[sampled], device=DEVICE)
    err = k1_against_plain(rlr_fused, params, updates, sizes, 8.0)
    record["max_abs_err"] = max(record.get("max_abs_err", 0.0), err)
    log(f"[precision] K1 on the bf16 ResNet-9 round's f32 updates (m="
        f"{len(sampled)}): max |kernel - plain| {err:.3e}")
    del updates, images, labels

    # one batched ResNet-9 step at m = 10: remat bit for bit, time, memory
    image = cfg.image_shape
    params, x, y = step_inputs("resnet9", "cifar10", image, PRECISION_CHUNK)
    out = {}
    with cudnn_deterministic():
        for policy in (None, "block", "conv"):
            model = registry.get_model("cifar10", image, arch="resnet9",
                                       remat=policy is not None,
                                       remat_policy=policy or "block")
            grads, losses = batched_step(model, params, x, y)
            torch.cuda.synchronize()
            out[policy] = (grads, losses)
            peak, ms = step_peak_gib(model, params, x, y)
            stash, bwd = stash_and_peak_gib(
                model, {k: v[0] for k, v in params.items()}, x[0], y[0])
            log(f"[precision] ResNet-9 batched step m={PRECISION_CHUNK}, "
                f"remat {policy or 'off'}: {ms:.1f} ms, peak "
                f"{peak:.2f} GiB; one agent's step: the forward leaves "
                f"{stash:.3f} GiB for the backward, whose peak is "
                f"{bwd:.3f} GiB above that (cuDNN deterministic; {card})")
    for policy in ("block", "conv"):
        g, lo = out[policy]
        bad = [k for k in g if not torch.equal(g[k], out[None][0][k])]
        if bad or not torch.equal(lo, out[None][1]):
            raise AssertionError(f"remat {policy} grads != plain: {bad}")
    log("[precision] remat block and conv grads == plain, bit for bit "
        "(26 leaves, cuDNN deterministic)")
    del out
    params40, x40, y40 = step_inputs("resnet9", "cifar10", image, 40)
    for remat in (True, False):
        model = registry.get_model("cifar10", image, arch="resnet9",
                                   remat=remat)
        what = (f"[precision] ResNet-9 batched step m=40 (all agents), "
                f"remat {'block' if remat else 'off'}")
        try:
            peak, ms = step_peak_gib(model, params40, x40, y40)
        except torch.cuda.OutOfMemoryError:
            log(f"{what}: does not fit")
            torch.cuda.empty_cache()
            continue
        log(f"{what}: {ms:.1f} ms, peak {peak:.2f} GiB")
    del params40, x40, y40

    # bf16 against f32, one step of each model
    for arch, data, img in (("resnet9", "cifar10", image),
                            ("cnn", "fmnist", (28, 28, 1))):
        params, x, y = step_inputs(arch, data, img, PRECISION_CHUNK)
        flat = {}
        for dtype in ("f32", "bf16"):
            model = registry.get_model(data, img, arch=arch, dtype=dtype)
            grads, _ = batched_step(model, params, x, y)
            flat[dtype] = torch.cat([g.reshape(-1) for g in grads.values()])
            _, ms = step_peak_gib(model, params, x, y)
            log(f"[precision] {type(model).__name__} batched step m="
                f"{PRECISION_CHUNK} at {dtype}: {ms:.1f} ms ({card})")
        name = type(model).__name__
        rel = float((flat["bf16"] - flat["f32"]).norm()
                    / flat["f32"].norm())
        log(f"[precision] {name} bf16 step's grads vs f32: {rel:.3e} "
            f"relative L2 (JAX's own gap on the CPU {BF16_GRAD_GAP[name]})")
        if not rel <= 2 * BF16_GRAD_GAP[name]:
            raise AssertionError(f"{name}: bf16 grads {rel} from f32")


DATA_FIELDS = ("data", "data_dir", "num_agents", "num_corrupt", "poison_frac",
               "pattern_type", "base_class", "target_class", "seed", "bs",
               "synth_train_size", "synth_val_size", "synth_hardness",
               "attack")


def keep_federated_data() -> None:
    """Build each federated data set once for the script's life: the
    phases' runs share a few (train.run and the phases build them from the
    config, and the build is a deterministic function of DATA_FIELDS), so
    a run after the first with the same fields reuses the arrays, which
    nothing writes to."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch import (
        train)
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data import (
        registry)
    build, kept = registry.get_federated_data, {}
    datasets, raw = registry.get_datasets, {}

    def get_federated_data(cfg):
        key = tuple(getattr(cfg, f) for f in DATA_FIELDS)
        if key not in kept:
            kept[key] = build(cfg)
        return kept[key]

    def get_datasets(cfg):
        # the base dataset of the cohort runs' banks: read, never written
        # (the cohort's rows are gathered and poisoned on copies)
        if cfg.data == "fedemnist":
            return datasets(cfg)
        key = (cfg.data, cfg.data_dir, cfg.synth_train_size,
               cfg.synth_val_size, cfg.synth_hardness, cfg.seed)
        if key not in raw:
            raw[key] = datasets(cfg)
        return raw[key]
    registry.get_federated_data = train.get_federated_data = (
        get_federated_data)
    registry.get_datasets = get_datasets


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="",
                        help="comma-separated phase names to run after "
                             "build (a rehearsal: no result lines); default "
                             "every phase")
    only = [p for p in parser.parse_args(argv).phases.split(",") if p]
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # deterministic cuBLAS (read when its handle is made, and by the
    # spawned ranks): the sharded phase compares rounds across processes
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops import (
        rlr_fused)
    keep_federated_data()

    record = {"name": "rlr_fused", "route": "cuda",
              "source": f"{PKG}/csrc/rlr_fused.cu",
              "replaces": "defending_against_backdoors_with_robust_learning_"
                          "rate_tpu/ops/pallas_rlr.py:57",
              "launches_by_path": {}}
    record2 = {"name": "rlr_partial", "route": "cuda",
               "source": f"{PKG}/csrc/rlr_partial.cu",
               "replaces": "defending_against_backdoors_with_robust_"
                           "learning_rate_tpu/ops/pallas_rlr.py:130"}
    st = {}

    def batched():
        st.update(round_setup())
        phase_batched(st)

    phases = (("build", lambda: phase_build(rlr_fused)),
              ("kernels", lambda: phase_kernels(rlr_fused, record)),
              ("k2", lambda: phase_k2(rlr_fused, record2)),
              ("batched", batched),
              ("main path", lambda: record["launches_by_path"].update(
                  fmnist=phase_main_path(rlr_fused))),
              ("server parity", lambda: phase_server_parity(rlr_fused,
                                                            record, st)),
              ("profile", lambda: phase_profile(st)),
              ("sharded", lambda: phase_sharded(rlr_fused, record2, st)),
              ("nccl d=1", phase_nccl),
              ("cifar10", lambda: phase_cifar10(rlr_fused, record)),
              ("fedemnist", lambda: phase_fedemnist(rlr_fused, record)),
              ("k1 shapes", lambda: phase_k1_shapes(rlr_fused, record)),
              ("rules", lambda: phase_rules(rlr_fused, record, st)),
              ("attack", lambda: phase_attack(rlr_fused, record, st)),
              ("acceptance", lambda: phase_acceptance(rlr_fused, record)),
              ("state", lambda: phase_state(rlr_fused, record, st)),
              ("population", lambda: phase_population(rlr_fused, record)),
              ("precision", lambda: phase_precision(rlr_fused, record)),
              ("buffered", lambda: phase_buffered(rlr_fused, record, st)))
    unknown = set(only) - {label for label, _ in phases}
    if unknown:
        print(f"chip_smoke: no phase {sorted(unknown)}", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    for label, fn in phases:
        if only and label != "build" and label not in only:
            continue
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # noqa: BLE001 — report the phase, then fail
            traceback.print_exc()
            print(f"chip_smoke: phase {label!r} FAILED", file=sys.stderr)
            return 1
        log(f"[phase] {label}: ok in {time.perf_counter() - t0:.1f} s")
    log(f"[phase] all: {time.perf_counter() - t_all:.1f} s")
    if only:
        return 0
    # each kernel's launches: every main-path run of every slice, each
    # read just after it (by path in launches_by_path)
    for r in (record, record2):
        r["launches"] = sum(r["launches_by_path"].values())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_by_path", "shapes", "attack_stacks")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in (record, record2)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
