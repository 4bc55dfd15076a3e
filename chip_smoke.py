"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (`defending_against_backdoors_with_robust_learning_rate_tpu_torch`,
never the JAX package) through five phases and exits non-zero if any fails:

1. build: prints the card's name and power limit (nvidia-smi) and builds
   every hand-written kernel of the main path from the checkout's sources,
   timing the build.
2. kernels: holds each kernel against its plain PyTorch version on the card
   at the shapes the main path gives it, and times kernel and plain version
   with CUDA events (median over 50 launches after warm-up, L2 flushed
   before each, as the round finds the updates) beside the least time the
   card needs for the bytes the kernel must move.
3. main path: the FMNIST triple at full width (CNN_MNIST, K=10 agents all
   sampled, 2 local epochs of bs 256, FedAvg; clean, then 1 corrupt agent
   poisoning half its base-class samples, then that attack with RLR
   threshold 4) for a few rounds each through `train.run`, on synthetic
   data at FMNIST's scale when no FMNIST is on disk, TF32 off. The kernel
   launch counts are set to 0 just before and read just after: a kernel of
   the path that did not launch fails the run.
4. server parity: for one round's real updates, the kernel's new params vs
   the plain server step's (ops/aggregate.py).
5. profile: one attack + RLR round timed unprofiled, then under
   torch.profiler: the card's busy time and idle share, and the kernels
   that take the most of it.

The last two lines of standard output are one JSON object per kernel
(`{"kernels": [...]}`) and `{"ok": true, "device": {...}}`. Without a CUDA
device it exits with 1 before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback

import torch

PKG = "defending_against_backdoors_with_robust_learning_rate_tpu_torch"
DEVICE = "cuda"
ROUNDS = 4
M = 10                      # agents per round on the main path
TOL = 1e-5                  # avg mode: f32 sums in another order
# device memory rate by card name (NVIDIA data sheets); FP32 rate outside
# the tensor cores
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12,
                   "H100": 3.35e12}
FP32_FLOPS = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S.items():
        if key in name:
            return rate
    raise ValueError(f"no memory rate on record for {name!r}")


def time_ms(fn, flush, reps: int = 50, warmup: int = 5) -> float:
    """Median device time of fn() over `reps` runs, L2 flushed before each."""
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


def phase_kernels(rlr_fused, record) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    err = 0.0
    cases = [(4, 300, 3.0), (10, 5000, 4.0), (7, 1111, 0.0)] + [
        (M, math.prod(s), 4.0) for s in leaf_shapes().values()]
    for m, n, thr in cases:
        u = torch.randn(m, n, generator=gen, device=dev)
        w = torch.rand(m, generator=gen, device=dev) * 4 + 1
        p = torch.randn(n, generator=gen, device=dev)
        wn = w / w.sum()
        for mode in ("avg", "sign"):
            got = rlr_fused.rlr_fused(u, wn, p, thr, 0.5, mode)
            want = rlr_fused.rlr_fused_reference(u, wn, p, thr, 0.5, mode)
            torch.cuda.synchronize()
            if mode == "sign":
                # p + (+-lr) * (+-1 | 0): the vote must agree exactly
                torch.testing.assert_close(got, want, atol=0, rtol=0)
            else:
                torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
            err = max(err, float((got - want).abs().max()))
    log(f"[k1] {2 * len(cases)} cases (test_pallas shapes + every CNN_MNIST "
        f"leaf at m={M}; avg and sign): max |kernel - plain| = {err:.3e} "
        f"(sign exact, avg within {TOL})")

    # one round's server step at the main path's shapes: 8 launches
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

    log(f"[k1-time] leaf, n, kernel_ms, plain_ms, bound_ms (m={M}, avg, "
        f"thr 4, L2 flushed; {name}, {rate / 1e12:.2f} TB/s):")
    total_bytes = total_ops = 0
    for k, s in shapes.items():
        n = math.prod(s)
        u, p = ups[k].view(M, -1), params[k].view(-1)
        nbytes = 4 * (M * n + M + 2 * n)
        total_bytes += nbytes
        total_ops += 4 * M * n
        k_ms = time_ms(lambda: rlr_fused.rlr_fused(u, wn, p, 4.0, 1.0), flush)
        p_ms = time_ms(lambda: rlr_fused.rlr_fused_reference(
            u, wn, p, 4.0, 1.0), flush)
        log(f"[k1-time]   {k:16s} {n:8d} {k_ms:.4f} {p_ms:.4f} "
            f"{nbytes / rate * 1e3:.4f}")
    k_ms = time_ms(kernel_step, flush)
    p_ms = time_ms(plain_step, flush)
    bound_ms = max(total_bytes / rate, total_ops / FP32_FLOPS) * 1e3
    bound_by = ("bytes" if total_bytes / rate >= total_ops / FP32_FLOPS
                else "operations")
    log(f"[k1-time] per round ({len(shapes)} launches): kernel {k_ms:.4f} ms, "
        f"plain {p_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); no "
        f"single PyTorch call computes K1, and the plain version is the "
        f"nearest composite of PyTorch calls")
    record.update(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms,
                  bound_by=bound_by, library_ms=None)


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
    for k in rlr_fused.LAUNCHES:
        rlr_fused.LAUNCHES[k] = 0
    summaries = {}
    for label, cfg in triple().items():
        s = train.run(cfg)
        summaries[label] = s
        log(f"[main] {label}: {s['rounds_per_sec']:.3f} rounds/s "
            f"({s['steady_rounds_per_sec']:.3f} after round 1), train_loss "
            f"{s['train_loss']:.4f}, val_acc {s['val_acc']:.4f}, "
            f"poison_acc {s['poison_acc']:.4f} at round {s['round']}")
    launches = rlr_fused.LAUNCHES["rlr_fused"]
    expect = len(triple()) * ROUNDS * len(leaf_shapes())
    log(f"[main] rlr_fused launches on the main path: {launches} "
        f"(expected {expect}: 3 runs x {ROUNDS} rounds x 8 leaves)")
    for label, s in summaries.items():
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
    if launches != expect:
        raise AssertionError(f"rlr_fused launched {launches} times on the "
                             f"main path, expected {expect}")
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
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl.client import (
        draw_perms, make_local_train)

    cfg, fed, params, rng = st["cfg"], st["fed"], st["params"], st["rng"]
    sampled = rounds.sample_agents(cfg, rng.host).tolist()
    perms = [draw_perms(int(fed.train.sizes[a]), st["images"].shape[1],
                        cfg.local_ep, rng.device, DEVICE) for a in sampled]
    updates, _ = rounds.train_agents(
        make_local_train(st["model"], cfg, st["norm"]), params, st["images"],
        st["labels"], fed.train.sizes, sampled, perms, rng.device)
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


def phase_profile(st) -> None:
    """Where one attack + RLR round's time goes: wall time unprofiled, then
    one round under torch.profiler for the card's busy time, its idle
    share, and the kernels that take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    round_fn, params, rng = st["round_fn"], st["params"], st["rng"]
    params, _ = round_fn(params, rng)           # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, _ = round_fn(params, rng)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, _ = round_fn(params, rng)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(t for _, t in by_name.values())
    launches = sum(n for n, _ in by_name.values())
    k1 = [(n, t) for name, (n, t) in by_name.items() if "rlr_fused" in name]
    k1_ms = sum(t for _, t in k1)
    log(f"[profile] one attack+RLR round: wall {wall_ms:.1f} ms unprofiled, "
        f"{prof_wall_ms:.1f} ms profiled; card busy {busy_ms:.1f} ms in "
        f"{launches} kernels (idle share {1 - busy_ms / prof_wall_ms:.3f} "
        f"of the profiled round); rlr_fused {k1_ms:.4f} ms in "
        f"{sum(n for n, _ in k1)} launches")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        log(f"[profile]   {t:9.2f} ms {n:6d}x  {name[:90]}")
    if not k1:
        raise AssertionError("the profiled round launched no rlr_fused kernel")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops import (
        rlr_fused)

    record = {"name": "rlr_fused", "route": "cuda",
              "source": f"{PKG}/csrc/rlr_fused.cu",
              "replaces": "defending_against_backdoors_with_robust_learning_"
                          "rate_tpu/ops/pallas_rlr.py:57"}
    st = {}

    def server_parity():
        st.update(round_setup())
        phase_server_parity(rlr_fused, record, st)

    phases = (("build", lambda: phase_build(rlr_fused)),
              ("kernels", lambda: phase_kernels(rlr_fused, record)),
              ("main path", lambda: record.update(
                  launches=phase_main_path(rlr_fused))),
              ("server parity", server_parity),
              ("profile", lambda: phase_profile(st)))
    for label, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # noqa: BLE001 — report the phase, then fail
            traceback.print_exc()
            print(f"chip_smoke: phase {label!r} FAILED", file=sys.stderr)
            return 1
        log(f"[phase] {label}: ok in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{
        k: record[k] for k in ("name", "route", "source", "replaces",
                               "launches", "max_abs_err", "ms", "plain_ms",
                               "bound_ms", "bound_by", "library_ms")}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
