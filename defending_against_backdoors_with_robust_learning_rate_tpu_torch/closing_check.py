"""Slice 5's closing check: the port's CLI on RESULTS.md's JAX
configurations, held to `results.json`'s JAX milestones.

    python -m defending_against_backdoors_with_robust_learning_rate_tpu_torch.closing_check \\
        [--rows cifar10-dba-attack,...] [--seeds 0,1,2] [--out FILE]

The rows are the JAX package's `scripts/run_baselines.py:285-335` sweep,
this package's own copy of the configurations: CIFAR-10 DBA (40 agents, 4
corrupt stamping the plus, RLR threshold 8, 2 local epochs at bs 256,
synthetic hardness 0.25) on CNN_CIFAR for 150 rounds and on ResNet-9 as
JAX ran it (`--remat --agent_chunk 10`) for 20, its bf16 row at seed 0
only; Fed-EMNIST-shaped (128 agents, a quarter sampled, 13 corrupt, 10
local epochs at bs 64, hardness 0.4) for 100 rounds; eval every 10
rounds, TF32 off. Each run goes through `train.run` on the card; its
val and poison accuracy at rounds 20, 50 and 100 (as far as it goes) are
read back from its metrics.jsonl and printed beside the JAX milestone of
the same row (results.json, seed 0). One JSON line a run is appended to
`--out`; the last lines print the card (nvidia-smi) and a table.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

MILESTONES = (20, 50, 100)
ROWS = ("cifar10-dba-attack", "cifar10-dba-rlr", "fedemnist-attack",
        "fedemnist-attack-rlr", "cifar10-resnet9-dba-attack",
        "cifar10-resnet9-dba-rlr", "cifar10-resnet9-dba-rlr-bf16")
SEED0_ONLY = ("cifar10-resnet9-dba-rlr-bf16",)


def row_config(name: str, seed: int, log_dir: str):
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
        Config)
    snap = 10
    if name.startswith("fedemnist"):
        kw = dict(data="fedemnist", num_agents=128, agent_frac=0.25,
                  local_ep=10, bs=64, rounds=100, synth_train_size=32768,
                  synth_val_size=1024, synth_hardness=0.4, num_corrupt=13,
                  poison_frac=0.5)
        if name.endswith("-rlr"):
            kw["robustLR_threshold"] = 8
    else:
        kw = dict(data="cifar10", num_agents=40, local_ep=2, bs=256,
                  rounds=150, synth_train_size=50000, synth_val_size=10000,
                  synth_hardness=0.25, num_corrupt=4, poison_frac=0.5,
                  pattern_type="plus")
        if "resnet9" in name:
            kw.update(arch="resnet9", remat=True, agent_chunk=10, rounds=20)
        if "-rlr" in name:
            kw["robustLR_threshold"] = 8
        if name.endswith("-bf16"):
            kw["dtype"] = "bf16"
    return Config(snap=snap, seed=seed, tensorboard=False,
                  log_dir=os.path.join(log_dir, f"{name}-s{seed}"),
                  data_dir="./data", **kw)


def milestones(cfg):
    """{round: (val_acc, poison_acc)} read from the run's metrics.jsonl."""
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils.metrics import (
        run_name)
    path = os.path.join(cfg.log_dir, run_name(cfg), "metrics.jsonl")
    got = {}
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    for r in rows:
        if r["step"] in MILESTONES and r["tag"] in (
                "Validation/Accuracy", "Poison/Poison_Accuracy"):
            got.setdefault(r["step"], {})[r["tag"]] = r["value"]
    return {k: (v["Validation/Accuracy"], v["Poison/Poison_Accuracy"])
            for k, v in sorted(got.items())}


def jax_milestones(results_path: str):
    with open(results_path) as f:
        rows = json.load(f)
    out = {}
    for row in rows:
        ms = row["milestones"]
        if isinstance(ms, str):
            # some rows keep the dict's repr, cut at 300 characters
            continue
        out[row["name"]] = {int(k): (v["val_acc"], v["poison_acc"])
                            for k, v in ms.items()}
    return out


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default=",".join(ROWS))
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--out", default="build/closing_check/runs.jsonl")
    ap.add_argument("--log_dir", default="build/closing_check/logs")
    ap.add_argument("--results", default="results.json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("closing_check: torch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from defending_against_backdoors_with_robust_learning_rate_tpu_torch import (
        train)
    jax_ms = jax_milestones(args.results)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    print(f"[card] {card()}", flush=True)
    table = []
    for name in args.rows.split(","):
        seeds = [int(s) for s in args.seeds.split(",")]
        if name in SEED0_ONLY:
            seeds = [0]
        for seed in seeds:
            cfg = row_config(name, seed, args.log_dir)
            t0 = time.perf_counter()
            s = train.run(cfg)
            wall = time.perf_counter() - t0
            got = milestones(cfg)
            rec = {"row": name, "seed": seed, "rounds": cfg.rounds,
                   "wall_s": wall,
                   "steady_rounds_per_sec": s["steady_rounds_per_sec"],
                   "final": (s["val_acc"], s["poison_acc"]),
                   "milestones": got,
                   "jax_seed0": jax_ms.get(name.replace("-bf16", "")
                                           if name in SEED0_ONLY else name),
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
            torch.cuda.reset_peak_memory_stats()
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(f"[closing] {json.dumps(rec)}", flush=True)
            table.append(rec)
    print(f"[card] {card()}")
    for rec in table:
        cells = "  ".join(
            f"r{r}: {v:.3f}/{p:.3f}" for r, (v, p) in rec["milestones"].items())
        print(f"| {rec['row']} s{rec['seed']} | {cells} | JAX "
              f"{rec['jax_seed0']} | {rec['steady_rounds_per_sec']:.3f} r/s |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
