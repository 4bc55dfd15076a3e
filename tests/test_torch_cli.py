"""The port's CLI end to end on the CPU, and its import boundary: the port
and chip_smoke.py import no jax, no flax and nothing of the JAX package.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import defending_against_backdoors_with_robust_learning_rate_tpu_torch as port
from defending_against_backdoors_with_robust_learning_rate_tpu_torch import (
    train)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_DIR = pathlib.Path(port.__file__).resolve().parent
JAX_PKG = "defending_against_backdoors_with_robust_learning_rate_tpu"
FORBIDDEN = ("jax", "flax", "jaxlib", "optax", "orbax", "chex", JAX_PKG)

# the rows the JAX driver writes at every eval boundary whatever its options
# (train._emit_eval_body: the reference's scalar names of
# src/federated.py:81-91, plus the throughput row)
REFERENCE_TAGS = {
    "Validation/Loss", "Validation/Accuracy", "Poison/Base_Class_Accuracy",
    "Poison/Poison_Accuracy", "Poison/Poison_Loss",
    "Poison/Cumulative_Poison_Accuracy_Mean", "Train/Loss",
    "Throughput/Rounds_Per_Sec"}
# and, with the health lanes on (the default), the rows JAX's
# health/monitor.emit_rows writes from them
HEALTH_TAGS = {"Health/Nonfinite_Updates", "Health/Params_Finite",
               "Health/Update_Norm", "Health/Loss_Z", "Health/Norm_Spike"}
# and from the second boundary on, the steady rate after the first dispatch
# (JAX train.py: Throughput/Steady_Rounds_Per_Sec)
STEADY_TAG = "Throughput/Steady_Rounds_Per_Sec"
# and, with a sign vote (the RLR threshold here), the Reputation/* rows
# JAX's obs/reputation.emit_rows writes: 4 clients tracked, 1 corrupt
REPUTATION_TAGS = {
    "Reputation/Clients_Tracked", "Reputation/Mean_Agree",
    "Reputation/Min_Agree", "Reputation/Suspect_Count",
    "Reputation/Top_Suspect_Score", "Reputation/Suspicion_AUC",
    *(f"Reputation/Top_Suspects/{i}" for i in range(4))}


def test_cli_two_rounds_writes_reference_tags(tmp_path, capsys):
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        rc = train.main([
            "--device", "cpu", "--data", "synthetic", "--num_agents", "4",
            "--bs", "16", "--local_ep", "1", "--rounds", "2", "--snap", "1",
            "--synth_train_size", "128", "--synth_val_size", "64",
            "--eval_bs", "32", "--num_corrupt", "1", "--poison_frac", "1.0",
            "--robustLR_threshold", "2", "--log_dir", str(tmp_path)])
    finally:
        torch.set_num_threads(old)
    assert rc == 0
    out = capsys.readouterr().out
    assert "Training has finished!" in out
    assert "| Rnd 2: Val_Loss/Val_Acc:" in out
    (path,) = tmp_path.glob("*/metrics.jsonl")
    assert path.parent.name == (
        "clip_val:0.0-noise_std:0.0-aggr:avg-s_lr:1.0-num_cor:1"
        "-thrs_robustLR:2-pttrn:plus-seed:0")
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert rows[0]["tag"] == "_run/start"
    for step in (1, 2):
        got = {r["tag"] for r in rows if r["step"] == step}
        assert got == (REFERENCE_TAGS | HEALTH_TAGS | REPUTATION_TAGS
                       | ({STEADY_TAG} if step > 1 else set())), step
    health = {r["tag"]: r["value"] for r in rows if r["step"] == 2
              and r["tag"] in HEALTH_TAGS}
    assert health["Health/Nonfinite_Updates"] == 0.0
    assert health["Health/Params_Finite"] == 1.0
    assert health["Health/Update_Norm"] > 0.0
    assert all(np.isfinite(r["value"]) for r in rows)

    # a run asked onto a card that is not there raises, it never falls
    # back to the CPU; a policy the port has not ported is refused
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train.resolve_device("cuda")
    with pytest.raises(ValueError, match="not ported"):
        train.args_parser(["--health_policy", "recover"])
    # the bucket layout is ported (the sharded round's server step); the
    # sharded round refuses it beside --diagnostics with JAX's words
    assert train.args_parser(["--agg_layout", "bucket"]).agg_layout == \
        "bucket"
    with pytest.raises(ValueError, match="bucket does not support"):
        train._sharded_cfg(train.args_parser(
            ["--agg_layout", "bucket", "--diagnostics"]), print)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted(PORT_DIR.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    # slice 10's modules are among those read and imported
    ported = {p.relative_to(PORT_DIR).as_posix() for p in files
              if PORT_DIR in p.parents}
    assert {"models/layers.py", "models/remat.py", "data/native.py",
            "utils/metrics.py", "closing_check.py"} <= ported
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
    # every module of the port imports in a fresh interpreter without
    # bringing jax in
    code = (
        "import importlib, pkgutil, sys\n"
        f"import {port.__name__} as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
