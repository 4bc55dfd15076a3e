"""`--agg_mode buffered` at the port's surface: the refusals, the run
name and the Async/* rows of metrics.jsonl.

Refusals, word for word against the JAX package's: `fl/buffered.check`
(the order-statistic rules comed, trmean, krum and rfa, --diagnostics,
the knobs' ranges), and the host-sampled refusal, one message from the
step builder and from `train.run` (read from JAX train.py's source: its
`train.run` is never called here). The sharded round refuses buffered by naming
ROADMAP item 11 (JAX's multi-process refusal: the port's sharded round is
its multi-process path), `--tenants` is still refused and names item 15.

The run name carries JAX's `-agm:bufK{K}a{a}S{S}` cell (K resolved) and,
under diurnal traffic, the latency sigma in the `-tfc:` cell, equal to
JAX's cells. A CPU run through the CLI writes the Async/Buffer_Fill,
Async/Committed and Async/Staleness_Hist/<b> rows after the Faults/*
rows and before the Defense/* rows at every boundary, the same through
the async drain and through --sync_metrics.

No process is spawned; everything is written under tmp_path.
At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import ast
import inspect
import json
import re

import pytest
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu import (
    train as jax_train)
from defending_against_backdoors_with_robust_learning_rate_tpu.config import (
    Config as JaxConfig)
from defending_against_backdoors_with_robust_learning_rate_tpu.fl import (
    buffered as jax_buffered)
from defending_against_backdoors_with_robust_learning_rate_tpu.utils.metrics import (
    run_name as jax_run_name)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch import (
    config, train)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    buffered, rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel import (
    rounds as prounds)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils.metrics import (
    run_name)


def _message(fn, *args):
    with pytest.raises(Exception) as e:
        fn(*args)
    return type(e.value), str(e.value)


def _jax_train_message(prefix):
    """The literal message of the ValueError JAX train.py raises whose
    text starts with `prefix`."""
    for node in ast.walk(ast.parse(inspect.getsource(jax_train))):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", "")
                == "ValueError" and node.args
                and isinstance(node.args[0], ast.Constant)
                and str(node.args[0].value).startswith(prefix)):
            return node.args[0].value
    raise AssertionError(f"no ValueError({prefix!r}...) in JAX train.py")


def test_refusals_match_jax(tmp_path):
    buf = dict(agg_mode="buffered")
    for kw in (dict(aggr="comed"), dict(aggr="trmean"), dict(aggr="krum"),
               dict(aggr="rfa"), dict(diagnostics=True),
               dict(async_buffer_k=-1), dict(async_staleness_exp=-0.5),
               dict(async_max_staleness=0)):
        want = _message(jax_buffered.check, JaxConfig(**buf, **kw))
        assert _message(buffered.check, Config(**buf, **kw)) == want, kw
    for mode in ("sync", "buffered"):
        buffered.check(Config(agg_mode=mode))
    with pytest.raises(ValueError, match="agg_mode must be"):
        buffered.is_buffered(Config(agg_mode="eventual"))
    # the CLI refuses before anything is built, JAX's words
    with pytest.raises(ValueError) as e:
        config.args_parser(["--agg_mode", "buffered", "--aggr", "krum"])
    assert str(e.value) == _message(
        jax_buffered.check, JaxConfig(**buf, aggr="krum"))[1]
    # the host-sampled step and train.run: one refusal, JAX train.py's
    # message
    assert _message(rounds.make_host_step, Config(**buf), None, None, None,
                    4, "cpu") == (ValueError, config.BUFFERED_HOST_SAMPLED)
    assert config.BUFFERED_HOST_SAMPLED == _jax_train_message(
        "--agg_mode buffered is not supported in host-sampled mode (this")
    host = Config(**buf, data="synthetic", num_agents=4, bs=16, local_ep=1,
                  rounds=1, synth_train_size=64, synth_val_size=32,
                  host_sampled="on", device="cpu",
                  data_dir=str(tmp_path / "nodata"),
                  log_dir=str(tmp_path / "logs"))
    with pytest.raises(ValueError) as e:
        train.run(host)
    assert str(e.value) == config.BUFFERED_HOST_SAMPLED
    # the sharded round: ROADMAP item 11, before its faults refusal
    for cfg in (Config(**buf), Config(**buf, straggler_rate=0.3)):
        with pytest.raises(ValueError) as e:
            train._sharded_cfg(cfg, print)
        assert str(e.value) == config.BUFFERED_SHARDED_NOT_PORTED
        assert "ROADMAP queue 1 item 11" in str(e.value)

    class _Group:
        size = 2
    with pytest.raises(ValueError) as e:
        prounds._check_sharded(Config(**buf), _Group())
    assert str(e.value) == config.BUFFERED_SHARDED_NOT_PORTED
    # tenants stay refused, now by item 15
    with pytest.raises(ValueError) as e:
        config.args_parser(["--tenants", "2"])
    assert str(e.value) == config.TENANTS_NOT_PORTED
    assert "ROADMAP queue 1 item 15" in str(e.value)
    # the fused kernel is off under buffered
    assert rounds._fused_applicable(Config())
    assert not rounds._fused_applicable(Config(**buf))


def _cell(name, prefix):
    found = re.search(rf"-{prefix}:[^-]*", name)
    return found.group(0) if found else None


def _rows(log_dir):
    (path,) = list((log_dir).glob("*/metrics.jsonl"))
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return path.parent.name, [r for r in rows if not r["tag"].startswith(
        ("_run/", "Throughput/"))]


def test_run_name_and_async_rows(tmp_path, capsys):
    for kw in (dict(agg_mode="buffered"),
               dict(agg_mode="buffered", async_buffer_k=5,
                    async_staleness_exp=0.5, async_max_staleness=2),
               dict(agg_mode="buffered", traffic="diurnal",
                    traffic_latency_sigma=1.5),
               dict(traffic="diurnal"), dict()):
        got, want = run_name(Config(**kw)), jax_run_name(JaxConfig(**kw))
        for cell in ("agm", "tfc"):
            assert _cell(got, cell) == _cell(want, cell), (kw, cell)
    assert "-agm:bufK10a0.0S4" in run_name(Config(agg_mode="buffered"))

    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        argv = ["--device", "cpu", "--data", "synthetic", "--num_agents", "4",
                "--bs", "16", "--local_ep", "1", "--rounds", "4", "--snap",
                "2", "--synth_train_size", "128", "--synth_val_size", "32",
                "--num_corrupt", "1", "--poison_frac", "1.0",
                "--robustLR_threshold", "2", "--telemetry", "basic",
                "--agg_mode", "buffered", "--straggler_rate", "0.5",
                "--async_buffer_k", "3", "--async_max_staleness", "2",
                "--data_dir", str(tmp_path / "nodata"), "--no_tensorboard"]
        outs = {}
        for mode, extra in (("drain", []), ("sync", ["--sync_metrics"])):
            log_dir = tmp_path / mode
            assert train.main(argv + ["--log_dir", str(log_dir)] + extra) == 0
            outs[mode] = _rows(log_dir)
    finally:
        torch.set_num_threads(old)
    said = capsys.readouterr().out
    assert ("[async] buffered aggregation: commit every 3 arrivals, "
            "staleness weight 1/(1+T)^0.0, max latency 2 tick(s)") in said
    assert "Aggregation mode: buffered" in said
    (name, rows), (name_sync, rows_sync) = outs["drain"], outs["sync"]
    assert name == name_sync and name.endswith("-agm:bufK3a0.0S2")
    assert rows == rows_sync
    for step in (2, 4):
        tags = [r["tag"] for r in rows if r["step"] == step]
        heads = [t.split("/")[0] for t in tags]
        async_tags = [t for t in tags if t.startswith("Async/")]
        assert async_tags == ["Async/Buffer_Fill", "Async/Committed",
                              "Async/Staleness_Hist/0",
                              "Async/Staleness_Hist/1",
                              "Async/Staleness_Hist/2"]
        first = heads.index("Async")
        assert heads[first - 1] == "Faults" and heads[first + 5] == "Defense"
        vals = {r["tag"]: r["value"] for r in rows if r["step"] == step}
        assert vals["Async/Buffer_Fill"] == sum(
            vals[f"Async/Staleness_Hist/{b}"] for b in range(3))
        assert vals["Async/Committed"] in (0.0, 1.0)
