"""The port's health policy (health/monitor.py: assess, emit_rows, enforce;
utils/guards.finite_warn) against the JAX package's, over one sequence of
eval boundaries; the CLI's refusals of what the port does not run yet
(among them --quarantine on the host-sampled and sharded rounds); and a
CPU run through the CLI, with a quarantine set, that writes the Health/*
and Faults/* rows.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import contextlib
import json
import math
import types

import pytest
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu.config import (
    Config as JaxConfig)
from defending_against_backdoors_with_robust_learning_rate_tpu.fl import (
    rounds as jax_rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu.health import (
    monitor as jax_monitor)
from defending_against_backdoors_with_robust_learning_rate_tpu.utils import (
    guards as jax_guards)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch import (
    train)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.health import (
    monitor)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel import (
    rounds as prounds)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils import (
    guards)


class _Rows:
    """A metrics writer that keeps its rows."""

    def __init__(self):
        self.rows = []

    def scalar(self, tag, value, step):
        self.rows.append((tag, float(value), int(step)))


def _lanes(loss, normsq, nonfinite=0.0, pfinite=1.0, finite=True):
    return {"finite": finite, "train_loss": loss,
            "hlth_nonfinite": nonfinite, "hlth_params_finite": pfinite,
            "hlth_update_normsq": normsq}


# warm-up, healthy, a loss jump, a norm spike, a NaN lane, an overflowed
# norm mass, healthy again; then --health off (no lanes): the finite bit
BOUNDARIES = (
    _lanes(2.30, 4.0), _lanes(2.20, 4.4), _lanes(2.10, 3.9),
    _lanes(2.05, 4.1), _lanes(9.0, 4.0), _lanes(2.0, 4.0e4),
    _lanes(float("nan"), float("nan"), nonfinite=2.0, pfinite=0.0,
           finite=False),
    _lanes(2.0, float("inf")), _lanes(1.98, 4.2),
    {"finite": True, "train_loss": 1.9}, {"finite": False,
                                          "train_loss": 1.9})


def _same(a, b):
    """Equal, NaN equal to NaN."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


def test_assess_and_rows_match_jax():
    """assess + emit_rows over the boundary sequence: the same rows (tags,
    values, order), verdicts, reasons and EMA states as JAX's, the state
    carried from boundary to boundary as the drivers carry it."""
    cfg, jcfg = Config(), JaxConfig()
    ours, theirs = _Rows(), _Rows()
    state = jstate = None
    verdicts = []
    for step, vals in enumerate(BOUNDARIES, start=1):
        got = monitor.assess(cfg, state, dict(vals))
        want = jax_monitor.assess(jcfg, jstate, dict(vals))
        assert _same(got, want), (step, got, want)
        monitor.emit_rows(ours, got, step)
        jax_monitor.emit_rows(theirs, want, step)
        state, jstate = got["new_state"], want["new_state"]
        verdicts.append(got["healthy"])
    assert _same(ours.rows, theirs.rows)
    assert verdicts == [True, True, True, True, False, False, False, False,
                        True, True, False]
    assert [t for t, _, s in ours.rows if s == 1] == list(
        monitor.TAGS.values())
    assert not [r for r in ours.rows if r[2] > 9]   # --health off: no rows
    assert monitor.TAGS == jax_monitor.TAGS
    assert state["n"] == 5      # only the healthy boundaries with lanes fold


def test_enforce_and_refusals(tmp_path, capsys):
    """enforce under record and abort (JAX's warnings, HealthIncident and
    finite_warn's FloatingPointError word for word); the refusals, JAX's
    error word for word for --quarantine on the host-sampled round; and a
    CPU run with comed, faults, --quarantine and --health_policy abort
    through the CLI: the quarantine line, Health/* rows first, Faults/*
    after Train/Loss, as JAX writes them."""
    jcfg = JaxConfig()
    nan_report = monitor.assess(Config(), None, dict(BOUNDARIES[6]))
    soft = monitor.assess(Config(), {"n": 4, "loss_ema": 2.0,
                                     "loss_var": 0.01, "norm_ema": 2.0,
                                     "delta_ema": 0.0}, _lanes(9.0, 4.0))
    assert not soft["healthy"] and soft["finite"]
    for report in (nan_report, soft):
        assert not monitor.enforce(Config(health_policy="record"), report,
                                   where="round 7")
        ours = capsys.readouterr().out
        assert not jax_monitor.enforce(jcfg.replace(health_policy="record"),
                                       report, where="round 7")
        assert ours == capsys.readouterr().out and "WARNING" in ours
        with pytest.raises(FloatingPointError) as got:
            monitor.enforce(Config(health_policy="abort"), report,
                            where="round 7")
        with pytest.raises(FloatingPointError) as want:
            jax_monitor.enforce(jcfg.replace(health_policy="abort"), report,
                                where="round 7")
        assert str(got.value) == str(want.value)
        assert (isinstance(got.value, monitor.HealthIncident)
                == isinstance(want.value, jax_monitor.HealthIncident))
    capsys.readouterr()
    for where in ("", "round 3"):
        for raise_error in (True, False):
            with pytest.raises(FloatingPointError) if raise_error else \
                    contextlib.nullcontext() as got:
                guards.finite_warn(False, where, raise_error)
            ours = capsys.readouterr().out
            with pytest.raises(FloatingPointError) if raise_error else \
                    contextlib.nullcontext() as want:
                jax_guards.finite_warn(False, where, raise_error)
            assert ours == capsys.readouterr().out
            if raise_error:
                assert str(got.value) == str(want.value)
            else:
                assert "non-finite parameters detected" in ours
    params = {"a": torch.ones(3), "b": torch.zeros(2)}
    assert bool(guards.all_finite_device(params))
    params["b"][1] = float("inf")
    assert not bool(guards.all_finite_device(params))

    # refusals: the ladder, checkify; --quarantine on the host-sampled
    # round (JAX's error). The sharded round runs the new rules, the
    # faults and a quarantine set (tests/test_torch_sharded_*.py) and
    # refuses --diagnostics beside them
    for argv in (["--health_policy", "recover"], ["--debug_nan"]):
        with pytest.raises(ValueError, match="not ported yet"):
            train.args_parser(argv)
    assert train.args_parser(["--quarantine", "3,4"]).quarantine == "3,4"
    with pytest.raises(ValueError) as want:
        jax_rounds.make_host_step(JaxConfig(quarantine="3,4"), None, None)
    with pytest.raises(ValueError) as got:
        rounds.make_round_fn_host(Config(quarantine="3,4"), None, None,
                                  [1, 2], 8, "cpu")
    assert str(got.value) == str(want.value)
    group = types.SimpleNamespace(size=2, rank=0)
    for cfg in (Config(aggr="comed"), Config(aggr="krum"),
                Config(dropout_rate=0.1), Config(payload_norm_cap=5.0),
                Config(quarantine="1")):
        assert prounds._check_sharded(cfg, group) == cfg.agents_per_round // 2
        with pytest.raises(ValueError, match="not ported yet"):
            prounds.make_sharded_round_fn(cfg.replace(diagnostics=True), None,
                                          None, group, None, None, None)

    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc = train.main([
            "--device", "cpu", "--data", "synthetic", "--num_agents", "4",
            "--bs", "16", "--local_ep", "2", "--rounds", "2", "--snap", "2",
            "--chain", "2", "--synth_train_size", "128",
            "--synth_val_size", "64", "--eval_bs", "32", "--num_corrupt",
            "1", "--poison_frac", "1.0", "--robustLR_threshold", "2",
            "--aggr", "comed", "--dropout_rate", "0.5", "--straggler_rate",
            "0.5", "--corrupt_rate", "0.5", "--rlr_threshold_mode", "scaled",
            "--faults_spare_corrupt", "--health_policy", "abort",
            "--quarantine", "2", "--log_dir", str(tmp_path)])
    finally:
        torch.set_num_threads(old)
    assert rc == 0
    assert ("[health] quarantined clients: [2] (excluded via the "
            "participation mask)") in capsys.readouterr().out
    (path,) = tmp_path.glob("*/metrics.jsonl")
    tags = [r["tag"] for r in map(json.loads, path.read_text().splitlines())
            if r["step"] == 2]
    assert tags[:5] == list(monitor.TAGS.values())
    at = tags.index("Train/Loss")
    assert tags[at + 1:at + 4] == ["Faults/Dropped", "Faults/Straggled",
                                   "Faults/Effective_Voters"]
    rows = {r["tag"]: r["value"]
            for r in map(json.loads, path.read_text().splitlines())}
    assert 1.0 <= rows["Faults/Effective_Voters"] <= 4.0
    assert rows["Health/Params_Finite"] == 1.0

