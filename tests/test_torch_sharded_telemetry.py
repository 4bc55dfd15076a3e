"""The sharded round's defense telemetry (obs/telemetry.compute_sharded,
shard_vote_stats, compute_sharded_bucket) against JAX's under a plain
`jax.jit` of `shard_map` on the faked CPU mesh, and a sharded `train.run`
under the bucket layout, faults, a quarantine set and full telemetry
against the dense run's rows.

The d ranks are gloo process groups on threads of this process
(parallel/mesh.run_in_threads). Tolerances: the flip fraction, the margin
histogram and mean are counts over the coordinate count, equal to one ulp
(JAX's division by a constant is a reciprocal-multiply); the norm
percentiles and
the cosines within 1e-5 relative (f32 sums in another order); the Faults/*
rows equal; a run's Defense/* rows within 1e-5 relative (absolute 1e-6
near zero) of the dense run's.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from defending_against_backdoors_with_robust_learning_rate_tpu.config import (
    Config as JaxConfig)
from defending_against_backdoors_with_robust_learning_rate_tpu.obs import (
    telemetry as jax_telemetry)
from defending_against_backdoors_with_robust_learning_rate_tpu.parallel.compat import (
    shard_map)
from defending_against_backdoors_with_robust_learning_rate_tpu.parallel.mesh import (
    make_mesh)
from defending_against_backdoors_with_robust_learning_rate_tpu.parallel.rounds import (
    _bucket_applicable, _bucketed_apply, _sharded_aggregate,
    _sharded_robust_lr, _sharded_sign_shared)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch import (
    train)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    registry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.obs import (
    telemetry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel import (
    multihost)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.mesh import (
    run_in_threads)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.rounds import (
    sharded_server_path)

M = 8
MASK = np.array([1, 1, 1, 0, 1, 1, 0, 1], bool)
CORRUPT = np.array([1, 0, 0, 1, 0, 0, 0, 0], bool)
COUNTS = ("tel_flip_frac", "tel_margin_hist", "tel_margin_mean")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jax_telemetry(jcfg, d, masked, params, updates, sizes):
    """JAX's sharded body's telemetry dict: the vote, the aggregate and
    compute_sharded on the leaf layout, _bucketed_apply and
    compute_sharded_bucket on the bucket layout."""
    ax = "agents"
    rlr = jcfg.robustLR_threshold > 0

    def body(p, u, s, ml, mf, flags):
        ml, mf = (ml, mf) if masked else (None, None)
        key = jax.random.PRNGKey(0)
        if _bucket_applicable(jcfg):
            _, info = _bucketed_apply(p, u, s, jcfg, key, d, ml, mf)
            return jax_telemetry.compute_sharded_bucket(
                jcfg, u, info, ax, mask_local=ml, mask_full=mf,
                corrupt_full=flags)
        if rlr and jcfg.aggr == "sign":
            lr, agg, sums = _sharded_sign_shared(u, jcfg, key, ml, mf)
        else:
            lr, sums = (_sharded_robust_lr(u, jcfg, ml, mf) if rlr
                        else (None, None))
            agg = _sharded_aggregate(u, s, jcfg, d, key, ml, mf)
        return jax_telemetry.compute_sharded(
            jcfg, u, lr, agg, ax, mask_local=ml, mask_full=mf,
            corrupt_full=flags, sign_sums=sums)
    fn = jax.jit(shard_map(
        body, mesh=make_mesh(d),
        in_specs=(P(), P(ax), P(ax), P(ax), P(), P()),
        out_specs={k: P() for k in jax_telemetry.telemetry_keys(jcfg)},
        check_vma=False))
    return fn({k: jnp.asarray(v) for k, v in params.items()},
              {k: jnp.asarray(v) for k, v in updates.items()},
              jnp.asarray(sizes), jnp.asarray(MASK), jnp.asarray(MASK),
              jnp.asarray(CORRUPT))


def _check(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        if k in COUNTS:
            # counts over the coordinate count: XLA divides by the constant
            # as a reciprocal-multiply, one ulp off a division
            np.testing.assert_allclose(g, w, rtol=2.0 ** -23, atol=0,
                                       err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{what} {k}")


def test_sharded_telemetry_matches_jax():
    model = registry.get_model("fmnist", (14, 14, 1))
    shapes = {k: tuple(p.shape) for k, p in sorted(model.named_parameters())}
    rng = np.random.default_rng(21)
    params = {k: rng.normal(size=s).astype(np.float32) * 0.1
              for k, s in shapes.items()}
    updates = {k: rng.normal(size=(M,) + s).astype(np.float32) * 0.01
               for k, s in shapes.items()}
    for k in updates:                   # the corrupt rows lean one way
        updates[k][CORRUPT] += 0.02
    sizes = rng.integers(20, 120, size=M).astype(np.int32)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    cases = [(aggr, thr, layout, level, masked)
             for aggr, thr, layout in (("avg", 3, "leaf"), ("sign", 3, "leaf"),
                                       ("comed", 0, "leaf"),
                                       ("avg", 3, "bucket"),
                                       ("sign", 0, "bucket"))
             for level in ("basic", "full") for masked in (False, True)]

    def cfg_kw(aggr, thr, layout, level, masked):
        return dict(aggr=aggr, robustLR_threshold=thr, agg_layout=layout,
                    telemetry=level, num_agents=M, num_corrupt=2,
                    server_lr=0.5)

    for d in (2, 4):
        mb = M // d

        def rank(group):
            lo = group.rank * mb
            block = {k: torch.from_numpy(v[lo:lo + mb])
                     for k, v in updates.items()}
            out = {}
            for case in cases:
                cfg = Config(**cfg_kw(*case), device="cpu", health="off",
                             use_fused=False)
                group.reset_counts()
                _, info, _, _ = sharded_server_path(
                    tp, block, torch.from_numpy(sizes[lo:lo + mb]), cfg,
                    group, qmask=torch.from_numpy(MASK) if case[4] else None,
                    flags=torch.from_numpy(CORRUPT))
                out[case] = ({k: v.numpy().copy() for k, v in info.items()},
                             dict(group.counts))
            return out

        results = run_in_threads(d, rank)
        for case in cases:
            what = f"{case} d={d}"
            want = _jax_telemetry(JaxConfig(**cfg_kw(*case)), d, case[4],
                                  params, updates, sizes)
            cfg = Config(**cfg_kw(*case), device="cpu")
            plan = multihost.plan_collectives(cfg, tp, d)
            plan["all_reduce"] -= 1         # the loss's
            for got, counts in (r[case] for r in results):
                assert set(got) == set(telemetry.telemetry_keys(cfg)), what
                _check(got, want, what)
                assert counts == plan, (what, counts, plan)


def _rows(path):
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return {(r["tag"], r["step"]): r["value"] for r in rows}


def test_sharded_run_rows_match_dense(tmp_path, capsys):
    """train.run on d = 2 ranks under --agg_layout bucket, --telemetry
    full, --dropout_rate 0.3 and --quarantine 0, and on the leaf layout
    under comed with --telemetry basic and churn: the lead's Defense/*,
    Faults/* and Churn/* rows against the dense run's, and every rank's
    collectives the plan's times the rounds."""
    kw = dict(data="synthetic", num_agents=4, bs=16, local_ep=1, rounds=2,
              snap=1, synth_train_size=128, synth_val_size=64, eval_bs=32,
              num_corrupt=1, poison_frac=1.0, robustLR_threshold=2,
              device="cpu", tensorboard=False)
    cases = {
        "bucket": dict(agg_layout="bucket", telemetry="full",
                       dropout_rate=0.3, quarantine="0"),
        "comed": dict(aggr="comed", telemetry="basic", churn_available=0.5,
                      churn_period=1),
    }
    for name, extra in cases.items():
        dense = train.run(Config(**kw, **extra,
                                 log_dir=str(tmp_path / f"dense_{name}")))
        cfg = Config(**kw, **extra, log_dir=str(tmp_path / f"sh_{name}"))

        def rank(group, cfg=cfg):
            out = train.run(cfg, group=group)
            return out, dict(group.counts)

        results = run_in_threads(2, rank)
        said = capsys.readouterr().out
        assert said.count("[agg] ") == 1, said
        (dpath,) = (tmp_path / f"dense_{name}").glob("*/metrics.jsonl")
        (spath,) = (tmp_path / f"sh_{name}").glob("*/metrics.jsonl")
        drows, srows = _rows(dpath), _rows(spath)
        keys = {key for key in drows
                if key[0].split("/")[0] in ("Defense", "Faults", "Churn")}
        assert {key[0] for key in keys} >= set(telemetry.tags(cfg)), name
        assert keys == {key for key in srows
                        if key[0].split("/")[0] in ("Defense", "Faults",
                                                    "Churn")}, name
        for key in sorted(keys):
            if key[0].startswith(("Faults/", "Churn/")):
                assert srows[key] == drows[key], (name, key)
            else:
                np.testing.assert_allclose(srows[key], drows[key],
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"{name} {key}")
        params = dense["params"]
        plan = multihost.plan_collectives(cfg, params, 2)
        for summary, counts in results:
            assert counts == {k: n * cfg.rounds for k, n in plan.items()}
            assert summary["collectives"] == counts
            for k, p in params.items():
                np.testing.assert_allclose(summary["params"][k].numpy(),
                                           p.numpy(), atol=1e-5, rtol=1e-5,
                                           err_msg=f"{name} {k}")
