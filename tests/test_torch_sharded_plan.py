"""The sharded round's collective plan (parallel/multihost.plan_collectives):
pinned against the counts JAX's static analysis keeps for its sharded
families in analysis_baseline.json, and held equal, kind by kind, to what
the port's sharded round makes on d = 2 gloo thread ranks
(parallel/mesh.run_in_threads) for every rule, both layouts, the noise,
the faults, the quarantine set, churn and the telemetry.

JAX's baseline counts jaxpr collectives at 8 devices with the contract
config (analysis/contracts.py: synthetic data, 8 agents, RLR 4). The
bucket families match the port's plan kind for kind (psum is the port's
all_reduce); on the leaf layout JAX counts one psum per leaf, which XLA's
combiner merges into the port's one packed all_reduce, so there the added
all_gathers of faults and telemetry are what is pinned.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    common, rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    registry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel import (
    multihost)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.mesh import (
    KINDS, run_in_threads)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.rounds import (
    make_sharded_round_fn)

BASELINE = pathlib.Path(__file__).resolve().parent.parent / (
    "analysis_baseline.json")
# JAX's jaxpr primitive -> the port's collective kind
KIND_OF = {"psum": "all_reduce", "all_gather": "all_gather",
           "all_to_all": "all_to_all", "reduce_scatter": "reduce_scatter"}
CONTRACT = dict(data="synthetic", num_agents=8, bs=16, local_ep=1,
                num_corrupt=2, poison_frac=0.5, robustLR_threshold=4,
                aggr="avg", device="cpu")
FAULTS = dict(dropout_rate=0.3, payload_norm_cap=100.0,
              faults_spare_corrupt=True)
# family -> the contract overrides (analysis/contracts.py check_specs)
BUCKET_FAMILIES = {
    "sharded_rlr_avg_bucket": dict(agg_layout="bucket"),
    "sharded_rlr_sign_bucket": dict(agg_layout="bucket", aggr="sign",
                                    server_lr=1.0),
    "sharded_rlr_avg_bucket_faults": dict(agg_layout="bucket", **FAULTS),
    "sharded_rlr_avg_bucket_tel_full": dict(agg_layout="bucket",
                                            telemetry="full"),
    "sharded_rlr_sign_bucket_tel_full": dict(agg_layout="bucket",
                                             aggr="sign", server_lr=1.0,
                                             telemetry="full"),
}
LEAF_FAMILIES = {
    "sharded_rlr_avg": {},
    "sharded_rlr_avg_faults": dict(FAULTS),
    "sharded_rlr_avg_atk_boost_faults": dict(attack="boost", **FAULTS),
    "sharded_rlr_avg_tel_full": dict(telemetry="full"),
    "sharded_rlr_sign_tel_full": dict(aggr="sign", server_lr=1.0,
                                      telemetry="full"),
}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_plan_matches_jax_baseline():
    families = json.loads(BASELINE.read_text())["families"]
    # the contract's CNN on its 28x28 synthetic images: one bucket
    params = registry.init_params(registry.get_model("synthetic",
                                                     (28, 28, 1)), 0, "cpu")
    for name, kw in BUCKET_FAMILIES.items():
        want = {KIND_OF[k]: n
                for k, n in families[name]["collectives"].items()}
        got = multihost.plan_collectives(Config(**{**CONTRACT, **kw}),
                                         params, 8)
        assert {k: n for k, n in got.items() if n} == want, name
    for name, kw in LEAF_FAMILIES.items():
        jax_counts = families[name]["collectives"]
        got = multihost.plan_collectives(Config(**{**CONTRACT, **kw}),
                                         params, 8)
        assert got["all_gather"] == jax_counts.get("all_gather", 0), name
        assert got["all_to_all"] == got["reduce_scatter"] == 0, name
        # the loss, the weight total for avg, one packed buffer
        assert got["all_reduce"] == (3 if kw.get("aggr", "avg") == "avg"
                                     else 2), name
    # the robust rules, counted from the code: one transpose and one
    # gather a round, krum's [m, m] all_reduce, rfa's 1 + 2 x 4
    # all_reduces, and the vote's packed all_reduce with RLR
    for aggr, want in (("comed", (2, 1, 1)), ("trmean", (2, 1, 1)),
                       ("krum", (3, 1, 1)), ("rfa", (11, 0, 0))):
        plan = multihost.plan_collectives(
            Config(**{**CONTRACT, "aggr": aggr}), params, 8)
        assert (plan["all_reduce"], plan["all_to_all"],
                plan["all_gather"]) == want, aggr
        off = Config(**{**CONTRACT, "aggr": aggr, "robustLR_threshold": 0})
        assert multihost.plan_collectives(off, params, 8)["all_reduce"] == (
            want[0] - 1), aggr
    # ResNet-9's 4.9 M coordinates take two buckets: two reduce_scatters
    big = {"w": torch.zeros(4_900_000)}
    assert multihost.plan_collectives(Config(**CONTRACT, agg_layout="bucket"),
                                      big, 8)["reduce_scatter"] == 2
    assert multihost.leaf_plan_collectives(Config(**CONTRACT)) == 3


def test_round_counts_equal_plan():
    """Every rule on both layouts (the bucket layout for avg and sign), with
    nothing, with the server noise, with faults, a quarantine set and
    churn, and with each telemetry level: one round on d = 2 ranks makes
    the plan's collectives, kind by kind, and its [agg] line names them."""
    rng = np.random.default_rng(0)
    shape = (14, 14, 1)
    xs = torch.from_numpy(rng.uniform(0, 255, size=(4, 32) + shape)
                          .astype(np.float32))
    ys = torch.from_numpy(rng.integers(0, 10, size=(4, 32)))
    sizes = np.array([32, 20, 17, 32], np.int32)
    norm = common.make_normalizer((0.5,), (0.5,), "cpu")
    params = registry.init_params(registry.get_model("fmnist", shape), 1,
                                  "cpu")
    base = dict(data="fmnist", num_agents=4, bs=16, local_ep=1, num_corrupt=1,
                robustLR_threshold=2, device="cpu")
    extras = [{}, dict(noise=0.001),
              dict(dropout_rate=0.5, corrupt_rate=0.3, quarantine="2",
                   churn_available=0.5, churn_period=1),
              dict(telemetry="basic"),
              dict(telemetry="full", dropout_rate=0.5)]
    cfgs = [Config(**base, aggr=aggr, agg_layout=layout, **extra)
            for aggr in ("avg", "sign", "comed", "trmean", "krum", "rfa")
            for layout in (("leaf", "bucket") if aggr in ("avg", "sign")
                           else ("leaf",))
            for extra in extras]

    def rank(group):
        out = []
        for cfg in cfgs:
            fn = make_sharded_round_fn(cfg, registry.get_model("fmnist",
                                                               shape),
                                       norm, group, xs, ys, sizes)
            group.reset_counts()
            fn(params, rounds.RoundRNG(3, "cpu"))
            out.append((dict(group.counts),
                        multihost.agg_plan_note(cfg, params, group)))
        return out

    for results in run_in_threads(2, rank, timeout_s=600):
        for cfg, (counts, note) in zip(cfgs, results):
            plan = multihost.plan_collectives(cfg, params, 2)
            what = (cfg.aggr, cfg.agg_layout, cfg.noise, cfg.telemetry,
                    cfg.faults_enabled)
            assert counts == plan, (what, counts, plan)
            assert set(counts) == set(KINDS)
            for kind, n in plan.items():
                assert (f"{n} {kind}" in note) == (n > 0), (what, note)
