"""The port's cohort-sampled round (fl/rounds.make_cohort_round_fn)
against the JAX package's `make_cohort_round_fn`, the equal cohort against
the dense round, and a cut and resumed cohort run against the straight
one.

Controlled variables as tests/test_torch_host.py: a Flax init carried
across, dropout off, each slot's epoch permutations replayed from the JAX
keys and injected, and the cohort JAX's own (`sample_cohort_host`), fed
to the port's round as its ids and `active` mask. CNN_MNIST at the
synthetic stand-in's narrow 8x8x1, K = 64 clients in a dirichlet bank,
m = 8, bs 32 (16-sample rows padded to 32), 6 corrupt clients poisoning
half their base-class samples, RLR threshold 2, churn 0.1 (a shortfall:
inactive padding slots in the mask), full telemetry and the reputation
lanes. JAX's round runs under its own plain `jax.jit`. Held: the gathered
rows byte for byte; the round's update within 1e-4 of its scale per
coordinate and 1e-5 relative L2 (f32, other summation orders); the
loss, the telemetry and the lanes at 1e-5; the Faults/* and churn counts
exactly, and under dropout 1.0 with --faults_spare_corrupt the electorate
is the round's active corrupt members on both sides.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu.config import (
    Config as JaxConfig)
from defending_against_backdoors_with_robust_learning_rate_tpu.data import (
    cohort as jax_cohort)
from defending_against_backdoors_with_robust_learning_rate_tpu.data.registry import (
    get_cohort_data as jax_get_cohort_data)
from defending_against_backdoors_with_robust_learning_rate_tpu.fl import (
    rounds as jax_rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu.fl.common import (
    make_normalizer as jax_make_normalizer)
from defending_against_backdoors_with_robust_learning_rate_tpu.models.cnn import (
    CNN_MNIST as JaxCNN)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch import (
    train)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data import (
    cohort)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data.registry import (
    get_cohort_data, get_federated_data)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    common, rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    carrier, registry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils import (
    checkpoint as ckpt)

SHAPE = (8, 8, 1)
MEAN, STD = (0.5,), (0.5,)
KW = dict(data="synthetic", num_agents=64, cohort_sampled="on",
          cohort_size=8, partitioner="dirichlet", bs=32, local_ep=2,
          client_lr=0.1, client_moment=0.9, synth_train_size=1024,
          synth_val_size=64, num_corrupt=6, poison_frac=0.5,
          robustLR_threshold=2, churn_available=0.1, churn_period=4,
          telemetry="full")


class _NoDropout:
    """A Flax module whose train-mode forward runs without dropout."""

    def __init__(self, inner):
        self._inner = inner

    def apply(self, variables, x, train=False, rngs=None):
        del train, rngs
        return self._inner.apply(variables, x, train=False)


def _epoch_perms(key, size, n_total, local_ep):
    """fl/client.make_local_train's shuffle, replayed from the agent's key."""
    perms = []
    for ep_key in jax.random.split(key, local_ep):
        shuffle_key, _ = jax.random.split(ep_key)
        r = jax.random.uniform(shuffle_key, (n_total,))
        r = jnp.where(jnp.arange(n_total) < size, r, 2.0)
        perms.append(torch.from_numpy(np.array(jnp.argsort(r))).long())
    return perms


def _flat(params):
    return np.concatenate([np.asarray(v.detach()).ravel()
                           for v in params.values()])


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_cohort_round_matches_jax(tmp_path):
    data_dir = str(tmp_path / "nodata")
    jcfg = JaxConfig(**KW, data_dir=data_dir, log_dir=str(tmp_path / "j"))
    cfg = Config(**KW, data_dir=data_dir, log_dir=str(tmp_path / "p"),
                 device="cpu")
    # a round whose cohort has a shortfall and an active corrupt member
    rnd = next(r for r in range(1, 200)
               if not (a := jax_cohort.sample_cohort_host(jcfg, r)[1]).all()
               and ((jax_cohort.sample_cohort_host(jcfg, r)[0] < 6)
                    & a).any())
    ids, active = jax_cohort.sample_cohort_host(jcfg, rnd)
    j_src, src = jax_get_cohort_data(jcfg), get_cohort_data(cfg)
    imgs, lbls, szs = j_src.gather_cohort(ids)
    for got, want in zip(src.gather_cohort(ids), (imgs, lbls, szs),
                         strict=True):
        np.testing.assert_array_equal(got, want)
    n_total = src.max_n
    assert n_total == 32 and cfg.agents_per_round == 8

    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(JaxCNN().init, jax.random.PRNGKey(0),
                            jnp.zeros((1,) + SHAPE))["params"]
    flax_params = {mod: {name: (rng.normal(size=leaf.shape) / np.sqrt(
        np.prod(leaf.shape[:-1]) if name == "kernel" else 10.0)).astype(
            np.float32) for name, leaf in leaves.items()}
        for mod, leaves in shapes.items()}
    fn = jax_rounds.make_cohort_round_fn(
        jcfg, _NoDropout(JaxCNN()), jax_make_normalizer(MEAN, STD, False))
    key = jax.random.PRNGKey(11)
    j_new, j_info = fn(flax_params, key, jnp.int32(rnd), jnp.asarray(imgs),
                       jnp.asarray(lbls), jnp.asarray(szs))
    np.testing.assert_array_equal(np.asarray(j_info["sampled"]), ids)
    agent_keys = jax.random.split(jax.random.split(key)[0], len(ids))
    perms = [_epoch_perms(agent_keys[s], int(szs[s]), n_total,
                          jcfg.local_ep) for s in range(len(ids))]

    model = registry.get_model("synthetic", SHAPE)
    norm = common.make_normalizer(MEAN, STD, "cpu")
    params = carrier.params_from_flax(flax_params, "cpu")
    assert not rounds._fused_applicable(cfg)
    round_fn = rounds.make_cohort_round_fn(cfg, model, norm, n_total, "cpu")
    assert round_fn.graph is None
    rr = rounds.RoundRNG(0, "cpu")
    rr.round = rnd - 1
    new, info = round_fn(params, rr, ids, torch.from_numpy(imgs),
                         torch.from_numpy(lbls).long(),
                         torch.from_numpy(szs), active, szs, perms=perms,
                         dropout=False)
    assert info["sampled"] == ids.tolist()
    ours = _flat(new) - _flat(params)
    ref = _flat(carrier.params_from_flax(
        jax.tree_util.tree_map(np.asarray, j_new), "cpu")) - _flat(params)
    scale = np.abs(ref).max()
    assert scale > 1e-3
    np.testing.assert_allclose(ours, ref, atol=1e-4 * scale, rtol=0)
    assert np.linalg.norm(ours - ref) / np.linalg.norm(ref) < 1e-5
    np.testing.assert_allclose(float(info["train_loss"]),
                               float(j_info["train_loss"]), rtol=1e-5)
    # the shortfall's padding left the electorate; churn's counts
    for k in ("fault_dropped", "fault_straggled", "fault_voters",
              "churn_away"):
        assert float(info[k]) == float(j_info[k]), k
    assert float(info["churn_away"]) == (~active).sum() > 0
    # the cosine split over active corrupt members, the lanes
    for k in ("tel_cos_honest", "tel_cos_corrupt", "tel_upd_norm_max",
              "tel_flip_frac", "tel_margin_mean"):
        np.testing.assert_allclose(float(info[k]), float(j_info[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert float(info["tel_cos_corrupt"]) != 0.0
    for k in ("rep_agree", "rep_norm"):
        np.testing.assert_allclose(info[k].numpy(), np.asarray(j_info[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)

    # --faults_spare_corrupt spares the round's active corrupt members
    # (JAX tests/test_population.py:664): under dropout 1.0 they alone
    # vote, on both sides
    spare = dict(dropout_rate=1.0, faults_spare_corrupt=True)
    _, j_f = jax_rounds.make_cohort_round_fn(
        jcfg.replace(**spare), _NoDropout(JaxCNN()),
        jax_make_normalizer(MEAN, STD, False))(
            flax_params, key, jnp.int32(rnd), jnp.asarray(imgs),
            jnp.asarray(lbls), jnp.asarray(szs))
    rr = rounds.RoundRNG(0, "cpu")
    rr.round = rnd - 1
    _, f = rounds.make_cohort_round_fn(cfg.replace(**spare), model, norm,
                                       n_total, "cpu")(
        params, rr, ids, torch.from_numpy(imgs),
        torch.from_numpy(lbls).long(), torch.from_numpy(szs), active, szs,
        perms=perms, dropout=False)
    n_cor = int(((ids < 6) & active).sum())
    assert float(f["fault_voters"]) == float(j_f["fault_voters"]) == n_cor
    assert float(f["fault_dropped"]) == float(j_f["fault_dropped"]) \
        == len(ids) - n_cor


def _rows(cfg, first):
    path = f"{cfg.log_dir}/{train.run_name(cfg)}/metrics.jsonl"
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    start = max(i for i, r in enumerate(rows) if r["tag"] == "_run/start")
    return [r for r in rows[start:] if r["step"] >= first
            and not r["tag"].startswith(("_run/", "Throughput/"))]


def test_equal_cohort_and_resume(tmp_path):
    # K = m = 10, label_shards: the bank rows are the dense stacked rows,
    # and the cohort round equals the dense round given the same ids
    # (the plain server step on both sides), bit for bit
    kw = dict(data="synthetic", num_agents=10, cohort_size=10, bs=32,
              local_ep=1, synth_train_size=1000, synth_val_size=64,
              num_corrupt=1, poison_frac=0.5, robustLR_threshold=4,
              partitioner="label_shards", data_dir=str(tmp_path / "nodata"),
              log_dir=str(tmp_path / "eq"), device="cpu", use_fused=False)
    cfg = Config(cohort_sampled="on", **kw)
    src = get_cohort_data(cfg)
    fed = get_federated_data(Config(cohort_sampled="off", **kw))
    model = registry.get_model("synthetic", SHAPE)
    norm = common.make_normalizer(MEAN, STD, "cpu")
    params = registry.init_params(model, 0, "cpu")
    dense = rounds.make_round_fn(
        cfg.replace(cohort_sampled="off"), model, norm,
        torch.from_numpy(fed.train.images),
        torch.from_numpy(fed.train.labels).long(), fed.train.sizes)
    coh = rounds.make_cohort_round_fn(cfg, model, norm, src.max_n, "cpu")
    full = [r for r in range(1, 40) if cohort.sample_cohort(cfg, r)[1].all()]
    assert len(full) >= 2
    for rnd in full[:2]:
        ids, active = cohort.sample_cohort(cfg, rnd)
        imgs, lbls, szs = src.gather_cohort(ids)
        for got, want in zip((imgs, lbls, szs), (fed.train.images[ids],
                                                 fed.train.labels[ids],
                                                 fed.train.sizes[ids]),
                             strict=True):
            np.testing.assert_array_equal(got, want)
        rd, rc = rounds.RoundRNG(3, "cpu"), rounds.RoundRNG(3, "cpu")
        rd.round = rc.round = rnd - 1
        p_d, i_d = dense(params, rd, sampled=ids.tolist())
        p_c, i_c = coh(params, rc, ids, torch.from_numpy(imgs),
                       torch.from_numpy(lbls).long(), torch.from_numpy(szs),
                       active, szs)
        for k in params:
            assert torch.equal(p_c[k], p_d[k]), (rnd, k)
        assert torch.equal(i_c["train_loss"], i_d["train_loss"])
        assert torch.equal(i_c["rep_agree"], i_d["rep_agree"])

    # a cohort run cut at round 2 and resumed to 4 == the straight 4
    # rounds (the draws are pure functions of the seeds and the round):
    # params bit for bit, every row of rounds 3-4 but Throughput/*
    base = Config(data="synthetic", num_agents=5000, cohort_size=8,
                  partitioner="dirichlet", bs=16, local_ep=1,
                  synth_train_size=512, synth_val_size=64, eval_bs=32,
                  num_corrupt=50, poison_frac=0.5, robustLR_threshold=2,
                  churn_available=0.5, churn_period=2, snap=2, chain=2,
                  data_dir=str(tmp_path / "nodata"), tensorboard=False,
                  device="cpu")
    straight = base.replace(rounds=4, log_dir=str(tmp_path / "a"),
                            checkpoint_dir=str(tmp_path / "ck_a"))
    cut = base.replace(rounds=2, log_dir=str(tmp_path / "b"),
                       checkpoint_dir=str(tmp_path / "ck_b"))
    want = train.run(straight)
    train.run(cut)
    got = train.run(cut.replace(rounds=4, resume=True))
    assert ckpt.saved_rounds(cut.checkpoint_dir) == [2, 4]
    for k, v in want["params"].items():
        assert torch.equal(got["params"][k], v), k
    rows_a, rows_b = _rows(straight, 3), _rows(cut, 3)
    assert rows_a == rows_b
    tags = {r["tag"] for r in rows_a}
    assert {"Churn/Sampled_Away", "Faults/Effective_Voters",
            "Reputation/Clients_Tracked"} <= tags
