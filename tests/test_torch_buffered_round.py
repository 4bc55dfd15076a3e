"""The port's dense buffered round (fl/rounds.make_round_fn under
--agg_mode buffered) against its sync round, and its commit cadence.

Degenerate parity (JAX tests/test_buffered.py::test_vmap_parity_*): with
K = m, no stragglers and the exponent 0 every tick's arrivals are the
whole cohort, the gate fires every tick, and the fold is the sync plain
server step's op sequence (--no_fused: the step through ops/aggregate.py).
Three ticks of each from the same params and draws: the params equal
bit for bit for sign + RLR and within 1e-6 relative for avg, with the
dense electorate and under dropout (the participation mask, a scaled
threshold, K = 1 so that every tick commits); the train loss, the
reputation lanes and the health lanes equal. Cadence (JAX
test_commit_cadence_k2m): K = 2m commits every other tick, the fill m
then 2m, the params are frozen bit for bit on the ticks that do not
commit, and the carry keeps its keys in their order (the captured round
is keyed by the carry's structure).

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import pytest
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data.registry import (
    get_federated_data)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    buffered, common, rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    registry)

M = 6


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _base(tmp_path, **kw):
    return Config(data="synthetic", num_agents=M, bs=16, local_ep=2,
                  synth_train_size=192, synth_val_size=32, device="cpu",
                  num_corrupt=1, poison_frac=0.5, robustLR_threshold=2,
                  data_dir=str(tmp_path / "nodata")).replace(**kw)


def _round(cfg):
    """(round fn, initial params or carry) of cfg's dense round."""
    fed = get_federated_data(cfg)
    model = registry.get_model(cfg.data, cfg.image_shape)
    norm = common.make_normalizer(fed.mean, fed.std, "cpu")
    fn = rounds.make_round_fn(cfg, model, norm,
                              torch.from_numpy(fed.train.images),
                              torch.from_numpy(fed.train.labels).long(),
                              fed.train.sizes)
    params = registry.init_params(model, cfg.seed, "cpu")
    if buffered.is_buffered(cfg):
        params = buffered.join_carry(params, buffered.init_state(cfg, params))
    return fn, params


def test_degenerate_buffered_equals_sync(tmp_path):
    # under dropout the electorate is the mask's: K = 1 commits every tick
    cases = (dict(aggr="sign", server_lr=0.5),
             dict(aggr="sign", server_lr=0.5, dropout_rate=0.3,
                  rlr_threshold_mode="scaled", async_buffer_k=1),
             dict(aggr="avg"),
             dict(aggr="avg", dropout_rate=0.3, async_buffer_k=1))
    for kw in cases:
        kw = dict(kw)
        k = kw.pop("async_buffer_k", 0)
        sync = _base(tmp_path, use_fused=False, **kw)
        buf = sync.replace(agg_mode="buffered", async_buffer_k=k)
        assert not rounds._fused_applicable(buf.replace(use_fused=True))
        fn_s, ps = _round(sync)
        fn_b, carry = _round(buf)
        rng_s, rng_b = (rounds.RoundRNG(sync.seed, "cpu") for _ in range(2))
        for r in range(1, 4):
            ps, info_s = fn_s(ps, rng_s)
            carry, info_b = fn_b(carry, rng_b)
            what = f"{kw} tick {r}"
            assert float(info_b["async_committed"]) == 1.0, what
            assert float(info_b["async_fill"]) == float(
                info_s.get("fault_voters", M)), what
            assert float(info_b["train_loss"]) == float(
                info_s["train_loss"]), what
            for k in ("rep_agree", "rep_norm", "hlth_nonfinite",
                      "hlth_update_normsq", "hlth_params_finite",
                      "hlth_agent_bad"):
                assert torch.equal(info_b[k], info_s[k]), (what, k)
            for k, v in ps.items():
                if kw["aggr"] == "sign":
                    assert torch.equal(carry[k], v), (what, k)
                else:
                    torch.testing.assert_close(
                        carry[k], v, rtol=1e-6,
                        atol=1e-6 * float(v.abs().max()), msg=what)
        # the buffer is empty after each commit
        _, state = buffered.split_carry(carry)
        assert float(state["count"]) == 0.0
        assert not any(bool(v.any()) for v in state.values())


def test_commit_every_other_tick_at_k_2m(tmp_path):
    for aggr in ("avg", "sign"):
        cfg = _base(tmp_path, aggr=aggr, agg_mode="buffered",
                    async_buffer_k=2 * M)
        fn, carry = _round(cfg)
        keys = list(carry)
        rng = rounds.RoundRNG(cfg.seed, "cpu")
        prev = buffered.model_params(carry)
        for r in range(1, 5):
            carry, info = fn(carry, rng)
            # the carry keeps its structure (a captured round is keyed by
            # it)
            assert list(carry) == keys, (aggr, r)
            committed = float(info["async_committed"])
            assert committed == float(r % 2 == 0), (aggr, r)
            assert float(info["async_fill"]) == M * (2 - r % 2), (aggr, r)
            now = buffered.model_params(carry)
            same = [torch.equal(now[k], v) for k, v in prev.items()]
            if committed:
                assert not all(same), (aggr, r)
            else:
                assert all(same), (aggr, r)
            _, state = buffered.split_carry(carry)
            assert float(state["count"]) == (0.0 if committed else M)
            prev = {k: v.clone() for k, v in now.items()}
