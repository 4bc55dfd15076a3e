"""The buffered path's latency draw: `data/traffic.latency_quantile`
against the JAX package's, and the staleness histogram of the port's
dense buffered round against the arrival schedule its host draw predicts.

`latency_quantile` maps uniforms to heavy-tailed staleness in float32
(ceil(exp(sigma * sqrt(2) * erfinv(2u - 1))), clipped to [1, S]); both
sides get the same 1,000,000 uniforms of `jax.random.uniform(PRNGKey(0))`
and the edge values, and must give the same integers for every sigma and
S tried. The ceiling could flip where exp(sigma * z) lies within an ulp of
an integer; no such case occurs among these uniforms. JAX's side runs
under a plain `jax.jit`.

The schedule (JAX tests/test_buffered.py::
test_pending_arrivals_match_host_mirror): a latency-T draw of tick t lands
at tick t + T in staleness bin T. With a commit gate the run never
reaches, the emitted Async/Staleness_Hist after each tick must equal the
cumulative arrivals predicted from `fl/buffered.host_latency_draw` over
the fault draw's stragglers, and the fill their sum.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import jax
import numpy as np
import pytest
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu.config import (
    Config as JaxConfig)
from defending_against_backdoors_with_robust_learning_rate_tpu.data import (
    traffic as jax_traffic)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data import (
    traffic)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data.registry import (
    get_federated_data)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.faults import (
    model as fmodel)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    buffered, common, rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    registry)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_latency_quantile_matches_jax_bit_for_bit():
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (1_000_000,)))
    edges = np.array([0.0, 0.5, 0.5 + 2.0 ** -24, 0.5 - 2.0 ** -24,
                      2.0 ** -24, 1.0 - 2.0 ** -24, 0.25, 0.75], np.float32)
    for sigma in (0.8, 0.3, 1.5):
        for S in (1, 4, 8):
            jcfg = JaxConfig(traffic_latency_sigma=sigma)
            cfg = Config(traffic_latency_sigma=sigma)
            draw = jax.jit(lambda x: jax_traffic.latency_quantile(jcfg, x, S))
            for x in (u, edges):
                got = traffic.latency_quantile(cfg, x, S)
                assert got.dtype == torch.int32
                np.testing.assert_array_equal(got.numpy(),
                                              np.asarray(draw(x)),
                                              err_msg=f"sigma {sigma} S {S}")
            got = traffic.latency_quantile(cfg, u, S).numpy()
            assert got.min() >= 1 and got.max() <= S
            # most uploads land next tick
            assert np.bincount(got).argmax() == 1, (sigma, S)


def test_staleness_histogram_matches_host_schedule(tmp_path):
    m, S, n = 6, 3, 5
    cfg = Config(data="synthetic", num_agents=m, bs=16, local_ep=1,
                 synth_train_size=192, synth_val_size=32, device="cpu",
                 data_dir=str(tmp_path / "nodata"), agg_mode="buffered",
                 straggler_rate=0.7, async_max_staleness=S,
                 async_buffer_k=10_000, robustLR_threshold=2)
    fed = get_federated_data(cfg)
    model = registry.get_model(cfg.data, cfg.image_shape)
    norm = common.make_normalizer(fed.mean, fed.std, "cpu")
    fn = rounds.make_round_fn(cfg, model, norm,
                              torch.from_numpy(fed.train.images),
                              torch.from_numpy(fed.train.labels).long(),
                              fed.train.sizes)
    params = registry.init_params(model, cfg.seed, "cpu")
    carry = buffered.join_carry(params, buffered.init_state(cfg, params))
    expect = np.zeros((n + 1, S + 1))
    late = 0
    for t in range(1, n + 1):
        strag = fmodel.sample_faults(
            cfg, rounds.RoundRNG(cfg.seed, "cpu").faults(t), m).straggler
        draws = buffered.host_latency_draw(cfg, t, strag, cfg.seed)
        assert ((draws > 0) == strag).all()
        late += int((draws > 1).sum())
        for T in draws.tolist():
            if t + T <= n:
                expect[t + T, T] += 1
    assert late > 0     # some arrivals are more than one tick late
    rng = rounds.RoundRNG(cfg.seed, "cpu")
    cum = np.zeros(S + 1)
    for r in range(1, n + 1):
        carry, info = fn(carry, rng)
        cum += expect[r]
        np.testing.assert_array_equal(info["async_stale_hist"].numpy(), cum)
        assert float(info["async_fill"]) == cum.sum()
        assert float(info["async_committed"]) == 0.0
        # the params never move while the buffer fills
        for k, v in params.items():
            assert torch.equal(carry[k], v), k
