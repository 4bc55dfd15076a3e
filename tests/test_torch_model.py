"""The port's models, weight carrier, normalizer and eval against the JAX
package's, on weights carried across from a Flax init.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu.fl import (
    common as jax_common, evaluate as jax_evaluate)
from defending_against_backdoors_with_robust_learning_rate_tpu.models import (
    cnn as jax_cnn)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    common, evaluate)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    carrier, registry)

MEAN, STD = (0.2860,), (0.3530,)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _flax_params(model, shape, seed):
    """Random Flax-layout params from numpy (shapes from an abstract init,
    which compiles nothing): kernels at 1/sqrt(fan_in), nonzero biases."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1,) + shape))["params"]
    rng = np.random.default_rng(seed)
    return {mod: {name: (rng.normal(size=leaf.shape)
                         / np.sqrt(np.prod(leaf.shape[:-1]) if
                                   name == "kernel" else 10.0)
                         ).astype(np.float32)
                  for name, leaf in leaves.items()}
            for mod, leaves in shapes.items()}


def test_cnn_forward_through_carrier():
    for data, jax_model, shape in (
            ("fmnist", jax_cnn.CNN_MNIST(), (28, 28, 1)),
            ("synthetic", jax_cnn.CNN_MNIST(), (8, 8, 1)),
            ("cifar10", jax_cnn.CNN_CIFAR(), (32, 32, 3))):
        fp = _flax_params(jax_model, shape, 0)
        model = registry.get_model(data, shape)
        params = carrier.params_from_flax(fp, "cpu")
        assert list(params) == [n for n, _ in model.named_parameters()]
        for name, p in model.named_parameters():
            assert params[name].shape == p.shape, name
        # the carrier's inverse gives the Flax arrays back bit for bit
        back = carrier.flax_from_params(params)
        for mod in fp:
            for leaf in ("kernel", "bias"):
                np.testing.assert_array_equal(back[mod][leaf], fp[mod][leaf])
        x = np.random.default_rng(4).normal(size=(8,) + shape).astype(
            np.float32)
        want = np.asarray(jax_model.apply({"params": fp}, jnp.asarray(x)))
        got = torch.func.functional_call(
            model, params, (torch.from_numpy(x).permute(0, 3, 1, 2),))
        # f32 conv/matmul in another summation order: 1e-5
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5,
                                   err_msg=data)

    # init: Flax's lecun_normal (std 1/sqrt(fan_in), truncated at 2 std),
    # zero biases, deterministic in the seed
    model = registry.get_model("fmnist", (28, 28, 1))
    a, b = (registry.init_params(model, 5, "cpu") for _ in range(2))
    assert registry.param_count(a) == 1199882
    for name, t in a.items():
        torch.testing.assert_close(t, b[name], atol=0, rtol=0)
        if name.endswith("bias"):
            assert not t.any()
        elif t.numel() > 10000:
            fan_in = t[0].numel()
            # sample std of >= 18k draws: within 5% of 1/sqrt(fan_in)
            assert abs(float(t.std()) * fan_in ** 0.5 - 1.0) < 0.05, name
            assert float(t.abs().max()) * fan_in ** 0.5 <= 2.0 / 0.8796 + 1e-4


def test_eval_metrics_match_jax():
    """Loss, accuracy and per-class accuracy on a padded eval set (70
    samples in batches of 32), same carried weights."""
    shape = (28, 28, 1)
    fp = _flax_params(jax_cnn.CNN_MNIST(), shape, 1)
    rng = np.random.default_rng(6)
    x = rng.integers(0, 256, size=(70,) + shape, dtype=np.uint8)
    y = rng.integers(0, 10, size=(70,)).astype(np.int32)

    jnorm = jax_common.make_normalizer(MEAN, STD, False)
    norm = common.make_normalizer(MEAN, STD, "cpu")
    np.testing.assert_allclose(
        norm(torch.from_numpy(x)).numpy(),
        np.asarray(jnorm(jnp.asarray(x))).transpose(0, 3, 1, 2),
        atol=1e-6, rtol=1e-6)

    want = jax_evaluate.make_eval_fn(jax_cnn.CNN_MNIST(), jnorm)(
        fp, *map(jnp.asarray, jax_evaluate.pad_eval_set(x, y, 32)))
    model = registry.get_model("fmnist", shape)
    got = evaluate.make_eval_fn(model, norm)(
        carrier.params_from_flax(fp, "cpu"),
        *map(torch.from_numpy, evaluate.pad_eval_set(x, y, 32)))
    # loss: f32 in another summation order, 1e-5; accuracy and per-class
    # accuracy are counts over the same argmaxes: 1e-6
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
    np.testing.assert_allclose(float(got[1]), float(want[1]), atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-6)
    assert 0.0 < float(got[1]) < 1.0
