"""The port's ResNet-9 (models/resnet.py) against the JAX package's Flax
ResNet9 on weights carried across (models/carrier.py): logits, loss and
every leaf's gradient; the carrier's round trip; and `flops_per_example`
against JAX's.

A batch of 2 images at 8x8x3 runs every layer at full width (the global
max pool makes the spatial size free): 6,573,130 parameters, 26 leaves.
The JAX side runs under a plain `jax.jit`.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from torch.func import functional_call

from defending_against_backdoors_with_robust_learning_rate_tpu.config import (
    Config as JaxConfig)
from defending_against_backdoors_with_robust_learning_rate_tpu.models import (
    registry as jax_registry)
from defending_against_backdoors_with_robust_learning_rate_tpu.models.resnet import (
    ResNet9 as JaxResNet9)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    carrier, registry)

SHAPE = (8, 8, 3)
LABELS = np.array([3, 7])
# f32 on both sides, other convolution and GroupNorm summation orders
# (Flax takes the variance as E[x^2] - E[x]^2): 1e-5 relative
RTOL = 1e-5


def _flax_params(rng):
    """Random Flax-layout ResNet9 weights: fan-in scaled kernels, GroupNorm
    scales near 1, small biases (an abstract init gives the shapes)."""
    shapes = jax.eval_shape(JaxResNet9().init, jax.random.PRNGKey(0),
                            jnp.zeros((1,) + SHAPE))["params"]

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.normal(size=s.shape)
                    / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        return (0.1 * rng.normal(size=s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_resnet9_matches_flax():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        rng = np.random.default_rng(0)
        flax_params = _flax_params(rng)
        x = rng.normal(size=(2,) + SHAPE).astype(np.float32)

        def loss_fn(p):
            logits = JaxResNet9().apply({"params": p}, x)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, LABELS).mean(), logits
        (j_loss, j_logits), j_grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(flax_params)

        model = registry.get_model("cifar10", SHAPE, arch="resnet9")
        params = {k: v.requires_grad_(True) for k, v in
                  carrier.params_from_flax(flax_params, "cpu").items()}
        assert list(params) == [n for n, _ in model.named_parameters()]
        assert registry.param_count(params) == 6_573_130
        logits = functional_call(
            model, params, (torch.from_numpy(x).permute(0, 3, 1, 2),))
        loss = torch.nn.functional.cross_entropy(logits,
                                                 torch.from_numpy(LABELS))
        grads = torch.autograd.grad(loss, list(params.values()))
    finally:
        torch.set_num_threads(old)

    j_logits = np.asarray(j_logits)
    np.testing.assert_allclose(logits.detach().numpy(), j_logits, rtol=0,
                               atol=RTOL * np.abs(j_logits).max())
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=RTOL)
    want = carrier.params_from_flax(j_grads, "cpu")
    assert len(want) == len(grads) == 26
    for (name, ref), got in zip(want.items(), grads, strict=True):
        ref, got = ref.numpy(), got.numpy()
        scale = np.abs(ref).max()
        assert scale > 0, name
        # every coordinate within 1e-5 of the leaf's largest gradient, and
        # 1e-5 relative L2
        np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * scale,
                                   err_msg=name)
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < RTOL, name


def test_resnet9_carrier_round_trip_and_flops():
    """Flax -> torch -> Flax is exact, leaves in the torch module's order;
    torch -> Flax -> torch too. flops_per_example equals JAX's for every
    dataset and arch (None for resnet9, as JAX)."""
    flax_params = jax.tree_util.tree_map(
        np.asarray, _flax_params(np.random.default_rng(1)))
    params = carrier.params_from_flax(flax_params, "cpu")
    back = carrier.flax_from_params(params)
    flat_in = jax.tree_util.tree_flatten_with_path(flax_params)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_in) == len(flat_back) == 26
    for path, leaf in flat_in:
        got = flat_back[path]
        assert got.dtype == leaf.dtype and got.shape == leaf.shape, path
        np.testing.assert_array_equal(got, leaf, err_msg=str(path))
    again = carrier.params_from_flax(back, "cpu")
    assert list(again) == list(params)
    for k, v in params.items():
        assert torch.equal(again[k], v), k

    for data in ("fmnist", "fedemnist", "cifar10", "synthetic"):
        shape = JaxConfig(data=data).image_shape
        for arch in ("cnn", "resnet9"):
            want = jax_registry.flops_per_example(data, arch, shape)
            got = registry.flops_per_example(data, arch, shape)
            assert got == want, (data, arch)
            assert (got is None) == (arch == "resnet9")
