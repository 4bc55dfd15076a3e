"""The compute dtype (`--dtype bf16`, models/layers.py) against the JAX
package's Flax modules at `dtype=bfloat16`.

The same numpy inputs and the same carried f32 params go through CNN_MNIST
on [8, 28, 28, 1] and ResNet-9 on [4, 32, 32, 3] (seed 0): JAX at bf16 and
at f32 under a plain `jax.jit`, the port at bf16. Held, each in relative
L2 against JAX's bf16 result, against JAX's own bf16-to-f32 gap on the
same inputs:

- CNN_MNIST end to end: the logits and one step's grads (softmax
  cross-entropy on the f32 logits) within half the gap;
- ResNet-9 block by block: each of the six blocks fed JAX's own bf16
  input, its output, its input's grad and its leaves' grads (one vjp with
  a fixed random cotangent) within half the block's gap;
- ResNet-9 end to end: logits and grads within 1.5 times the gap. Two
  bf16 implementations that round at the same points still differ in
  where a product's accumulation order flips a rounding; through eight
  convolutions those one-ulp flips cascade until the two differ about as
  much as bf16 and f32 do (0.93 of the gap on these logits, 0.66 on the
  grads, with every block at under a tenth of its gap). The block-wise
  check is what holds the rounding points.

JAX's bf16 programs are compiled with `xla_allow_excess_precision` off.
By default the CPU compiler drops some of the roundings the Flax modules
ask for (it normalizes a convolution's unrounded f32 output while taking
GroupNorm's statistics from the rounded one), and then every ResNet-9
block differs from the modules' bf16 semantics by about its whole gap.
With the flag off the program rounds where the modules' dtypes say, as
the TPU's native bf16 ops do.

Then a bf16 round of the port keeps f32 params, grads and updates, as JAX
tests/test_models.py:53 holds for its models.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from torch.func import functional_call, vjp

from defending_against_backdoors_with_robust_learning_rate_tpu.models import (
    resnet as jax_resnet)
from defending_against_backdoors_with_robust_learning_rate_tpu.models.cnn import (
    CNN_MNIST as JaxCNN)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data.registry import (
    get_federated_data)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    common, rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    carrier, registry, resnet)

STRICT = {"xla_allow_excess_precision": False}
# JAX's ResNet9 blocks: (module, width, pool; None for a Residual)
JAX_BLOCKS = {"ConvGN_0": (jax_resnet.ConvGN, 64, False),
              "ConvGN_1": (jax_resnet.ConvGN, 128, True),
              "Residual_0": (jax_resnet.Residual, 128, None),
              "ConvGN_2": (jax_resnet.ConvGN, 256, True),
              "ConvGN_3": (jax_resnet.ConvGN, 512, True),
              "Residual_1": (jax_resnet.Residual, 512, None)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _leaves(tree):
    return np.concatenate([np.asarray(v, np.float32).ravel()
                           for v in jax.tree_util.tree_leaves(tree)])


def _nchw(a):
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2)


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT)(*args)


def _end_to_end(data, arch, jax_cls, shape):
    """(port vs JAX bf16, JAX bf16 vs f32) for the logits and the grads."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    y = rng.integers(0, 10, size=shape[0])
    params = jax.tree_util.tree_map(np.asarray, jax_cls().init(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"])

    def jax_step(dtype):
        def loss_fn(p):
            logits = jax_cls(dtype=dtype).apply({"params": p}, x)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean(), logits
        (_, logits), grads = _jit(jax.value_and_grad(loss_fn, has_aux=True),
                                  params)
        return np.asarray(logits), _leaves(carrier.params_from_flax(
            jax.tree_util.tree_map(np.asarray, grads), "cpu"))
    j16, j32 = jax_step(jnp.bfloat16), jax_step(jnp.float32)

    model = registry.get_model(data, shape[1:], arch=arch, dtype="bf16")
    p = {k: v.requires_grad_(True) for k, v in
         carrier.params_from_flax(params, "cpu").items()}
    logits = functional_call(model, p, (_nchw(x),))
    assert logits.dtype == torch.float32
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
    grads = torch.autograd.grad(loss, list(p.values()))
    assert all(g.dtype == torch.float32 for g in grads)
    got = (logits.detach().numpy(),
           _leaves({k: g.numpy() for k, g in zip(p, grads, strict=True)}))
    return ([_rel(a, b) for a, b in zip(got, j16, strict=True)],
            [_rel(a, b) for a, b in zip(j16, j32, strict=True)], params, x)


def _resnet_blocks(params, x):
    """Each block on JAX's bf16 input: [(port vs JAX bf16, JAX's gap)] for
    the output, the input's grad and the leaves' grads."""
    model = registry.get_model("cifar10", x.shape[1:], arch="resnet9",
                               dtype="bf16")
    tparams = carrier.params_from_flax(params, "cpu")
    _, state = _jit(lambda p, x: jax_resnet.ResNet9(
        dtype=jnp.bfloat16).apply({"params": p}, x,
                                  capture_intermediates=True,
                                  mutable=["intermediates"]), params, x)
    inter = state["intermediates"]
    h = jnp.asarray(x).astype(jnp.bfloat16)
    out = []
    for i, name in enumerate(resnet.BLOCKS):
        cls, width, pool = JAX_BLOCKS[name]
        kw = {} if pool is None else {"pool": pool}
        g = np.random.default_rng(i + 1).normal(
            size=inter[name]["__call__"][0].shape).astype(np.float32)

        def jax_block(dtype):
            def fn(p, h):
                return cls(width, dtype=dtype, **kw).apply(
                    {"params": p}, h).astype(jnp.float32)

            def with_vjp(p, h):
                o, pull = jax.vjp(fn, p, h)
                return (o, *pull(jnp.asarray(g)))
            o, gp, gh = _jit(with_vjp, params[name], h.astype(dtype))
            return np.asarray(o), _leaves(gp), np.asarray(gh, np.float32)
        j16, j32 = jax_block(jnp.bfloat16), jax_block(jnp.float32)

        block = getattr(model, name)
        names = [n for n, _ in block.named_parameters()]
        spec = resnet.BlockSpec(torch.bfloat16, block.stages(),
                                isinstance(block, resnet.Residual))
        o, pull = vjp(lambda h, *ls: spec(h, *ls).to(torch.float32),
                      _nchw(h.astype(jnp.float32)).to(torch.bfloat16),
                      *[tparams[f"{name}.{n}"] for n in names])
        gh, *gp = pull(_nchw(g))
        full = {k: torch.zeros_like(v) for k, v in tparams.items()}
        full.update({f"{name}.{n}": t for n, t in zip(names, gp,
                                                      strict=True)})
        got = (o.detach().permute(0, 2, 3, 1).numpy(),
               _leaves(carrier.flax_from_params(full)[name]),
               gh.to(torch.float32).permute(0, 2, 3, 1).numpy())
        out.append((name, [(_rel(a, b), _rel(b, c)) for a, b, c in
                           zip(got, j16, j32, strict=True)]))
        h = inter[name]["__call__"][0]
    return out


def test_bf16_matches_flax_within_half_its_gap():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        got, gap, _, _ = _end_to_end("fmnist", "cnn", JaxCNN, (8, 28, 28, 1))
        # the yardstick is not vacuous: bf16 moves both by over 1e-3
        assert min(gap) > 1e-3, gap
        for what, g, j in zip(("logits", "grads"), got, gap, strict=True):
            assert g <= 0.5 * j, ("CNN_MNIST", what, g, j)

        got, gap, params, x = _end_to_end("cifar10", "resnet9",
                                          jax_resnet.ResNet9, (4, 32, 32, 3))
        assert min(gap) > 1e-3, gap
        for what, g, j in zip(("logits", "grads"), got, gap, strict=True):
            assert g <= 1.5 * j, ("ResNet-9", what, g, j)
        for name, pairs in _resnet_blocks(params, x):
            for what, (g, j) in zip(("output", "leaf grads", "input grad"),
                                    pairs, strict=True):
                assert j > 1e-3, (name, what, j)
                assert g <= 0.5 * j, (name, what, g, j)
    finally:
        torch.set_num_threads(old)


def test_bf16_round_keeps_f32_params(tmp_path):
    """One FMNIST-shaped round of the port at --dtype bf16 on the CPU: the
    params stay f32 leaf for leaf, the round moves them, and every value
    is finite."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cfg = Config(data="synthetic", num_agents=4, bs=16, local_ep=1,
                     synth_train_size=128, synth_val_size=32,
                     num_corrupt=1, poison_frac=1.0, robustLR_threshold=2,
                     dtype="bf16", data_dir=str(tmp_path / "nodata"),
                     log_dir=str(tmp_path / "logs"), device="cpu")
        fed = get_federated_data(cfg)
        model = registry.get_model(cfg.data, cfg.image_shape, arch="cnn",
                                   dtype=cfg.dtype)
        assert model.compute_dtype == torch.bfloat16
        params = registry.init_params(model, 0, "cpu")
        norm = common.make_normalizer(fed.mean, fed.std, "cpu")
        round_fn = rounds.make_round_fn(
            cfg, model, norm, torch.from_numpy(fed.train.images),
            torch.from_numpy(fed.train.labels).long(), fed.train.sizes)
        new, info = round_fn(params, rounds.RoundRNG(0, "cpu"))
    finally:
        torch.set_num_threads(old)
    assert list(new) == list(params)
    moved = 0.0
    for k, v in new.items():
        assert v.dtype == torch.float32 == params[k].dtype, k
        assert bool(torch.isfinite(v).all()), k
        moved = max(moved, float((v - params[k]).abs().max()))
    assert moved > 0
    assert info["train_loss"].dtype == torch.float32
    assert np.isfinite(float(info["train_loss"]))
