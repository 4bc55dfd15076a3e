"""ResNet-9's blockwise rematerialization (JAX `--remat`, `--remat_policy`).

Counterpart: `nn.remat(ConvGN)` / `nn.remat(Residual)` in the JAX package's
`models/resnet.py:78-86`, with `jax.checkpoint_policies.
save_only_these_names("conv_out")` under the `conv` policy. Each block is
one `torch.autograd.Function`:

- `block`: forward saves the block's input and leaves only; backward
  recomputes the whole block through `torch.func.vjp` and pulls the grad
  through it;
- `conv`: forward also saves each stage's convolution output (JAX's
  `checkpoint_name(x, "conv_out")`); backward recomputes only each
  stage's tail (GroupNorm, relu, pool) from the saved output, and takes
  the convolutions' grads from their saved inputs with the one
  `convolution_backward` call autograd makes, so no convolution runs
  forward twice.

`torch.utils.checkpoint` does not run inside the batched trainer's
`torch.func.vmap(grad_and_value(...))` (fl/client.py): its non-reentrant
form needs saved-tensor hooks, which torch.func refuses, and its
reentrant form has no `setup_context`. A Function with `setup_context` and
`generate_vmap_rule = True` runs there and inside the round's captured
CUDA graph. Both policies compute the ops of the plain forward and
backward, so the grads equal the un-rematerialized ones bit for bit
(tests/test_torch_remat.py; on the card under cuDNN deterministic,
chip_smoke.py phase precision).

A block is its `models/resnet.BlockSpec` (a callable of the block's input
and leaves, with `conv`, `conv_backward` and `tail` for its stages); the
spec rides the Function as a non-tensor argument.
"""

from __future__ import annotations

import torch
from torch.func import vjp


class _SaveInputs(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(spec, x, *leaves):
        return spec(x, *leaves)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.spec = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, grad):
        spec, (x, *leaves) = ctx.spec, ctx.saved_tensors
        if ctx.needs_input_grad[1]:
            _, pull = vjp(spec, x, *leaves)
            return (None, *pull(grad))
        _, pull = vjp(lambda *ls: spec(x, *ls), *leaves)
        return (None, None, *pull(grad))


class _SaveConvs(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(spec, x, *leaves):
        h, convs = x, []
        for i in range(len(spec.stages)):
            w, s, b = leaves[3 * i:3 * i + 3]
            c = spec.conv(h, w)
            convs.append(c)
            h = spec.tail(i, c, s, b)
        return (x + h if spec.residual else h, *convs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.spec = inputs[0]
        ctx.n_leaves = len(inputs) - 2
        ctx.mark_non_differentiable(*output[1:])
        ctx.save_for_backward(*inputs[1:], *output[1:])

    @staticmethod
    def backward(ctx, grad, *_conv_grads):
        spec, saved = ctx.spec, ctx.saved_tensors
        x, leaves = saved[0], saved[1:1 + ctx.n_leaves]
        convs = saved[1 + ctx.n_leaves:]
        # recompute each stage's input from the saved convolution outputs
        ins, pulls = [x], []
        for i, c in enumerate(convs):
            s, b = leaves[3 * i + 1:3 * i + 3]
            h, pull = vjp(lambda c, s, b, i=i: spec.tail(i, c, s, b), c, s, b)
            ins.append(h)
            pulls.append(pull)
        grads = [None] * len(leaves)
        g = grad
        for i in reversed(range(len(convs))):
            gc, grads[3 * i + 1], grads[3 * i + 2] = pulls[i](g)
            need_input = i > 0 or ctx.needs_input_grad[1]
            g, grads[3 * i] = spec.conv_backward(gc, ins[i], leaves[3 * i],
                                                 need_input)
        gx = None
        if ctx.needs_input_grad[1]:
            gx = grad + g if spec.residual else g
        return (None, gx, *grads)


def checkpoint_block(policy: str, spec, x, leaves):
    """The block `spec(x, *leaves)` under remat policy `policy` (`block` or
    `conv`)."""
    if policy == "block":
        return _SaveInputs.apply(spec, x, *leaves)
    return _SaveConvs.apply(spec, x, *leaves)[0]
