"""ResNet-9's rematerialization (models/remat.py: `--remat`,
`--remat_policy block|conv`) against the model without it.

JAX's counterparts are `tests/test_models.py:90` and `:118` (marked slow
there); these run at batch 2 on 8x8x3 images, where the global max pool
keeps every layer at full width. Held bit for bit on the CPU, under
`torch.func.vmap(grad_and_value(...))` as the batched trainer runs it
(fl/client.py): each agent's loss and every leaf's grad with `block` and
with `conv` remat equal those without remat, at f32 and at bf16; and one
batched-trainer round's updates and losses (two agents, two steps, the
SGD tail included) equal too. The module tree does not change with remat:
the state dict's keys, the parameters' order and the carrier's Flax names
are the same, and the CNNs ignore the flag, as JAX's registry does.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import numpy as np
import torch
from torch.func import functional_call, grad_and_value, vmap

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    client, common)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    carrier, registry)

SHAPE = (8, 8, 3)
M = 3


def _model(**kw):
    return registry.get_model("cifar10", SHAPE, arch="resnet9", **kw)


def _grads(model, params, x, y):
    def loss(p, x, y):
        return torch.nn.functional.cross_entropy(
            functional_call(model, p, (x,)), y)
    stacked = {k: v.expand((M,) + v.shape).clone() for k, v in params.items()}
    return vmap(grad_and_value(loss))(stacked, x, y)


def _round(model, params, images, labels):
    cfg = Config(data="cifar10", bs=2, local_ep=1, client_lr=0.1,
                 client_moment=0.9, device="cpu")
    norm = common.make_normalizer((0.5, 0.5, 0.5), (0.25, 0.25, 0.25), "cpu")
    train = client.make_local_train_batched(model, cfg, norm)
    agents = torch.arange(2)
    sizes = torch.tensor([4, 3])
    perms = torch.stack([torch.stack([torch.tensor([2, 0, 3, 1])]),
                         torch.stack([torch.tensor([1, 2, 0, 3])])])
    return train(params, images, labels, agents, sizes, perms)


def test_remat_grads_equal_bit_for_bit():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        gen = torch.Generator().manual_seed(0)
        x = torch.randn((M, 2, 3) + SHAPE[:2], generator=gen)
        y = torch.randint(0, 10, (M, 2), generator=gen)
        images = torch.randint(0, 256, (2, 4) + SHAPE, generator=gen,
                               dtype=torch.uint8)
        labels = torch.randint(0, 10, (2, 4), generator=gen)
        params = registry.init_params(_model(), 0, "cpu")
        for dtype in ("f32", "bf16"):
            grads, losses = _grads(_model(dtype=dtype), params, x, y)
            upd, ep_loss = _round(_model(dtype=dtype), params, images, labels)
            for policy in ("block", "conv"):
                model = _model(dtype=dtype, remat=True, remat_policy=policy)
                g, lo = _grads(model, params, x, y)
                assert torch.equal(lo, losses), (dtype, policy)
                for k in grads:
                    assert g[k].dtype == torch.float32
                    assert torch.equal(g[k], grads[k]), (dtype, policy, k)
                u, el = _round(model, params, images, labels)
                assert torch.equal(el, ep_loss), (dtype, policy)
                for k in upd:
                    assert torch.equal(u[k], upd[k]), (dtype, policy, k)
                # the comparison is not vacuous: every leaf moved
                assert all(bool(upd[k].abs().max() > 0) for k in upd)
    finally:
        torch.set_num_threads(old)


def test_remat_keeps_the_module_tree():
    plain = _model()
    keys = list(plain.state_dict())
    assert len(keys) == 26
    params = registry.init_params(plain, 0, "cpu")
    flax_names = sorted(
        "/".join(path) for path in _paths(carrier.flax_from_params(params)))
    for dtype in ("f32", "bf16"):
        for policy in ("block", "conv"):
            model = _model(dtype=dtype, remat=True, remat_policy=policy)
            assert list(model.state_dict()) == keys
            assert [n for n, _ in model.named_parameters()] == keys
            p = registry.init_params(model, 0, "cpu")
            assert sorted("/".join(path) for path in _paths(
                carrier.flax_from_params(p))) == flax_names
            for k, v in p.items():
                assert torch.equal(v, params[k]), k
    # the CNNs ignore --remat (JAX's registry passes it to ResNet-9 only)
    for data in ("fmnist", "cifar10"):
        shape = (28, 28, 1) if data == "fmnist" else (32, 32, 3)
        a = registry.get_model(data, shape, remat=True, remat_policy="conv")
        b = registry.get_model(data, shape)
        assert type(a) is type(b)
        assert list(a.state_dict()) == list(b.state_dict())
    try:
        _model(remat=True, remat_policy="layer")
    except ValueError as e:
        assert "remat_policy must be one of" in str(e)
    else:
        raise AssertionError("an unknown remat policy was accepted")
    np.testing.assert_equal(len(flax_names), 26)


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,)
