"""The port's cifar10 and fedemnist data against the JAX package's: the
on-disk loaders (CIFAR-10's pickle batches, Fed-EMNIST's per-user .pt
files), the synthetic stand-ins, the uneven per-user stacks, the DBA
stamps and the poisoned shards and val set. Same seed, same bytes.

The JAX side is composed from its numpy pieces the way its
get_federated_data composes them (tests/test_torch_data.py does the same
for fmnist; its native pack helper gives identical outputs,
tests/test_native.py). Every file is written under `tmp_path`; data_dir
points at a directory that does not exist for the stand-ins.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import pickle

import numpy as np
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu.attack import (
    patterns as jax_patterns, poison as jax_poison)
from defending_against_backdoors_with_robust_learning_rate_tpu.config import (
    Config as JaxConfig)
from defending_against_backdoors_with_robust_learning_rate_tpu.data import (
    arrays as jax_arrays, partition as jax_partition, registry as jax_registry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.attack import (
    patterns)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data import (
    arrays, registry)


def _equal(a, b, what):
    assert a.dtype == b.dtype, what
    np.testing.assert_array_equal(a, b, err_msg=what)   # byte-equal


def _write_cifar10(base, rng):
    base.mkdir(parents=True)
    for name, n in [(f"data_batch_{i}", 6) for i in range(1, 6)] + [
            ("test_batch", 5)]:
        d = {b"data": rng.integers(0, 256, size=(n, 3072), dtype=np.uint8),
             b"labels": [int(v) for v in rng.integers(0, 10, size=n)]}
        with open(base / name, "wb") as f:
            pickle.dump(d, f)


def _write_fedemnist(base, rng):
    """The val set and three users' train sets in the payload forms the
    loader reads: a dict of tensors (NCHW), a pair of numpy arrays ([N, H,
    W]) and a pair of tensors (NHWC)."""
    users = base / "user_trainsets"
    users.mkdir(parents=True)

    def images(n):
        return rng.normal(size=(n, 28, 28)).astype(np.float32)

    def labels(n):
        return rng.integers(0, 10, size=n)
    torch.save({"pixels": torch.from_numpy(images(7))[:, None],
                "label": torch.from_numpy(labels(7))},
               base / "fed_emnist_all_valset.pt")
    torch.save({"pixels": torch.from_numpy(images(5))[:, None],
                "label": torch.from_numpy(labels(5))},
               users / "user_0_trainset.pt")
    torch.save((images(3), labels(3)), users / "user_1_trainset.pt")
    torch.save((torch.from_numpy(images(9))[..., None],
                torch.from_numpy(labels(9))), users / "user_2_trainset.pt")


def test_loaders_and_stamps_bit_equal(tmp_path):
    rng = np.random.default_rng(5)
    _write_cifar10(tmp_path / "cifar-10-batches-py", rng)
    _write_fedemnist(tmp_path / "Fed_EMNIST", rng)

    want = jax_registry._load_cifar10(str(tmp_path))
    got = registry._load_cifar10(str(tmp_path))
    for w, g, n in zip(want, got, (30, 5), strict=True):
        assert g.images.shape == (n, 32, 32, 3)
        _equal(g.images, w.images, "cifar10 images")
        _equal(g.labels, w.labels, "cifar10 labels")

    (w_shards, w_val) = jax_registry._load_fedemnist(str(tmp_path))
    (g_shards, g_val) = registry._load_fedemnist(str(tmp_path))
    assert len(g_shards) == len(w_shards) == 3
    _equal(g_val.images, w_val.images, "fedemnist val images")
    _equal(g_val.labels, w_val.labels, "fedemnist val labels")
    for u, (w, g) in enumerate(zip(w_shards, g_shards, strict=True)):
        assert g[0].shape[1:] == (28, 28, 1)
        _equal(g[0], w[0], f"user {u} images")
        _equal(g[1], w[1], f"user {u} labels")
    for pad in (1, 4):
        ws = jax_arrays.stack_uneven_shards([s[0] for s in w_shards],
                                            [s[1] for s in w_shards], pad)
        gs = arrays.stack_uneven_shards([s[0] for s in g_shards],
                                        [s[1] for s in g_shards], pad)
        for name in ("images", "labels", "sizes"):
            _equal(getattr(gs, name), getattr(ws, name), f"stack {name}")

    # the port's get_datasets reads the same files
    cfg = Config(data="fedemnist", num_agents=2, data_dir=str(tmp_path))
    shards, val, synthetic = registry.get_datasets(cfg)
    assert not synthetic and len(shards) == 2
    _equal(val.images, w_val.images, "get_datasets val")

    # every stamp, the DBA slices of agents 0-7 and the full pattern
    for data, ptypes in (("cifar10", ("plus", "square")),
                         ("fedemnist", ("plus", "square")),
                         ("fmnist", ("plus", "square"))):
        for ptype in ptypes:
            for agent in range(-1, 8):
                w = jax_patterns.build_stamp(data, ptype, agent_idx=agent)
                g = patterns.build_stamp(data, ptype, agent_idx=agent)
                what = f"{data}/{ptype}/agent {agent}"
                assert w.mode == jax_patterns.SET, what
                _equal(g.mask, w.mask, what + " mask")
                _equal(g.value, w.value, what + " value")
                shape = w.mask.shape + ((3,) if data == "cifar10" else (1,))
                x = (rng.integers(0, 256, size=(4,) + shape, dtype=np.uint8)
                     if data != "fedemnist" else
                     rng.normal(size=(4,) + shape).astype(np.float32))
                _equal(patterns.apply_stamp(x, g),
                       np.asarray(jax_patterns.apply_stamp(x, w)),
                       what + " stamped")
    # the DBA slices partition the full cifar10 plus
    full = patterns.build_stamp("cifar10", "plus").mask
    parts = [patterns.build_stamp("cifar10", "plus", a).mask
             for a in range(4)]
    assert sum(p.sum() for p in parts) >= full.sum() > 0
    np.testing.assert_array_equal(np.logical_or.reduce(parts), full)


def _jax_federated(jcfg):
    """JAX's get_federated_data through its numpy pieces."""
    tr, va, synthetic = jax_registry.get_datasets(jcfg)
    if isinstance(tr, list):
        shards = jax_arrays.stack_uneven_shards([s[0] for s in tr],
                                                [s[1] for s in tr], jcfg.bs)
    else:
        groups = jax_partition.distribute_data(tr.labels, jcfg.num_agents)
        shards = jax_arrays.stack_agent_shards(tr.images, tr.labels, groups,
                                               jcfg.num_agents, jcfg.bs)
    imgs, lbls, pmask = jax_poison.poison_agent_shards(
        shards.images, shards.labels, shards.sizes, jcfg)
    pv_imgs, pv_lbls = jax_poison.build_poisoned_val(va.images, va.labels,
                                                     jcfg)
    return dict(images=imgs, labels=lbls, sizes=shards.sizes,
                poison_mask=pmask, val_images=va.images,
                val_labels=va.labels, pval_images=pv_imgs,
                pval_labels=pv_lbls, synthetic=synthetic)


def test_federated_data_byte_equal():
    cases = (
        # the CIFAR-10 DBA run's poisoning at a small size
        dict(data="cifar10", num_agents=8, bs=32, synth_train_size=960,
             synth_val_size=200, num_corrupt=4, poison_frac=0.5, seed=2),
        # Fed-EMNIST's synthetic per-user shards at a small K
        dict(data="fedemnist", num_agents=30, bs=16, synth_train_size=500,
             synth_val_size=100, num_corrupt=3, poison_frac=0.5, seed=4))
    for kw in cases:
        kw["data_dir"] = "/nonexistent-data-dir"
        data = kw["data"]
        fed = registry.get_federated_data(Config(**kw))
        jcfg = JaxConfig(**kw)
        want = _jax_federated(jcfg)
        assert fed.synthetic and want["synthetic"]
        assert fed.train.poison_mask.sum() > 0 and len(fed.pval_labels) > 0
        for name in ("images", "labels", "sizes", "poison_mask"):
            _equal(getattr(fed.train, name), want[name], f"{data} {name}")
        for name in ("val_images", "val_labels", "pval_images",
                     "pval_labels"):
            _equal(getattr(fed, name), want[name], f"{data} {name}")
        mean, std = jax_registry.NORM_STATS[data]
        _equal(fed.mean, np.asarray(mean, np.float32), f"{data} mean")
        _equal(fed.std, np.asarray(std, np.float32), f"{data} std")
        assert fed.raw_is_normalized == (data == "fedemnist")
        assert fed.train.images.dtype == (np.float32 if data == "fedemnist"
                                          else np.uint8)
        assert fed.train.images.shape[2:] == jcfg.image_shape
        assert fed.train.max_n % kw["bs"] == 0

        # each corrupt agent's poisoned rows carry its own stamp (its DBA
        # slice on cifar10) and the target label, and only those rows moved
        clean = registry.get_federated_data(Config(**{**kw,
                                                      "num_corrupt": 0}))
        for a in range(kw["num_corrupt"]):
            rows = fed.train.poison_mask[a]
            if not rows.any():
                # a user with fewer than 2 base-class samples poisons none
                assert data == "fedemnist", a
                continue
            stamp = jax_patterns.build_stamp(data, "plus", agent_idx=a)
            got = fed.train.images[a][rows]
            assert (got[:, stamp.mask] == stamp.value[stamp.mask][:, None]
                    ).all(), a
            assert (fed.train.labels[a][rows] == jcfg.target_class).all()
            assert (clean.train.labels[a][rows] == jcfg.base_class).all()
            _equal(fed.train.images[a][~rows], clean.train.images[a][~rows],
                   f"{data} agent {a} unpoisoned rows")
        _equal(fed.train.images[kw["num_corrupt"]:],
               clean.train.images[kw["num_corrupt"]:], f"{data} honest")
