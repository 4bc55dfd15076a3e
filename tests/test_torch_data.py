"""The port's host data pipeline against the JAX package's: synthetic data,
the label-sorted partition, the padded agent stacks, the trojan stamps, the
poisoned shards and the poisoned val set. Same seed, same bytes.

The JAX side is composed from its numpy pieces the way its
get_federated_data composes them (the native partition/pack helper it
prefers gives identical outputs, tests/test_native.py).

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import numpy as np

from defending_against_backdoors_with_robust_learning_rate_tpu.attack import (
    patterns as jax_patterns, poison as jax_poison)
from defending_against_backdoors_with_robust_learning_rate_tpu.config import (
    Config as JaxConfig)
from defending_against_backdoors_with_robust_learning_rate_tpu.data import (
    arrays as jax_arrays, partition as jax_partition, registry as jax_registry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.attack import (
    patterns, poison)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data import (
    arrays, partition, registry)

KW = dict(data="fmnist", num_agents=4, bs=32, synth_train_size=600,
          synth_val_size=120, num_corrupt=2, poison_frac=0.5, seed=3,
          data_dir="/nonexistent-data-dir")


def _equal(a, b, what):
    assert a.dtype == b.dtype, what
    np.testing.assert_array_equal(a, b, err_msg=what)   # byte-equal


def _write_idx(path, arr):
    import gzip
    import struct
    header = struct.pack(">HBB", 0, 0x08, arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    with gzip.open(path, "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


def test_data_arrays_byte_equal(tmp_path):
    # the FMNIST idx parser, on tiny gzipped idx files in torchvision's layout
    raw = tmp_path / "FashionMNIST" / "raw"
    raw.mkdir(parents=True)
    rng = np.random.default_rng(11)
    for split, n in (("train", 40), ("t10k", 12)):
        _write_idx(raw / f"{split}-images-idx3-ubyte.gz",
                   rng.integers(0, 256, size=(n, 28, 28)))
        _write_idx(raw / f"{split}-labels-idx1-ubyte.gz",
                   rng.integers(0, 10, size=(n,)))
    want = jax_registry._load_fmnist(str(tmp_path))
    got = registry._load_fmnist(str(tmp_path))
    for w, g in zip(want, got, strict=True):
        assert g.images.shape[1:] == (28, 28, 1)
        _equal(g.images, w.images, "fmnist idx images")
        _equal(g.labels, w.labels, "fmnist idx labels")

    for hardness in (0.0, 0.5):
        for shape in ((28, 28, 1), (8, 8, 1)):
            want = jax_registry.make_synthetic("fmnist", shape, 300, 50, 7,
                                               hardness=hardness)
            got = registry.make_synthetic("fmnist", shape, 300, 50, 7,
                                          hardness=hardness)
            for w, g, split in zip(want, got, ("train", "val"), strict=True):
                _equal(g.images, w.images, f"{split} images h={hardness}")
                _equal(g.labels, w.labels, f"{split} labels h={hardness}")

    tr, _ = registry.make_synthetic("fmnist", (28, 28, 1), 600, 10, 1)
    for k in (1, 4, 6):
        want = jax_partition.distribute_data(tr.labels, k)
        got = partition.distribute_data(tr.labels, k)
        assert got == want
        ws = jax_arrays.stack_agent_shards(tr.images, tr.labels, want, k, 32)
        gs = arrays.stack_agent_shards(tr.images, tr.labels, got, k, 32)
        for name in ("images", "labels", "sizes"):
            _equal(getattr(gs, name), getattr(ws, name), f"K={k} {name}")
        assert gs.max_n % 32 == 0


def test_poisoning_byte_equal():
    for data, ptype in (("fmnist", "plus"), ("fmnist", "square"),
                        ("synthetic", "plus")):
        want = jax_patterns.build_stamp(data, ptype)
        got = patterns.build_stamp(data, ptype)
        _equal(got.mask, want.mask, f"{data}/{ptype} mask")
        _equal(got.value, want.value, f"{data}/{ptype} value")
        x = np.random.default_rng(0).integers(
            0, 256, size=(5,) + want.mask.shape + (1,), dtype=np.uint8)
        _equal(patterns.apply_stamp(x, got),
               np.asarray(jax_patterns.apply_stamp(x, want)),
               f"{data}/{ptype} stamped")

    cfg, jcfg = Config(**KW), JaxConfig(**KW)
    fed = registry.get_federated_data(cfg)
    tr, va, synthetic = jax_registry.get_datasets(jcfg)
    assert synthetic and fed.synthetic
    groups = jax_partition.distribute_data(tr.labels, jcfg.num_agents)
    shards = jax_arrays.stack_agent_shards(tr.images, tr.labels, groups,
                                           jcfg.num_agents, jcfg.bs)
    imgs, lbls, pmask = jax_poison.poison_agent_shards(
        shards.images, shards.labels, shards.sizes, jcfg)
    pv_imgs, pv_lbls = jax_poison.build_poisoned_val(va.images, va.labels,
                                                     jcfg)
    assert pmask.sum() > 0 and len(pv_lbls) > 0     # the attack is live
    _equal(fed.train.images, imgs, "poisoned train images")
    _equal(fed.train.labels, lbls, "poisoned train labels")
    _equal(fed.train.sizes, shards.sizes, "sizes")
    _equal(fed.train.poison_mask, pmask, "poison mask")
    _equal(fed.val_images, va.images, "val images")
    _equal(fed.val_labels, va.labels, "val labels")
    _equal(fed.pval_images, pv_imgs, "poisoned val images")
    _equal(fed.pval_labels, pv_lbls, "poisoned val labels")
    np.testing.assert_array_equal(
        fed.mean, np.asarray(jax_registry.NORM_STATS["fmnist"][0], np.float32))
    np.testing.assert_array_equal(
        fed.std, np.asarray(jax_registry.NORM_STATS["fmnist"][1], np.float32))
