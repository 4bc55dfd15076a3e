"""The port's native host runtime (data/native.py, a ctypes binding of
native/fl_host.cc built with g++ into tmp_path) against its numpy twins
(data/partition.py, data/arrays.py) and the JAX package's numpy twins, on
the cases of JAX tests/test_native.py: the partitioner on three sizes, one
agent, a missing class, a missing class under a binding quota and agents
dealt only empty chunks; the packs of uint8 and float32 shards and of
uneven per-user shards; an index past the dataset (the numpy twin's
IndexError) and mixed shard dtypes (the numpy twin's cast). All equal
exactly. Then the switch: FL_NATIVE_HOST=0 takes the twins and says so in
`status()`, and a build that fails prints one `[native]` line with its
reason and names the numpy path.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import numpy as np
import pytest

from defending_against_backdoors_with_robust_learning_rate_tpu.data import (
    arrays as jax_arrays, partition as jax_partition)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data import (
    arrays, native, partition)


@pytest.fixture()
def built(tmp_path):
    native.set_build_dir(str(tmp_path / "build"))
    try:
        assert native.available(), native.status()
        assert (tmp_path / "build" / native.LIB_NAME).exists()
        yield native
    finally:
        native.set_build_dir(None)


def _labels(n, n_classes=10, seed=0):
    return np.random.default_rng(seed).integers(0, n_classes, size=n,
                                                dtype=np.int64)


def _same_groups(labels, num_agents, **kw):
    got = native.distribute_data(labels, num_agents, **kw)
    want = partition.distribute_data(labels, num_agents, **kw)
    assert got == want == jax_partition.distribute_data(labels, num_agents,
                                                        **kw)
    return got


def _same_shards(got, *wants):
    for want in wants:
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)
        np.testing.assert_array_equal(got.sizes, want.sizes)
        assert got.images.dtype == want.images.dtype


def test_native_partition_equals_numpy(built):
    for n, k in ((1000, 10), (640, 8), (990, 33)):
        assert len(_same_groups(_labels(n), k)) == k
    assert _same_groups(_labels(64), 1) == {0: list(range(64))}
    absent = np.where(_labels(1000) == 3, 4, _labels(1000))
    _same_groups(absent, 10)
    _same_groups(absent, 10, class_per_agent=5)
    skew = np.concatenate([np.zeros(31, np.int64), np.ones(969, np.int64)])
    _same_groups(skew, 32, class_per_agent=1)


def test_native_packs_equal_numpy_and_the_switch(built, monkeypatch,
                                                 capsys, tmp_path):
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, size=(500, 28, 28, 1), dtype=np.uint8)
    labels = _labels(500)
    groups = partition.distribute_data(labels, 10)
    _same_shards(native.pack_shards(images, labels, groups, 10, 32),
                 arrays.stack_agent_shards(images, labels, groups, 10, 32),
                 jax_arrays.stack_agent_shards(images, labels, groups, 10,
                                               32))
    floats = rng.normal(size=(100, 8, 8, 3)).astype(np.float32)
    lbl = _labels(100)
    groups = partition.distribute_data(lbl, 5)
    _same_shards(native.pack_shards(floats, lbl, groups, 5, 16),
                 arrays.stack_agent_shards(floats, lbl, groups, 5, 16),
                 jax_arrays.stack_agent_shards(floats, lbl, groups, 5, 16))
    shard_imgs = [rng.normal(size=(int(k), 28, 28, 1)).astype(np.float32)
                  for k in rng.integers(5, 40, size=12)]
    shard_lbls = [_labels(len(x), seed=i) for i, x in enumerate(shard_imgs)]
    _same_shards(native.pack_uneven(shard_imgs, shard_lbls, 64),
                 arrays.stack_uneven_shards(shard_imgs, shard_lbls, 64),
                 jax_arrays.stack_uneven_shards(shard_imgs, shard_lbls, 64))
    # the twins' contract on inputs the native path does not take
    with pytest.raises(IndexError):
        native.pack_shards(np.zeros((10, 4, 4, 1), np.uint8),
                           np.zeros(10, np.int64), {0: [0, 99]}, 1)
    mixed = [np.ones((4, 2, 2, 1), np.float32),
             np.full((3, 2, 2, 1), 2.0, np.float64)]
    mixed_lbls = [np.zeros(4, np.int64), np.ones(3, np.int64)]
    _same_shards(native.pack_uneven(mixed, mixed_lbls, 4),
                 arrays.stack_uneven_shards(mixed, mixed_lbls, 4))
    assert native.status().startswith("native (")

    monkeypatch.setenv("FL_NATIVE_HOST", "0")
    assert native.status() == "numpy (FL_NATIVE_HOST=0)"
    assert native.distribute_data(labels, 10) == partition.distribute_data(
        labels, 10)
    monkeypatch.delenv("FL_NATIVE_HOST")

    # a build that cannot run: one line that says why, then the twins
    monkeypatch.setattr(native, "SRC", str(tmp_path / "missing.cc"))
    native.set_build_dir(str(tmp_path / "other"))
    capsys.readouterr()
    assert native.distribute_data(labels, 10) == partition.distribute_data(
        labels, 10)
    native.pack_shards(images, labels, groups, 5)
    out = capsys.readouterr().out.splitlines()
    assert [line for line in out if line.startswith("[native]")] == [
        f"[native] host runtime unavailable (no source at "
        f"{tmp_path / 'missing.cc'}); the numpy partitioner and packers "
        f"run instead"]
    assert native.status().startswith("numpy (native unavailable: no "
                                      "source at")
