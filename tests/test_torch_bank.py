"""The port's client bank (data/bank.py) and cohort gather
(data/registry.CohortData) against the JAX package's, byte for byte.

Both packages build into directories under tmp_path from the same labels:
label_shards at K = 10, dirichlet and pathological at 20,000 clients in
two shard files each. Their bank keys, `content_sha`, offsets, index
files and sidecars, and both gathers (streamed and memmapped) must be
equal; label_shards rows must also equal the dense stacked rows. Then
`get_or_build`'s reuse, a digest mismatch raising `BankCorrupted` in
both, and the cohort gather with its corrupt members poisoned, through
each package's `get_cohort_data` on the synthetic FMNIST stand-in.
Serial builds only: the parallel build spawns processes and is checked on
the card (chip_smoke.py phase population). Numpy only on both sides, so
the tolerance is zero.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import os
import shutil

import numpy as np
import pytest

from defending_against_backdoors_with_robust_learning_rate_tpu.config import (
    Config as JaxConfig)
from defending_against_backdoors_with_robust_learning_rate_tpu.data import (
    bank as jax_bank)
from defending_against_backdoors_with_robust_learning_rate_tpu.data.registry import (
    get_cohort_data as jax_get_cohort_data)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data import (
    bank)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data.arrays import (
    stack_agent_shards)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data.partition import (
    distribute_data)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data.registry import (
    get_cohort_data)

N = 3000                       # base samples
SHAPE = (6, 6, 1)


def _files(d):
    """{name: bytes} of a bank directory (meta.json aside: its `n_shards`
    and every field are compared as parsed JSON)."""
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n != bank.META_NAME}


def _log(lines):
    return lines.append


def test_bank_builds_equal_jax(tmp_path):
    rng = np.random.default_rng(7)
    labels = rng.integers(0, 10, size=N).astype(np.int32)
    labels[labels == 3] = 4                      # one empty class
    images = rng.integers(0, 256, size=(N,) + SHAPE).astype(np.uint8)
    cases = [("label_shards", 10, 65536),
             ("dirichlet", 20000, 10000),
             ("pathological", 20000, 10000)]
    for partitioner, population, shard_clients in cases:
        kw = dict(population=population, partitioner=partitioner,
                  samples_per_client=0, dirichlet_alpha=0.3,
                  classes_per_client=3, seed=5, n_classes=10,
                  shard_clients=shard_clients)
        spc = bank.resolve_samples_per_client(0, N, population)
        assert spc == jax_bank.resolve_samples_per_client(0, N, population)
        key_kw = {k: v for k, v in kw.items() if k != "shard_clients"}
        key_kw["samples_per_client"] = spc
        key = bank.bank_key(labels, **key_kw)
        assert key == jax_bank.bank_key(labels, **key_kw), partitioner
        ours_dir = str(tmp_path / f"port-{partitioner}")
        jax_dir = str(tmp_path / f"jax-{partitioner}")
        lines, jax_lines = [], []
        ours = bank.build_bank(ours_dir, labels, key=key, log=_log(lines),
                               **kw)
        ref = jax_bank.build_bank(jax_dir, labels, key=key,
                                  log=_log(jax_lines), **kw)
        assert ours.meta == ref.meta, partitioner
        assert ours.meta["n_shards"] == (1 if population == 10 else 2)
        assert _files(ours_dir) == _files(jax_dir), partitioner
        assert [ln.replace(ours_dir, "D") for ln in lines] == [
            ln.replace(jax_dir, "D") for ln in jax_lines]
        assert ours.padded_max_n(32) == ref.padded_max_n(32)
        # both gathers, over both shard files, a repeated id included
        ids = np.array([population - 1, 0, 7, population // 2 + 3, 7])
        max_n = ours.padded_max_n(8)
        for streamed in (True, False):
            got = ours.gather(ids, images, labels, max_n, streamed=streamed)
            want = ref.gather(ids, images, labels, max_n, streamed=streamed)
            for g, w in zip(got, want, strict=True):
                assert g.dtype == w.dtype and np.array_equal(g, w)
        np.testing.assert_array_equal(ours.sizes_of(ids), ref.sizes_of(ids))
        for cid in (0, population - 1):
            np.testing.assert_array_equal(ours.client_indices(cid),
                                          ours.read_client_indices(cid))
        if partitioner == "label_shards":
            # bank rows == the dense stacked rows, padded to bs alike
            dense = stack_agent_shards(
                images, labels, distribute_data(labels, population),
                population, pad_multiple=8)
            got = ours.gather(np.arange(population), images, labels,
                              dense.max_n)
            for g, w in zip(got, (dense.images, dense.labels, dense.sizes),
                            strict=True):
                np.testing.assert_array_equal(g, w)
        else:
            assert ours.meta["samples_per_client"] == 16
        ours.close()
        ref.close()


def test_bank_reuse_digests_and_cohort_gather(tmp_path):
    labels = np.random.default_rng(1).integers(0, 10, size=N).astype(
        np.int32)
    kw = dict(population=20000, partitioner="dirichlet",
              samples_per_client=0, dirichlet_alpha=0.5,
              classes_per_client=2, seed=0, n_classes=10,
              shard_clients=10000)
    for mod, name in ((bank, "port"), (jax_bank, "jax")):
        d = str(tmp_path / f"reuse-{name}")
        lines = []
        first, built = mod.get_or_build(d, labels, log=_log(lines), **kw)
        assert built
        again, built = mod.get_or_build(d, labels, verify=True,
                                        log=_log(lines), **kw)
        assert not built and again.meta == first.meta
        assert lines[-1] == f"[bank] {d}: 2 shard digest(s) verified " \
                            f"(--bank_verify)"
        # a key mismatch rebuilds; a damaged shard raises, naming it
        other, built = mod.get_or_build(d, labels, log=_log(lines),
                                        **{**kw, "seed": 1})
        assert built and other.meta["key"] != first.meta["key"]
        shard = os.path.join(d, "indices-00001.bin")
        raw = bytearray(open(shard, "rb").read())
        raw[100] ^= 0xFF
        open(shard, "wb").write(bytes(raw))
        with pytest.raises(mod.BankCorrupted) as e:
            mod.get_or_build(d, labels, verify=True, log=_log(lines),
                             **{**kw, "seed": 1})
        assert shard in str(e.value) and "CORRUPTED" in str(e.value)
        shutil.rmtree(d)

    # the cohort gather through each package's get_cohort_data: the bank
    # under each one's log_dir, corrupt members (ids < 40) poisoned by the
    # per-client routine, rows equal byte for byte
    common = dict(data="fmnist", num_agents=5000, cohort_size=16,
                  partitioner="pathological", num_corrupt=40,
                  poison_frac=0.5, synth_train_size=4000,
                  synth_val_size=200, bs=32,
                  data_dir=str(tmp_path / "nodata"))
    ours = get_cohort_data(Config(log_dir=str(tmp_path / "pl"), **common))
    ref = jax_get_cohort_data(JaxConfig(log_dir=str(tmp_path / "jl"),
                                        **common))
    assert ours.bank.meta == ref.bank.meta
    assert ours.max_n == ref.max_n == 32
    assert ours.train.images.shape == ref.train.images.shape
    for a, b in ((ours.pval_images, ref.pval_images),
                 (ours.val_labels, ref.val_labels)):
        np.testing.assert_array_equal(a, b)
    ids = np.array([3, 4999, 17, 39, 40, 1200, 0])
    got, want = ours.gather_cohort(ids), ref.gather_cohort(ids)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # the corrupt members' rows carry the target label where stamped
    assert (got[1][:4] == 7).any()
    with pytest.raises(ValueError) as e:
        get_cohort_data(Config(**{**common, "data": "fedemnist",
                                  "log_dir": str(tmp_path / "pl")}))
    with pytest.raises(ValueError) as j:
        jax_get_cohort_data(JaxConfig(**{**common, "data": "fedemnist",
                                         "log_dir": str(tmp_path / "jl")}))
    assert str(e.value) == str(j.value)
