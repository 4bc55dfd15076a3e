"""Sharded, memory-mapped client bank: the population store of the
cohort-sampled round.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
data/bank.py`, kept as this package's own copy (the port imports nothing
of the JAX package, and this module is numpy only in both): the same
inputs give the same bank byte for byte (`bank_key`, `content_sha`,
`offsets.npy`, every `indices-*.bin` and its sidecar, both gathers), which
tests/test_torch_bank.py holds.

- The population is partitioned once into per-client index lists over the
  base dataset, written as one flat int64 stream in `indices-<i>.bin`
  files of `shard_clients` clients each, with a memory-mapped
  `offsets.npy` [K+1]: the resident set is O(cohort touched), never
  O(population).
- `dirichlet` and `pathological` draw each client's list as a pure
  function of (seed, client), in fixed BUILD_BLOCK-client blocks keyed by
  the block's global index, so the content never depends on the shard
  layout, on the build order or on the process that built it.
  `label_shards` is the paper's dealing scheme (data/partition.py, the
  numpy copy JAX's tests/test_native.py holds equal to its native one);
  its bank rows are the dense `stack_agent_shards` rows bit for bit.
- `build_bank(..., workers=N)` writes whole shard files in N spawned
  processes and hashes them in shard order: the published bank equals the
  serial build's, so `workers` is not part of the key.
- `ClientBank.gather` gives the cohort's padded [m, max_n, ...] stacks,
  each row's byte range read with one pread (`streamed=False`: through
  the memmap, the same bytes).

Left out: JAX's `obs_events` records of a build (bank/build_start,
bank/shard_done, bank/published) and its Prometheus build-progress
exporter (`install_build_exporter`). They belong to the event ledger and
the exporter of the port's observability plane, which is not ported yet
(ROADMAP queue 1 item 14).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import multiprocessing
import os
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data.arrays import (
    padded_max_n)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data import (
    native)

BANK_VERSION = 1
META_NAME = "meta.json"
OFFSETS_NAME = "offsets.npy"
DIGEST_SUFFIX = ".sha256"

# fixed generation block for the per-client-seeded partitioners: content is
# a function of (seed, block index) with BUILD_BLOCK a named constant, so
# the partition never depends on `shard_clients` (an IO layout knob) or on
# how many clients one build call handles
BUILD_BLOCK = 4096

PARTITIONERS = ("label_shards", "dirichlet", "pathological")

# samples_per_client auto-resolution bounds (resolve_samples_per_client)
MIN_SAMPLES_PER_CLIENT = 16
MAX_SAMPLES_PER_CLIENT = 4096


def resolve_samples_per_client(requested: int, n_samples: int,
                               population: int) -> int:
    """``--samples_per_client 0`` = auto: an even split of the base dataset
    clamped to [16, 4096] — at 1M clients over a 60k-sample dataset every
    client still holds a trainable (16-sample) shard drawn with
    replacement."""
    if requested > 0:
        return requested
    return int(np.clip(n_samples // max(population, 1),
                       MIN_SAMPLES_PER_CLIENT, MAX_SAMPLES_PER_CLIENT))


def bank_key(labels: np.ndarray, *, population: int, partitioner: str,
             samples_per_client: int, dirichlet_alpha: float,
             classes_per_client: int, seed: int, n_classes: int) -> str:
    """Input fingerprint deciding bank reuse: dataset content (labels) +
    every partition-shaping parameter. The shard layout
    (``shard_clients``) and the gather-time padding (``pad_multiple`` —
    applied by ``padded_max_n`` when rows are materialized, never at
    build) are deliberately NOT part of the key: neither can change the
    stored content, so e.g. a batch-size change reuses the bank."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(labels, dtype=np.int64).tobytes())
    h.update(json.dumps({
        "version": BANK_VERSION, "population": population,
        "partitioner": partitioner,
        "samples_per_client": samples_per_client,
        "dirichlet_alpha": dirichlet_alpha,
        "classes_per_client": classes_per_client,
        "seed": seed, "n_classes": n_classes,
    }, sort_keys=True).encode())
    return h.hexdigest()[:20]


def _class_pools(labels: np.ndarray, n_classes: int) -> List[np.ndarray]:
    return [np.nonzero(labels == c)[0].astype(np.int64)
            for c in range(n_classes)]


def _block_rng(seed: int, block: int) -> np.random.Generator:
    # SeedSequence([...]) keys the stream by (constant, seed, block): two
    # builds of the same config produce identical blocks in any order
    return np.random.default_rng([0xBA4C, seed, block])


def _draw_block(rng: np.random.Generator, counts: np.ndarray,
                pools: List[np.ndarray]) -> np.ndarray:
    """[B, spc] sample indices from per-(client, class) `counts` [B, C]
    (rows sum to spc): class-major draws scattered back to clients.

    Within a client the row is ordered class-major then draw-order — a
    deterministic function of the rng stream alone (np.argsort stable)."""
    B = counts.shape[0]
    owners, vals = [], []
    for c, pool in enumerate(pools):
        tot = int(counts[:, c].sum())
        if tot == 0:
            continue
        vals.append(pool[rng.integers(0, len(pool), size=tot)])
        owners.append(np.repeat(np.arange(B), counts[:, c]))
    owner = np.concatenate(owners)
    order = np.argsort(owner, kind="stable")
    return np.concatenate(vals)[order].reshape(B, -1)


def _dirichlet_block(rng: np.random.Generator, block_size: int,
                     pools: List[np.ndarray], spc: int,
                     alpha: float) -> np.ndarray:
    """Per-client Dir(alpha) class mixtures -> multinomial counts -> index
    draws. Classes with empty pools get zero mass (a dataset missing a
    class cannot be sampled from)."""
    C = len(pools)
    nonempty = np.array([len(p) > 0 for p in pools])
    g = rng.standard_gamma(alpha, size=(block_size, C))
    g = np.where(nonempty[None, :], np.maximum(g, 1e-30), 0.0)
    p = g / g.sum(axis=1, keepdims=True)
    counts = rng.multinomial(spc, p)
    return _draw_block(rng, counts, pools)


def _pathological_block(rng: np.random.Generator, block_size: int,
                        pools: List[np.ndarray], spc: int,
                        classes_per_client: int) -> np.ndarray:
    """The classic pathological non-IID split: each client sees only
    `classes_per_client` distinct (nonempty) classes, samples split evenly
    (remainder to the client's first picks)."""
    C = len(pools)
    nonempty = np.nonzero([len(p) > 0 for p in pools])[0]
    cpc = min(classes_per_client, len(nonempty))
    scores = rng.random((block_size, len(nonempty)))
    picks = nonempty[np.argsort(scores, axis=1, kind="stable")[:, :cpc]]
    base, rem = divmod(spc, cpc)
    counts = np.zeros((block_size, C), dtype=np.int64)
    rows = np.arange(block_size)[:, None]
    np.add.at(counts, (np.broadcast_to(rows, picks.shape), picks), base)
    if rem:
        np.add.at(counts, (np.broadcast_to(rows, picks[:, :rem].shape),
                           picks[:, :rem]), 1)
    return _draw_block(rng, counts, pools)


def _iter_client_lists(labels: np.ndarray, *, population: int,
                       partitioner: str, spc: int, alpha: float,
                       classes_per_client: int, seed: int, n_classes: int,
                       lo: int = 0, hi: Optional[int] = None):
    """Yield (first_client_id, [per-client int64 index arrays]) in client
    order, in bounded chunks — the streaming source every build consumes.

    ``[lo, hi)`` restricts the yield to a client range WITHOUT changing
    any client's content: blocks are always generated on the global
    BUILD_BLOCK grid (rng keyed by the global block index, block size
    taken from the population), then sliced to the range — the invariant
    the parallel build rests on."""
    hi = population if hi is None else hi
    grid_lo = (lo // BUILD_BLOCK) * BUILD_BLOCK
    if partitioner == "label_shards":
        groups = native.distribute_data(labels, population,
                                        n_classes=n_classes)
        for start in range(grid_lo, hi, BUILD_BLOCK):
            stop = min(start + BUILD_BLOCK, population)
            a0, a1 = max(start, lo), min(stop, hi)
            yield a0, [np.asarray(list(groups.get(a, ())), dtype=np.int64)
                       for a in range(a0, a1)]
        return
    if partitioner not in PARTITIONERS:
        raise ValueError(f"partitioner must be one of {PARTITIONERS}, "
                         f"got {partitioner!r}")
    pools = _class_pools(labels, n_classes)
    if not any(len(p) for p in pools):
        raise ValueError("cannot partition an empty dataset")
    for start in range(grid_lo, hi, BUILD_BLOCK):
        stop = min(start + BUILD_BLOCK, population)
        rng = _block_rng(seed, start // BUILD_BLOCK)
        if partitioner == "dirichlet":
            block = _dirichlet_block(rng, stop - start, pools, spc, alpha)
        else:
            block = _pathological_block(rng, stop - start, pools, spc,
                                        classes_per_client)
        a0, a1 = max(start, lo), min(stop, hi)
        yield a0, list(block[a0 - start:a1 - start])


@dataclasses.dataclass
class ClientBank:
    """An opened bank: memmapped offsets + lazily-memmapped index shards.

    ``offsets`` is np.load(mmap_mode="r") — O(population) bytes stay on
    disk; a cohort gather touches m+1 entries. Shard memmaps open on first
    use and are views, never copies."""

    dir: str
    meta: Dict
    offsets: np.ndarray                       # int64 [K+1] (memmap)
    _shards: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    _files: Dict[int, object] = dataclasses.field(default_factory=dict)

    @property
    def population(self) -> int:
        return int(self.meta["population"])

    @property
    def max_client_n(self) -> int:
        return int(self.meta["max_client_n"])

    @property
    def shard_clients(self) -> int:
        return int(self.meta["shard_clients"])

    def padded_max_n(self, pad_multiple: int = 1) -> int:
        """The static cohort-row length: max client shard size rounded up
        exactly like the dense layout (data/arrays.padded_max_n), so a
        label_shards bank row is bitwise the dense stacked row."""
        return padded_max_n(np.asarray([self.max_client_n]), pad_multiple)

    def _shard(self, i: int) -> np.ndarray:
        mm = self._shards.get(i)
        if mm is None:
            path = os.path.join(self.dir, f"indices-{i:05d}.bin")
            mm = np.memmap(path, dtype=np.int64, mode="r")
            self._shards[i] = mm
        return mm

    def client_indices(self, cid: int) -> np.ndarray:
        """This client's sample-index list (a memmap view)."""
        cid = int(cid)
        lo, hi = int(self.offsets[cid]), int(self.offsets[cid + 1])
        if lo == hi:
            # an empty shard must not touch the shard file (a shard whose
            # clients are all empty is a 0-byte file np.memmap rejects)
            return np.empty((0,), dtype=np.int64)
        s = cid // self.shard_clients
        base = int(self.offsets[s * self.shard_clients])
        return self._shard(s)[lo - base:hi - base]

    def _shard_fd(self, i: int) -> int:
        f = self._files.get(i)
        if f is None:
            path = os.path.join(self.dir, f"indices-{i:05d}.bin")
            f = open(path, "rb")
            self._files[i] = f
        return f.fileno()

    def read_client_indices(self, cid: int) -> np.ndarray:
        """This client's sample-index list, STREAMED: one pread of
        exactly the row's byte range into a fresh buffer. Unlike the
        memmap view (``client_indices``) no shard pages join the resident
        set — at 10M+ clients a long run's gathers would otherwise
        accumulate the whole touched shard in RSS. Bitwise-equal to
        ``client_indices`` by construction (same bytes, same dtype)."""
        cid = int(cid)
        lo, hi = int(self.offsets[cid]), int(self.offsets[cid + 1])
        if lo == hi:
            return np.empty((0,), dtype=np.int64)
        s = cid // self.shard_clients
        base = int(self.offsets[s * self.shard_clients])
        buf = os.pread(self._shard_fd(s), (hi - lo) * 8, (lo - base) * 8)
        return np.frombuffer(buf, dtype=np.int64)

    def close(self) -> None:
        """Release streamed-read file handles (memmaps close with GC;
        the pread fds are real OS handles and deserve an explicit
        release — long-lived drivers reopen lazily on next use)."""
        for f in self._files.values():
            try:
                f.close()
            except OSError:
                pass
        self._files.clear()

    def sizes_of(self, ids) -> np.ndarray:
        ids = np.asarray(ids, dtype=np.int64)
        off = self.offsets
        return (off[ids + 1] - off[ids]).astype(np.int32)

    def gather(self, ids, images: np.ndarray, labels: np.ndarray,
               max_n: int, streamed: bool = True
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The cohort's padded stacks: ([m, max_n, ...] images, [m, max_n]
        labels, [m] sizes) — the exact AgentShards row layout, built for
        the m sampled clients only. ``streamed`` (default) preads each
        row's byte range; ``streamed=False`` keeps the historical memmap
        path (bitwise-identical output, larger resident set)."""
        ids = np.asarray(ids, dtype=np.int64)
        fetch = self.read_client_indices if streamed else self.client_indices
        m = len(ids)
        out_img = np.zeros((m, max_n) + images.shape[1:], dtype=images.dtype)
        out_lbl = np.zeros((m, max_n), dtype=np.int32)
        sizes = np.zeros((m,), dtype=np.int32)
        for j, cid in enumerate(ids):
            idx = np.asarray(fetch(cid))
            n = len(idx)
            sizes[j] = n
            if n:
                out_img[j, :n] = images[idx]
                out_lbl[j, :n] = labels[idx]
        return out_img, out_lbl, sizes

    @classmethod
    def open(cls, bank_dir: str) -> "ClientBank":
        with open(os.path.join(bank_dir, META_NAME)) as f:
            meta = json.load(f)
        if meta.get("version") != BANK_VERSION:
            raise ValueError(f"bank {bank_dir!r}: version "
                             f"{meta.get('version')} != {BANK_VERSION}")
        offsets = np.load(os.path.join(bank_dir, OFFSETS_NAME),
                          mmap_mode="r")
        return cls(bank_dir, meta, offsets)


class BankCorrupted(ValueError):
    """A shard's bytes disagree with its sha256 sidecar — real on-disk
    damage, never a stale-config condition ``get_or_build`` may silently
    rebuild over."""


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def verify_digests(bank_dir: str, log=print) -> int:
    """Data-plane integrity: check every ``indices-*.bin``
    shard against its ``.sha256`` sidecar (written at build — presence
    is atomic with the bank's publish rename). A mismatch raises a loud,
    actionable error NAMING the shard: a silently corrupted index shard
    would otherwise feed garbage batches to every cohort that touches
    its clients. Shards without a sidecar (a pre-digest legacy bank) are
    skipped with a note. Returns the number of shards verified."""
    names = sorted(n for n in os.listdir(bank_dir)
                   if n.startswith("indices-") and n.endswith(".bin"))
    checked = 0
    for name in names:
        path = os.path.join(bank_dir, name)
        sidecar = path + DIGEST_SUFFIX
        if not os.path.exists(sidecar):
            log(f"[bank] {name}: no digest sidecar (pre-digest bank) — "
                f"skipping verification for this shard")
            continue
        with open(sidecar, encoding="utf-8") as f:
            want = f.read().strip()
        have = _file_sha256(path)
        if have != want:
            raise BankCorrupted(
                f"client bank shard CORRUPTED: {path} hashes to "
                f"{have[:16]}… but its sidecar records {want[:16]}… — "
                f"the bank on disk is damaged (bad disk, torn copy, or "
                f"tampering). Delete the bank directory ({bank_dir}) to "
                f"rebuild it deterministically, or restore it from a "
                f"good copy.")
        checked += 1
    return checked


def _write_range(tmp: str, labels: np.ndarray, lo: int, hi: int, *,
                 population: int, partitioner: str, spc: int, alpha: float,
                 classes_per_client: int, seed: int, n_classes: int,
                 shard_clients: int, sha=None
                 ) -> Tuple[np.ndarray, int, int]:
    """Write the shard files covering clients ``[lo, hi)`` into ``tmp``
    (plus sha256 sidecars). ``lo`` must be shard-aligned so every shard
    file this range touches is written whole — the unit one build worker
    owns. ``sha``, when given, is updated with each row's bytes in client
    order (the serial in-process build's running content hash). Returns
    (per-client row sizes [hi-lo], max_client_n, total_indices)."""
    if lo % shard_clients:
        raise ValueError(f"range start {lo} not aligned to "
                         f"shard_clients={shard_clients}")
    sizes = np.zeros(hi - lo, dtype=np.int64)
    max_client_n = 0
    total = 0
    shard_f = None
    shard_id = -1
    shard_sha = None

    def close_shard():
        # finalize the open shard: close it and land its sha256 sidecar
        # (data-plane integrity: verify_digests checks it on
        # every --bank_verify open). Sidecars are written inside the tmp
        # dir, so they publish atomically with the bank's rename.
        nonlocal shard_f, shard_sha
        if shard_f is not None:
            path = shard_f.name
            shard_f.close()
            shard_f = None
            with open(path + DIGEST_SUFFIX, "w", encoding="utf-8") as sf:
                sf.write(shard_sha.hexdigest() + "\n")

    try:
        for start, lists in _iter_client_lists(
                labels, population=population, partitioner=partitioner,
                spc=spc, alpha=alpha,
                classes_per_client=classes_per_client, seed=seed,
                n_classes=n_classes, lo=lo, hi=hi):
            for j, idx in enumerate(lists):
                cid = start + j
                s = cid // shard_clients
                if s != shard_id:
                    close_shard()
                    shard_id = s
                    shard_sha = hashlib.sha256()
                    shard_f = open(os.path.join(
                        tmp, f"indices-{s:05d}.bin"), "wb")
                buf = np.ascontiguousarray(idx, dtype=np.int64).tobytes()
                shard_f.write(buf)
                if sha is not None:
                    sha.update(buf)
                shard_sha.update(buf)
                n = len(idx)
                max_client_n = max(max_client_n, n)
                total += n
                sizes[cid - lo] = n
    finally:
        close_shard()
    return sizes, max_client_n, total


_WORKER_LABELS = "labels.npy"


def _build_worker(args) -> Dict:
    """One parallel-build subprocess: write this worker's whole-shard
    client range. Module-level and primitive-args so the spawn context
    can pickle it; labels come from the tmp dir (saved once by the
    parent) rather than the pickle stream."""
    (tmp, w, lo, hi, population, partitioner, spc, alpha,
     classes_per_client, seed, n_classes, shard_clients) = args
    labels = np.load(os.path.join(tmp, _WORKER_LABELS))
    sizes, max_client_n, total = _write_range(
        tmp, labels, lo, hi, population=population,
        partitioner=partitioner, spc=spc, alpha=alpha,
        classes_per_client=classes_per_client, seed=seed,
        n_classes=n_classes, shard_clients=shard_clients)
    # sizes ride a file, not the result pickle: at 100M clients a
    # worker's sizes array is hundreds of MB
    np.save(os.path.join(tmp, f"sizes-{w:05d}.npy"), sizes)
    return {"w": w, "lo": lo, "hi": hi,
            "max_client_n": int(max_client_n), "total": int(total),
            "shards": (hi - lo + shard_clients - 1) // shard_clients}


def build_bank(bank_dir: str, labels: np.ndarray, *, population: int,
               partitioner: str = "dirichlet", samples_per_client: int = 0,
               dirichlet_alpha: float = 0.5, classes_per_client: int = 2,
               seed: int = 0, n_classes: int = 10,
               shard_clients: int = 65536, key: Optional[str] = None,
               workers: int = 1, log=print) -> ClientBank:
    """Partition once into an offset-indexed store. Streams: peak memory is
    O(BUILD_BLOCK * samples_per_client) regardless of population. The
    build lands in a temp dir and is renamed into place atomically, so a
    concurrent builder (or a killed one) can never leave a half-bank that
    opens. `key` is the precomputed bank_key of these exact inputs
    (callers that already paid the labels hash pass it through).

    ``workers > 1`` fans the shard range out across spawn subprocesses
    (whole shard files per worker, clamped to the shard count); the
    published bank — content_sha, offsets, every shard byte — is
    bitwise identical to the serial build's by construction, so
    ``workers`` never joins the bank key."""
    labels = np.asarray(labels)
    spc = resolve_samples_per_client(samples_per_client, len(labels),
                                     population)
    shard_clients = max(1, int(shard_clients))
    if key is None:
        key = bank_key(labels, population=population,
                       partitioner=partitioner, samples_per_client=spc,
                       dirichlet_alpha=dirichlet_alpha,
                       classes_per_client=classes_per_client, seed=seed,
                       n_classes=n_classes)
    n_shards = (population + shard_clients - 1) // shard_clients
    workers = max(1, min(int(workers), n_shards))
    tmp = f"{bank_dir}.tmp.{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    kw = dict(population=population, partitioner=partitioner, spc=spc,
              alpha=dirichlet_alpha,
              classes_per_client=classes_per_client, seed=seed,
              n_classes=n_classes, shard_clients=shard_clients)
    if workers == 1:
        sha = hashlib.sha256()
        sizes, max_client_n, total = _write_range(tmp, labels, 0,
                                                  population, sha=sha,
                                                  **kw)
        content_sha = sha.hexdigest()
    else:
        # whole-shard contiguous ranges per worker: shard s's bytes are
        # written by exactly one process, and the ranges tile the client
        # axis in order — concatenating the shard files in shard order
        # reproduces the serial content byte stream exactly
        np.save(os.path.join(tmp, _WORKER_LABELS),
                np.ascontiguousarray(labels, dtype=np.int64))
        bounds = [round(n_shards * w / workers) * shard_clients
                  for w in range(workers + 1)]
        bounds[-1] = population
        jobs = [(tmp, w, bounds[w], min(bounds[w + 1], population),
                 population, partitioner, spc, dirichlet_alpha,
                 classes_per_client, seed, n_classes, shard_clients)
                for w in range(workers)]
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(workers) as pool:
            results = list(pool.imap_unordered(_build_worker, jobs))
        results.sort(key=lambda r: r["w"])
        sizes = np.concatenate(
            [np.load(os.path.join(tmp, f"sizes-{r['w']:05d}.npy"))
             for r in results])
        max_client_n = max(r["max_client_n"] for r in results)
        total = sum(r["total"] for r in results)
        # one global content sha: stream the finished shard files in
        # shard order (= client order) through a single hash
        sha = hashlib.sha256()
        for s in range(n_shards):
            path = os.path.join(tmp, f"indices-{s:05d}.bin")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    for chunk in iter(lambda: f.read(1 << 20), b""):
                        sha.update(chunk)
        content_sha = sha.hexdigest()
        os.remove(os.path.join(tmp, _WORKER_LABELS))
        for r in results:
            os.remove(os.path.join(tmp, f"sizes-{r['w']:05d}.npy"))
    offsets = np.zeros(population + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    np.save(os.path.join(tmp, OFFSETS_NAME), offsets)
    meta = {
        "version": BANK_VERSION, "key": key, "content_sha": content_sha,
        "population": population, "partitioner": partitioner,
        "samples_per_client": spc, "dirichlet_alpha": dirichlet_alpha,
        "classes_per_client": classes_per_client, "seed": seed,
        "n_classes": n_classes, "shard_clients": shard_clients,
        "n_base_samples": int(len(labels)),
        "total_indices": int(total), "max_client_n": int(max_client_n),
        "n_shards": (population + shard_clients - 1) // shard_clients,
    }
    with open(os.path.join(tmp, META_NAME), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    if os.path.isdir(bank_dir):
        # a racing builder finished first: its content is identical by
        # construction (same key); keep it
        shutil.rmtree(tmp)
    else:
        try:
            os.replace(tmp, bank_dir)
        except OSError:
            # check-then-replace race: a concurrent builder published
            # between the isdir check and the rename (os.replace cannot
            # overwrite a non-empty dir). Same key => same content; keep
            # the winner's
            if not os.path.isdir(bank_dir):
                raise
            shutil.rmtree(tmp)
    log(f"[bank] {partitioner} partition of {population:,} clients "
        f"({total:,} index rows, max shard {max_client_n}, "
        f"{meta['n_shards']} shard file(s)"
        + (f", {workers} build workers" if workers > 1 else "")
        + f") -> {bank_dir}")
    return ClientBank.open(bank_dir)


def get_or_build(bank_dir: str, labels: np.ndarray, *, population: int,
                 partitioner: str, samples_per_client: int,
                 dirichlet_alpha: float, classes_per_client: int,
                 seed: int, n_classes: int, shard_clients: int,
                 key: Optional[str] = None, verify: bool = False,
                 workers: int = 1, log=print) -> Tuple[ClientBank, bool]:
    """Open `bank_dir` when its key matches this config, else (re)build.
    Returns (bank, built). `key` = precomputed bank_key of these inputs
    (the labels sha256 is the expensive part — callers that already
    computed it to resolve the bank dir pass it through). ``verify``
    (--bank_verify) checks every reused shard against its sha256
    sidecar before the first gather — a corrupted bank fails loudly
    naming the shard instead of feeding garbage batches (a fresh build
    is trusted: the sidecars were just computed from the written
    bytes)."""
    labels = np.asarray(labels)
    spc = resolve_samples_per_client(samples_per_client, len(labels),
                                     population)
    if key is None:
        key = bank_key(labels, population=population,
                       partitioner=partitioner, samples_per_client=spc,
                       dirichlet_alpha=dirichlet_alpha,
                       classes_per_client=classes_per_client, seed=seed,
                       n_classes=n_classes)
    meta_path = os.path.join(bank_dir, META_NAME)
    if os.path.exists(meta_path):
        try:
            bank = ClientBank.open(bank_dir)
            if bank.meta.get("key") == key:
                if verify:
                    # a digest MISMATCH stays loud (BankCorrupted is not
                    # caught below): silently rebuilding would hide real
                    # disk damage behind a multi-minute rebuild
                    n = verify_digests(bank_dir, log=log)
                    log(f"[bank] {bank_dir}: {n} shard digest(s) "
                        f"verified (--bank_verify)")
                return bank, False
            log(f"[bank] {bank_dir}: key mismatch "
                f"(have {bank.meta.get('key')}, want {key}); rebuilding")
        except BankCorrupted:
            raise
        except (OSError, ValueError) as e:
            log(f"[bank] {bank_dir}: unreadable ({e}); rebuilding")
        shutil.rmtree(bank_dir, ignore_errors=True)
    bank = build_bank(bank_dir, labels, population=population,
                      partitioner=partitioner, samples_per_client=spc,
                      dirichlet_alpha=dirichlet_alpha,
                      classes_per_client=classes_per_client, seed=seed,
                      n_classes=n_classes, shard_clients=shard_clients,
                      key=key, workers=workers, log=log)
    return bank, True
