"""Host->device input pipeline of the host-sampled (fedemnist-scale) round.

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
data/prefetch.py` (`RoundPrefetcher`, kept with JAX's contract: depth,
order, the retry of the last unit, a producer's exception re-raised at
`get`, the stall heartbeat). The host-sampled round gathers the round's m
sampled shards on the host and ships them to the card each round; done in
line, the gather and the copy sit between two replays of the round.
`RoundPrefetcher` runs them on a worker thread up to `depth` rounds
ahead, in the order the driver will ask for them.

`HostGather` is the producer: the rows of the sampled ids, from the
dense host stacks or from the cohort round's client bank
(data/registry.CohortData.gather_cohort), gathered into pinned host
memory, then copied to the card on a side stream, with an event that the
round's stream waits on before it reads them (`Payload.ready`). A chained
unit's rounds are gathered as one [chain, m, ...] block. The sampling
sequence is the caller's (train.sample_ids: seeded per round, or the
cohort draw); the pipeline only evaluates it early.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

_SENTINEL = object()


@dataclasses.dataclass
class Payload:
    """One dispatch unit's gathered stacks on the round's device: the ids
    ([m], or [chain, m] for a chained block), images [..., m, max_n, ...],
    labels [..., m, max_n] int64 and sizes [..., m] int32; on the host the
    sizes again (`host_sizes`, what the slot draws read) and, on the
    cohort round, the cohort's `active` mask. On a CUDA device the copies
    may still be in flight on a side stream until `ready()`."""
    ids: np.ndarray
    images: torch.Tensor
    labels: torch.Tensor
    sizes: torch.Tensor
    event: Optional["torch.cuda.Event"] = None
    host_sizes: Optional[np.ndarray] = None
    active: Optional[np.ndarray] = None

    def ready(self):
        """(ids, images, labels, sizes), the current stream made to wait
        for their copies and named as their user (the caching allocator
        then keeps their blocks until that stream is past them)."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.images.device)
            stream.wait_event(self.event)
            for t in (self.images, self.labels, self.sizes):
                t.record_stream(stream)
            self.event = None
        return self.ids, self.images, self.labels, self.sizes


class HostGather:
    """gather(ids, active=None) -> Payload: the rows of `ids` from a gather
    source, on `device`. The source is the dense host shard stacks (an
    `AgentShards`: the host-sampled round's, rows taken by id) or a
    function ids -> (images, labels, sizes) of numpy arrays (the cohort
    round's `CohortData.gather_cohort`, reading the client bank). `ids` is
    one round's [m] or a chained block's [chain, m]: a block is gathered
    whole, one payload a dispatch unit. On a CUDA device the rows land in
    pinned memory and are copied on this gatherer's side stream, without
    a host sync; elsewhere they are plain tensors."""

    def __init__(self, source, device):
        self.source = source
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def __call__(self, ids, active=None) -> Payload:
        ids = np.asarray(ids)
        if callable(self.source):
            per_round = [self.source(row)
                         for row in ids.reshape(-1, ids.shape[-1])]
            arrays = [np.stack([r[i] for r in per_round]).reshape(
                ids.shape + per_round[0][i].shape[1:]) for i in range(3)]
            shapes = [a.shape for a in arrays]

            def fill(i, out):
                out[...] = arrays[i]
        else:
            src = (self.source.images, self.source.labels,
                   self.source.sizes)
            shapes = [ids.shape + a.shape[1:] for a in src]

            def fill(i, out):
                if out.dtype == src[i].dtype:       # one pass, no temporary
                    np.take(src[i], ids, axis=0, out=out)
                else:
                    out[...] = src[i][ids]
        dtypes = [torch.from_numpy(np.empty(0, a.dtype)).dtype
                  for a in (arrays if callable(self.source) else src)]
        # labels go to int64 on the device, the cross-entropy's target type
        dtypes[1] = torch.int64
        if active is not None:
            active = np.asarray(active, dtype=bool)
        bufs = [torch.empty(shape, dtype=dt,
                            pin_memory=self.stream is not None)
                for shape, dt in zip(shapes, dtypes)]
        for i, buf in enumerate(bufs):
            fill(i, buf.numpy())
        host_sizes = bufs[2].numpy().copy()
        if self.stream is None:
            return Payload(ids, *bufs, host_sizes=host_sizes, active=active)
        with torch.cuda.stream(self.stream):
            dev = [b.to(self.device, non_blocking=True) for b in bufs]
            event = torch.cuda.Event()
            event.record(self.stream)
        # freeing the pinned buffers is safe: the caching host allocator
        # holds each block until the copy's event has passed
        return Payload(ids, *dev, event=event, host_sizes=host_sizes,
                       active=active)


class RoundPrefetcher:
    """Depth-bounded background producer of per-round payloads.

    produce(rnd) -> payload is called on a worker thread for each round id
    in `rounds`, in order; `get(rnd)` returns the payloads in the same
    order. A producer exception is re-raised by the next `get` call.

    Up to depth + 2 payloads are resident at once: `depth` queued, one in
    the worker's hand mid-put, and the one retained for a retry of the
    last round (see get())."""

    # get() re-checks for a wedged worker at this period, and logs a
    # heartbeat so a hang (a stuck gather or copy) is attributable to the
    # pipeline rather than silently blocking the driver
    STALL_WARN_SEC = 30.0

    def __init__(self, produce: Callable, rounds: Iterable[int],
                 depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err = None
        self._last = None  # (rnd, payload) most recently served — see get()
        self._thread = threading.Thread(
            target=self._worker, args=(produce, rounds), daemon=True)
        self._thread.start()

    def _put_checked(self, item) -> bool:
        """Blocking put that a racing close() can always interrupt: retries
        on a full queue until the item lands or `_stop` is set, so nothing
        (the sentinel least of all) is dropped and nothing blocks forever
        against close()."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, produce, rounds):
        try:
            for rnd in rounds:
                payload = produce(rnd)
                if not self._put_checked((rnd, payload)):
                    return
        except BaseException as e:  # surfaced to the consumer by get()
            self._err = e
        finally:
            self._put_checked(_SENTINEL)

    def get(self, rnd):
        """Blocking fetch of round `rnd`'s payload (calls must follow the
        constructor's round order). A repeat request for the round just
        served returns it again (a retry of the same unit). While waiting
        it logs a stall heartbeat every STALL_WARN_SEC."""
        if self._last is not None and self._last[0] == rnd:
            return self._last[1]
        waited = 0.0
        while True:
            try:
                item = self._q.get(timeout=self.STALL_WARN_SEC)
                break
            except queue.Empty:
                waited += self.STALL_WARN_SEC
                alive = self._thread.is_alive()
                print(f"[prefetch] stalled waiting for round {rnd} "
                      f"({waited:.0f}s; worker "
                      f"{'alive' if alive else 'DEAD'})", flush=True)
                if not alive and self._q.empty():
                    raise RuntimeError(
                        f"prefetch worker died without sentinel before "
                        f"round {rnd}") from self._err
        if item is _SENTINEL:
            if self._err is not None:
                raise RuntimeError(
                    f"prefetch worker failed before round {rnd}") \
                    from self._err
            raise RuntimeError(
                f"prefetch exhausted before round {rnd} — the driver asked "
                f"for a round outside the range it constructed")
        got, payload = item
        if got != rnd:
            raise RuntimeError(
                f"prefetch order violation: driver asked for round {rnd}, "
                f"pipeline produced round {got}")
        self._last = (got, payload)
        return payload

    def close(self) -> None:
        """Stop the worker and release anything it buffered."""
        self._stop.set()
        # keep draining until the worker exits: it may be mid-put with one
        # payload in hand. Bounded: give up after 10 s if produce() itself
        # is stuck (a daemon thread, which does not block exit).
        deadline = time.monotonic() + 10.0
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.1)
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
