"""Minimal threaded data loader: shuffle, batch, collate, prefetch
(counterpart of ``edge_diffusion_tts_tpu/data/loader.py``: the same order,
batches and threads).

A background thread reads and collates the next batches while the device
computes; the host work per batch is small (the mel frontend runs on the
device).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np


class DataLoader:
    """Iterate over ``dataset`` in shuffled batches, collated by ``collate``.

    ``prefetch`` > 0 runs reading+collation in a daemon thread with a bounded
    queue.  Epoch shuffling is deterministic given ``seed`` (epoch index is
    folded in, so each epoch gets a fresh order).

    ``pin_memory`` (cfg.pin_memory) turns each collated array into a tensor
    in pinned host memory and copies it to ``device`` with
    ``non_blocking=True`` in the producer, so the copy overlaps the previous
    step's compute; on a CPU ``device`` the tensors are made and not pinned.
    Values are unchanged.

    ``workers`` (cfg.num_workers) is the number of read+collate threads.  0
    loads synchronously in the consumer, 1 is the single prefetch thread, >1
    fans collation over a thread pool with order-preserving emission: batch
    order and content are identical for any worker count.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        collate: Callable,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        prefetch: int = 2,
        pin_memory: bool = False,
        workers: int = 1,
        device=None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self.device = device
        self.workers = max(int(workers), 0)
        self.epoch = 0

    def _collate(self, items):
        batch = self.collate(items)
        if self.pin_memory:
            import torch

            device = torch.device(self.device if self.device is not None else "cuda")
            out = {}
            for k, v in batch.items():
                t = torch.from_numpy(np.ascontiguousarray(v))
                if device.type == "cuda":
                    t = t.pin_memory().to(device, non_blocking=True)
                out[k] = t
            batch = out
        return batch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self) -> Iterator[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(n)
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for i in range(0, end, self.batch_size):
            yield order[i : i + self.batch_size]

    def _produce(self, q: "queue.Queue", stop: threading.Event):
        def put(item) -> bool:
            # Bounded put that aborts when the consumer abandoned the epoch
            # (validation loops break after val_batches batches): blocking
            # on q.put forever would leak the thread + its queued batches.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            for idx in self._batch_indices():
                if stop.is_set():
                    return
                items = [self.dataset[int(i)] for i in idx]
                if not put(self._collate(items)):
                    return
            put(None)
        except BaseException as e:  # surface reader errors in the consumer
            put(e)

    def __iter__(self):
        self.epoch += 1
        if self.prefetch <= 0 or self.workers == 0:
            for idx in self._batch_indices():
                yield self._collate([self.dataset[int(i)] for i in idx])
            return
        if self.workers > 1:
            yield from self._iter_pool()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        t = threading.Thread(
            target=self._produce, args=(q, stop), daemon=True
        )
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # Runs on normal exhaustion AND on generator close (a consumer
            # breaking out of its for-loop): releases the producer.
            stop.set()

    def _iter_pool(self):
        """workers > 1: strided read+collate across a thread pool, emitted in
        batch order via a reorder buffer (the consumer keeps draining the
        shared queue while waiting for the next in-order batch, so producers
        never block on an out-of-order head-of-line)."""
        batches = list(self._batch_indices())
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch + self.workers)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def work(w: int):
            try:
                for pos in range(w, len(batches), self.workers):
                    if stop.is_set():
                        return
                    items = [self.dataset[int(i)] for i in batches[pos]]
                    if not put((pos, self._collate(items))):
                        return
            except BaseException as e:  # surface reader errors in the consumer
                put((-1, e))

        threads = [
            threading.Thread(target=work, args=(w,), daemon=True)
            for w in range(self.workers)
        ]
        for t in threads:
            t.start()
        buf = {}
        try:
            for want in range(len(batches)):
                while want not in buf:
                    pos, item = q.get()
                    if pos == -1:
                        raise item
                    buf[pos] = item
                yield buf.pop(want)
        finally:
            stop.set()
