"""Threaded batch prefetcher (counterpart of nerfloc_tpu/data/prefetch.py).

Item assembly is numpy and zlib, which release the GIL for their bulk
work, so a thread pool and a bounded queue overlap data loading with the
device step. The epoch's order comes from the loader's own Generator
(seeded once), as in the JAX package. A data-parallel rank keeps the same
global order (the same seed on every rank) and loads only its rows of
each global batch.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Sequence

import numpy as np

from .batching import device_batch, stack_batches


class BatchLoader:
    """Iterates stacked host batches of `batch_size` items, prefetching
    `prefetch` batches ahead with `num_workers` threads. An exception in a
    worker is raised by the iterator. With `world` > 1 the batches are
    global and this loader yields rank `rank`'s contiguous
    batch_size / world rows of each (batch_size must divide by world);
    len() stays the number of global batches."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, num_workers: int = 8, prefetch: int = 4,
                 drop_last: bool = True, rank: int = 0, world: int = 1):
        if batch_size % world or not 0 <= rank < world or (world > 1 and not drop_last):
            raise ValueError(f"BatchLoader: global batch {batch_size} does not split over "
                             f"{world} ranks (rank {rank}, drop_last {drop_last})")
        self.rank, self.world = rank, world
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def batches(self, epoch: int) -> List[Sequence[int]]:
        """The item indices of each batch of `epoch` (draws the shuffle)."""
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        out: List[Sequence[int]] = []
        for s in range(0, len(order), self.batch_size):
            idxs = order[s: s + self.batch_size]
            if len(idxs) < self.batch_size and self.drop_last:
                break
            out.append(idxs)
        return out

    def epoch(self, epoch: int) -> Iterator[dict]:
        k = self.batch_size // self.world
        batches = [idxs[self.rank * k:(self.rank + 1) * k] for idxs in self.batches(epoch)]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # re-check `stop` while the queue is full: a consumer that left
            # early never drains it
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(
                            lambda i: device_batch(self.dataset[int(i)]), idxs))
                        if not put(stack_batches(items)):
                            return
                put(None)
            except BaseException as e:  # the consumer raises it
                put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                if b is None:
                    return
                if isinstance(b, BaseException):
                    raise b
                yield b
        finally:
            stop.set()
            t.join(timeout=60)
