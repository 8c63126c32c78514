"""Host batching with background prefetch (the JAX package's
``slice3d_tpu/data/pipeline.py``).

A producer thread maps the dataset over a thread pool and stacks numpy
batches into a bounded queue, so image decoding overlaps the card's work.
With ``shuffle=False`` the batches keep the dataset's order; with
``drop_last=False`` the short last batch is kept.  A worker's exception is
raised in the consumer.

In a process group every process is one of ``num_shards`` shards (default:
the group's size and this process's rank): all of them draw the one
permutation from the shared seed and walk global batches of ``num_shards x
batch_size``, each taking its ``shard``-th ``batch_size`` rows.  The shards
are disjoint and together the one-process loader's batches at the global
size.  (The JAX package's loader gives every process the same batches: each
shuffles the whole split with the same seed and takes all of it.)
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from ..parallel.mesh import rank, world_size

__all__ = ["BatchLoader"]


class BatchLoader:
    """Iterates dict-of-array batches of ``batch_size`` (this shard's) with
    background prefetch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                 num_workers: int = 4, prefetch: int = 2, seed: int = 0,
                 num_shards: Optional[int] = None, shard: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.num_shards = world_size() if num_shards is None else num_shards
        self.shard = rank() if shard is None else shard
        if not 0 <= self.shard < self.num_shards:
            raise ValueError(f"shard {self.shard} of {self.num_shards}")
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        n, gb = len(self.dataset), self.batch_size * self.num_shards
        if self.drop_last:
            return n // gb
        # the last global batch may leave the later shards nothing
        return n // gb + int(n % gb > self.shard * self.batch_size)

    def _batch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        bs = self.batch_size
        gb = bs * self.num_shards
        end = len(idx) - (len(idx) % gb) if self.drop_last else len(idx)
        for i in range(0, end, gb):
            part = idx[i + self.shard * bs:min(i + (self.shard + 1) * bs, end)]
            if len(part):
                yield part

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # give up when the consumer has gone, rather than block forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx in self._batch_indices():
                        samples = list(pool.map(self.dataset.__getitem__, batch_idx))
                        batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
                        if not put(batch):
                            return
                put(None)
            except BaseException as exc:  # surface worker failures to the consumer
                put(exc)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            thread.join()
