"""Host batching with background prefetch (the JAX package's
``slice3d_tpu/data/pipeline.py``).

A producer thread maps the dataset over a thread pool and stacks numpy
batches into a bounded queue, so image decoding overlaps the card's work.
With ``shuffle=False`` the batches keep the dataset's order; with
``drop_last=False`` the short last batch is kept.  A worker's exception is
raised in the consumer.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np

__all__ = ["BatchLoader"]


class BatchLoader:
    """Iterates dict-of-array batches with background prefetch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                 num_workers: int = 4, prefetch: int = 2, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        bs = self.batch_size
        end = len(idx) - (len(idx) % bs) if self.drop_last else len(idx)
        for i in range(0, end, bs):
            yield idx[i:i + bs]

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
