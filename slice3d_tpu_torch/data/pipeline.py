"""Host batching with background prefetch (the JAX package's
``slice3d_tpu/data/pipeline.py``).

A producer thread maps the dataset over a thread pool and stacks numpy
batches into a bounded queue, so image decoding overlaps the card's work.
With ``shuffle=False`` the batches keep the dataset's order; with
``drop_last=False`` the short last batch is kept.  A worker's exception is
raised in the consumer.

In a process group every process is one of ``num_shards`` shards (default:
the process mesh's data axis and this process's index on it, so the
processes of one model group read the same rows): all of them draw the one
permutation from the shared seed and walk global batches of ``num_shards x
batch_size``, each taking its ``shard``-th ``batch_size`` rows.  The shards
are disjoint and together the one-process loader's batches at the global
size.  (The JAX package's loader gives every process the same batches: each
shuffles the whole split with the same seed and takes all of it.)  With a
``model`` axis larger than 1 only the first process of each model group
loads, and hands every batch to the others: a dataset's own draws (a random
view, a query subset) come from the process's global generators, so
processes loading the same rows would not get the same batch.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from ..parallel.mesh import data_index, data_size, process_mesh

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
        self.num_shards = data_size() if num_shards is None else num_shards
        self.shard = data_index() if shard is None else shard
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
        mesh = process_mesh()
        if mesh.model_size > 1:
            return self._shared(mesh)
        return self._load()

    def _shared(self, mesh) -> Iterator[Dict[str, np.ndarray]]:
        """The model group's first process's batches on every process of the
        group (a broadcast a batch; None ends them)."""
        import torch.distributed as dist

        src = dist.get_global_rank(mesh.model_group, 0)
        batches = self._load() if mesh.model_index == 0 else None
        try:
            while True:
                box = [None if batches is None else next(batches, None)]
                dist.broadcast_object_list(box, src=src, group=mesh.model_group)
                if box[0] is None:
                    return
                yield box[0]
        finally:
            if batches is not None:
                batches.close()

    def _load(self) -> Iterator[Dict[str, np.ndarray]]:
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
