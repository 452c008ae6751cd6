"""Shuffled epoch batching with one background prefetch thread
(counterpart of text2protein_tpu/data/loader.py). Each batch carries its
records' dataset indices, `index` (B,) int32 (`loader.py:55-59`). Across
nodes each loads its shard of the index space, `indices[host_id::
host_count]`, as each JAX host does (`loader.py:35`)."""

from __future__ import annotations

import queue
import threading

import numpy as np

from .dataset import make_batch


class PrefetchLoader:
    """Iterate batches of records; one thread reads and collates ahead.

    Args:
      dataset: indexable record source (ProteinProcessedDataset).
      indices: index array of this split.
      batch_size, max_len: batch geometry.
      seed: the shuffle's seed (an explicit numpy RandomState).
      start: the number of the epoch's first batches to leave out (a
        resumed run continues inside its epoch).
      host_id/host_count: this node's shard of the index space.
    """

    def __init__(self, dataset, indices, batch_size, max_len, seed=0,
                 prefetch=2, shuffle=True, drop_last=True, start=0,
                 host_id=0, host_count=1):
        self.dataset = dataset
        self.indices = np.asarray(indices)[host_id::host_count]
        self.batch_size = batch_size
        self.max_len = max_len
        self.prefetch = prefetch
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.start = start
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        n = len(self.indices)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def _produce(self, order, q):
        try:
            for i in range(0, len(order), self.batch_size):
                chunk = order[i: i + self.batch_size]
                if len(chunk) < self.batch_size and self.drop_last:
                    break
                recs = [self.dataset[int(j)] for j in chunk]
                batch = make_batch(recs, self.max_len)
                # the records' indices in the dataset: the trainer gathers
                # their rows of the resident context table by them
                batch["index"] = np.asarray(chunk, dtype=np.int32)
                q.put(batch)
        except Exception as e:  # surface worker errors to the consumer
            q.put(e)
        finally:
            q.put(None)

    def __iter__(self):
        order = (self.rng.permutation(self.indices) if self.shuffle
                 else self.indices)[self.start * self.batch_size:]
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=self._produce, args=(order, q),
                             daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            yield item
        t.join()
