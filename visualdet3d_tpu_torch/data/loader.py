"""Host input pipeline (counterpart of ``visualdet3d_tpu/data/loader.py``):
a prefetching loader over an indexable dataset whose decode and
augmentation run in a thread pool.

Threads, not ``torch.utils.data.DataLoader``'s worker processes: the
augmentations draw from numpy's global generator, which forked workers
would each copy (every worker drawing the same augmentations), and a
forked worker cannot touch CUDA. The PNG unfilter, numpy and torch's CPU
ops release the interpreter lock, so the threads decode and augment in
parallel. Batches are collated into fixed-shape numpy arrays.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional

from visualdet3d_tpu_torch.data.samplers import InferenceSampler, TrainingSampler


class DataLoader:
    """Batched loader with background prefetch.

    Args:
      dataset: indexable with __getitem__/__len__.
      batch_size: items per batch.
      collate_fn: fn(list_of_items) -> batch.
      sampler: iterable of indices; default sequential one-pass.
      num_workers: decode threads (0 = synchronous).
      prefetch: number of batches to stage ahead.
      drop_last: drop the trailing partial batch (True keeps shapes static).
    """

    def __init__(self, dataset, batch_size: int, collate_fn: Callable,
                 sampler: Optional[Iterable[int]] = None, num_workers: int = 4,
                 prefetch: int = 2, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.sampler = sampler
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> Iterator[list]:
        indices = self.sampler if self.sampler is not None else range(len(self.dataset))
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __iter__(self):
        if self.num_workers <= 0:
            for idx_batch in self._index_batches():
                yield self.collate_fn([self.dataset[i] for i in idx_batch])
            return
        yield from self._threaded_iter()

    def _threaded_iter(self):
        out_q: 'queue.Queue' = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        sentinel = object()

        def put(item) -> bool:
            """Hand ``item`` over unless the consumer has gone."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            with ThreadPoolExecutor(self.num_workers) as pool:
                try:
                    for idx_batch in self._index_batches():
                        items = list(pool.map(self.dataset.__getitem__, idx_batch))
                        if not put(self.collate_fn(items)):
                            return
                except BaseException as e:  # handed to the consumer, which raises it
                    put(e)
                    return
                put(sentinel)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # a consumer that stops early (an epoch of an infinite sampler)
            # ends the producer instead of leaving it blocked on a full queue
            stop.set()
            thread.join()


def build_dataloader(dataset, num_workers: int, batch_size: int,
                     collate_fn: Callable, local_rank: int = -1, world_size: int = 1,
                     training: bool = True) -> DataLoader:
    """A loader over a ``TrainingSampler`` (training: shuffled, endless,
    full batches) or an ``InferenceSampler`` (one pass, the last batch
    kept), each sharded to process ``local_rank`` of ``world_size`` (-1:
    a single process); ``batch_size`` items a batch in each process."""
    rank = max(local_rank, 0)
    sampler = (TrainingSampler(len(dataset), shuffle=True, rank=rank, world_size=world_size)
               if training else InferenceSampler(len(dataset), rank=rank, world_size=world_size))
    return DataLoader(dataset, batch_size=batch_size, collate_fn=collate_fn,
                      sampler=sampler, num_workers=num_workers,
                      drop_last=training)
