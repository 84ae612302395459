"""Batch pipeline and host -> device prefetch.

`DataLoader` is the port's own copy of
`dnn_based_source_separation_tpu/data/loader.py:23-145`: a map-style dataset
becomes shuffled, fixed-size batches of stacked numpy arrays (drop_last by
default when shuffling), with an optional background thread pool
(`num_workers`) keeping `prefetch` assembled batches ahead of the step.
`prefetch_to_device` is the port of its `prefetch_to_device` (:147-175): it
moves those batches to the training device ahead of the step that needs them.
"""
from __future__ import annotations

import collections
import itertools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional

import numpy as np
import torch


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        drop_last: Optional[bool] = None,
        seed: int = 0,
        collate_fn=None,
        num_workers: int = 0,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = shuffle if drop_last is None else drop_last
        self.rng = np.random.default_rng(seed)
        self.collate_fn = collate_fn
        self.num_workers = num_workers
        self.prefetch = prefetch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_starts(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self.rng.shuffle(order)
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        return order, range(0, end, self.batch_size)

    def _assemble(self, idxs):
        items = [self.dataset[int(j)] for j in idxs]
        if self.collate_fn is not None:
            return self.collate_fn(items)
        return tuple(np.stack(field) for field in zip(*items))

    def __iter__(self):
        order, starts = self._batch_starts()
        if self.num_workers <= 0:
            for i in starts:
                yield self._assemble(order[i : i + self.batch_size])
            return

        # Background pipeline: a pool loads the items of each batch and a
        # producer thread keeps up to `prefetch` ready batches staged.
        # Submission is lazy (at most num_workers + prefetch futures
        # outstanding), and a `stop` event lets an abandoned iterator tear
        # the producer down instead of loading the rest of the epoch.
        q: queue.Queue = queue.Queue(maxsize=max(1, self.prefetch))
        sentinel = object()
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    start_iter = iter(starts)
                    pending: collections.deque = collections.deque()

                    def submit_next():
                        for i in start_iter:
                            pending.append(pool.submit(
                                self._assemble, order[i : i + self.batch_size]))
                            return

                    for _ in range(self.num_workers + q.maxsize):
                        submit_next()
                    while pending and not stop.is_set():
                        result = pending.popleft().result()
                        while not stop.is_set():
                            try:
                                q.put(result, timeout=0.1)
                                break
                            except queue.Full:
                                continue
                        submit_next()
                    for fut in pending:  # abandoned: drop unconsumed work
                        fut.cancel()
            except BaseException as exc:  # surface worker errors to the consumer
                # Retry as the normal path does: a single timed put could be
                # dropped while the consumer is busy, leaving the iterator
                # blocked with neither an exception nor a sentinel queued.
                while not stop.is_set():
                    try:
                        q.put(exc, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                return
            while not stop.is_set():
                try:
                    q.put(sentinel, timeout=0.1)
                    break
                except queue.Full:
                    continue

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                out = q.get()
                if out is sentinel:
                    break
                if isinstance(out, BaseException):
                    raise out
                yield out
        finally:
            stop.set()
            try:  # unblock a producer stuck on q.put
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=10)


def prefetch_to_device(batches: Iterable, device, size: int = 2) -> Iterator[tuple]:
    """Yield each batch (a tuple of arrays) as tensors on `device`, `size` batches ahead.

    On CUDA: each array is copied into pinned host memory and sent with a
    `non_blocking` copy on a side stream, so the next batches' transfers
    overlap the current step; the compute stream waits on the copy's event
    before it uses the batch, and the tensors are marked as used by that
    stream so the allocator does not hand their memory out early. The pinned
    host buffers are released by PyTorch's host allocator only after their
    copies have run. On the CPU it is a plain pass-through (no copy of the
    arrays' data).
    """
    device = torch.device(device)
    if device.type != "cuda":
        for batch in batches:
            yield tuple(torch.from_numpy(np.asarray(a)) for a in batch)
        return

    side = torch.cuda.Stream(device)
    staged: collections.deque = collections.deque()
    it = iter(batches)

    def enqueue(n: int) -> None:
        for batch in itertools.islice(it, n):
            host = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory() for a in batch]
            with torch.cuda.stream(side):
                tensors = tuple(h.to(device, non_blocking=True) for h in host)
                ready = torch.cuda.Event()
                ready.record(side)
            staged.append((tensors, ready))

    enqueue(size)
    while staged:
        tensors, ready = staged.popleft()
        compute = torch.cuda.current_stream(device)
        compute.wait_event(ready)
        for t in tensors:
            t.record_stream(compute)
        yield tensors
        enqueue(1)
