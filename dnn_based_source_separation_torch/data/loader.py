"""Host -> device batch prefetch.

Port of `dnn_based_source_separation_tpu/data/loader.py:147-175`
(`prefetch_to_device`). The batch pipeline itself is the JAX package's
framework-free `DataLoader`, which yields tuples of numpy arrays; this module
moves them to the training device ahead of the step that needs them.
"""
from __future__ import annotations

import collections
import itertools
from typing import Iterable, Iterator

import numpy as np
import torch


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
