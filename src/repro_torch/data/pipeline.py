"""Pull-based prefetching pipeline, the port of ``repro.data.pipeline``.

``Prefetcher`` runs the generator in a daemon thread with a bounded
queue, the classic straggler absorber: a slow host-side batch generation
step does not stall the card as long as the queue has depth (copied).
``sharded_batches`` puts each numpy batch on the device, so the train
step consumes tensors already there (no implicit transfer inside the
step). A mesh's batch placement waits for ROADMAP item 20.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterator

import torch

from repro_torch._device import resolve_device


class Prefetcher:
    _SENTINEL = object()

    def __init__(self, it: Iterator[Any], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None

        def run():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:  # surface in consumer
                self._err = e
            finally:
                self._q.put(self._SENTINEL)

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def sharded_batches(it: Iterator[dict], mesh=None, specs=None,
                    prefetch: int = 2, device=None):
    """Wrap a (step, batch) iterator: each batch's arrays as tensors on
    ``device`` (``None`` means the card), made in the prefetch thread.
    With a mesh it raises: the batch placement over a mesh's "data" axis
    (JAX's ``NamedSharding`` of ``batch_specs``) waits for ROADMAP item
    20."""
    if mesh is not None or specs is not None:
        raise NotImplementedError(
            "sharded_batches over a mesh (the batch placement of "
            "batch_specs) waits for ROADMAP item 20; pass mesh=None")
    dev = resolve_device(device)

    def gen():
        for step, batch in it:
            yield step, {k: torch.as_tensor(v).to(dev)
                         for k, v in batch.items()}

    return Prefetcher(gen(), depth=prefetch)
