"""Pull-based prefetching pipeline, the port of ``repro.data.pipeline``.

``Prefetcher`` runs the generator in a daemon thread with a bounded
queue, the classic straggler absorber: a slow host-side batch generation
step does not stall the card as long as the queue has depth (copied).
``sharded_batches`` puts each numpy batch on the device, so the train
step consumes tensors already there (no implicit transfer inside the
step); on a mesh each array becomes a DTensor on the placements of its
spec (``dist.rules.batch_specs``), the counterpart of JAX's
``device_put`` with a ``NamedSharding``. Every rank draws the same
batches, so each keeps its own part and nothing is communicated: the
prefetch thread makes them without a collective.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterator

import torch

from repro_torch._device import resolve_device
from repro_torch.dist.api import NamedSharding, P, place, to_placements


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
    Given a ``DeviceMesh`` and ``specs`` ({key: P}; a key without one is
    replicated), each array is a DTensor on the mesh, on the rank's own
    device."""
    if mesh is None or specs is None:
        dev = resolve_device(device)
        shardings = None
    else:
        dev = resolve_device(mesh.device_type)
        shardings = {k: NamedSharding(mesh, to_placements(s, mesh))
                     for k, s in specs.items()}
        rep = NamedSharding(mesh, to_placements(P(), mesh))

    def put(k, v):
        t = torch.as_tensor(v).to(dev)
        return t if shardings is None else place(t, shardings.get(k, rep))

    def gen():
        for step, batch in it:
            yield step, {k: put(k, v) for k, v in batch.items()}

    return Prefetcher(gen(), depth=prefetch)
