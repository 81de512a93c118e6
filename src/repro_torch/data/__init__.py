"""repro_torch.data — the deterministic synthetic tasks and the input
pipeline.

``synthetic``: copies of ``repro.data.synthetic`` (numpy), per-(seed,
step) batches, the same in both packages. ``pipeline``: ``Prefetcher``
(copied) and ``sharded_batches``, which puts each batch on the device,
or on a mesh as DTensors on ``dist.rules.batch_specs``' placements.
"""
from .pipeline import Prefetcher, sharded_batches
from .synthetic import (
    AddingTask,
    CharLMTask,
    CopyTask,
    SeqClassifyTask,
    lm_batch_iterator,
)

__all__ = [
    "CharLMTask", "CopyTask", "AddingTask", "SeqClassifyTask",
    "lm_batch_iterator", "Prefetcher", "sharded_batches",
]
