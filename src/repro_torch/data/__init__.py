"""repro_torch.data — the deterministic synthetic tasks.

Copies of ``repro.data.synthetic`` (numpy): per-(seed, step) batches, the
same in both packages. The JAX package's ``Prefetcher`` and
``sharded_batches`` (``repro.data.pipeline``) wait for the port's
training slice.
"""
from .synthetic import (
    AddingTask,
    CharLMTask,
    CopyTask,
    SeqClassifyTask,
    lm_batch_iterator,
)

__all__ = [
    "CharLMTask", "CopyTask", "AddingTask", "SeqClassifyTask",
    "lm_batch_iterator",
]
