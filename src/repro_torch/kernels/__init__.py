"""repro_torch.kernels — the port's CUDA kernels and their wrappers.

``csrc/csb_mvm.cu`` (the CSB-MVM), ``csrc/paged_attn.cu`` (paged decode
attention) and ``csrc/csb_sharded.cu`` (the CSB-MVM over block-row
shards, sharing the CSB-MVM's block-row body, ``csrc/csb_block.cuh``)
are built on first use by ``_build``; ``csb_mvm`` and ``paged_attn`` are
their launch wrappers, ``ref`` their plain PyTorch versions and ``ops``
the public entry points ``csb_matvec`` and ``paged_attn_decode``.
``csb_sharded`` is kernel B3, ``csb_matvec_sharded``: one launch a call
on each rank of a mesh axis, whose stores into every rank's output are
the exchange (imported on its own: it reads ``repro_torch.dist``).
"""
from .ops import csb_matvec, pad_to_grid, paged_attn_decode
from .ref import csb_mvm_ref, densify, paged_attn_ref

__all__ = ["csb_matvec", "csb_mvm_ref", "densify", "pad_to_grid",
           "paged_attn_decode", "paged_attn_ref"]
