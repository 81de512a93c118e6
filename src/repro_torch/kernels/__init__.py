"""repro_torch.kernels — the port's CUDA kernels and their wrappers.

``csrc/csb_mvm.cu`` (the CSB-MVM) and ``csrc/paged_attn.cu`` (paged
decode attention) are built on first use by ``_build``; ``csb_mvm`` and
``paged_attn`` are their launch wrappers, ``ref`` their plain PyTorch
versions and ``ops`` the public entry points ``csb_matvec`` and
``paged_attn_decode``.
"""
from .ops import csb_matvec, pad_to_grid, paged_attn_decode
from .ref import csb_mvm_ref, densify, paged_attn_ref

__all__ = ["csb_matvec", "csb_mvm_ref", "densify", "pad_to_grid",
           "paged_attn_decode", "paged_attn_ref"]
