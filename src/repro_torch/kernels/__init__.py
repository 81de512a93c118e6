"""repro_torch.kernels — the CSB-MVM kernel for Hopper and its wrappers.

``csrc/csb_mvm.cu`` is the CUDA kernel (built on first use by
``_build``), ``csb_mvm`` its launch wrapper, ``ref`` its plain PyTorch
version and ``ops`` the padded public entry point ``csb_matvec``.
"""
from .ops import csb_matvec, pad_to_grid
from .ref import csb_mvm_ref, densify

__all__ = ["csb_matvec", "csb_mvm_ref", "densify", "pad_to_grid"]
