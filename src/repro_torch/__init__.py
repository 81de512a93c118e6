"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The package mirrors ``repro``'s module names. It imports torch, numpy
and the standard library, never JAX and nothing of ``repro``. Slice 1
holds the paper's serving path: CSB pruning (``core``), the CSB-MVM
kernel in CUDA (``kernels``), the RNN cells (``cells``) and
frame-by-frame serving (``serve.rnn_serve_frames``). Slice 2 adds decoder
LM serving with paged continuous batching (``configs``, ``models``,
``serve.serve_continuous``) through the paged-attention kernel in CUDA.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
