"""Symmetric device buffers: the memory kernel B3 exchanges its rows in.

With its block-rows spread over R > 1 ranks, kernel B3
(``kernels/csrc/csb_sharded.cu``) stores each rank's output rows straight
into every rank's memory. Every rank of the axis's process group holds
one buffer per (output width, batch bound): ``N_SLOTS`` output slots of
(batch bound, out_dim) fp32 and the int32 words ``written[S][R]`` and
``consumed[R]`` that order the calls on the device (the protocol is in the
source). The buffer is made once, zeroed, and its CUDA IPC handle is
exchanged over the group (``dist.all_gather_object``); each rank opens its
peers' buffers and keeps them for the life of the process. A peer on
another card is reached over NVLink; ranks that share one card map the
same device memory.

The route: the buffer comes from ``cudaMalloc`` inside the kernel's own
library, its handle from ``cudaIpcGetMemHandle``, and peers open it with
``cudaIpcOpenMemHandle(..., cudaIpcMemLazyEnablePeerAccess)``. PyTorch's
own sharing of CUDA tensors (``torch.multiprocessing.reductions``) was not
taken: a tensor from its caching allocator lies at an offset inside a
larger ``cudaMalloc`` block that the allocator may share with other
tensors and reuse once the tensor is freed, so the sharing side has to
keep reference counts alive across processes; a region the library
allocates whole is the buffer's own and never moves.

The calls are SPMD: every rank of the group calls B3 with the same
matrix and batch size in the same order, so the buffers are made in the
same order on every rank and their tickets (one per call) advance in
lock-step. Every rank must have synchronised its device before any rank
of the group exits (``dist.launch.spawn_ranks`` does): a peer's kernel may
still be storing into its memory.
"""
from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from repro_torch.kernels._build import load_library

N_SLOTS = 2                # output slots a buffer cycles through
MAX_RANKS = 8              # destinations a launch stores into (the kernel's)
BATCH_STEP = 8             # a buffer's batch bound: the batch rounded up to it
_ALIGN = 256

_BUFFERS: dict = {}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = load_library("csb_sharded")
        lib.symm_alloc.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_void_p),
                                   ctypes.c_char_p]
        lib.symm_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_void_p)]
        lib.symm_handle_bytes.argtypes = []
        lib.csb_sharded_error_string.argtypes = [ctypes.c_int]
        lib.csb_sharded_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(err: int, what: str) -> None:
    if err:
        msg = _library().csb_sharded_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} (error {err})")


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def exchange_route(n_ranks: int) -> str:
    """How B3's ranks exchange rows on the card."""
    return ("none (one rank)" if n_ranks == 1
            else "peer stores through CUDA IPC")


class SymmetricBuffer:
    """This rank's view of one buffer that every rank of ``group`` holds:
    ``bases[k]`` is rank k's buffer as mapped in this process (a ctypes
    array of pointers), laid out as ``flag_bytes`` of int32 words, then
    ``n_slots`` (``N_SLOTS``) slots of ``slot_bytes``. ``next_ticket``
    numbers this buffer's calls 1, 2, ..."""

    def __init__(self, group, device: torch.device, slot_floats: int):
        self.group = group          # held: the cache keys on its id
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        if self.size > MAX_RANKS:
            raise ValueError(f"B3 stores into at most {MAX_RANKS} ranks, the "
                             f"group has {self.size}")
        self.n_slots = n_slots = N_SLOTS
        self.flag_bytes = _round_up(4 * (n_slots + 1) * self.size, _ALIGN)
        self.slot_bytes = _round_up(4 * slot_floats, _ALIGN)
        lib = _library()
        own = ctypes.c_void_p()
        handle = ctypes.create_string_buffer(lib.symm_handle_bytes())
        _check(lib.symm_alloc(self.flag_bytes + n_slots * self.slot_bytes,
                              device.index, ctypes.byref(own), handle),
               "allocating a symmetric buffer")
        handles = [None] * self.size
        dist.all_gather_object(handles, handle.raw, group=group)
        bases = []
        for k, h in enumerate(handles):
            if k == self.rank:
                bases.append(own.value)
                continue
            peer = ctypes.c_void_p()
            _check(lib.symm_open(h, device.index, ctypes.byref(peer)),
                   f"opening rank {k}'s buffer (cudaIpcOpenMemHandle)")
            bases.append(peer.value)
        self.bases = (ctypes.c_void_p * self.size)(*bases)
        self.ticket = 0

    def next_ticket(self) -> int:
        self.ticket += 1
        return self.ticket


def symmetric_buffer(group, device: torch.device, out_dim: int,
                     batch: int) -> SymmetricBuffer:
    """The buffer for B3 calls of ``out_dim`` outputs and ``batch`` rows
    over ``group``, made (collectively: every rank of the group must ask
    for it at the same call) the first time it is asked for."""
    rows = _round_up(max(batch, 1), BATCH_STEP)
    key = (id(group), device, out_dim, rows)
    buf = _BUFFERS.get(key)
    if buf is None:
        buf = _BUFFERS[key] = SymmetricBuffer(group, device, rows * out_dim)
    return buf


__all__ = ["N_SLOTS", "SymmetricBuffer", "exchange_route",
           "symmetric_buffer"]
