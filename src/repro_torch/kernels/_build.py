"""Build the port's CUDA sources with nvcc and load them with ctypes.

Every ``csrc/*.cu`` exposes a plain C interface and is compiled on first
use into a shared library under ``build/`` at the repository root (or
the directory ``REPRO_TORCH_BUILD`` names), for ``sm_90a``. A library's
file name carries a hash of its source, of every header beside it
(``csrc/*.cuh``, which the sources include) and of the flags, so an
edited source or header is rebuilt and a stale library is never loaded.
Kernels are built only from the sources in this package. Nothing here
runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOADED: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD")
    return Path(env) if env else Path(__file__).resolve().parents[3] / "build"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME
        cand = Path(CUDA_HOME or "", "bin", "nvcc")
        if not (CUDA_HOME and cand.exists()):
            raise RuntimeError("nvcc not found: put the CUDA toolkit's bin "
                               "directory on PATH or set CUDA_HOME")
        nvcc = str(cand)
    return nvcc


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, str]:
    """Compile every source whose library is missing, one nvcc process per
    source, all started together. Returns ``{stem: nvcc output}`` for the
    sources compiled now (``-Xptxas=-v`` lists registers and shared
    memory); raises with nvcc's output if any compile fails."""
    jobs = {}
    nvcc = None
    for src in sorted(CSRC.glob("*.cu")):
        out = _target(src)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[src.stem] = (proc, tmp, out)
    logs, failed = {}, []
    for stem, (proc, tmp, out) in jobs.items():
        logs[stem] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(stem)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(
            f"{s}.cu:\n{logs[s]}" for s in failed))
    return logs


def load_library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, building it if needed."""
    with _LOCK:
        lib = _LOADED.get(stem)
        if lib is None:
            path = _target(CSRC / f"{stem}.cu")
            if not path.exists():
                build_all()
            lib = _LOADED[stem] = ctypes.CDLL(str(path))
    return lib
