"""Build the CUDA kernels from ``csrc/`` at first use and load them.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``. Libraries go to
``kernels/build/`` (listed in ``.gitignore``), named by a hash of the
source and the flags, so a changed source is rebuilt and an unchanged one
is loaded as it is. Sources not yet built are compiled together, one
``nvcc`` process each. No ``--use_fast_math``: the Q->DQ and pack
kernels must divide and round exactly as IEEE float32 does, and the seed
kernel's logf / cosf must be the accurate ones.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"
SOURCES = ("sumsq.cu", "quantize.cu", "agg_tail.cu", "dp_clip.cu",
           "swa_attention.cu", "seed_reconstruct.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return nvcc


def library_path(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing; returns the
    compiler's output (register and shared-memory use, from ``-Xptxas
    -v``) by source, empty for the sources already built. Raises if any
    compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for source in SOURCES:
        out = library_path(source)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        jobs[source] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, out)
    logs, failed = {}, []
    for source, (proc, tmp, out) in jobs.items():
        logs[source] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)   # atomic: a reader never sees half a file
        else:
            failed.append(f"{source} (exit {proc.returncode}):\n"
                          f"{logs[source]}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(source: str, signatures) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed, with
    ``signatures`` ({function name: argtypes}) declared; every function
    returns the CUDA error code of its launches as an int."""
    if source not in _LIBS:
        if not library_path(source).exists():
            build_all()
        lib = ctypes.CDLL(str(library_path(source)))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[source] = lib
    return _LIBS[source]


# --- launch helpers shared by the wrappers ---------------------------------


def check_cuda(name: str, t, dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype/rank."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.get_device() != torch.cuda.current_device():
        # the C functions launch on the current device
        raise ValueError(f"{name}: tensor on {t.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim}-d, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_ptr(t) -> int:
    """The raw handle of the current stream on ``t``'s device, without
    making a ``torch.cuda.Stream`` (a tenth of its host time)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def raise_on_error(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
