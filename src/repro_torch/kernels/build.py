"""Build the CUDA kernels with ``nvcc`` at first use and load them by ctypes.

Each ``csrc/<name>.cu`` (one library each; ``flash_attention_train.cu``
compiles ``flash_attention.cu`` again with the training forward's hooks
on) has a plain C interface (no PyTorch headers), so
one ``nvcc`` call per source takes seconds. All missing libraries are
compiled together, one ``nvcc`` process per source started at once,
into ``build/repro_torch_kernels/`` at the repository root (listed in
``.gitignore``). A library's file name carries a hash of its source and
the flags, so an edited source is rebuilt and a stale one never loads.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NAMES = ("xfer_matmul", "flash_attention", "paged_attention", "rglru_scan",
         "mlstm_chunkwise", "flash_attention_bwd", "flash_attention_train")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc/ptxas output of the builds this process ran (register and shared
#: memory use per kernel), keyed by kernel name
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _source_bytes(name: str) -> bytes:
    """A source and the csrc files it includes by name (flash_attention_train.cu
    is flash_attention.cu compiled again), so that editing either rebuilds."""
    src = (CSRC / f"{name}.cu").read_bytes()
    for inc in re.findall(rb'#include "([^"]+)"', src):
        src += (CSRC / inc.decode()).read_bytes()
    return src


def lib_path(name: str) -> Path:
    src = _source_bytes(name)
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build_all() -> Dict[str, float]:
    """Compile every kernel whose library is missing, all in parallel.
    Returns the wall seconds of this call per built kernel (empty when
    everything was already built)."""
    todo = [n for n in NAMES if not lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    failed = []
    seconds = {}
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        if not lib_path(name).exists():
            build_all()
        lib = ctypes.CDLL(str(lib_path(name)))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib

