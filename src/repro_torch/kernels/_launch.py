"""What the kernel wrappers share around a CUDA launch: operand checks and
the typed call into a kernel's C entry."""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Sequence

import torch

from repro_torch.kernels import build

#: dtype codes of the C entries
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_entries: Dict[str, Callable[..., int]] = {}


def check_device(name: str, *tensors: torch.Tensor) -> None:
    """All operands on the current CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors on {dev} but the current device "
                         f"is cuda:{torch.cuda.current_device()}")
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")


def check_float(name: str, t: torch.Tensor) -> None:
    """``t`` has a float dtype the kernels take."""
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported "
                        f"(float32 or bfloat16)")


def check_dtype(name: str, dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """All operands on the current CUDA device, one supported float dtype."""
    check_device(name, *tensors)
    check_float(name, tensors[0])
    check_dtype(name, tensors[0].dtype, *tensors[1:])


def launch(name: str, argtypes: Sequence, *args,
           source: Optional[str] = None) -> None:
    """Call the C entry ``<name>_launch`` of ``csrc/<source>.cu``
    (``source`` defaults to ``name``; built and loaded on first use) with
    ``args`` and PyTorch's current stream appended. The C entry returns
    the ``cudaError_t`` of its launch; raise if it is not 0."""
    source = source or name
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(build.library(source), f"{name}_launch")
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = build.library(source).error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}: {msg}")
