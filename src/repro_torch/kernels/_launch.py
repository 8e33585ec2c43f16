"""What the kernel wrappers share around a CUDA launch: operand checks and
the typed call into a kernel's C entry."""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build

#: dtype codes of the C entries
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_entries: Dict[str, Callable[..., int]] = {}
_scratch: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
_holders: List[dict] = []


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (cached)."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def scratch(name: str, device: torch.device, floats: int,
            counters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A kernel's cross-block workspace on ``device``: at least ``floats``
    f32 values and ``counters`` int32 counters. Kept per (kernel, device)
    and grown, never shrunk; the counters are zeroed once when allocated
    and every kernel that uses them leaves them at 0 when it exits, so a
    call costs no memset. Calls on one stream run in order, so one
    workspace serves them all.

    Growing replaces the entry, which frees the old buffers unless
    something else holds them: a CUDA graph that recorded their addresses
    holds them through :func:`hold_workspaces`. Nothing may be allocated
    here while a stream is being captured (the graph would own it and its
    zeroing would never run): warm up on the same shapes first."""
    key = (name, device.index)
    ws, cnt = _scratch.get(key, (None, None))
    grow_ws = ws is None or ws.numel() < floats
    grow_cnt = cnt is None or cnt.numel() < counters
    if (grow_ws or grow_cnt) and device.type == "cuda" \
            and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{name}: workspace requested during CUDA graph "
                           f"capture; run the captured work once first")
    if grow_ws:
        ws = torch.empty(max(floats, 1 << 16), dtype=torch.float32,
                         device=device)
    if grow_cnt:
        cnt = torch.zeros(max(counters, 1024), dtype=torch.int32,
                          device=device)
    _scratch[key] = (ws, cnt)
    for held in _holders:
        held[(ws.data_ptr(), cnt.data_ptr())] = (ws, cnt)
    return ws, cnt


@contextlib.contextmanager
def hold_workspaces() -> Iterator[dict]:
    """Collect every workspace :func:`scratch` hands out inside the block,
    keyed by address: whoever keeps the dict keeps the buffers alive (a
    captured graph, whose recorded pointers must outlive a later, larger
    request that replaces them)."""
    held: dict = {}
    _holders.append(held)
    try:
        yield held
    finally:
        _holders.remove(held)


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


def entry(name: str, argtypes: Sequence,
          source: Optional[str] = None) -> Callable[..., int]:
    """The C entry ``<name>_launch`` of ``csrc/<source>.cu`` (``source``
    defaults to ``name``; built and loaded on first use), typed with
    ``argtypes`` and the stream after them."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(build.library(source or name), f"{name}_launch")
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def current_stream(index: int) -> int:
    """PyTorch's current stream on CUDA device ``index``, as a raw handle."""
    return torch._C._cuda_getCurrentRawStream(index)


def check_rc(name: str, rc: int, source: Optional[str] = None) -> None:
    """Raise if a C entry returned a CUDA error."""
    if rc != 0:
        msg = build.library(source or name).error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}: {msg}")


def launch(name: str, argtypes: Sequence, *args,
           source: Optional[str] = None) -> None:
    """Call the C entry ``<name>_launch`` of ``csrc/<source>.cu`` with
    ``args`` and PyTorch's current stream appended. The C entry returns
    the ``cudaError_t`` of its launch; raise if it is not 0."""
    fn = entry(name, argtypes, source)
    check_rc(name, fn(*args, current_stream(torch.cuda.current_device())),
             source)
