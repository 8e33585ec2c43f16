"""``rglru_scan``: the RG-LRU linear recurrence ``h_t = a_t·h_{t-1} + b_t``.

Replaces the TPU kernel ``repro/kernels/rglru_scan.py`` (``rglru_scan``
/ ``_rglru_kernel``) with the hand-written CUDA kernel
``csrc/rglru_scan.cu``: a, b ``[B, S, W]`` (fp32 or bf16) from h0
``[B, W]`` (f32), an f32 carry, the h sequence ``[B, S, W]`` in
``a.dtype``. Each step is a rounded multiply then a rounded add, as the
plain version computes it, so the two agree bit for bit, and an identity
step ``(1, 0)`` leaves h exactly unchanged.

Bound on the H100: its bytes are ``3·B·S·W`` elements (a and b read
once, h written once), but at the serving path's prefill shapes
(``[n <= 8, 2048-2560, 2560]``) one thread per (b, w) channel walking
S dependent steps gives at most 20,480 threads, so it is bound by load
latency, not bytes. Unlike the TPU kernel it has no ``S % bs == 0``
requirement. A chunked scan over S is later work.

A CPU tensor takes the plain version (:func:`plain`); a CUDA tensor
launches the kernel or raises. ``rglru_scan.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._launch import (DTYPE_CODES, check_cuda,
                                         check_device, check_dtype, launch)
from repro_torch.kernels.ref import rglru_scan_ref as plain

_VP, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_VP, _VP, _VP, _VP, _I, _I, _I, _I)


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor) -> torch.Tensor:
    """a, b [B, S, W]; h0 [B, W] f32 -> h [B, S, W] in ``a.dtype``."""
    if a.dim() != 3 or a.shape != b.shape \
            or tuple(h0.shape) != (a.shape[0], a.shape[2]):
        raise ValueError(f"rglru_scan: bad shapes a {tuple(a.shape)} "
                         f"b {tuple(b.shape)} h0 {tuple(h0.shape)}")
    check_dtype("rglru_scan", torch.float32, h0)
    if all(t.device.type == "cpu" for t in (a, b, h0)):
        return plain(a, b, h0)
    check_cuda("rglru_scan", a, b)
    check_device("rglru_scan", a, h0)
    bsz, s, w = a.shape
    a, b, h0 = a.contiguous(), b.contiguous(), h0.contiguous()
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    launch("rglru_scan", _ARGTYPES, a.data_ptr(), b.data_ptr(),
           h0.data_ptr(), out.data_ptr(), bsz, s, w, DTYPE_CODES[a.dtype])
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0
