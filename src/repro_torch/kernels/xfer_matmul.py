"""``xfer_matmul``: the paper's <Tr, Tm, Tn>-tiled matmul core on Hopper.

Replaces the TPU kernel ``repro/kernels/xfer_matmul.py`` (``xfer_matmul``
/ ``_matmul_kernel``) with the hand-written CUDA kernel
``csrc/xfer_matmul.cu``: ``x [R, N] @ w [N, M]`` with an fp32
accumulator, cast to ``x.dtype`` once per output tile.

Bound on the H100: on the serving path it reads every projection weight
once per decode step at R = slots, far below the card's
operations-per-byte ridge, so it is bound by the bytes of ``w``. The
kernel reads each weight element once per block of rows, coalesced along
whichever axis of ``w`` is contiguous, so the tied unembedding runs on
``embed.T`` (strides ``(1, d_model)``) without a transposed copy.

``tr``/``tm``/``tn`` keep the planner's tiling signature. On Hopper the
block tile is bounded by the register file: ``tr`` picks the block's
rows (16 when ``min(tr, R) <= 16``, as for decode, else 64); the block
is 64 columns wide and 32 deep whatever ``tm``/``tn`` ask. Ragged edges
are masked in the kernel, so no dim has to divide a tile.

A CPU tensor takes the plain version (:func:`plain`); a CUDA tensor
launches the kernel or raises. ``xfer_matmul.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._launch import DTYPE_CODES, check_cuda, launch
from repro_torch.kernels.ref import matmul_ref as plain

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = (_VP, _VP, _VP, _I, _I, _I, _LL, _LL, _I, _I)


def xfer_matmul(x: torch.Tensor, w: torch.Tensor, *, tr: int = 256,
                tm: int = 256, tn: int = 256) -> torch.Tensor:
    """x [R, N] @ w [N, M] -> [R, M] in ``x.dtype`` (fp32 accumulation).
    ``w`` may be any strided view (e.g. ``embed.T``)."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"xfer_matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not chain")
    if min(tr, tm, tn) <= 0:
        raise ValueError(f"xfer_matmul: tiles must be positive, got "
                         f"{(tr, tm, tn)}")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return plain(x, w)
    check_cuda("xfer_matmul", x, w)
    x = x.contiguous()
    r, n = x.shape
    m = w.shape[1]
    out = torch.empty((r, m), dtype=x.dtype, device=x.device)
    if r == 0 or m == 0:
        return out
    bm = 16 if min(tr, r) <= 16 else 64
    launch("xfer_matmul", _ARGTYPES, x.data_ptr(), w.data_ptr(),
           out.data_ptr(), r, n, m, w.stride(0), w.stride(1),
           DTYPE_CODES[x.dtype], bm)
    xfer_matmul.launches += 1
    return out


xfer_matmul.launches = 0
