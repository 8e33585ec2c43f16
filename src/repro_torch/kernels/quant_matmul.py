"""``quant_matmul``: fp activations times int8 weights, per-column scale.

Replaces the TPU kernel ``repro/kernels/quant_matmul.py``
(``quant_matmul`` / ``_quant_matmul_kernel``) with the hand-written CUDA
kernel ``quant_matmul_launch`` of ``csrc/xfer_matmul.cu``, the same tile
loop as ``xfer_matmul`` templated on an int8 weight: ``x [R, N]`` (fp32
or bf16) ``@ w_q [N, M]`` (int8) with an fp32 accumulator; ``scale [1,
M]`` (f32) multiplies each output column once at flush; the result is
cast to ``x.dtype``.

Bound on the H100: on the INT8 serving path it reads every projection's
int8 weights once per decode step at R = slots, far below the card's
operations-per-byte ridge, so it is bound by the bytes of ``w_q`` — half
of what ``xfer_matmul`` reads in bf16. The kernel reads each weight byte
once per block of rows, widened to fp32 in shared memory, coalesced
along whichever axis of ``w_q`` is contiguous: the tied unembedding
passes the strided view ``embed.q.T`` with no transposed copy. It runs
the CUDA-core tile kernel that ``xfer_matmul`` keeps for fp32 and
misaligned shapes: 16 column blocks for a 1024-wide decode output, too
few for 132 SMs. Moving it onto ``xfer_matmul``'s split-K decode design
is queued work.

The block is 16 rows high when R <= 16 (decode), else 64. Ragged edges
are masked in the kernel.

A CPU tensor takes the plain version (:func:`plain`); a CUDA tensor
launches the kernel or raises. ``quant_matmul.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._launch import (DTYPE_CODES, check_device,
                                         check_dtype, check_float, launch)
from repro_torch.kernels.ref import quant_matmul_ref as plain

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = (_VP, _VP, _VP, _VP, _I, _I, _I, _LL, _LL, _I, _I)


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """x [R, N] fp @ w_q [N, M] int8, times scale [1, M] f32 -> [R, M] in
    ``x.dtype``. ``w_q`` may be any strided view (e.g. ``q.T``)."""
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"quant_matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(w_q.shape)} do not chain")
    m = w_q.shape[1]
    if scale.numel() != m:
        raise ValueError(f"quant_matmul: scale {tuple(scale.shape)} for "
                         f"{m} columns")
    check_dtype("quant_matmul", torch.int8, w_q)
    check_dtype("quant_matmul", torch.float32, scale)
    if all(t.device.type == "cpu" for t in (x, w_q, scale)):
        return plain(x, w_q, scale)
    check_device("quant_matmul", x, w_q, scale)
    check_float("quant_matmul", x)
    x, scale = x.contiguous(), scale.contiguous()
    r, n = x.shape
    out = torch.empty((r, m), dtype=x.dtype, device=x.device)
    if r == 0 or m == 0:
        return out
    launch("quant_matmul", _ARGTYPES, x.data_ptr(), w_q.data_ptr(),
           scale.data_ptr(), out.data_ptr(), r, n, m, w_q.stride(0),
           w_q.stride(1), DTYPE_CODES[x.dtype], 16 if r <= 16 else 64,
           source="xfer_matmul")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
