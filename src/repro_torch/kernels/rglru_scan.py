"""``rglru_scan``: the RG-LRU linear recurrence ``h_t = a_t·h_{t-1} + b_t``.

Replaces the TPU kernel ``repro/kernels/rglru_scan.py`` (``rglru_scan``
/ ``_rglru_kernel``) with the hand-written CUDA kernels of
``csrc/rglru_scan.cu``: a, b ``[B, S, W]`` (fp32 or bf16) from h0
``[B, W]`` (f32), an f32 carry, the h sequence ``[B, S, W]`` in
``a.dtype``. Each step is a rounded multiply then a rounded add, as the
plain version computes it, so the two agree bit for bit, and an identity
step ``(1, 0)`` leaves h exactly unchanged.

Bound on the H100: its bytes, ``3·B·S·W`` elements (a and b read once, h
written once); the walk of S dependent steps a channel is far shorter
than their transfer at ``n >= 2``. :func:`plan` picks the route:
``ring`` (``rglru_ring_kernel``: one warp a block walks ``cw`` channels
of one batch row while a and b stream through an 8-stage ``cp.async``
ring in shared memory, seven stages in flight) when a row of a and b
lies on 16 bytes, with ``cw`` the widest of 32, 16, 8 that gives two
blocks per SM (32 at ``[n >= 4, S, 2560]``, 16 at n = 2 and 3, 8 at n =
1: a block's time is its one warp's walk and copy issue, so at small n
more, narrower blocks go faster); ``rows`` (one thread per channel
loading from device memory) otherwise. Unlike the TPU kernel it has no
``S % bs == 0`` requirement.

A CPU tensor takes the plain version (:func:`plain`); a CUDA tensor
launches the kernel or raises. ``rglru_scan.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels._launch import (DTYPE_CODES, check_cuda,
                                         check_device, check_dtype, launch,
                                         sm_count)
from repro_torch.kernels.ref import rglru_scan_ref as plain

_VP, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I)
#: channels a block of the ring route, widest first
RING_WIDTHS = (32, 16, 8)
#: channels a block of the rows route
ROWS_THREADS = 128


class Plan(NamedTuple):
    kernel: str              # "ring" or "rows"
    cw: int                  # channels a block
    grid: Tuple[int, int]    # (channel tiles, batch rows)


#: blocks an SM the ring route's plan asks for: a block's one warp is
#: bound by its own walk and copy issue, so more blocks, down to 8
#: channels, go faster until there are two an SM
BLOCKS_PER_SM = 2


def plan(b: int, w: int, elem_size: int, aligned: bool, sms: int) -> Plan:
    """The launch of ``rglru_scan`` over ``[b, S, w]`` of ``elem_size``
    bytes: the ring route where ``w`` elements and the bases of a and b
    (``aligned``) lie on 16 bytes, with the widest channel tile that
    gives ``BLOCKS_PER_SM * sms`` blocks or more (else the narrowest);
    the rows route otherwise. S does not enter: every block walks all of
    it."""
    if aligned and (w * elem_size) % 16 == 0:
        cw = next((c for c in RING_WIDTHS
                   if b * -(-w // c) >= BLOCKS_PER_SM * sms),
                  RING_WIDTHS[-1])
        return Plan("ring", cw, (-(-w // cw), b))
    return Plan("rows", ROWS_THREADS, (-(-w // ROWS_THREADS), b))


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
    p = plan(bsz, w, a.element_size(),
             a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0,
             sm_count(a.device))
    launch("rglru_scan", _ARGTYPES, a.data_ptr(), b.data_ptr(),
           h0.data_ptr(), out.data_ptr(), bsz, s, w, DTYPE_CODES[a.dtype],
           p.cw if p.kernel == "ring" else 0)
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0
