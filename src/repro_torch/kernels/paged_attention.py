"""``paged_attention``: single-token decode attention through a page table.

Replaces the TPU kernel ``repro/kernels/paged_attention.py``
(``paged_attention`` / ``_paged_kernel``, fp body ``_paged_body``) with
the hand-written CUDA kernel ``csrc/paged_attention.cu``. q ``[B, H,
D]``, page pools kp/vp ``[P, ps, G, D]``, ``page_table [B, M]`` int32,
``lengths [B]`` int32; head h reads group ``h // (H/G)``; positions at
or past ``lengths[b]`` are masked; online softmax across the row.

Bound on the H100: the bytes of the valid K/V rows (4·D flops per
4·D bytes in bf16). One block per (row, head) reads its own table row
and length and stops at the length — the TPU grid walked all M pages.
Head dims that divide 128 run 128-thread blocks; D = 256
(recurrentgemma-2b) runs 256-thread blocks; the C entry refuses any
other head dim, and :func:`launch` raises its error.

The dense serving slot grid ``[slots, max_len, G, D]`` is read as a pool
of ``P = slots`` pages of ``ps = max_len`` with an identity table
(``models.blocks``). Lengths must lie in ``[1, M·ps]``: the kernel
traps on the card if not, the wrapper checks it on the CPU — for the dense
grid that is the engine's ``positions < max_len``.

INT8 pools (``QuantConfig(kv="int8")``) pass their per-token f32 scale
pools ``k_scale``/``v_scale`` ``[P, ps, G, 1]``; they go to the int8
body of the same source (:func:`paged_attention_q8`, which replaces
``_paged_kernel_q8``), which dequantises each element in registers in
f32 before its dot, so the fp extent never exists in device memory. Its
bound is the valid int8 rows and their scales, about half the bf16
bytes.

A CPU tensor takes the plain version (:func:`plain`); a CUDA tensor
launches the kernel or raises. ``paged_attention.launches`` counts the
fp body's launches, ``paged_attention_q8.launches`` the int8 body's.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels._launch import (DTYPE_CODES, check_cuda,
                                         check_device, check_dtype,
                                         check_float, launch)
from repro_torch.kernels.ref import paged_attention_ref as plain


_VP, _I = ctypes.c_void_p, ctypes.c_int
_GEOMETRY = (_I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I)
_ARGTYPES = (_VP,) * 6 + _GEOMETRY
_ARGTYPES_Q8 = (_VP,) * 8 + _GEOMETRY


def paged_attention(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                    page_table: torch.Tensor, lengths: torch.Tensor, *,
                    k_scale: torch.Tensor = None,
                    v_scale: torch.Tensor = None) -> torch.Tensor:
    """q [B, H, D]; kp, vp [P, ps, G, D]; page_table [B, M] int32;
    lengths [B] int32; optional ``k_scale``/``v_scale`` [P, ps, G, 1]
    f32 for int8 pools. Returns [B, H, D] in ``q.dtype``."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_attention: pass both k_scale and v_scale, "
                         "or neither")
    if q.dim() != 3 or kp.dim() != 4 or kp.shape != vp.shape:
        raise ValueError(f"paged_attention: bad shapes q {tuple(q.shape)} "
                         f"kp {tuple(kp.shape)} vp {tuple(vp.shape)}")
    b, h, d = q.shape
    n_pages, ps, g, d2 = kp.shape
    if d2 != d or h % g != 0:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} does not "
                         f"match pool {tuple(kp.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or tuple(lengths.shape) != (b,):
        raise ValueError(f"paged_attention: table {tuple(page_table.shape)} "
                         f"/ lengths {tuple(lengths.shape)} for batch {b}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attention: page_table and lengths must be int32")
    scales = () if k_scale is None else (k_scale, v_scale)
    if scales:
        want = (n_pages, ps, g, 1)
        if tuple(k_scale.shape) != want or tuple(v_scale.shape) != want:
            raise ValueError(f"paged_attention: scale pools "
                             f"{tuple(k_scale.shape)} / {tuple(v_scale.shape)}"
                             f" for pools {tuple(kp.shape)}")
        check_dtype("paged_attention", torch.int8, kp, vp)
        check_dtype("paged_attention", torch.float32, *scales)
    m = page_table.shape[1]
    if all(t.device.type == "cpu"
           for t in (q, kp, vp, page_table, lengths, *scales)):
        if b and (int(lengths.min()) < 1 or int(lengths.max()) > m * ps):
            raise ValueError(f"paged_attention: lengths must lie in "
                             f"[1, {m * ps}], got {lengths.tolist()}")
        return plain(q, kp, vp, page_table, lengths, *scales)
    if scales:
        return paged_attention_q8(q, kp, vp, *scales, page_table, lengths)
    check_cuda("paged_attention", q, kp, vp)
    if page_table.device != q.device or lengths.device != q.device:
        raise ValueError("paged_attention: page_table / lengths on another "
                         "device than q")
    q, kp, vp = q.contiguous(), kp.contiguous(), vp.contiguous()
    page_table, lengths = page_table.contiguous(), lengths.contiguous()
    out = torch.empty_like(q)
    if b == 0:
        return out
    launch("paged_attention", _ARGTYPES, q.data_ptr(), kp.data_ptr(),
           vp.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
           out.data_ptr(), b, h, g, d, ps, m, n_pages, 1.0 / math.sqrt(d),
           DTYPE_CODES[q.dtype])
    paged_attention.launches += 1
    return out


def paged_attention_q8(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                       k_scale: torch.Tensor, v_scale: torch.Tensor,
                       page_table: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """The int8 body on CUDA tensors, shapes checked by
    :func:`paged_attention` (its entry point): int8 kp/vp, f32 scale
    pools, q fp32 or bf16."""
    check_device("paged_attention_q8", q, kp, vp, k_scale, v_scale,
                 page_table, lengths)
    check_float("paged_attention_q8", q)
    b, h, d = q.shape
    n_pages, ps, g, _ = kp.shape
    m = page_table.shape[1]
    q, kp, vp, k_scale, v_scale, page_table, lengths = (
        t.contiguous() for t in (q, kp, vp, k_scale, v_scale, page_table,
                                 lengths))
    out = torch.empty_like(q)
    if b == 0:
        return out
    launch("paged_attention_q8", _ARGTYPES_Q8, q.data_ptr(), kp.data_ptr(),
           vp.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
           page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, h,
           g, d, ps, m, n_pages, 1.0 / math.sqrt(d), DTYPE_CODES[q.dtype],
           source="paged_attention")
    paged_attention_q8.launches += 1
    return out


paged_attention.launches = 0
paged_attention_q8.launches = 0
