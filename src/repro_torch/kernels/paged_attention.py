"""``paged_attention``: decode attention through a page table.

Replaces the TPU kernel ``repro/kernels/paged_attention.py``
(``paged_attention`` / ``_paged_kernel``, fp body ``_paged_body``) with
the hand-written CUDA kernel ``csrc/paged_attention.cu``. q ``[B, H,
D]``, page pools kp/vp ``[P, ps, G, D]``, ``page_table [B, M]`` int32,
``lengths [B]`` int32; head h reads group ``h // (H/G)``; positions at
or past ``lengths[b]`` are masked; online softmax across the row.

The multi-query form takes q ``[B, S, H, D]``: S fresh positions per row
(the speculative verify of k + 1 positions), ``lengths [B]`` the first
query's, and query j sees the positions below ``min(lengths[b] + j,
M·ps)``, the reference's causal mask over the fresh positions. It is the
same kernel: a block carries the S·H/G query rows of its group, so each
K/V tile is staged once for all S queries (S launches of the one-query
form would read every row S times), each query row with its own limit,
softmax state and chunk merge. S = 1 with a 3-D q is the one-token form
and its arithmetic unchanged. The int8 body has the same multi-query
form (:func:`paged_attention_q8_multi`: the verify over an INT8 target's
grid or pool).

Bound on the H100: the bytes of the valid K/V rows (4·D flops per
4·D bytes in bf16, per query head of a group). The fp body runs one block
per (row, kv group, chunk of :data:`CHUNK` positions): every query head
of the group is computed from each K/V tile loaded (the TPU body's
grouping), tiles are staged through the page table with 16-byte
``cp.async`` loads, and a row's chunks are merged in chunk order inside
the same launch by the chunk that arrives last, through a per-device
workspace (:func:`chunk_plan` gives the grid; the plain mirror of that
split is ``ref.paged_attention_split_ref``). Chunks past a row's length
exit at once; the wrapper never reads ``lengths`` or the table on the
card. Head dims that divide 128, and D = 256 (recurrentgemma-2b), are
taken; the C entry refuses any other head dim, and :func:`launch` raises
its error.

The dense serving slot grid ``[slots, max_len, G, D]`` is read as a pool
of ``P = slots`` pages of ``ps = max_len`` with an identity table
(``models.blocks``); so is the encoder output of the encoder-decoder's
cross-attention, ``[slots, max_src_len, G, D]`` with ``lengths = enc_len``.
Lengths must lie in ``[0, M·ps]``: the kernel traps on the card if not,
the wrapper checks it on the CPU — for the dense grid that is the
engine's ``positions < max_len``. A row of length 0 (an inert slot's
cross-attention, ``enc_len = 0``) has no visible position: its output
is 0, on the card and in the plain version, where the reference's
masked softmax averages V; nothing is read for it.

INT8 pools (``QuantConfig(kv="int8")``) pass their per-token f32 scale
pools ``k_scale``/``v_scale`` ``[P, ps, G, 1]``; they go to the int8
body of the same source (:func:`paged_attention_q8`, which replaces
``_paged_kernel_q8``): the fp body's kernel with an int8 stage, the same
grid, chunks and merge (through a workspace of its own), the int8 rows
and their scales staged with ``cp.async`` through the same table lookup
and each element dequantised in f32 where it is read from shared memory,
so the fp extent never exists in device memory. Its plain mirror is
``ref.paged_attention_split_ref`` with the scale pools. Its bound is the
valid int8 rows and their scales, about half the bf16 bytes.

A CPU tensor takes the plain version (:func:`plain`); a CUDA tensor
launches the kernel or raises. ``paged_attention.launches`` counts the
fp body's launches (both forms), ``paged_attention_q8.launches`` the int8
body's one-query ones and ``paged_attention_q8_multi.launches`` its
multi-query ones.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels._launch import (DTYPE_CODES, check_cuda,
                                         check_device, check_dtype,
                                         check_float, launch, scratch)
from repro_torch.kernels.ref import paged_attention_ref as plain


_VP, _I = ctypes.c_void_p, ctypes.c_int
_GEOMETRY = (_I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I)
_ARGTYPES = (_VP,) * 8 + (_I,) + _GEOMETRY[:7] + (_I,) + _GEOMETRY[7:]
_ARGTYPES_Q8 = (_VP,) * 10 + (_I,) + _GEOMETRY[:7] + (_I,) + _GEOMETRY[7:]

#: positions per block of both bodies (their flash-decoding split): two
#: 64-token pages. recurrentgemma-2b's ring of 2048 on 8 slots then runs
#: on 128 blocks, about one per SM; at 256 positions it filled 64.
CHUNK = 128


def chunk_plan(table_cols: int, page_size: int) -> tuple:
    """(chunks per row, positions per chunk) of both bodies for a page
    table of ``table_cols`` pages of ``page_size`` positions: counted in
    positions, so the same table width gives the same chunks whatever the
    page size."""
    return -(-(table_cols * page_size) // CHUNK), CHUNK


def paged_attention(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                    page_table: torch.Tensor, lengths: torch.Tensor, *,
                    k_scale: torch.Tensor = None,
                    v_scale: torch.Tensor = None) -> torch.Tensor:
    """q [B, H, D] (or [B, S, H, D], S query positions per row); kp, vp
    [P, ps, G, D]; page_table [B, M] int32; lengths [B] int32 (of the
    first query); optional ``k_scale``/``v_scale`` [P, ps, G, 1] f32 for
    int8 pools. Returns q's shape in ``q.dtype``."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_attention: pass both k_scale and v_scale, "
                         "or neither")
    if q.dim() not in (3, 4) or kp.dim() != 4 or kp.shape != vp.shape:
        raise ValueError(f"paged_attention: bad shapes q {tuple(q.shape)} "
                         f"kp {tuple(kp.shape)} vp {tuple(vp.shape)}")
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    s = q.shape[1] if q.dim() == 4 else 1
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
        if b and (int(lengths.min()) < 0 or int(lengths.max()) > m * ps):
            raise ValueError(f"paged_attention: lengths must lie in "
                             f"[0, {m * ps}], got {lengths.tolist()}")
        return plain(q, kp, vp, page_table, lengths, *scales)
    if s < 1:
        raise ValueError("paged_attention: no query position")
    if scales:
        body = paged_attention_q8_multi if q.dim() == 4 \
            else paged_attention_q8
        return body(q, kp, vp, *scales, page_table, lengths)
    check_cuda("paged_attention", q, kp, vp)
    if page_table.device != q.device or lengths.device != q.device:
        raise ValueError("paged_attention: page_table / lengths on another "
                         "device than q")
    q, kp, vp = q.contiguous(), kp.contiguous(), vp.contiguous()
    page_table, lengths = page_table.contiguous(), lengths.contiguous()
    out = torch.empty_like(q)
    if b == 0:
        return out
    chunks, _ = chunk_plan(m, ps)
    ws, counters = scratch("paged_attention", q.device,
                           b * s * h * chunks * (d + 2), b * g)
    launch("paged_attention", _ARGTYPES, q.data_ptr(), kp.data_ptr(),
           vp.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
           out.data_ptr(), ws.data_ptr(), counters.data_ptr(), b, s, h, g,
           d, ps, m, n_pages, CHUNK, 1.0 / math.sqrt(d), DTYPE_CODES[q.dtype])
    paged_attention.launches += 1
    return out


def paged_attention_q8(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                       k_scale: torch.Tensor, v_scale: torch.Tensor,
                       page_table: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """The int8 body on CUDA tensors, shapes checked by
    :func:`paged_attention` (its entry point): int8 kp/vp, f32 scale
    pools, q [B, H, D] fp32 or bf16."""
    out = _launch_q8("paged_attention_q8", q, kp, vp, k_scale, v_scale,
                     page_table, lengths)
    if out.shape[0]:  # launched
        paged_attention_q8.launches += 1
    return out


def paged_attention_q8_multi(q: torch.Tensor, kp: torch.Tensor,
                             vp: torch.Tensor, k_scale: torch.Tensor,
                             v_scale: torch.Tensor, page_table: torch.Tensor,
                             lengths: torch.Tensor) -> torch.Tensor:
    """The int8 body's multi-query form on CUDA tensors (the speculative
    verify over an INT8 target's grid or pool): q [B, S, H, D], query j
    over the positions below ``min(lengths + j, M·ps)``, each K/V tile
    staged and dequantised once for all S queries of a group; shapes
    checked by :func:`paged_attention`."""
    out = _launch_q8("paged_attention_q8_multi", q, kp, vp, k_scale,
                     v_scale, page_table, lengths)
    if out.shape[0]:  # launched
        paged_attention_q8_multi.launches += 1
    return out


def _launch_q8(name: str, q, kp, vp, k_scale, v_scale, page_table,
               lengths) -> torch.Tensor:
    """One launch of the int8 body for q [B, H, D] or [B, S, H, D]
    (none for B = 0)."""
    check_device(name, q, kp, vp, k_scale, v_scale, page_table, lengths)
    check_float(name, q)
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    s = q.shape[1] if q.dim() == 4 else 1
    n_pages, ps, g, _ = kp.shape
    m = page_table.shape[1]
    q, kp, vp, k_scale, v_scale, page_table, lengths = (
        t.contiguous() for t in (q, kp, vp, k_scale, v_scale, page_table,
                                 lengths))
    out = torch.empty_like(q)
    if b == 0:
        return out
    chunks, _ = chunk_plan(m, ps)
    ws, counters = scratch("paged_attention_q8", q.device,
                           b * s * h * chunks * (d + 2), b * g)
    launch("paged_attention_q8", _ARGTYPES_Q8, q.data_ptr(), kp.data_ptr(),
           vp.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
           page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
           ws.data_ptr(), counters.data_ptr(), b, s, h, g, d, ps, m, n_pages,
           CHUNK, 1.0 / math.sqrt(d), DTYPE_CODES[q.dtype],
           source="paged_attention")
    return out


paged_attention.launches = 0
paged_attention_q8.launches = 0
paged_attention_q8_multi.launches = 0
