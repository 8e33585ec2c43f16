"""``flash_attention``: causal / windowed online-softmax prefill attention.

Replaces the TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` / ``_flash_kernel``, fp body ``_flash_body``) with
the hand-written CUDA kernel ``csrc/flash_attention.cu``. q ``[BH, S,
D]``, k/v ``[BH, T, D]`` (kv already broadcast across groups), query and
key positions from 0; fp32 scores scaled by 1/sqrt(D), running
max/sum/accumulator in fp32, one normalisation at the end.

Bound on the H100: at this path's prefill shapes the work is operation
bound (``4·D`` flops per visible query-key pair); the score matrix
never reaches device memory, and kv blocks past the causal diagonal are
skipped. One block per (bh, 64 queries), a loop over kv blocks in place
of the TPU's sequential grid axis; at D = 256 (recurrentgemma-2b's local
attention) one block per (bh, 32 queries) with 8 threads sharing each
query row, so that q and the accumulator fit in registers. The TPU tile
sizes ``bq``/``bk`` do not carry over: the Hopper tile is fixed by the
kernel.

Like the TPU kernel it has no length operand: on a right-padded batch
the valid query rows are exact and the padded tail's rows are not (they
are causally invisible to valid rows and their cache entries are
invalidated by the scheduler).

A CPU tensor takes the plain version (:func:`plain`); a CUDA tensor
launches the kernel or raises. ``flash_attention.launches`` counts
launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels._launch import DTYPE_CODES, check_cuda, launch
from repro_torch.kernels.ref import flash_attention_ref as plain

HEAD_DIMS = (16, 32, 64, 128, 256)
_VP, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [BH, S, D]; k, v: [BH, T, D] -> [BH, S, D] in ``q.dtype``."""
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return plain(q, k, v, causal=causal, window=window)
    check_cuda("flash_attention", q, k, v)
    bh, s, d = q.shape
    t = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if bh == 0 or s == 0:
        return out
    if t == 0:
        raise ValueError("flash_attention: empty key sequence")
    launch("flash_attention", _ARGTYPES, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), out.data_ptr(), bh, s, t, d, int(causal),
           int(window), 1.0 / math.sqrt(d), DTYPE_CODES[q.dtype])
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
