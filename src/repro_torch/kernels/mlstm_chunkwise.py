"""``mlstm_chunkwise``: the chunkwise mLSTM (xLSTM matrix memory).

Replaces the TPU kernel ``repro/kernels/mlstm_kernel.py``
(``mlstm_chunkwise`` / ``_mlstm_kernel``) with the hand-written CUDA
kernel ``csrc/mlstm_chunkwise.cu``. Two entries:

* :func:`mlstm_chunkwise_fold` is the kernel's own signature: q, k, v
  ``[BH, S, D]`` (fp32 or bf16, k pre-scaled by 1/sqrt(D)), f32 input
  gates ``it`` and **log**-forget gates ``logf`` ``[BH, S]``, an optional
  f32 initial state ``(C0 [BH, D, D], n0 [BH, D], m0 [BH])`` (zeros and
  ``m0 = -1e30`` by default); it returns ``(h [BH, S, D] in q.dtype, C,
  n, m)``, the final state in f32. The model's prefill calls it: a
  padded step is the identity gate pair ``(logf, it) = (0, -1e30)``.
* :func:`mlstm_chunkwise` is the TPU kernel's signature ``(q, k, v, it,
  ft)`` with forget pre-activations: it applies a stable log-sigmoid
  and returns h from the zero state.

Bound on the H100: bytes, barely (q/k/v/h read and written once against
~4·BH·S·D² flops for ``q C`` and the chunk fold, on the tensor cores).
One block per (bh, 64-column tile of C) walks the chunks of 16 steps in
order. bf16 q, k, v run ``mlstm_tc_kernel``: the block's slice of C
held as fp32 ``mma.sync`` accumulators in registers, the chunk's q kᵀ,
C q and fold on the tensor cores, C and w·k as three bf16 terms (plain
mirror: ``ref.mlstm_chunkwise_ref(split=True)``). fp32 runs
``mlstm_kernel`` on the CUDA cores (no TF32).

A CPU tensor takes the plain version (:func:`plain`, the chunkwise
``ref.mlstm_chunkwise_ref``); a CUDA tensor launches the kernel or
raises. ``mlstm_chunkwise.launches`` counts launches of either entry.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels._launch import (DTYPE_CODES, check_cuda,
                                         check_device, check_dtype, launch)
from repro_torch.kernels.ref import NEG_INF
from repro_torch.kernels.ref import mlstm_chunkwise_ref as plain

_VP, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_VP,) * 12 + (_I,) * 4


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``log(sigmoid(x))`` in the stable form: ``-log1p(exp(-x))`` for
    x >= 0, ``x - log1p(exp(x))`` otherwise."""
    pos = -torch.log1p(torch.exp(-x))
    neg = x - torch.log1p(torch.exp(x))
    return torch.where(x >= 0, pos, neg)


def mlstm_chunkwise_fold(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         it: torch.Tensor, logf: torch.Tensor,
                         C0: Optional[torch.Tensor] = None,
                         n0: Optional[torch.Tensor] = None,
                         m0: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """-> (h [BH, S, D] in ``q.dtype``, C [BH, D, D], n [BH, D], m [BH]).
    On the card D must be a multiple of 32 up to 512; the C entry
    rejects others and the launch raises."""
    bh, s, d = q.shape
    if k.shape != q.shape or v.shape != q.shape \
            or tuple(it.shape) != (bh, s) or tuple(logf.shape) != (bh, s):
        raise ValueError(f"mlstm_chunkwise: bad shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} it "
                         f"{tuple(it.shape)} logf {tuple(logf.shape)}")
    given = [t is not None for t in (C0, n0, m0)]
    if any(given) and not all(given):
        raise ValueError("mlstm_chunkwise: give all of C0, n0, m0 or none")
    if all(given) and (tuple(C0.shape) != (bh, d, d)
                       or tuple(n0.shape) != (bh, d)
                       or tuple(m0.shape) != (bh,)):
        raise ValueError(f"mlstm_chunkwise: bad state shapes C0 "
                         f"{tuple(C0.shape)} n0 {tuple(n0.shape)} m0 "
                         f"{tuple(m0.shape)}")
    check_dtype("mlstm_chunkwise", torch.float32, it, logf,
                *([C0, n0, m0] if all(given) else []))
    if all(t.device.type == "cpu" for t in (q, k, v, it, logf)):
        return plain(q, k, v, it, logf, C0, n0, m0)
    check_cuda("mlstm_chunkwise", q, k, v)
    check_device("mlstm_chunkwise", q, it, logf,
                 *([C0, n0, m0] if all(given) else []))
    if not all(given):
        C0 = torch.zeros((bh, d, d), dtype=torch.float32, device=q.device)
        n0 = torch.zeros((bh, d), dtype=torch.float32, device=q.device)
        m0 = torch.full((bh,), NEG_INF, dtype=torch.float32, device=q.device)
    ins = [t.contiguous() for t in (q, k, v, it, logf, C0, n0, m0)]
    h = torch.empty_like(ins[0])
    C = torch.empty((bh, d, d), dtype=torch.float32, device=q.device)
    n = torch.empty((bh, d), dtype=torch.float32, device=q.device)
    m = torch.empty((bh,), dtype=torch.float32, device=q.device)
    launch("mlstm_chunkwise", _ARGTYPES, *(t.data_ptr() for t in ins),
           h.data_ptr(), C.data_ptr(), n.data_ptr(), m.data_ptr(), bh, s, d,
           DTYPE_CODES[q.dtype])
    mlstm_chunkwise.launches += 1
    return h, C, n, m


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    it: torch.Tensor, ft: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's signature: it, ft ``[BH, S]`` gate
    pre-activations, zero initial state -> h ``[BH, S, D]``."""
    return mlstm_chunkwise_fold(q, k, v, it.float(),
                                log_sigmoid(ft.float()))[0]


mlstm_chunkwise.launches = 0
