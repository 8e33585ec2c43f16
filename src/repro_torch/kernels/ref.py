"""Plain PyTorch versions of the kernels (the port's ``kernels/ref.py``).

Each function mirrors its JAX oracle in ``repro/kernels/ref.py``
operation for operation: inputs promoted to fp32, the same masks, the
same ``NEG_INF`` fill, softmax, cast back to the input dtype. They are
what a kernel wrapper runs when it is handed CPU tensors, and what
``chip_smoke.py`` holds each CUDA kernel against on the card.

The int8 ``k_scale``/``v_scale`` arguments of ``flash_attention_ref``
and the ``mlstm_ref`` oracle arrive with their slices.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [R, N] @ w [N, M] in fp32, cast to ``x.dtype``."""
    return (x.float() @ w.float()).to(x.dtype)


def quant_matmul_ref(x: torch.Tensor, w_q: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """Dequantise-then-matmul: x [R, N] fp @ (w_q [N, M] int8 * scale
    [1, M] f32) in fp32, cast to ``x.dtype``."""
    w = w_q.float() * scale.reshape(1, w_q.shape[1])
    return (x.float() @ w).to(x.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [BH, S, D]; k, v: [BH, T, D]; positions of q and k start at 0."""
    _, sq, d = q.shape
    t = k.shape[1]
    s = torch.einsum("bsd,btd->bst", q.float(), k.float()) / math.sqrt(d)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((sq, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= (qp - kp) < window
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bst,btd->bsd", p, v.float()).to(q.dtype)


def paged_attention_ref(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                        page_table: torch.Tensor, lengths: torch.Tensor,
                        k_scale: torch.Tensor = None,
                        v_scale: torch.Tensor = None) -> torch.Tensor:
    """Gather-then-attend: q [B, H, D]; kp, vp [P, ps, G, D];
    page_table [B, M] int32; lengths [B] valid kv count; optional
    [P, ps, G, 1] f32 scale pools dequantise int8 kp/vp after the
    gather. Returns [B, H, D]."""
    b, h, d = q.shape
    ps, g = kp.shape[1], kp.shape[2]
    t = page_table.shape[1] * ps
    rep = h // g
    table = page_table.long()
    k = kp[table].reshape(b, t, g, d).float()
    v = vp[table].reshape(b, t, g, d).float()
    if k_scale is not None:
        k = k * k_scale[table].reshape(b, t, g, 1)
        v = v * v_scale[table].reshape(b, t, g, 1)
    qg = q.float().reshape(b, g, rep, d) / math.sqrt(d)
    s = torch.einsum("bgrd,btgd->bgrt", qg, k)
    valid = torch.arange(t, device=q.device)[None] < lengths.to(q.device)[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrt,btgd->bgrd", p, v)
    return o.reshape(b, h, d).to(q.dtype)


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t with an fp32 carry from h0 [B, W], one
    step at a time over S; a, b [B, S, W]. Returns the h sequence
    [B, S, W] in ``a.dtype``."""
    af, bf = a.float(), b.float()
    h = h0.float()
    hs = torch.empty(af.shape, dtype=torch.float32, device=a.device)
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs[:, t] = h
    return hs.to(a.dtype)
