"""Plain PyTorch versions of the kernels (the port's ``kernels/ref.py``).

Each function mirrors its JAX oracle in ``repro/kernels/ref.py``
operation for operation: inputs promoted to fp32, the same masks, the
same ``NEG_INF`` fill, softmax, cast back to the input dtype. They are
what a kernel wrapper runs when it is handed CPU tensors, and what
``chip_smoke.py`` holds each CUDA kernel against on the card.

``mlstm_chunkwise_ref`` is the plain version of the ``mlstm_chunkwise``
kernel (its arguments, chunk by chunk); ``mlstm_ref`` is the JAX
package's strict per-step oracle. ``prefix_attention_ref`` is the plain
version of the shared-prefix entry of the ``flash_attention`` kernel, the
attention of ``blocks._shared_prefix_attention`` in the JAX package.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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
                        k_scale: torch.Tensor = None,
                        v_scale: torch.Tensor = None,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [BH, S, D]; k, v: [BH, T, D]; positions of q and k start at 0.
    Optional [BH, T, 1] f32 per-token scales dequantise int8 k/v (in
    f32, not rounded) before attending."""
    if k_scale is not None:
        k = k.float() * k_scale
        v = v.float() * v_scale
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


def prefix_attention_ref(q: torch.Tensor, pre_k: torch.Tensor,
                         pre_v: torch.Tensor, pre_len: int, k: torch.Tensor,
                         v: torch.Tensor, *, pre_k_scale: torch.Tensor = None,
                         pre_v_scale: torch.Tensor = None) -> torch.Tensor:
    """Queries of a suffix after a shared prefix: q [BH, S, D] at
    positions ``pre_len + i``; the prefix ``pre_k``/``pre_v`` [BH, Lp, D]
    (fp, or int8 with [BH, Lp, 1] f32 scales, dequantised and then
    rounded to ``q.dtype`` as the JAX block's ``pre_k.astype(k.dtype)``
    does), visible below ``pre_len`` only; the fresh suffix ``k``/``v``
    [BH, S, D], causal on the local index. f32 scores scaled by
    1/sqrt(D), one softmax over both segments."""
    if pre_k_scale is not None:
        pre_k = pre_k.float() * pre_k_scale
        pre_v = pre_v.float() * pre_v_scale
    pre_k, pre_v = pre_k.to(q.dtype), pre_v.to(q.dtype)
    _, sq, d = q.shape
    lp = pre_k.shape[1]
    kc = torch.cat([pre_k.float(), k.float()], dim=1)
    vc = torch.cat([pre_v.float(), v.float()], dim=1)
    s = torch.einsum("bsd,btd->bst", q.float(), kc) / math.sqrt(d)
    qi = torch.arange(sq, device=q.device)[:, None]
    j = torch.arange(sq, device=q.device)[None, :]
    mask = torch.cat([(torch.arange(lp, device=q.device) < pre_len)[None]
                      .expand(sq, lp), j <= qi], dim=1)
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bst,btd->bsd", p, vc).to(q.dtype)


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


def paged_attention_split_ref(q: torch.Tensor, kp: torch.Tensor,
                              vp: torch.Tensor, page_table: torch.Tensor,
                              lengths: torch.Tensor, *,
                              chunk: int = 256) -> torch.Tensor:
    """The fp ``paged_attention`` kernel's algorithm in plain PyTorch: the
    row's positions cut into chunks of ``chunk`` (counted over the whole
    table width, so chunks past a row's length are empty), each chunk's
    (m, l, acc) from its own softmax, then the chunks merged in chunk
    order with weight ``exp(m_c - max m)`` and one division by
    ``max(l, 1e-30)``. An empty chunk (m = -1e30, l = 0) merges with
    weight exactly 0. Same arguments and result as
    :func:`paged_attention_ref` without the scale pools."""
    b, h, d = q.shape
    ps, g = kp.shape[1], kp.shape[2]
    t = page_table.shape[1] * ps
    rep = h // g
    table = page_table.long()
    k = kp[table].reshape(b, t, g, d).float()
    v = vp[table].reshape(b, t, g, d).float()
    qg = q.float().reshape(b, g, rep, d) / math.sqrt(d)
    s = torch.einsum("bgrd,btgd->bgrt", qg, k)
    valid = (torch.arange(t, device=q.device)[None]
             < lengths.to(q.device)[:, None])[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    ms, ls, accs = [], [], []
    for c0 in range(0, t, chunk):
        sc, vc = s[..., c0:c0 + chunk], valid[..., c0:c0 + chunk]
        m = sc.amax(-1)
        p = torch.where(vc, torch.exp(sc - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bgrt,btgd->bgrd", p, v[:, c0:c0 + chunk]))
    m_all = torch.stack(ms).amax(0)
    l_all = torch.zeros_like(m_all)
    acc = torch.zeros_like(accs[0])
    for m, l, a in zip(ms, ls, accs):
        wgt = torch.exp(m - m_all)
        l_all = l_all + wgt * l
        acc = acc + wgt[..., None] * a
    o = acc / torch.clamp(l_all, min=1e-30)[..., None]
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


def mlstm_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              it: torch.Tensor, ft: torch.Tensor) -> torch.Tensor:
    """Strict per-step mLSTM recurrence from the zero state: q, k, v
    [BH, S, D] (k pre-scaled by 1/sqrt(D)); it, ft [BH, S] gate
    pre-activations. Returns h [BH, S, D] in ``q.dtype``."""
    bh, s, d = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    it, ft = it.float(), ft.float()
    C = torch.zeros((bh, d, d), dtype=torch.float32, device=q.device)
    n = torch.zeros((bh, d), dtype=torch.float32, device=q.device)
    m = torch.full((bh,), NEG_INF, dtype=torch.float32, device=q.device)
    hs = torch.empty((bh, s, d), dtype=torch.float32, device=q.device)
    for t in range(s):
        qt, kt, vt = qf[:, t], kf[:, t], vf[:, t]
        logf = F.logsigmoid(ft[:, t])
        m_new = torch.maximum(logf + m, it[:, t])
        fs = torch.exp(logf + m - m_new)[:, None]
        is_ = torch.exp(it[:, t] - m_new)[:, None]
        C = fs[..., None] * C + is_[..., None] * (kt[:, :, None] * vt[:, None, :])
        n = fs * n + is_ * kt
        num = torch.einsum("bkv,bk->bv", C, qt)
        den = torch.maximum(torch.abs(torch.einsum("bk,bk->b", n, qt)),
                            torch.exp(-m_new))[:, None]
        hs[:, t] = num / den
        m = m_new
    return hs.to(q.dtype)


def mlstm_chunkwise_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        it: torch.Tensor, logf: torch.Tensor,
                        C0: torch.Tensor = None, n0: torch.Tensor = None,
                        m0: torch.Tensor = None, *, bq: int = 16):
    """The chunkwise mLSTM of the TPU kernel, chunks of ``bq`` steps (the
    last may be shorter), from the state ``(C0 [BH, D, D], n0 [BH, D],
    m0 [BH])`` (default zeros and ``m0 = -1e30``). ``logf`` is the
    log-forget gate, so ``(logf, it) = (0, -1e30)`` is an identity step.
    Returns (h [BH, S, D] in ``q.dtype``, C, n, m in f32)."""
    bh, s, d = q.shape
    dev = q.device
    qf, kf, vf = q.float(), k.float(), v.float()
    it, logf = it.float(), logf.float()
    if C0 is None:
        C = torch.zeros((bh, d, d), dtype=torch.float32, device=dev)
        n = torch.zeros((bh, d), dtype=torch.float32, device=dev)
        m = torch.full((bh,), NEG_INF, dtype=torch.float32, device=dev)
    else:
        C, n, m = C0.float(), n0.float(), m0.float()
    out = torch.empty((bh, s, d), dtype=torch.float32, device=dev)
    for t0 in range(0, s, bq):
        t1 = min(t0 + bq, s)
        qc, kc, vc = qf[:, t0:t1], kf[:, t0:t1], vf[:, t0:t1]
        ic = it[:, t0:t1]
        Fc = torch.cumsum(logf[:, t0:t1], dim=1)  # [BH, Q]
        causal = torch.ones((t1 - t0, t1 - t0), dtype=torch.bool,
                            device=dev).tril()
        bias = Fc[:, :, None] - Fc[:, None, :] + ic[:, None, :]
        w_state = Fc + m[:, None]
        m_i = torch.maximum(torch.where(causal, bias, NEG_INF).amax(-1), w_state)
        m_i = torch.clamp(m_i, min=NEG_INF)
        decay = torch.where(causal, torch.exp(bias - m_i[..., None]), 0.0)
        scores = (qc @ kc.transpose(1, 2)) * decay
        s_coef = torch.exp(w_state - m_i)
        num = scores @ vc + s_coef[..., None] * (qc @ C)
        den = scores.sum(-1) + s_coef * (qc @ n[:, :, None])[..., 0]
        den = torch.maximum(den.abs(), torch.exp(-m_i))
        out[:, t0:t1] = num / den[..., None]
        # fold the chunk into the state
        fe = Fc[:, -1]
        w_log = fe[:, None] - Fc + ic
        m_new = torch.maximum(w_log.amax(-1), fe + m)
        wts = torch.exp(w_log - m_new[:, None])
        carry = torch.exp(fe + m - m_new)
        kw = kc * wts[..., None]
        C = carry[:, None, None] * C + kw.transpose(1, 2) @ vc
        n = carry[:, None] * n + kw.sum(1)
        m = m_new
    return out.to(q.dtype), C, n, m
