"""Plain PyTorch versions of the kernels (the port's ``kernels/ref.py``).

Each function mirrors its JAX oracle in ``repro/kernels/ref.py``
operation for operation: inputs promoted to fp32, the same masks, the
same ``NEG_INF`` fill, softmax, cast back to the input dtype. They are
what a kernel wrapper runs when it is handed CPU tensors, and what
``chip_smoke.py`` holds each CUDA kernel against on the card.

``quant_matmul_split_ref`` and ``flash_attention_tiles_ref`` are plain
mirrors of the tensor-core kernels' arithmetic (three bf16 terms of fp32
x; the flash tile order with P rounded before P·V, and with
``terms=True`` the flash form on bf16 terms with the int8 scales on the
scores and on p and two merged running states), held against the JAX
package in the tests; the wrappers never run them.

``mlstm_chunkwise_ref`` is the plain version of the ``mlstm_chunkwise``
kernel (its arguments, chunk by chunk); ``mlstm_ref`` is the JAX
package's strict per-step oracle. ``prefix_attention_ref`` is the plain
version of the shared-prefix entry of the ``flash_attention`` kernel, the
attention of ``blocks._shared_prefix_attention`` in the JAX package.

A row with no visible key (``flash_attention_ref``'s ``kv_len`` of 0,
``paged_attention_ref``'s length 0: an inert slot's cross-attention)
gives 0, as the kernels do, where the reference's masked softmax
averages V. Serving refuses a request with 0 source frames, so only an
inert slot has such a row there.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _acc(x: torch.Tensor) -> torch.dtype:
    """The accumulation dtype of a plain version: fp32, or fp64 for fp64
    inputs (``torch.autograd.gradcheck`` of the training Functions)."""
    return torch.promote_types(x.dtype, torch.float32)


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [R, N] @ w [N, M] in fp32 (fp64 for fp64 x), cast to ``x.dtype``."""
    acc = _acc(x)
    return (x.to(acc) @ w.to(acc)).to(x.dtype)


def expert_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                      counts: torch.Tensor = None) -> torch.Tensor:
    """The expert products of an MoE layer: x [E, C, K] @ w [E, K, N]
    per expert (the reference's ``einsum("ecd,edf->ecf")``) in fp32 (fp64
    for fp64 x), cast to ``x.dtype``. ``counts`` [E] (int): expert e's
    rows at or past ``counts[e]`` are not live and come out +0 (the MoE
    layer's rows there are zero already, so the product is unchanged);
    ``None``: every row is live."""
    acc = _acc(x)
    out = torch.einsum("eck,ekn->ecn", x.to(acc), w.to(acc))
    if counts is not None:
        rows = torch.arange(x.shape[1], device=x.device)
        live = rows[None, :] < counts.to(x.device, torch.int64)[:, None]
        out = torch.where(live[..., None], out, 0.0)
    return out.to(x.dtype)


def expert_matmul_dgrad_ref(dy: torch.Tensor, w: torch.Tensor,
                            counts: torch.Tensor = None) -> torch.Tensor:
    """The data gradient of :func:`expert_matmul_ref`: dy [E, C, N] @
    w [E, K, N]ᵀ per expert -> dx [E, C, K] in fp32, cast to
    ``dy.dtype``; rows at or past ``counts[e]`` +0 (their forward rows
    were not live)."""
    return expert_matmul_ref(dy, w.transpose(1, 2), counts)


def expert_matmul_wgrad_ref(x: torch.Tensor, dy: torch.Tensor,
                            counts: torch.Tensor = None) -> torch.Tensor:
    """The weight gradient of :func:`expert_matmul_ref`: x [E, C, K]ᵀ @
    dy [E, C, N] per expert -> dw [E, K, N] in fp32, cast to
    ``x.dtype``, the contraction over C stopped at ``counts[e]`` (an
    expert with no live row gets zeros). The MoE layer's rows past it are
    zero in x and in dy, so the sum equals the one over all C."""
    acc = _acc(x)
    xf, gf = x.to(acc), dy.to(acc)
    if counts is not None:
        rows = torch.arange(x.shape[1], device=x.device)
        live = rows[None, :] < counts.to(x.device, torch.int64)[:, None]
        xf = torch.where(live[..., None], xf, 0.0)
    return torch.einsum("eck,ecn->ekn", xf, gf).to(x.dtype)


def quant_matmul_ref(x: torch.Tensor, w_q: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """Dequantise-then-matmul: x [R, N] fp @ (w_q [N, M] int8 * scale
    [1, M] f32) in fp32, cast to ``x.dtype``."""
    w = w_q.float() * scale.reshape(1, w_q.shape[1])
    return (x.float() @ w).to(x.dtype)


def quant_matmul_experts_ref(x: torch.Tensor, w_q: torch.Tensor,
                             scale: torch.Tensor,
                             counts: torch.Tensor = None) -> torch.Tensor:
    """The int8 expert products: x [E, C, K] fp @ (w_q [E, K, N] int8 *
    scale, N f32 values shared by every expert) per expert in fp32 (the
    reference's ``einsum("ecd,edf->ecf")`` on its dequantised weights),
    cast to ``x.dtype``; ``counts`` as :func:`expert_matmul_ref`'s."""
    w = w_q.float() * scale.reshape(1, 1, w_q.shape[2]).float()
    return expert_matmul_ref(x.float(), w, counts).to(x.dtype)


def split_terms(x: torch.Tensor) -> list:
    """``x`` as the bf16 terms the tensor-core ``quant_matmul`` routes
    stage it as: fp32 x as ``hi = bf16(x)``, ``mid = bf16(x - hi)``,
    ``lo = bf16(x - hi - mid)`` (their sum is x exactly for normal
    values); bf16 x as itself."""
    if x.dtype != torch.float32:
        return [x.to(torch.bfloat16)]
    hi = x.to(torch.bfloat16)
    rest = x - hi.float()
    mid = rest.to(torch.bfloat16)
    return [hi, mid, (rest - mid.float()).to(torch.bfloat16)]


def quant_matmul_split_ref(x: torch.Tensor, w_q: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """The tensor-core ``quant_matmul`` routes' arithmetic: the sum over
    :func:`split_terms` of ``term @ w_q`` in fp32 (each product of a bf16
    term and an int8 weight exact), times ``scale [1, M]`` once, cast to
    ``x.dtype``. Equal to :func:`quant_matmul_ref` up to the fp32
    summation order."""
    w = w_q.float()
    acc = sum(t.float() @ w for t in split_terms(x))
    return (acc * scale.reshape(1, w_q.shape[1])).to(x.dtype)


def quant_matmul_experts_split_ref(x: torch.Tensor, w_q: torch.Tensor,
                                   scale: torch.Tensor,
                                   counts: torch.Tensor = None
                                   ) -> torch.Tensor:
    """The arithmetic of ``quant_matmul_experts`` at decode
    (``stream_ex``): per expert, each of :func:`split_terms`'s terms
    times ``w_q`` in fp32 on its own, the terms summed last (hi + mid +
    lo), times ``scale`` (N values shared by every expert) once, cast to
    ``x.dtype``; ``counts`` as :func:`expert_matmul_ref`'s. Equal to
    :func:`quant_matmul_experts_ref` up to the fp32 summation order."""
    w = w_q.float()
    acc = sum(expert_matmul_ref(t.float(), w, counts)
              for t in split_terms(x))
    return (acc * scale.reshape(1, 1, w_q.shape[2]).float()).to(x.dtype)


#: query rows per block of the tensor-core flash kernels: 128 for
#: ``flash_tc_kernel`` (192 at D = 128; its result does not depend on it),
#: 64 for ``flash_terms_kernel``, whose two warpgroups take every other
#: K/V tile of a block with running states of their own; keys per tile
FLASH_BQ, FLASH_TERMS_BQ, FLASH_TERMS_SPLITS, FLASH_BK = 128, 64, 2, 64


def flash_attention_tiles_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *,
                              k_scale: torch.Tensor = None,
                              v_scale: torch.Tensor = None,
                              causal: bool = True, window: int = 0,
                              pre_k: torch.Tensor = None,
                              pre_v: torch.Tensor = None,
                              pre_k_scale: torch.Tensor = None,
                              pre_v_scale: torch.Tensor = None,
                              pre_len: int = 0, p_dtype: torch.dtype = None,
                              terms: bool = False) -> torch.Tensor:
    """The tensor-core ``flash_attention`` kernels' algorithm: for each
    block of queries, the K/V tiles of ``FLASH_BK`` keys it visits — the
    prefix ``pre_k``/``pre_v`` [BH, Lp, D] below ``pre_len`` first (the
    shared-prefix entry: q then sits at ``pre_len + i``), then the main
    keys from the tile holding the block's first row's window start to the
    block's causal end — each updating (m, l, acc) in fp32 from its own
    maximum (masked scores are -inf, so a tile that masks a whole row
    leaves the row's state as it was), l summed from the f32 p, P rounded
    to ``p_dtype`` (default ``q.dtype``) before P·V, one division by
    ``max(l, 1e-30)`` at the end. Keys past a segment's end, and their
    scales, are never read (zeros). Int8 k/v (``k_scale``/``v_scale``
    [BH, T, 1], the prefix's ``pre_k_scale``/``pre_v_scale`` [BH, Lp,
    1]) stay int8 in the products: a score column is multiplied by its k
    scale, and p by its v scale before P·V (l sums the unscaled p).

    ``terms=False`` is ``flash_tc_kernel`` (blocks of ``FLASH_BQ``
    queries, fp32 products); with ``p_dtype`` float32 it equals
    :func:`flash_attention_ref` (or :func:`prefix_attention_ref`) up to
    the fp32 summation order. ``terms=True`` is ``flash_terms_kernel``:
    blocks of ``FLASH_TERMS_BQ`` queries, tile ``i`` updating running
    state ``i % FLASH_TERMS_SPLITS``, the states merged in order at the
    end with weight ``exp(m_s - max m)``; operands enter the products as
    bf16 terms (:func:`split_terms`; int8 values exact as they are): of
    two split operands the term pairs ``i + j < 3``, of a split and an
    exact one all three. Returns [BH, S, D] in ``q.dtype``."""
    bh, s, d = q.shape
    dev = q.device
    p_dtype = p_dtype or q.dtype
    bq, splits = ((FLASH_TERMS_BQ, FLASH_TERMS_SPLITS) if terms
                  else (FLASH_BQ, 1))
    bk = FLASH_BK

    def enter(x):  # an operand as it enters the products
        if terms and x.dtype != torch.int8:
            return [y.float() for y in split_terms(x)]
        return [x.float()]

    def products(xs, ys, spec):  # term pairs i + j < n, smallest first
        n = max(len(xs), len(ys))
        pairs = sorted(((i, j) for i in range(len(xs)) for j in range(len(ys))
                        if i + j < n), key=lambda ij: -(ij[0] + ij[1]))
        return sum(torch.einsum(spec, xs[i], ys[j]) for i, j in pairs)

    qt = enter(q)
    segs = []
    if pre_k is not None:
        segs.append((pre_k, pre_v, pre_k_scale, pre_v_scale, pre_len, True))
    segs.append((k, v, k_scale, v_scale, k.shape[1], False))
    out = torch.empty((bh, s, d), dtype=torch.float32, device=dev)
    for q0 in range(0, s, bq):
        rows = min(bq, s - q0)
        qi = torch.arange(q0, q0 + rows, device=dev)[:, None]
        qb = [x[:, q0:q0 + rows] for x in qt]
        tiles = []
        for kk, vv, ks, vs, lim, pre in segs:
            begin, end = 0, lim
            if not pre and causal:
                end = min(lim, q0 + bq)
            if not pre and window:
                begin = max(q0 - window + 1, 0) // bk * bk
            tiles += [(kk, vv, ks, vs, lim, pre, t0)
                      for t0 in range(begin, end, bk)]
        states = [(torch.full((bh, rows), NEG_INF, device=dev),
                   torch.zeros((bh, rows), device=dev),
                   torch.zeros((bh, rows, d), device=dev))
                  for _ in range(splits)]
        for i, (kk, vv, ks, vs, lim, pre, t0) in enumerate(tiles):
            m, l, acc = states[i % splits]
            n = min(bk, lim - t0)
            kt = torch.zeros((bh, bk, d), dtype=kk.dtype, device=dev)
            vt = torch.zeros_like(kt)
            kt[:, :n], vt[:, :n] = kk[:, t0:t0 + n], vv[:, t0:t0 + n]
            sc = products(qb, enter(kt), "bsd,btd->bst")
            if ks is not None:
                kst = torch.zeros((bh, bk), device=dev)
                vst = torch.zeros((bh, bk), device=dev)
                kst[:, :n] = ks[:, t0:t0 + n, 0]
                vst[:, :n] = vs[:, t0:t0 + n, 0]
                sc = sc * kst[:, None, :]
            sc = sc / math.sqrt(d)
            kp = torch.arange(t0, t0 + bk, device=dev)[None, :]
            ok = kp < lim
            if not pre and causal:
                ok = ok & (kp <= qi)
            if not pre and window:
                ok = ok & ((qi - kp) < window)
            sc = torch.where(ok[None], sc, float("-inf"))
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            if ks is not None:
                p = p * vst[:, None, :]
            acc = acc * alpha[..., None] + products(
                enter(p.to(p_dtype)), enter(vt), "bst,btd->bsd")
            states[i % splits] = (m_new, l, acc)
        m_all = torch.stack([st[0] for st in states]).amax(0)
        l_all = torch.zeros_like(m_all)
        acc_all = torch.zeros_like(states[0][2])
        for m, l, acc in states:
            w = torch.exp(m - m_all)
            l_all = l_all + l * w
            acc_all = acc_all + acc * w[..., None]
        out[:, q0:q0 + rows] = acc_all / torch.clamp(l_all, min=1e-30)[..., None]
    return out.to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        k_scale: torch.Tensor = None,
                        v_scale: torch.Tensor = None,
                        causal: bool = True, window: int = 0,
                        kv_len: torch.Tensor = None,
                        prefix_len: int = 0) -> torch.Tensor:
    """q: [BH, S, D]; k, v: [BH, T, D]; positions of q and k start at 0.
    Optional [BH, T, 1] f32 per-token scales dequantise int8 k/v (in
    f32, not rounded) before attending. ``kv_len`` [B] (B dividing BH):
    keys at or past row bh's length ``kv_len[bh // (BH / B)]`` masked (the
    reference's ``kv_valid``); ``prefix_len`` (causal): keys below it
    visible to every query (the reference's prefix-LM ``prefix_len``).
    A row with no visible key gives 0."""
    if k_scale is not None:
        k = k.float() * k_scale
        v = v.float() * v_scale
    bh, sq, d = q.shape
    t = k.shape[1]
    s = torch.einsum("bsd,btd->bst", q.float(), k.float()) / math.sqrt(d)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((sq, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= (kp <= qp) | (kp < prefix_len)
    if window:
        mask &= (qp - kp) < window
    mask = mask[None]
    if kv_len is not None:
        lens = kv_len.to(q.device).repeat_interleave(bh // kv_len.shape[0])
        mask = mask & (kp[None] < lens[:, None, None])
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask.any(-1, keepdim=True), torch.softmax(s, dim=-1), 0.0)
    return torch.einsum("bst,btd->bsd", p, v.float()).to(q.dtype)


def _train_mask(sq: int, t: int, causal: bool, device) -> torch.Tensor:
    """The training forms' mask [1, S, T]: query qi sees key kp when ``kp
    <= qi`` (``causal``, positions from 0 on both sides), else every key."""
    qp = torch.arange(sq, device=device)[:, None]
    kp = torch.arange(t, device=device)[None, :]
    mask = kp <= qp if causal else torch.ones((sq, t), dtype=torch.bool,
                                               device=device)
    return mask[None]


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True) -> tuple:
    """The training forward's plain version: :func:`flash_attention_ref`
    of q [BH, S, D] over k, v [BH, T, D] (``causal``: key kp seen by
    query qi when kp <= qi; else every key, S and T free) and each row's
    log-sum-exp of the scaled scores, ``lse`` [BH, S] f32 (fp64 for fp64
    q), the natural log of the softmax denominator that
    ``flash_attention_bwd`` recomputes P from."""
    acc = _acc(q)
    bh, sq, d = q.shape
    s = torch.einsum("bsd,btd->bst", q.to(acc), k.to(acc)) / math.sqrt(d)
    s = torch.where(_train_mask(sq, k.shape[1], causal, q.device), s,
                    NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bst,btd->bsd", p, v.to(acc)).to(q.dtype), lse


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor, *,
                            causal: bool = True) -> tuple:
    """The plain version of ``flash_attention_bwd``: the
    FlashAttention-2 gradient the kernel computes, from the forward's
    output ``o`` and log-sum-exp ``lse`` [BH, S] (q, o, dO [BH, S, D];
    k, v [BH, T, D]; the mask of :func:`flash_attention_lse_ref`):
    ``delta = sum(dO o)``, ``P = exp(scale q k - lse)`` masked, ``dV =
    P^T dO``, ``dS = P (dO V^T - delta)``, ``dQ = scale dS K``, ``dK =
    scale dS^T Q``; fp32 (fp64 for fp64 q), each cast to ``q.dtype``."""
    acc = _acc(q)
    bh, sq, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf = q.to(acc), k.to(acc), v.to(acc)
    gf = do.to(acc)
    delta = (gf * o.to(acc)).sum(-1, keepdim=True)
    mask = _train_mask(sq, k.shape[1], causal, q.device)
    s = torch.einsum("bsd,btd->bst", qf, kf) * scale
    p = torch.where(mask, torch.exp(s - lse.to(acc)[..., None]), 0.0)
    dv = torch.einsum("bst,bsd->btd", p, gf)
    ds = p * (torch.einsum("bsd,btd->bst", gf, vf) - delta)
    dq = torch.einsum("bst,btd->bsd", ds, kf) * scale
    dk = torch.einsum("bst,bsd->btd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


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
    gather. Returns [B, H, D].

    The multi-query form, q [B, S, H, D], is written out position by
    position: query j is the one-query form over ``min(lengths + j,
    M·ps)`` keys (every query of a row of length 0 gives 0). Returns
    [B, S, H, D]."""
    if q.dim() == 4:
        t = page_table.shape[1] * kp.shape[1]
        o = torch.stack([
            paged_attention_ref(q[:, j], kp, vp, page_table,
                                torch.clamp(lengths + j, max=t), k_scale,
                                v_scale)
            for j in range(q.shape[1])], dim=1)
        empty = (lengths.to(q.device) == 0)[:, None, None, None]
        return torch.where(empty, torch.zeros_like(o), o)
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
    p = torch.where(valid.any(-1)[:, None, None, None],
                    torch.softmax(s, dim=-1), 0.0)
    o = torch.einsum("bgrt,btgd->bgrd", p, v)
    return o.reshape(b, h, d).to(q.dtype)


def paged_attention_split_ref(q: torch.Tensor, kp: torch.Tensor,
                              vp: torch.Tensor, page_table: torch.Tensor,
                              lengths: torch.Tensor,
                              k_scale: torch.Tensor = None,
                              v_scale: torch.Tensor = None, *,
                              chunk: int = 256) -> torch.Tensor:
    """The ``paged_attention`` kernel's algorithm (both bodies) in plain
    PyTorch: the row's positions cut into chunks of ``chunk`` (counted
    over the whole table width, so chunks past a row's length are empty),
    each chunk's (m, l, acc) from its own softmax, then the chunks merged
    in chunk order with weight ``exp(m_c - max m)`` and one division by
    ``max(l, 1e-30)``. An empty chunk (m = -1e30, l = 0) merges with
    weight exactly 0. Int8 pools are dequantised in f32 after the gather
    (``k * k_scale``, ``v * v_scale``), as the int8 body does at its
    shared-memory read. Same arguments and result as
    :func:`paged_attention_ref`."""
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
                        m0: torch.Tensor = None, *, bq: int = 16,
                        split: bool = False):
    """The chunkwise mLSTM of the TPU kernel, chunks of ``bq`` steps (the
    last may be shorter), from the state ``(C0 [BH, D, D], n0 [BH, D],
    m0 [BH])`` (default zeros and ``m0 = -1e30``). ``logf`` is the
    log-forget gate, so ``(logf, it) = (0, -1e30)`` is an identity step.
    Returns (h [BH, S, D] in ``q.dtype``, C, n, m in f32).

    With ``split`` it mirrors the bf16 tensor-core kernel's arithmetic: C
    in ``q C`` and ``w * k`` in the fold enter their products as three
    bf16 terms (exact for normal values, so only the summation order
    departs from f32); q, k and v must then hold bf16 values."""
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
        qC = sum(qc @ t.float() for t in split_terms(C)) if split else qc @ C
        num = scores @ vc + s_coef[..., None] * qC
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
        kwt = kw.transpose(1, 2)
        fold = sum(t.float() @ vc for t in split_terms(kwt)) if split \
            else kwt @ vc
        C = carry[:, None, None] * C + fold
        n = carry[:, None] * n + kw.sum(1)
        m = m_new
    return out.to(q.dtype), C, n, m
