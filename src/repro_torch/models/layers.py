"""Shared model primitives on tensors: init, norm, RoPE, MLP, embeddings,
and the attention forms of the serving path.

Mirrors ``repro/models/layers.py`` function for function where the port
needs it. Every ``x @ w`` goes through ``kernels.ops.matmul``
(``xfer_matmul`` on the card). Attention goes through the kernels too:
prefill attention through ``flash_attention`` (a suffix after a shared
prefix through its prefix entry), decode over the dense slot grid, a
page pool or an encoder output through ``paged_attention`` (one token,
or the S fresh positions of a speculative verify). On CPU tensors the
kernels' plain versions run, so the CPU path is the same code.

The JAX package's masked ``attention``/``_attend_block``/``_mask`` are
not carried over: the two kernels take their place, with the masks the
serving paths need: causal, window and prefix-LM (``prefix_len``, the
vlm family's patch prefix), and per-row key lengths (the encoder's
frames and the decoder's cross-attention, ``kv_len``) in prefill; the
length mask in decode.

INT8 weights (``quant.quantize_params``) arrive as :class:`QTensor`
leaves: ``dense`` runs them through ``quant_matmul``, the embedding
gathers int8 rows and scales them, and a norm scale or bias is
dequantised to fp32 where it is read. The values are the reference's
``dequantize_params`` (fp32) followed by its fp arithmetic.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import quant as Q
from repro_torch.kernels import ops


def dense_init_(param: torch.Tensor, fan_in: int,
                gen: torch.Generator) -> None:
    """Fill ``param`` in place like ``layers.dense_init``: a normal
    truncated to [-2, 2], scaled by 1/sqrt(fan_in), drawn in fp32 from
    ``gen`` and cast to the param's dtype. (The distribution, not JAX's
    bits: those come over through ``bridge.from_jax_params``.)"""
    std = 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.empty(param.shape, dtype=torch.float32, device=param.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    param.copy_((x * std).to(param.dtype))


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + Q.fp(scale).float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] (int). Rotates pairs (d, d+D/2)."""
    d = x.shape[-1]
    half = d // 2
    freq = torch.exp(-math.log(theta)
                     * torch.arange(half, dtype=torch.float32, device=x.device)
                     / half)
    ang = positions.float()[:, :, None] * freq[None, None, :]  # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` over the last axis of ``x``: through ``xfer_matmul``, or
    through ``quant_matmul`` when ``w`` is an int8 :class:`QTensor`."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if Q.is_qtensor(w):
        out = ops.int8_matmul(x2, w.q, w.scale)
    else:
        out = ops.matmul(x2, w)
    return out.reshape(*lead, w.shape[1])


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: int = 0, causal: bool = True,
              kv_len: torch.Tensor = None,
              prefix_len: int = 0) -> torch.Tensor:
    """Prefill attention: q [B, S, H, D] at positions 0..S-1, k/v [B, T,
    G, D] at 0..T-1 -> [B, S, H, D]. ``causal`` (the reference's
    ``kp <= qp``), with ``prefix_len`` P > 0 the prefix-LM mask (keys
    below P visible to every query); ``window`` > 0 also masks keys
    ``window`` or more positions back (local attention); ``kv_len`` [B]
    int32 masks row b's keys at or past its length (the reference's
    ``kv_valid`` of a right-padded batch: the encoder, and with T != S
    the cross-attention; a row of length 0 gives 0). KV is broadcast
    across groups and heads are folded into the batch for
    ``flash_attention``."""
    b, s, h, d = q.shape
    g = k.shape[2]
    if g != h:
        k = k.repeat_interleave(h // g, dim=2)
        v = v.repeat_interleave(h // g, dim=2)

    def fold(t):
        return t.permute(0, 2, 1, 3).reshape(b * h, t.shape[1], d)

    o = ops.attention(fold(q), fold(k), fold(v), causal=causal, window=window,
                      kv_len=kv_len, prefix_len=prefix_len)
    return o.reshape(b, h, s, d).permute(0, 2, 1, 3)


def prefix_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pre: dict) -> torch.Tensor:
    """The compute-skip suffix prefill's attention: q [B, S, H, D] at
    positions ``pre_len + i`` over the gathered prefix ``pre`` (``pre_k``/
    ``pre_v`` [B, Lp, G, D], fp or int8 with ``pre_k_scale``/
    ``pre_v_scale`` [B, Lp, G, 1]; valid below ``pre["pre_len"]``), then
    the fresh suffix k/v [B, S, G, D], causally -> [B, S, H, D]. KV
    (and scales) are broadcast across groups and heads folded into the
    batch for ``flash_attention``'s prefix entry."""
    b, s, h, d = q.shape
    g = k.shape[2]

    def fold(t):
        if t.shape[2] != h:
            t = t.repeat_interleave(h // g, dim=2)
        return t.permute(0, 2, 1, 3).reshape(b * h, t.shape[1], t.shape[3])

    scales = {}
    if "pre_k_scale" in pre:
        scales = dict(pre_k_scale=fold(pre["pre_k_scale"]),
                      pre_v_scale=fold(pre["pre_v_scale"]))
    o = ops.prefix_attention(fold(q), fold(pre["pre_k"]), fold(pre["pre_v"]),
                             pre["pre_len"], fold(k), fold(v), **scales)
    return o.reshape(b, h, s, d).permute(0, 2, 1, 3)


def decode_attention(q: torch.Tensor, cache: dict, table: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Decode over the dense slot grid: q [B, S, H, D] at the positions
    ``p..p+S-1`` of each row (S = 1: one token; S > 1: the speculative
    draft-and-verify append, non-windowed grids only); the cache's grids
    ``k``/``v`` [B, T, G, D] (int8 with ``k_scale``/``v_scale`` [B, T, G,
    1] when quantised, one token per row) read as a page pool of B pages
    of T tokens through the identity ``table`` [B, 1]; ``lengths`` [B] =
    ``min(p + 1, T)``, and query j sees ``min(p + 1 + j, T)`` keys.
    Returns [B, S, H, D].

    Equal to the JAX grid mask (``pos >= 0``, ``kv_pos <= q_pos`` and,
    on a windowed ring, ``q_pos - kv_pos < window``). A non-windowed
    cache never wraps (``submit`` guarantees prompt + max_new <=
    max_len): grid index i holds position i, every index below the
    length is valid, every index at or past it is masked. A windowed
    ring of T = min(max_len, window) slots holds the newest position
    congruent to each index: before it wraps, index i holds position i
    as above; once it has wrapped, all T slots hold the last T
    positions, each inside the window, and the length is T. Softmax
    does not depend on the order of the slots. An append of S positions
    writes all of ``p..p+S-1`` (those below T) before the read, so query j
    sees every position up to its own: the reference's ``pos >= 0`` and
    ``kv_pos <= q_pos``."""
    s = q.shape[1]
    o = ops.paged_attn(q[:, 0] if s == 1 else q, cache["k"], cache["v"],
                       table, lengths, k_scale=cache.get("k_scale"),
                       v_scale=cache.get("v_scale"))
    return o[:, None] if s == 1 else o


def cross_decode_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """One decode query per row over its encoder positions: q [B, 1, H,
    D], k/v [B, T, G, D] (the encoder output's cross K/V), ``lengths``
    [B] int32 valid positions (``enc_len``; 0 on an inert slot gives 0)
    -> [B, 1, H, D]. ``paged_attention`` reads k/v as a pool of B pages
    of T positions through the identity table, as the dense slot grid
    is read."""
    b = q.shape[0]
    table = torch.arange(b, dtype=torch.int32, device=q.device)[:, None]
    return ops.paged_attn(q[:, 0], k, v, table, lengths)[:, None]


def mlp_act(kind: str):
    """The gate activation of a gated MLP: ``silu`` (SwiGLU) or the
    tanh-approximated ``gelu`` (GeGLU, as ``jax.nn.gelu(approximate=True)``)."""
    if kind == "swiglu":
        return F.silu
    if kind == "geglu":
        return lambda g: F.gelu(g, approximate="tanh")
    raise NotImplementedError(f"mlp {kind!r} is not ported yet")


def mlp_apply(p, x: torch.Tensor, kind: str) -> torch.Tensor:
    """SwiGLU or GeGLU gated MLP (``w_gate``, ``w_up``, ``w_down``), or the
    ungated squared-ReLU MLP ``relu2`` (``w_up``, ``w_down``):
    ``relu(x @ w_up)² @ w_down``."""
    if kind == "relu2":
        return dense(F.relu(dense(x, p.w_up)).square(), p.w_down)
    act = mlp_act(kind)
    g = dense(x, p.w_gate)
    u = dense(x, p.w_up)
    return dense(act(g) * u, p.w_down)


def embed_tokens(embed, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``embed`` [V, D]; an int8 :class:`QTensor` gives its rows
    times the per-column scale in fp32 (dequantise-then-take's values)."""
    if Q.is_qtensor(embed):
        return embed.q[tokens.long()].float() * embed.scale
    return F.embedding(tokens.long(), embed)


def unembed_logits(w, x: torch.Tensor) -> torch.Tensor:
    return dense(x, w)


def _chunk_loss(w: torch.Tensor, xc: torch.Tensor, yc: torch.Tensor,
                mc: torch.Tensor) -> torch.Tensor:
    """One chunk's summed masked cross-entropy: logits ``xc @ w`` through
    ``xfer_matmul``, cast to fp32, ``logsumexp - gold``."""
    logits = dense(xc, w).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, yc.long()[..., None])[..., 0]
    return torch.sum((lse - gold) * mc)


def cross_entropy_chunked(unembed_w: torch.Tensor, x: torch.Tensor,
                          labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy over the masked tokens of x [B, S, D] against
    ``labels`` [B, S], the logits computed ``chunk`` positions at a time
    (the largest divisor of S up to ``chunk``, as the reference searches
    it) so the [B, S, V] tensor never exists; with grad enabled each
    chunk is checkpointed, so backward keeps no [B, chunk, V] logits
    either. Divided by ``max(sum(mask), 1)``."""
    b, s, _ = x.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
    mask = mask.float()
    chunk = min(chunk, s)
    while s % chunk:
        chunk -= 1
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        args = (unembed_w, x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
                mask[:, c0:c0 + chunk])
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_loss, *args, use_reentrant=False)
        else:
            total = total + _chunk_loss(*args)
    return total / torch.clamp(mask.sum(), min=1.0)


def unembed_tied_int8(embed: Q.QTensor, x: torch.Tensor,
                      ones: torch.Tensor) -> torch.Tensor:
    """``x @ dequantize(embed).T`` for a per-column int8 ``embed`` [V, D]
    (scale [1, D]). Transposed, the scale lies on the contraction axis,
    where ``quant_matmul`` has no slot for it, so it scales ``x``
    instead: ``quant_matmul(x * s, q.T, ones)``, with ``q.T`` a strided
    view (no transposed copy) and ``ones`` [1, V]. Equal to the
    reference up to the fp32 summation order."""
    return dense(x * embed.scale.reshape(-1), Q.QTensor(embed.q.T, ones))
