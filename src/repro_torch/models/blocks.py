"""Attention block of the dense, MoE, hybrid, vlm and encdec families:
pre-norm GQA/MQA attention (causal, local with a window, prefix-LM, or
bidirectional over right-padded frames) + an MLP (gated SwiGLU or GeGLU,
the ungated squared-ReLU ``relu2``, or the MoE family's capacity-routed
experts, ``models/moe.py``) over a dense slot-grid KV cache; the
encoder-decoder's decoder block adds cross-attention over the encoder
output between the two.

Mirrors the dense and windowed branches of ``repro/models/blocks.py``:
``make_kv_cache`` (with ``window``: a ring of ``min(length, window)``
slots), ``_project_qkv`` (with the qkv bias), ``attn_apply``'s prefill
fills (the suffix fill, and ``_ring_exact_fill`` for a windowed prefill
with true lengths), decode ring write (``_cache_write``), the append
write of S >= 1 fresh positions (``_cache_write_many``, the speculative
draft and verify) and the two paged branches
(``_paged_decode_attention``, S >= 1; ``_shared_prefix_attention``; see
``serving/pages.py``), the MoE MLP (``moe_apply``), the prefill masks
of ``attn_apply`` (``causal=False`` with ``seq_lens``: the encoder's
``kv_valid_in``; ``prefix_len``: the prefix-LM) and the cross-attention
branch (``cross_attn_apply``: RMSNorm ``ln_x``, ``xwq`` on x, ``xwk``/
``xwv`` on the encoder output recomputed every call, no RoPE, keys past
``enc_lens`` masked).

A cache is a dict ``{"k", "v": [B, T, G, D], "pos": [B, T] int32}``
(``pos = -1`` marks an invalid entry). With ``kv_quant`` ``k``/``v`` are
int8 and two more leaves ``k_scale``/``v_scale`` ``[B, T, G, 1]`` f32
hold one scale per token per kv group; fresh fp K/V are quantised where
they are written (the decode write and the prefill fill), and decode
runs the int8 body of ``paged_attention`` over the grid. Prefill attends
over the fresh fp K/V. Decode writes into a cache in place, where the
JAX package returns a new tree; the JAX ``count`` leaf is not kept
because nothing reads it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch import quant as Q
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as M


def make_kv_cache(arch: ArchConfig, batch: int, length: int, *,
                  device: torch.device, dtype: torch.dtype,
                  window: int = 0, kv_quant: bool = False) -> dict:
    """A grid of ``t = min(length, window)`` slots per row when
    ``window`` > 0 (a ring), else ``length``."""
    t = min(length, window) if window else length
    g, d = arch.num_kv_heads, arch.head_dim
    kv_dtype = torch.int8 if kv_quant else dtype
    cache = {
        "k": torch.zeros((batch, t, g, d), dtype=kv_dtype, device=device),
        "v": torch.zeros((batch, t, g, d), dtype=kv_dtype, device=device),
        "pos": torch.full((batch, t), -1, dtype=torch.int32, device=device),
    }
    if kv_quant:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros((batch, t, g, 1),
                                      dtype=torch.float32, device=device)
    return cache


def _kv_leaves(cache: dict, k: torch.Tensor, v: torch.Tensor):
    """Fresh fp K/V as the cache's storage leaves, ``[(name, value)]``:
    cast to the cache dtype, or int8 payloads and per-token scales for a
    quantised cache. Per-token quantisation commutes with slicing and
    padding along the length axis, so the fills quantise first."""
    if "k_scale" not in cache:
        return [("k", k.to(cache["k"].dtype)), ("v", v.to(cache["v"].dtype))]
    kq, vq = Q.quantize_kv(k), Q.quantize_kv(v)
    return [("k", kq.q), ("k_scale", kq.scale),
            ("v", vq.q), ("v_scale", vq.scale)]


def _cache_write(cache: dict, k_new, v_new, pos_new) -> None:
    """Ring-buffer write of one decode token per row, in place: slot =
    position mod cache length, per batch row."""
    t = cache["k"].shape[1]
    rows = torch.arange(k_new.shape[0], device=k_new.device)
    slot = (pos_new[:, 0] % t).long()
    for name, u in _kv_leaves(cache, k_new[:, 0], v_new[:, 0]):
        cache[name][rows, slot] = u
    cache["pos"][rows, slot] = pos_new[:, 0].to(torch.int32)


def _cache_write_many(cache: dict, k_new, v_new, pos_new) -> None:
    """Append-mode write of S >= 1 tokens per row (the speculative draft
    and verify), in place: the slot is the position itself (a
    non-windowed grid, no wrap), and a write at a position at or past the
    grid's T slots is dropped (the reference's ``mode="drop"``).

    One scatter per leaf, with no duplicate index holding two values:
    the positions of a row are the contiguous ``p..p+S-1``, so the
    dropped ones are a suffix, and each is sent to slot T - 1 with the
    value that the row's write at T - 1 stores there (its own old value
    when the whole row is past the grid)."""
    t = cache["k"].shape[1]
    b, s = pos_new.shape
    dev = pos_new.device
    rows = torch.arange(b, device=dev)[:, None]
    pos = pos_new.long()
    first = pos[:, :1]
    # entry j writes u[jj] at idx: itself while in range, else the
    # row's last in-range entry (j = T - 1 - p) again
    jj = torch.minimum(torch.arange(s, device=dev)[None],
                       (t - 1 - first).clamp(0, s - 1))
    idx = pos.clamp(max=t - 1)
    inside = first < t  # [B, 1]: some entry of the row is in range
    leaves = _kv_leaves(cache, k_new, v_new) + [("pos", pos_new.to(torch.int32))]
    for name, u in leaves:
        src = u[rows, jj]
        keep = inside.reshape((b, 1) + (1,) * (src.dim() - 2))
        cache[name][rows, idx] = torch.where(keep, src, cache[name][rows, idx])


def _prefill_fill(cache: dict, k, v, positions) -> dict:
    """The prefill's cache: the last T positions when S >= T, else the S
    positions padded to T (k/v and scales zeros, pos -1)."""
    t = cache["k"].shape[1]
    s = k.shape[1]
    leaves = _kv_leaves(cache, k, v)
    if s >= t:  # own copies: decode writes into them in place
        out = {name: u[:, -t:].contiguous() for name, u in leaves}
        out["pos"] = positions[:, -t:].to(torch.int32).contiguous()
        return out
    out = {}
    for name, u in leaves:
        out[name] = torch.zeros_like(cache[name])
        out[name][:, :s] = u
    out["pos"] = torch.full_like(cache["pos"], -1)
    out["pos"][:, :s] = positions.to(torch.int32)
    return out


def _ring_exact_fill(cache: dict, k, v, seq_lens: torch.Tensor) -> dict:
    """Length-exact prefill fill of a (windowed) ring of ``t`` slots:
    index i holds the newest position ``p ≡ i (mod t)`` below the row's
    true length, i.e. the last ``min(len, t)`` positions of the unpadded
    prompt (``pos`` -1 where ``p < 0``), whatever the padded length."""
    t = cache["k"].shape[1]
    s = k.shape[1]
    ring = torch.arange(t, device=k.device)[None, :]
    last = seq_lens.to(k.device).long()[:, None] - 1
    pos = last - torch.remainder(last - ring, t)  # [B, t], pos ≡ ring (mod t)
    idx = pos.clamp(0, s - 1)
    out = {}
    for name, u in _kv_leaves(cache, k, v):
        ix = idx[:, :, None, None].expand(-1, -1, *u.shape[2:])
        out[name] = torch.gather(u, 1, ix)
    out["pos"] = torch.where(pos >= 0, pos, -1).to(torch.int32)
    return out


def _paged_decode_attention(q, k, v, pool: dict, page_table: torch.Tensor,
                            positions: torch.Tensor) -> torch.Tensor:
    """S >= 1 decode tokens per row (S > 1: the speculative verify of the
    contiguous positions ``p..p+S-1``) against a page pool ``{"kp",
    "vp"[, "kps", "vps"]}``, in place: write the new K/V (quantised for
    an int8 pool) at ``page_table[pos // ps], pos % ps`` (a position past
    the table goes to the null page), then attend through the table, the
    query at ``p + j`` over ``min(p + 1 + j, M·ps)`` keys (positions past
    a row's reserved pages read the null page: such tokens are past the
    budget and never committed). Inactive slots carry a zeroed table row
    (the serve step's stale-write gate), so their writes land on the
    null page."""
    ps = pool["kp"].shape[1]
    m = page_table.shape[1]
    s = positions.shape[1]
    pos = positions.long()
    page = torch.gather(page_table.long(), 1, (pos // ps).clamp(0, m - 1))
    page = torch.where(pos < m * ps, page, 0)
    slot = pos % ps
    if "kps" in pool:
        kq, vq = Q.quantize_kv(k), Q.quantize_kv(v)
        leaves = (("kp", kq.q), ("kps", kq.scale), ("vp", vq.q),
                  ("vps", vq.scale))
    else:
        leaves = (("kp", k), ("vp", v))
    for name, u in leaves:
        pool[name][page, slot] = u.to(pool[name].dtype)
    lengths = torch.clamp(positions[:, 0] + 1, max=m * ps).to(torch.int32)
    o = ops.paged_attn(q[:, 0] if s == 1 else q, pool["kp"], pool["vp"],
                       page_table.to(torch.int32), lengths,
                       k_scale=pool.get("kps"), v_scale=pool.get("vps"))
    return o[:, None] if s == 1 else o


def _param(*shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, device=device, dtype=dtype),
                        requires_grad=False)


class MLP(nn.Module):
    """``w_gate``, ``w_up``, ``w_down`` of a SwiGLU or GeGLU MLP, or
    ``w_up``, ``w_down`` of the ungated ``relu2`` one; with ``experts``
    each is stacked ``[E, d_in, d_out]`` (the MoE layer's routed
    experts)."""

    def __init__(self, d_model: int, d_ff: int, kind: str, *, device, dtype,
                 experts: int = 0):
        super().__init__()
        lead = (experts,) if experts else ()
        kw = dict(device=device, dtype=dtype)
        if kind != "relu2":
            self.w_gate = _param(*lead, d_model, d_ff, **kw)
        self.w_up = _param(*lead, d_model, d_ff, **kw)
        self.w_down = _param(*lead, d_ff, d_model, **kw)

    def init_(self, gen: torch.Generator) -> None:
        """``layers.dense_init``'s distribution over each matrix's d_in."""
        for w in self.parameters():
            L.dense_init_(w, w.shape[-2], gen)


class AttnBlock(nn.Module):
    """Pre-norm self-attention + MLP. Weights in the JAX layout
    ``[d_in, d_out]``; parameter names mirror the JAX tree
    (``ln1, wq, wk, wv, wo, bq, bk, bv, ln2, mlp.{w_gate, w_up, w_down}``;
    ``relu2``: ``mlp.{w_up, w_down}``). ``arch.window`` > 0 (the hybrid
    family's) makes it a local-attention block over a ring cache.
    ``moe=True`` (the MoE family past its dense prefix layers) replaces
    ``mlp`` by ``router [D, E]``, the routed experts ``moe.*`` ``[E, D,
    F]`` / ``[E, F, D]`` (F = ``moe_d_ff``) and, with shared experts,
    ``shared.*`` of width ``moe_d_ff · num_shared_experts``.
    ``cross=True`` (the encoder-decoder's decoder layers) adds the
    cross-attention leaves ``ln_x, xwq, xwk, xwv, xwo``."""

    def __init__(self, arch: ArchConfig, *, device, dtype, moe: bool = False,
                 cross: bool = False):
        super().__init__()
        if arch.mlp not in ("swiglu", "geglu", "relu2") or not arch.d_ff:
            raise NotImplementedError(f"{arch.name}: only attention blocks "
                                      f"with an MLP (SwiGLU, GeGLU or relu2) "
                                      f"are ported")
        self.arch = arch
        self.is_moe = moe
        d, qd, kvd = arch.d_model, arch.q_dim, arch.kv_dim
        kw = dict(device=device, dtype=dtype)
        self.ln1 = _param(d, **kw)
        self.wq = _param(d, qd, **kw)
        self.wk = _param(d, kvd, **kw)
        self.wv = _param(d, kvd, **kw)
        self.wo = _param(qd, d, **kw)
        if arch.qkv_bias:
            self.bq = _param(qd, **kw)
            self.bk = _param(kvd, **kw)
            self.bv = _param(kvd, **kw)
        self.is_cross = cross
        if cross:
            self.ln_x = _param(d, **kw)
            self.xwq = _param(d, qd, **kw)
            self.xwk = _param(d, kvd, **kw)
            self.xwv = _param(d, kvd, **kw)
            self.xwo = _param(qd, d, **kw)
        self.ln2 = _param(d, **kw)
        if not moe:
            self.mlp = MLP(d, arch.d_ff, arch.mlp, **kw)
            return
        ff = arch.moe_d_ff or arch.d_ff
        self.router = _param(d, arch.num_experts, **kw)
        self.moe = MLP(d, ff, arch.mlp, experts=arch.num_experts, **kw)
        if arch.num_shared_experts:
            self.shared = MLP(d, ff * arch.num_shared_experts, arch.mlp, **kw)

    def init_(self, gen: torch.Generator) -> None:
        """Random weights with ``layers.dense_init``'s distribution; norms
        and biases stay zero, as in ``blocks.attn_init``."""
        cross = (self.xwq, self.xwk, self.xwv, self.xwo) if self.is_cross \
            else ()
        for w in (self.wq, self.wk, self.wv, self.wo) + cross:
            L.dense_init_(w, w.shape[0], gen)
        if self.is_moe:
            L.dense_init_(self.router, self.router.shape[0], gen)
        for name in ("mlp", "moe", "shared"):
            if hasattr(self, name):
                getattr(self, name).init_(gen)

    def _project_qkv(self, h: torch.Tensor):
        arch = self.arch
        b, s, _ = h.shape
        q = L.dense(h, self.wq)
        k = L.dense(h, self.wk)
        v = L.dense(h, self.wv)
        if arch.qkv_bias:
            q = q + Q.fp(self.bq)
            k = k + Q.fp(self.bk)
            v = v + Q.fp(self.bv)
        return (q.reshape(b, s, arch.num_heads, arch.head_dim),
                k.reshape(b, s, arch.num_kv_heads, arch.head_dim),
                v.reshape(b, s, arch.num_kv_heads, arch.head_dim))

    def cross_attend(self, x: torch.Tensor, enc: torch.Tensor,
                     enc_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``cross_attn_apply``: x [B, S, D] attends the encoder output
        ``enc`` [B, T, D] (K/V projected here, every call, as the
        reference does), keys at or past ``enc_lens`` [B] int32 masked,
        no RoPE; returns x plus the projected result. S > 1 (a prefill)
        goes through ``flash_attention``'s non-causal form with per-row
        lengths, S == 1 (decode) through ``paged_attention`` over the
        encoder positions."""
        arch = self.arch
        b, s, _ = x.shape
        t = enc.shape[1]
        h = L.rms_norm(x, self.ln_x)
        q = L.dense(h, self.xwq).reshape(b, s, arch.num_heads, arch.head_dim)
        k = L.dense(enc, self.xwk).reshape(b, t, arch.num_kv_heads,
                                           arch.head_dim)
        v = L.dense(enc, self.xwv).reshape(b, t, arch.num_kv_heads,
                                           arch.head_dim)
        if enc_lens is not None:
            enc_lens = enc_lens.to(torch.int32)
        if s == 1:
            if enc_lens is None:
                enc_lens = torch.full((b,), t, dtype=torch.int32,
                                      device=x.device)
            o = L.cross_decode_attention(q, k, v, enc_lens)
        else:
            o = L.attention(q, k, v, causal=False, kv_len=enc_lens)
        return x + L.dense(o.reshape(b, s, arch.q_dim), self.xwo)

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                cache: Optional[dict] = None,
                decode_meta: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                seq_lens: Optional[torch.Tensor] = None,
                page_table: Optional[torch.Tensor] = None,
                append: bool = False, causal: bool = True,
                prefix_len: int = 0, enc: Optional[torch.Tensor] = None,
                enc_lens: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
        """Full mode (no cache, or a cache being filled by a prefill): x
        [B, S, D]; ``seq_lens`` [B], the true lengths of a right-padded
        batch, make a windowed block's fill ring-exact
        (:func:`_ring_exact_fill`) and, with ``causal=False`` (the
        encoder), mask the keys at or past them. ``prefix_len`` P > 0
        (the vlm family's patch prefix) makes the prefill's causal mask
        the prefix-LM one; a decode token lies past the prefix, where it
        changes nothing. ``enc`` [B, T, D] (the encoder-decoder's
        decoder layers): cross-attention over it after self-attention
        (:meth:`cross_attend`, keys past ``enc_lens`` masked). Decode
        mode (a cache and S == 1):
        ``decode_meta`` is the identity page table and lengths of
        :func:`layers.decode_attention`. ``append=True`` (speculative
        decoding, non-windowed grids) treats a filled cache as the target
        of S >= 1 fresh positions per row: they are written at their
        positions (:func:`_cache_write_many`) and attended like decode
        tokens, each causally over the grid.

        Paged modes, keyed by the cache's leaves as in the JAX
        ``attn_apply``: a pool ``{"kp", "vp"[, "kps", "vps"]}`` with
        ``page_table`` [B, M] int32 is a paged decode step (the pool is
        written in place and returned); a gathered prefix ``{"pre_k",
        "pre_v", "pre_len"[, "pre_k_scale", "pre_v_scale"]}`` is the
        compute-skip suffix prefill, whose returned cache is the suffix's
        fp row ``{"k", "v", "pos"}`` that the scheduler splices into
        pages."""
        arch = self.arch
        b, s, _ = x.shape
        h = L.rms_norm(x, self.ln1)
        q, k, v = self._project_qkv(h)
        q = L.rope(q, positions, arch.rope_theta)
        k = L.rope(k, positions, arch.rope_theta)

        new_cache = None
        if cache is not None and "kp" in cache:
            if page_table is None:
                raise ValueError("paged KV pool given without a page_table")
            o = _paged_decode_attention(q, k, v, cache, page_table, positions)
            new_cache = cache
        elif cache is not None and "pre_k" in cache:
            o = L.prefix_attention(q, k, v, cache)
            new_cache = {"k": k, "v": v, "pos": positions.to(torch.int32)}
        elif cache is not None and (s == 1 or append):
            if append:
                _cache_write_many(cache, k, v, positions)
            else:
                _cache_write(cache, k, v, positions)
            table, lengths = decode_meta
            o = L.decode_attention(q, cache, table, lengths)
            new_cache = cache
        else:
            kv_len = (seq_lens.to(torch.int32) if not causal and s > 1
                      and seq_lens is not None else None)
            o = L.attention(q, k, v, window=arch.window, causal=causal,
                            kv_len=kv_len, prefix_len=prefix_len)
            if cache is not None and seq_lens is not None and arch.window:
                new_cache = _ring_exact_fill(cache, k, v, seq_lens)
            elif cache is not None:
                new_cache = _prefill_fill(cache, k, v, positions)
        x = x + L.dense(o.reshape(b, s, arch.q_dim), self.wo)
        if enc is not None:
            x = self.cross_attend(x, enc, enc_lens)
        h = L.rms_norm(x, self.ln2)
        if self.is_moe:
            x = x + M.moe_apply(arch, self, h)
        else:
            x = x + L.mlp_apply(self.mlp, h, arch.mlp)
        return x, new_cache
