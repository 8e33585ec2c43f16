"""Attention block of the dense and hybrid families: pre-norm GQA/MQA
attention (causal, or local with a window) + a gated MLP (SwiGLU or
GeGLU) over a dense slot-grid KV cache.

Mirrors the dense and windowed branches of ``repro/models/blocks.py``:
``make_kv_cache`` (with ``window``: a ring of ``min(length, window)``
slots), ``_project_qkv`` (with the qkv bias), ``attn_apply``'s prefill
fills (the suffix fill, and ``_ring_exact_fill`` for a windowed prefill
with true lengths) and decode ring write (``_cache_write``). The paged,
append, cross-attention and MoE branches arrive with their slices.

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
from repro_torch.models import layers as L


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


def _param(*shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, device=device, dtype=dtype),
                        requires_grad=False)


class GatedMLP(nn.Module):
    """``w_gate``, ``w_up``, ``w_down`` of a SwiGLU or GeGLU MLP."""

    def __init__(self, d_model: int, d_ff: int, *, device, dtype):
        super().__init__()
        self.w_gate = _param(d_model, d_ff, device=device, dtype=dtype)
        self.w_up = _param(d_model, d_ff, device=device, dtype=dtype)
        self.w_down = _param(d_ff, d_model, device=device, dtype=dtype)


class AttnBlock(nn.Module):
    """Pre-norm self-attention + MLP. Weights in the JAX layout
    ``[d_in, d_out]``; parameter names mirror the JAX tree
    (``ln1, wq, wk, wv, wo, bq, bk, bv, ln2, mlp.{w_gate, w_up, w_down}``).
    ``arch.window`` > 0 (the hybrid family's) makes it a local-attention
    block over a ring cache."""

    def __init__(self, arch: ArchConfig, *, device, dtype):
        super().__init__()
        if arch.mlp not in ("swiglu", "geglu") or not arch.d_ff:
            raise NotImplementedError(f"{arch.name}: only attention blocks "
                                      f"with a SwiGLU or GeGLU MLP are ported")
        self.arch = arch
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
        self.ln2 = _param(d, **kw)
        self.mlp = GatedMLP(d, arch.d_ff, **kw)

    def init_(self, gen: torch.Generator) -> None:
        """Random weights with ``layers.dense_init``'s distribution; norms
        and biases stay zero, as in ``blocks.attn_init``."""
        for w in (self.wq, self.wk, self.wv, self.wo,
                  self.mlp.w_gate, self.mlp.w_up, self.mlp.w_down):
            L.dense_init_(w, w.shape[0], gen)

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

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                cache: Optional[dict] = None,
                decode_meta: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                seq_lens: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
        """Full mode (no cache, or a cache being filled by a prefill): x
        [B, S, D]; ``seq_lens`` [B], the true lengths of a right-padded
        batch, make a windowed block's fill ring-exact
        (:func:`_ring_exact_fill`). Decode mode (a cache and S == 1):
        ``decode_meta`` is the identity page table and lengths of
        :func:`layers.decode_attention`."""
        arch = self.arch
        b, s, _ = x.shape
        h = L.rms_norm(x, self.ln1)
        q, k, v = self._project_qkv(h)
        q = L.rope(q, positions, arch.rope_theta)
        k = L.rope(k, positions, arch.rope_theta)

        new_cache = None
        if cache is not None and s == 1:
            _cache_write(cache, k, v, positions)
            table, lengths = decode_meta
            o = L.decode_attention(q, cache, table, lengths)
            new_cache = cache
        else:
            o = L.attention(q, k, v, window=arch.window)
            if cache is not None and seq_lens is not None and arch.window:
                new_cache = _ring_exact_fill(cache, k, v, seq_lens)
            elif cache is not None:
                new_cache = _prefill_fill(cache, k, v, positions)
        x = x + L.dense(o.reshape(b, s, arch.q_dim), self.wo)
        x = x + L.mlp_apply(self.mlp, L.rms_norm(x, self.ln2), arch.mlp)
        return x, new_cache
