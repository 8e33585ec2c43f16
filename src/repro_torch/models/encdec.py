"""Encoder-decoder stack of the encdec family (seamless-m4t-medium's
backbone) as an ``nn.Module``.

Mirrors ``repro/models/encdec.py``: ``init_params`` (``embed``, the
``enc_body`` and ``dec_body`` stacks, ``enc_norm``, ``final_norm``,
an untied ``unembed``), ``make_caches`` (the decoder's KV grid only:
the encoder output is no cache row, it rides in the serving state),
``encode`` and ``decode``. The audio frontend is a stub in the
reference too: the encoder takes precomputed frame embeddings ``frames
[B, S_src, D]``.

The encoder is ``enc_layers`` attention blocks (``blocks.AttnBlock``)
attending bidirectionally: RoPE over frame positions 0..S_src-1, keys at
or past a row's frame count ``enc_lens`` masked (``flash_attention``'s
non-causal form with per-row lengths), then ``enc_norm``. So a valid
position's output does not depend on the padding of its batch, which
lets requests of different source lengths share one padded encoder call.
The decoder is ``dec_layers`` blocks with cross-attention
(``AttnBlock(cross=True)``): the token embedding scaled by sqrt(d_model),
causal self-attention over its KV grid, cross-attention over the encoder
output (its K/V projected on every call, as the reference recomputes
them; keys past ``enc_lens`` masked), the MLP; then ``final_norm``.
JAX's stacked ``enc_body``/``dec_body`` are ``ModuleList``s here,
``enc_layers.<i>`` and ``dec_layers.<i>`` (``bridge.from_jax_params``
unstacks a JAX tree).

Training (:func:`loss_fn`, the reference's ``ED.loss_fn``): the encoder
and the decoder with every layer rematerialised (``remat=True``), then
``cross_entropy_chunked`` over ``unembed``; no ``enc_lens`` (the
training frames fill their rows), so the encoder's bidirectional
attention and the decoder's cross-attention are ``flash_attention``'s
non-causal form without lengths, whose gradient is
``flash_attention_bwd``'s.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import quant as Q
from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.lm import _scale_in, check_supported, check_trainable


class EncDec(nn.Module):
    """Parameters named as the JAX tree: ``embed [V, D]``, ``enc_norm``,
    ``final_norm``, ``unembed [D, V]``, ``enc_layers.<i>.*`` (the JAX
    ``enc_body`` stack's entries) and ``dec_layers.<i>.*`` (``dec_body``'s,
    with the cross-attention leaves ``ln_x, xwq, xwk, xwv, xwo``)."""

    def __init__(self, arch: ArchConfig, *, device: torch.device,
                 dtype: torch.dtype):
        super().__init__()
        check_supported(arch)
        if arch.family != "encdec":
            raise ValueError(f"{arch.name}: EncDec serves the encdec family, "
                             f"not {arch.family!r}")
        self.arch = arch
        kw = dict(device=device, dtype=dtype)
        self.embed = B._param(arch.vocab_size, arch.d_model, **kw)
        self.enc_norm = B._param(arch.d_model, **kw)
        self.final_norm = B._param(arch.d_model, **kw)
        self.unembed = B._param(arch.d_model, arch.vocab_size, **kw)
        self.enc_layers = nn.ModuleList(
            B.AttnBlock(arch, **kw) for _ in range(arch.enc_layers))
        self.dec_layers = nn.ModuleList(
            B.AttnBlock(arch, cross=True, **kw) for _ in range(arch.dec_layers))

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    @property
    def dtype(self) -> torch.dtype:
        return self.final_norm.dtype

    @property
    def weights_quantized(self) -> bool:
        return Q.is_qtensor(self.embed)

    def init_(self, gen: torch.Generator) -> None:
        """Random weights with the JAX init's distribution
        (``encdec.init_params``): the embedding scaled by 1/sqrt(d_model),
        the unembedding by 1/sqrt(d_model) over its rows; norms zero."""
        L.dense_init_(self.embed, self.arch.d_model, gen)
        L.dense_init_(self.unembed, self.arch.d_model, gen)
        for layer in (*self.enc_layers, *self.dec_layers):
            layer.init_(gen)

    def make_caches(self, batch: int, length: int,
                    dtype: Optional[torch.dtype] = None,
                    kv_quant: bool = False) -> List[dict]:
        """The decoder's KV grid: one cache of ``length`` slots per
        decoder layer."""
        return [B.make_kv_cache(self.arch, batch, length, device=self.device,
                                dtype=dtype or self.dtype, kv_quant=kv_quant)
                for _ in self.dec_layers]

    def encode(self, frames: torch.Tensor,
               enc_lens: Optional[torch.Tensor] = None, *,
               remat: bool = False) -> torch.Tensor:
        """frames [B, S_src, D] -> the encoder output [B, S_src, D] in the
        model's dtype, or in fp32 under int8 weights (the reference's
        INT8 step encodes its fp32 frames with fp32 dequantised params;
        serving casts the output to the state's ``enc_out`` dtype where
        it writes it). ``enc_lens`` [B]: the true frame count of each
        row of a right-padded batch; keys at or past it are masked, so a
        valid position's output equals the unpadded row's. ``remat=True``
        (training): each layer under ``torch.utils.checkpoint``, as
        ``LM.forward`` runs its layers."""
        x = frames.to(torch.float32 if self.weights_quantized else self.dtype)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
        for layer in self.enc_layers:
            if remat and torch.is_grad_enabled():
                x, _ = checkpoint(layer, x, positions=positions, causal=False,
                                  seq_lens=enc_lens, use_reentrant=False)
            else:
                x, _ = layer(x, positions=positions, causal=False,
                             seq_lens=enc_lens)
        return L.rms_norm(x, self.enc_norm)

    def forward(self, tokens: torch.Tensor, enc_out: torch.Tensor, *,
                caches: Optional[List[dict]] = None,
                positions: Optional[torch.Tensor] = None,
                enc_lens: Optional[torch.Tensor] = None,
                remat: bool = False
                ) -> Tuple[torch.Tensor, Optional[List[dict]]]:
        """``decode``: tokens [B, S] against ``enc_out`` [B, T, D] ->
        (hidden [B, S, D] after the final norm, caches). ``enc_lens``
        [B] masks each row's encoder positions at or past it out of every
        cross-attention (0: an inert slot, whose cross-attention gives
        0). With ``caches`` and S == 1 a decode step: each layer writes
        its token into its grid in place and attends over it, and
        ``caches`` itself is returned; with ``caches`` and S > 1 a prefill
        that returns freshly filled caches. ``positions`` default to
        0..S-1. ``remat=True`` (training, no caches): each layer under
        ``torch.utils.checkpoint``."""
        x = L.embed_tokens(self.embed, tokens)
        x = x * _scale_in(self.arch.d_model ** 0.5, x.dtype)
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=x.device)[None].expand(b, s)
        decode_meta = None
        in_place = caches is not None and s == 1
        if in_place:  # the grid read as a page pool, as in LM.forward
            t = caches[0]["k"].shape[1]
            table = torch.arange(b, dtype=torch.int32, device=x.device)[:, None]
            decode_meta = (table, torch.clamp(positions[:, 0] + 1,
                                              max=t).to(torch.int32))
        enc = enc_out.to(x.dtype)
        new_caches = [] if caches is not None else None
        for i, layer in enumerate(self.dec_layers):
            if remat and caches is None and torch.is_grad_enabled():
                x, c = checkpoint(layer, x, positions=positions, enc=enc,
                                  enc_lens=enc_lens, use_reentrant=False)
                continue
            x, c = layer(x, positions=positions,
                         cache=None if caches is None else caches[i],
                         decode_meta=decode_meta, enc=enc, enc_lens=enc_lens)
            if caches is not None:
                new_caches.append(c)
        if in_place:
            new_caches = caches
        return L.rms_norm(x, self.final_norm), new_caches

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """``hidden @ unembed`` through ``xfer_matmul`` (``quant_matmul``
        for int8 weights)."""
        return L.unembed_logits(self.unembed, hidden)


def loss_fn(model: EncDec, frames: torch.Tensor, tokens: torch.Tensor,
            labels: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
            chunk: int = 512) -> torch.Tensor:
    """The reference's ``encdec.loss_fn``: ``frames`` [B, S_src, D]
    encoded with every layer rematerialised, ``tokens`` [B, S] decoded
    against the output the same way, then ``cross_entropy_chunked`` of
    ``labels`` [B, S] over ``unembed`` (``mask`` [B, S]; None: every
    token)."""
    check_trainable(model.arch)
    enc_out = model.encode(frames, remat=True)
    hidden, _ = model(tokens, enc_out, remat=True)
    return L.cross_entropy_chunked(model.unembed, hidden, labels, mask=mask,
                                   chunk=chunk)
