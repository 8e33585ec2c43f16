"""Decoder-only LM of the dense family as an ``nn.Module``.

Mirrors ``repro/models/lm.py`` for ``family == "dense"``: ``forward``
(embedding scaled by sqrt(d_model), the block stack, the final norm),
``logits_fn`` (tied embeddings: ``embed.T``) and ``make_caches``. The
JAX package stacks the layers into a scanned ``body``; here they are a
``ModuleList`` (``bridge.from_jax_params`` unstacks a JAX tree), and the
caches are a list of per-layer dicts.

After ``quant.quantize_params`` the weight leaves are int8
:class:`~repro_torch.quant.QTensor` attributes in place of parameters
(``final_norm`` stays fp); the forward then computes in fp32, as the
reference's INT8 step does on its dequantised params.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from repro_torch import quant as Q
from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as B
from repro_torch.models import layers as L


def check_supported(arch: ArchConfig) -> None:
    if arch.family != "dense" or arch.block_pattern or arch.window:
        raise NotImplementedError(
            f"{arch.name}: family {arch.family!r} is not ported yet (the port "
            f"serves the dense decoder-only family)")


class LM(nn.Module):
    """Parameters named as the JAX tree: ``embed [V, D]``, ``final_norm``,
    ``unembed [D, V]`` when embeddings are untied, and ``layers.<i>.*``
    for the i-th entry of the JAX ``body`` stack."""

    def __init__(self, arch: ArchConfig, *, device: torch.device,
                 dtype: torch.dtype):
        super().__init__()
        check_supported(arch)
        self.arch = arch
        kw = dict(device=device, dtype=dtype)
        self.embed = B._param(arch.vocab_size, arch.d_model, **kw)
        self.final_norm = B._param(arch.d_model, **kw)
        if not arch.tie_embeddings:
            self.unembed = B._param(arch.d_model, arch.vocab_size, **kw)
        self.layers = nn.ModuleList(B.AttnBlock(arch, **kw)
                                    for _ in range(arch.num_layers))

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    @property
    def dtype(self) -> torch.dtype:
        """The fp parameters' dtype (``final_norm`` is never quantised)."""
        return self.final_norm.dtype

    @property
    def weights_quantized(self) -> bool:
        return Q.is_qtensor(self.embed)

    def init_(self, gen: torch.Generator) -> None:
        """Random weights with the JAX init's distribution
        (``lm.init_params``): embeddings scaled by 1/sqrt(d_model)."""
        L.dense_init_(self.embed, self.arch.d_model, gen)
        if not self.arch.tie_embeddings:
            L.dense_init_(self.unembed, self.arch.d_model, gen)
        for layer in self.layers:
            layer.init_(gen)

    def make_caches(self, batch: int, length: int,
                    dtype: Optional[torch.dtype] = None,
                    kv_quant: bool = False) -> List[dict]:
        return [B.make_kv_cache(self.arch, batch, length, device=self.device,
                                dtype=dtype or self.dtype, kv_quant=kv_quant)
                for _ in self.layers]

    def forward(self, tokens: torch.Tensor, *,
                caches: Optional[List[dict]] = None,
                positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[List[dict]]]:
        """tokens [B, S] -> (hidden [B, S, D] after the final norm, caches).

        With ``caches`` and S == 1 this is a decode step: each layer writes
        its token into its grid in place and attends over it. With
        ``caches`` and S > 1 it is a prefill that returns freshly filled
        caches. ``positions`` default to 0..S-1."""
        x = L.embed_tokens(self.embed, tokens)
        x = x * torch.tensor(self.arch.d_model ** 0.5, dtype=x.dtype)
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=x.device)[None].expand(b, s)
        decode_meta = None
        if caches is not None and s == 1:
            # the dense grid read as a page pool: row b is page b
            table = torch.arange(b, dtype=torch.int32, device=x.device)[:, None]
            decode_meta = (table, (positions[:, 0] + 1).to(torch.int32))
        new_caches = [] if caches is not None else None
        for i, layer in enumerate(self.layers):
            x, c = layer(x, positions=positions,
                         cache=None if caches is None else caches[i],
                         decode_meta=decode_meta)
            if caches is not None:
                new_caches.append(c)
        return L.rms_norm(x, self.final_norm), new_caches

    def unembed_matrix(self) -> torch.Tensor:
        return self.embed.T if self.arch.tie_embeddings else self.unembed

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """``logits_fn``: hidden [..., D] -> [..., V] through ``xfer_matmul``
        (the tied matrix is passed as the ``embed.T`` view, no copy), or
        ``quant_matmul`` for int8 weights."""
        if self.arch.tie_embeddings and self.weights_quantized:
            return L.unembed_tied_int8(self.embed, hidden, self.unembed_ones)
        return L.unembed_logits(self.unembed_matrix(), hidden)
