"""Decoder-only LM of the dense, MoE, hybrid and ssm families as an
``nn.Module``.

Mirrors ``repro/models/lm.py`` for ``family in ("dense", "moe",
"hybrid", "ssm")``: ``forward`` (embedding scaled by sqrt(d_model), the
block stack, the final norm), ``logits_fn`` (tied embeddings:
``embed.T``) and ``make_caches``. The JAX package keeps unrolled
``prefix`` layers (the MoE family's ``first_dense_layers``: attention
blocks with a dense MLP), stacks the block pattern's layers into a
scanned ``body`` of ``repeats`` copies and keeps unrolled ``suffix``
blocks (``stack_structure``; deepseek-moe-16b's 28 layers are one dense
prefix layer + 27 MoE attention blocks, recurrentgemma-2b's 26 are 8 x
(rglru, rglru, attn) + (rglru, rglru)); here they are one
``ModuleList`` in layer order: the prefix layers, then layer
``n_prefix + i`` of kind ``pattern[i % len(pattern)]``
(``bridge.from_jax_params`` unstacks a JAX tree), and the caches are a
list of per-layer dicts: a KV grid for an attention block (a ring of
``min(length, window)`` slots in the hybrid family), an RG-LRU, mLSTM
or sLSTM state for a recurrent one.

After ``quant.quantize_params`` the weight leaves are int8
:class:`~repro_torch.quant.QTensor` attributes in place of parameters
(``final_norm`` stays fp); the forward then computes in fp32, as the
reference's INT8 step does on its dequantised params.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch
from torch import nn

from repro_torch import quant as Q
from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R


#: the block module of each kind a pattern may name
BLOCK_KINDS = {"attn": B.AttnBlock, "rglru": R.RGLRUBlock,
               "mlstm": R.MLSTMBlock, "slstm": R.SLSTMBlock}


def check_supported(arch: ArchConfig) -> None:
    dense = arch.family in ("dense", "moe") and not arch.window \
        and tuple(arch.block_pattern) in ((), ("attn",))
    hybrid = arch.family == "hybrid" \
        and set(arch.block_pattern) <= {"attn", "rglru"}
    ssm = arch.family == "ssm" and not arch.window \
        and tuple(arch.block_pattern) == ("mlstm", "slstm")
    if not (dense or hybrid or ssm):
        raise NotImplementedError(
            f"{arch.name}: family {arch.family!r} is not ported yet (the port "
            f"serves the dense family, the MoE family, the RG-LRU hybrid "
            f"family and the xLSTM ssm family)")


def pattern(arch: ArchConfig) -> Tuple[str, ...]:
    return arch.block_pattern or ("attn",)


def n_prefix(arch: ArchConfig) -> int:
    """The leading dense-MLP attention layers of an MoE stack."""
    return arch.first_dense_layers if arch.family == "moe" else 0


def stack_structure(arch: ArchConfig) -> Tuple[List[str], int, List[str]]:
    """(prefix kinds, body repeats, suffix kinds), as the JAX
    ``stack_structure``."""
    pat = pattern(arch)
    prefix = ["attn"] * n_prefix(arch)
    repeats, rem = divmod(arch.num_layers - len(prefix), len(pat))
    return prefix, repeats, list(pat[:rem])


def layer_kinds(arch: ArchConfig) -> List[str]:
    """The kind of each layer in order: the prefix layers, then body
    repeat r, position j as layer ``n_prefix + r * len(pattern) + j``;
    the suffix blocks follow."""
    pat = pattern(arch)
    p = n_prefix(arch)
    return ["attn"] * p + [pat[i % len(pat)]
                           for i in range(arch.num_layers - p)]


@functools.lru_cache(maxsize=None)
def _scale_in(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float."""
    return float(torch.tensor(value, dtype=dtype))


class LM(nn.Module):
    """Parameters named as the JAX tree: ``embed [V, D]``, ``final_norm``,
    ``unembed [D, V]`` when embeddings are untied, and ``layers.<i>.*``
    for the i-th layer (the JAX ``prefix{i}``, then the ``body`` stack's
    entries, then ``suffix{i}``); in the MoE family every attention
    layer past the prefix is an MoE block."""

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
        self.kinds = layer_kinds(arch)
        p = n_prefix(arch)

        def block(i, kind):
            if kind == "attn" and arch.family == "moe":
                return B.AttnBlock(arch, moe=i >= p, **kw)
            return BLOCK_KINDS[kind](arch, **kw)

        self.layers = nn.ModuleList(block(i, kind)
                                    for i, kind in enumerate(self.kinds))

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
        """One cache per layer: a KV grid of ``length`` slots (a ring of
        ``min(length, window)`` in the hybrid family), an RG-LRU state,
        or an mLSTM or sLSTM state (f32 whatever ``dtype``)."""
        kw = dict(device=self.device, dtype=dtype or self.dtype)

        def cache(kind):
            if kind == "attn":
                return B.make_kv_cache(self.arch, batch, length,
                                       window=self.arch.window,
                                       kv_quant=kv_quant, **kw)
            if kind == "rglru":
                return R.make_rglru_state(self.arch, batch, **kw)
            make = R.make_mlstm_state if kind == "mlstm" else R.make_slstm_state
            return make(self.arch, batch, device=self.device)

        return [cache(kind) for kind in self.kinds]

    def forward(self, tokens: torch.Tensor, *,
                caches: Optional[List[dict]] = None,
                positions: Optional[torch.Tensor] = None,
                seq_lens: Optional[torch.Tensor] = None,
                page_table: Optional[torch.Tensor] = None,
                append: bool = False
                ) -> Tuple[torch.Tensor, Optional[List[dict]]]:
        """tokens [B, S] -> (hidden [B, S, D] after the final norm, caches).

        With ``caches`` and S == 1 this is a decode step: each attention
        layer writes its token into its grid in place and attends over it,
        each recurrent layer steps its state in place, and ``caches``
        itself is returned, every leaf at its address. With ``caches`` and S > 1 it
        is a prefill that returns freshly filled caches. ``positions``
        default to 0..S-1. ``seq_lens`` [B] (the true lengths of a
        right-padded prefill) make the recurrent states and windowed
        rings length-exact.

        ``page_table`` [B, M] int32: a paged decode step of S >= 1 tokens
        per row, ``caches`` then being the page pools of
        ``serving.pages.make_paged_caches`` shared by every slot. ``caches``
        may also be the gathered prefix blocks of
        ``serving.pages.gather_prefix``: a suffix prefill at ``positions``
        past the prefix, returning the suffix's fp rows.

        ``append=True`` (speculative decoding; the dense family, no
        window): S >= 1 fresh tokens per row at ``positions`` on filled
        caches, written in place at their positions (those past the grid
        dropped) and attended causally over the grid or, with
        ``page_table``, the pool; ``caches`` itself is returned."""
        x = L.embed_tokens(self.embed, tokens)
        # sqrt(d_model) rounded to the activation dtype, as a Python
        # float: the same product as a 0-dim tensor of that dtype, with
        # no host tensor in the step
        x = x * _scale_in(self.arch.d_model ** 0.5, x.dtype)
        b, s, _ = x.shape
        if append and (caches is None or self.arch.family != "dense"
                       or self.arch.window):
            raise ValueError("append=True needs the caches of a dense, "
                             "non-windowed LM")
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=x.device)[None].expand(b, s)
        decode_meta = None
        in_place = caches is not None and (s == 1 or append)
        if in_place and "attn" in self.kinds and page_table is None:
            # the dense grid read as a page pool: row b is page b; on a
            # ring of t slots the valid length stops growing at t (and an
            # append's first query sees at most the t slots)
            t = caches[self.kinds.index("attn")]["k"].shape[1]
            table = torch.arange(b, dtype=torch.int32, device=x.device)[:, None]
            decode_meta = (table, torch.clamp(positions[:, 0] + 1,
                                              max=t).to(torch.int32))
        new_caches = [] if caches is not None else None
        for i, (kind, layer) in enumerate(zip(self.kinds, self.layers)):
            cache = None if caches is None else caches[i]
            if kind == "attn":
                x, c = layer(x, positions=positions, cache=cache,
                             decode_meta=decode_meta, seq_lens=seq_lens,
                             page_table=page_table, append=append)
            else:
                x, c = layer(x, state=cache, seq_lens=seq_lens)
            if caches is not None:
                new_caches.append(c)
        if in_place or (caches is not None and page_table is not None):
            new_caches = caches  # a decode step: every layer wrote in place
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
