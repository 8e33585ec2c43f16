"""Gradient compression with error feedback (the port's copy of
``repro/runtime/compression.py``).

Per-tensor symmetric int8 quantisation of each gradient leaf plus an
fp32 error-feedback residual carried to the next step (Seide et al.
2014; Karimireddy et al. 2019 EF-SGD). Trees are dicts keyed by
parameter name; the arithmetic is ``quant.quantize``'s, so payloads and
scales are the reference's bit for bit. The reference quantises each
leaf of its stacked tree as one tensor; :func:`compressed_grads` takes
the same grouping (``quant.stack_groups``: one scale for a stacked
leaf's layers) so its values are the reference's too.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.quant import _quantize_with, dequantize, quantize

Tree = Mapping[str, torch.Tensor]


def init_error_feedback(params: Tree) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def compress(g: torch.Tensor, err: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (int8 payload, scale, new error residual)."""
    corrected = g.float() + err
    t = quantize(corrected)
    return t.q, t.scale, corrected - dequantize(t)


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_grads(grads: Tree, err: Tree,
                     groups: Optional[List[List[str]]] = None
                     ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Quantise -> dequantise every gradient leaf with error feedback,
    one per-tensor scale per group of names (``groups``; default one
    leaf a group); returns (grads in their dtypes, new residuals)."""
    if set(grads) != set(err):
        raise ValueError(
            f"error-feedback tree does not match the gradient tree: "
            f"residuals would pair with the wrong leaves (re-init with "
            f"init_error_feedback(params)).\n  grads: {list(grads)}\n"
            f"  err:   {list(err)}")
    out_g, out_e = {}, {}
    for group in groups or [[n] for n in grads]:
        corrected = [grads[n].float() + err[n] for n in group]
        amax = torch.stack([c.abs().amax() for c in corrected]).amax()
        for n, c in zip(group, corrected):
            t = _quantize_with(c, amax)
            deq = decompress(t.q, t.scale)
            out_g[n] = deq.to(grads[n].dtype)
            out_e[n] = c - deq
    return out_g, out_e
