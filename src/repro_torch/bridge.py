"""Carry a JAX parameter tree over into the port's ``LM``.

``repro.models.registry.init_params`` stacks the block pattern's layers
into ``params["body"]`` with a leading ``[repeats, ...]`` axis
(``lm.stack_structure``; for the dense family the pattern is one
``attn`` block, so ``repeats == num_layers``). The bridge unstacks that
axis into ``LM.layers[i]`` and keeps every weight's ``[d_in, d_out]``
layout, so ``x @ w`` is the same product on both sides.

The tree's leaves may be numpy arrays or anything ``numpy.asarray``
converts (a JAX array does, without importing JAX here).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, default_dtype, resolve_device
from repro_torch.models.lm import LM, check_supported


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, f"{prefix}{k}."))
        else:
            flat[f"{prefix}{k}"] = v
    return flat


def from_jax_params(tree: Dict[str, Any], arch: ArchConfig,
                    device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> LM:
    """The JAX tree of a dense LM as an :class:`LM` on ``device`` (default
    ``cuda``) in ``dtype`` (bf16 on CUDA, fp32 on the CPU by default).
    Raises ``KeyError`` unless the tree's leaves and the module's
    parameters correspond one to one, and ``ValueError`` on a shape
    mismatch."""
    check_supported(arch)
    dev = resolve_device(device)
    model = LM(arch, device=dev, dtype=default_dtype(dev, dtype))
    top = {k: v for k, v in tree.items() if k != "body"}
    flat = _flatten(top)
    body = tree.get("body", {})
    if set(body) != {"b0_attn"}:
        raise KeyError(f"expected body {{'b0_attn'}}, got {sorted(body)}")
    for name, leaf in _flatten(body["b0_attn"]).items():
        leaf = np.asarray(leaf)
        if leaf.shape[0] != arch.num_layers:
            raise ValueError(f"body leaf {name} stacks {leaf.shape[0]} layers, "
                             f"arch has {arch.num_layers}")
        for i in range(arch.num_layers):
            flat[f"layers.{i}.{name}"] = leaf[i]
    params = dict(model.named_parameters())
    if set(flat) != set(params):
        raise KeyError(f"JAX tree and LM parameters differ: only in tree "
                       f"{sorted(set(flat) - set(params))}, only in LM "
                       f"{sorted(set(params) - set(flat))}")
    with torch.no_grad():
        for name, p in params.items():
            arr = np.asarray(flat[name]).astype(np.float32)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: tree shape {arr.shape} vs LM "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr).to(device=dev, dtype=p.dtype))
    return model
