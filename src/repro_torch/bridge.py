"""Carry a JAX parameter tree over into the port's ``LM``.

``repro.models.registry.init_params`` stacks the block pattern's layers
into ``params["body"]`` with a leading ``[repeats, ...]`` axis, one
subtree ``b{j}_{kind}`` per pattern position, and keeps the pattern's
remainder as top-level ``suffix{i}`` blocks (``lm.stack_structure``; for
the dense family the pattern is one ``attn`` block, so ``repeats ==
num_layers``; recurrentgemma-2b has 8 repeats of (rglru, rglru, attn)
and two suffix rglru blocks; xlstm-350m 12 repeats of (mlstm, slstm)
and no suffix). The bridge unstacks ``b{j}_{kind}[r]``
into ``LM.layers[r * len(pattern) + j]`` and ``suffix{i}`` into
``LM.layers[repeats * len(pattern) + i]``, and keeps every weight's
``[d_in, d_out]`` layout, so ``x @ w`` is the same product on both
sides.

The tree's leaves may be numpy arrays or anything ``numpy.asarray``
converts (a JAX array does, without importing JAX here).
:func:`from_jax_spec_params` carries the ``{"target", "draft"}`` pair of
trees that the reference's speculative engine takes.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, default_dtype, resolve_device
from repro_torch.models.lm import LM, check_supported, pattern, stack_structure


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
    """The JAX tree of a dense, hybrid or ssm LM as an :class:`LM` on ``device``
    (default ``cuda``) in ``dtype`` (bf16 on CUDA, fp32 on the CPU by
    default).
    Raises ``KeyError`` unless the tree's leaves and the module's
    parameters correspond one to one, and ``ValueError`` on a shape
    mismatch."""
    check_supported(arch)
    dev = resolve_device(device)
    model = LM(arch, device=dev, dtype=default_dtype(dev, dtype))
    pat = pattern(arch)
    repeats, suffix = stack_structure(arch)
    n_suffix = len(suffix)
    top = {k: v for k, v in tree.items()
           if k != "body" and k not in {f"suffix{i}" for i in range(n_suffix)}}
    flat = _flatten(top)
    body = tree.get("body", {})
    want = {f"b{j}_{kind}" for j, kind in enumerate(pat)} if repeats else set()
    if set(body) != want:
        raise KeyError(f"expected body {sorted(want)}, got {sorted(body)}")
    for j, kind in enumerate(pat):
        for name, leaf in _flatten(body.get(f"b{j}_{kind}", {})).items():
            leaf = np.asarray(leaf)
            if leaf.shape[0] != repeats:
                raise ValueError(f"body leaf b{j}_{kind}.{name} stacks "
                                 f"{leaf.shape[0]} repeats, arch has {repeats}")
            for r in range(repeats):
                flat[f"layers.{r * len(pat) + j}.{name}"] = leaf[r]
    for i in range(n_suffix):
        if f"suffix{i}" not in tree:
            raise KeyError(f"expected suffix{i} in the JAX tree")
        for name, leaf in _flatten(tree[f"suffix{i}"]).items():
            flat[f"layers.{repeats * len(pat) + i}.{name}"] = leaf
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


def from_jax_spec_params(trees: Dict[str, Any], arch: ArchConfig,
                         draft: ArchConfig, device: DeviceLike = None,
                         dtype: Optional[torch.dtype] = None) -> Dict[str, LM]:
    """The reference's speculative params ``{"target": tree, "draft":
    tree}`` as ``{"target": LM, "draft": LM}`` (the pair
    ``ServingEngine`` takes with ``ServeConfig(spec=...)``); each tree
    as :func:`from_jax_params` carries it."""
    if set(trees) != {"target", "draft"}:
        raise KeyError(f"expected the keys 'target' and 'draft', got "
                       f"{sorted(trees)}")
    return {"target": from_jax_params(trees["target"], arch, device, dtype),
            "draft": from_jax_params(trees["draft"], draft, device, dtype)}
