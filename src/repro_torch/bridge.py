"""Carry a JAX parameter tree over into the port's ``LM``.

``repro.models.registry.init_params`` keeps the MoE family's leading
dense layers as top-level ``prefix{i}`` blocks, stacks the block
pattern's layers into ``params["body"]`` with a leading ``[repeats,
...]`` axis, one subtree ``b{j}_{kind}`` per pattern position, and keeps
the pattern's remainder as top-level ``suffix{i}`` blocks
(``lm.stack_structure``; for the dense family the pattern is one
``attn`` block, so ``repeats == num_layers``; deepseek-moe-16b has one
prefix layer and 27 repeats of an MoE ``attn`` block, whose expert
leaves ``moe.w_*`` stack to ``[27, E, D, F]``; recurrentgemma-2b has 8
repeats of (rglru, rglru, attn) and two suffix rglru blocks; xlstm-350m
12 repeats of (mlstm, slstm) and no suffix). With P prefix layers the
bridge carries ``prefix{i}`` into ``LM.layers[i]``, unstacks
``b{j}_{kind}[r]`` into ``LM.layers[P + r * len(pattern) + j]`` and
``suffix{i}`` into ``LM.layers[P + repeats * len(pattern) + i]``, and
keeps every weight's ``[d_in, d_out]`` layout, so ``x @ w`` is the same
product on both sides.

The encdec family's tree (``repro.models.encdec.init_params``) has
``embed``, ``enc_norm``, ``final_norm``, an untied ``unembed`` and two
stacks: ``enc_body`` (``enc_layers`` attention blocks) and ``dec_body``
(``dec_layers`` blocks with the cross-attention leaves ``ln_x``, ``xwq``,
``xwk``, ``xwv``, ``xwo``), each leaf with a leading layer axis; the
bridge unstacks them into :class:`~repro_torch.models.encdec.EncDec`'s
``enc_layers.<i>`` and ``dec_layers.<i>``.

The tree's leaves may be numpy arrays or anything ``numpy.asarray``
converts (a JAX array does, without importing JAX here).
:func:`from_jax_tree` applies the same unstacking to any tree shaped
like the params (gradients, AdamW's ``m`` and ``v``, int8 ones too),
so tests compare them leaf by leaf.
:func:`from_jax_spec_params` carries the ``{"target", "draft"}`` pair of
trees that the reference's speculative engine takes.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, default_dtype, resolve_device
from repro_torch.models.encdec import EncDec
from repro_torch.models.lm import LM, check_supported, pattern, stack_structure


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, f"{prefix}{k}."))
        else:
            flat[f"{prefix}{k}"] = v
    return flat


def _unstack(flat: Dict[str, Any], stack: Dict[str, Any], name: str,
             n: int) -> None:
    """Entry r of every leaf of the stacked subtree ``stack`` as
    ``flat["<name>.<r>.<leaf>"]``, for r < ``n``."""
    for leaf_name, leaf in _flatten(stack).items():
        leaf = np.asarray(leaf)
        if leaf.shape[0] != n:
            raise ValueError(f"stacked leaf {leaf_name} has {leaf.shape[0]} "
                             f"entries, arch has {n}")
        for r in range(n):
            flat[f"{name}.{r}.{leaf_name}"] = leaf[r]


def _load(model, flat: Dict[str, Any], dev: torch.device):
    params = dict(model.named_parameters())
    if set(flat) != set(params):
        raise KeyError(f"JAX tree and model parameters differ: only in tree "
                       f"{sorted(set(flat) - set(params))}, only in model "
                       f"{sorted(set(params) - set(flat))}")
    with torch.no_grad():
        for name, p in params.items():
            arr = np.asarray(flat[name]).astype(np.float32)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: tree shape {arr.shape} vs model "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr).to(device=dev, dtype=p.dtype))
    return model


def _port_flat(tree: Dict[str, Any], arch: ArchConfig) -> Dict[str, Any]:
    """Every leaf of a tree shaped like the JAX params, keyed by the port's
    parameter name (stacked leaves unstacked along their layer axis)."""
    if arch.family == "encdec":
        flat = _flatten({k: v for k, v in tree.items()
                         if k not in ("enc_body", "dec_body")})
        for key, name, n in (("enc_body", "enc_layers", arch.enc_layers),
                             ("dec_body", "dec_layers", arch.dec_layers)):
            if key not in tree:
                raise KeyError(f"expected {key} in the JAX tree")
            _unstack(flat, tree[key], name, n)
        return flat
    pat = pattern(arch)
    prefix, repeats, suffix = stack_structure(arch)
    n_pre, n_suffix = len(prefix), len(suffix)
    blocks = {f"prefix{i}" for i in range(n_pre)} | \
        {f"suffix{i}" for i in range(n_suffix)}
    top = {k: v for k, v in tree.items() if k != "body" and k not in blocks}
    flat = _flatten(top)
    for i in range(n_pre):
        if f"prefix{i}" not in tree:
            raise KeyError(f"expected prefix{i} in the JAX tree")
        for name, leaf in _flatten(tree[f"prefix{i}"]).items():
            flat[f"layers.{i}.{name}"] = leaf
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
                flat[f"layers.{n_pre + r * len(pat) + j}.{name}"] = leaf[r]
    for i in range(n_suffix):
        if f"suffix{i}" not in tree:
            raise KeyError(f"expected suffix{i} in the JAX tree")
        for name, leaf in _flatten(tree[f"suffix{i}"]).items():
            flat[f"layers.{n_pre + repeats * len(pat) + i}.{name}"] = leaf
    return flat


def from_jax_params(tree: Dict[str, Any], arch: ArchConfig,
                    device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None):
    """The JAX tree of a dense, MoE, hybrid, ssm or vlm LM as an
    :class:`LM`, or of an encdec model as an :class:`EncDec`, on
    ``device`` (default ``cuda``) in ``dtype`` (bf16 on CUDA, fp32 on
    the CPU by default).
    Raises ``KeyError`` unless the tree's leaves and the module's
    parameters correspond one to one, and ``ValueError`` on a shape
    mismatch."""
    check_supported(arch)
    dev = resolve_device(device)
    cls = EncDec if arch.family == "encdec" else LM
    model = cls(arch, device=dev, dtype=default_dtype(dev, dtype))
    return _load(model, _port_flat(tree, arch), dev)


def _is_qleaf(x) -> bool:
    return hasattr(x, "q") and hasattr(x, "scale") and not isinstance(x, dict)


def _split_q(tree, part: str, stacked: int = 0):
    """The ``q`` (or ``scale``) tree of a tree with int8 leaves; a
    per-tensor scale inside a stacked subtree is repeated along the layer
    axis (``stacked``: its length), so it unstacks like the payload."""
    if isinstance(tree, dict):
        return {k: _split_q(v, part, stacked) for k, v in tree.items()}
    if not _is_qleaf(tree):
        return tree
    x = np.asarray(getattr(tree, part))
    if part == "scale" and stacked and (x.ndim == 0 or x.shape[0] != stacked):
        x = np.broadcast_to(x, (stacked,) + x.shape)
    return x


def from_jax_tree(tree: Dict[str, Any], arch: ArchConfig) -> Dict[str, Any]:
    """Any tree shaped like the JAX params (grads, AdamW's ``m`` / ``v``)
    as ``{port parameter name: CPU tensor}``, unstacked as
    :func:`from_jax_params` unstacks the params; an int8 leaf (``q`` and
    ``scale``: the int8 AdamW state) becomes a
    :class:`~repro_torch.quant.QTensor`, a stacked leaf's per-tensor
    scale repeated for each of its layers."""
    from repro_torch.quant import QTensor

    def tensors(t):
        return {k: torch.from_numpy(np.array(v)) for k, v in
                _port_flat(t, arch).items()}

    def has_q(t):
        return any(has_q(v) for v in t.values()) if isinstance(t, dict) \
            else _is_qleaf(t)

    if not has_q(tree):
        return tensors(tree)
    stacks = {"body": stack_structure(arch)[1]} if arch.family != "encdec" \
        else {"enc_body": arch.enc_layers, "dec_body": arch.dec_layers}
    scales = {k: _split_q(v, "scale", stacks.get(k, 0))
              for k, v in tree.items()}
    qs, ss = tensors(_split_q(tree, "q")), tensors(scales)
    return {k: QTensor(qs[k], ss[k]) if qs[k].dtype == torch.int8 else qs[k]
            for k in qs}


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
