"""Symmetric INT8 quantisation for serving (the port's copy of the serving
half of ``repro/quant.py``).

``quantize`` is ``q = clamp(round(x / scale), -127, 127)`` with ``scale =
max(amax, Q_EPS) / 127`` over the reduction axes, all in fp32.
``torch.round`` rounds half to even like ``jnp.round``, so the int8
payloads and scales are the JAX package's bit for bit. The scale keeps
``q``'s rank with the reduced axes at extent 1, so ``q * scale``
broadcasts. Three layouts: per tensor (``axis=None``), per output channel
(serving weights, :func:`quantize_params`) and per token over the head
dim (the KV cache, :func:`quantize_kv`: an ``[..., G, 1]`` scale beside
the ``[..., G, D]`` payload).

The optimizer-state and gradient uses and ``param_qdims`` wait for the
training and planning slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

#: symmetric int8 range bound (-127..127; -128 is never produced)
Q_MAX = 127.0
#: amax floor so all-zero tensors quantise to scale Q_EPS/127, not 0/0
Q_EPS = 1e-12

Axis = Union[None, int, Tuple[int, ...]]


class QTensor(NamedTuple):
    """Symmetric int8 tensor ``q`` with its f32 ``scale`` (scalar, or
    ``q``'s rank with the reduced axes of extent 1). ``values``, when
    set, is ``dequantize`` of the pair computed once, for a leaf the
    arithmetic reads in fp (:func:`fp`)."""

    q: torch.Tensor
    scale: torch.Tensor
    values: Optional[torch.Tensor] = None

    @property
    def shape(self):
        return self.q.shape


def is_qtensor(x) -> bool:
    return isinstance(x, QTensor)


def _amax(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    x = x.abs()
    if axis is None:
        return x.amax()
    if axis == ():  # nothing reduced: the element is its own channel
        return x
    return x.amax(dim=axis, keepdim=True)


def _quantize_with(x: torch.Tensor, amax: torch.Tensor) -> QTensor:
    # the divisor is a tensor on amax's device: CUDA computes a division
    # by a Python scalar as a multiplication by its reciprocal, which
    # rounds differently from the CPU's (and JAX's) true division
    scale = (amax.clamp_min(Q_EPS) / amax.new_full((), Q_MAX)).float()
    q = torch.clamp(torch.round(x / scale), -Q_MAX, Q_MAX).to(torch.int8)
    return QTensor(q, scale)


def quantize(x: torch.Tensor, axis: Axis = None) -> QTensor:
    """Symmetric int8 quantisation over the ``axis`` reduction axes
    (``None``: per tensor, a scalar scale)."""
    x = x.float()
    return _quantize_with(x, _amax(x, axis))


def dequantize(t: QTensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``q * scale`` in fp32, cast to ``dtype`` when given."""
    out = t.q.float() * t.scale
    return out if dtype is None else out.to(dtype)


def fp(x):
    """A weight leaf as the fp tensor the arithmetic reads: a
    :class:`QTensor` dequantised to fp32 (``dequantize_params`` without a
    dtype, as the reference's INT8 step does; its cached ``values`` when
    set), anything else as it is."""
    if not is_qtensor(x):
        return x
    return dequantize(x) if x.values is None else x.values


def quantize_kv(x: torch.Tensor) -> QTensor:
    """Per-token KV quantisation: ``x [..., G, D]`` -> int8 with a
    ``[..., G, 1]`` f32 scale."""
    return quantize(x, axis=x.dim() - 1)


# ---------------------------------------------------------------------------
# serving weights: per output channel, with the JAX package's stacking
# ---------------------------------------------------------------------------

def _weight_axis(x: torch.Tensor) -> Tuple[int, ...]:
    """Per-channel reduction axes of a weight leaf: all but the trailing
    output-feature axis."""
    return tuple(range(x.dim() - 1))


def named_leaves(model: nn.Module) -> Dict[str, Union[torch.Tensor, QTensor]]:
    """Every weight leaf of ``model`` by its parameter name: the
    ``nn.Parameter``, or the :class:`QTensor` that replaced it."""
    out = {}
    for mod_name, mod in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        for name, p in mod._parameters.items():
            if p is not None:
                out[prefix + name] = p
        for name, v in vars(mod).items():
            if is_qtensor(v):
                out[prefix + name] = v
    return out


def _replace(model: nn.Module, name: str, value: QTensor) -> None:
    """Swap the parameter ``name`` for ``value`` (a plain attribute),
    dropping the fp copy."""
    path, _, leaf = name.rpartition(".")
    mod = model.get_submodule(path) if path else model
    delattr(mod, leaf)
    setattr(mod, leaf, value)


def _quantize_stack(leaves: List[torch.Tensor]) -> List[QTensor]:
    """Quantise the per-layer copies of one body leaf as the JAX package
    quantises its stacked ``[L, ...]`` leaf: one scale per output column,
    shared by all layers (the amax runs over the layer axis too), so a
    1-D norm scale or bias of each layer is quantised as well. Each
    layer's scale keeps that layer's rank."""
    axes = _weight_axis(leaves[0])
    amax = None
    for x in leaves:
        a = _amax(x.float(), axes)
        amax = a if amax is None else torch.maximum(amax, a)
    out = [_quantize_with(x.float(), amax) for x in leaves]
    if leaves[0].dim() == 1:  # norm scales and biases: read in fp32
        out = [qt._replace(values=dequantize(qt)) for qt in out]
    return out


@torch.no_grad()
def quantize_params(model: nn.Module) -> nn.Module:
    """``repro.quant.quantize_params`` on the port's LM, in place.

    The reference quantises its stacked parameter tree: every floating
    leaf of two or more dims becomes a per-channel :class:`QTensor`.
    Its ``body`` leaves carry a leading layer axis, so each is
    quantised across all layers with one shared scale and its 1-D norm
    scales and biases (2-D once stacked) are int8 too; of the top-level
    leaves only the matrices (``embed``, ``unembed``) are, and
    ``final_norm`` stays fp. The port unstacks the body into
    ``layers.<i>`` and reproduces exactly that (a caveat of the
    reference, not fixed here). The 1-D norm scales and biases keep
    their fp32 dequantised values beside the int8 pair (``values``),
    since the forward reads them in fp. For a tied unembedding the
    module also gains ``unembed_ones`` ([1, V] f32), the unit column
    scale its logits pass to ``quant_matmul``.

    Each fp parameter is dropped once its int8 copy exists, and the
    :class:`QTensor` leaves are plain attributes: ``module.to()``,
    ``parameters()`` and ``state_dict()`` no longer see them. So place
    the model on its device and dtype first and quantise it there, as
    ``ServingEngine`` does."""
    leaves = named_leaves(model)
    if any(is_qtensor(v) for v in leaves.values()):
        raise ValueError("quantize_params: the model is already quantised")
    n_layers = len(model.layers)
    body = {name.split(".", 2)[2] for name in leaves
            if name.startswith("layers.")}
    for sub in sorted(body):
        stacked = [leaves[f"layers.{i}.{sub}"] for i in range(n_layers)]
        for i, qt in enumerate(_quantize_stack(stacked)):
            _replace(model, f"layers.{i}.{sub}", qt)
    for name, p in leaves.items():
        if not name.startswith("layers.") and p.dim() >= 2 \
                and p.is_floating_point():
            _replace(model, name, quantize(p, axis=_weight_axis(p)))
    arch = getattr(model, "arch", None)
    if arch is not None and arch.tie_embeddings:
        model.unembed_ones = torch.ones((1, arch.vocab_size),
                                        dtype=torch.float32,
                                        device=model.embed.q.device)
    return model


def leaf_bytes(model: nn.Module) -> int:
    """Bytes of every weight leaf (int8 payloads and f32 scales of the
    quantised ones)."""
    total = 0
    for v in named_leaves(model).values():
        for t in ((v.q, v.scale) if is_qtensor(v) else (v,)):
            total += t.numel() * t.element_size()
    return total


# ---------------------------------------------------------------------------
# the user surface
# ---------------------------------------------------------------------------

_MODES = (None, "int8")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """What is quantised on the serving path (``ServeConfig(quant=...)``).

    ``weights="int8"``: per-channel int8 weights, resident on the device;
    the projections run through ``quant_matmul``. ``kv="int8"``: int8 KV
    cache rows with per-token f32 ``k_scale``/``v_scale`` leaves; decode
    runs the int8 body of ``paged_attention``."""

    weights: Optional[str] = None
    kv: Optional[str] = None

    def __post_init__(self):
        for name in ("weights", "kv"):
            v = getattr(self, name)
            if v not in _MODES:
                raise ValueError(f"QuantConfig.{name}={v!r}; known: {_MODES}")

    @property
    def quant_kv(self) -> bool:
        return self.kv is not None

    @property
    def quant_weights(self) -> bool:
        return self.weights is not None


#: canonical full-INT8 serving config
INT8_SERVE = QuantConfig(weights="int8", kv="int8")
