"""AdamW on the port's parameters (mirrors ``repro/optim/adamw.py``).

``params`` and ``grads`` are dicts keyed by parameter name (an
``nn.Module`` is taken as its ``named_parameters()``); the optimizer
state is ``{"m": {name: state}, "v": {name: state}, "step": int32 []}``
on the parameters' device, each state fp32, or with ``quantize=True`` an
int8 :class:`~repro_torch.quant.QTensor` with a per-tensor scale. The
reference quantises the leaves of its stacked tree, so one scale covers
a stacked leaf's layers: the port keeps that grouping
(``quant.stack_groups``), each group's layers sharing one scale.

:func:`adamw_update` clips by the global norm, applies bias correction
and decoupled weight decay on every leaf and writes the new parameters
(cast to their dtype) and the new state **in place**, under
``torch.no_grad()``, where the reference returns new trees: the state
and parameters keep their addresses, which the checkpoint restore
copies into. The elementwise work is plain PyTorch per leaf, as the
reference leaves it to XLA (a fused kernel is ROADMAP B work).
``opt_state_dims`` is sharding and waits for the planner (ROADMAP A13).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.quant import (QTensor, _quantize_with, dequantize,
                               is_qtensor, stack_groups)

Params = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    quantize: bool = False  # int8 m/v with per-tensor scales


def as_params(params) -> Dict[str, torch.Tensor]:
    """``params`` as a name -> tensor dict (a module's named parameters)."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def default_groups(params) -> List[List[str]]:
    """The int8 state's scale groups: the reference's stacked leaves for a
    module (:func:`quant.stack_groups`), else one name a group."""
    if isinstance(params, nn.Module):
        return stack_groups(params)
    return [[n] for n in params]


def _quant_group(xs: List[torch.Tensor]) -> List[QTensor]:
    """Per-tensor int8 of one group: one amax over every member."""
    amax = torch.stack([x.abs().amax() for x in xs]).amax()
    return [_quantize_with(x, amax) for x in xs]


def adamw_init(params, cfg: AdamWConfig,
               groups: Optional[List[List[str]]] = None) -> dict:
    """Zero state for every parameter (int8 with ``cfg.quantize``)."""
    groups = groups or default_groups(params)
    params = as_params(params)
    state = {"m": {}, "v": {}}
    for key in ("m", "v"):
        for group in groups:
            zs = [torch.zeros(params[n].shape, dtype=torch.float32,
                              device=params[n].device) for n in group]
            vals = _quant_group(zs) if cfg.quantize else zs
            state[key].update(zip(group, vals))
    dev = next(iter(params.values())).device
    state["step"] = torch.zeros((), dtype=torch.int32, device=dev)
    return state


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    leaves = list(tree.values()) if isinstance(tree, Mapping) else list(tree)
    sums = [torch.sum(torch.square(x.float())) for x in leaves]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def adamw_update(params, grads: Params, opt_state: dict, cfg: AdamWConfig,
                 lr, groups: Optional[List[List[str]]] = None
                 ) -> Tuple[Dict[str, torch.Tensor], dict, dict]:
    """One AdamW step of every parameter from ``grads`` at learning rate
    ``lr`` (a float or a 0-dim tensor), in place; returns (params,
    opt_state, {"grad_norm", "clip_scale"})."""
    groups = groups or default_groups(params)
    params = as_params(params)
    step = opt_state["step"] + 1
    gn = global_norm([grads[n] for group in groups for n in group])
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-12), max=1.0)
    stepf = step.float()
    bc1 = 1.0 - cfg.b1 ** stepf
    bc2 = 1.0 - cfg.b2 ** stepf
    lr = torch.as_tensor(lr, dtype=torch.float32, device=gn.device)
    ms, vs = opt_state["m"], opt_state["v"]
    for group in groups:
        new_m, new_v = [], []
        for n in group:
            p = params[n]
            g = grads[n].float() * scale
            mf = dequantize(ms[n]) if cfg.quantize else ms[n]
            vf = dequantize(vs[n]) if cfg.quantize else vs[n]
            mf = cfg.b1 * mf + (1 - cfg.b1) * g
            vf = cfg.b2 * vf + (1 - cfg.b2) * torch.square(g)
            upd = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
            pf = p.float()
            p.copy_((pf - lr * (upd + cfg.weight_decay * pf)).to(p.dtype))
            new_m.append(mf)
            new_v.append(vf)
        for store, new in ((ms, new_m), (vs, new_v)):
            if cfg.quantize:
                new = _quant_group(new)
                for n, qt in zip(group, new):
                    store[n].q.copy_(qt.q)
                    store[n].scale.copy_(qt.scale)
            else:
                for n, x in zip(group, new):
                    store[n].copy_(x)
    opt_state["step"].copy_(step)
    return params, opt_state, {"grad_norm": gn, "clip_scale": scale}


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to ``min_frac * base_lr`` at ``total``; fp32 on the step's
    device."""
    def fn(step) -> torch.Tensor:
        step = torch.as_tensor(step).float()
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return fn


def state_bytes(opt_state: dict) -> int:
    """Bytes of the m and v state (int8 payloads and their scales)."""
    total = 0
    for key in ("m", "v"):
        for x in opt_state[key].values():
            for t in ((x.q, x.scale) if is_qtensor(x) else (x,)):
                total += t.numel() * t.element_size()
    return total
