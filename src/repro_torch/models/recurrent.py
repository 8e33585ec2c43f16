"""RG-LRU recurrent block (RecurrentGemma / Griffin) of the hybrid family.

Mirrors the RG-LRU half of ``repro/models/recurrent.py``: ``rglru_init``
(:meth:`RGLRUBlock.init_`), ``make_rglru_state``, ``_causal_conv``,
``_rglru_gates`` and ``rglru_apply`` (:meth:`RGLRUBlock.forward`):
in-projection, depthwise causal conv1d, the gated linear recurrence,
the GeLU gate, the out-projection, then the block's MLP.

Prefill runs the recurrence through ``ops.lru_scan`` (the ``rglru_scan``
kernel on the card) from ``h0 = state["h"]``, where the reference adds
``a_0·h`` into ``b_0`` and runs a zero-started ``associative_scan``: the
same h sequence, summed in another order. Right-padded steps become scan
identities ``(a, b) = (1, 0)``, and the conv state keeps the window of
the last ``cw - 1`` real inputs, so the carried state does not depend on
the padded length; unlike the reference's associative scan, the kernel
applies identity steps exactly, so it is bit-equal across buckets.
Decode is the elementwise step ``a·h + b`` in PyTorch, as the reference
computes it outside any kernel.

A block's state is ``{"h": [B, W] f32, "conv": [B, cw-1, W]}`` (the
conv window in the cache dtype); decode returns a new state dict.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.blocks import GatedMLP, _param

_LRU_C = 8.0


def make_rglru_state(arch: ArchConfig, batch: int, *, device: torch.device,
                     dtype: torch.dtype) -> dict:
    w = arch.lru_width or arch.d_model
    cw = arch.conv1d_width or 4
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cw - 1, w), dtype=dtype, device=device)}


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor],
                 seq_lens: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d. x [B, S, W], w [cw, W]. Returns (y,
    new_state). With ``seq_lens`` the carried state is the window of the
    last ``cw - 1`` real inputs, ``xp[len : len + cw - 1]`` (``xp`` index
    i holds input ``i - (cw - 1)``), not the padded tail."""
    cw = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)  # [B, S + cw - 1, W]
    s = x.shape[1]
    y = xp[:, 0:s] * w[0]
    for i in range(1, cw):
        y = y + xp[:, i:i + s] * w[i]
    if cw <= 1:
        return y + b, state
    if seq_lens is None:
        return y + b, xp[:, -(cw - 1):]
    idx = (seq_lens.to(x.device).long()[:, None]
           + torch.arange(cw - 1, device=x.device)[None, :])
    new_state = torch.gather(xp, 1, idx[:, :, None].expand(-1, -1, xp.shape[2]))
    return y + b, new_state


def _rglru_gates(gate_w: torch.Tensor, gate_b: torch.Tensor,
                 a_param: torch.Tensor, xr: torch.Tensor, heads: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-head input and recurrence gates: returns (log_a, b) [B, S, W]
    in f32, ``b = sqrt(1 - a^2) · i · x``. The block-diagonal gate
    product is ``torch.einsum``, as the reference computes it outside any
    kernel."""
    b, s, w = xr.shape
    hw = w // heads
    xh = xr.reshape(b, s, heads, hw)
    g = torch.einsum("bshd,hde->bshe", xh, gate_w) + gate_b
    r, i = torch.split(g.reshape(b, s, 2 * w), w, dim=-1)
    r, i = torch.sigmoid(r.float()), torch.sigmoid(i.float())
    log_a = -_LRU_C * F.softplus(a_param.float()) * r
    gated_x = xr.float() * i
    scale = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return log_a, scale * gated_x


class RGLRUBlock(nn.Module):
    """Pre-norm RG-LRU block + MLP. Parameter names mirror the JAX tree:
    ``ln1, w_in [d, 2w], conv_w [cw, w], conv_b [w], gate_w [heads, hw,
    2hw], gate_b [heads, 2hw], a_param [w], w_out [w, d], ln2,
    mlp.{w_gate, w_up, w_down}``."""

    def __init__(self, arch: ArchConfig, *, device, dtype):
        super().__init__()
        if arch.mlp not in ("swiglu", "geglu") or not arch.d_ff:
            raise NotImplementedError(f"{arch.name}: only RG-LRU blocks "
                                      f"with a SwiGLU or GeGLU MLP are ported")
        self.arch = arch
        d = arch.d_model
        w = arch.lru_width or d
        heads = arch.num_heads
        hw = w // heads
        cw = arch.conv1d_width or 4
        kw = dict(device=device, dtype=dtype)
        self.ln1 = _param(d, **kw)
        self.w_in = _param(d, 2 * w, **kw)
        self.conv_w = _param(cw, w, **kw)
        self.conv_b = _param(w, **kw)
        self.gate_w = _param(heads, hw, 2 * hw, **kw)
        self.gate_b = _param(heads, 2 * hw, **kw)
        self.a_param = _param(w, **kw)
        self.w_out = _param(w, d, **kw)
        self.ln2 = _param(d, **kw)
        self.mlp = GatedMLP(d, arch.d_ff, **kw)

    def init_(self, gen: torch.Generator) -> None:
        """Random weights with ``rglru_init``'s distributions: the dense
        init for the projections, the conv (fan-in cw) and the per-head
        gates (fan-in hw); ``a_param = linspace(0.9, 0.999, w)``; norms
        and biases stay zero."""
        for p in (self.w_in, self.conv_w, self.w_out, self.mlp.w_gate,
                  self.mlp.w_up, self.mlp.w_down):
            L.dense_init_(p, p.shape[0], gen)
        L.dense_init_(self.gate_w, self.gate_w.shape[1], gen)
        with torch.no_grad():
            self.a_param.copy_(torch.linspace(0.9, 0.999, self.a_param.shape[0],
                                              dtype=torch.float32))

    def forward(self, x: torch.Tensor, *, state: Optional[dict] = None,
                seq_lens: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
        """x [B, S, D]. With ``state`` and S == 1 this is a decode step;
        with ``state`` and S > 1 a prefill from that state; without, a
        full forward. ``seq_lens`` [B]: true lengths of a right-padded
        prefill. Returns (x, new state or None)."""
        arch = self.arch
        s = x.shape[1]
        h = L.rms_norm(x, self.ln1)
        u = L.dense(h, self.w_in)
        y_branch, xr = torch.chunk(u, 2, dim=-1)
        xr, new_conv = _causal_conv(
            xr, self.conv_w, self.conv_b,
            None if state is None else state["conv"],
            seq_lens=None if s == 1 else seq_lens)
        log_a, bx = _rglru_gates(self.gate_w, self.gate_b, self.a_param, xr,
                                 arch.num_heads)

        new_state = None
        if s == 1 and state is not None:  # decode step
            h_new = torch.exp(log_a[:, 0]) * state["h"] + bx[:, 0]
            seq = h_new[:, None, :]
            new_state = {"h": h_new, "conv": new_conv.to(state["conv"].dtype)}
        else:
            if seq_lens is not None:
                # padded steps become scan identities (a, b) = (1, 0)
                valid = (torch.arange(s, device=x.device)[None, :]
                         < seq_lens.to(x.device)[:, None])[:, :, None]
                log_a = torch.where(valid, log_a, 0.0)
                bx = torch.where(valid, bx, 0.0)
            h0 = (state["h"] if state is not None else
                  torch.zeros(bx.shape[0], bx.shape[2], dtype=torch.float32,
                              device=x.device))
            seq = ops.lru_scan(torch.exp(log_a), bx, h0)
            if state is not None:
                new_state = {"h": seq[:, -1].contiguous(),
                             "conv": new_conv.to(state["conv"].dtype)}

        gate = F.gelu(y_branch, approximate="tanh")
        x = x + L.dense(seq.to(x.dtype) * gate, self.w_out)
        x = x + L.mlp_apply(self.mlp, L.rms_norm(x, self.ln2), arch.mlp)
        return x, new_state
