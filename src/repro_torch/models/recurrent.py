"""Recurrent blocks: RG-LRU (the hybrid family, RecurrentGemma / Griffin)
and mLSTM + sLSTM (the ssm family, xLSTM).

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
conv window in the cache dtype). Decode updates it in place and returns
the same dict (every leaf keeps its address, as a captured decode step
needs); a prefill returns a new one. So do the mLSTM and sLSTM blocks.

The mLSTM half mirrors ``mlstm_init`` (:meth:`MLSTMBlock.init_`),
``make_mlstm_state``, ``_mlstm_qkvif``, ``mlstm_apply`` and
``_mlstm_suffix_state``: up-projection into a mixer branch u and an
output gate z, per-head q/k/v and scalar gates, the matrix memory, the
inner norm, the gate and the down-projection. Prefill runs
``ops.mlstm_fold`` (the ``mlstm_chunkwise`` kernel on the card) from
the block's state on log-forget gates, with the identity pair
``(log f, i) = (0, -1e30)`` on right-padded steps; the kernel writes the
final state, which the reference folds with ``_mlstm_suffix_state``
(the same state: its stabiliser does not depend on the chunking). Decode
is the O(1) update in PyTorch, as the reference computes it outside any
kernel. State: ``{"C": [B, H, hd, hd], "n": [B, H, hd], "m": [B, H]}``.

The sLSTM half mirrors ``slstm_init``, ``make_slstm_state``,
``_slstm_step`` and ``slstm_apply``: a strictly sequential scan with a
per-head recurrence matrix, in PyTorch (the JAX package has no kernel
for it); padded prefill steps carry every state leaf through. State:
``{"c", "n", "h", "m": [B, D]}``. Both ssm states are f32 whatever the
cache dtype.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import quant as Q
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.blocks import MLP, _param

_LRU_C = 8.0

_NEG = -1e30  # log-space "never": exp(_NEG - finite) underflows to exactly 0


def _valid_mask(seq_lens: Optional[torch.Tensor], s: int,
                device: torch.device) -> Optional[torch.Tensor]:
    """[B, S] bool, True below each row's true length; None when no
    lengths were given."""
    if seq_lens is None:
        return None
    return (torch.arange(s, device=device)[None, :]
            < seq_lens.to(device)[:, None])


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
    g = torch.einsum("bshd,hde->bshe", xh, Q.fp(gate_w)) + Q.fp(gate_b)
    r, i = torch.split(g.reshape(b, s, 2 * w), w, dim=-1)
    r, i = torch.sigmoid(r.float()), torch.sigmoid(i.float())
    log_a = -_LRU_C * F.softplus(Q.fp(a_param).float()) * r
    gated_x = xr.float() * i
    scale = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return log_a, scale * gated_x


class RGLRUBlock(nn.Module):
    """Pre-norm RG-LRU block + MLP. Parameter names mirror the JAX tree:
    ``ln1, w_in [d, 2w], conv_w [cw, w], conv_b [w], gate_w [heads, hw,
    2hw], gate_b [heads, 2hw], a_param [w], w_out [w, d], ln2,
    mlp.{w_gate, w_up, w_down}``."""

    #: leaves of two or more dims that the forward reads in fp, not
    #: through ``quant_matmul`` (``quant.quantize_params`` keeps their
    #: dequantised values)
    fp_leaves = ("conv_w", "gate_w", "gate_b")

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
        self.mlp = MLP(d, arch.d_ff, arch.mlp, **kw)

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
            xr, Q.fp(self.conv_w), Q.fp(self.conv_b),
            None if state is None else state["conv"],
            seq_lens=None if s == 1 else seq_lens)
        log_a, bx = _rglru_gates(self.gate_w, self.gate_b, self.a_param, xr,
                                 arch.num_heads)

        new_state = None
        if s == 1 and state is not None:  # decode step, in place
            h = state["h"].mul_(torch.exp(log_a[:, 0])).add_(bx[:, 0])
            state["conv"].copy_(new_conv)
            seq = h[:, None, :]
            new_state = state
        else:
            if seq_lens is not None:
                # padded steps become scan identities (a, b) = (1, 0)
                valid = _valid_mask(seq_lens, s, x.device)[:, :, None]
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


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM): matrix memory
# ---------------------------------------------------------------------------

def make_mlstm_state(arch: ArchConfig, batch: int, *,
                     device: torch.device) -> dict:
    w = 2 * arch.d_model
    heads = arch.num_heads
    hd = w // heads
    kw = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, heads, hd, hd), **kw),
            "n": torch.zeros((batch, heads, hd), **kw),
            "m": torch.full((batch, heads), _NEG, **kw)}


class MLSTMBlock(nn.Module):
    """Pre-norm mLSTM block. Parameter names mirror the JAX tree: ``ln1
    [d], w_up [d, 2w], wq, wk, wv [w, w], w_i, w_f [w, heads], b_i, b_f
    [heads], ln_inner [w], w_down [w, d]`` with ``w = 2 d``."""

    def __init__(self, arch: ArchConfig, *, device, dtype):
        super().__init__()
        self.arch = arch
        d = arch.d_model
        w = 2 * d
        heads = arch.num_heads
        kw = dict(device=device, dtype=dtype)
        self.ln1 = _param(d, **kw)
        self.w_up = _param(d, 2 * w, **kw)
        self.wq = _param(w, w, **kw)
        self.wk = _param(w, w, **kw)
        self.wv = _param(w, w, **kw)
        self.w_i = _param(w, heads, **kw)
        self.w_f = _param(w, heads, **kw)
        self.b_i = _param(heads, **kw)
        self.b_f = _param(heads, **kw)
        self.ln_inner = _param(w, **kw)
        self.w_down = _param(w, d, **kw)

    def init_(self, gen: torch.Generator) -> None:
        """Random weights with ``mlstm_init``'s distributions: the dense
        init (fan-in axis 0) for the projections, the forget-gate bias
        ``b_f = 3`` (remember), norms and ``b_i`` zero."""
        for p in (self.w_up, self.wq, self.wk, self.wv, self.w_i, self.w_f,
                  self.w_down):
            L.dense_init_(p, p.shape[0], gen)
        with torch.no_grad():
            self.b_f.fill_(3.0)

    def _qkvif(self, u: torch.Tensor):
        """``_mlstm_qkvif``: q, k (scaled by 1/sqrt(hd)), v [B, S, H, hd]
        in the activation dtype; it, ft [B, S, H] in f32."""
        b, s, w = u.shape
        heads = self.arch.num_heads
        hd = w // heads
        q = L.dense(u, self.wq).reshape(b, s, heads, hd)
        k = L.dense(u, self.wk).reshape(b, s, heads, hd) / math.sqrt(hd)
        v = L.dense(u, self.wv).reshape(b, s, heads, hd)
        it = (L.dense(u, self.w_i) + Q.fp(self.b_i)).float()
        ft = (L.dense(u, self.w_f) + Q.fp(self.b_f)).float()
        return q, k, v, it, ft

    def forward(self, x: torch.Tensor, *, state: Optional[dict] = None,
                seq_lens: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
        """x [B, S, D]. With ``state`` and S == 1 a decode step; with
        ``state`` and S > 1 a prefill from that state; without, a full
        forward from the zero state. Returns (x, new state or None)."""
        b, s, _ = x.shape
        heads = self.arch.num_heads
        up = L.dense(L.rms_norm(x, self.ln1), self.w_up)
        u, z = torch.chunk(up, 2, dim=-1)  # mixer input, output gate branch
        q, k, v, it, ft = self._qkvif(u)
        hd = q.shape[-1]

        if s == 1 and state is not None:  # recurrent decode, in place
            logf = F.logsigmoid(ft[:, 0])  # [B, H]
            m_new = torch.maximum(logf + state["m"], it[:, 0])
            fs = torch.exp(logf + state["m"] - m_new)[..., None]
            is_ = torch.exp(it[:, 0] - m_new)[..., None]
            k1, v1, q1 = (t[:, 0].float() for t in (k, v, q))  # [B, H, hd]
            # C = f·C + (i·k) v^T in two passes over C, with no C-sized
            # temporary (the reference forms i·(k v^T): one rounding apart)
            C = state["C"].mul_(fs[..., None]).addcmul_(
                (is_ * k1)[..., :, None], v1[..., None, :])
            n = state["n"].mul_(fs).add_(is_ * k1)
            state["m"].copy_(m_new)
            num = torch.einsum("bhkv,bhk->bhv", C, q1)
            den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, q1)),
                                torch.exp(-m_new))[..., None]
            hseq = (num / den).reshape(b, 1, heads * hd)
            new_state = state
        else:
            st0 = state if state is not None else make_mlstm_state(
                self.arch, b, device=x.device)
            logf = F.logsigmoid(ft)  # [B, S, H]
            valid = _valid_mask(seq_lens, s, x.device)
            if valid is not None:
                # identity gates on padded steps: log f = 0 keeps the
                # cumulative decay flat, i = _NEG weighs the step 0 in
                # the fold, so padded k/v never enter (C, n, m)
                logf = torch.where(valid[..., None], logf, 0.0)
                it = torch.where(valid[..., None], it, _NEG)

            def fold(t):  # [B, S, H, ...] -> [B*H, S, ...]
                return t.transpose(1, 2).reshape(b * heads, s, *t.shape[3:])

            h, C, n, m = ops.mlstm_fold(
                fold(q), fold(k), fold(v), fold(it), fold(logf),
                st0["C"].reshape(b * heads, hd, hd),
                st0["n"].reshape(b * heads, hd), st0["m"].reshape(b * heads))
            hseq = h.reshape(b, heads, s, hd).transpose(1, 2).reshape(
                b, s, heads * hd)
            new_state = None
            if state is not None:
                new_state = {"C": C.reshape(b, heads, hd, hd),
                             "n": n.reshape(b, heads, hd),
                             "m": m.reshape(b, heads)}

        hseq = L.rms_norm(hseq.to(x.dtype), self.ln_inner)
        return x + L.dense(hseq * F.silu(z), self.w_down), new_state


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM): scalar memory, strictly sequential scan
# ---------------------------------------------------------------------------

def make_slstm_state(arch: ArchConfig, batch: int, *,
                     device: torch.device) -> dict:
    d = arch.d_model
    kw = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, d), **kw),
            "n": torch.zeros((batch, d), **kw),
            "h": torch.zeros((batch, d), **kw),
            "m": torch.full((batch, d), _NEG, **kw)}


class SLSTMBlock(nn.Module):
    """Pre-norm sLSTM block. Parameter names mirror the JAX tree: ``ln1
    [d], w [d, 4d], r [heads, hd, 4hd], b [4d], w_out [d, d]``."""

    #: read in fp by the recurrence (see :attr:`RGLRUBlock.fp_leaves`)
    fp_leaves = ("r",)

    def __init__(self, arch: ArchConfig, *, device, dtype):
        super().__init__()
        self.arch = arch
        d = arch.d_model
        heads = arch.num_heads
        hd = d // heads
        kw = dict(device=device, dtype=dtype)
        self.ln1 = _param(d, **kw)
        self.w = _param(d, 4 * d, **kw)
        self.r = _param(heads, hd, 4 * hd, **kw)
        self.b = _param(4 * d, **kw)
        self.w_out = _param(d, d, **kw)

    def init_(self, gen: torch.Generator) -> None:
        """Random weights with ``slstm_init``'s distributions: the dense
        init for ``w`` and ``w_out`` (fan-in axis 0) and for ``r``
        (fan-in axis 1, hd); ``ln1`` and ``b`` zero."""
        L.dense_init_(self.w, self.w.shape[0], gen)
        L.dense_init_(self.r, self.r.shape[1], gen)
        L.dense_init_(self.w_out, self.w_out.shape[0], gen)

    def _step(self, st: dict, xt: torch.Tensor) -> dict:
        """``_slstm_step``: one timestep from xt [B, 4D], the input
        projection's pre-activations in the activation dtype."""
        b = xt.shape[0]
        d = self.arch.d_model
        heads = self.arch.num_heads
        hprev = st["h"].reshape(b, heads, d // heads).to(xt.dtype)
        rec = torch.einsum("bhd,hde->bhe", hprev,
                           Q.fp(self.r)).reshape(b, 4 * d)
        pre = (xt + rec + Q.fp(self.b)).float()
        i_, f_, z_, o_ = torch.chunk(pre, 4, dim=-1)
        m_new = torch.maximum(f_ + st["m"], i_)
        ip = torch.exp(i_ - m_new)
        fp = torch.exp(f_ + st["m"] - m_new)
        c = fp * st["c"] + ip * torch.tanh(z_)
        n = fp * st["n"] + ip
        h = torch.sigmoid(o_) * c / torch.clamp(n, min=1e-6)
        return {"c": c, "n": n, "h": h, "m": m_new}

    def forward(self, x: torch.Tensor, *, state: Optional[dict] = None,
                seq_lens: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
        """As :meth:`MLSTMBlock.forward`; a prefill is a Python loop over
        S in which padded steps carry every state leaf (``h`` included,
        which feeds the recurrence) through unchanged."""
        b, s, _ = x.shape
        pre = L.dense(L.rms_norm(x, self.ln1), self.w)  # [B, S, 4D]
        st = state if state is not None else make_slstm_state(
            self.arch, b, device=x.device)
        if s == 1:
            nxt = self._step(st, pre[:, 0])
            if state is None:
                st = nxt
            else:  # decode: the state in place
                for k, leaf in nxt.items():
                    st[k].copy_(leaf)
            seq = st["h"][:, None].to(x.dtype)
        else:
            valid = _valid_mask(seq_lens, s, x.device)
            hs = []
            for t in range(s):
                nxt = self._step(st, pre[:, t])
                if valid is not None:
                    vt = valid[:, t, None]
                    nxt = {k: torch.where(vt, nxt[k], st[k]) for k in nxt}
                st = nxt
                hs.append(st["h"])
            seq = torch.stack(hs, dim=1).to(x.dtype)
        new_state = st if state is not None else None
        return x + L.dense(seq, self.w_out), new_state
