"""Capacity-routed mixture of experts (GShard/Switch style): the MoE
family's MLP, the port's counterpart of ``_moe_apply_dense`` with
``_local_dispatch``, ``_local_combine`` and ``_expert_ffn`` in
``repro/models/blocks.py``.

Step by step as the reference, over the whole batch's T = B·S tokens
(pad positions of a prefill bucket and the inert slots of a decode step
included: they are routed and take capacity there too):

1. router logits ``h @ router`` (rounded to the activation dtype by the
   matmul), then fp32; softmax; the top k with the gate values divided
   by ``max(sum, 1e-9)``. The top k come from a stable descending sort,
   so tied probabilities keep the lowest expert first, as
   ``jax.lax.top_k`` does (``torch.topk`` fixes no tie order on CUDA);
2. ``cap = max(ceil(T·k/E·capacity_factor), 1)``; the T·k assignments
   stably sorted by expert id, each ranked within its expert
   (``searchsorted(side="left")``), those ranked at or past ``cap``
   dropped;
3. the kept tokens scattered into an [E, cap, D] buffer (a dropped one
   goes to a spare row that nothing reads), the expert FFN over it
   through ``xfer_matmul_experts`` (``quant_matmul_experts`` for int8
   expert leaves), one launch per product. Expert e's
   kept assignments fill its rows ``[0, counts[e])`` and leave the rest
   zero (:func:`expert_counts`); the products take ``counts`` and read
   no weight of an expert that holds no row, which is bit-equal, since
   a zero row times ``w`` is +0 and act(0)·0 = 0;
4. the combine: each assignment's output row times its gate value,
   rounded to the activation dtype, zero where dropped; a token's k
   terms summed in a fixed order, by ascending expert id, which is the
   order in which the reference's scatter-add meets them, so the sum is
   the same run to run (CUDA's ``index_add_`` is not);
5. the shared experts' MLP added.

Nothing here reads back to the host or takes a shape from the data:
``cap`` depends on T only, so the routing runs inside the captured
decode step.

Under autograd (training, ``lm.loss_fn``) the same code is
differentiated as ``jax.grad`` differentiates ``_moe_apply_dense``: the
router gets its gradient through the renormalised gate values (the
sort's values, as through ``jax.lax.top_k``), the expert products
through ``xfer_matmul_experts``' Function (its dgrad and wgrad), the
dispatch through the scatter into the buffer; a dropped assignment
lands on the spare row, which nothing reads, and gets no gradient. The
routing depends only on the layer's input, so a rematerialised layer
recomputes the same one. Expert parallelism over a mesh (``_moe_apply_sharded``) is
not ported.
"""
from __future__ import annotations

import math

import torch

from repro_torch import quant as Q
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L


def capacity(arch: ArchConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` routed tokens (the reference's
    expression, evaluated the same way)."""
    return max(int(math.ceil(tokens * arch.top_k / arch.num_experts
                             * arch.moe_capacity_factor)), 1)


def route(arch: ArchConfig, hf: torch.Tensor, router):
    """Top-k routing of ``hf`` [T, D]: (gate values [T, k] fp32,
    renormalised; expert ids [T, k] int64, by descending probability,
    ties lowest id first). An int8 ``router`` goes through
    ``quant_matmul``, whose logits are fp32 under INT8 weights."""
    logits = L.dense(hf, router).float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = arch.top_k
    vals, idx = vals[:, :k], idx[:, :k]
    return vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9), idx


def dispatch(arch: ArchConfig, idx: torch.Tensor, cap: int):
    """The assignments' places: (``order`` [T·k], the stable sort of the
    expert ids; ``dest`` [T·k], each sorted assignment's row of the
    [E·cap] buffer, ``E·cap`` (the spare row) where dropped; ``keep``
    [T·k])."""
    e = arch.num_experts
    eid = idx.reshape(-1)
    eid_s, order = torch.sort(eid, stable=True)
    first = torch.searchsorted(eid_s, eid_s, side="left")
    rank = torch.arange(eid.numel(), device=eid.device) - first
    keep = rank < cap
    dest = torch.where(keep, eid_s * cap + rank, e * cap)
    return order, dest, keep


def expert_counts(arch: ArchConfig, idx: torch.Tensor,
                  cap: int) -> torch.Tensor:
    """Kept assignments per expert, [E] int32: each expert's share of the
    top-k ids ``idx``, at most ``cap`` (:func:`dispatch` keeps the first
    ``cap`` of each expert). A fixed-shape ``scatter_add_`` on the
    device: no read back to the host, no shape taken from the data, so
    it runs inside the captured decode step."""
    eid = idx.reshape(-1)
    ones = torch.ones(eid.numel(), dtype=torch.int32, device=eid.device)
    counts = torch.zeros(arch.num_experts, dtype=torch.int32,
                         device=eid.device)
    return counts.scatter_add_(0, eid, ones).clamp_(max=cap)


def expert_ffn(arch: ArchConfig, experts, buf: torch.Tensor,
               counts: torch.Tensor = None) -> torch.Tensor:
    """The routed experts' MLP over ``buf`` [E, cap, D] -> [E, cap, D]:
    ``act(buf @ w_gate) * (buf @ w_up) @ w_down`` per expert (SwiGLU or
    GeGLU), or ``relu(buf @ w_up)² @ w_down`` (relu2). ``counts`` [E]:
    each expert's live rows (:func:`expert_counts`; ``None``: all), the
    rest zero in ``buf`` and +0 out of every product. An int8 expert
    leaf (a :class:`~repro_torch.quant.QTensor`, one column scale for
    every expert) goes through ``quant_matmul_experts``."""
    def mm(a, w):
        if Q.is_qtensor(w):
            return ops.int8_expert_matmul(a, w.q, w.scale, counts)
        return ops.expert_matmul(a, w, counts)

    if arch.mlp == "relu2":
        inner = torch.relu(mm(buf, experts.w_up)).square()
    else:
        act = L.mlp_act(arch.mlp)
        inner = act(mm(buf, experts.w_gate)) * mm(buf, experts.w_up)
    return mm(inner, experts.w_down)


def moe_apply(arch: ArchConfig, block, h: torch.Tensor) -> torch.Tensor:
    """The MoE MLP of ``block`` (``router``, ``moe.*``, ``shared.*``) on
    the normed activations ``h`` [B, S, D] -> [B, S, D]."""
    b, s, d = h.shape
    t, e, k = b * s, arch.num_experts, arch.top_k
    cap = capacity(arch, t)
    hf = h.reshape(t, d)
    gates, idx = route(arch, hf, block.router)
    order, dest, keep = dispatch(arch, idx, cap)
    src_tok = order // k

    buf = torch.zeros((e * cap + 1, d), dtype=h.dtype, device=h.device)
    buf[dest] = hf[src_tok]  # dropped assignments all land on the spare row
    out = expert_ffn(arch, block.moe, buf[:e * cap].reshape(e, cap, d),
                     expert_counts(arch, idx, cap))

    out_flat = out.reshape(e * cap, d)
    contrib = torch.where(keep[:, None],
                          out_flat[torch.clamp(dest, max=e * cap - 1)], 0.0)
    terms = (contrib.float() * gates.reshape(-1)[order][:, None]).to(h.dtype)
    # token i's assignments sit at the sorted places inv[i*k .. i*k+k-1];
    # sorted ascending they are its experts in ascending id
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=order.device)
    places = torch.sort(inv.reshape(t, k), dim=1).values
    per_tok = terms[places]  # [T, k, D]
    y = per_tok[:, 0]
    for j in range(1, k):
        y = y + per_tok[:, j]
    y = y.reshape(b, s, d)
    if hasattr(block, "shared"):
        y = y + L.mlp_apply(block.shared, h, arch.mlp)
    return y
