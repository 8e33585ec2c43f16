"""Step builders of the port (mirrors ``repro/models/registry.py``).

  init_params(arch, seed)                      -> LM (random, seeded)
  prefill_step(model, tokens)                  -> (caches, last_logits)
  serve_step(model, caches, batch)             -> (next_token, caches)
  serve_step(model, caches, state)             -> (state', caches', record)

The second ``serve_step`` form (``sampling`` given) is the serving
runtime's fused step: greedy token choice and the per-slot lifecycle
(EOS, emission budget, position advance) on the device, returning only a
small per-slot record ``{token, emit, finished}`` for the host to read.
It updates the caches and the state in place and returns the same
objects, so every leaf keeps its address: the form the engine captures
as one CUDA graph (``serving/captured.py``), where the reference jits
the step with its caches and state donated.
With ``paged=True`` the state carries a page table and the caches are
page pools; inactive slots' table rows are zeroed inside the step (the
stale-write gate), so the host's lagging retire bookkeeping under
lookahead can never route a write into a freed, possibly re-allocated,
page.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import DeviceLike, default_dtype, resolve_device
from repro_torch.models.lm import LM


def init_params(arch: ArchConfig, seed: int = 0, *, device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None) -> LM:
    """A randomly initialised ``LM`` on ``device`` (default ``cuda``),
    drawn from a ``torch.Generator`` on that device seeded with ``seed``
    (bf16 on CUDA, fp32 on the CPU unless ``dtype`` is given)."""
    dev = resolve_device(device)
    model = LM(arch, device=dev, dtype=default_dtype(dev, dtype))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model.init_(gen)
    return model


def build_prefill_step(arch: ArchConfig, shape: ShapeConfig,
                       cache_dtype: Optional[torch.dtype] = None) -> Callable:
    """Prefill of ``shape.global_batch`` same-length prompts of
    ``shape.seq_len`` tokens into fresh caches of that length."""
    b, s = shape.global_batch, shape.seq_len

    def prefill_step(model: LM, tokens: torch.Tensor):
        caches = model.make_caches(b, s, cache_dtype)
        hidden, caches = model(tokens, caches=caches)
        return caches, model.logits(hidden[:, -1:])

    return prefill_step


def build_serve_step(arch: ArchConfig, *, sampling=None,
                     eos_id: Optional[int] = None,
                     paged: bool = False) -> Callable:
    """Decode-step builder; see the module docstring for the two forms."""
    if paged and sampling is None:
        raise ValueError("paged serve steps require the sampling "
                         "(state-threaded) form")
    if paged:
        from repro_torch.serving.pages import check_paged_supported
        check_paged_supported(arch)
    if sampling is None:
        def serve_step(model: LM, caches, batch):
            hidden, caches = model(batch["tokens"], caches=caches,
                                   positions=batch["positions"])
            logits = model.logits(hidden)
            return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), caches

        return serve_step

    from repro_torch.serving import sampler as SMP
    from repro_torch.serving.state import DecodeState
    eos = -1 if eos_id is None else int(eos_id)

    def serve_step(model: LM, caches, state: DecodeState):
        table = None
        if paged:  # stale-write gate: inactive slots write the null page
            table = torch.where(state.active[:, None], state.page_table, 0)
        hidden, caches = model(state.tokens, caches=caches,
                               positions=state.positions, page_table=table)
        nxt = SMP.sample(model.logits(hidden)[:, -1], sampling)
        cur = state.tokens[:, 0]
        active = state.active
        eos_at_prefill = active & (cur == eos)
        emit = active & ~eos_at_prefill
        emitted = state.emitted + emit.to(torch.int32)
        stop = emit & ((emitted >= state.max_new) | (nxt == eos))
        new_active = emit & ~stop
        record = {"token": torch.where(emit, cur, -1), "emit": emit,
                  "finished": active & ~new_active}
        # the state in place, after everything that reads it: inert slots
        # hold token/position so the grid stays fixed-shape
        state.tokens.copy_(torch.where(new_active, nxt, cur)[:, None])
        state.positions.add_(new_active.to(torch.int32)[:, None])
        if state.seq_len is not None:
            state.seq_len.add_(active.to(torch.int32))
        state.emitted.copy_(emitted)
        state.active.copy_(new_active)
        return state, caches, record

    return serve_step
