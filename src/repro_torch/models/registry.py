"""Step builders of the port (mirrors ``repro/models/registry.py``).

  init_params(arch, seed)                      -> LM or EncDec (random, seeded)
  train_step(model, opt_state, batch)          -> (model, opt_state, metrics)
  prefill_step(model, tokens)                  -> (caches, last_logits)
  serve_step(model, caches, batch)             -> (next_token, caches)
  serve_step(model, caches, state)             -> (state', caches', record)
  serve_step({"target", "draft"}, caches, state)   (``spec=SpecConfig``)

The second ``serve_step`` form (``sampling`` given) is the serving
runtime's fused step: token choice (greedy, or seeded temperature/top-k
with the per-slot keys of ``state.rng``) and the per-slot lifecycle
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

For the encdec family (an :class:`~repro_torch.models.encdec.EncDec`)
the step decodes against the state's ``enc_out`` with its ``enc_len``
(both written in place at admission, read inside the captured step),
as the reference's encdec branch does; the record is unchanged.

With ``spec`` the step is the speculative one (:func:`_build_spec_serve_step`):
the draft model proposes k tokens, the target verifies k + 1 positions
in one forward, and the longest accepted prefix commits; its record's
``token``/``emit`` are ``[slots, k + 1]`` and it adds ``committed``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import DeviceLike, default_dtype, resolve_device
from repro_torch.models.encdec import EncDec
from repro_torch.models.lm import LM


def init_params(arch: ArchConfig, seed: int = 0, *, device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None):
    """A randomly initialised ``LM`` (``EncDec`` for the encdec family)
    on ``device`` (default ``cuda``), drawn from a ``torch.Generator`` on
    that device seeded with ``seed`` (bf16 on CUDA, fp32 on the CPU
    unless ``dtype`` is given)."""
    dev = resolve_device(device)
    cls = EncDec if arch.family == "encdec" else LM
    model = cls(arch, device=dev, dtype=default_dtype(dev, dtype))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model.init_(gen)
    return model


def batch_to_device(batch: Dict[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """A pipeline batch (numpy) on ``device``: through pinned host
    buffers with ``non_blocking`` copies on CUDA."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def build_train_step(arch: ArchConfig, cfg, lr_schedule: Optional[Callable]
                     = None, accum_steps: int = 1) -> Callable:
    """The reference's ``build_train_step`` for the dense, MoE and encdec
    families (``lm.check_trainable``): ``train_step(model, opt_state,
    batch) -> (model, opt_state, metrics)``; the loss is ``lm.loss_fn``,
    or for the encdec family ``encdec.loss_fn`` over the batch's
    ``frames``, as the reference branches; ``metrics`` = ``loss``,
    ``lr``, ``grad_norm``, ``clip_scale`` (0-dim tensors on the
    device). ``cfg`` is an
    ``optim.adamw.AdamWConfig``; the learning rate is
    ``lr_schedule(opt_state["step"])`` read before the step increments
    it (``cfg.lr`` without a schedule). With ``accum_steps > 1`` the
    batch is split into that many equal microbatches along dim 0, their
    gradients summed in fp32 buffers and scaled by ``1 / accum_steps``
    before the single update. The step turns on ``requires_grad`` of its
    model's parameters (serving models keep it off) and updates them in
    place (``optim.adamw.adamw_update``)."""
    from repro_torch.models import encdec as ED
    from repro_torch.models.lm import check_trainable, loss_fn
    from repro_torch.optim import adamw as OPT
    check_trainable(arch)

    def schedule(step: torch.Tensor) -> torch.Tensor:
        if lr_schedule is not None:
            return lr_schedule(step)
        return torch.full((), cfg.lr, dtype=torch.float32, device=step.device)

    def value_and_grad(model, params: dict, batch: dict):
        if arch.family == "encdec":
            loss = ED.loss_fn(model, batch["frames"], batch["tokens"],
                              batch["labels"])
        else:
            loss = loss_fn(model, batch["tokens"], batch["labels"])
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    def grads_of(model: LM, params: dict, batch: dict):
        if accum_steps <= 1:
            return value_and_grad(model, params, batch)
        b = batch["tokens"].shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} does not split into {accum_steps} "
                             f"microbatches")
        mb = b // accum_steps
        lsum = torch.zeros((), dtype=torch.float32, device=model.device)
        gsum = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}
        for i in range(accum_steps):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            lval, g = value_and_grad(model, params, micro)
            lsum = lsum + lval
            for n in gsum:
                gsum[n] += g[n]
        inv = 1.0 / accum_steps
        return lsum * inv, {n: g * inv for n, g in gsum.items()}

    def train_step(model: LM, opt_state: dict, batch):
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        batch = batch_to_device(batch, model.device)
        lval, grads = grads_of(model, params, batch)
        lr = schedule(opt_state["step"])
        _, opt_state, info = OPT.adamw_update(params, grads, opt_state, cfg,
                                              lr, OPT.default_groups(model))
        return model, opt_state, {"loss": lval, "lr": lr, **info}

    return train_step


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


def check_spec_supported(arch: ArchConfig, draft: Optional[ArchConfig]) -> None:
    """The reference's pairing rules for speculative decoding: a draft
    given, both models dense and non-windowed, one vocabulary."""
    if draft is None:
        raise ValueError("SpecConfig.draft unresolved: set SpecConfig(draft=...)"
                         " (the port has no plan to take a draft from)")
    for label, a in (("target", arch), ("draft", draft)):
        if a.family != "dense" or a.window:
            raise NotImplementedError(
                f"speculative decoding requires dense-attention non-windowed "
                f"LMs; {label} {a.name!r} has family {a.family!r}"
                + (f" and window {a.window}" if a.window else ""))
    if draft.vocab_size != arch.vocab_size:
        raise ValueError(f"draft vocab {draft.vocab_size} != target vocab "
                         f"{arch.vocab_size}: proposals must be target tokens")


def build_serve_step(arch: ArchConfig, *, sampling=None,
                     eos_id: Optional[int] = None,
                     paged: bool = False, spec=None) -> Callable:
    """Decode-step builder; see the module docstring for the forms."""
    if paged and sampling is None:
        raise ValueError("paged serve steps require the sampling "
                         "(state-threaded) form")
    if paged:
        from repro_torch.serving.pages import check_paged_supported
        check_paged_supported(arch)
    if spec is not None:
        if sampling is None:
            raise ValueError("speculative serve steps require the sampling "
                             "(state-threaded) form")
        check_spec_supported(arch, spec.draft)
        return _build_spec_serve_step(int(spec.k), sampling=sampling,
                                      eos_id=eos_id, paged=paged)
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
        if arch.family == "encdec":
            # every slot cross-attends its own enc_out row, padded source
            # positions masked by enc_len (0 on an inert slot)
            hidden, caches = model(state.tokens, state.enc_out, caches=caches,
                                   positions=state.positions,
                                   enc_lens=state.enc_len)
        else:
            hidden, caches = model(state.tokens, caches=caches,
                                   positions=state.positions,
                                   page_table=table)
        rng, nxt = SMP.sample(model.logits(hidden)[:, -1], state.rng,
                              sampling)
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
        if rng is not state.rng:
            state.rng.copy_(rng)
        return state, caches, record

    return serve_step


def _build_spec_serve_step(k: int, *, sampling,
                           eos_id: Optional[int] = None,
                           paged: bool = False) -> Callable:
    """The fused draft-k + batched-verify + commit step (the reference's
    ``_build_spec_serve_step``), on ``{"target": LM, "draft": LM}``, the
    target's caches (grid or pools) and a state with ``draft_caches``.

    Draft: k + 1 single-token forwards on the draft's grid (append mode),
    the first k proposing greedily, the last the catch-up that writes
    d_k. Verify: one target forward over ``[cur, d_1..d_k]`` at
    ``p..p+k`` (append mode; the pool's stale-write gate as in the plain
    step). Commit, one sub-step j per verify position, following the
    reference line by line: sub-step j consumes ``in_j`` (``cur``, then
    ``d_j``) and samples ``t_j`` from the target's logits there; it runs
    (``can_j``) while the slot is live and ``in_j`` equals the previous
    sub-step's sample; a key advances only where it runs; EOS and the
    budget stop the slot. Everything is written in place, the state
    last, so the step keeps every address (the captured form)."""
    from repro_torch.serving import sampler as SMP
    from repro_torch.serving.state import DecodeState
    eos = -1 if eos_id is None else int(eos_id)

    def serve_step(params, caches, state: DecodeState):
        target, draft = params["target"], params["draft"]
        active = state.active
        cur = state.tokens[:, 0]
        pos0 = state.positions

        # draft: k greedy proposals, then the catch-up forward
        tok = state.tokens
        drafts = []
        for j in range(k + 1):
            dh, _ = draft(tok, caches=state.draft_caches, positions=pos0 + j,
                          append=True)
            if j < k:
                tok = torch.argmax(draft.logits(dh)[:, -1], dim=-1
                                   ).to(torch.int32)[:, None]
                drafts.append(tok[:, 0])
        drafts = torch.stack(drafts, dim=1)  # [B, k]

        # target: one verify over [cur, d_1..d_k] at p..p+k
        vtoks = torch.cat([state.tokens, drafts], dim=1)
        vpos = pos0 + torch.arange(k + 1, dtype=torch.int32,
                                   device=pos0.device)[None]
        table = None
        if paged:  # stale-write gate: inactive slots write the null page
            table = torch.where(active[:, None], state.page_table, 0)
        hidden, caches = target(vtoks, caches=caches, positions=vpos,
                                page_table=table, append=True)
        logits = target.logits(hidden)  # [B, k + 1, V]

        # longest-accepted-prefix commit, per slot
        keys = state.rng
        emitted = state.emitted
        alive = active    # survives the step (False after a stop)
        live = active     # still chaining within this step
        tokf = cur        # next step's input token
        zero = torch.zeros_like(emitted)
        pos_adv, seq_adv = zero, zero
        rec_tok, rec_emit = [], []
        t_prev = cur
        for j in range(k + 1):
            in_j = cur if j == 0 else drafts[:, j - 1]
            can = active if j == 0 else live & (in_j == t_prev)
            new_keys, t_j = SMP.sample(logits[:, j], keys, sampling)
            if new_keys is not keys:
                keys = torch.where(can[:, None], new_keys, keys)
            emit = can & (in_j != eos)
            emitted = emitted + emit.to(torch.int32)
            stop = emit & ((emitted >= state.max_new) | (t_j == eos))
            new_live = emit & ~stop
            tokf = torch.where(new_live, t_j, torch.where(can, in_j, tokf))
            alive = torch.where(can, new_live, alive)
            pos_adv = pos_adv + new_live.to(torch.int32)
            seq_adv = seq_adv + can.to(torch.int32)
            rec_tok.append(torch.where(emit, in_j, -1))
            rec_emit.append(emit)
            live, t_prev = new_live, t_j

        emit2d = torch.stack(rec_emit, dim=1)
        record = {"token": torch.stack(rec_tok, dim=1), "emit": emit2d,
                  "finished": active & ~alive,
                  "committed": emit2d.sum(dim=1).to(torch.int32)}
        a32 = active.to(torch.int32)
        # the state in place, after everything that reads it
        state.accepted.add_(seq_adv - a32)
        state.proposed.add_(k * a32)
        if state.seq_len is not None:
            state.seq_len.add_(seq_adv)
        state.tokens.copy_(tokf[:, None])
        state.positions.add_(pos_adv[:, None])
        state.emitted.copy_(emitted)
        state.active.copy_(alive)
        if keys is not state.rng:
            state.rng.copy_(keys)
        return state, caches, record

    return serve_step
