"""Serving engine: continuous batching with one-step-lookahead dispatch.

Mirrors the fused paths of ``repro/serving/engine.py`` (greedy, seeded
temperature/top-k, speculative; decoder-only and encoder-decoder). Step N+1 is
enqueued on the card before step N's per-slot record is read back, so
the host's bookkeeping overlaps the device's decode work:

    step N:    [retire N-2] [admit] [dispatch N] --+ device runs N
    step N+1:  [retire N-1] [admit] [dispatch N+1] + host never waits

Each step's record (tokens / emit / finished per slot) is copied to the
host without blocking and a CUDA event is recorded after it; retiring a
record waits on its event, and a record whose event has completed is
retired early at no cost (the JAX engine polls ``is_ready`` instead).
``lookahead=0`` retires every record in the step that made it.

The decode step is a :class:`~repro_torch.serving.captured.CapturedStep`:
on CUDA one CUDA graph, captured when the engine is built and replayed
by every ``step()``, over caches and a ``DecodeState`` that live at
fixed addresses and are written in place (admission included); on the
CPU the same in-place step runs eagerly through the kernels' plain
versions. Admission (prefill, splice) stays eager.

With ``ServeConfig(paging=PagingConfig(paged=True))`` (the dense and
MoE families; the MoE family without prefix reuse) the KV lives in page
pools (``serving/pages.py``) and the state carries
a page table. A finished slot's pages are released when its record is
retired; under lookahead 1 the step in flight at that moment no longer
writes them (its table row for the slot is zeroed by the stale-write
gate of the serve step) and any reuse by a later admission is enqueued
behind it on the same stream.

The encdec family (seamless-m4t-medium, an
:class:`~repro_torch.models.encdec.EncDec`) serves on the slot grid: its
state carries each slot's encoder output ``enc_out [slots,
max_src_len, D]`` and source length ``enc_len``, written at admission
(``ServeConfig.max_src_len`` bounds a request's frames) and read by the
captured step. The vlm family (paligemma-3b) serves on the grid and the
pool; a request's patch embeddings ride in its cache row.

With ``ServeConfig(spec=SpecConfig(draft=..., k=...))`` (both models
dense) the step is the speculative one: the draft proposes k tokens, the
target verifies k + 1 positions in one forward and up to k + 1 tokens
commit per slot and step; params are ``{"target": LM, "draft": LM}``,
the draft's dense grid lives in ``state.draft_caches`` (prefilled over
the full prompt at admission), and the step is captured like the plain
one. Under INT8 only the target is quantised (its weights, its grid or
pool), as in the reference; the draft and its grid stay fp in ``dtype``.
"""
from __future__ import annotations

import time
import warnings
from collections import deque
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.stats import percentile
from repro_torch import quant as Q
from repro_torch.device import DeviceLike, default_dtype, resolve_device
from repro_torch.models import registry as REG
from repro_torch.models.lm import LM
from repro_torch.serving import pages as PG
from repro_torch.serving.captured import CapturedStep, unpack_record
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.scheduler import Request, Scheduler
from repro_torch.serving.state import make_decode_state

__all__ = ["ServingEngine", "Request", "IncompleteDrainError", "ServeConfig"]


class IncompleteDrainError(RuntimeError):
    """``run_until_drained`` hit ``max_steps`` with requests in flight."""

    def __init__(self, msg: str, unfinished: List[int]):
        super().__init__(msg)
        self.unfinished = unfinished


class _Record:
    """One step's per-slot record on its way to the host: ``[2c + 1,
    slots]`` int32 (``captured.pack_record``), copied without blocking; on
    the card a
    CUDA event marks the copy's completion. On the card ``packed`` is the
    captured step's static output: the copy is enqueued right after the
    replay that wrote it, on the same stream, so the next replay cannot
    overwrite it first."""

    def __init__(self, packed: torch.Tensor):
        self.event = None
        if packed.is_cuda:
            self.host = packed.to("cpu", non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = packed

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def read(self):
        """(token ``[slots, c]``, emit ``[slots, c]``, finished
        ``[slots]``) as numpy arrays."""
        if self.event is not None:
            self.event.synchronize()
        return unpack_record(self.host.numpy())


class ServingEngine:
    """``ServingEngine(arch, params, config=ServeConfig(slots=..., max_len=...))``.

    ``params`` is the :class:`~repro_torch.models.lm.LM` to serve (with
    ``config.spec``, the pair ``{"target": LM, "draft": LM}``). The
    engine takes it over: it is moved in place (``nn.Module.to``) to
    ``device`` and ``dtype`` and, under int8 weights, quantised in place,
    so a second engine needs a model of its own.

    ``config.sampling`` (:class:`~repro_torch.serving.sampler.SamplingParams`)
    picks greedy, temperature or top-k; a sampled request draws with the
    key ``fold_in(PRNGKey(config.seed), rid)``, JAX's, so its stream does
    not depend on its slot, its step or the lookahead.

    ``config.spec`` (:class:`~repro_torch.serving.config.SpecConfig`)
    turns on speculative decoding with ``spec.draft`` proposing
    ``spec.k`` tokens a step (the reference's pairing rules: both dense
    and non-windowed, one vocabulary). A quantising ``config.quant``
    applies to the target only; the draft stays fp.

    ``device=None`` means ``cuda`` and raises without a CUDA device; pass
    ``device="cpu"`` to serve on the CPU through the kernels' plain
    versions. ``dtype`` defaults to bf16 on CUDA and fp32 on the CPU and
    is the dtype of the params and the KV grid.

    ``config.quant`` (:class:`~repro_torch.quant.QuantConfig`, e.g.
    ``INT8_SERVE``) selects INT8 serving, for every family the port
    serves. ``weights="int8"`` quantises the params once, on the device
    and after the move to ``dtype`` (per-channel, with the reference's
    stack-wide scales, ``quant.quantize_params``; the fp copies are
    dropped; a model quantised already is served as it is); every
    projection then runs through ``quant_matmul`` (the MoE family's
    expert products through ``quant_matmul_experts``). As in the
    reference, whose INT8 step dequantises its params to fp32, the
    activations of that forward are fp32 whatever ``dtype`` is (the
    embedding, norms, attention, the recurrences, the encoder); only the
    KV grid, the recurrent states' conv window, the encdec family's
    ``enc_out`` and ``final_norm`` keep ``dtype``. ``kv="int8"`` makes
    the grid (or pool) int8 with per-token f32 scales, filled by
    quantising the fresh K/V, read by the int8 body of
    ``paged_attention``; with fp weights the activations stay in
    ``dtype``. Weights-only int8 on CUDA needs ``dtype=torch.float32``
    (the fp decode kernel takes one dtype for q and the grid).

    ``config.paging`` (:class:`~repro_torch.serving.config.PagingConfig`)
    with ``paged=True`` replaces the slot grid by page pools of
    ``page_size`` tokens (default 64) and ``kv_pages`` pages (default
    the dense equivalent plus the null page), int8 under ``kv="int8"``;
    ``prefix_cache`` (default True) shares prompt prefixes across
    requests (not in the MoE family, whose routing couples a prefill
    group's rows; in the vlm family only text-only prompts). Only the
    dense, MoE and vlm families page (the reference's
    ``PAGED_FAMILIES``): the hybrid, ssm and encdec families raise
    ``ValueError``.

    ``config.max_src_len`` (default ``max_len``): the encdec family's
    bound on a request's source frames, the width of ``state.enc_out``.
    An encdec request needs ``src_frames`` ([S_src, D], at most
    ``max_src_len``); a vlm request may carry ``patch_embeds`` ([P, D])."""

    def __init__(self, arch: ArchConfig, params: LM, *,
                 config: ServeConfig, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None):
        dev = resolve_device(device)
        dtype = default_dtype(dev, dtype)
        config = config.resolve()
        paging = config.paging
        if paging.paged:
            PG.check_paged_supported(arch)
        quant = config.quant
        spec = config.spec
        if spec is not None:
            REG.check_spec_supported(arch, spec.draft)
            if not (isinstance(params, dict)
                    and set(params) == {"target", "draft"}):
                raise TypeError("speculative serving takes params as "
                                "{'target': LM, 'draft': LM}")
        if quant.quant_weights and not quant.quant_kv \
                and dev.type == "cuda" and dtype != torch.float32:
            raise NotImplementedError(
                f"int8 weights with a {dtype} KV grid are not ported on "
                f"CUDA (fp32 activations, one dtype per decode kernel): use "
                f"QuantConfig(weights='int8', kv='int8') or dtype=float32")
        self.arch = arch
        self.config = config
        self.device = dev
        self.slots, self.max_len = config.slots, config.max_len
        self.eos_id = config.eos_id
        self.sampling = config.sampling
        self.lookahead = config.lookahead
        self.spec = spec
        self.draft = None
        if spec is not None:
            self.draft = params["draft"].to(device=dev, dtype=dtype)
            params = params["target"]
        self.model = params.to(device=dev, dtype=dtype)
        if quant.quant_weights and not self.model.weights_quantized:
            Q.quantize_params(self.model)  # the target only
        self.paged = paging.paged
        self.page_size = paging.page_size or PG.DEFAULT_PAGE_SIZE
        self.kv_pages = paging.kv_pages
        table_len = None
        if self.paged:
            if self.kv_pages is None:
                self.kv_pages = PG.default_kv_pages(self.slots, self.max_len,
                                                    self.page_size)
            table_len = PG.num_pages_per_slot(self.max_len, self.page_size)
            self.caches = PG.make_paged_caches(
                arch, self.kv_pages, self.page_size, device=dev, dtype=dtype,
                kv_quant=quant.quant_kv)
        else:
            self.caches = self.model.make_caches(self.slots, self.max_len,
                                                 dtype, kv_quant=quant.quant_kv)
        draft_caches = None
        if self.draft is not None:
            draft_caches = self.draft.make_caches(self.slots, self.max_len,
                                                  dtype)
        self.max_src_len = config.max_src_len
        enc_shape = ((self.max_src_len, arch.d_model)
                     if arch.family == "encdec" else None)
        self.state = make_decode_state(self.slots, dev, table_len,
                                       seed=config.seed,
                                       draft_caches=draft_caches,
                                       enc_shape=enc_shape, enc_dtype=dtype)
        # the step's params: the model, or the pair the spec step reads
        self.params = self.model if self.draft is None else \
            {"target": self.model, "draft": self.draft}
        # on CUDA: captured here, on the all-inactive state
        self.decode = CapturedStep(
            REG.build_serve_step(arch, sampling=self.sampling,
                                 eos_id=self.eos_id, paged=self.paged,
                                 spec=spec),
            self.params, self.caches, self.state)
        self.scheduler = Scheduler(
            arch, slots=self.slots, max_len=self.max_len, cache_dtype=dtype,
            sampling=self.sampling, seed=config.seed, kv_quant=quant.quant_kv,
            paged=self.paged, page_size=self.page_size,
            kv_pages=self.kv_pages, prefix_cache=paging.prefix_cache,
            draft=self.draft, max_src_len=self.max_src_len)
        self.completed: List[Request] = []
        self._pending: deque = deque()  # dispatched, unread step records
        self.step_times = deque(maxlen=4096)
        self.step_token_counts = deque(maxlen=4096)
        self.queue_depths = deque(maxlen=4096)
        # per retired record: tokens emitted, slots active at dispatch
        self.retired_emits = deque(maxlen=4096)
        self.retired_active = deque(maxlen=4096)

    # ------------------------- queue / slot views -------------------------
    @property
    def queue(self) -> List[Request]:
        return self.scheduler.queue

    @property
    def active(self) -> Dict[int, Optional[Request]]:
        return self.scheduler.active

    def submit(self, req: Request):
        self.scheduler.submit(req)

    def unfinished(self) -> List[int]:
        rids = [r.rid for r in self.queue]
        rids += [r.rid for r in self.active.values() if r is not None]
        return rids

    # ---------------------------- decode loop ----------------------------
    def step(self):
        """Retire the record(s) that fell out of the lookahead window (and
        any already complete), admit into the freed slots, dispatch the
        next decode step."""
        t0 = time.perf_counter()
        self.queue_depths.append(len(self.queue))
        emitted = 0
        while len(self._pending) > self.lookahead:
            emitted += self._retire_one()
        while self._pending and self._pending[0].ready():
            emitted += self._retire_one()
        self.scheduler.admit(self.model, self.caches, self.state)
        self._pending.append(_Record(self.decode()))
        if self.lookahead == 0:
            emitted += self._flush()
        self.step_times.append(time.perf_counter() - t0)
        self.step_token_counts.append(emitted)

    def _retire_one(self) -> int:
        """Read one record back and apply it: append emitted tokens (up to
        k + 1 a slot from a speculative step, in commit order), free
        finished slots."""
        token, emit, finished = self._pending.popleft().read()
        # emit.any(1) | finished: the slots active at dispatch (an active
        # slot emits, or finishes without emitting on EOS at prefill)
        self.retired_emits.append(int(emit.sum()))
        self.retired_active.append(int((emit.any(axis=1) | finished).sum()))
        count = 0
        for slot, req in self.active.items():
            if req is None:
                continue
            for j in range(token.shape[1]):
                if emit[slot, j]:
                    req.out_tokens.append(int(token[slot, j]))
                    count += 1
            if finished[slot]:
                req.finished_at = time.time()
                self.completed.append(req)
                self.active[slot] = None
                if self.paged:
                    self.scheduler.release_slot(slot)
        return count

    def _flush(self) -> int:
        count = 0
        while self._pending:
            count += self._retire_one()
        return count

    def run_until_drained(self, max_steps: int = 10_000, *,
                          on_incomplete: str = "raise") -> int:
        """Step until every submitted request completed; returns the step
        count. Hitting ``max_steps`` with requests in flight raises
        :class:`IncompleteDrainError` (``on_incomplete="warn"`` warns).
        Step/prefill telemetry is reset on entry."""
        if on_incomplete not in ("raise", "warn"):
            raise ValueError(f"on_incomplete must be 'raise' or 'warn', "
                             f"got {on_incomplete!r}")
        self.reset_step_stats()
        steps = 0
        while (self.queue or self.scheduler.has_active()) and steps < max_steps:
            self.step()
            steps += 1
            if not self.queue and not self.scheduler.has_active():
                self._flush()
        if self.queue or self.scheduler.has_active():
            self._flush()
        if self.queue or self.scheduler.has_active():
            rids = self.unfinished()
            msg = (f"run_until_drained: {len(rids)} request(s) still in "
                   f"flight after {steps} steps (max_steps={max_steps}): "
                   f"rids={rids}")
            if on_incomplete == "raise":
                raise IncompleteDrainError(msg, rids)
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return steps

    # ------------------------- step-timing hooks -------------------------
    def reset_step_stats(self):
        self.step_times.clear()
        self.step_token_counts.clear()
        self.queue_depths.clear()
        self.retired_emits.clear()
        self.retired_active.clear()
        self.scheduler.reset_stats()

    def step_stats(self) -> Dict[str, float]:
        """p50/p95 wall time of ``step()`` calls (host clock) and the token
        throughput over them. ``accepted_tokens_mean`` is the tokens
        committed per active slot-step (1.0 without speculation, up to
        k + 1 with it); a speculative engine adds ``draft_acceptance``,
        accepted over proposed draft tokens of the resident requests
        (the state's counters, zeroed at admission; one device read)."""
        ms = [t * 1e3 for t in self.step_times]
        total_s = sum(self.step_times)
        toks = sum(self.step_token_counts)
        qd = list(self.queue_depths)
        emits, actives = sum(self.retired_emits), sum(self.retired_active)
        stats = {
            "steps": float(len(ms)),
            "step_p50_ms": percentile(ms, 50),
            "step_p95_ms": percentile(ms, 95),
            "step_mean_ms": (sum(ms) / len(ms)) if ms else 0.0,
            "tokens": float(toks),
            "tokens_per_s": toks / total_s if total_s > 0 else 0.0,
            "queue_depth": (sum(qd) / len(qd)) if qd else 0.0,
            "accepted_tokens_mean": (emits / actives) if actives else 0.0,
        }
        if self.spec is not None:
            acc = float(self.state.accepted.sum())
            prop = float(self.state.proposed.sum())
            stats["draft_acceptance"] = acc / prop if prop else 0.0
        return stats

    def prefill_stats(self) -> Dict[str, float]:
        """Per-request and per-dispatch admission wall (host clock).
        ``prefix_hit_rate`` is the fraction of prefix-registry lookups that
        aliased shared pages (0.0 without a registry);
        ``shared_dispatches`` counts the dispatches of shared-prefix
        groups among ``prefill_dispatches``."""
        sched = self.scheduler
        ms = [t * 1e3 for t in sched.prefill_times]
        lens = list(sched.prefill_prompt_lens)
        disp_ms = [t * 1e3 for t in sched.prefill_dispatch_times]
        sizes = list(sched.prefill_batch_sizes)
        reg = sched.registry
        looked = (reg.hits + reg.misses) if reg is not None else 0
        return {
            "prefix_hit_rate": (reg.hits / looked) if looked else 0.0,
            "shared_dispatches": float(sched.prefill_shared_groups),
            "prefills": float(len(ms)),
            "prefill_p50_ms": percentile(ms, 50),
            "prefill_p95_ms": percentile(ms, 95),
            "prefill_mean_ms": (sum(ms) / len(ms)) if ms else 0.0,
            "prompt_tokens": float(sum(lens)),
            "prefill_tokens_per_s": (sum(lens) / (sum(sched.prefill_times) or 1.0)
                                     if ms else 0.0),
            "prefill_dispatches": float(len(disp_ms)),
            "admit_p50_ms": percentile(disp_ms, 50),
            "admit_p95_ms": percentile(disp_ms, 95),
            "prefill_batch_mean": (sum(sizes) / len(sizes)) if sizes else 0.0,
        }
