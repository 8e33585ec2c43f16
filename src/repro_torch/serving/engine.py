"""Serving engine: continuous batching with one-step-lookahead dispatch.

Mirrors the dense greedy path of ``repro/serving/engine.py``. Step N+1 is
enqueued on the card before step N's per-slot record is read back, so
the host's bookkeeping overlaps the device's decode work:

    step N:    [retire N-2] [admit] [dispatch N] --+ device runs N
    step N+1:  [retire N-1] [admit] [dispatch N+1] + host never waits

Each step's record (token / emit / finished per slot) is copied to the
host without blocking and a CUDA event is recorded after it; retiring a
record waits on its event, and a record whose event has completed is
retired early at no cost (the JAX engine polls ``is_ready`` instead).
``lookahead=0`` retires every record in the step that made it.
"""
from __future__ import annotations

import time
import warnings
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.stats import percentile
from repro_torch import quant as Q
from repro_torch.device import DeviceLike, default_dtype, resolve_device
from repro_torch.models import registry as REG
from repro_torch.models.lm import LM
from repro_torch.serving import sampler as SMP
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
    """One step's per-slot record on its way to the host: ``[3, slots]``
    int32 (token, emit, finished), copied without blocking; on the card a
    CUDA event marks the copy's completion."""

    def __init__(self, rec: Dict[str, torch.Tensor]):
        packed = torch.stack([rec["token"].to(torch.int32),
                              rec["emit"].to(torch.int32),
                              rec["finished"].to(torch.int32)])
        self.event = None
        if packed.is_cuda:
            self.host = packed.to("cpu", non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = packed

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def read(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class ServingEngine:
    """``ServingEngine(arch, params, config=ServeConfig(slots=..., max_len=...))``.

    ``params`` is the :class:`~repro_torch.models.lm.LM` to serve. The
    engine takes it over: it is moved in place (``nn.Module.to``) to
    ``device`` and ``dtype`` and, under int8 weights, quantised in place,
    so a second engine needs a model of its own.
    ``device=None`` means ``cuda`` and raises without a CUDA device; pass
    ``device="cpu"`` to serve on the CPU through the kernels' plain
    versions. ``dtype`` defaults to bf16 on CUDA and fp32 on the CPU and
    is the dtype of the params and the KV grid.

    ``config.quant`` (:class:`~repro_torch.quant.QuantConfig`, e.g.
    ``INT8_SERVE``) selects INT8 serving. ``weights="int8"`` quantises
    the params once, on the device and after the move to ``dtype``
    (per-channel, with the reference's layer-stack-wide scales; the fp
    copies are dropped); every projection then runs through
    ``quant_matmul``. As in the reference, whose INT8 step dequantises
    its params to fp32, the activations of that forward are fp32
    whatever ``dtype`` is (the embedding, norms, attention); only the
    KV grid and ``final_norm`` keep ``dtype``. ``kv="int8"`` makes the
    grid int8 with per-token f32 scales, filled by quantising the fresh
    K/V, read by the int8 body of ``paged_attention``; with fp weights
    the activations stay in ``dtype``. Weights-only int8 on CUDA needs
    ``dtype=torch.float32`` (the fp decode kernel takes one dtype for q
    and the grid)."""

    def __init__(self, arch: ArchConfig, params: LM, *,
                 config: ServeConfig, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None):
        dev = resolve_device(device)
        dtype = default_dtype(dev, dtype)
        config = config.resolve()
        if config.paging.paged:
            raise NotImplementedError("paged KV is not ported yet; serve "
                                      "with PagingConfig(paged=False)")
        SMP.check_supported(config.sampling)
        quant = config.quant
        if arch.family in ("hybrid", "ssm") \
                and (quant.quant_weights or quant.quant_kv):
            leaves = ("gate, a_param and conv" if arch.family == "hybrid"
                      else "gate (w_i, w_f, b_i, b_f), r and b")
            raise NotImplementedError(
                f"{arch.name}: INT8 serving of the {arch.family} family is "
                f"not ported yet (its {leaves} leaves need their own check; "
                f"see ROADMAP A5)")
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
        self.model = params.to(device=dev, dtype=dtype)
        if quant.quant_weights:
            Q.quantize_params(self.model)
        self.caches = self.model.make_caches(self.slots, self.max_len, dtype,
                                             kv_quant=quant.quant_kv)
        self.state = make_decode_state(self.slots, dev)
        self._serve_step = REG.build_serve_step(arch, sampling=self.sampling,
                                                eos_id=self.eos_id)
        self.scheduler = Scheduler(arch, slots=self.slots,
                                   max_len=self.max_len, cache_dtype=dtype,
                                   sampling=self.sampling,
                                   kv_quant=quant.quant_kv)
        self.completed: List[Request] = []
        self._pending: deque = deque()  # dispatched, unread step records
        self.step_times = deque(maxlen=4096)
        self.step_token_counts = deque(maxlen=4096)
        self.queue_depths = deque(maxlen=4096)

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
        self.caches, self.state = self.scheduler.admit(
            self.model, self.caches, self.state)
        self.state, self.caches, record = self._serve_step(
            self.model, self.caches, self.state)
        self._pending.append(_Record(record))
        if self.lookahead == 0:
            emitted += self._flush()
        self.step_times.append(time.perf_counter() - t0)
        self.step_token_counts.append(emitted)

    def _retire_one(self) -> int:
        """Read one record back and apply it: append emitted tokens, free
        finished slots."""
        token, emit, finished = self._pending.popleft().read()
        count = 0
        for slot, req in self.active.items():
            if req is None:
                continue
            if emit[slot]:
                req.out_tokens.append(int(token[slot]))
                count += 1
            if finished[slot]:
                req.finished_at = time.time()
                self.completed.append(req)
                self.active[slot] = None
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
        self.scheduler.reset_stats()

    def step_stats(self) -> Dict[str, float]:
        """p50/p95 wall time of ``step()`` calls (host clock) and the token
        throughput over them."""
        ms = [t * 1e3 for t in self.step_times]
        total_s = sum(self.step_times)
        toks = sum(self.step_token_counts)
        qd = list(self.queue_depths)
        return {
            "steps": float(len(ms)),
            "step_p50_ms": percentile(ms, 50),
            "step_p95_ms": percentile(ms, 95),
            "step_mean_ms": (sum(ms) / len(ms)) if ms else 0.0,
            "tokens": float(toks),
            "tokens_per_s": toks / total_s if total_s > 0 else 0.0,
            "queue_depth": (sum(qd) / len(qd)) if qd else 0.0,
        }

    def prefill_stats(self) -> Dict[str, float]:
        """Per-request and per-dispatch admission wall (host clock)."""
        sched = self.scheduler
        ms = [t * 1e3 for t in sched.prefill_times]
        lens = list(sched.prefill_prompt_lens)
        disp_ms = [t * 1e3 for t in sched.prefill_dispatch_times]
        sizes = list(sched.prefill_batch_sizes)
        return {
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
