"""Admission, slot lifecycle and batched bucketed prefill.

Mirrors the dense ``"lm"`` path of ``repro/serving/scheduler.py``: a FIFO
queue, the slot -> request map, and admission that pads each prompt to
its power-of-two bucket (>= ``MIN_BUCKET``), prefills every waiting
request of one bucket as one batched forward, splices the rows into the
slot grid and admits them into the :class:`DecodeState` with one scatter
per field. The splice writes into the grid in place (the JAX package
donates the grid to a jitted ``dynamic_update_slice``).

K/V that a shorter bucket leaves in a grid row's tail are stale; the
spliced ``pos`` leaf marks them ``-1``, and decode never reads past a
row's length anyway.

The hybrid family (recurrentgemma-2b) prefills with the rows' true
lengths (``seq_lens``), so its recurrent states and windowed rings are
length-exact; its buckets start at ``bucket_floor`` (the window), so a
prefill row's ring has as many slots as the grid's, and a splice copies
whole rows of ring and state leaves. The ssm family (xlstm-350m)
prefills with ``seq_lens`` too; it has no window, so its buckets start
at ``MIN_BUCKET``, and its mLSTM and sLSTM states are spliced as whole
rows.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import LM
from repro_torch.serving import sampler as SMP
from repro_torch.serving.state import DecodeState, admit_rows

MIN_BUCKET = 8


class RequestValidationError(ValueError):
    """A request was rejected at ``submit()``."""


class Request:
    """One serving request: a token prompt and an emission budget."""

    def __init__(self, rid: int, prompt: np.ndarray, max_new_tokens: int = 16,
                 *, out_tokens: Optional[List[int]] = None,
                 submitted_at: float = 0.0, finished_at: float = 0.0):
        self.rid = rid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.out_tokens: List[int] = [] if out_tokens is None else out_tokens
        self.submitted_at = submitted_at
        self.finished_at = finished_at

    def __repr__(self) -> str:
        return (f"Request(rid={self.rid}, prompt_len={len(self.prompt)}, "
                f"max_new_tokens={self.max_new_tokens})")


def bucket_floor(arch: ArchConfig, max_len: int,
                 min_bucket: int = MIN_BUCKET) -> int:
    """Smallest admissible bucket: windowed archs must build prefill rows
    whose ring size equals the grid's (``min(bucket, window)`` ==
    ``min(max_len, window)``), so their floor is the window."""
    if not arch.window:
        return min_bucket
    return max(min_bucket, min(arch.window, max_len))


def bucket_len(prompt_len: int, max_len: int, *,
               min_bucket: int = MIN_BUCKET) -> int:
    """Power-of-two bucket >= prompt_len, clamped to ``max_len``."""
    b = min_bucket
    while b < prompt_len:
        b *= 2
    return min(b, max_len)


def invalidate_padding(rows: List[dict], lens: torch.Tensor) -> List[dict]:
    """Mark ``pos`` entries at or beyond each row's true length ``-1``
    (the stored position, not the ring index, is compared; recurrent
    states have no ``pos``)."""
    out = []
    for c in rows:
        if "pos" in c:
            c = dict(c, pos=torch.where(c["pos"] < lens[:, None], c["pos"], -1))
        out.append(c)
    return out


def splice_rows(grid: List[dict], rows: List[dict], slots: torch.Tensor) -> None:
    """Write ``n`` stacked prefill rows into the grid at ``slots [n]``, in
    place: every leaf a row carries (k/v, and the int8 grid's scales).
    Rows shorter than the grid leave the tail of those leaves untouched
    and pad ``pos`` with ``-1``. A recurrent state (RG-LRU ``h``,
    ``conv``; mLSTM ``C``, ``n``, ``m``; sLSTM ``c``, ``n``, ``h``,
    ``m``) is copied whole."""
    for g, r in zip(grid, rows):
        if "pos" not in r:
            for name, leaf in r.items():
                g[name][slots] = leaf.to(g[name].dtype)
            continue
        s = r["k"].shape[1]
        for name, leaf in r.items():
            if name != "pos":
                g[name][slots, :s] = leaf.to(g[name].dtype)
        pos = torch.full((slots.shape[0], g["pos"].shape[1]), -1,
                         dtype=torch.int32, device=g["pos"].device)
        pos[:, :s] = r["pos"]
        g["pos"][slots] = pos


def prefill_rows(model: LM, tokens: torch.Tensor, lens: torch.Tensor,
                 cache_dtype: Optional[torch.dtype] = None,
                 kv_quant: bool = False) -> Tuple[List[dict], torch.Tensor]:
    """Batched bucketed prefill: tokens [n, bucket] right-padded, ``lens``
    [n] true lengths. Returns the length-exact cache rows (``pos`` past
    each length invalidated; int8 with scales when ``kv_quant``) and the
    logits at each row's last valid position, [n, 1, V]."""
    n, bucket = tokens.shape
    caches = model.make_caches(n, bucket, cache_dtype, kv_quant=kv_quant)
    hidden, rows = model(tokens, caches=caches, seq_lens=lens)
    last = hidden[torch.arange(n, device=hidden.device), lens.long() - 1]
    logits = model.logits(last[:, None])
    return invalidate_padding(rows, lens), logits


class Scheduler:
    """Host-side slot lifecycle; device mutation goes through the model,
    :func:`splice_rows` and :func:`admit_rows`."""

    def __init__(self, arch: ArchConfig, *, slots: int, max_len: int,
                 cache_dtype: torch.dtype,
                 sampling: SMP.SamplingParams = SMP.GREEDY,
                 min_bucket: int = MIN_BUCKET, kv_quant: bool = False):
        self.arch = arch
        self.slots = slots
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.kv_quant = kv_quant
        self.sampling = sampling
        self.min_bucket = bucket_floor(arch, max_len, min_bucket)
        self.queue: List[Request] = []
        self.active: Dict[int, Optional[Request]] = {i: None for i in range(slots)}
        # host wall per admission (dispatch of prefill + splice + admit);
        # the device work overlaps the in-flight decode step
        self.prefill_times = deque(maxlen=4096)
        self.prefill_prompt_lens = deque(maxlen=4096)
        self.prefill_dispatch_times = deque(maxlen=4096)
        self.prefill_batch_sizes = deque(maxlen=4096)

    def submit(self, req: Request) -> None:
        total = len(req.prompt)
        if total > self.max_len:
            raise RequestValidationError(
                f"request {req.rid}: prompt length {total} exceeds max_len "
                f"{self.max_len}")
        if total + req.max_new_tokens > self.max_len:
            raise RequestValidationError(
                f"request {req.rid}: prompt {total} + max_new_tokens "
                f"{req.max_new_tokens} exceeds max_len {self.max_len} "
                f"(the slot's KV row holds prompt and decoded tokens)")
        req.submitted_at = time.time()
        self.queue.append(req)

    def has_active(self) -> bool:
        return any(r is not None for r in self.active.values())

    def admit(self, model: LM, caches: List[dict], state: DecodeState):
        """Fill free slots from the queue; returns updated (caches, state).
        All waiting requests of one bucket become one batched prefill, one
        splice and one state scatter."""
        free = [s for s, occ in self.active.items() if occ is None]
        take = min(len(free), len(self.queue))
        if take == 0:
            return caches, state
        pairs = list(zip(self.queue[:take], free))
        del self.queue[:take]
        groups: Dict[int, List[Tuple[Request, int]]] = {}
        for req, slot in pairs:
            bucket = bucket_len(len(req.prompt), self.max_len,
                                min_bucket=self.min_bucket)
            groups.setdefault(bucket, []).append((req, slot))

        dev = model.device
        for bucket, group in sorted(groups.items()):
            t0 = time.perf_counter()
            n = len(group)
            toks = np.zeros((n, bucket), np.int32)
            lens = np.zeros((n,), np.int32)
            slots_arr = np.zeros((n,), np.int64)
            max_new = np.zeros((n,), np.int32)
            for i, (req, slot) in enumerate(group):
                s = len(req.prompt)
                toks[i, :s] = req.prompt
                lens[i] = s
                slots_arr[i] = slot
                max_new[i] = req.max_new_tokens
            lens_t = torch.from_numpy(lens).to(dev)
            slots_t = torch.from_numpy(slots_arr).to(dev)
            rows, logits = prefill_rows(model, torch.from_numpy(toks).to(dev),
                                        lens_t, self.cache_dtype,
                                        kv_quant=self.kv_quant)
            splice_rows(caches, rows, slots_t)
            first = SMP.sample(logits[:, -1], self.sampling)
            state = admit_rows(state, slots_t, first, lens_t,
                               torch.from_numpy(max_new).to(dev))
            for req, slot in group:
                self.active[slot] = req
            wall = time.perf_counter() - t0
            self.prefill_dispatch_times.append(wall)
            self.prefill_batch_sizes.append(n)
            for req, _ in group:
                self.prefill_times.append(wall / n)
                self.prefill_prompt_lens.append(len(req.prompt))
        return caches, state

    def reset_stats(self) -> None:
        self.prefill_times.clear()
        self.prefill_prompt_lens.clear()
        self.prefill_dispatch_times.clear()
        self.prefill_batch_sizes.clear()
