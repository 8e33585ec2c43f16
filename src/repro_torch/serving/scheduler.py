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

Paged (``paged=True``, the dense and MoE families; ``serving/pages.py``): each
admission reserves pages for prompt + decode budget from a host
:class:`~repro_torch.serving.pages.PagePool` and the prefill rows are
spliced into the pools through the slots' page-table rows. With the
prefix registry a prompt whose prefix is registered aliases the matched
full pages (and copies a frontier page matched mid-page before writing
into it), and its group ``("lm_shared", suffix bucket, m)`` prefills
only the suffix against the gathered prefix (:func:`prefill_shared`).
An admission the pool cannot hold goes back to the queue head, after
the registry releases its cold entries, and waits for retiring slots.
The MoE family pages without a registry, as the reference does: expert
capacity couples the rows of a prefill group, so a suffix-only prefill
would change what its companions' tokens are routed to.

In the MoE family every token of a prefill group, the pad positions of
its bucket included, is routed and takes expert capacity, as in the
reference; the groups (bucket and size) are the reference's, so the
routing is too.

Each request's first token is drawn at admission with its own key,
``fold_in(PRNGKey(seed), rid)`` (greedy leaves it as it is), and the key
after that draw goes into the state: keyed on the request id, a sampled
stream does not depend on the slot, the step or the lookahead. With a
speculative draft model (``draft``) every admission also prefills the
draft over the full prompt on a dense grid of its own (never suffix-only,
even where the target's prefill reuses a shared prefix) and splices the
rows into ``state.draft_caches``.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import LM
from repro_torch.serving import pages as PG
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


def prefill_shared(model: LM, pools: List[dict], page_rows: torch.Tensor,
                   m: int, tokens: torch.Tensor, lens: torch.Tensor
                   ) -> Tuple[List[dict], torch.Tensor]:
    """Compute-skip suffix prefill of one shared group: gather the prefix
    pages ``page_rows [n, span]`` (``pages.gather_prefix``) and run only
    the suffix tokens [n, bucket] through the stack at positions
    ``m..m+bucket-1``. ``lens`` [n] are the total prompt lengths. Returns
    the suffix's fp rows (``pos`` absolute, invalidated past each length:
    the paged splice routes them past the shared region) and the logits
    at each row's last position (``lens - m - 1`` in the suffix)."""
    n, bucket = tokens.shape
    dev = tokens.device
    pre = PG.gather_prefix(pools, page_rows, m)
    positions = m + torch.arange(bucket, dtype=torch.int32,
                                 device=dev)[None].expand(n, bucket)
    hidden, rows = model(tokens, caches=pre, positions=positions,
                         seq_lens=lens)
    last = hidden[torch.arange(n, device=dev), lens.long() - m - 1]
    return invalidate_padding(rows, lens), model.logits(last[:, None])


class Scheduler:
    """Host-side slot lifecycle; device mutation goes through the model,
    :func:`splice_rows` and :func:`admit_rows`."""

    def __init__(self, arch: ArchConfig, *, slots: int, max_len: int,
                 cache_dtype: torch.dtype,
                 sampling: SMP.SamplingParams = SMP.GREEDY, seed: int = 0,
                 min_bucket: int = MIN_BUCKET, kv_quant: bool = False,
                 paged: bool = False, page_size: int = PG.DEFAULT_PAGE_SIZE,
                 kv_pages: Optional[int] = None, prefix_cache: bool = True,
                 draft: Optional[LM] = None):
        self.arch = arch
        self.slots = slots
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.kv_quant = kv_quant
        self.sampling = sampling
        self.seed = seed
        self.draft = draft
        self.min_bucket = bucket_floor(arch, max_len, min_bucket)
        self.queue: List[Request] = []
        self.active: Dict[int, Optional[Request]] = {i: None for i in range(slots)}
        self.paged = paged
        self.page_size = page_size
        self.pool: Optional[PG.PagePool] = None
        self.registry: Optional[PG.PrefixRegistry] = None
        self.slot_pages: Dict[int, List[int]] = {}
        self._matches: Dict[int, Tuple[int, Tuple[int, ...], Optional[int]]] = {}
        if paged:
            PG.check_paged_supported(arch)
            self.table_len = PG.num_pages_per_slot(max_len, page_size)
            if kv_pages is None:
                kv_pages = PG.default_kv_pages(slots, max_len, page_size)
            self.pool = PG.PagePool(kv_pages, page_size)
            # MoE routing capacity couples the rows of a prefill group, so
            # a compute-skip suffix prefill would change its companions:
            # the MoE family pages its KV but keeps no prefix registry
            if prefix_cache and arch.family != "moe":
                self.registry = PG.PrefixRegistry(self.pool)
        # host wall per admission (dispatch of prefill + splice + admit);
        # the device work overlaps the in-flight decode step
        self.prefill_times = deque(maxlen=4096)
        self.prefill_prompt_lens = deque(maxlen=4096)
        self.prefill_dispatch_times = deque(maxlen=4096)
        self.prefill_batch_sizes = deque(maxlen=4096)
        self.prefill_shared_groups = 0  # dispatches of "lm_shared" groups

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

    # ------------------------- page accounting --------------------------
    def _alloc_slot_pages(self, req: Request):
        """Reserve the pages one admission needs: fresh pages covering
        prompt + decode budget, with a matched prefix's full pages
        aliased (refcount + 1) ahead of them. Returns ``(row [table_len]
        int32, owned pages, (cow_dst, cow_src) or None)``; raises
        :class:`pages.PagePoolExhausted` when the pool cannot hold it."""
        need = -(-(len(req.prompt) + req.max_new_tokens) // self.page_size)
        waiting = [req.rid] + [r.rid for r in self.queue]
        row = np.zeros((self.table_len,), np.int32)
        match = self._matches.get(req.rid)
        if match is not None and match[0]:
            _, chain, frontier = match
            j = len(chain)
            fresh = self.pool.alloc(need - j, waiting=waiting)
            self.pool.retain(chain)
            row[:j] = chain
            row[j:need] = fresh
            # a mid-page match: the suffix continues inside the owner's
            # frontier page, so it writes into a private copy of it
            cow = (fresh[0], frontier) if frontier is not None else None
            return row, list(chain) + fresh, cow
        pages = self.pool.alloc(need, waiting=waiting)
        row[:need] = pages
        return row, pages, None

    def release_slot(self, slot: int) -> None:
        """Return a retired slot's pages to the pool (refcount - 1; pages
        still pinned by the prefix registry or a sharer stay resident)."""
        pages = self.slot_pages.pop(slot, None)
        if pages is not None:
            self.pool.release(pages)

    # ---------------------------- admission ----------------------------
    def _group_key(self, req: Request) -> Tuple[str, int, int]:
        total = len(req.prompt)
        if self.registry is not None:
            m, chain, frontier = self.registry.lookup(
                np.asarray(req.prompt, np.int32))
            if m:
                # only the unmatched suffix runs through prefill, bucketed
                # on its own length; every member of the group shares m,
                # so it gathers the same page span
                self._matches[req.rid] = (m, chain, frontier)
                return ("lm_shared", bucket_len(total - m, self.max_len,
                                                min_bucket=self.min_bucket), m)
        return ("lm", bucket_len(total, self.max_len,
                                 min_bucket=self.min_bucket), 0)

    def admit(self, model: LM, caches: List[dict], state: DecodeState):
        """Fill free slots from the queue, writing ``caches`` and ``state``
        in place, and return them (the same objects: a captured decode
        step reads them at their addresses). All waiting requests of one
        group (bucket; with a shared prefix, suffix bucket and prefix
        length) become one batched prefill, one splice and one state
        scatter."""
        free = [s for s, occ in self.active.items() if occ is None]
        take = min(len(free), len(self.queue))
        if take == 0:
            return caches, state
        pairs = list(zip(self.queue[:take], free))
        del self.queue[:take]
        self._matches.clear()
        groups: Dict[Tuple[str, int, int], List[Tuple[Request, int]]] = {}
        for req, slot in pairs:
            groups.setdefault(self._group_key(req), []).append((req, slot))

        dev = model.device
        admitted = set()
        exhausted = False
        for (kind, bucket, prefix), group in sorted(groups.items()):
            if exhausted:
                break
            page_rows, owned, cows = [], [], []
            if self.paged:
                kept = []
                for req, slot in group:
                    try:
                        row, own, cow = self._alloc_slot_pages(req)
                    except PG.PagePoolExhausted:
                        # degrade to queueing: the rest of the wave goes
                        # back to the queue head and waits for retiring
                        # slots (or a registry eviction) to free pages
                        exhausted = True
                        if self.registry is not None:
                            self.registry.evict_unreferenced()
                        break
                    kept.append((req, slot))
                    page_rows.append(row)
                    owned.append(own)
                    cows.append(cow)
                group = kept
                if not group:
                    continue
            t0 = time.perf_counter()
            n = len(group)
            toks = np.zeros((n, bucket), np.int32)
            lens = np.zeros((n,), np.int32)
            slots_arr = np.zeros((n,), np.int64)
            max_new = np.zeros((n,), np.int32)
            rids = np.zeros((n,), np.int64)
            for i, (req, slot) in enumerate(group):
                s = len(req.prompt)
                toks[i, :s - prefix] = req.prompt[prefix:]
                lens[i] = s
                slots_arr[i] = slot
                max_new[i] = req.max_new_tokens
                rids[i] = req.rid
            lens_t = torch.from_numpy(lens).to(dev)
            slots_t = torch.from_numpy(slots_arr).to(dev)
            toks_t = torch.from_numpy(toks).to(dev)
            rows_t = (torch.from_numpy(np.stack(page_rows)).to(dev)
                      if self.paged else None)
            if kind == "lm_shared":
                pairs_cow = [c for c in cows if c is not None]
                if pairs_cow:
                    PG.copy_pages(caches, [d for d, _ in pairs_cow],
                                  [s_ for _, s_ in pairs_cow])
                span = -(-prefix // self.page_size)
                rows, logits = prefill_shared(model, caches, rows_t[:, :span],
                                              prefix, toks_t, lens_t)
                self.prefill_shared_groups += 1
            else:
                rows, logits = prefill_rows(model, toks_t, lens_t,
                                            self.cache_dtype,
                                            kv_quant=self.kv_quant)
            if self.paged:
                PG.splice_pages(caches, rows, rows_t)
            else:
                splice_rows(caches, rows, slots_t)
            # the requests' keys, computed on the host: one copy
            keys = SMP.fold_in(SMP.prng_key(self.seed),
                               torch.from_numpy(rids)).to(dev)
            keys, first = SMP.sample(logits[:, -1], keys, self.sampling)
            admit_rows(state, slots_t, first, lens_t,
                       torch.from_numpy(max_new).to(dev), keys,
                       page_rows=rows_t)
            if self.draft is not None:
                self._admit_draft(state, group, lens, lens_t, slots_t)
            for i, (req, slot) in enumerate(group):
                self.active[slot] = req
                admitted.add(req.rid)
                if self.paged:
                    self.slot_pages[slot] = owned[i]
                    if self.registry is not None:
                        cover = -(-len(req.prompt) // self.page_size)
                        self.registry.register(
                            np.asarray(req.prompt, np.int32),
                            page_rows[i][:cover].tolist())
            wall = time.perf_counter() - t0
            self.prefill_dispatch_times.append(wall)
            self.prefill_batch_sizes.append(n)
            for req, _ in group:
                self.prefill_times.append(wall / n)
                self.prefill_prompt_lens.append(len(req.prompt))
        leftover = [req for req, _ in pairs if req.rid not in admitted]
        if leftover:  # pool exhausted mid-wave: requeue in arrival order
            self.queue[:0] = leftover
        return caches, state

    def _admit_draft(self, state: DecodeState, group, lens: np.ndarray,
                     lens_t: torch.Tensor, slots_t: torch.Tensor) -> None:
        """The draft's prompt KV of one admitted group: a dense prefill of
        the full prompts, bucketed on the longest (from ``MIN_BUCKET``, as
        the reference's draft factory), spliced into ``state.draft_caches``
        in place."""
        bucket = bucket_len(int(lens.max()), self.max_len)
        toks = np.zeros((len(group), bucket), np.int32)
        for i, (req, _) in enumerate(group):
            toks[i, :len(req.prompt)] = req.prompt
        rows, _ = prefill_rows(self.draft,
                               torch.from_numpy(toks).to(lens_t.device),
                               lens_t, self.cache_dtype)
        splice_rows(state.draft_caches, rows, slots_t)

    def reset_stats(self) -> None:
        self.prefill_shared_groups = 0
        self.prefill_times.clear()
        self.prefill_prompt_lens.clear()
        self.prefill_dispatch_times.clear()
        self.prefill_batch_sizes.clear()
