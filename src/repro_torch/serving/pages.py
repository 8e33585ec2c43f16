"""Paged KV cache: a page pool per attention layer and prefix reuse.

Mirrors ``repro/serving/pages.py``. The dense slot grid holds one
``max_len`` row per slot; here KV lives in pools of fixed-size pages
(``{"kp", "vp": [P, page_size, G, D]}`` per attention layer, int8 with
per-token f32 scale pools ``{"kps", "vps": [P, page_size, G, 1]}`` under
``kv_quant``) and each slot holds a row of one int32 page table
``[slots, ceil(max_len / page_size)]`` shared by every layer. Capacity
then follows the tokens in flight, and identical prompt prefixes share
physical pages. Page 0 is the reserved **null page**: decode writes of
inactive slots and the splice's invalid (``pos = -1``) entries land
there, so its contents are garbage by construction and never read
unmasked.

Page accounting is the host :class:`PagePool` (refcounts; prefix sharing
aliases pages across slots), which the scheduler drives synchronously,
as the JAX scheduler does. The JAX package's device form of the same
accounting is here too: :class:`PoolState` (int32 refcounts on a given
device) and the pure functions :func:`make_pool_state`,
:func:`pool_alloc`, :func:`pool_retain`, :func:`pool_release` and
:func:`pool_free_count`, with the host pool's policy (lowest free pages
first, the null page 0 never allocated, releases clamped at 0) and no
read back to the host.

:class:`PrefixRegistry` maps prompt prefixes to refcounted pages at token
granularity. A later prompt aliases the matched full pages and gets a
private copy (:func:`copy_pages`) of a frontier page matched mid-page;
its prefill then runs only the unmatched suffix against the gathered
prefix (:func:`gather_prefix`). Where the JAX ``gather_prefix``
dequantises an int8 prefix into an fp32 copy, this one returns the int8
payload and its scales, so the ``flash_attention`` kernel dequantises in
registers (the values are the same: ``pre_k.float() * pre_k_scale``).

Pools are updated in place (the JAX package donates them to jitted
scatters). A pool tree is the list of per-layer dicts of
``models.lm.LM.make_caches``' layout, one per attention layer.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import quant as Q
from repro_torch.configs.base import ArchConfig

DEFAULT_PAGE_SIZE = 64

#: Families whose every cache leaf is a full-length attention KV row
#: (window 0): the only layout the page pool replaces. Hybrid (windowed
#: ring), pure-recurrent and enc-dec caches keep their existing layout.
PAGED_FAMILIES = ("dense", "moe", "vlm")


def paged_supported(arch: ArchConfig) -> bool:
    return arch.family in PAGED_FAMILIES


def check_paged_supported(arch: ArchConfig) -> None:
    if not paged_supported(arch):
        raise ValueError(
            f"paged KV cache supports all-attention families {PAGED_FAMILIES}, "
            f"not {arch.family!r} ({arch.name}): recurrent/windowed/enc-dec "
            f"caches keep their dense layout")


def num_pages_per_slot(max_len: int, page_size: int) -> int:
    """Page-table width: logical position blocks covering ``max_len``."""
    return -(-max_len // page_size)


def default_kv_pages(slots: int, max_len: int, page_size: int) -> int:
    """Dense-equivalent pool size (+1 null page): every slot can hold a
    full ``max_len`` sequence, so the default can never exhaust; callers
    opt into oversubscription by passing a smaller ``kv_pages``."""
    return slots * num_pages_per_slot(max_len, page_size) + 1


class PagePoolExhausted(RuntimeError):
    """An admission needed more free pages than the pool holds.

    ``waiting`` carries the rids whose admission is blocked; the
    scheduler re-queues them (FIFO) and retries as decode slots retire
    and release pages."""

    def __init__(self, msg: str, waiting: Sequence[int] = ()):
        super().__init__(msg)
        self.waiting = list(waiting)


@dataclasses.dataclass
class PoolState:
    """Device-resident page accounting: ``refcount [P] int32``. Page 0
    (null) is born with refcount 1 so it is never allocated."""

    refcount: torch.Tensor

    @property
    def kv_pages(self) -> int:
        return self.refcount.shape[0]


def make_pool_state(kv_pages: int, device=None) -> PoolState:
    """A pool of ``kv_pages`` pages (the null page and ``kv_pages - 1``
    usable) on ``device``, every usable page free."""
    if kv_pages < 2:
        raise ValueError(f"kv_pages must be >= 2 (null page + one usable), "
                         f"got {kv_pages}")
    rc = torch.zeros((kv_pages,), dtype=torch.int32, device=device)
    rc[0] = 1
    return PoolState(refcount=rc)


def pool_free_count(state: PoolState) -> torch.Tensor:
    """The free pages (refcount 0), a 0-dim int32 tensor on the pool's
    device."""
    return (state.refcount == 0).sum(dtype=torch.int32)


def pool_alloc(state: PoolState, n: int) -> Tuple[PoolState, torch.Tensor]:
    """Take the ``n`` lowest-indexed free pages (refcount 0 -> 1).

    Returns ``(state', pages [n] int32)``; positions past the free count
    return the null page 0 (callers check :func:`pool_free_count`: the
    function reads nothing back to the host, so it cannot raise)."""
    rc = state.refcount
    p = state.kv_pages
    free = rc == 0
    ids = torch.arange(p, dtype=torch.int32, device=rc.device)
    # lowest free indices first: a stable sort of (free ? index : P)
    order = torch.sort(torch.where(free, ids, p), stable=True).indices
    want = torch.arange(1, n + 1, dtype=torch.int32, device=rc.device)
    pages = torch.zeros(n, dtype=torch.int32, device=rc.device)
    m = min(n, p)
    pages[:m] = order[:m].to(torch.int32)
    pages = torch.where(free.sum(dtype=torch.int32) >= want, pages, 0)
    return pool_retain(state, pages), pages


def pool_retain(state: PoolState, pages: torch.Tensor) -> PoolState:
    """refcount += 1 for each page id (null page 0 is a no-op)."""
    pages = pages.to(torch.int64)
    inc = (pages > 0).to(torch.int32)
    return PoolState(refcount=state.refcount.index_add(0, pages, inc))


def pool_release(state: PoolState, pages: torch.Tensor) -> PoolState:
    """refcount -= 1 for each page id, clamped at 0 (null page no-op):
    each id is held to the refcount before the call, as the reference's
    scatter-add reads it."""
    pages = pages.to(torch.int64)
    rc = state.refcount
    dec = -((pages > 0) & (rc[pages] > 0)).to(torch.int32)
    return PoolState(refcount=rc.index_add(0, pages, dec))


class PagePool:
    """Host-side page accounting: ``refcount [P]``, lowest-free-first
    allocation. Page 0 (null) is born with refcount 1, so it is never
    allocated or freed."""

    def __init__(self, kv_pages: int, page_size: int = DEFAULT_PAGE_SIZE):
        if kv_pages < 2:
            raise ValueError(f"kv_pages must be >= 2 (null page + one "
                             f"usable), got {kv_pages}")
        self.kv_pages = kv_pages
        self.page_size = page_size
        self.refcount = np.zeros((kv_pages,), np.int32)
        self.refcount[0] = 1

    @property
    def free_pages(self) -> int:
        return int((self.refcount == 0).sum())

    @property
    def used_pages(self) -> int:
        return self.kv_pages - 1 - self.free_pages

    def alloc(self, n: int, waiting: Sequence[int] = ()) -> List[int]:
        """Allocate ``n`` pages (lowest free indices first) or raise
        :class:`PagePoolExhausted` naming the ``waiting`` rids."""
        free = np.flatnonzero(self.refcount == 0)
        if len(free) < n:
            raise PagePoolExhausted(
                f"page pool exhausted: need {n} pages, {len(free)} free "
                f"of {self.kv_pages - 1} (page_size={self.page_size}); "
                f"waiting rids={list(waiting)}", waiting)
        pages = free[:n].tolist()
        self.refcount[pages] = 1
        return pages

    def retain(self, pages: Sequence[int]) -> None:
        for p in pages:
            if p > 0:
                self.refcount[p] += 1

    def release(self, pages: Sequence[int]) -> None:
        for p in pages:
            if p <= 0:
                continue
            if self.refcount[p] <= 0:
                raise AssertionError(
                    f"double free of page {p} (refcount already 0)")
            self.refcount[p] -= 1


# ---------------------------------------------------------------------------
# pools and their device operations
# ---------------------------------------------------------------------------

#: dense-row leaf -> pool leaf names (scale pools only exist for int8 KV)
_POOL_NAMES = (("k", "kp"), ("v", "vp"), ("k_scale", "kps"), ("v_scale", "vps"))


def make_paged_caches(arch: ArchConfig, kv_pages: int, page_size: int, *,
                      device: torch.device, dtype: torch.dtype,
                      kv_quant: bool = False) -> List[dict]:
    """One pool dict per attention layer, replacing ``LM.make_caches``:
    ``{"kp", "vp": [P, ps, G, D]}`` in ``dtype``, or int8 with
    ``{"kps", "vps": [P, ps, G, 1]}`` f32 under ``kv_quant``."""
    check_paged_supported(arch)
    g, d = arch.num_kv_heads, arch.head_dim
    shape = (kv_pages, page_size, g, d)

    def pool():
        out = {"kp": torch.zeros(shape, dtype=torch.int8 if kv_quant else dtype,
                                 device=device)}
        out["vp"] = torch.zeros_like(out["kp"])
        if kv_quant:
            for name in ("kps", "vps"):
                out[name] = torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                        device=device)
        return out

    return [pool() for _ in range(arch.num_layers)]


def splice_pages(pools: List[dict], rows: List[dict],
                 page_rows: torch.Tensor) -> None:
    """Write batched prefill rows ``{"k", "v": [n, S, G, D], "pos": [n, S]}``
    (int8 with scales, or fp) into the pools at the positions their
    ``pos`` leaves claim, in place; ``pos = -1`` entries go to the null
    page. ``page_rows [n, M]`` are the slots' page-table rows. fp rows
    written into int8 pools (the shared-prefix prefill's suffix rows) are
    quantised here with the per-token routine of the dense fill, so the
    pool holds what a full quantised prefill would write."""
    for pool, row in zip(pools, rows):
        ps = pool["kp"].shape[1]
        pos = row["pos"].long()
        valid = pos >= 0
        logical = pos.clamp(min=0)
        pages = torch.gather(page_rows.long(), 1, logical // ps)
        pages = torch.where(valid, pages, 0)
        slots = logical % ps
        if "kps" in pool and "k_scale" not in row:
            kq, vq = Q.quantize_kv(row["k"]), Q.quantize_kv(row["v"])
            row = dict(row, k=kq.q, k_scale=kq.scale, v=vq.q, v_scale=vq.scale)
        for row_name, pool_name in _POOL_NAMES:
            if pool_name in pool:
                pool[pool_name][pages, slots] = row[row_name].to(
                    pool[pool_name].dtype)


def gather_prefix(pools: List[dict], page_rows: torch.Tensor,
                  prefix_len: int) -> List[dict]:
    """Per-layer shared-prefix KV for a compute-skip suffix prefill: the
    pages of ``page_rows [n, K]`` (the span covering the prefix) as dense
    ``{"pre_k", "pre_v": [n, K·ps, G, D], "pre_len": prefix_len}`` blocks,
    with ``"pre_k_scale"``/``"pre_v_scale"`` [n, K·ps, G, 1] for int8
    pools (the payload stays int8). Entries at or past ``prefix_len`` are
    garbage and masked by the attention."""
    table = page_rows.long()
    n, k = table.shape

    def one(p):
        return p[table].reshape(n, k * p.shape[1], *p.shape[2:])

    out = []
    for pool in pools:
        pre = {"pre_k": one(pool["kp"]), "pre_v": one(pool["vp"]),
               "pre_len": int(prefix_len)}
        if "kps" in pool:
            pre["pre_k_scale"] = one(pool["kps"])
            pre["pre_v_scale"] = one(pool["vps"])
        out.append(pre)
    return out


def copy_pages(pools: List[dict], dst: Sequence[int],
               src: Sequence[int]) -> None:
    """Copy whole pages ``src -> dst`` in every layer and leaf, in place:
    the copy-on-write of a frontier page shared mid-page (the new request
    writes its suffix into its private copy; the owner keeps the
    original)."""
    dev = pools[0]["kp"].device
    dst_t = torch.as_tensor(list(dst), dtype=torch.long, device=dev)
    src_t = torch.as_tensor(list(src), dtype=torch.long, device=dev)
    for pool in pools:
        for leaf in pool.values():
            leaf[dst_t] = leaf[src_t]


# ---------------------------------------------------------------------------
# prefix registry (host-side; token-granularity longest-prefix match)
# ---------------------------------------------------------------------------

class PrefixRegistry:
    """Prompt-prefix -> physical-pages cache with refcounted aliasing.

    Entries (host-side; pages pinned with one registry refcount each):

    * ``full``: ``tokens[:j·ps] -> (page_0..page_{j-1})`` for every full
      page boundary ``j`` of a registered prompt, aliasable as-is.
    * ``tail``: ``tokens[:p] -> (chain, frontier page, p mod ps)`` for the
      full prompt when it ends mid-page; the frontier page is
      copy-on-write for a new sharer (the owner keeps appending to it).

    ``lookup`` returns the longest match at token granularity; ``cap``
    bounds both maps LRU-style (evicted entries drop their refcounts, so
    unreferenced pages return to the pool)."""

    def __init__(self, pool: PagePool, cap: int = 1024):
        self.pool = pool
        self.cap = cap
        self.full: "OrderedDict[bytes, Tuple[int, ...]]" = OrderedDict()
        self.tail: "OrderedDict[bytes, Tuple[Tuple[int, ...], int, int]]" = \
            OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _key(tokens: np.ndarray) -> bytes:
        return np.ascontiguousarray(tokens, dtype=np.int32).tobytes()

    def register(self, tokens: np.ndarray, pages: Sequence[int]) -> None:
        """Pin an admitted prompt's prefix pages. ``pages`` must cover
        ``ceil(len(tokens)/ps)`` entries of the slot's table."""
        ps = self.pool.page_size
        p = len(tokens)
        k_full, r = divmod(p, ps)
        for j in range(1, k_full + 1):
            self._put_full(self._key(tokens[:j * ps]), tuple(pages[:j]))
        if r and k_full < len(pages):
            self._put_tail(self._key(tokens[:p]),
                           (tuple(pages[:k_full]), int(pages[k_full]), r))

    def _put_full(self, key: bytes, chain: Tuple[int, ...]) -> None:
        if key in self.full:
            self.full.move_to_end(key)
            return
        self.pool.retain(chain)
        self.full[key] = chain
        self._evict()

    def _put_tail(self, key: bytes, entry) -> None:
        if key in self.tail:
            self.tail.move_to_end(key)
            return
        chain, frontier, _ = entry
        self.pool.retain(chain)
        self.pool.retain([frontier])
        self.tail[key] = entry
        self._evict()

    def _evict(self) -> None:
        while len(self.full) + len(self.tail) > self.cap:
            if self.full and (not self.tail or len(self.full) >= len(self.tail)):
                _, chain = self.full.popitem(last=False)
                self.pool.release(chain)
            else:
                _, (chain, frontier, _) = self.tail.popitem(last=False)
                self.pool.release(chain)
                self.pool.release([frontier])

    def evict_unreferenced(self) -> int:
        """Drop entries whose pages are only pinned by the registry (the
        exhaustion fallback that returns cold prefix pages to the pool).
        Nested prefixes of one prompt pin each other's pages, so "only the
        registry" means ``refcount == registry pin count``. Returns the
        number of page pins released."""
        pins: Dict[int, int] = {}
        for chain in self.full.values():
            for p in chain:
                pins[p] = pins.get(p, 0) + 1
        for chain, frontier, _ in self.tail.values():
            for p in list(chain) + [frontier]:
                pins[p] = pins.get(p, 0) + 1
        freed = 0

        def try_evict(held):
            nonlocal freed
            if not all(self.pool.refcount[p] == pins.get(p, 0) for p in held):
                return False
            self.pool.release(held)
            for p in held:
                pins[p] -= 1
            freed += len(held)
            return True

        for key in list(self.full):
            if try_evict(list(self.full[key])):
                del self.full[key]
        for key in list(self.tail):
            chain, frontier, _ = self.tail[key]
            if try_evict(list(chain) + [frontier]):
                del self.tail[key]
        return freed

    def lookup(self, tokens: np.ndarray
               ) -> Tuple[int, Tuple[int, ...], Optional[int]]:
        """Longest registered prefix of ``tokens``, capped at
        ``len(tokens) - 1`` (one suffix token at least must run through
        prefill to give the first logits).

        Returns ``(m, full_chain, frontier)``: ``m`` matched tokens, the
        aliasable full pages covering ``m // ps`` blocks, and, when ``m``
        ends mid-page, the owner's frontier page to copy on write (None
        on a page boundary). ``(0, (), None)`` on a miss."""
        ps = self.pool.page_size
        q = len(tokens)
        best = (0, (), None)
        for key, (chain, frontier, r) in self.tail.items():
            t_len = len(chain) * ps + r
            if t_len <= best[0] or t_len > q - 1:
                continue
            if key == self._key(tokens[:t_len]):
                best = (t_len, chain, frontier)
        for j in range((q - 1) // ps, 0, -1):
            if j * ps <= best[0]:
                break
            chain = self.full.get(self._key(tokens[:j * ps]))
            if chain is not None:
                best = (j * ps, chain, None)
                break
        if best[0]:
            self.hits += 1
            if best[2] is None:
                self.full.move_to_end(self._key(tokens[:best[0]]))
            else:
                self.tail.move_to_end(self._key(tokens[:best[0]]))
        else:
            self.misses += 1
        return best

    def clear(self) -> None:
        for chain in self.full.values():
            self.pool.release(chain)
        for chain, frontier, _ in self.tail.values():
            self.pool.release(chain)
            self.pool.release([frontier])
        self.full.clear()
        self.tail.clear()
