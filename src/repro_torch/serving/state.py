"""DecodeState — per-slot bookkeeping of the serving loop, on the device.

Mirrors ``repro/serving/state.py``:

  tokens     [slots, 1] int32 — current input token per slot (the token
                                the next step will both emit and consume)
  positions  [slots, 1] int32 — next cache position per slot
  active     [slots]     bool — slot holds a live request
  emitted    [slots]    int32 — tokens emitted so far (EOS never counts)
  max_new    [slots]    int32 — per-request emission budget
  rng        [slots, 2] int64 — per-slot sampling key, two uint32 words
                                (``serving.sampler``): fold_in(PRNGKey(
                                seed), slot) at init, the request's
                                fold_in(PRNGKey(seed), rid) split at
                                admission

Enc-dec engines carry two more leaves (None otherwise):

  enc_out [slots, max_src_len, D] — the encoder output of each slot's
                                request, written at admission and
                                cross-attended by every decode step
  enc_len [slots]          int32 — its true source length; positions at
                                or past it are masked (0 on a slot that
                                never held a request)

Paged engines (``serving.pages``) carry two more leaves (None
otherwise):

  page_table [slots, M] int32 — physical page per logical position block
                                (M = ceil(max_len / page_size)); 0 is
                                the reserved null page
  seq_len    [slots]    int32 — tokens resident in the slot's pages

Speculative engines (``SpecConfig``) carry three more (None otherwise):

  draft_caches  list of dicts — the draft model's dense KV grid,
                                prefilled at admission and rolled forward
                                by the draft-k loop of the spec step
  accepted   [slots] int32    — draft proposals accepted so far (zeroed
                                at admission)
  proposed   [slots] int32    — draft proposals made so far

Inert slots keep their last token/position (and encoder row) so the
grid stays fixed-shape. Every field
(and every leaf of ``draft_caches``) is written in place, by the decode
step and by admission, so it keeps its address for the life of an
engine (the reference donates the state to its jitted step instead).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.serving import sampler as SMP


@dataclasses.dataclass
class DecodeState:
    tokens: torch.Tensor
    positions: torch.Tensor
    active: torch.Tensor
    emitted: torch.Tensor
    max_new: torch.Tensor
    rng: torch.Tensor
    enc_out: Optional[torch.Tensor] = None
    enc_len: Optional[torch.Tensor] = None
    page_table: Optional[torch.Tensor] = None
    seq_len: Optional[torch.Tensor] = None
    draft_caches: Optional[List[dict]] = None
    accepted: Optional[torch.Tensor] = None
    proposed: Optional[torch.Tensor] = None


def tensors(state: DecodeState) -> dict:
    """Every tensor of ``state`` by name (``draft_caches[i].k`` for the
    draft grid's leaves): what a captured step reads at fixed
    addresses."""
    out = {}
    for name, v in vars(state).items():
        if name == "draft_caches" and v is not None:
            out.update({f"draft_caches[{i}].{k}": t
                        for i, c in enumerate(v) for k, t in c.items()})
        elif v is not None:
            out[name] = v
    return out


def clone(state: DecodeState) -> DecodeState:
    """A deep copy of ``state`` (draft grid included) at new addresses."""
    kw = {k: None if v is None else v.clone() for k, v in vars(state).items()
          if k != "draft_caches"}
    if state.draft_caches is not None:
        kw["draft_caches"] = [{k: t.clone() for k, t in c.items()}
                              for c in state.draft_caches]
    return DecodeState(**kw)


def make_decode_state(slots: int, device: torch.device,
                      table_len: Optional[int] = None, seed: int = 0,
                      draft_caches: Optional[List[dict]] = None,
                      enc_shape: Optional[tuple] = None,
                      enc_dtype: Optional[torch.dtype] = None
                      ) -> DecodeState:
    """Fresh all-inert state; slot i's key is fold_in(PRNGKey(seed), i).
    ``table_len`` (paged engines) adds a zeroed page table of that width
    and ``seq_len``; ``draft_caches`` (a fresh dense grid of the draft
    model) adds the speculative leaves; ``enc_shape`` ``(max_src_len,
    d_model)`` (enc-dec engines) adds a zeroed ``enc_out`` in
    ``enc_dtype`` and ``enc_len``."""
    i32 = dict(dtype=torch.int32, device=device)
    paged = table_len is not None
    spec = draft_caches is not None
    enc = enc_shape is not None
    keys = SMP.fold_in(SMP.prng_key(seed, device),
                       torch.arange(slots, device=device))
    return DecodeState(
        tokens=torch.zeros((slots, 1), **i32),
        positions=torch.zeros((slots, 1), **i32),
        active=torch.zeros((slots,), dtype=torch.bool, device=device),
        emitted=torch.zeros((slots,), **i32),
        max_new=torch.ones((slots,), **i32),
        rng=keys,
        enc_out=(torch.zeros((slots,) + tuple(enc_shape), dtype=enc_dtype,
                             device=device) if enc else None),
        enc_len=torch.zeros((slots,), **i32) if enc else None,
        page_table=torch.zeros((slots, table_len), **i32) if paged else None,
        seq_len=torch.zeros((slots,), **i32) if paged else None,
        draft_caches=draft_caches,
        accepted=torch.zeros((slots,), **i32) if spec else None,
        proposed=torch.zeros((slots,), **i32) if spec else None,
    )


def admit_rows(state: DecodeState, slots: torch.Tensor, tokens: torch.Tensor,
               positions: torch.Tensor, max_new: torch.Tensor,
               rng: torch.Tensor,
               page_rows: Optional[torch.Tensor] = None,
               enc_out: Optional[torch.Tensor] = None,
               enc_len: Optional[torch.Tensor] = None) -> None:
    """Write ``n`` freshly-prefilled requests at ``slots [n]`` (distinct)
    into ``state`` in place: one scatter per field, every field keeping
    its address (a captured decode step reads them there). ``rng [n, 2]``
    are the requests' keys after their first draw. Paged engines pass
    ``page_rows [n, M]``, the slots' page-table rows; ``seq_len`` starts
    at the prompt length (``positions``). Enc-dec engines pass the
    requests' encoder output ``enc_out [n, max_src_len, D]`` (cast to the
    state's dtype) and source lengths ``enc_len [n]``. The acceptance
    counters restart at 0."""
    n = slots.shape[0]

    def put(arr, vals):
        vals = vals.to(arr.dtype).reshape((n,) + tuple(arr.shape[1:]))
        arr.index_put_((slots,), vals)

    zeros = torch.zeros((n,), dtype=torch.int32, device=slots.device)
    put(state.tokens, tokens)
    put(state.positions, positions)
    put(state.active, torch.ones((n,), dtype=torch.bool, device=slots.device))
    put(state.emitted, zeros)
    put(state.max_new, max_new)
    put(state.rng, rng)
    if page_rows is not None:
        put(state.page_table, page_rows)
        put(state.seq_len, positions)
    if enc_out is not None:
        put(state.enc_out, enc_out)
        put(state.enc_len, enc_len)
    if state.accepted is not None:
        put(state.accepted, zeros)
        put(state.proposed, zeros)
