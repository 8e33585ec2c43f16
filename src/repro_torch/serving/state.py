"""DecodeState — per-slot bookkeeping of the serving loop, on the device.

Mirrors ``repro/serving/state.py`` for the dense greedy engine:

  tokens     [slots, 1] int32 — current input token per slot (the token
                                the next step will both emit and consume)
  positions  [slots, 1] int32 — next cache position per slot
  active     [slots]     bool — slot holds a live request
  emitted    [slots]    int32 — tokens emitted so far (EOS never counts)
  max_new    [slots]    int32 — per-request emission budget

Paged engines (``serving.pages``) carry two more leaves (None
otherwise):

  page_table [slots, M] int32 — physical page per logical position block
                                (M = ceil(max_len / page_size)); 0 is
                                the reserved null page
  seq_len    [slots]    int32 — tokens resident in the slot's pages

The sampling keys and the enc-dec and speculative leaves arrive with
their slices. Inert slots keep their last token/position so the grid
stays fixed-shape. Every field is written in place, by the decode step
and by admission, so it keeps its address for the life of an engine
(the reference donates the state to its jitted step instead).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class DecodeState:
    tokens: torch.Tensor
    positions: torch.Tensor
    active: torch.Tensor
    emitted: torch.Tensor
    max_new: torch.Tensor
    page_table: Optional[torch.Tensor] = None
    seq_len: Optional[torch.Tensor] = None


def make_decode_state(slots: int, device: torch.device,
                      table_len: Optional[int] = None) -> DecodeState:
    """Fresh all-inert state; ``table_len`` (paged engines) adds a zeroed
    page table of that width and ``seq_len``."""
    i32 = dict(dtype=torch.int32, device=device)
    paged = table_len is not None
    return DecodeState(
        tokens=torch.zeros((slots, 1), **i32),
        positions=torch.zeros((slots, 1), **i32),
        active=torch.zeros((slots,), dtype=torch.bool, device=device),
        emitted=torch.zeros((slots,), **i32),
        max_new=torch.ones((slots,), **i32),
        page_table=torch.zeros((slots, table_len), **i32) if paged else None,
        seq_len=torch.zeros((slots,), **i32) if paged else None,
    )


def admit_rows(state: DecodeState, slots: torch.Tensor, tokens: torch.Tensor,
               positions: torch.Tensor, max_new: torch.Tensor,
               page_rows: Optional[torch.Tensor] = None) -> None:
    """Write ``n`` freshly-prefilled requests at ``slots [n]`` (distinct)
    into ``state`` in place: one scatter per field, every field keeping
    its address (a captured decode step reads them there). Paged engines
    pass ``page_rows [n, M]``, the slots' page-table rows; ``seq_len``
    starts at the prompt length (``positions``)."""
    n = slots.shape[0]

    def put(arr, vals):
        vals = vals.to(arr.dtype).reshape((n,) + tuple(arr.shape[1:]))
        arr.index_put_((slots,), vals)

    put(state.tokens, tokens)
    put(state.positions, positions)
    put(state.active, torch.ones((n,), dtype=torch.bool, device=slots.device))
    put(state.emitted, torch.zeros((n,), dtype=torch.int32,
                                   device=slots.device))
    put(state.max_new, max_new)
    if page_rows is not None:
        put(state.page_table, page_rows)
        put(state.seq_len, positions)
