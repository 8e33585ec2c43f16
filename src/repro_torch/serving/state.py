"""DecodeState — per-slot bookkeeping of the serving loop, on the device.

Mirrors ``repro/serving/state.py`` for the dense greedy engine:

  tokens     [slots, 1] int32 — current input token per slot (the token
                                the next step will both emit and consume)
  positions  [slots, 1] int32 — next cache position per slot
  active     [slots]     bool — slot holds a live request
  emitted    [slots]    int32 — tokens emitted so far (EOS never counts)
  max_new    [slots]    int32 — per-request emission budget

The sampling keys and the enc-dec, paged and speculative leaves arrive
with their slices. Inert slots keep their last token/position so the
grid stays fixed-shape.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class DecodeState:
    tokens: torch.Tensor
    positions: torch.Tensor
    active: torch.Tensor
    emitted: torch.Tensor
    max_new: torch.Tensor


def make_decode_state(slots: int, device: torch.device) -> DecodeState:
    """Fresh all-inert state."""
    i32 = dict(dtype=torch.int32, device=device)
    return DecodeState(
        tokens=torch.zeros((slots, 1), **i32),
        positions=torch.zeros((slots, 1), **i32),
        active=torch.zeros((slots,), dtype=torch.bool, device=device),
        emitted=torch.zeros((slots,), **i32),
        max_new=torch.ones((slots,), **i32),
    )


def admit_rows(state: DecodeState, slots: torch.Tensor, tokens: torch.Tensor,
               positions: torch.Tensor, max_new: torch.Tensor) -> DecodeState:
    """Write ``n`` freshly-prefilled requests at ``slots [n]`` (distinct):
    one scatter per field."""
    n = slots.shape[0]

    def put(arr, vals):
        vals = vals.to(arr.dtype).reshape((n,) + tuple(arr.shape[1:]))
        return arr.index_put((slots,), vals)

    return DecodeState(
        tokens=put(state.tokens, tokens),
        positions=put(state.positions, positions),
        active=put(state.active, torch.ones((n,), dtype=torch.bool,
                                            device=slots.device)),
        emitted=put(state.emitted, torch.zeros((n,), dtype=torch.int32,
                                               device=slots.device)),
        max_new=put(state.max_new, max_new),
    )
