"""ServeConfig — the serve surface (the port's copy of the fields it reads).

Mirrors ``repro/serving/config.py``. Only the fields this slice reads are
carried over: the dense slot grid (``PagingConfig.paged`` must stay
False), greedy sampling, lookahead, INT8 quantisation. Disaggregation,
speculation and elastic replan arrive with their slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.quant import QuantConfig


@dataclasses.dataclass(frozen=True)
class PagingConfig:
    """Paged KV (not ported yet: ``paged`` must be False)."""

    paged: bool = False


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """``slots``: decode slot count. ``max_len``: per-slot KV length.
    ``eos_id``: stop token (None -> run to max_new_tokens). ``seed``: base
    seed (random params of the CLI). ``sampling``:
    :class:`repro_torch.serving.sampler.SamplingParams` (None -> greedy).
    ``lookahead``: dispatch depth (1 = double-buffered, 0 = synchronous).
    ``paging``: nested :class:`PagingConfig`. ``quant``: nested
    :class:`repro_torch.quant.QuantConfig` — INT8 serving (per-channel
    int8 weights and/or an int8 KV grid with per-token scales); the
    default quantises nothing."""

    slots: Optional[int] = None
    max_len: Optional[int] = None
    eos_id: Optional[int] = None
    seed: int = 0
    sampling: Optional[Any] = None
    lookahead: int = 1
    paging: PagingConfig = PagingConfig()
    quant: QuantConfig = QuantConfig()

    def resolve(self) -> "ServeConfig":
        """Fill defaults (greedy sampling, lookahead >= 0); ``slots`` and
        ``max_len`` must be set — the port has no planned shape to take
        them from yet."""
        from repro_torch.serving.sampler import GREEDY
        if self.slots is None or self.max_len is None:
            raise ValueError("ServeConfig.slots and ServeConfig.max_len must "
                             "be set")
        return dataclasses.replace(
            self, slots=int(self.slots), max_len=int(self.max_len),
            sampling=self.sampling if self.sampling is not None else GREEDY,
            lookahead=max(0, int(self.lookahead)))
