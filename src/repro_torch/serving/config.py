"""ServeConfig — the serve surface (the port's copy of the fields it reads).

Mirrors ``repro/serving/config.py``. Only the fields the port reads are
carried over: the slot grid or the paged pool (:class:`PagingConfig`),
sampling, lookahead, the encoder-decoder's source bound
(``max_src_len``), INT8 quantisation and speculative decoding
(:class:`SpecConfig`). Disaggregation and elastic replan are not
ported (ROADMAP A14).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.quant import QuantConfig


@dataclasses.dataclass(frozen=True)
class PagingConfig:
    """Paged-KV knobs (see ``serving.pages``). ``page_size`` / ``kv_pages``
    default (``None``) to ``DEFAULT_PAGE_SIZE`` / ``default_kv_pages``;
    ``prefix_cache`` turns on prefix reuse through the page registry."""

    paged: bool = False
    page_size: Optional[int] = None
    kv_pages: Optional[int] = None
    prefix_cache: bool = True


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative decoding (``registry.build_serve_step(spec=...)``).

    A small draft model proposes ``k`` tokens per slot per engine step;
    the target verifies all ``k + 1`` positions in one batched forward
    and the longest accepted prefix commits on the device. Greedy
    streams equal the target-only streams; seeded temperature/top-k
    advance each request's key once per committed sub-step, so sampled
    streams equal them too.

    ``draft``: the draft :class:`~repro_torch.configs.base.ArchConfig`
    (the port has no plan to take one from, so it must be set). Pairing
    rules: both models dense and non-windowed, with equal vocabularies;
    the draft runs full-precision on its own dense grid.
    ``k``: proposals per step (>= 1)."""

    draft: Optional[Any] = None
    k: int = 4

    def __post_init__(self):
        if int(self.k) < 1:
            raise ValueError(f"SpecConfig.k must be >= 1, got {self.k}")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """``slots``: decode slot count. ``max_len``: per-slot KV length.
    ``eos_id``: stop token (None -> run to max_new_tokens). ``seed``: base
    seed (random params of the CLI). ``sampling``:
    :class:`repro_torch.serving.sampler.SamplingParams` (None -> greedy).
    ``lookahead``: dispatch depth (1 = double-buffered, 0 = synchronous).
    ``max_src_len``: the encdec family's per-request bound on source
    frames, the width of the state's ``enc_out`` rows (None ->
    ``max_len``).
    ``paging``: nested :class:`PagingConfig`. ``quant``: nested
    :class:`repro_torch.quant.QuantConfig` — INT8 serving (per-channel
    int8 weights and/or an int8 KV grid with per-token scales); the
    default quantises nothing. ``spec``: :class:`SpecConfig` — speculative
    decoding with a draft model (None -> off)."""

    slots: Optional[int] = None
    max_len: Optional[int] = None
    eos_id: Optional[int] = None
    seed: int = 0
    sampling: Optional[Any] = None
    lookahead: int = 1
    max_src_len: Optional[int] = None
    paging: PagingConfig = PagingConfig()
    quant: QuantConfig = QuantConfig()
    spec: Optional[SpecConfig] = None

    def resolve(self) -> "ServeConfig":
        """Fill defaults (greedy sampling, lookahead >= 0, ``max_src_len``
        from ``max_len``); ``slots`` and ``max_len`` must be set — the
        port has no planned shape to take them from yet."""
        from repro_torch.serving.sampler import GREEDY
        if self.slots is None or self.max_len is None:
            raise ValueError("ServeConfig.slots and ServeConfig.max_len must "
                             "be set")
        return dataclasses.replace(
            self, slots=int(self.slots), max_len=int(self.max_len),
            sampling=self.sampling if self.sampling is not None else GREEDY,
            max_src_len=(int(self.max_src_len) if self.max_src_len is not None
                         else int(self.max_len)),
            lookahead=max(0, int(self.lookahead)))
