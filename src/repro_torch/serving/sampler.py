"""Token selection on the device (mirrors ``repro/serving/sampler.py``).

Greedy only in this slice. Temperature and top-k keep their
``SamplingParams`` validation but raise when used: their JAX streams come
from threefry bits the port cannot reproduce, so they wait for a slice
that checks their invariance within the port.
"""
from __future__ import annotations

import dataclasses

import torch

METHODS = ("greedy", "temperature", "top_k")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    method: str = "greedy"
    temperature: float = 1.0
    top_k: int = 0

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"unknown sampling method {self.method!r}; "
                             f"known: {METHODS}")
        if self.method != "greedy" and self.temperature <= 0:
            raise ValueError(f"temperature must be > 0, got {self.temperature}")
        if self.method == "top_k" and self.top_k <= 0:
            raise ValueError(f"top_k must be > 0, got {self.top_k}")


GREEDY = SamplingParams()


def check_supported(sp: SamplingParams) -> None:
    if sp.method != "greedy":
        raise NotImplementedError(f"sampling method {sp.method!r} is not "
                                  f"ported yet (greedy only)")


def sample(logits: torch.Tensor, sp: SamplingParams = GREEDY) -> torch.Tensor:
    """One int32 token per row of ``logits [S, V]``: the argmax, first
    index on ties (as ``jnp.argmax``)."""
    check_supported(sp)
    return torch.argmax(logits, dim=-1).to(torch.int32)
