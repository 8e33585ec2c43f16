"""Serving runtime of the port (slot grid or paged pool; greedy, sampled
or speculative).

  config.py     ServeConfig / PagingConfig / SpecConfig
  state.py      DecodeState — per-slot bookkeeping on the device
  sampler.py    SamplingParams + greedy / temperature / top-k choice
  scheduler.py  admission, slot lifecycle, bucketed prefill + splice
  engine.py     ServingEngine — one-step-lookahead dispatch loop
"""
from repro_torch.serving.config import (  # noqa: F401
    PagingConfig, ServeConfig, SpecConfig)
from repro_torch.serving.engine import (  # noqa: F401
    IncompleteDrainError, Request, ServingEngine)
from repro_torch.serving.sampler import GREEDY, SamplingParams  # noqa: F401
from repro_torch.serving.scheduler import RequestValidationError  # noqa: F401
