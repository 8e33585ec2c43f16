"""Serving runtime of the port (dense slot grid, greedy).

  config.py     ServeConfig / PagingConfig
  state.py      DecodeState — per-slot bookkeeping on the device
  sampler.py    SamplingParams + greedy token choice
  scheduler.py  admission, slot lifecycle, bucketed prefill + splice
  engine.py     ServingEngine — one-step-lookahead dispatch loop
"""
from repro_torch.serving.config import PagingConfig, ServeConfig  # noqa: F401
from repro_torch.serving.engine import (  # noqa: F401
    IncompleteDrainError, Request, ServingEngine)
from repro_torch.serving.sampler import GREEDY, SamplingParams  # noqa: F401
from repro_torch.serving.scheduler import RequestValidationError  # noqa: F401
