"""Deterministic synthetic LM data pipeline (the port's copy of
``repro/data/pipeline.py``), host-sharded and checkpointable.

Tokens are a pure function of (seed, step, position) through a
counter-mode splitmix64 hash in numpy, so batches are bit-equal to the
JAX package's for every family (the vlm family's ``patches`` and the
encdec family's ``frames`` stubs included), restart replays the stream
by setting ``state.step``, and the host rows partition one global
stream. Batches are numpy arrays; the train step moves them to the
device (``models.registry.build_train_step``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig

_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & _MASK
    z = x
    z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & _MASK
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & _MASK
    return z ^ (z >> np.uint64(31))


@dataclasses.dataclass
class PipelineState:
    step: int = 0

    def to_dict(self) -> dict:
        return {"step": self.step}

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineState":
        return cls(step=int(d["step"]))


@dataclasses.dataclass
class TokenPipeline:
    """Yields {tokens, labels} batches (with ``frames`` for the encdec
    family, ``patches`` for the vlm family) for an (arch, shape) cell.

    ``host_index``/``host_count`` select this host's batch rows; the global
    stream is identical regardless of the host grid.
    """

    arch: ArchConfig
    shape: ShapeConfig
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    state: PipelineState = dataclasses.field(default_factory=PipelineState)

    def __post_init__(self):
        if self.shape.global_batch % self.host_count:
            raise ValueError("global_batch must divide evenly across hosts")
        self.local_batch = self.shape.global_batch // self.host_count

    def _tokens(self, step: int, rows: np.ndarray, length: int) -> np.ndarray:
        pos = np.arange(length, dtype=np.uint64)[None, :]
        base = (np.uint64(self.seed) * np.uint64(0x100000001B3)
                + np.uint64(step) * np.uint64(0x1000193)) & _MASK
        h = _splitmix64(base + rows[:, None] * np.uint64(0x10001) + pos)
        return (h % np.uint64(self.arch.vocab_size)).astype(np.int32)

    def next_batch(self) -> Dict[str, np.ndarray]:
        step = self.state.step
        rows = (np.arange(self.local_batch, dtype=np.uint64)
                + np.uint64(self.host_index * self.local_batch))
        text_len = self.shape.seq_len
        if self.arch.frontend == "vision_patches":
            text_len -= self.arch.frontend_tokens
        if self.arch.family == "encdec":
            tgt = max(self.shape.seq_len // 8, 1)
            toks = self._tokens(step, rows, tgt + 1)
            frames = self._frames(step, rows, self.shape.seq_len)
            batch = {"frames": frames, "tokens": toks[:, :-1],
                     "labels": toks[:, 1:]}
        else:
            toks = self._tokens(step, rows, text_len + 1)
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            if self.arch.frontend == "vision_patches":
                batch["patches"] = self._frames(step, rows,
                                                self.arch.frontend_tokens)
        self.state.step += 1
        return batch

    def _frames(self, step: int, rows: np.ndarray, length: int) -> np.ndarray:
        """Stub modality embeddings: deterministic pseudo-gaussian floats."""
        pos = np.arange(length * self.arch.d_model, dtype=np.uint64)[None, :]
        h = _splitmix64(np.uint64(self.seed ^ 0xABCD) + np.uint64(step)
                        + rows[:, None] * np.uint64(0x7F4A7C15) + pos)
        u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        g = np.sqrt(-2.0 * np.log(np.maximum(u, 1e-12))) * np.cos(2 * np.pi * u)
        return (g.reshape(len(rows), length, self.arch.d_model)
                * 0.02).astype(np.float32)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
