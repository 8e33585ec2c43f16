"""Architecture + shape configuration dataclasses (the port's own copy).

Mirrors ``repro/configs/base.py`` field for field so that an
``ArchConfig`` built here describes the same model as the JAX one; the
port imports nothing of ``repro``, so it keeps this copy. Only the
parts the port reads are carried over: the fields, the derived sizes and
:meth:`ArchConfig.reduced`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | encdec | hybrid | ssm | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    mlp: str = "swiglu"  # swiglu | relu2 | geglu | none
    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    first_dense_layers: int = 0
    # --- encoder-decoder ---
    enc_layers: int = 0
    dec_layers: int = 0
    # --- modality frontend ---
    frontend: str = "none"
    frontend_tokens: int = 0
    # --- hybrid / ssm block pattern ---
    block_pattern: Tuple[str, ...] = ()
    lru_width: int = 0
    window: int = 0
    conv1d_width: int = 0
    # --- general ---
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    subquadratic: bool = False
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError(f"{self.name}: num_heads must be divisible by num_kv_heads")

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests (same rule as the JAX copy)."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 4 if self.block_pattern else 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4,
            head_dim=16,
            d_ff=0 if self.d_ff == 0 else 128,
            moe_d_ff=0 if self.moe_d_ff == 0 else 64,
            vocab_size=256,
            num_experts=min(self.num_experts, 8),
            num_shared_experts=min(self.num_shared_experts, 1),
            top_k=min(self.top_k, 2),
            moe_capacity_factor=8.0,
            first_dense_layers=min(self.first_dense_layers, 1),
            enc_layers=min(self.enc_layers, 2),
            dec_layers=min(self.dec_layers, 2),
            lru_width=0 if self.lru_width == 0 else 64,
            window=0 if self.window == 0 else 16,
            frontend_tokens=0 if self.frontend_tokens == 0 else 8,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    def reduced(self) -> "ShapeConfig":
        return ShapeConfig(self.name + "-smoke", min(self.seq_len, 32), min(self.global_batch, 2), self.kind)
