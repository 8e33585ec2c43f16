"""Llama-4-Maverick-400B-A17B — 128-expert top-1 MoE + shared expert
[hf:meta-llama/Llama-4-*]. Early-fusion multimodal frontend is a stub per
the brief (backbone only)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,  # shared/dense MLP hidden
    vocab_size=202048,
    head_dim=128,
    num_experts=128,
    num_shared_experts=1,
    top_k=1,
    moe_d_ff=8192,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (scaled per brief)",
)
