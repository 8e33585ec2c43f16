"""Phi-3-medium-14B — RoPE + SwiGLU + GQA dense LM [arXiv:2404.14219]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    head_dim=128,
    source="arXiv:2404.14219",
)
