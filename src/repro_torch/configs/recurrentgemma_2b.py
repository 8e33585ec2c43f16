"""RecurrentGemma-2B (Griffin) — RG-LRU recurrent blocks + local attention,
pattern 2 recurrent : 1 local-attn [arXiv:2402.19427; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,  # MQA in the local-attention blocks
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    mlp="geglu",
    block_pattern=("rglru", "rglru", "attn"),
    lru_width=2560,
    window=2048,
    conv1d_width=4,
    tie_embeddings=True,
    subquadratic=True,  # local attention + recurrence: O(S) decode state
    source="arXiv:2402.19427",
)
