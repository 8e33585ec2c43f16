"""PaliGemma-3B — SigLIP vision frontend (stub) + Gemma-2B backbone
[arXiv:2407.07726; hf]. The frontend is a stub: a request carries
precomputed patch embeddings, a 256-token prefix attended both ways."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,  # MQA (gemma-2b)
    d_ff=16384,
    vocab_size=257216,
    head_dim=256,
    mlp="geglu",
    frontend="vision_patches",
    frontend_tokens=256,
    tie_embeddings=True,
    source="arXiv:2407.07726",
)
