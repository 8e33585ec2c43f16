"""Yi-9B — llama-architecture GQA dense LM [arXiv:2403.04652; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    head_dim=128,
    source="arXiv:2403.04652",
)
