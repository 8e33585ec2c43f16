"""Minitron-8B — width/depth-pruned Nemotron-4 [arXiv:2407.14679; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    head_dim=128,
    mlp="relu2",  # nemotron uses squared-ReLU MLP (no gate)
    source="arXiv:2407.14679",
)
