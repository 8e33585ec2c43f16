"""DeepSeekMoE-16B — fine-grained 64-expert top-6 routing + 2 shared experts,
first layer dense [arXiv:2401.06066; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,  # MHA
    d_ff=10944,  # dense first layer hidden
    vocab_size=102400,
    head_dim=128,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    source="arXiv:2401.06066",
)
