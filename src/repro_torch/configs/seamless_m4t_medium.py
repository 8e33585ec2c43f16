"""SeamlessM4T-medium — encoder-decoder multimodal translator
[arXiv:2308.11596; hf]. The audio frontend is a stub: the encoder takes
precomputed frame embeddings ``[S_src, d_model]``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=24,  # 12 encoder + 12 decoder
    enc_layers=12,
    dec_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
    frontend="audio_frames",
    source="arXiv:2308.11596",
)
