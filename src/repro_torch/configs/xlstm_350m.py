"""xLSTM-350M — alternating mLSTM (matrix-memory) and sLSTM blocks
[arXiv:2405.04517]. d_ff=0: xLSTM blocks carry their own up/down
projections; there is no separate FFN. The mLSTM's inner width is 2 x
d_model, so its heads are 2048 / 4 = 512 wide (``head_dim`` is not read
by the ssm blocks)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=256,
    mlp="none",
    block_pattern=("mlstm", "slstm"),
    tie_embeddings=True,
    subquadratic=True,  # recurrent state: O(1) decode per token
    source="arXiv:2405.04517",
)
