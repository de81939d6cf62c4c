"""smollm-360m [dense] — llama-arch small; 15 heads (GSPMD pads over TP=16)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, head_dim=64,
    d_ff=2560, vocab_size=49152, tie_embeddings=True,
    rope_theta=10_000.0,
)
