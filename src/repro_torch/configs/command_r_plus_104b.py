"""command-r-plus-104b [dense] — GQA, no-bias, tied embeddings [hf:CohereForAI]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=33792, vocab_size=256000, tie_embeddings=True,
    rope_theta=75_000_000.0,
)
