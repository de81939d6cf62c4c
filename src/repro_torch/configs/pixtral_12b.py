"""pixtral-12b [vlm] — mistral-nemo backbone + patch-embedding frontend stub
(input_specs provides precomputed patch embeddings) [hf:mistralai/Pixtral-12B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    frontend="patches", n_patches=64,
    rope_theta=1_000_000.0,
)
