"""hubert-xlarge [audio] — encoder-only; frame-embedding frontend stub
(input_specs provides precomputed frames).  No decode shapes (DESIGN §5)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="encoder",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab_size=504, causal=False, frontend="frames",
)
