"""Contriever-like dual encoder — the paper's embedding model F_emb (§2.3.4).
Vocab matches the synthetic tokenizer used by the MedRAG-analog benchmark."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="contriever-110m", family="encoder",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=8192, causal=False,
)
