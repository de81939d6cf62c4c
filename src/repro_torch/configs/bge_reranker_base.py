"""bge-reranker-base-like cross encoder — the paper's aggregation model F_aggr
(§2.3.2): pairwise (query, chunk) relevance scoring."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="bge-reranker-base", family="encoder",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=8192, causal=False,
)
