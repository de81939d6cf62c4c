"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7, MoE 16e top-2 every 2nd layer
[arXiv:2403.19887].  SSD-form mamba layers (DESIGN.md adaptation note)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    n_experts=16, moe_top_k=2, moe_d_ff=24576, moe_every=2, moe_offset=1,
    attn_every=8, attn_offset=0,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_groups=8, conv_width=4,
    rope_theta=10_000.0,
)
