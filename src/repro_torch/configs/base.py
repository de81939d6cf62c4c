"""Model / shape configuration system.

One ``ModelConfig`` per architecture (the 10 assigned + the paper's own
retrieval trio).  Configs are frozen dataclasses — pure data, no jax import
side effects.  ``ShapeConfig`` describes the (seq_len, global_batch, step
kind) cells from the assignment; ``applicable()`` encodes the documented
skips (DESIGN.md §5).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str = "dense"  # dense | moe | hybrid | ssm | encoder | vlm

    # --- backbone ---
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    n_kv_heads: int = 12
    head_dim: int = 0  # 0 -> d_model // n_heads
    d_ff: int = 3072
    vocab_size: int = 32000
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    causal: bool = True

    # --- MoE ---
    n_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0  # per-expert hidden (0 -> d_ff)
    n_shared_experts: int = 0
    moe_every: int = 1  # MoE on layers where i % moe_every == moe_offset
    moe_offset: int = 0
    capacity_slack: float = 1.5
    router_aux_weight: float = 0.01
    moe_impl: str = "psum"  # psum (masked-local EP) | a2a (token-resharded EP)

    # --- hybrid / ssm mixers ---
    attn_every: int = 1  # attention on layers where i % attn_every == attn_offset
    attn_offset: int = 0  # (ssm family: attn_every=0 -> no attention anywhere)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_width: int = 4
    ssd_chunk: int = 256

    # --- modality frontend stubs (DESIGN.md §5) ---
    frontend: str = "none"  # none | frames | patches
    n_patches: int = 0  # vlm: precomputed patch embeds replacing first N positions

    # --- compute policy ---
    attn_impl: str = "flash_jnp"  # naive | flash_jnp | pallas
    attn_chunk: int = 1024
    remat: str = "block"  # none | block
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    logit_dtype: str = "float32"
    bf16_grads: bool = False  # bf16 gradient sync (f32 master update)
    scan_unroll: bool = False  # unroll all scans (dry-run cost measurement:
    # XLA cost_analysis counts while-loop bodies ONCE, so roofline
    # measurement compiles must be loop-free; see launch/dryrun.py)

    # ------------------------------------------------------------------ #
    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def resolved_moe_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    # --- per-layer structure ----------------------------------------- #
    def mixer_kind(self, i: int) -> str:
        if self.family == "ssm":
            return "mamba"
        if self.family == "hybrid":
            return "attn" if (i % self.attn_every) == self.attn_offset else "mamba"
        return "attn"

    def ffn_kind(self, i: int) -> str:
        if self.n_experts > 0 and (i % self.moe_every) == self.moe_offset:
            return "moe"
        return "dense"

    @property
    def scan_period(self) -> int:
        """Smallest period such that layer structure repeats; we scan over
        n_layers // period blocks of `period` explicit positions."""
        p = 1
        if self.family == "hybrid":
            p = math.lcm(p, self.attn_every)
        if self.n_experts > 0 and self.moe_every > 1:
            p = math.lcm(p, self.moe_every)
        assert self.n_layers % p == 0, (self.name, self.n_layers, p)
        return p

    @property
    def n_blocks(self) -> int:
        return self.n_layers // self.scan_period

    # --- parameter counting (MODEL_FLOPS denominators) ---------------- #
    def _attn_params(self) -> int:
        hd = self.resolved_head_dim
        p = self.d_model * hd * (self.n_heads + 2 * self.n_kv_heads)  # qkv
        p += self.n_heads * hd * self.d_model  # o
        if self.qk_norm:
            p += 2 * hd
        return p

    def _mamba_params(self) -> int:
        di, ds, g, h = self.d_inner, self.ssm_state, self.ssm_groups, self.ssm_heads
        p = self.d_model * di * 2  # z, x projections
        p += self.d_model * (2 * g * ds)  # B, C
        p += self.d_model * h  # dt
        p += (di + 2 * g * ds) * self.conv_width  # depthwise conv
        p += 3 * h  # A_log, D, dt_bias
        p += di  # gated norm scale
        p += di * self.d_model  # out proj
        return p

    def _dense_ffn_params(self) -> int:
        return 3 * self.d_model * self.d_ff

    def _moe_ffn_params(self, active: bool) -> int:
        e = self.moe_top_k if active else self.n_experts
        p = 3 * self.d_model * self.resolved_moe_d_ff * e
        p += self.d_model * self.n_experts  # router
        if self.n_shared_experts:
            p += 3 * self.d_model * (self.n_shared_experts * self.resolved_moe_d_ff)
        return p

    def param_count(self, active: bool = False) -> int:
        """Total (or activated, for MoE) parameter count, excluding embeddings
        for the 6ND convention denominator; embeddings reported separately."""
        total = 0
        for i in range(self.n_layers):
            total += (
                self._attn_params()
                if self.mixer_kind(i) == "attn"
                else self._mamba_params()
            )
            if self.family != "encoder" or True:
                total += (
                    self._moe_ffn_params(active)
                    if self.ffn_kind(i) == "moe"
                    else self._dense_ffn_params()
                )
            total += 2 * self.d_model  # norms
        total += self.d_model  # final norm
        return total

    def embedding_params(self) -> int:
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings and self.family != "encoder":
            n *= 2
        return n


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) per DESIGN.md §5."""
    if cfg.family == "encoder" and shape.kind == "decode":
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, "long_500k needs sub-quadratic attention (ssm/hybrid only)"
    return True, ""


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    period = cfg.scan_period
    return cfg.with_overrides(
        n_layers=period * 2 if period > 1 else 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        n_experts=min(cfg.n_experts, 8),
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16,
        n_patches=min(cfg.n_patches, 4) if cfg.n_patches else 0,
        attn_impl="naive",
        attn_chunk=64,
        ssd_chunk=16,
        remat="none",
    )
