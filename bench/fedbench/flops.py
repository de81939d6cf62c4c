"""The yardstick's arithmetic: the H100's peaks and a model's FLOPs.

``PEAK_BF16`` and ``HBM_BW`` are NVIDIA's published dense peaks of one
H100 SXM at its 700 W limit.  ``active_params`` and ``token_flops`` are
the benchmark's own copy of the program's ``launch/roofline.py``
``model_flops_for`` arithmetic (2 * N_active per token, embeddings left
out, plus 4 * heads * head_dim * context for each attention layer's
scores and values), worked from the configuration file's sizes, so
that a later change to the program cannot move the yardstick.

This file counts a generator of attention layers with a SwiGLU or a
routed SwiGLU in each.  A configuration whose generator it does not fit
names its own file in its generator block (``"flops": "<file>.py"``,
under ``bench/fedbench/``), which supplies ``prefill_flops(m, tokens,
mean_context)`` and ``decode_flops(m, prompt_len, n_tokens)`` of the
generator's model block ``m``.  Each is a term per token that does not
grow with the context (projections, FFNs, a state-space layer's state
update) and a term per position a token reads (attention's scores and
values); ``prefill`` and ``decode`` add them up, so that such a file
says only what its two terms are.  The peaks stay here: they are the
card's.
"""
from __future__ import annotations

PEAK_BF16 = 989e12  # FLOP/s, dense tensor cores
HBM_BW = 3.35e12  # B/s


def active_params(m: dict) -> int:
    """Parameters one token runs through, without the embedding and head:
    attention, the dense or the routed top-k (plus shared) SwiGLU with the
    router, and the norms."""
    d, hd = m["d_model"], m["head_dim"]
    attn = d * hd * (m["n_heads"] + 2 * m["n_kv_heads"]) + m["n_heads"] * hd * d
    if m.get("qk_norm"):
        attn += 2 * hd
    if m.get("n_experts"):
        f = m["moe_d_ff"]
        ffn = 3 * d * f * m["moe_top_k"] + d * m["n_experts"]
        ffn += 3 * d * f * m.get("n_shared_experts", 0)
    else:
        ffn = 3 * d * m["d_ff"]
    return m["n_layers"] * (attn + ffn + 2 * d) + d


def attn_flops_per_context(m: dict) -> int:
    """FLOPs of one token's attention scores and values per position it reads."""
    return 4 * m["n_heads"] * m["head_dim"] * m["n_layers"]


def prefill(per_token: float, per_position: float, tokens: float, mean_context: float) -> float:
    """``tokens`` prompt tokens, each reading ``mean_context`` positions."""
    return tokens * (per_token + per_position * mean_context)


def decode(per_token: float, per_position: float, prompt_len: int, n_tokens: int) -> float:
    """A request's answer tokens: token t (1-based) reads prompt_len + t positions."""
    ctx = n_tokens * prompt_len + n_tokens * (n_tokens + 1) / 2
    return n_tokens * per_token + per_position * ctx


def prefill_flops(m: dict, tokens: float, mean_context: float) -> float:
    return prefill(2 * active_params(m), attn_flops_per_context(m), tokens, mean_context)


def decode_flops(m: dict, prompt_len: int, n_tokens: int) -> float:
    return decode(2 * active_params(m), attn_flops_per_context(m), prompt_len, n_tokens)
