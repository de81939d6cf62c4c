"""FLOPs of a generator whose attention layers mix a sliding window with
full attention (Mellum2: a window of 1,024 keys on the layers i % 4 != 3,
full causal attention on the others), for ``mfu``.

Per token: 2 x the parameters one token runs through, the output head's
included (the configuration's 2.21 B active: ``flops.active_params``, which
leaves the embedding and head out, plus d_model x vocab).  Per position a
token reads: 4 x heads x head_dim for each layer, where a windowed layer
reads at most ``window`` positions (its own and ``window - 1`` before it)
and a full layer every one.

The harness hands ``prefill_flops`` the prompt tokens computed and their
mean context only; the prompts are taken as all of length twice that
mean, so each prefill token at position p (0-based) reads p + 1
positions on a full layer and min(p + 1, window) on a windowed one.
"""
from __future__ import annotations

from fedbench import flops


def per_token(m: dict) -> float:
    return 2 * (flops.active_params(m) + m["d_model"] * m["vocab_size"])


def layer_kinds(m: dict) -> tuple[int, int]:
    """(windowed layers, full layers)."""
    every, offset = m.get("full_every", 0), m.get("full_offset", 0)
    if m.get("window", 0) <= 0:
        return 0, m["n_layers"]
    full = sum(1 for i in range(m["n_layers"]) if every and i % every == offset)
    return m["n_layers"] - full, full


def per_position(m: dict) -> float:
    """FLOPs of one layer's scores and values per position a token reads."""
    return 4 * m["n_heads"] * m["head_dim"]


def _window_sum(n: float, w: float) -> float:
    """sum over p = 1 .. n of min(p, w)."""
    if n <= w:
        return n * (n + 1) / 2
    return w * (w + 1) / 2 + (n - w) * w


def prefill_flops(m: dict, tokens: float, mean_context: float) -> float:
    n_win, n_full = layer_kinds(m)
    length = max(1.0, 2 * mean_context)  # each token reads p + 1 positions, mean (length + 1) / 2
    full_ctx = (length + 1) / 2
    win_ctx = _window_sum(length, m.get("window", 0)) / length if n_win else 0.0
    return tokens * (per_token(m) + per_position(m) * (n_full * full_ctx + n_win * win_ctx))


def decode_flops(m: dict, prompt_len: int, n_tokens: int) -> float:
    """A request's answer tokens: token t (1-based) reads prompt_len + t positions."""
    n_win, n_full = layer_kinds(m)
    full = n_tokens * prompt_len + n_tokens * (n_tokens + 1) / 2
    w = m.get("window", 0)
    win = (_window_sum(prompt_len + n_tokens, w) - _window_sum(prompt_len, w)) if n_win else 0.0
    return n_tokens * per_token(m) + per_position(m) * (n_full * full + n_win * win)
