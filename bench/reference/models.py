"""Plain PyTorch forward passes of the benchmark's models, for checking.

Written from the architectures' published descriptions and run in
float32 with TF32 off: a Qwen3 decoder (RMSNorm before attention and
MLP, grouped-query attention with per-head RMSNorm on q and k, rotary
positions on the two halves of each head, SwiGLU, a final RMSNorm and
the LM head), the Qwen2-MoE block (a softmax router over the real
experts, the top k, each token's SwiGLU experts weighted by its gates,
and a shared SwiGLU scaled by a sigmoid gate), and the two encoders
(the same pre-norm block without a causal mask: the dual encoder
mean-pools its non-PAD tokens and normalises, the cross encoder adds a
segment embedding and scores its first token).

Where the served program departs from the published models, these
passes follow the program, and the benchmark's PERF.md lists each
departure: the encoders use the decoder's block (RMSNorm, rotary
positions, SwiGLU) in place of BERT's post-norm GELU layers and learned
positions, and attend to PAD keys as the program does; the MoE router
renormalises the top-k gates.

Weights are a nested dict of tensors in the layout the benchmark made
them in: per layer a stacked leading axis (``blocks/pos0/...``), a
projection ``wq`` as (d, heads, head_dim), ``wo`` as (heads, head_dim,
d), experts as (experts, d, f).  Nothing of the program is imported.

``Prec("fp8")`` runs every matrix product with both operands rounded to
float8 e4m3 (one scale per row of the left operand and per column of
the right one): the control, one precision below the bfloat16 the
configurations serve in.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Prec:
    """How the reference multiplies: ``"f32"`` plainly, ``"fp8"`` with both
    operands rounded to float8 e4m3 first."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"precision {kind!r}")
        self.kind = kind

    def round(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x`` in f32, rounded to e4m3 with one scale per slice along ``dim``."""
        x = x.float()
        if self.kind == "f32":
            return x
        amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
        scale = 448.0 / amax
        return (x * scale).to(torch.float8_e4m3fn).float() / scale

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a (..., K) @ b (K, N) in f32."""
        return self.round(a, -1) @ self.round(b, 0)


F32 = Prec("f32")


def rmsnorm(x, w, eps: float):
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rope(x, positions, theta: float):
    """x (..., S, H, hd); the first and second halves of each head rotate as pairs."""
    hd = x.shape[-1]
    half = hd // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64, device=x.device) * 2.0 / hd))
    ang = positions.double()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang).float()[:, None, :], torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, causal: bool, prec: Prec):
    """q (B, S, H, hd), k and v (B, S, KV, hd); query head h reads KV head
    h // (H / KV).  Returns (B, S, H * hd)."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    qh, kh, vh = q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    scores = prec.round(qh, -1) @ prec.round(kh, -1).transpose(-1, -2) / math.sqrt(hd)
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = prec.round(probs, -1) @ prec.round(vh, -2)
    return out.permute(0, 2, 1, 3).reshape(b, s, h * hd)


def _layer(tree, i: int):
    """Layer ``i``'s leaves of a stacked tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _proj(x, w, prec):
    """x (B, S, d) @ w (d, H, hd) -> (B, S, H, hd)."""
    d, h, hd = w.shape
    return prec.mm(x, w.reshape(d, h * hd)).reshape(*x.shape[:-1], h, hd)


def attn_block(cfg: dict, p, x, positions, causal: bool, prec: Prec):
    q, k, v = _proj(x, p["wq"], prec), _proj(x, p["wk"], prec), _proj(x, p["wv"], prec)
    if cfg.get("qk_norm"):
        q = rmsnorm(q, p["q_norm"], cfg["norm_eps"])
        k = rmsnorm(k, p["k_norm"], cfg["norm_eps"])
    q, k = rope(q, positions, cfg["rope_theta"]), rope(k, positions, cfg["rope_theta"])
    o = attention(q, k, v, causal, prec)
    h, hd, d = p["wo"].shape
    return prec.mm(o, p["wo"].reshape(h * hd, d))


def swiglu(p, x, prec: Prec):
    return prec.mm(F.silu(prec.mm(x, p["wg"])) * prec.mm(x, p["wu"]), p["wd"])


def moe_block(cfg: dict, p, x, prec: Prec):
    """Routed experts (top k of the softmax over the real experts, gates
    renormalised) plus the sigmoid-gated shared SwiGLU.  x (B, S, d)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).float()
    logits = x2 @ p["router"].float()[:, : cfg["n_experts"]]
    gates, ids = torch.topk(torch.softmax(logits, dim=-1), cfg["moe_top_k"], dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(x2)
    for e in torch.unique(ids).tolist():
        tok, slot = (ids == e).nonzero(as_tuple=True)
        pe = {"wg": p["wg"][e], "wu": p["wu"][e], "wd": p["wd"][e]}
        out.index_add_(0, tok, swiglu(pe, x2[tok], prec) * gates[tok, slot][:, None])
    out = out.reshape(shape)
    if cfg.get("n_shared_experts"):
        gate = torch.sigmoid(x.float() @ p["shared_gate"].float())
        out = out + swiglu(p["shared"], x, prec) * gate
    return out


def decoder_logits(cfg: dict, params, tokens: torch.Tensor, n_last: int, prec: Prec = F32):
    """Causal LM over one sequence ``tokens`` (S,); the logits (n_last, V)
    of its last ``n_last`` positions, layer by layer."""
    eps = cfg["norm_eps"]
    h = params["embed"]["tok"][tokens.long()].float()[None]
    positions = torch.arange(tokens.shape[0], device=tokens.device)
    blocks = params["blocks"]["pos0"]
    for i in range(cfg["n_layers"]):
        p = _layer(blocks, i)
        h = h + attn_block(cfg, p["attn"], rmsnorm(h, p["mixer_norm"], eps), positions, True, prec)
        x = rmsnorm(h, p["ffn_norm"], eps)
        h = h + (moe_block(cfg, p["moe"], x, prec) if "moe" in p else swiglu(p["mlp"], x, prec))
    h = rmsnorm(h[0, -n_last:], params["final_norm"], eps)
    w = params["embed"]["tok"].T if cfg.get("tie_embeddings") else params["head"]["w"]
    return prec.mm(h, w)


def encoder_states(cfg: dict, params, h, prec: Prec):
    """The encoders' bidirectional stack over h (B, S, d), final-normed."""
    eps = cfg["norm_eps"]
    positions = torch.arange(h.shape[1], device=h.device)
    for i in range(cfg["n_layers"]):
        p = _layer(params["blocks"], i)
        h = h + attn_block(cfg, p["attn"], rmsnorm(h, p["mixer_norm"], eps), positions, False, prec)
        h = h + swiglu(p["mlp"], rmsnorm(h, p["ffn_norm"], eps), prec)
    return rmsnorm(h, params["final_norm"], eps)


def embed_texts(cfg: dict, params, tokens: torch.Tensor, prec: Prec = F32, batch: int = 256):
    """Dual encoder: (N, S) token rows -> (N, d) unit vectors, the mean of
    each row's non-PAD states."""
    outs = []
    for i in range(0, tokens.shape[0], batch):
        t = tokens[i : i + batch]
        h = encoder_states(cfg, params, params["embed"]["tok"][t.long()].float(), prec)
        m = (t != 0).float()[..., None]
        pooled = (h * m).sum(1) / m.sum(1).clamp_min(1.0)
        outs.append(pooled / pooled.norm(dim=-1, keepdim=True).clamp_min(1e-9))
    return torch.cat(outs)


def score_pairs(cfg: dict, params, tokens: torch.Tensor, types: torch.Tensor, prec: Prec = F32):
    """Cross encoder: (N, S) packed pairs -> (N,) scores from the first state."""
    h = params["embed"]["tok"][tokens.long()].float() + params["type_embed"].float()[types.long()]
    h = encoder_states(cfg, params, h, prec)
    return (h[:, 0] @ params["score"]["w"].float())[:, 0]
