"""Dense flash attention: grouped-query attention over contiguous
``(B, S, heads, head_dim)`` tensors, causal or not.

``flash_attention`` launches the hand-written kernel
(``kernels/csrc/flash_attention.cu``) for CUDA tensors, runs
``flash_attention_plain`` for CPU tensors and returns an empty output
for ``meta`` tensors; anything else raises.  ``cost`` is one call's FLOPs
and bytes, which a cost counter records (``_build.counted``).
``launches`` counts kernel launches.  Query position ``i`` sees key
position ``j`` iff the call is non-causal or ``i >= j`` (top-left
aligned); query head ``h`` reads KV head ``h // (H // KV)``.  The kernel
takes head_dim 16, 32, 64 and 128; a smaller head_dim (HuBERT's 80) is
padded with zero columns to the next of them, its scale kept at
``1 / sqrt(head_dim)``.

Gradients: when an input requires grad under grad mode, the call goes
through ``FlashAttention``, an autograd Function whose forward is the
kernel (the plain version on the CPU) and whose backward recomputes
``flash_attention_plain`` from the saved q, k, v and differentiates it.
The reference has no backward kernel either: it differentiates its XLA
attention.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

launches = 0

_HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_plain(q, k, v, *, causal: bool):
    """Materialised softmax in f32.  q (B, Sq, H, dh); k, v (B, Sk, KV, dh)
    -> (B, Sq, H, dh) in q's dtype."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qr = q.float().reshape(b, sq, kv, h // kv, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qr, k.float()) / math.sqrt(dh)
    if causal:
        mask = torch.arange(sq, device=q.device)[:, None] >= torch.arange(sk, device=q.device)[None, :]
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, dh).to(q.dtype)


def _in_place(t) -> bool:
    """Whether the kernel can read ``t`` through its strides: head_dim
    contiguous and, in bf16, the pointer and every stride that is ever
    stepped (of a dimension longer than 1) a multiple of 16 bytes."""
    if t.stride(-1) != 1:
        return False
    if t.dtype != torch.bfloat16:
        return True
    return t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)


def _padded_head_dim(dh: int) -> int | None:
    """The kernel's head_dim for inputs of head_dim ``dh``: ``dh`` itself,
    else the next one up (the inputs padded with zero columns), None above
    128."""
    return next((d for d in _HEAD_DIMS if d >= dh), None)


def cost(q, k, v, causal: bool):
    """(FLOPs by dtype, bytes) of one call: q, k and v read once, the
    output written once; Q.K^T and P.V over the (query, key) pairs the
    mask keeps (query i sees keys j <= i, top-left aligned, when causal)."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    m = min(sq, sk)
    pairs = m * (m + 1) // 2 + (sq - m) * sk if causal else sq * sk
    nbytes = q.element_size() * (2 * b * sq * h * dh + 2 * b * sk * kv * dh)
    return _build.flops((4 * b * h * dh * pairs, q.dtype)), nbytes


def _launch(q, k, v, causal: bool):
    """The kernel on CUDA tensors (checked), the plain version on CPU ones,
    an empty output on meta ones; counted as one kernel call."""
    return _build.counted("flash_attention", lambda: cost(q, k, v, causal), lambda: _run(q, k, v, causal))


def _run(q, k, v, causal: bool):
    if q.device.type == "cpu":
        return _build.fresh(flash_attention_plain(q, k, v, causal=causal))
    if q.device.type == "meta":  # laid out as the kernel's: a padded head_dim's columns cut off
        dh_run = _padded_head_dim(q.shape[3]) or q.shape[3]
        return torch.empty((*q.shape[:3], dh_run), dtype=q.dtype, device=q.device)[..., : q.shape[3]]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: tensor on {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    b, sq, h, dh = q.shape
    _, sk, kv, dh_k = k.shape
    dh_run = _padded_head_dim(dh)
    if (
        v.shape != k.shape or k.shape[0] != b or dh_k != dh or dh_run is None or dh == 0
        or kv == 0 or h % kv
    ):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: dtypes {q.dtype} / {k.dtype} / {v.dtype}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"flash_attention: tensors on {q.device} and {t.device}")
    if dh_run != dh:  # zero columns add nothing to q . k and give zero output columns
        q, k, v = (F.pad(t, (0, dh_run - dh)) for t in (q, k, v))
    # read in place through the strides; only head_dim must be contiguous,
    # and for bf16 (16-byte copies) every pointer and stride 16-byte aligned
    # (a fresh copy: a contiguous view at an odd offset stays unaligned)
    q, k, v = (t if _in_place(t) else t.clone(memory_format=torch.contiguous_format) for t in (q, k, v))
    out = torch.empty((b, sq, h, dh_run), dtype=q.dtype, device=q.device)
    if b == 0 or sq == 0:
        return out[..., :dh]
    lib = _build.load("flash_attention")
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk, h, kv, dh_run, dh,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal), int(q.dtype == torch.bfloat16),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    _build.check(err, "flash_attention")
    global launches
    launches += 1
    return out[..., :dh]


class FlashAttention(torch.autograd.Function):
    """The kernel forward; a backward that recomputes the plain version
    (top-left causal, query head h reading KV head h // G, softmax in f32)
    from the saved inputs and returns dq, dk, dv in their dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v, causal)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        wanted = [i for i in range(3) if ctx.needs_input_grad[i]]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(i in wanted) for i, t in enumerate((q, k, v))]
            out = flash_attention_plain(*leaves, causal=ctx.causal)
            got = torch.autograd.grad(out, [leaves[i] for i in wanted], grad_out)
        grads = [None, None, None]
        for i, g in zip(wanted, got):
            grads[i] = g
        return (*grads, None)


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """Full-sequence attention.  A non-zero ``q_offset`` raises: the
    kernel serves whole-sequence prefill, training and the encoders, and
    decode goes through ``layers.attn_decode``."""
    if q_offset:
        raise ValueError(f"flash_attention: q_offset={q_offset}; only full-sequence attention (0) is supported")
    if _build.needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal)
    return _launch(q, k, v, causal)
