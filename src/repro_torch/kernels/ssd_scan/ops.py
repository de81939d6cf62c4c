"""Mamba2 SSD intra-chunk terms (the state-space-duality chunk of the
Mamba2 mixer).

``ssd_chunk`` launches the hand-written kernel
(``kernels/csrc/ssd_chunk.cu``) for CUDA tensors, runs
``ssd_chunk_plain`` for CPU tensors and returns empty outputs for
``meta`` tensors; anything else raises.  ``cost`` is one call's FLOPs and
bytes, which a cost counter records (``_build.counted``).  ``launches``
counts the calls that reach the card, one each (two kernel launches: the
``C . B^T`` tiles, then the chunk terms).  For one chunk of ``L`` positions per (batch,
head), with ``cum`` the inclusive prefix sum of ``dt * a`` over the chunk:

    y_intra[i] = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
    state      = sum_j exp(cum_L - cum_j) dt_j x_j^T B_j
    decay      = exp(cum_L)

``b`` and ``c`` carry one row per head; a single group shared by every
head may come as an ``expand``ed view (head stride 0), which the kernel
reads in place, computing ``C . B^T`` once for all the heads.

Gradients: when an input requires grad under grad mode, the call goes
through ``SSDChunk``, an autograd Function whose forward is the kernel
(the plain version on the CPU) and whose backward recomputes
``ssd_chunk_plain`` from the saved inputs and differentiates it (the
reference differentiates its XLA scan; it has no backward kernel).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

_DIMS = (16, 32, 64, 128)
_TILE = 64  # positions per i / j tile of the kernel


def ssd_chunk_plain(x, b, c, dt, a):
    """Materialised ``L x L`` scores in f32.  x (B, L, H, hd); b, c
    (B, L, H, ds); dt (B, L, H) f32; a (H,) f32 -> y_intra (B, L, H, hd),
    state (B, H, hd, ds), decay (B, H), all f32."""
    xf, bf, cf = x.float(), b.float(), c.float()
    cum = torch.cumsum(dt * a[None, None, :], dim=1)  # (B, L, H)
    cum_h = cum.transpose(1, 2)  # (B, H, L)
    cb = torch.einsum("bihs,bjhs->bhij", cf, bf)
    l = x.shape[1]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    arg = torch.where(mask, cum_h[:, :, :, None] - cum_h[:, :, None, :], torch.full((), -1e30, device=x.device))
    scores = cb * torch.exp(arg) * dt.transpose(1, 2)[:, :, None, :]
    y = torch.einsum("bhij,bjhp->bihp", scores, xf)
    wgt = torch.exp(cum[:, -1:, :] - cum) * dt  # (B, L, H)
    st = torch.einsum("bjh,bjhs,bjhp->bhps", wgt, bf, xf)
    return y, st, torch.exp(cum[:, -1, :])


def _scores_scratch(b, c, bsz, l, h):
    """(groups, f32 scratch for the kernel's ``C . B^T`` tiles): one group
    when every head reads the same B and C rows (head stride 0), else one
    per head; per (batch, group) the n (n + 1) / 2 causal 64 x 64 tiles of
    n = ceil(l / 64)."""
    groups = 1 if b.stride(2) == 0 and c.stride(2) == 0 else h
    n_t = -(-l // _TILE)
    return groups, torch.empty((bsz, groups, n_t * (n_t + 1) // 2, _TILE, _TILE), dtype=torch.float32,
                               device=b.device)


def _rows16(t):
    """``t`` read in place where its rows are 16-byte aligned (the kernel's
    16-byte copies), else a contiguous copy; an expanded head axis (stride
    0) stays expanded."""
    if _build.aligned16(t):
        return t
    if t.stride(2) == 0:
        return t[:, :, :1].clone(memory_format=torch.contiguous_format).expand(t.shape)
    return t.clone(memory_format=torch.contiguous_format)


class SSDChunk(torch.autograd.Function):
    """The kernel forward; a backward that recomputes the plain version from
    the saved x, b, c, dt, a and returns their gradients in their dtypes
    (an expanded b or c gets the full per-head gradient, which the expand's
    own backward sums over the heads)."""

    @staticmethod
    def forward(ctx, x, b, c, dt, a):
        ctx.save_for_backward(x, b, c, dt, a)
        return _launch(x, b, c, dt, a)

    @staticmethod
    def backward(ctx, gy, gst, gdec):
        saved = ctx.saved_tensors
        wanted = [i for i in range(5) if ctx.needs_input_grad[i]]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(i in wanted) for i, t in enumerate(saved)]
            outs = ssd_chunk_plain(*leaves)
            got = torch.autograd.grad(outs, [leaves[i] for i in wanted], (gy, gst, gdec))
        grads = [None] * 5
        for i, g in zip(wanted, got):
            grads[i] = g
        return tuple(grads)


def ssd_chunk(x, b, c, dt, a):
    """One chunk's SSD terms per (batch, head); see the module docstring."""
    if _build.needs_grad(x, b, c, dt, a):
        return SSDChunk.apply(x, b, c, dt, a)
    return _launch(x, b, c, dt, a)


def cost(x, b, c, dt, a):
    """(FLOPs by dtype, bytes) of one call.  Bytes: x, the distinct B and C
    rows (one group when every head reads the same rows, head stride 0,
    else one per head), dt and a read once; y, state and decay written once.
    FLOPs over the causal half (j <= i): C.B^T once per (batch, group) on
    the inputs' type, the score-weighted x and the state product per
    (batch, head) in f32 (the decay weights are f32)."""
    bsz, l, h, hd = x.shape
    ds = b.shape[3]
    g = 1 if b.stride(2) == 0 and c.stride(2) == 0 else h
    tri = l * (l + 1) // 2
    nbytes = x.element_size() * (bsz * l * h * hd + 2 * bsz * l * g * ds) + 4 * (bsz * l * h + h) \
        + 4 * (bsz * l * h * hd + bsz * h * hd * ds + bsz * h)
    return _build.flops((bsz * g * tri * 2 * ds, x.dtype),
                        (bsz * h * (tri * 2 * hd + 2 * l * hd * ds), torch.float32)), nbytes


def _launch(x, b, c, dt, a):
    """The kernel on CUDA tensors (checked), the plain version on CPU ones,
    empty outputs on meta ones; counted as one kernel call."""
    return _build.counted("ssd_chunk", lambda: cost(x, b, c, dt, a), lambda: _run(x, b, c, dt, a))


def _run(x, b, c, dt, a):
    if x.device.type == "cpu":
        return _build.fresh(ssd_chunk_plain(x, b, c, dt, a))
    if x.device.type == "meta":
        bsz, l, h, hd = x.shape
        ds = b.shape[3]
        f32 = dict(dtype=torch.float32, device=x.device)
        return torch.empty((bsz, l, h, hd), **f32), torch.empty((bsz, h, hd, ds), **f32), torch.empty((bsz, h), **f32)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk: tensor on {x.device}")
    if x.dim() != 4 or b.dim() != 4 or dt.dim() != 3:
        raise ValueError(f"ssd_chunk: x {tuple(x.shape)}, b {tuple(b.shape)}, dt {tuple(dt.shape)}")
    bsz, l, h, hd = x.shape
    ds = b.shape[3]
    if (
        b.shape != (bsz, l, h, ds) or c.shape != b.shape or dt.shape != (bsz, l, h) or a.shape != (h,)
        or hd not in _DIMS or ds not in _DIMS or l == 0
    ):
        raise ValueError(
            f"ssd_chunk: x {tuple(x.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}, "
            f"dt {tuple(dt.shape)}, a {tuple(a.shape)}"
        )
    if not (x.dtype == b.dtype == c.dtype) or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ssd_chunk: dtypes {x.dtype} / {b.dtype} / {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"ssd_chunk: dt {dt.dtype} and a {a.dtype} must be float32")
    for t in (b, c, dt, a):
        if t.device != x.device:
            raise ValueError(f"ssd_chunk: tensors on {x.device} and {t.device}")
    # read in place through the strides where the kernel can
    c, dt = (t if t.stride(-1) == 1 else t.contiguous() for t in (c, dt))
    x, b = _rows16(x), _rows16(b)  # staged by 16-byte copies
    a = a.contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((bsz, l, h, hd), **f32)
    st = torch.empty((bsz, h, hd, ds), **f32)
    dec = torch.empty((bsz, h), **f32)
    if bsz == 0 or h == 0:
        return y, st, dec
    groups, cbt = _scores_scratch(b, c, bsz, l, h)
    lib = _build.load("ssd_chunk")
    err = lib.ssd_chunk_launch(
        x.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(), a.data_ptr(), cbt.data_ptr(), y.data_ptr(),
        st.data_ptr(), dec.data_ptr(), bsz, l, h, hd, ds, groups, *x.stride()[:3], *b.stride()[:3],
        *c.stride()[:3], *dt.stride(), int(x.dtype == torch.bfloat16),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    _build.check(err, "ssd_chunk")
    global launches
    launches += 1
    return y, st, dec
