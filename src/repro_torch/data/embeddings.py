"""Training-free bag-of-words hash embedder, on the device.

Deterministic per-token Gaussian vectors keyed by token id, mean-pooled
over the non-PAD tokens and L2-normalized: lexical-overlap similarity.

The vectors are bit-compatible with ``jax.random.normal(fold_in(
PRNGKey(seed), tid), (dim,))`` under JAX's default
``jax_threefry_partitionable=True``: threefry-2x32 is written out here in
64-bit integer tensor ops (masked to 32 bits), so the same corpus gives
the same embeddings, the same retrieval and the same prompts in both
packages.  Vectors are generated once per distinct token id in the
batch and gathered, not once per token occurrence.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.data.tokenizer import PAD

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 with 20 rounds (Salmon et al.), as JAX computes it.
    Keys and counters are int64 tensors (or ints) holding uint32 values;
    returns the two uint32 output words as int64 tensors."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def token_vectors(ids: torch.Tensor, dim: int, seed: int = 17) -> torch.Tensor:
    """``(U,)`` int token ids -> ``(U, dim)`` f32 standard-normal vectors,
    equal to ``jax.random.normal(fold_in(PRNGKey(seed), id), (dim,))``."""
    ids = ids.to(torch.int64) & _M32
    zero = torch.zeros_like(ids)
    # PRNGKey(seed) = (0, seed); fold_in(key, d) = threefry(key, (0, d))
    a, b = threefry2x32(0, seed & _M32, zero, ids)  # (U,) per-token keys
    # partitionable random bits: counter (hi, lo) = (0, j), bits = y0 ^ y1
    j = torch.arange(dim, dtype=torch.int64, device=ids.device)[None, :]
    y0, y1 = threefry2x32(a[:, None], b[:, None], torch.zeros_like(j), j)
    bits = (y0 ^ y1) & _M32
    # uniform in [nextafter(-1, 0), 1): mantissa trick, then sqrt(2)*erfinv
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = f * (np.float32(1.0) - lo) + lo
    u = torch.maximum(u, torch.tensor(lo, dtype=torch.float32, device=u.device))
    return (math.sqrt(2.0) * torch.erfinv(u.double())).float()


def bag_embed(tokens, dim: int = 256, seed: int = 17, device: str | torch.device = "cuda"):
    """tokens: (N, S) int -> (N, dim) f32 unit-norm tensor on ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bag_embed: device='cuda' asked for but no CUDA device is present")
    tokens = torch.as_tensor(np.asarray(tokens), device=device).to(torch.int64)
    uniq, inv = torch.unique(tokens, return_inverse=True)
    vecs = token_vectors(uniq, dim, seed)[inv]  # (N, S, dim)
    mask = (tokens != PAD).to(torch.float32)[..., None]
    pooled = (vecs * mask).sum(1) / torch.clamp(mask.sum(1), min=1.0)
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / torch.clamp(norm, min=1e-9)
