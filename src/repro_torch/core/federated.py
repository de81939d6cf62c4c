"""Federated training of the embedding and re-ranking models (paper
§2.2) with cryptographic secure aggregation.

* ``fedavg``: weighted model averaging (in f64, cast back per leaf).
* ``SecureAggregator``: Bonawitz-style pairwise-mask secure aggregation in
  exact fixed-point modular arithmetic (uint64 mod 2^62, scale 2^24; masks
  derived from the attested Diffie-Hellman pair keys of
  ``core/confidential.Enclave``): the server sees only masked updates,
  and the masks cancel exactly in the sum.  The exchange runs in host
  numpy, as in the reference: device tensors come to the host as f64,
  the mean goes back to each leaf's device and dtype.
* ``federated_train_embedder``: FedAvg rounds of a local objective (the
  paper's InfoNCE on each provider's (query, chunk) pairs) into one shared
  F_emb; ``secure=True`` routes the update exchange through the masks.

Trees are nested dicts whose leaves are tensors (on any device) or numpy
arrays; the arithmetic per leaf is the reference's, in the same order.
"""
from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.confidential import Enclave, hkdf
from repro_torch.models.params import leaves, map_tree

_Q = 1 << 62  # modulus
_SCALE = 1 << 24  # fixed-point scale


def _leaves(tree) -> list:
    """The leaves in sorted-path order (the reference's flattening order)."""
    return [x for _, x in leaves(tree)]


def _rebuild(like, it):
    """``like``'s structure, its leaves taken in sorted-path order from ``it``."""
    if isinstance(like, dict):
        return {k: _rebuild(like[k], it) for k in sorted(like)}
    return next(it)


def _f64(x):
    return x.double() if isinstance(x, torch.Tensor) else np.asarray(x, np.float64)


def _cast_like(x, like):
    """``x`` (f64) in ``like``'s dtype, on its device for a tensor."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(x).to(device=like.device, dtype=like.dtype)
    return np.asarray(x).astype(np.asarray(like).dtype)


def _host_f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


def fedavg(client_params: Sequence, weights: Sequence[float] | None = None):
    """The weighted mean of the clients' trees (weights normalised)."""
    w = np.asarray(weights if weights is not None else [1.0] * len(client_params), np.float64)
    w = w / w.sum()
    return map_tree(lambda *xs: _cast_like(sum(float(wi) * _f64(x) for wi, x in zip(w, xs)), xs[0]), *client_params)


# ------------------------------------------------------------------ #
# secure aggregation
# ------------------------------------------------------------------ #


def _encode(x: np.ndarray) -> np.ndarray:
    fp = np.round(np.asarray(x, np.float64) * _SCALE).astype(np.int64)
    return np.mod(fp, _Q).astype(np.uint64)


def _decode(x: np.ndarray, n_clients: int) -> np.ndarray:
    v = x.astype(np.int64)
    v = np.where(v > _Q // 2, v - _Q, v)  # centered representative
    return (v / _SCALE).astype(np.float64)


def _pair_mask(key: bytes, round_id: int, size: int) -> np.ndarray:
    seed = hkdf(key, b"mask-round:%d" % round_id, 32)
    rng = np.random.default_rng(np.frombuffer(seed, np.uint64))
    return rng.integers(0, _Q, size=size, dtype=np.uint64)


class SecureAggregator:
    """Pairwise-cancelling-mask aggregation over attested DH pair keys."""

    def __init__(self, enclaves: Sequence[Enclave]):
        self.enclaves = list(enclaves)
        n = len(enclaves)
        self.pair_keys = {}
        for i in range(n):
            for j in range(i + 1, n):
                self.pair_keys[(i, j)] = enclaves[i].shared_key(enclaves[j].dh_public, b"secure-agg")

    def mask_update(self, client: int, flat: np.ndarray, round_id: int) -> np.ndarray:
        """Client side: fixed-point encode, then add (lower index) or
        subtract (higher index) each pair's mask, mod 2^62."""
        enc = _encode(flat)
        for (i, j), key in self.pair_keys.items():
            if client not in (i, j):
                continue
            m = _pair_mask(key, round_id, flat.size)
            if client == i:
                enc = np.mod(enc + m, _Q).astype(np.uint64)
            else:
                enc = np.mod(enc - m, _Q).astype(np.uint64)
        return enc

    def aggregate(self, masked: Sequence[np.ndarray]) -> np.ndarray:
        """Server side: the modular sum, in which the masks cancel."""
        total = np.zeros_like(masked[0])
        for m in masked:
            total = np.mod(total + m, _Q).astype(np.uint64)
        return _decode(total, len(masked))


def secure_fedavg(client_updates: Sequence, aggregator: SecureAggregator, round_id: int):
    """The secure-aggregated MEAN of the clients' update trees, each leaf
    in the first client's dtype and on its device."""
    n = len(client_updates)
    flats = []
    for c, upd in enumerate(client_updates):
        flat = np.concatenate([_host_f64(x).ravel() for x in _leaves(upd)])
        flats.append(aggregator.mask_update(c, flat, round_id))
    total = aggregator.aggregate(flats) / n
    out, off = [], 0
    for x in _leaves(client_updates[0]):
        size = int(np.prod(x.shape))
        seg = total[off: off + size].reshape(tuple(x.shape))
        out.append(_cast_like(seg, x))
        off += size
    return _rebuild(client_updates[0], iter(out))


# ------------------------------------------------------------------ #
# federated embedder training (FedAvg over providers)
# ------------------------------------------------------------------ #


def federated_train_embedder(
    init_params,
    client_batch_fns: Sequence[Callable[[int], dict]],  # round -> local batch
    grad_fn: Callable,  # (params, batch) -> (loss, grads)
    apply_update: Callable,  # (params, grads) -> params
    n_rounds: int,
    secure: bool = True,
    local_steps: int = 1,
):
    """Returns (global params, per-round history).  Each round every client
    takes ``local_steps`` steps from the global parameters on its own
    batch; the mean of their deltas (through ``SecureAggregator`` when
    ``secure``) moves the global parameters.  History entries: ``round``,
    ``mean_loss`` (the clients' last local losses) and ``exchange_s`` (the
    host seconds of the update exchange)."""
    params = init_params
    enclaves = [Enclave(f"fl-client-{i}") for i in range(len(client_batch_fns))]
    agg = SecureAggregator(enclaves) if secure else None
    history = []
    for r in range(n_rounds):
        updates, losses = [], []
        for batch_fn in client_batch_fns:
            local = params
            for _ in range(local_steps):
                loss, grads = grad_fn(local, batch_fn(r))
                local = apply_update(local, grads)
            updates.append(map_tree(lambda a, b: a - b, local, params))
            losses.append(float(loss))
        t0 = time.perf_counter()
        if secure:
            mean_delta = secure_fedavg(updates, agg, r)
        else:
            mean_delta = map_tree(lambda *xs: sum(_f64(x) for x in xs) / len(xs), *updates)
        params = map_tree(lambda p, d: _cast_like(_f64(p) + d, p), params, mean_delta)
        history.append({"round": r, "mean_loss": float(np.mean(losses)), "exchange_s": time.perf_counter() - t0})
    return params, history
