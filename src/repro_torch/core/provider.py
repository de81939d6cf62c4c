"""Data provider (paper §2.3.4): standardized retrieval API behind an
attested channel.

Each provider owns its corpus shard, vectorizes it once with its embedding
model of choice (off-the-shelf bag embedder or an FL-trained dual
encoder), and answers ``retrieve`` requests with its local top-m — raw
chunks never leave except as filtered, AEAD-sealed responses to an
attested orchestrator.  Providers never talk to each other and never
receive inbound connections except via the orchestrator channel (paper
§4.1).

The ``fail`` flag is the blunt always-down switch (kept for the quorum
tests and the ``--kill-provider`` CLI); the full fault taxonomy —
seeded connection failures, timeouts, jitter, payload corruption,
replayed nonces, poisoned scores — lives in
``core.resilience.FaultyProvider``, which wraps a provider without it
noticing.

The corpus embeddings live on the provider's ``device`` as one
``(N, D)`` tensor; ``retrieve`` embeds the query batch there and scores
it with ``kernels/retrieval_topk`` (the hand-written kernel on CUDA, its
plain version on the CPU).  Only the ``(B, m)`` ids and scores come back
to the host.
"""
from __future__ import annotations

import io
import threading
import time
from typing import Callable, Sequence

import numpy as np

import torch

from repro_torch.core.confidential import Enclave, SecureChannel
from repro_torch.core.filters import Filter, apply_filters
from repro_torch.data.corpus import Chunk
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.kernels.retrieval_topk.ops import retrieval_topk
from repro_torch.runtime import trace


def pack(payload: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **payload)
    return buf.getvalue()


def unpack(raw: bytes) -> dict:
    with np.load(io.BytesIO(raw), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


class DataProvider:
    def __init__(
        self,
        provider_id: int,
        chunks: Sequence[Chunk],
        embed_fn: Callable,  # (tokens (N,S) int32) -> (N,D) f32 unit-norm
        tokenizer: HashTokenizer,
        chunk_max_len: int = 40,
        filters: list[Filter] | None = None,
        fail: bool = False,
        delay_s: float = 0.0,
        device: str | torch.device = "cuda",
    ):
        self.provider_id = provider_id
        self.chunks = list(chunks)
        self.embed_fn = embed_fn
        self.tok = tokenizer
        self.filters = filters or []
        self.device = torch.device(device)
        self.fail = fail
        self.delay_s = delay_s
        self.enclave = Enclave(f"cfedrag-provider-v1:{provider_id}")
        with trace.span("provider.tokenize", provider=provider_id, chunks=len(self.chunks)):
            self.chunk_tokens = np.stack(
                [tokenizer.encode(c.text, max_len=chunk_max_len) for c in self.chunks]
            )
        self._chunk_id_arr = np.asarray([c.chunk_id for c in self.chunks], np.int64)
        self.embeddings: torch.Tensor | None = None
        self.channel: SecureChannel | None = None
        self.n_requests = 0  # sealed requests handled (observability/tests)
        # serializes sealed round-trips: the orchestrator's concurrent
        # fan-out must never interleave two rounds' channel sequence
        # numbers on the same provider (e.g. an abandoned straggler
        # finishing while the next collect is already in flight)
        self.rpc_lock = threading.Lock()

    # ---- lifecycle ----
    def build_index(self, batch: int = 512):
        with trace.span("provider.index", provider=self.provider_id, chunks=len(self.chunks)):
            outs = []
            for i in range(0, len(self.chunk_tokens), batch):
                outs.append(self._on_device(self.embed_fn(self.chunk_tokens[i : i + batch])))
            self.embeddings = torch.cat(outs, 0).contiguous()

    def _on_device(self, emb) -> torch.Tensor:
        return torch.as_tensor(emb, device=self.device).to(torch.float32)

    def list_products(self) -> dict:
        corpora = sorted({c.corpus for c in self.chunks})
        return {
            "provider": self.provider_id,
            "products": corpora,
            "n_chunks": len(self.chunks),
        }

    # ---- retrieval API (sealed request/response) ----
    def handle_request(self, nonce: bytes, sealed: bytes) -> tuple[bytes, bytes]:
        """Sealed {query_tokens, m} -> sealed {scores, chunk_ids, chunk_tokens}.

        ``query_tokens`` may be a single (S,) query or a (B, S) batch; the
        response arrays carry the matching leading shape."""
        self.n_requests += 1
        if self.fail:
            raise ConnectionError(f"provider {self.provider_id} down")
        if self.delay_s:
            time.sleep(self.delay_s)
        assert self.channel is not None, "no established channel"
        req = unpack(self.channel.open(nonce, sealed))
        out = self.retrieve(req["query_tokens"], int(req["m"]))
        return self.channel.seal(pack(out))

    def retrieve(self, query_tokens: np.ndarray, m: int) -> dict:
        """Local top-m.  query_tokens: (S,) -> {scores (m,), chunk_ids (m,),
        chunk_tokens (m, S_c)}; or batched (B, S) -> (B, m, ...) — the whole
        batch is embedded and scored in one kernel call."""
        assert self.embeddings is not None, "index not built"
        q = np.asarray(query_tokens)
        single = q.ndim == 1
        if single:
            q = q[None, :]
        q_emb = self._on_device(self.embed_fn(q))  # (B, D)
        m_eff = min(m, len(self.chunks))
        scores, idx = retrieval_topk(q_emb.contiguous(), self.embeddings, m_eff)
        scores = trace.to_host(scores, "provider.topk").numpy()  # (B, m)
        idx = trace.to_host(idx, "provider.topk").numpy()
        if single:
            scores, idx = scores[0], idx[0]
        payload = {
            "provider": np.int32(self.provider_id),
            "scores": scores,
            "chunk_ids": self._chunk_id_arr[idx],
            "chunk_tokens": self.chunk_tokens[idx],
        }
        return apply_filters(self.filters, payload)
