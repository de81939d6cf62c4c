"""Advanced federated-flow variations (paper §2.2 / §4.4-4.5).

The paper's basic setup broadcasts to all providers and generates with one
LLM, but §2.2 explicitly describes the richer flow:

  * "instead of blindly broadcasting to everyone, a selective process can
    be added to only query the most relevant data providers according to
    the global knowledge of query-provider compatibility"
    -> ProviderSelector: per-provider corpus centroids (coarse, privacy-
       preserving sketches shared at enrollment) + top-p routing.
  * "before sending the query to a data provider, the query can be
    pre-processed (rewriting, expansion, etc.) in a personalized fashion"
    -> QueryRewriter: per-provider token expansion from a provider-supplied
       synonym/expansion map (filtered, so no raw corpus leaves the site).
  * "a routing model can orchestrate the answer inference by sending the
    augmented query to the most relevant LLMs, and produce the final
    answer by aggregating the responses from them" (§4.4 "internet of
    agents") -> AnswerFusion: score-weighted answer voting across
    multiple generator endpoints.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.provider import DataProvider
from repro_torch.data.tokenizer import HashTokenizer


class ProviderSelector:
    """Query-provider compatibility routing from enrollment-time corpus
    centroids (a k-dim sketch per provider, far coarser than any chunk).

    The centroids are computed on the device of each provider's embedding
    tensor, in f32; a selection scores the query there and brings one
    float per provider back to the host."""

    def __init__(self, providers: Sequence[DataProvider], embed_fn: Callable, n_centroids: int = 4):
        self.embed_fn = embed_fn
        self.centroids: dict[int, torch.Tensor] = {}
        for p in providers:
            assert p.embeddings is not None, "build_index first"
            embs = p.embeddings.to(torch.float32)
            # k-means-lite: seed with strided picks, one refinement pass
            idx = np.linspace(0, len(embs) - 1, n_centroids).astype(int)
            cents = embs[torch.as_tensor(idx, device=embs.device)].clone()
            assign = torch.argmax(embs @ cents.T, dim=1)
            for c in range(n_centroids):
                members = embs[assign == c]
                if len(members):
                    cents[c] = members.mean(0)
            cents /= torch.clamp(torch.linalg.vector_norm(cents, dim=1, keepdim=True), min=1e-9)
            self.centroids[p.provider_id] = cents

    def select(self, query_tokens: np.ndarray, providers: Sequence[DataProvider], top_p: int) -> list[DataProvider]:
        q = self.embed_fn(query_tokens[None, :])[0]
        scored = []
        for p in providers:
            c = self.centroids[p.provider_id]
            qc = torch.as_tensor(q, device=c.device).to(torch.float32)
            scored.append((float((c @ qc).max()), p))
        scored.sort(key=lambda t: -t[0])
        return [p for _, p in scored[: max(top_p, 1)]]


class QueryRewriter:
    """Per-provider query expansion: each provider publishes a (filtered)
    token-expansion map at enrollment; the orchestrator expands the query
    with provider-specific related tokens before dispatch."""

    def __init__(self, expansion_maps: dict[int, dict[int, list[int]]], max_extra: int = 4):
        self.maps = expansion_maps
        self.max_extra = max_extra

    def rewrite(self, query_tokens: np.ndarray, provider_id: int) -> np.ndarray:
        m = self.maps.get(provider_id, {})
        extra: list[int] = []
        for t in query_tokens:
            extra.extend(m.get(int(t), []))
            if len(extra) >= self.max_extra:
                break
        if not extra:
            return query_tokens
        out = np.concatenate([query_tokens, np.asarray(extra[: self.max_extra], np.int32)])
        return out


@dataclasses.dataclass
class GeneratorEndpoint:
    name: str
    generate: Callable  # (prompt_tokens (1,S)) -> (1,T) answer tokens
    domains: tuple = ()  # corpus names this expert specializes in


class AnswerFusion:
    """Multi-LLM answer inference (paper §4.4): route the augmented query to
    the most relevant expert generators and fuse their answers by
    context-affinity-weighted voting."""

    def __init__(self, endpoints: Sequence[GeneratorEndpoint], top_m: int = 2):
        self.endpoints = list(endpoints)
        self.top_m = top_m

    def route(self, context: dict) -> list[GeneratorEndpoint]:
        """Rank endpoints by how much of the context window comes from their
        specialty corpora (provider ids double as corpus tags here)."""
        provs = [int(x) for x in context.get("providers", [])]
        scored = []
        for e in self.endpoints:
            affinity = sum(provs.count(d) for d in e.domains) if e.domains else 0.5
            scored.append((affinity, e))
        scored.sort(key=lambda t: -t[0])
        return [e for _, e in scored[: self.top_m]]

    def answer(self, prompt_tokens: np.ndarray, context: dict) -> dict:
        chosen = self.route(context)
        votes: dict[int, float] = {}
        per_model = {}
        for rank, e in enumerate(chosen):
            ans = np.asarray(e.generate(prompt_tokens))[0]
            tok = int(ans[0])
            votes[tok] = votes.get(tok, 0.0) + 1.0 / (rank + 1)
            per_model[e.name] = ans
        best = max(votes, key=votes.get)
        return {"answer_token": best, "votes": votes, "per_model": per_model,
                "models": [e.name for e in chosen]}


def build_expansion_maps(
    providers: Sequence[DataProvider], tokenizer: HashTokenizer, max_pairs: int = 64
) -> dict[int, dict[int, list[int]]]:
    """Derive per-provider co-occurrence expansions from each provider's own
    chunks (computed provider-side; only the token-id map is shared)."""
    maps: dict[int, dict[int, list[int]]] = {}
    for p in providers:
        co: dict[int, list[int]] = {}
        for row in p.chunk_tokens[: max_pairs]:
            toks = [int(t) for t in row if t > 7]
            for a, b in zip(toks, toks[1:]):
                co.setdefault(a, [])
                if b not in co[a] and len(co[a]) < 3:
                    co[a].append(b)
        maps[p.provider_id] = co
    return maps
