"""CFedRAGSystem: end-to-end wiring of Algorithm 1.

Builds providers from a FederatedCorpus (paper topology: 2 sites x 2
corpora), an in-enclave orchestrator with the chosen aggregation model,
and model-backed reranker/generator callables.  Provider embeddings and
retrieval run on ``CFedRAGConfig.device``; generation runs wherever the
generator's engine was built.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.filters import MaxChunksFilter, ProvenanceStripFilter
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.provider import DataProvider
from repro_torch.core.resilience import (
    BreakerPolicy,
    FaultSpec,
    FaultyProvider,
    QuorumNotMet,
    RetryPolicy,
    ScoreGate,
)
from repro_torch.data.corpus import FederatedCorpus
from repro_torch.data.embeddings import bag_embed
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.serving.scheduler import Scheduler


@dataclasses.dataclass
class CFedRAGConfig:
    m_local: int = 8  # paper §3.2: top-8 per site
    n_global: int = 8  # paper §3.3: final context window of 8
    aggregation: str = "rerank"
    split_by: str = "site"  # site (paper: 2 providers) | corpus (4 providers)
    embed_dim: int = 256
    chunk_max_len: int = 40
    quorum: int = 1
    deadline_s: float | None = None  # wall-clock collect cutoff (Alg. 1 k_n <= k)
    concurrent_collect: bool | None = None  # None -> auto (transport-aware)
    # federation resilience (core/resilience.py); defaults keep the
    # single-shot path
    retries: int = 1  # collect attempts per provider per round (1 = off)
    retry_backoff_s: float = 0.02  # base of the exponential backoff
    breaker: bool = False  # per-provider circuit breakers
    breaker_threshold: int = 2  # consecutive failed rounds to open
    breaker_cooldown_s: float = 1.0  # open -> half-open probe delay
    score_gate: bool = False  # aggregator-side poisoning gate
    device: str = "cuda"  # where provider embeddings and retrieval run


def _serve_result(req, prompt, context, n_providers: int, answer=None) -> dict:
    """One per-query result dict."""
    out = {
        "context": context,
        "n_providers": n_providers,
        "prompt": prompt,
        "status": req.status,
        "latency_s": req.latency_s,
    }
    if req.status == "done":
        out["answer_tokens"] = answer
        if req.truncated:  # cut short by KV-pool OOM, not EOS/budget
            out["truncated"] = True
    return out


def _degraded_result(err: QuorumNotMet) -> dict:
    """Per-query result for a batch whose collect missed quorum: flagged
    degraded, never silent, never fatal to the other queries."""
    return {
        "context": None,
        "n_providers": err.arrived,
        "prompt": None,
        "status": "degraded",
        "degraded": True,
        "error": str(err),
        "latency_s": None,
    }


class CFedRAGSystem:
    def __init__(
        self,
        corpus: FederatedCorpus,
        cfg: CFedRAGConfig | None = None,
        tokenizer: HashTokenizer | None = None,
        embed_fn: Callable | None = None,
        reranker: Callable | None = None,
        generator: Callable | None = None,
        fault_spec: FaultSpec | None = None,
    ):
        self.cfg = cfg or CFedRAGConfig()
        self.corpus = corpus
        self.tok = tokenizer or HashTokenizer()
        self.embed_fn = embed_fn or (
            lambda toks: bag_embed(toks, dim=self.cfg.embed_dim, device=self.cfg.device)
        )
        groups: dict[object, list] = {}
        for c in corpus.chunks:
            key = c.site if self.cfg.split_by == "site" else c.corpus
            groups.setdefault(key, []).append(c)
        self.providers = [
            DataProvider(
                provider_id=i,
                chunks=chunks,
                embed_fn=self.embed_fn,
                tokenizer=self.tok,
                chunk_max_len=self.cfg.chunk_max_len,
                filters=[MaxChunksFilter(self.cfg.m_local), ProvenanceStripFilter()],
                device=self.cfg.device,
            )
            for i, (_, chunks) in enumerate(sorted(groups.items(), key=lambda kv: str(kv[0])))
        ]
        for p in self.providers:
            p.build_index()
        if fault_spec is not None:
            self.providers = [FaultyProvider(p, fault_spec) for p in self.providers]
        self.orchestrator = Orchestrator(
            self.providers,
            self.tok,
            aggregation=self.cfg.aggregation,
            reranker=reranker,
            generator=generator,
            m_local=self.cfg.m_local,
            n_global=self.cfg.n_global,
            quorum=self.cfg.quorum,
            deadline_s=self.cfg.deadline_s,
            concurrent_collect=self.cfg.concurrent_collect,
            retry=RetryPolicy(
                max_attempts=self.cfg.retries, backoff_s=self.cfg.retry_backoff_s
            )
            if self.cfg.retries > 1
            else None,
            breaker=BreakerPolicy(
                fail_threshold=self.cfg.breaker_threshold,
                cooldown_s=self.cfg.breaker_cooldown_s,
            )
            if self.cfg.breaker
            else None,
            score_gate=ScoreGate() if self.cfg.score_gate else None,
        )

    # ---- serving entry points ----
    def answer_batch(self, query_texts: list[str]) -> list[dict]:
        """Batched Algorithm 1: one sealed request per provider per batch."""
        return self.orchestrator.answer_batch(query_texts)

    def serve(
        self,
        query_texts: list[str],
        *,
        max_new_tokens: int | list[int] | None = None,
        gen_deadline_s: float | list[float | None] | None = None,
        tenants: str | list[str] | None = None,
        priorities: int | list[int] | None = None,
        tenant_weights: dict[str, float] | None = None,
        fifo: bool = False,
    ) -> list[dict]:
        """Scheduler-driven Algorithm 1: provider fan-out for collect, one
        batched aggregation pass, then generation through the engine's
        continuous-batching slot pool (when the generator is an
        ``engine_generator``).  Each result carries its ``latency_s``
        (submit -> finish).  Without an engine-backed generator this is
        ``answer_batch``."""
        queries = list(query_texts)
        if not queries:
            return []
        orch = self.orchestrator
        engine = getattr(orch.generator, "engine", None)
        if orch.generator is None or engine is None:
            try:
                return self.answer_batch(queries)
            except QuorumNotMet as e:
                self.last_serve_stats = {"federation": orch.federation_stats()}
                return [_degraded_result(e) for _ in queries]
        try:
            responses = orch.collect_contexts_batch(queries)
        except QuorumNotMet as e:
            self.last_serve_stats = {"federation": orch.federation_stats()}
            return [_degraded_result(e) for _ in queries]
        contexts = orch.aggregate_batch(queries, responses)
        # prompts are built at the engine's window, so grammar-aware
        # truncation happens here and never in the engine's tail-slice
        width = engine.scfg.max_prompt_len
        prompts = [orch.build_prompt(q, c, max_len=width) for q, c in zip(queries, contexts)]
        sched = Scheduler(tenant_weights=tenant_weights, fifo=fifo)
        rids = sched.submit_many(
            prompts, max_new_tokens, gen_deadline_s,
            tenants=tenants, priorities=priorities,
        )
        answers = engine.serve(sched)
        self.last_serve_stats = sched.latency_stats()
        self.last_serve_stats["federation"] = orch.federation_stats()
        return [
            _serve_result(sched.results[rid], prompt, ctx, len(responses), answers.get(rid))
            for rid, prompt, ctx in zip(rids, prompts, contexts)
        ]

    # ---- evaluation (Table 1 protocol on synthetic provenance) ----
    def eval_retrieval(self, n_queries: int | None = None, batch_size: int = 32) -> dict:
        """recall@n of the gold chunk in the final context window."""
        queries = self.corpus.queries[:n_queries] if n_queries else self.corpus.queries
        hits = 0
        per_corpus: dict = {}
        mrr = 0.0
        for i in range(0, len(queries), batch_size):
            chunk = queries[i : i + batch_size]
            results = self.orchestrator.answer_batch([q.text for q in chunk])
            for q, res in zip(chunk, results):
                ids = list(res["context"]["chunk_ids"])
                hit = q.gold_chunk_id in ids
                hits += hit
                if hit:
                    mrr += 1.0 / (ids.index(q.gold_chunk_id) + 1)
                stats = per_corpus.setdefault(q.corpus, [0, 0])
                stats[0] += hit
                stats[1] += 1
        n = len(queries)
        return {
            "recall_at_n": hits / n,
            "mrr": mrr / n,
            "n_queries": n,
            "per_corpus": {c: h / t for c, (h, t) in per_corpus.items()},
        }
