"""CFedRAGSystem: end-to-end wiring of Algorithm 1.

Builds providers from a FederatedCorpus (paper topology: 2 sites x 2
corpora), an in-enclave orchestrator with the chosen aggregation model,
and model-backed reranker/generator callables.  Provider embeddings and
retrieval run on ``CFedRAGConfig.device``; generation runs wherever the
generator's engine was built.  ``single_silo_system`` and
``centralized_system`` build the paper's Table-1 baselines
(``launch/table1.py``).
"""
from __future__ import annotations

import dataclasses
import threading
import time
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
from repro_torch.serving.scheduler import Scheduler, _broadcast


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
    """One per-query result dict, the one definition that ``serve`` and
    ``serve_stream`` share."""
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
        (submit -> finish).  Without an engine-backed generator, or with a
        lock-step one, this is ``answer_batch``."""
        queries = list(query_texts)
        if not queries:
            return []
        orch = self.orchestrator
        engine = getattr(orch.generator, "engine", None)
        continuous = getattr(orch.generator, "mode", "continuous") == "continuous"
        if orch.generator is None or engine is None or not continuous:
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

    def serve_stream(
        self,
        query_texts: list[str],
        *,
        max_new_tokens: int | list[int] | None = None,
        gen_deadline_s: float | list[float | None] | None = None,
        collect_batch: int = 8,
        tenants: str | list[str] | None = None,
        priorities: int | list[int] | None = None,
        tenant_weights: dict[str, float] | None = None,
        fifo: bool = False,
    ):
        """Pipelined front door: a collector thread runs collect and
        aggregation for micro-batch N+1 while the engine decodes micro-batch
        N, submitting prompts into the live scheduler as they are ready.
        Yields ``(query_index, result_dict)`` as each generation retires
        (retire order).  Scheduler backpressure keeps the collector at most
        one micro-batch ahead, and yielded requests drop their prompt and
        answer buffers, so resident payloads stay O(collect_batch).

        Each result equals ``serve``'s on the same inputs except
        ``latency_s``, which here runs from its micro-batch's collect start
        to its finish.  Every query yields exactly once: expired requests
        and the queries of a micro-batch whose collect missed quorum
        (flagged ``degraded``) come after the retired ones.  A collector
        error is raised to the consumer; an abandoned generator stops and
        joins the collector.  Without an engine-backed continuous
        generator this yields ``serve``'s results in order.

        On one card both threads queue work on the default stream, so the
        collector's retrieval runs between the engine's steps: the
        pipelining overlaps host work only."""
        queries = list(query_texts)
        if not queries:
            return
        orch = self.orchestrator
        engine = getattr(orch.generator, "engine", None)
        continuous = getattr(orch.generator, "mode", "continuous") == "continuous"
        if orch.generator is None or engine is None or not continuous:
            yield from enumerate(self.serve(
                queries, max_new_tokens=max_new_tokens, gen_deadline_s=gen_deadline_s,
                tenants=tenants, priorities=priorities, tenant_weights=tenant_weights, fifo=fifo,
            ))
            return
        n = len(queries)
        budgets = _broadcast(max_new_tokens, n, "max_new_tokens")
        deadlines = _broadcast(gen_deadline_s, n, "gen_deadline_s")
        tenant_l = _broadcast(tenants if tenants is not None else "default", n, "tenants")
        prio_l = _broadcast(priorities if priorities is not None else 0, n, "priorities")
        collect_batch = max(1, int(collect_batch))
        width = engine.scfg.max_prompt_len
        sched = Scheduler(tenant_weights=tenant_weights, fifo=fifo)
        info: dict[int, tuple] = {}  # qidx -> (prompt, context, n_providers)
        degraded: dict[int, dict] = {}  # qidx -> quorum-degraded result
        collect_err: list[BaseException] = []
        stop = threading.Event()  # the consumer has gone

        def collector():
            try:
                for start in range(0, n, collect_batch):
                    # backpressure: collect micro-batch N+1 only while at
                    # most one micro-batch of work is not yet terminal; the
                    # timeout only lets an abandoned stream (stop set, no
                    # retire left to wake the wait) exit promptly
                    while not stop.is_set() and not sched.wait_backlog_below(2 * collect_batch, timeout=0.5):
                        pass
                    if stop.is_set():
                        return
                    chunk = queries[start : start + collect_batch]
                    t0 = time.monotonic()
                    try:
                        responses = orch.collect_contexts_batch(chunk)
                    except QuorumNotMet as e:
                        # this micro-batch degrades; the stream goes on
                        for j in range(len(chunk)):
                            degraded[start + j] = _degraded_result(e)
                        continue
                    contexts = orch.aggregate_batch(chunk, responses)
                    prompts = [orch.build_prompt(q, c, max_len=width) for q, c in zip(chunk, contexts)]
                    idxs = list(range(start, start + len(chunk)))
                    # publish before submitting: the engine may retire a
                    # request the moment it is queued
                    for j, qidx in enumerate(idxs):
                        info[qidx] = (prompts[j], contexts[j], len(responses))
                    sched.submit_many(
                        prompts, [budgets[i] for i in idxs], [deadlines[i] for i in idxs],
                        tags=idxs, t0=t0, tenants=[tenant_l[i] for i in idxs],
                        priorities=[prio_l[i] for i in idxs],
                    )
            except BaseException as e:  # raised to the consumer below
                collect_err.append(e)
            finally:
                sched.close()  # the engine drains and exits

        producer = threading.Thread(target=collector, daemon=True)
        producer.start()
        try:
            for rid, ans in engine.serve_stream(sched):
                req = sched.results[rid]
                prompt, context, n_providers = info.pop(req.tag)
                req.tokens = req.answer = None  # keep the timestamps, drop the payloads
                yield req.tag, _serve_result(req, prompt, context, n_providers, ans)
            # expired requests never reach the engine: report them too
            for req in list(sched.results.values()):
                if req.status != "expired":
                    continue
                prompt, context, n_providers = info.pop(req.tag)
                req.tokens = None
                yield req.tag, _serve_result(req, prompt, context, n_providers)
            # nor do the queries of a quorum-degraded micro-batch
            for qidx in sorted(degraded):
                yield qidx, degraded[qidx]
        finally:
            # an abandoned stream must not leave the collector blocked on
            # backpressure: signal it down, then wait for it
            stop.set()
            producer.join()
            self.last_serve_stats = sched.latency_stats()
            self.last_serve_stats["federation"] = orch.federation_stats()
        if collect_err:
            raise collect_err[0]

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


def single_silo_system(corpus: FederatedCorpus, corpus_name: str, cfg: CFedRAGConfig | None = None, **kw):
    """Vanilla-RAG baseline on one corpus only (Table 1 MedRag(X) rows)."""
    sub = FederatedCorpus(chunks=corpus.corpus_chunks(corpus_name), queries=corpus.queries)
    c = dataclasses.replace(cfg or CFedRAGConfig(), split_by="corpus", aggregation="embedding_rank")
    return CFedRAGSystem(sub, c, **kw)


def centralized_system(corpus: FederatedCorpus, cfg: CFedRAGConfig | None = None, **kw):
    """Centralized MedRag(MedCorp) baseline: every chunk is remapped to
    one site, so the site split yields one provider holding all corpora."""
    c = dataclasses.replace(cfg or CFedRAGConfig(), split_by="site")
    merged = FederatedCorpus(
        chunks=[dataclasses.replace(ch, site=0) for ch in corpus.chunks],
        queries=corpus.queries,
    )
    return CFedRAGSystem(merged, c, **kw)
