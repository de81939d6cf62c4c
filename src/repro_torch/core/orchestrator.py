"""Orchestrator (paper §2.3.2, Algorithm 1) — runs inside the CC enclave.

Flow per query:
  1. select k_n <= k providers (all by default; compatibility selector opt-in)
  2. broadcast the sealed query over attested channels
  3. collect local top-m responses under a deadline/quorum (straggler
     mitigation is *native* to Algorithm 1's k_n <= k semantics)
  4. aggregate inside the enclave:
       embedding_rank  merge by provider-reported scores
       rerank          cross-encoder F_aggr over all candidates (paper's
                       bge-reranker-base role), keep global top-n
  5. build the augmented prompt and run F_inf (generation LLM) in-enclave

Every step also runs batched (``answer_batch``): one sealed request per
provider carries the whole (B, S) query block, aggregation re-ranks the
(B, C, S) candidate block in one pass, and generation goes through the
generator's ``generate_batch`` hook when present — identical results to
B sequential ``answer`` calls at a fraction of the per-query overhead.

Dispatch is **transport-aware**: when providers have real round-trip
latency (``delay_s``, standing in for remote RTT) or a ``deadline_s``
SLO is set, step 2-3 fans the sealed request out to all selected
providers at once (one thread-pool future per provider), so collect
wall-clock is the *max* of provider round-trips instead of the sum,
``deadline_s`` is a true wall-clock cutoff (whatever arrived by then is
aggregated, stragglers are abandoned), and the quorum check runs against
the arrivals at the deadline.  For colocated in-process providers with
sub-millisecond round-trips the sequential loop is kept — thread handoff
would cost more than the overlap buys.  Responses are re-ordered by
provider position before aggregation, so results are bit-identical
between the two dispatchers whenever every provider responds in time;
``concurrent_collect=True/False`` forces either path (False is the
determinism baseline).

Dispatch is also **resilient** (core/resilience.py): per-provider
retry/backoff (budget deducted from the live deadline), circuit breakers
that skip flapping providers, channel self-healing on ``IntegrityError``
(one re-attest + re-establish before a round counts as failed), an
opt-in aggregator-side poisoning gate (per-provider score calibration +
outlier quarantine), and a ``federation_stats()`` health ledger.  All of
it is overlay: with retries off / breaker off / gate off and no faults
firing, collect results are bit-identical to the plain path.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.confidential import Enclave, IntegrityError, SecureChannel
from repro_torch.core.provider import DataProvider, pack, unpack
from repro_torch.core.resilience import (
    BreakerPolicy,
    CircuitBreaker,
    ProviderHealth,
    QuorumNotMet,
    RetryPolicy,
    ScoreGate,
)
from repro_torch.data.tokenizer import ANS, BOS, CTX, EOS, PAD, QRY, SEP, HashTokenizer
from repro_torch.runtime import trace

# the faults one provider may raise without failing the round: absorbed
# by quorum (Algorithm 1's k_n <= k), counted in the health ledger.  An
# IntegrityError (tampered/corrupted/replayed sealed payload) is a
# per-provider fault exactly like a dead link — it must never crash the
# whole round.
_TOLERATED_FAULTS = (ConnectionError, TimeoutError, IntegrityError)


class Orchestrator:
    def __init__(
        self,
        providers: Sequence[DataProvider],
        tokenizer: HashTokenizer,
        *,
        aggregation: str = "rerank",  # embedding_rank | rerank
        reranker: Callable | None = None,  # (query_tokens, cand_tokens (C,S)) -> (C,) scores
        generator: Callable | None = None,  # (prompt_tokens (1,S)) -> (1,T) answer tokens
        m_local: int = 8,
        n_global: int = 8,
        quorum: int = 1,
        deadline_s: float | None = None,
        selector=None,  # core.advanced.ProviderSelector (paper §2.2 routing)
        selector_top_p: int = 0,  # 0 -> broadcast to all (paper's basic setup)
        rewriter=None,  # core.advanced.QueryRewriter (per-provider expansion)
        concurrent_collect: bool | None = None,  # None -> auto (transport-aware)
        query_reserve: int = 32,  # prompt tail allowance (see build_prompt)
        retry: RetryPolicy | None = None,  # None -> single-shot (legacy path)
        breaker: BreakerPolicy | None = None,  # None -> no circuit breakers
        score_gate: ScoreGate | None = None,  # None -> raw provider scores
    ):
        self.providers = list(providers)
        self.tok = tokenizer
        self.aggregation = aggregation
        self.reranker = reranker
        self.generator = generator
        self.m_local, self.n_global = m_local, n_global
        self.quorum = quorum
        self.deadline_s = deadline_s
        self.selector = selector
        self.selector_top_p = selector_top_p
        self.rewriter = rewriter
        self.concurrent_collect = concurrent_collect
        self.query_reserve = query_reserve
        self.retry = retry
        self.breaker_policy = breaker
        self.score_gate = score_gate
        # per-provider health ledger (attempts/retries/faults/breaker/...)
        self._health: dict[int, ProviderHealth] = {
            int(p.provider_id): ProviderHealth(
                breaker=CircuitBreaker(breaker) if breaker is not None else None
            )
            for p in self.providers
        }
        self.enclave = Enclave("cfedrag-orchestrator-v1")
        self._establish_channels()

    def _establish_channels(self):
        """Mutual attestation with every provider (paper §2.3.1 mTLS): each
        side verifies the other's measurement before deriving session keys
        (directional keys agree because both are derived from the same
        static-DH secret with measurement-ordered labels)."""
        for p in self.providers:
            self._establish_channel(p)

    def _establish_channel(self, p):
        ch = SecureChannel.establish(self.enclave, p.enclave, p.enclave.measurement)
        p.channel = SecureChannel.establish(p.enclave, self.enclave, self.enclave.measurement)
        setattr(p, "_orch_channel", ch)

    def select_providers(self, query_text: str) -> list[DataProvider]:
        if self.selector is not None and self.selector_top_p:
            q_tokens = self.tok.encode(query_text, max_len=24)
            return self.selector.select(q_tokens, self.providers, self.selector_top_p)
        return self.providers  # broadcast policy (paper's basic setup)

    def query_routes(self, queries: Sequence[str]) -> list[list[DataProvider]] | None:
        """Per-query provider subsets in SELECTOR ORDER (score-descending
        — the order the sequential path collects and aggregates in, which
        the rank tie-break depends on).  ``None`` when the selector is
        off: broadcast to all."""
        if self.selector is None or not self.selector_top_p:
            return None
        return [
            self.selector.select(
                self.tok.encode(q, max_len=24), self.providers, self.selector_top_p
            )
            for q in queries
        ]

    # ------------------------------------------------------------------ #
    def _roundtrip(self, p, tokens_for) -> dict:
        """One sealed request/response exchange with provider ``p``.  The
        per-provider lock serializes overlapping rounds (an abandoned
        straggler from a previous collect must not interleave its channel
        sequence numbers with the current round)."""
        with p.rpc_lock:
            ch = getattr(p, "_orch_channel")
            nonce, sealed = ch.seal(
                pack({"query_tokens": tokens_for(p), "m": np.int64(self.m_local)})
            )
            r_nonce, r_sealed = p.handle_request(nonce, sealed)
            return unpack(ch.open(r_nonce, r_sealed))

    def _quorum_check(self, responses: list[dict]) -> list[dict]:
        if len(responses) < self.quorum:
            raise QuorumNotMet(len(responses), self.quorum)
        return responses

    def _health_for(self, p) -> ProviderHealth:
        pid = int(p.provider_id)
        h = self._health.get(pid)
        if h is None:  # provider added after construction
            h = self._health[pid] = ProviderHealth(
                breaker=CircuitBreaker(self.breaker_policy)
                if self.breaker_policy is not None
                else None
            )
        return h

    def _heal_channel(self, p, tokens_for) -> dict | None:
        """Channel self-heal: an ``IntegrityError`` (tampered payload,
        replayed nonce, sequence desync) may mean the session state is
        wedged rather than the provider hostile — re-attest and
        re-establish the provider's SecureChannel ONCE, then retry the
        exchange once, before the round counts as failed.  Re-
        establishment runs attestation from scratch, so a provider whose
        code identity changed still fails closed (AttestationError is
        not tolerated)."""
        h = self._health_for(p)
        h.rechannels += 1
        with p.rpc_lock:  # never re-key mid-roundtrip of another round
            self._establish_channel(p)
        try:
            h.attempts += 1
            return self._roundtrip(p, tokens_for)
        except _TOLERATED_FAULTS as e:
            h.record_fault(e)
            return None

    def _exchange(self, p, tokens_for, t0: float) -> dict | None:
        """One resilient provider exchange: breaker gate, bounded retries
        with exponential backoff (the backoff budget comes OUT of the
        remaining ``deadline_s``), channel self-heal on IntegrityError.
        Returns the response dict, or None when the provider failed the
        whole round (tolerated — quorum decides downstream).  With
        ``retry=None`` and ``breaker=None`` this is exactly one
        ``_roundtrip`` plus fault accounting — the legacy path."""
        h = self._health_for(p)
        br = h.breaker
        if br is not None and not br.allow():
            h.skips += 1
            return None
        attempts = self.retry.max_attempts if self.retry is not None else 1
        resp = None
        for attempt in range(attempts):
            if attempt:
                backoff = self.retry.backoff(attempt)
                if self.deadline_s is not None:
                    remaining = self.deadline_s - (time.monotonic() - t0)
                    if remaining <= backoff:
                        break  # SLO cannot afford another attempt
                h.retries += 1
                if backoff:
                    time.sleep(backoff)
            h.attempts += 1
            try:
                resp = self._roundtrip(p, tokens_for)
            except IntegrityError as e:
                h.record_fault(e)
                resp = self._heal_channel(p, tokens_for)
                if resp is not None:
                    break
            except _TOLERATED_FAULTS as e:
                h.record_fault(e)
            else:
                break
        if resp is None:
            if br is not None:
                br.record_failure()  # one failure per failed ROUND
            return None
        if br is not None:
            br.record_success()
        h.successes += 1
        return resp

    def federation_stats(self) -> dict:
        """Per-provider health ledger + federation totals: attempts,
        retries, breaker state/trips, faults by type, skip/quarantine
        counts — and, for fault-injection harness runs, the wrapper's
        injected-fault counters so a benchmark can reconcile every
        injected fault against an observed one."""
        per: dict[int, dict] = {}
        for p in self.providers:
            d = self._health_for(p).as_dict()
            injected = getattr(p, "faults", None)
            if isinstance(injected, dict):
                d["injected"] = dict(injected)
            per[int(p.provider_id)] = d
        totals = {
            k: sum(d[k] for d in per.values())
            for k in ("attempts", "successes", "retries", "skips", "rechannels",
                      "quarantined", "dropped_chunks")
        }
        totals["faults"] = {
            k: sum(d["faults"][k] for d in per.values())
            for k in ("conn", "timeout", "integrity")
        }
        totals["breakers_open"] = sum(
            1 for d in per.values() if d["breaker"] not in (None, "closed")
        )
        if self.score_gate is not None:
            totals["score_gate"] = self.score_gate.snapshot()
        return {"providers": per, "totals": totals}

    def _use_concurrent(self, providers) -> bool:
        """Transport-aware dispatch policy: fan out when overlap can pay
        (providers with real round-trip latency) or when wall-clock
        deadline semantics are requested; else the sequential loop wins
        (in-process round-trips are GIL-bound, so threads only add
        handoff cost).  ``concurrent_collect`` forces either path."""
        if len(providers) <= 1:
            return False
        if self.concurrent_collect is not None:
            return self.concurrent_collect
        return self.deadline_s is not None or any(
            getattr(p, "delay_s", 0.0) for p in providers
        )

    def _collect(self, providers, tokens_for) -> list[dict]:
        """Shared steps 2-3 dispatch: sealed round-trip per provider under
        the deadline, straggler tolerance, quorum check.
        ``tokens_for(provider)`` builds the query token payload.

        The ``deadline_s`` clock is anchored HERE, before any dispatch
        work (payload building, thread spawning), so the SLO bounds the
        whole collect step — not just the wait after setup."""
        t0 = time.monotonic()
        if self._use_concurrent(providers):
            return self._collect_concurrent(providers, tokens_for, t0)
        return self._collect_sequential(providers, tokens_for, t0)

    def _collect_sequential(self, providers, tokens_for, t0: float) -> list[dict]:
        """Sequential loop — the in-process fast path and the determinism
        baseline (``concurrent_collect=False``): latency is the SUM of
        provider round-trips and the deadline only fires between calls.
        Per-provider faults (dead link, timeout, tampered payload) are
        absorbed by ``_exchange`` and left to the quorum check."""
        responses = []
        for p in providers:
            if self.deadline_s is not None and time.monotonic() - t0 > self.deadline_s:
                break  # deadline: proceed with what we have (k_n <= k)
            resp = self._exchange(p, tokens_for, t0)
            if resp is not None:
                responses.append(resp)
        return self._quorum_check(responses)

    def _collect_concurrent(self, providers, tokens_for, t0: float) -> list[dict]:
        """Concurrent fan-out: every provider round-trip runs in its own
        future, so collect wall-clock tracks the slowest *responding*
        provider (max, not sum).  ``deadline_s`` is a hard wall-clock
        cutoff: whatever completed by then is returned (quorum permitting)
        and stragglers are abandoned mid-flight — Algorithm 1's k_n <= k
        straggler tolerance with real overlap.  Completed responses are
        re-ordered by provider position so aggregation stays bit-identical
        to the sequential path when everyone answers in time.

        Workers are daemon threads on purpose: an abandoned straggler
        (a hung provider past the deadline) must never block interpreter
        exit — the deadline SLO bounds process lifetime too."""
        results: dict[int, dict] = {}
        unexpected: list[BaseException] = []
        n_finished = [0]
        cond = threading.Condition()

        def worker(i, p):
            resp = None
            try:
                # expected faults (dead link, timeout, tampered payload)
                # are absorbed inside _exchange -> None; quorum decides
                resp = self._exchange(p, tokens_for, t0)
            except BaseException as e:  # real bugs must surface, not vanish
                with cond:
                    unexpected.append(e)
                    n_finished[0] += 1
                    cond.notify_all()
                return
            with cond:
                if resp is not None:
                    results[i] = resp
                n_finished[0] += 1
                cond.notify_all()

        for i, p in enumerate(providers):
            threading.Thread(target=worker, args=(i, p), daemon=True).start()
        # the SLO clock started at _collect entry (``t0``), so only the
        # REMAINING budget is spent waiting — spawning one thread per
        # provider must not extend the effective deadline.  The predicate
        # also wakes on an unexpected worker exception: with no deadline
        # and a hung straggler, waiting for n_finished alone would park
        # the raise below forever.
        timeout = None
        if self.deadline_s is not None:
            timeout = max(0.0, self.deadline_s - (time.monotonic() - t0))
        with cond:
            cond.wait_for(
                lambda: bool(unexpected) or n_finished[0] >= len(providers),
                timeout=timeout,
            )
            if unexpected:
                raise unexpected[0]
            responses = [results[i] for i in sorted(results)]
        return self._quorum_check(responses)

    def collect_contexts(self, query_text: str) -> list[dict]:
        """Steps 1-3: dispatch + quorum collection."""
        base_tokens = self.tok.encode(query_text, max_len=24)

        def tokens_for(p):
            if self.rewriter is not None:  # personalized expansion (§2.2)
                return self.rewriter.rewrite(base_tokens, p.provider_id)
            return base_tokens

        return self._collect(self.select_providers(query_text), tokens_for)

    def collect_contexts_batch(
        self, queries: Sequence[str], *, routes: list[list[DataProvider]] | None = None
    ) -> list[dict]:
        """Steps 1-3 for a query batch: ONE sealed request per provider
        carries all (B, S) query tokens; each response holds (B, m)
        scores/ids and (B, m, S_c) chunk tokens.  Sealing/serialization
        round-trips drop from B*P to P and every provider embeds the whole
        batch in one kernel call.

        Selector routing (``selector_top_p > 0``) rides the same fan-out
        ragged: only providers selected by at least one query receive a
        request, and within a selected provider's (B, S) block the rows of
        queries that did NOT route to it are masked to all-PAD (the
        embedder masks PAD, and the response rows of masked queries are
        discarded at aggregation).  ``routes`` lets a caller that already
        computed ``query_routes`` pass them in instead of re-embedding."""
        queries = list(queries)
        with trace.span("fed.collect", queries=len(queries)):
            base = [self.tok.encode(q, max_len=24) for q in queries]
            if routes is None:
                routes = self.query_routes(queries)
            if routes is None:
                fan, mine_of = self.providers, None
            else:
                mine_of = {}  # provider id -> query rows routed to it
                for b, sub in enumerate(routes):
                    for p in sub:
                        mine_of.setdefault(int(p.provider_id), set()).add(b)
                fan = [p for p in self.providers if int(p.provider_id) in mine_of]

            def tokens_for(p):
                rows = base
                if self.rewriter is not None:  # personalized expansion (§2.2)
                    rows = [self.rewriter.rewrite(r, p.provider_id) for r in base]
                width = max(len(r) for r in rows)
                if mine_of is not None:
                    mine = mine_of[int(p.provider_id)]
                    rows = [
                        r if b in mine else np.full((width,), PAD, np.int32)
                        for b, r in enumerate(rows)
                    ]
                return np.stack(
                    [np.pad(r, (0, width - len(r))) for r in rows]
                ).astype(np.int32)  # PAD tail; the embedder masks PAD

            return self._collect(fan, tokens_for)

    def _gate_responses(self, responses: list[dict]) -> tuple[list[dict], dict | None]:
        """Aggregator-side poisoning gate (opt-in, ``score_gate``): each
        provider's round is z-checked against that provider's OWN running
        score distribution — anomalous rounds are quarantined (their
        chunks never reach ranking), surviving scores are calibrated to
        per-provider z-scores so incompatible embedding spaces become
        comparable.  Returns (kept responses, provenance meta).  If the
        gate would quarantine EVERY provider the raw rounds are kept
        instead: the defense assumes an honest majority, and dropping
        the whole federation on a global distribution shift would turn
        the gate itself into a denial of service."""
        if self.score_gate is None or not responses:
            return responses, None
        kept, quarantined = [], []
        for r in responses:
            pid = int(r["provider"])
            keep, calibrated = self.score_gate.admit(pid, r["scores"])
            if keep:
                r = dict(r)
                r["scores"] = calibrated
                kept.append(r)
            else:
                quarantined.append((pid, int(np.asarray(r["chunk_ids"]).size)))
        if not kept:
            return responses, {"quarantined": [], "calibrated": False}
        for pid, n_chunks in quarantined:
            h = self._health.get(pid)
            if h is not None:
                h.quarantined += 1
                h.dropped_chunks += n_chunks
        return kept, {
            "quarantined": [pid for pid, _ in quarantined],
            "calibrated": True,
        }

    def aggregate(self, query_text: str, responses: list[dict]) -> dict:
        """Step 4: in-enclave context aggregation (global re-rank).  With
        a ``score_gate``, poisoned/outlier provider rounds are quarantined
        first and surviving scores calibrated; the context dict carries
        the provenance (``providers`` per chunk + ``gated`` round meta)."""
        responses, gated = self._gate_responses(responses)
        all_tokens = np.concatenate([r["chunk_tokens"] for r in responses], 0)
        all_ids = np.concatenate([r["chunk_ids"] for r in responses], 0)
        all_scores = np.concatenate([r["scores"] for r in responses], 0)
        providers = np.concatenate(
            [np.full(len(r["chunk_ids"]), int(r["provider"])) for r in responses]
        )
        if self.aggregation == "rerank" and self.reranker is not None:
            q_tokens = self.tok.encode(query_text, max_len=24)
            rank_scores = np.asarray(self.reranker(q_tokens, all_tokens))
        else:
            rank_scores = all_scores
        n = min(self.n_global, len(all_ids))
        order = np.argsort(-rank_scores)[:n]
        out = {
            "chunk_tokens": all_tokens[order],
            "chunk_ids": all_ids[order],
            "scores": rank_scores[order],
            "providers": providers[order],
            "n_candidates": len(all_ids),
        }
        if gated is not None:
            out["gated"] = gated
        return out

    def aggregate_batch(self, queries: Sequence[str], responses: list[dict]) -> list[dict]:
        """Step 4 over a batch: one re-rank pass over the (B, C, S)
        candidate block when the reranker supports batching, else per-row.
        Produces per-query context dicts identical to ``aggregate``."""
        with trace.span("fed.rerank", queries=len(queries)):
            responses, gated = self._gate_responses(responses)
            all_tokens = np.concatenate([r["chunk_tokens"] for r in responses], 1)  # (B, C, S)
            all_ids = np.concatenate([r["chunk_ids"] for r in responses], 1)  # (B, C)
            all_scores = np.concatenate([r["scores"] for r in responses], 1)
            providers = np.concatenate(
                [
                    np.full(r["chunk_ids"].shape, int(r["provider"]))
                    for r in responses
                ],
                1,
            )
            if self.aggregation == "rerank" and self.reranker is not None:
                q_tok = np.stack([self.tok.encode(q, max_len=24) for q in queries])
                if getattr(self.reranker, "supports_batch", False):
                    rank_scores = np.asarray(self.reranker(q_tok, all_tokens))
                else:
                    rank_scores = np.stack(
                        [np.asarray(self.reranker(q_tok[b], all_tokens[b])) for b in range(len(queries))]
                    )
            else:
                rank_scores = all_scores
            n = min(self.n_global, all_ids.shape[1])
            outs = []
            for b in range(len(queries)):
                order = np.argsort(-rank_scores[b])[:n]
                ctx = {
                    "chunk_tokens": all_tokens[b][order],
                    "chunk_ids": all_ids[b][order],
                    "scores": rank_scores[b][order],
                    "providers": providers[b][order],
                    "n_candidates": all_ids.shape[1],
                }
                if gated is not None:
                    ctx["gated"] = gated
                outs.append(ctx)
            return outs

    def build_prompt(self, query_text: str, context: dict, max_len: int = 512) -> np.ndarray:
        """[BOS] CTX chunk1 SEP chunk2 ... QRY query ANS — a STABLE
        shared-prefix layout.

        The context preamble comes first and is a pure function of the
        context and ``max_len``: the chunk budget reserves a FIXED query
        allowance (``query_reserve``, not the query's own length), so two
        queries served against the same aggregated context produce
        byte-identical prompts up to and including the ``QRY`` marker —
        exactly the prefix the paged engine's refcounted prefix cache
        shares block-for-block across micro-batch siblings and retries
        (``ServeConfig.prefix_cache``).  Truncation cuts from the TAIL:
        overflow drops whole lowest-ranked chunks first, and only the
        query itself is tail-truncated into whatever space remains (at
        least the reserve, so structural markers always survive).

        Overflow never breaks the grammar: dropping whole chunks keeps
        the ``BOS/CTX/QRY/query/ANS`` skeleton intact, where a blind
        ``ids[-max_len:]`` would slice off ``BOS``/``CTX`` and could
        bisect a chunk."""
        with trace.span("fed.prompt"):
            query = [int(t) for t in self.tok.encode(query_text, bos=False) if t not in (PAD, EOS)]
            n_markers = 4  # BOS, CTX, QRY, ANS
            # fixed reserve: chunk inclusion must not depend on the query, or
            # same-context siblings diverge before QRY and never share blocks
            reserve = min(self.query_reserve, max(0, (max_len - n_markers) // 2))
            chunk_budget = max_len - n_markers - reserve
            ids = [BOS, CTX]
            for row in context["chunk_tokens"]:
                chunk = [int(t) for t in row if t not in (PAD, BOS, EOS)]
                if len(chunk) + 1 > chunk_budget:  # +1: trailing SEP
                    break  # ranked order: everything after is lower-scored
                ids += chunk
                ids.append(SEP)
                chunk_budget -= len(chunk) + 1
            ids.append(QRY)
            ids += query[: max(0, max_len - len(ids) - 1)]  # tail cut, ANS always fits
            ids.append(ANS)
            return np.asarray(ids, np.int32)[None, :]

    def _prompt_max_len(self) -> int:
        """Generator-advertised prompt window (``max_prompt_len`` on an
        engine adapter), so grammar-aware truncation in ``build_prompt``
        happens at the width the generator will actually consume."""
        return int(getattr(self.generator, "max_prompt_len", None) or 512)

    def answer(self, query_text: str) -> dict:
        responses = self.collect_contexts(query_text)
        context = self.aggregate(query_text, responses)
        out = {
            "context": context,
            "n_providers": len(responses),
        }
        if self.generator is not None:
            prompt = self.build_prompt(query_text, context, max_len=self._prompt_max_len())
            out["answer_tokens"] = np.asarray(self.generator(prompt))[0]
            out["prompt"] = prompt
        return out

    @staticmethod
    def _response_row(r: dict, b: int) -> dict:
        """Row ``b`` of a provider's batched response, shaped exactly like
        the sequential per-query response (m,) / (m, S_c)."""
        return {
            "provider": r["provider"],
            "scores": np.asarray(r["scores"])[b],
            "chunk_ids": np.asarray(r["chunk_ids"])[b],
            "chunk_tokens": np.asarray(r["chunk_tokens"])[b],
        }

    def _aggregate_routed(
        self, queries: Sequence[str], responses: list[dict], routes
    ) -> list[dict]:
        """Step 4 under selector routing: per query, slice out the rows of
        ITS providers in selector order (the order the sequential path
        concatenates in — rank tie-breaks depend on it), quorum-check the
        routed subset, and aggregate exactly like ``aggregate`` does.
        Returns (per-query contexts, per-query responding-provider
        counts)."""
        by_pid = {int(r["provider"]): r for r in responses}
        outs, n_prov = [], []
        for b, q in enumerate(queries):
            rs = [
                self._response_row(by_pid[int(p.provider_id)], b)
                for p in routes[b]
                if int(p.provider_id) in by_pid
            ]
            self._quorum_check(rs)
            outs.append(self.aggregate(q, rs))
            n_prov.append(len(rs))
        return outs, n_prov

    def answer_batch(self, queries: Sequence[str]) -> list[dict]:
        """Algorithm 1 over a query batch: one sealed round-trip per
        provider for the whole batch (selector-routed setups fan out
        ragged — only selected providers, non-selected query rows PAD-
        masked), batched aggregation, and (when the generator exposes
        ``generate_batch``) batched decoding.  Returns per-query result
        dicts identical to ``answer``."""
        queries = list(queries)
        if not queries:
            return []
        routes = self.query_routes(queries)
        responses = self.collect_contexts_batch(queries, routes=routes)
        if routes is None:
            contexts = self.aggregate_batch(queries, responses)
            n_prov = [len(responses)] * len(queries)
        else:
            contexts, n_prov = self._aggregate_routed(queries, responses, routes)
        outs = [
            {"context": ctx, "n_providers": n}
            for ctx, n in zip(contexts, n_prov)
        ]
        if self.generator is not None:
            width = self._prompt_max_len()
            prompts = [self.build_prompt(q, ctx, max_len=width) for q, ctx in zip(queries, contexts)]
            gen_batch = getattr(self.generator, "generate_batch", None)
            if gen_batch is not None:
                answers = gen_batch(prompts)
            else:
                answers = [np.asarray(self.generator(p))[0] for p in prompts]
            for out, prompt, ans in zip(outs, prompts, answers):
                out["answer_tokens"] = np.asarray(ans).ravel()
                out["prompt"] = prompt
        return outs
