"""C-FedRAG serving launcher: build the federated corpus, stand up the
providers + enclave orchestrator, and answer queries.

  python -m repro_torch.launch.serve --queries 5 --aggregation rerank
  python -m repro_torch.launch.serve --queries 16 --generate --paged --device cuda
  python -m repro_torch.launch.serve --queries 16 --generate --paged --token-budget 32

Uses the bag embedder + lexical-overlap reranker (training-free).
``--generate`` stands up a random-init, smoke-width LM ``ServeEngine``
(paged, the only engine layout ported so far) and routes the whole query
set through ``CFedRAGSystem.serve``, printing per-request p50/p95.
Everything runs on ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.pipeline import CFedRAGConfig, CFedRAGSystem
from repro_torch.data.corpus import make_federated_corpus
from repro_torch.data.tokenizer import HashTokenizer


def overlap_reranker(tok: HashTokenizer):
    """Lexical-overlap cross-scorer (training-free F_aggr stand-in).

    Accepts (query (S,), candidates (C, S)) -> (C,) scores, or a whole
    batch (queries (B, S), candidates (B, C, S)) -> (B, C)."""

    def _score_row(q: set, row: np.ndarray) -> float:
        c = set(int(t) for t in row if t > 7)
        return len(q & c) / (len(q) ** 0.5 * max(len(c), 1) ** 0.5)

    def rerank(query_tokens: np.ndarray, cand_tokens: np.ndarray) -> np.ndarray:
        cand_tokens = np.asarray(cand_tokens)
        if cand_tokens.ndim == 3:  # (B, C, S) batch
            return np.stack(
                [rerank(qt, ct) for qt, ct in zip(np.asarray(query_tokens), cand_tokens)]
            )
        q = set(int(t) for t in query_tokens if t > 7)
        return np.asarray([_score_row(q, row) for row in cand_tokens], np.float32)

    rerank.supports_batch = True
    return rerank


def make_demo_engine(max_new_tokens: int = 16, block_size: int = 32, pool_blocks: int | None = None,
                     max_batch: int = 4, token_budget: int | None = None,
                     vocab_size: int = 8192, device: str = "cuda", seed: int = 0):
    """Random-init smoke-width qwen3-0.6b ``ServeEngine`` + generator
    adapter.  The model's vocabulary is ``vocab_size``, which must cover
    the tokenizer the prompts come from (an id outside it raises)."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import lm as LM
    from repro_torch.models.params import ParamTree, init_params
    from repro_torch.serving.engine import ServeConfig, ServeEngine, engine_generator

    cfg = smoke_config(get_config("qwen3-0.6b")).with_overrides(
        dtype="float32", vocab_size=vocab_size
    )
    gen = torch.Generator(device=device).manual_seed(seed)
    params = ParamTree(init_params(LM.param_specs(cfg), gen, device=device))
    engine = ServeEngine(
        cfg, params,
        ServeConfig(
            max_batch=max_batch, max_prompt_len=256, max_new_tokens=max_new_tokens,
            paged=True, block_size=block_size, n_pool_blocks=pool_blocks,
            token_budget=token_budget,
        ),
        device=device,
    )
    return engine_generator(engine)


def full_width_system(n_queries: int = 16, device: str = "cuda", seed: int = 0,
                      generate: bool = True):
    """The one configuration measured on the card, built here for both
    ``chip_smoke.py`` and ``launch/profile_serve.py``: qwen3-0.6b at full
    width (28 layers, bf16 activations and KV pool, random weights from
    ``seed``) behind ``ServeConfig(paged=True, max_batch=8,
    max_prompt_len=256, max_new_tokens=16)``, over a 128-fact +
    128-distractor federated corpus with the overlap reranker.

    Returns ``(system, engine, texts)``, ``texts`` being the corpus's
    first ``n_queries`` questions.  ``generate=False`` builds the same
    federation with no model (``engine`` is None), for retrieval alone."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm as LM
    from repro_torch.models.params import ParamTree, init_params
    from repro_torch.serving.engine import ServeConfig, ServeEngine, engine_generator

    tok = HashTokenizer()
    corpus = make_federated_corpus(n_facts=128, n_distractors=128, n_queries=n_queries, seed=seed)
    engine = None
    if generate:
        cfg = get_config("qwen3-0.6b")
        if tok.vocab_size > cfg.vocab_size:
            raise ValueError("tokenizer vocabulary exceeds the model's")
        gen = torch.Generator(device=device).manual_seed(seed)
        params = ParamTree(init_params(LM.param_specs(cfg), gen, device=device))
        scfg = ServeConfig(paged=True, max_batch=8, max_prompt_len=256, max_new_tokens=16)
        engine = ServeEngine(cfg, params, scfg, device=device)
    system = CFedRAGSystem(
        corpus, CFedRAGConfig(device=device), tokenizer=tok, reranker=overlap_reranker(tok),
        generator=engine_generator(engine) if engine is not None else None,
    )
    return system, engine, [q.text for q in corpus.queries[:n_queries]]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", type=int, default=5)
    ap.add_argument("--aggregation", default="rerank", choices=["embedding_rank", "rerank"])
    ap.add_argument("--n-facts", type=int, default=128)
    ap.add_argument("--m-local", type=int, default=8)
    ap.add_argument("--n-global", type=int, default=8)
    ap.add_argument("--kill-provider", type=int, default=None)
    ap.add_argument("--deadline-s", type=float, default=None, help="collect wall-clock cutoff")
    ap.add_argument(
        "--sequential-collect", action="store_true",
        help="disable concurrent provider fan-out (determinism baseline)",
    )
    ap.add_argument(
        "--generate", action="store_true",
        help="decode answers through the continuous-batching ServeEngine",
    )
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument(
        "--paged", action="store_true",
        help="paged KV cache (block pool); the only engine layout the port runs, "
        "so --generate implies it",
    )
    ap.add_argument("--block-size", type=int, default=32, help="tokens per KV block")
    ap.add_argument(
        "--pool-blocks", type=int, default=None,
        help="KV pool size in blocks; default = max-batch full-length requests",
    )
    ap.add_argument("--max-batch", type=int, default=4, help="engine decode slots")
    ap.add_argument(
        "--token-budget", type=int, default=None, metavar="N",
        help="query lanes per unified mixed step (prompt chunks + decode rows); "
        "implies --paged --generate",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.token_budget is not None:
        args.generate = True

    corpus = make_federated_corpus(n_facts=args.n_facts, n_distractors=args.n_facts, n_queries=args.queries)
    tok = HashTokenizer()
    sys_ = CFedRAGSystem(
        corpus,
        CFedRAGConfig(
            aggregation=args.aggregation,
            m_local=args.m_local,
            n_global=args.n_global,
            deadline_s=args.deadline_s,
            concurrent_collect=False if args.sequential_collect else None,
            device=args.device,
        ),
        tokenizer=tok,
        reranker=overlap_reranker(tok) if args.aggregation == "rerank" else None,
        generator=make_demo_engine(
            args.max_new_tokens, block_size=args.block_size,
            pool_blocks=args.pool_blocks, max_batch=args.max_batch,
            token_budget=args.token_budget, vocab_size=tok.vocab_size, device=args.device,
        ) if args.generate else None,
    )
    if args.kill_provider is not None:
        sys_.providers[args.kill_provider].fail = True
        print(f"!! provider {args.kill_provider} marked down (quorum keeps serving)")

    texts = [q.text for q in corpus.queries[: args.queries]]
    qmeta = list(corpus.queries[: args.queries])
    if args.generate:
        # warm-up: the first request builds the kernels and allocates the
        # pool, so the printed p50/p95 reflect serving, not set-up
        sys_.orchestrator.generator.engine.serve_prompts(
            [np.full((4,), 9, np.int32)], max_new_tokens=2
        )
    if args.deadline_s is not None:
        # readiness warm-up: a deadline SLO applies to serving, not to the
        # first collect's set-up
        orch = sys_.orchestrator
        orch.deadline_s = None
        orch.collect_contexts_batch(texts)
        orch.deadline_s = args.deadline_s
    if args.generate:
        results = sys_.serve(texts, max_new_tokens=args.max_new_tokens)
    else:
        results = [sys_.orchestrator.answer(t) for t in texts]
    for q, res in zip(qmeta, results):
        if res.get("degraded"):
            print(f"Q: {q.text!r:45s} DEGRADED ({res['error']})")
            continue
        ids = list(res["context"]["chunk_ids"])
        hit = q.gold_chunk_id in ids
        extra = ""
        if "answer_tokens" in res:
            extra = f" answer_toks={len(res['answer_tokens'])} lat={res['latency_s'] * 1e3:.1f}ms"
        print(
            f"Q: {q.text!r:45s} gold_chunk={q.gold_chunk_id:4d} "
            f"hit@{args.n_global}={'Y' if hit else 'n'} "
            f"providers={res['n_providers']} candidates={res['context']['n_candidates']}"
            + extra
        )
    if args.generate:
        lats = sorted(r["latency_s"] for r in results if r.get("latency_s") is not None)
        if lats:
            p50 = lats[len(lats) // 2]
            p95 = lats[min(len(lats) - 1, int(len(lats) * 0.95))]
            print(f"\ngeneration latency on {args.device}: p50={p50 * 1e3:.1f}ms p95={p95 * 1e3:.1f}ms")
        st = getattr(sys_, "last_serve_stats", {})
        if "min_free_slots" in st:
            slots = sys_.orchestrator.generator.engine.scfg.max_batch
            line = (
                f"memory headroom: peak {slots - st['min_free_slots']}/{slots} slots "
                f"(backlog peak {st['peak_backlog']})"
            )
            if "min_free_blocks" in st:
                line += (
                    f", KV blocks {st['free_blocks']} free now / "
                    f"{st['min_free_blocks']} at peak ({args.block_size} tok/block)"
                )
            print(line)
        if st.get("engine_steps"):
            print(
                f"dispatches: {st['decode_dispatches']} decode + "
                f"{st['mixed_dispatches']} mixed over {st['engine_steps']} "
                f"engine steps ({st['dispatches_per_step']:.2f}/step)"
            )
    stats = sys_.eval_retrieval(args.queries)
    print(f"\nrecall@{args.n_global}: {stats['recall_at_n']:.3f}  mrr: {stats['mrr']:.3f}")


if __name__ == "__main__":
    main()
