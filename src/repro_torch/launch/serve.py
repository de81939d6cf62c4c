"""C-FedRAG serving launcher: build the federated corpus, stand up the
providers + enclave orchestrator, and answer queries.

  python -m repro_torch.launch.serve --queries 5 --aggregation rerank
  python -m repro_torch.launch.serve --queries 16 --generate --device cuda
  python -m repro_torch.launch.serve --queries 16 --generate --paged --token-budget 32
  python -m repro_torch.launch.serve --queries 16 --prefix-cache --repeat 2 --spill-mb 8
  python -m repro_torch.launch.serve --queries 16 --stream --collect-batch 4 --tenants interactive=4:1,batch=1
  python -m repro_torch.launch.serve --queries 16 --generate --paged --draft-k 3
  python -m repro_torch.launch.serve --queries 16 --shards 4 --block-size 8 --device cpu

Uses the bag embedder + lexical-overlap reranker (training-free).
``--generate`` stands up a random-init, smoke-width LM ``ServeEngine``
(contiguous cache stripes, or the paged block pool with ``--paged``) and
routes the whole query set through ``CFedRAGSystem.serve`` (or, with
``--stream``, the pipelined ``serve_stream``), printing per-request
p50/p95.  ``--prefix-cache`` shares prompt prefixes on the paged pool,
``--repeat N`` serves the query set N times through one resident engine
and ``--spill-mb`` adds the host spill tier; ``--tenants`` tags queries
with SLO classes; ``--draft-k K`` turns on speculative decoding with the
demo model as its own drafter (self-speculation) and prints the drafter
pool and the speculation gauges; ``--shards N`` splits the paged pool over
N devices (the first N cards, or N shards on the CPU with ``--device
cpu``) and prints the blocks free on each shard.  Everything runs on
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions).

``full_width_system`` (qwen3-0.6b, qwen3-4b or qwen2-moe-a2.7b on the
paged or contiguous engine, mamba2-1.3b and jamba-1.5-large-398b, the
latter cut to one scan period, on the contiguous engine; with
``draft_k`` and a drafter for speculative decoding, and with ``shards``
(and a ``mesh`` placing them) for the sharded pool) and
``paper_models_system`` build the configurations measured on the card
(``chip_smoke.py``, ``launch/profile_serve.py``).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.pipeline import CFedRAGConfig, CFedRAGSystem
from repro_torch.core.resilience import FaultSpec
from repro_torch.data.corpus import make_federated_corpus
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models import cross_encoder as CE
from repro_torch.models import dual_encoder as DE
from repro_torch.models import lm as LM
from repro_torch.models.params import ParamTree, init_params, map_tree
from repro_torch.serving.engine import ServeConfig, ServeEngine, engine_generator


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


def make_demo_engine(max_new_tokens: int = 16, paged: bool = False, block_size: int = 32,
                     pool_blocks: int | None = None, max_batch: int = 4,
                     token_budget: int | None = None, vocab_size: int = 8192,
                     device: str = "cuda", seed: int = 0, prefix_cache: bool = False,
                     spill_bytes: int | None = None, draft_k: int = 0, shards: int | None = None):
    """Random-init smoke-width qwen3-0.6b ``ServeEngine`` + generator
    adapter, over contiguous stripes or (``paged``) the block pool.  The
    model's vocabulary is ``vocab_size``, which must cover the tokenizer
    the prompts come from (an id outside it raises).  ``draft_k > 0``
    speculates with the model as its own drafter (a real deployment passes
    a small ``draft_config`` / ``draft_params`` pair to ``ServeConfig``);
    ``shards`` splits the block pool over that many devices, every step
    one distributed dispatch, tokens bit-identical to ``shards=1``."""
    cfg = smoke_config(get_config("qwen3-0.6b")).with_overrides(
        dtype="float32", vocab_size=vocab_size
    )
    gen = torch.Generator(device=device).manual_seed(seed)
    params = ParamTree(init_params(LM.param_specs(cfg), gen, device=device))
    engine = ServeEngine(
        cfg, params,
        ServeConfig(
            max_batch=max_batch, max_prompt_len=256, max_new_tokens=max_new_tokens,
            paged=paged, block_size=block_size, n_pool_blocks=pool_blocks,
            token_budget=token_budget, prefix_cache=prefix_cache, spill_bytes=spill_bytes,
            draft_k=draft_k, shards=shards,
        ),
        device=device,
    )
    return engine_generator(engine)


def parse_tenant_spec(spec: str) -> tuple[dict[str, float], dict[str, int]]:
    """``--tenants 'interactive=4:1,batch=1'`` -> (weights, priorities).

    Each comma-separated entry is ``name=weight[:priority]``; weight is
    the weighted-fair admission share within a priority class, priority
    the strict admission class (higher preempts the queue)."""
    weights: dict[str, float] = {}
    prios: dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, eq, rest = part.partition("=")
        name = name.strip()
        if not name or not eq:
            raise ValueError(f"bad --tenants entry {part!r} (want name=weight[:priority])")
        w, _, p = rest.partition(":")
        weights[name] = float(w)
        prios[name] = int(p) if p else 0
    if not weights:
        raise ValueError(f"--tenants spec {spec!r} names no tenants")
    return weights, prios


def _on(tree, device):
    return map_tree(lambda t: t.to(device), tree)


# jamba-1.5-large-398b (397.7 B parameters) is held by no card whole.
# Its smallest legal depth is one scan period, lcm(attn_every 8, moe_every
# 2) = 8 layers (attention at 0, Mamba2 at 1-7, MoE at 1, 3, 5, 7), still
# 45.1 B parameters (180.6 GB in f32), 38.7 B of them the four layers of 16
# routed experts of 3 x 8192 x 24576; fewer experts would not help, since
# the tree pads them back to 16.  So the routed experts' hidden width is
# cut from 24,576 to 4,096 too: 12.93 B parameters, 51.7 GB of f32
# weights.  Every other width is the published one, so every shape that
# reaches a kernel is jamba's own; the cut touches only the expert loop's
# matmuls.
FULL_WIDTH_CUTS = {"jamba-1.5-large-398b": dict(n_layers=8, moe_d_ff=4096)}


def full_width_config(arch: str):
    """``arch``'s published config with the cuts of ``FULL_WIDTH_CUTS``
    that one card forces (none for the other architectures)."""
    return get_config(arch).with_overrides(**FULL_WIDTH_CUTS.get(arch, {}))


def _full_width_engine(tok: HashTokenizer, device: str, seed: int, paged: bool, arch: str = "qwen3-0.6b",
                       mesh=None, **serve_kw):
    """``arch`` at full width (qwen3-0.6b: 28 layers, bf16 activations and
    KV cache; qwen3-4b: 36 layers; qwen2-moe-a2.7b: 24 layers of 60
    routed top-4 experts and 4 shared ones, 60.6 GB of f32 weights;
    mamba2-1.3b: 48 layers, bf16 activations, f32 SSM state;
    jamba-1.5-large-398b: one scan period of 8 layers with the routed
    experts' hidden width 4,096, see ``FULL_WIDTH_CUTS``; the last two on
    the contiguous engine only), random weights from ``seed``, behind
    ``ServeConfig(max_batch=8, max_prompt_len=256, max_new_tokens=16,
    **serve_kw)`` (``mesh`` places a sharded pool's shards)."""
    cfg = full_width_config(arch)
    if tok.vocab_size > cfg.vocab_size:
        raise ValueError("tokenizer vocabulary exceeds the model's")
    if paged and not LM.attention_only(cfg):
        raise ValueError(f"{arch} serves on the contiguous engine only: pass paged=False")
    gen = torch.Generator(device=device).manual_seed(seed)
    params = ParamTree(init_params(LM.param_specs(cfg), gen, device=device))
    scfg = ServeConfig(paged=paged, max_batch=8, max_prompt_len=256, max_new_tokens=16, **serve_kw)
    return ServeEngine(cfg, params, scfg, device=device, mesh=mesh)


def full_width_system(n_queries: int = 16, device: str = "cuda", seed: int = 0,
                      generate: bool = True, paged: bool = True, arch: str = "qwen3-0.6b",
                      prefix_cache: bool = False, spill_bytes: int | None = None,
                      n_pool_blocks: int | None = None, draft_k: int = 0,
                      draft_config=None, draft_params=None, shards: int | None = None, mesh=None):
    """The bag-embedder configuration measured on the card: the full-width
    ``arch`` engine (``_full_width_engine``; qwen3-0.6b by default on the
    paged block pool, or contiguous stripes with ``paged=False``;
    ``arch="mamba2-1.3b"`` and ``"jamba-1.5-large-398b"`` need
    ``paged=False``) over a 128-fact +
    128-distractor federated corpus with the overlap reranker.
    ``prefix_cache``, ``spill_bytes``, ``n_pool_blocks``, the
    speculative ``draft_k``, ``draft_config`` and ``draft_params`` (None:
    self-speculation) and the sharded pool's ``shards`` go to the engine's
    ``ServeConfig``; ``mesh`` places the shards (default: the first
    ``shards`` cards).

    Returns ``(system, engine, texts)``, ``texts`` being the corpus's
    first ``n_queries`` questions.  ``generate=False`` builds the same
    federation with no model (``engine`` is None), for retrieval alone."""
    tok = HashTokenizer()
    corpus = make_federated_corpus(n_facts=128, n_distractors=128, n_queries=n_queries, seed=seed)
    engine = _full_width_engine(
        tok, device, seed, paged, arch, prefix_cache=prefix_cache, spill_bytes=spill_bytes,
        n_pool_blocks=n_pool_blocks, draft_k=draft_k, draft_config=draft_config, draft_params=draft_params,
        shards=shards, mesh=mesh,
    ) if generate else None
    system = CFedRAGSystem(
        corpus, CFedRAGConfig(device=device), tokenizer=tok, reranker=overlap_reranker(tok),
        generator=engine_generator(engine) if engine is not None else None,
    )
    return system, engine, [q.text for q in corpus.queries[:n_queries]]


def paper_models_system(n_queries: int = 16, device: str = "cuda", seed: int = 0,
                        generate: bool = True, encoder_dtype: str = "bfloat16"):
    """C-FedRAG with the models the paper names, on the same corpus as
    ``full_width_system``: ``contriever-110m`` (dual encoder, F_emb) as
    every provider's ``embed_fn`` and ``bge-reranker-base`` (cross encoder,
    F_aggr) through ``make_reranker``, both at full width (12 layers,
    d_model 768, 12 heads of 64) in ``encoder_dtype``, plus the paged
    full-width qwen3-0.6b engine.  The encoders' random weights are drawn
    from ``seed`` on the CPU and moved to ``device``, so a CPU and a card
    build hold the same encoders.  Building the system embeds every
    provider's chunks (its index).

    Returns ``(system, engine, texts)`` as ``full_width_system`` does."""
    tok = HashTokenizer()
    e_cfg = get_config("contriever-110m").with_overrides(dtype=encoder_dtype)
    r_cfg = get_config("bge-reranker-base").with_overrides(dtype=encoder_dtype)
    for cfg in (e_cfg, r_cfg):
        if tok.vocab_size > cfg.vocab_size:
            raise ValueError(f"tokenizer vocabulary exceeds {cfg.name}'s")
    gen = torch.Generator().manual_seed(seed)
    e_params = _on(init_params(DE.param_specs(e_cfg), gen, device="cpu"), device)
    r_params = _on(init_params(CE.param_specs(r_cfg), gen, device="cpu"), device)

    def embed_fn(tokens):
        return DE.encode(e_cfg, e_params, torch.as_tensor(np.asarray(tokens), device=device))

    corpus = make_federated_corpus(n_facts=128, n_distractors=128, n_queries=n_queries, seed=seed)
    engine = _full_width_engine(tok, device, seed, paged=True) if generate else None
    system = CFedRAGSystem(
        corpus, CFedRAGConfig(device=device), tokenizer=tok, embed_fn=embed_fn,
        reranker=CE.make_reranker(r_cfg, r_params),
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
    ap.add_argument(
        "--stream", action="store_true",
        help="pipelined front door: collect of micro-batch N+1 overlaps decode "
        "of N, results print as each generation retires (implies --generate)",
    )
    ap.add_argument("--collect-batch", type=int, default=4, help="micro-batch size of the --stream collector")
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument(
        "--paged", action="store_true",
        help="paged KV cache: block-pool memory manager instead of one "
        "contiguous stripe per slot",
    )
    ap.add_argument("--block-size", type=int, default=32, help="tokens per KV block (--paged)")
    ap.add_argument(
        "--pool-blocks", type=int, default=None,
        help="KV pool size in blocks (--paged); default = max-batch full-length requests",
    )
    ap.add_argument("--max-batch", type=int, default=4, help="engine decode slots")
    ap.add_argument(
        "--prefix-cache", action="store_true",
        help="refcounted prefix cache on the paged pool: prompts that share a "
        "preamble share its KV blocks and skip its prefill (implies --paged --generate)",
    )
    ap.add_argument(
        "--token-budget", type=int, default=None, metavar="N",
        help="query lanes per unified mixed step (prompt chunks + decode rows); "
        "implies --paged --generate",
    )
    ap.add_argument(
        "--draft-k", type=int, default=0, metavar="K",
        help="speculative decoding: the demo model drafts K greedy tokens per "
        "row from its own paged pool (self-speculation) and the target verifies "
        "all K+1 lanes in one mixed dispatch; tokens equal plain decode's "
        "(implies --paged --generate)",
    )
    ap.add_argument(
        "--shards", type=int, default=None, metavar="N",
        help="split the paged KV pool over N devices (the first N cards; N "
        "shards on the CPU with --device cpu): row-affine blocks, one "
        "distributed dispatch per step, tokens bit-identical to --shards 1 "
        "(implies --paged --generate)",
    )
    ap.add_argument(
        "--repeat", type=int, default=1,
        help="serve the query set N times through one resident engine and "
        "prefix index (prints the per-repeat hit rate)",
    )
    ap.add_argument(
        "--tenants", type=str, default=None, metavar="SPEC",
        help="per-tenant SLO classes, e.g. 'interactive=4:1,batch=1' "
        "(name=weight[:priority]); queries are assigned round-robin, admission "
        "is strict priority then weighted-fair (implies --generate)",
    )
    ap.add_argument(
        "--fifo", action="store_true",
        help="admit in global arrival order, ignoring tenant weights and priorities",
    )
    ap.add_argument(
        "--spill-mb", type=float, default=None, metavar="MB",
        help="host spill tier for the prefix cache, in MiB: parked chains that "
        "pool pressure evicts are demoted to host memory and re-admitted by "
        "upload (implies --prefix-cache)",
    )
    ap.add_argument(
        "--fault-spec", type=str, default=None, metavar="JSON",
        help='seeded fault injection on every provider, e.g. '
        '\'{"seed": 0, "p_conn": 0.1, "p_corrupt": 0.05, "p_poison": 0.05}\' '
        "(core.resilience.FaultSpec)",
    )
    ap.add_argument(
        "--retries", type=int, default=1,
        help="collect attempts per provider per round (exponential backoff; 1 = off)",
    )
    ap.add_argument(
        "--breaker", action=argparse.BooleanOptionalAction, default=False,
        help="per-provider circuit breakers",
    )
    ap.add_argument(
        "--score-gate", action="store_true",
        help="aggregator-side poisoning gate: score calibration + outlier quarantine",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.spill_mb is not None:
        args.prefix_cache = True
    if args.prefix_cache or args.token_budget is not None or args.draft_k > 0 or args.shards is not None:
        args.paged = args.generate = True
    if args.tenants is not None or args.stream:
        args.generate = True
    tenant_weights = tenant_prios = None
    if args.tenants is not None:
        tenant_weights, tenant_prios = parse_tenant_spec(args.tenants)

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
            retries=args.retries,
            breaker=args.breaker,
            score_gate=args.score_gate,
            device=args.device,
        ),
        fault_spec=FaultSpec.from_json(args.fault_spec) if args.fault_spec else None,
        tokenizer=tok,
        reranker=overlap_reranker(tok) if args.aggregation == "rerank" else None,
        generator=make_demo_engine(
            args.max_new_tokens, paged=args.paged, block_size=args.block_size,
            pool_blocks=args.pool_blocks, max_batch=args.max_batch,
            token_budget=args.token_budget, vocab_size=tok.vocab_size, device=args.device,
            prefix_cache=args.prefix_cache,
            spill_bytes=int(args.spill_mb * 2**20) if args.spill_mb else None,
            draft_k=args.draft_k, shards=args.shards,
        ) if args.generate else None,
    )
    if args.kill_provider is not None:
        sys_.providers[args.kill_provider].fail = True
        print(f"!! provider {args.kill_provider} marked down (quorum keeps serving)")

    texts = [q.text for q in corpus.queries[: args.queries]]
    qmeta = list(corpus.queries[: args.queries])
    tenants = priorities = None
    if tenant_weights is not None:
        names = list(tenant_weights)
        tenants = [names[i % len(names)] for i in range(len(texts))]
        priorities = [tenant_prios[t] for t in tenants]
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
        orch.collect_contexts(texts[0])
        orch.deadline_s = args.deadline_s
    # --repeat serves through ONE resident system: the engine, its pool and
    # its prefix index survive from round to round, so round 2 on re-serves
    # every query against a warm index
    results: list = []
    meta_all: list = []
    serve_kw = dict(max_new_tokens=args.max_new_tokens, tenants=tenants, priorities=priorities,
                    tenant_weights=tenant_weights, fifo=args.fifo)
    for rep in range(max(1, args.repeat)):
        if args.stream:
            # results arrive in retire order while later micro-batches are
            # still collecting; printed live, reported below in query order
            res = [None] * len(texts)
            for qidx, out in sys_.serve_stream(texts, collect_batch=args.collect_batch, **serve_kw):
                res[qidx] = out
                lat = "-" if out["latency_s"] is None else f"{out['latency_s'] * 1e3:.1f}ms"
                print(f"  [stream] q{qidx} retired: status={out['status']} lat={lat} (collect->finish)")
        elif args.generate:
            res = sys_.serve(texts, **serve_kw)
        else:
            res = [sys_.orchestrator.answer(t) for t in texts]
        results.extend(res)
        meta_all.extend(qmeta)
        if args.repeat > 1 and args.generate:
            st = getattr(sys_, "last_serve_stats", {})
            print(
                f"repeat {rep + 1}/{args.repeat}: prefix hits "
                f"{st.get('prefix_hits', 0)}/{st.get('prefix_lookups', 0)} "
                f"({st.get('prefix_hit_rate', 0.0):.0%}), "
                f"{st.get('prefill_tokens_saved', 0)} prefill tokens saved this round"
            )
    for q, res in zip(meta_all, results):
        if res.get("degraded"):
            print(f"Q: {q.text!r:45s} DEGRADED ({res['error']}): flagged, the others kept serving")
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
            if args.shards is not None:
                pool = sys_.orchestrator.generator.engine._pool
                print(f"sharded pool: {args.shards} shards, blocks free by shard {pool.free_blocks_by_shard}")
            if args.draft_k > 0 and "draft_free_blocks" in st:
                print(
                    f"drafter pool: {st['draft_free_blocks']} blocks free now / "
                    f"{st['min_draft_free_blocks']} at peak"
                )
        if st.get("engine_steps"):
            print(
                f"dispatches: {st['admit_dispatches']} admit + {st['decode_dispatches']} decode + "
                f"{st['mixed_dispatches']} mixed over {st['engine_steps']} "
                f"engine steps ({st['dispatches_per_step']:.2f}/step)"
            )
        if "spec_tokens_per_round" in st:
            print(
                f"speculation: {st['spec_tokens_per_round']:.2f} tokens/round "
                f"at accept rate {st.get('spec_accept_rate', 0.0):.0%} "
                f"(draft_k={args.draft_k}), "
                f"{st['dispatches_per_spec_round']:.2f} dispatches/spec round "
                f"over {st['spec_rounds']} rounds"
            )
        if "prefix_lookups" in st:
            print(
                f"prefix cache: {st['prefix_hits']}/{st['prefix_lookups']} hits "
                f"({st.get('prefix_hit_rate', 0.0):.0%}), "
                f"{st['prefill_tokens_saved']}/{st['prefill_tokens']} prefill tokens "
                f"saved ({st.get('prefill_saved_frac', 0.0):.0%}), "
                f"{st['prefix_shared_blocks']} blocks shared by reference, "
                f"{st['prefix_cached_blocks']} chunks cached "
                f"({st.get('reclaimable_blocks', 0)} reclaimable)"
            )
        if "spilled_blocks" in st:
            print(
                f"spill tier: {st['spilled_blocks']} chunks on host "
                f"({st['spill_bytes_used'] / 2**20:.2f} MiB), "
                f"{st['spill_demotions']} demotions / "
                f"{st['spill_readmits']} re-admits this window"
            )
        for name, ts in sorted(st.get("tenants", {}).items()):
            line = (
                f"tenant {name}: {ts['n_done']} done, {ts['n_expired']} expired, "
                f"{ts.get('n_admitted', 0)} admitted, {ts['tokens_out']} tokens out"
            )
            if "p95_s" in ts:
                line += f", p50={ts['p50_s'] * 1e3:.1f}ms p95={ts['p95_s'] * 1e3:.1f}ms"
            if ts.get("prefix_lookups") and args.prefix_cache:
                line += f", prefix hit rate {ts.get('prefix_hit_rate', 0.0):.0%}"
            print(line)
    fed = sys_.orchestrator.federation_stats()
    tot = fed["totals"]
    if tot["attempts"]:
        print(
            f"federation: {tot['successes']}/{tot['attempts']} round-trips ok, "
            f"{tot['retries']} retries, {tot['skips']} breaker skips "
            f"({tot['breakers_open']} breakers open), "
            f"{tot['rechannels']} channel re-establishes, "
            f"faults conn={tot['faults']['conn']} timeout={tot['faults']['timeout']} "
            f"integrity={tot['faults']['integrity']}, "
            f"{tot['quarantined']} rounds quarantined by the score gate"
        )
        flaky = {
            pid: d for pid, d in fed["providers"].items()
            if d["attempts"] != d["successes"] or d["skips"] or d["quarantined"]
        }
        for pid, d in sorted(flaky.items()):
            print(
                f"  provider {pid}: {d['successes']}/{d['attempts']} ok, "
                f"{d['retries']} retries, {d['skips']} skips, "
                f"breaker={d['breaker'] or 'off'}, faults={d['faults']}"
                + (f", injected={d['injected']}" if "injected" in d else "")
            )
    stats = sys_.eval_retrieval(args.queries)
    print(f"\nrecall@{args.n_global}: {stats['recall_at_n']:.3f}  mrr: {stats['mrr']:.3f}")


if __name__ == "__main__":
    main()
