"""The paper's Table 1 on the port: C-FedRAG against vanilla single-silo
RAG and a centralized index.

    PYTHONPATH=src python -m repro_torch.launch.table1 [--device cuda] [--json [PATH]]

Paper protocol (§3): 4 corpora across 2 sites, top-8 per site, re-rank 32
-> 8 context window.  The synthetic provenance corpus (``data/corpus.py``)
gives exact ground truth; the metric is recall@8 / MRR of the gold chunk
in the final context window.  Rows, in the paper's order: no-RAG (CoT),
0 by construction; the four ``MedRag(<corpus>)`` silos; the centralized
``MedRag(MedCorp)``; C-FedRAG with embedding rank and with the re-rank
model.  ``run`` uses the protocol of ``benchmarks/table1_federated_rag.py``
(``n_facts=192, n_queries=120, seed=0``) and ``main`` prints the rows and
the two claim checks, or with ``--json`` writes them to ``PATH``
(default ``table1_torch.json``).  Providers embed and retrieve on
``--device`` (``cpu`` runs the kernels' plain versions).
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.core.pipeline import CFedRAGConfig, CFedRAGSystem, centralized_system, single_silo_system
from repro_torch.data.corpus import CORPORA, make_federated_corpus
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.launch.serve import overlap_reranker


def run(n_facts: int = 192, n_queries: int = 120, seed: int = 0, device: str = "cuda") -> list[dict]:
    corpus = make_federated_corpus(n_facts=n_facts, n_distractors=n_facts, n_queries=n_queries, seed=seed)
    tok = HashTokenizer()
    rows = []

    def add(name, system):
        t0 = time.monotonic()
        r = system.eval_retrieval(n_queries)
        dt = (time.monotonic() - t0) / n_queries
        rows.append({
            "method": name,
            "recall_at_8": round(r["recall_at_n"], 4),
            "mrr": round(r["mrr"], 4),
            "us_per_query": round(dt * 1e6, 1),
            "per_corpus": {k: round(v, 3) for k, v in r["per_corpus"].items()},
        })

    # no retrieval -> no gold context, by definition
    rows.append({"method": "CoT (no RAG)", "recall_at_8": 0.0, "mrr": 0.0, "us_per_query": 0.0, "per_corpus": {}})
    for c in CORPORA:
        add(f"MedRag({c})", single_silo_system(corpus, c, CFedRAGConfig(device=device)))
    add("MedRag(MedCorp/centralized)", centralized_system(corpus, CFedRAGConfig(device=device)))
    add(
        "C-FedRAG (Embedding Rank)",
        CFedRAGSystem(corpus, CFedRAGConfig(aggregation="embedding_rank", device=device), tokenizer=tok),
    )
    add(
        "C-FedRAG (Re-rank Model)",
        CFedRAGSystem(corpus, CFedRAGConfig(aggregation="rerank", device=device), tokenizer=tok,
                      reranker=overlap_reranker(tok)),
    )
    return rows


def claim_checks(rows: list[dict]) -> dict:
    """The Table-1 ordering the paper claims: re-rank >= embedding rank, and
    re-rank > the best single silo.  ``{name: (holds, lhs, rhs)}``."""
    by = {r["method"]: r for r in rows}
    fed_rr = by["C-FedRAG (Re-rank Model)"]["recall_at_8"]
    fed_er = by["C-FedRAG (Embedding Rank)"]["recall_at_8"]
    best_silo = max(by[f"MedRag({c})"]["recall_at_8"] for c in CORPORA)
    return {
        "C-FedRAG(rerank) >= C-FedRAG(embed)": (fed_rr >= fed_er - 1e-9, fed_rr, fed_er),
        "C-FedRAG(rerank) > best single silo": (fed_rr > best_silo, fed_rr, best_silo),
    }


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--json", nargs="?", const="table1_torch.json", default=None, metavar="PATH",
                    help="write the rows and claim checks here instead of printing them")
    args = ap.parse_args(argv)
    rows = run(device=args.device)
    checks = claim_checks(rows)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": args.device, "rows": rows,
                       "claim_checks": {k: list(v) for k, v in checks.items()}}, f, indent=1)
        return rows
    print(f"{'method':34s} {'recall@8':>9s} {'MRR':>7s} {'us/query':>10s}")
    for r in rows:
        print(f"{r['method']:34s} {r['recall_at_8']:9.3f} {r['mrr']:7.3f} {r['us_per_query']:10.1f}")
    print("\nclaim checks:")
    for name, (ok, lhs, rhs) in checks.items():
        print(f"  {name}: {ok} ({lhs:.3f} vs {rhs:.3f})")
    return rows


if __name__ == "__main__":
    main()
