"""Synthetic corpus + QA generator with known ground-truth provenance.

Stand-in for MedRAG/MIRAGE (unavailable offline, DESIGN.md §2).  Mirrors
the paper's experimental topology: 4 corpora ("pubmed", "wikipedia",
"statpearls", "textbooks") distributed across 2 sites; each query's gold
evidence lives in exactly one corpus, with corpus-skewed query mixes so a
single silo cannot answer everything (the Table 1 mechanism).

Facts are ``entity attribute value`` triples; chunks embed the fact inside
topic-correlated distractor words; queries ask ``what is <attribute> of
<entity>``.  Every chunk records (corpus, site, gold query ids).
"""
from __future__ import annotations

import dataclasses

import numpy as np

CORPORA = ("pubmed", "wikipedia", "statpearls", "textbooks")
SITE_OF = {"pubmed": 0, "wikipedia": 0, "statpearls": 1, "textbooks": 1}
# query-topic mix: pubmed dominates (as in Table 1 where MedRag(PubMed)
# nearly matches MedRag(MedCorp))
CORPUS_WEIGHTS = (0.55, 0.15, 0.15, 0.15)


@dataclasses.dataclass
class Chunk:
    text: str
    corpus: str
    site: int
    chunk_id: int
    fact_id: int  # -1 for distractor-only chunks


@dataclasses.dataclass
class Query:
    text: str
    answer: str
    gold_chunk_id: int
    corpus: str
    query_id: int


@dataclasses.dataclass
class FederatedCorpus:
    chunks: list[Chunk]
    queries: list[Query]

    def site_chunks(self, site: int) -> list[Chunk]:
        return [c for c in self.chunks if c.site == site]

    def corpus_chunks(self, corpus: str) -> list[Chunk]:
        return [c for c in self.chunks if c.corpus == corpus]


def _words(rng: np.random.Generator, pool: list[str], n: int) -> str:
    return " ".join(rng.choice(pool, size=n))


def make_federated_corpus(
    n_facts: int = 256,
    n_distractors: int = 256,
    n_queries: int = 200,
    chunk_len_words: int = 24,
    seed: int = 0,
) -> FederatedCorpus:
    rng = np.random.default_rng(seed)
    topics = {
        c: [f"{c}word{i}" for i in range(200)] for c in CORPORA
    }
    attrs = [f"attr{i}" for i in range(32)]
    chunks: list[Chunk] = []
    queries: list[Query] = []

    # facts, assigned to corpora by the skewed mix
    fact_corpus = rng.choice(len(CORPORA), size=n_facts, p=CORPUS_WEIGHTS)
    for f in range(n_facts):
        corpus = CORPORA[fact_corpus[f]]
        ent, attr = f"entity{f}", attrs[rng.integers(len(attrs))]
        val = f"value{f}x{rng.integers(10_000)}"
        filler = _words(rng, topics[corpus], chunk_len_words - 6)
        text = f"{filler} {ent} {attr} is {val} ."
        chunks.append(Chunk(text, corpus, SITE_OF[corpus], len(chunks), f))
        if len(queries) < n_queries:
            queries.append(
                Query(
                    text=f"what is {attr} of {ent}",
                    answer=val,
                    gold_chunk_id=len(chunks) - 1,
                    corpus=corpus,
                    query_id=len(queries),
                )
            )
    # distractors
    for _ in range(n_distractors):
        corpus = CORPORA[rng.integers(len(CORPORA))]
        text = _words(rng, topics[corpus], chunk_len_words)
        chunks.append(Chunk(text, corpus, SITE_OF[corpus], len(chunks), -1))

    rng.shuffle(queries)
    return FederatedCorpus(chunks=chunks, queries=queries)
