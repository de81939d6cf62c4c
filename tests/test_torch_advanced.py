"""The paper's §2.2 / §4.4 advanced flow in the port against the reference:
the selector's centroids at 1e-5, its selections equal (an order may
differ only where the reference's scores are a near-tie), query rewriting
and the expansion maps exact, selector-routed ``answer_batch`` contexts
equal; and tests/test_advanced.py re-asserted on the port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.advanced import ProviderSelector as RSelector, QueryRewriter as RRewriter  # noqa: E402
from repro.core.advanced import build_expansion_maps as r_maps  # noqa: E402
from repro.core.pipeline import CFedRAGConfig as RConfig, CFedRAGSystem as RSystem  # noqa: E402
from repro.data.corpus import make_federated_corpus as r_corpus  # noqa: E402
from repro_torch.core.advanced import (  # noqa: E402
    AnswerFusion,
    GeneratorEndpoint,
    ProviderSelector,
    QueryRewriter,
    build_expansion_maps,
)
from repro_torch.core.pipeline import CFedRAGConfig as TConfig, CFedRAGSystem as TSystem  # noqa: E402
from repro_torch.data.corpus import make_federated_corpus as t_corpus  # noqa: E402

KW = dict(n_facts=96, n_distractors=96, n_queries=24, seed=5)
TIE = 1e-5  # scores closer than this may order either way


@pytest.fixture(scope="module")
def systems():
    r_sys = RSystem(r_corpus(**KW), RConfig(aggregation="embedding_rank", split_by="corpus"))
    t_sys = TSystem(t_corpus(**KW), TConfig(aggregation="embedding_rank", split_by="corpus", device="cpu"))
    return r_sys, t_sys


@pytest.fixture(scope="module")
def selectors(systems):
    r_sys, t_sys = systems
    return RSelector(r_sys.providers, r_sys.embed_fn), ProviderSelector(t_sys.providers, t_sys.embed_fn)


def test_centroids_match_reference(selectors):
    r_sel, t_sel = selectors
    assert sorted(r_sel.centroids) == sorted(t_sel.centroids)
    for pid, want in r_sel.centroids.items():
        got = t_sel.centroids[pid]
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("top_p", [1, 2, 4])
def test_selection_matches_reference(systems, selectors, top_p):
    (r_sys, t_sys), (r_sel, t_sel) = systems, selectors
    for q in r_sys.corpus.queries:
        toks = r_sys.tok.encode(q.text, max_len=24)
        want = [p.provider_id for p in r_sel.select(toks, r_sys.providers, top_p)]
        got = [p.provider_id for p in t_sel.select(toks, t_sys.providers, top_p)]
        if want == got:
            continue
        # a swap only between the reference's near-tied providers
        emb = np.asarray(r_sys.embed_fn(toks[None, :]))[0]
        score = {p.provider_id: float((np.asarray(r_sel.centroids[p.provider_id]) @ emb).max())
                 for p in r_sys.providers}
        for a, b in zip(want, got):
            assert a == b or abs(score[a] - score[b]) <= TIE, (want, got, score)


def test_rewrite_and_expansion_maps_match_reference(systems):
    r_sys, t_sys = systems
    want, got = r_maps(r_sys.providers, r_sys.tok), build_expansion_maps(t_sys.providers, t_sys.tok)
    assert got == want
    r_rw, t_rw = RRewriter(want), QueryRewriter(got)
    for q in r_sys.corpus.queries:
        toks = r_sys.tok.encode(q.text, max_len=12)
        for p in r_sys.providers:
            a, b = r_rw.rewrite(toks, p.provider_id), t_rw.rewrite(toks, p.provider_id)
            assert np.array_equal(a, b) and a.dtype == b.dtype


def test_selector_routed_answer_batch_matches_reference(systems, selectors):
    """One ``answer_batch`` routed by ``ProviderSelector(top_p=1)``: the
    reference's contexts, every chunk from the one selected provider."""
    (r_sys, t_sys), (r_sel, t_sel) = systems, selectors
    texts = [q.text for q in r_sys.corpus.queries[:12]]
    for sys_, sel in ((r_sys, r_sel), (t_sys, t_sel)):
        sys_.orchestrator.selector, sys_.orchestrator.selector_top_p = sel, 1
    try:
        want, got = r_sys.answer_batch(texts), t_sys.answer_batch(texts)
    finally:
        for sys_ in (r_sys, t_sys):
            sys_.orchestrator.selector, sys_.orchestrator.selector_top_p = None, 0
    for t, a, b in zip(texts, want, got):
        assert list(a["context"]["chunk_ids"]) == list(b["context"]["chunk_ids"])
        chosen = t_sel.select(t_sys.tok.encode(t, max_len=24), t_sys.providers, 1)[0].provider_id
        assert set(np.asarray(b["context"]["providers"]).tolist()) == {chosen}
        np.testing.assert_allclose(np.asarray(b["context"]["scores"]), np.asarray(a["context"]["scores"]), atol=1e-5)


def test_selector_routes_to_gold_provider(systems):
    _, sys_ = systems
    sel = ProviderSelector(sys_.providers, sys_.embed_fn)
    queries = sys_.corpus.queries[:16]
    hits = 0
    for q in queries:
        gold = sys_.corpus.chunks[q.gold_chunk_id]
        chosen = sel.select(sys_.tok.encode(q.text, max_len=24), sys_.providers, top_p=2)
        hits += any(gold.corpus == c.corpus for p in chosen for c in p.chunks[:1])
    assert hits >= len(queries) * 0.4, f"selector routed only {hits}/{len(queries)}"


def test_selector_reduces_dispatch_fanout(systems):
    _, sys_ = systems
    sel = ProviderSelector(sys_.providers, sys_.embed_fn)
    q = sys_.corpus.queries[0]
    chosen = sel.select(sys_.tok.encode(q.text, max_len=24), sys_.providers, top_p=2)
    assert len(chosen) == 2 < len(sys_.providers)


def test_query_rewriter_expands_with_provider_vocab(systems):
    _, sys_ = systems
    rw = QueryRewriter(build_expansion_maps(sys_.providers, sys_.tok))
    q = sys_.tok.encode(sys_.corpus.queries[0].text, max_len=12)
    out = rw.rewrite(q, sys_.providers[0].provider_id)
    assert len(out) >= len(q)
    assert (out[: len(q)] == q).all(), "original query preserved"


def test_answer_fusion_votes_and_routes():
    def mk_gen(tok):
        return lambda prompt: np.asarray([[tok, 2]])

    eps = [
        GeneratorEndpoint("pubmed-expert", mk_gen(101), domains=(0,)),
        GeneratorEndpoint("generalist", mk_gen(202), domains=()),
        GeneratorEndpoint("texbook-expert", mk_gen(303), domains=(3,)),
    ]
    fusion = AnswerFusion(eps, top_m=2)
    ctx = {"providers": np.asarray([0, 0, 0, 3])}
    assert fusion.route(ctx)[0].name == "pubmed-expert"  # most context affinity
    out = fusion.answer(np.zeros((1, 4), np.int32), ctx)
    assert out["answer_token"] == 101  # the top-ranked expert wins the vote
    assert set(out["models"]) <= {"pubmed-expert", "generalist", "texbook-expert"}
