"""The paper's Table-1 baselines in the port against the reference:
``single_silo_system`` and ``centralized_system`` beside the federated
system, on the same corpus, recall@n and MRR equal exactly, the
reference's Table-1 claims (tests/test_system.py) re-asserted on the
port, and ``launch/table1.py`` equal to ``benchmarks/table1_federated_rag.py``
row by row."""
import json
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.core.pipeline import CFedRAGConfig as RConfig, CFedRAGSystem as RSystem  # noqa: E402
from repro.core.pipeline import centralized_system as r_central, single_silo_system as r_silo  # noqa: E402
from repro.data.corpus import make_federated_corpus as r_corpus  # noqa: E402
from repro.data.tokenizer import HashTokenizer as RTok  # noqa: E402
from repro.launch.serve import overlap_reranker as r_rerank  # noqa: E402
from repro_torch.core.pipeline import CFedRAGConfig as TConfig, CFedRAGSystem as TSystem  # noqa: E402
from repro_torch.core.pipeline import centralized_system as t_central, single_silo_system as t_silo  # noqa: E402
from repro_torch.data.corpus import CORPORA, make_federated_corpus as t_corpus  # noqa: E402
from repro_torch.data.tokenizer import HashTokenizer as TTok  # noqa: E402
from repro_torch.launch import table1  # noqa: E402
from repro_torch.launch.serve import overlap_reranker as t_rerank  # noqa: E402

KW = dict(n_facts=96, n_distractors=96, n_queries=48, seed=1)
ROWS = ["centralized", *CORPORA, "embedding_rank", "rerank"]


@pytest.fixture(scope="module")
def corpora():
    return r_corpus(**KW), t_corpus(**KW)


def _build(row, corpus, pkg):
    if pkg == "ref":
        cfg, silo, central, system, tok, rerank = RConfig, r_silo, r_central, RSystem, RTok(), r_rerank
        extra = {}
    else:
        cfg, silo, central, system, tok, rerank = TConfig, t_silo, t_central, TSystem, TTok(), t_rerank
        extra = {"device": "cpu"}
    if row == "centralized":
        return central(corpus, cfg(**extra))
    if row in CORPORA:
        return silo(corpus, row, cfg(**extra))
    if row == "embedding_rank":
        return system(corpus, cfg(aggregation="embedding_rank", **extra), tokenizer=tok)
    return system(corpus, cfg(aggregation="rerank", **extra), tokenizer=tok, reranker=rerank(tok))


@pytest.fixture(scope="module")
def port_rows(corpora):
    return {row: _build(row, corpora[1], "port").eval_retrieval(32) for row in ROWS}


@pytest.mark.parametrize("row", ROWS)
def test_row_matches_reference_exactly(corpora, port_rows, row):
    want = _build(row, corpora[0], "ref").eval_retrieval(32)
    got = port_rows[row]
    assert got["recall_at_n"] == want["recall_at_n"]
    assert got["mrr"] == want["mrr"]
    assert got["per_corpus"] == want["per_corpus"]


def test_baseline_shapes(corpora):
    """A silo holds one corpus in per-corpus providers; the centralized
    system holds every chunk in one provider."""
    corpus = corpora[1]
    cent = t_central(corpus, TConfig(device="cpu"))
    assert len(cent.providers) == 1 and len(cent.providers[0].chunks) == len(corpus.chunks)
    for c in CORPORA:
        silo = t_silo(corpus, c, TConfig(device="cpu"))
        assert {ch.corpus for p in silo.providers for ch in p.chunks} == {c}
        assert silo.cfg.aggregation == "embedding_rank" and silo.cfg.split_by == "corpus"


def test_federated_matches_centralized_recall(port_rows):
    """The paper's key claim: federated retrieval recovers the centralized
    context (tests/test_system.py)."""
    assert port_rows["embedding_rank"]["recall_at_n"] >= port_rows["centralized"]["recall_at_n"] - 0.05


def test_single_silo_much_worse(port_rows):
    worst = min(port_rows[c]["recall_at_n"] for c in CORPORA)
    assert port_rows["embedding_rank"]["recall_at_n"] > worst + 0.2, "federation must beat the weakest silo clearly"


def test_table1_matches_reference_script(tmp_path, monkeypatch):
    """``launch/table1.run`` gives ``benchmarks/table1_federated_rag.run``'s
    rows, in order (at a small size); ``--json`` writes them to its file."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmarks.table1_federated_rag import run as r_run

    want = r_run(n_facts=48, n_queries=24, seed=3)
    got = table1.run(n_facts=48, n_queries=24, seed=3, device="cpu")
    assert [r["method"] for r in got] == [r["method"] for r in want]
    for a, b in zip(want, got):
        assert (a["recall_at_8"], a["mrr"], a["per_corpus"]) == (b["recall_at_8"], b["mrr"], b["per_corpus"])
    monkeypatch.setattr(table1, "run", lambda device: got)  # main's rows, without the full-size run
    out = tmp_path / "t1.json"
    table1.main(["--device", "cpu", "--json", str(out)])
    blob = json.loads(out.read_text())
    assert [r["recall_at_8"] for r in blob["rows"]] == [r["recall_at_8"] for r in want]
    assert set(blob["claim_checks"]) == set(table1.claim_checks(got))
