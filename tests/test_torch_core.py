"""The port's framework-free core against the reference: the confidential
channel interoperates byte for byte, and the batched orchestrator picks
the same contexts (chunk ids) from the same corpus."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import confidential as RC  # noqa: E402
from repro.core.pipeline import CFedRAGConfig as RConfig, CFedRAGSystem as RSystem  # noqa: E402
from repro.data.corpus import make_federated_corpus as r_corpus  # noqa: E402
from repro.data.tokenizer import HashTokenizer as RTok  # noqa: E402
from repro.launch.serve import overlap_reranker as r_rerank  # noqa: E402
from repro_torch.core import confidential as TC  # noqa: E402
from repro_torch.core.pipeline import CFedRAGConfig as TConfig, CFedRAGSystem as TSystem  # noqa: E402
from repro_torch.data.corpus import make_federated_corpus as t_corpus  # noqa: E402
from repro_torch.data.tokenizer import HashTokenizer as TTok  # noqa: E402
from repro_torch.launch.serve import overlap_reranker as t_rerank  # noqa: E402


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_secure_channel_interoperates(direction):
    key_a, key_b = RC.hkdf(b"session", b"a"), RC.hkdf(b"session", b"b")
    assert TC.hkdf(b"session", b"a") == key_a and TC.measure("x") == RC.measure("x")
    sender_mod, receiver_mod = (TC, RC) if direction == "port_to_ref" else (RC, TC)
    sender = sender_mod.SecureChannel(key_a, key_b)
    receiver = receiver_mod.SecureChannel(key_b, key_a)
    payloads = [b"", b"query tokens", bytes(range(256)) * 5]
    for p in payloads:
        nonce, sealed = sender.seal(p, aad=b"hdr")
        assert receiver.open(nonce, sealed, aad=b"hdr") == p
    nonce, sealed = sender.seal(b"tamper me")
    bad = bytes([sealed[0] ^ 1]) + sealed[1:]
    with pytest.raises(receiver_mod.IntegrityError):
        receiver.open(nonce, bad)


@pytest.mark.parametrize("aggregation", ["embedding_rank", "rerank"])
def test_answer_batch_contexts_match_reference(aggregation):
    kw = dict(n_facts=40, n_distractors=40, n_queries=12, seed=3)
    rc, tc = r_corpus(**kw), t_corpus(**kw)
    rtok, ttok = RTok(), TTok()
    r_sys = RSystem(
        rc, RConfig(aggregation=aggregation, m_local=4, n_global=4, chunk_max_len=24),
        tokenizer=rtok, reranker=r_rerank(rtok) if aggregation == "rerank" else None,
    )
    t_sys = TSystem(
        tc, TConfig(aggregation=aggregation, m_local=4, n_global=4, chunk_max_len=24, device="cpu"),
        tokenizer=ttok, reranker=t_rerank(ttok) if aggregation == "rerank" else None,
    )
    texts = [q.text for q in rc.queries]
    r_out, t_out = r_sys.answer_batch(texts), t_sys.answer_batch(texts)
    for a, b in zip(r_out, t_out):
        assert list(a["context"]["chunk_ids"]) == list(b["context"]["chunk_ids"])
        np.testing.assert_allclose(
            np.asarray(b["context"]["scores"], np.float32),
            np.asarray(a["context"]["scores"], np.float32), rtol=0, atol=1e-5,
        )
    assert r_sys.eval_retrieval() == t_sys.eval_retrieval()
