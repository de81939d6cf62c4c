"""The paper's retrieval models in the port against the reference: the
Contriever-style dual encoder (F_emb, ``encode``) and the
bge-reranker-style cross encoder (F_aggr, ``score_pairs`` and
``make_reranker``), with the reference's own weights carried over by
``params.from_reference``, at smoke width with the tokenizer's 8192-id
vocabulary (the smoke config's 256 would index past the embedding table).

The reference runs its attention both through its Pallas kernel
(``attn_impl="pallas"``, interpret mode on the CPU) and through its
materialised oracle (``"naive"``); the port's attention is its
``flash_attention`` (plain version on the CPU) either way.  Tolerance
1e-5 in f32: the same sums in another order.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as r_get, smoke_config as r_smoke  # noqa: E402
from repro.core.pipeline import CFedRAGConfig as RConfig, CFedRAGSystem as RSystem  # noqa: E402
from repro.data.corpus import make_federated_corpus as r_corpus  # noqa: E402
from repro.data.tokenizer import HashTokenizer as RTok  # noqa: E402
from repro.models import cross_encoder as RCE  # noqa: E402
from repro.models import dual_encoder as RDE  # noqa: E402
from repro.models.params import init_params as r_init  # noqa: E402
from repro.runtime.sharding import ShardingPolicy, base_rules  # noqa: E402
from repro_torch.configs import get_config as t_get, smoke_config as t_smoke  # noqa: E402
from repro_torch.core.pipeline import CFedRAGConfig as TConfig, CFedRAGSystem as TSystem  # noqa: E402
from repro_torch.data.corpus import make_federated_corpus as t_corpus  # noqa: E402
from repro_torch.data.tokenizer import HashTokenizer as TTok  # noqa: E402
from repro_torch.launch import serve as t_launch  # noqa: E402
from repro_torch.models import cross_encoder as TCE  # noqa: E402
from repro_torch.models import dual_encoder as TDE  # noqa: E402
from repro_torch.models.params import from_reference, leaves  # noqa: E402

POL = ShardingPolicy(rules=base_rules(False), mesh=None)
VOCAB = 8192  # the HashTokenizer's
T = torch.as_tensor


def _bridged(name, mod_r, mod_t, attn_impl, key=0):
    cfg = r_smoke(r_get(name)).with_overrides(dtype="float32", vocab_size=VOCAB, attn_impl=attn_impl)
    tcfg = t_smoke(t_get(name)).with_overrides(dtype="float32", vocab_size=VOCAB)
    params = r_init(mod_r.param_specs(cfg), jax.random.PRNGKey(key))
    tparams = from_reference(mod_t.param_specs(tcfg), jax.tree.map(np.asarray, params), device="cpu")
    return cfg, tcfg, params, tparams


def _tokens(rng, b, s, n_pad):
    """Random ids with a PAD tail on some rows, as the tokenizer pads."""
    tok = rng.integers(8, VOCAB, size=(b, s)).astype(np.int32)
    for i in range(b):
        if i % 2:
            tok[i, s - n_pad :] = 0
    return tok


@pytest.mark.parametrize("name,mod", [("contriever-110m", "dual"), ("bge-reranker-base", "cross")])
def test_encoder_param_specs_match_reference_tree(name, mod):
    r_mod, t_mod = (RDE, TDE) if mod == "dual" else (RCE, TCE)
    r_specs = r_mod.param_specs(r_smoke(r_get(name)))
    t_specs = t_mod.param_specs(t_smoke(t_get(name)))
    flat = jax.tree_util.tree_flatten_with_path(r_specs, is_leaf=lambda x: hasattr(x, "fan_in_dims"))[0]
    r_map = {"/".join(p.key for p in path): (s.shape, s.init, s.fan_in_dims) for path, s in flat}
    assert r_map == {p: (s.shape, s.init, s.fan_in_dims) for p, s in leaves(t_specs)}


@pytest.mark.parametrize("attn_impl", ["pallas", "naive"])
@pytest.mark.parametrize("b,s", [(3, 24), (4, 40)])
def test_dual_encoder_encode_matches_reference(attn_impl, b, s):
    cfg, tcfg, params, tparams = _bridged("contriever-110m", RDE, TDE, attn_impl)
    tok = _tokens(np.random.default_rng(b * s), b, s, n_pad=s // 3)
    want = np.asarray(RDE.encode(cfg, POL, params, jax.numpy.asarray(tok)))
    got = TDE.encode(tcfg, tparams, T(tok))
    assert got.dtype == torch.float32 and got.shape == (b, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0, rtol=0, atol=1e-5)


@pytest.mark.parametrize("attn_impl", ["pallas", "naive"])
def test_cross_encoder_score_pairs_matches_reference(attn_impl):
    cfg, tcfg, params, tparams = _bridged("bge-reranker-base", RCE, TCE, attn_impl, key=1)
    rng = np.random.default_rng(5)
    tok = _tokens(rng, 5, 64, n_pad=20)
    types = np.zeros_like(tok)
    types[:, 10:] = 1
    want = np.asarray(RCE.score_pairs(cfg, POL, params, jax.numpy.asarray(tok), jax.numpy.asarray(types)))
    got = TCE.score_pairs(tcfg, tparams, T(tok), T(types))
    assert got.shape == (5,) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_reranker_batched_matches_per_query_and_reference():
    """One flattened (B*C, S) pass scores as the per-query calls do, and
    both match the reference's reranker on the same packed pairs."""
    cfg, tcfg, params, tparams = _bridged("bge-reranker-base", RCE, TCE, "naive", key=2)
    rerank = TCE.make_reranker(tcfg, tparams, max_len=48)
    r_rerank = RCE.make_reranker(cfg, POL, params, max_len=48)
    assert rerank.supports_batch
    tk = TTok()
    texts = ["what is attr3 of entity7", "what is attr1 of entity2"]
    docs = [["entity7 attr3 is value12 and more", "entity9 attr1 is value4"],
            ["entity2 attr1 is value8", "something else entirely here", "entity2 is short"]]
    q_tok = np.stack([tk.encode(t, max_len=24) for t in texts])
    cands = np.zeros((2, 3, 40), np.int32)
    for i, ds in enumerate(docs):
        for j, d in enumerate(ds):
            cands[i, j] = tk.encode(d, max_len=40)
    batched = rerank(q_tok, cands)
    assert batched.shape == (2, 3) and batched.dtype == np.float32
    for i in range(2):
        np.testing.assert_allclose(rerank(q_tok[i], cands[i]), batched[i], rtol=0, atol=1e-5)
        np.testing.assert_allclose(batched[i], np.asarray(r_rerank(q_tok[i], cands[i])), rtol=0, atol=1e-5)
    np.testing.assert_allclose(batched, np.asarray(r_rerank(q_tok, cands)), rtol=0, atol=1e-5)


def test_system_with_encoders_matches_reference():
    """C-FedRAG with the paper's models at smoke width: the dual encoder as
    every provider's embed_fn and the cross encoder as the reranker give
    the reference's contexts (chunk ids, scores) on the same corpus."""
    e_cfg, e_tcfg, e_params, e_tparams = _bridged("contriever-110m", RDE, TDE, "naive", key=3)
    r_cfg, r_tcfg, r_params, r_tparams = _bridged("bge-reranker-base", RCE, TCE, "naive", key=4)
    kw = dict(n_facts=24, n_distractors=24, n_queries=8, seed=7)
    sys_kw = dict(aggregation="rerank", m_local=4, n_global=4, chunk_max_len=24)
    rtok, ttok = RTok(), TTok()
    r_sys = RSystem(
        r_corpus(**kw), RConfig(**sys_kw), tokenizer=rtok,
        embed_fn=lambda t: RDE.encode(e_cfg, POL, e_params, jax.numpy.asarray(t)),
        reranker=RCE.make_reranker(r_cfg, POL, r_params),
    )
    t_sys = TSystem(
        t_corpus(**kw), TConfig(device="cpu", **sys_kw), tokenizer=ttok,
        embed_fn=lambda t: TDE.encode(e_tcfg, e_tparams, T(np.asarray(t))),
        reranker=TCE.make_reranker(r_tcfg, r_tparams),
    )
    texts = [q.text for q in r_sys.corpus.queries]
    r_out, t_out = r_sys.answer_batch(texts), t_sys.answer_batch(texts)
    for a, b in zip(r_out, t_out):
        assert list(a["context"]["chunk_ids"]) == list(b["context"]["chunk_ids"])
        np.testing.assert_allclose(
            np.asarray(b["context"]["scores"], np.float32),
            np.asarray(a["context"]["scores"], np.float32), rtol=0, atol=1e-5,
        )


def test_paper_models_system_builder(monkeypatch):
    """``launch.serve.paper_models_system`` wires the dual encoder into
    every provider and the cross encoder into the orchestrator; run here
    with the configs cut to smoke width (the full width runs on the card)."""
    monkeypatch.setattr(
        t_launch, "get_config", lambda name: t_smoke(t_get(name)).with_overrides(vocab_size=VOCAB)
    )
    sys_, engine, texts = t_launch.paper_models_system(4, "cpu", seed=0, generate=False, encoder_dtype="float32")
    assert engine is None and len(texts) == 4
    emb = sys_.providers[0].embeddings
    assert emb.shape[1] == 64 and bool(torch.isfinite(emb).all())  # smoke d_model, not bag_embed's 256
    out = sys_.answer_batch(texts)
    assert all(len(o["context"]["chunk_ids"]) == 8 for o in out)
    # a rebuild from the same seed gives the same contexts
    again = t_launch.paper_models_system(4, "cpu", seed=0, generate=False, encoder_dtype="float32")[0]
    assert [list(o["context"]["chunk_ids"]) for o in again.answer_batch(texts)] == [
        list(o["context"]["chunk_ids"]) for o in out
    ]
