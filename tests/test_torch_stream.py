"""The port's pipelined front door, ``CFedRAGSystem.serve_stream``, and the
launcher's serving flags, against the reference and within the port
(tests/test_streaming.py's contracts).

Within the port: ``serve_stream`` ≡ ``serve`` per query (prompt, context
and answer tokens), on the contiguous and on the paged engine with its
prefix cache; one result per query, with a quorum-degraded micro-batch
and an expired request among them; a collector error reaches the caller;
an abandoned stream stops and joins its collector.  Against the
reference: the streamed prompts equal, the tokens equal under the top-2
margin rule, and ``parse_tenant_spec`` equal on good and bad specs.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as r_get, smoke_config as r_smoke  # noqa: E402
from repro.core.pipeline import CFedRAGConfig as RConfig, CFedRAGSystem as RSystem  # noqa: E402
from repro.data.corpus import make_federated_corpus as r_corpus  # noqa: E402
from repro.data.tokenizer import HashTokenizer as RTok  # noqa: E402
from repro.launch import serve as r_launch  # noqa: E402
from repro.models import lm as RLM  # noqa: E402
from repro.models.params import init_params as r_init  # noqa: E402
from repro.runtime.sharding import ShardingPolicy, base_rules  # noqa: E402
from repro.serving.engine import ServeConfig as RServe, ServeEngine as REngine  # noqa: E402
from repro.serving.engine import engine_generator as r_gen  # noqa: E402
from repro_torch.configs import get_config as t_get, smoke_config as t_smoke  # noqa: E402
from repro_torch.core.pipeline import CFedRAGConfig as TConfig, CFedRAGSystem as TSystem  # noqa: E402
from repro_torch.core.resilience import QuorumNotMet  # noqa: E402
from repro_torch.data.corpus import make_federated_corpus as t_corpus  # noqa: E402
from repro_torch.data.tokenizer import HashTokenizer as TTok  # noqa: E402
from repro_torch.launch import serve as t_launch  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models.params import from_reference  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402

POL = ShardingPolicy(rules=base_rules(False), mesh=None)
VOCAB = 8192
CORPUS = dict(n_facts=24, n_distractors=24, n_queries=8, seed=11)
SYS = dict(aggregation="rerank", m_local=4, n_global=4, chunk_max_len=16)
SERVE = dict(max_batch=2, max_prompt_len=128, max_new_tokens=4, sched_chunk=2)


@pytest.fixture(scope="module")
def bridged():
    cfg = r_smoke(r_get("qwen3-0.6b")).with_overrides(dtype="float32", vocab_size=VOCAB)
    tcfg = t_smoke(t_get("qwen3-0.6b")).with_overrides(dtype="float32", vocab_size=VOCAB)
    params = r_init(RLM.param_specs(cfg), jax.random.PRNGKey(0))
    tparams = from_reference(TLM.param_specs(tcfg), jax.tree.map(np.asarray, params), device="cpu")
    return cfg, tcfg, params, tparams


def _port_system(bridged, **serve_kw):
    _, tcfg, _, tparams = bridged
    tok = TTok()
    eng = TE.ServeEngine(tcfg, tparams, TE.ServeConfig(**{**SERVE, **serve_kw}), device="cpu")
    return TSystem(t_corpus(**CORPUS), TConfig(device="cpu", **SYS), tokenizer=tok,
                   reranker=t_launch.overlap_reranker(tok), generator=TE.engine_generator(eng))


def _margin(cfg, params, prompt, answer_prefix):
    seq = np.concatenate([prompt, answer_prefix]).astype(np.int32)[None]
    logits, _ = RLM.forward(cfg, POL, params, {"tokens": jnp.asarray(seq)})
    top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
    return float(top2[1] - top2[0])


def _assert_same_result(a, b):
    assert a["status"] == b["status"] == "done"
    assert np.array_equal(a["prompt"], b["prompt"])
    assert np.array_equal(a["answer_tokens"], b["answer_tokens"])
    for k in ("chunk_tokens", "chunk_ids", "scores", "providers"):
        assert np.array_equal(a["context"][k], b["context"][k])


@pytest.mark.parametrize(
    "serve_kw", [dict(), dict(paged=True, prefix_cache=True, block_size=16, token_budget=64)],
    ids=["contiguous", "paged-prefix"],
)
def test_serve_stream_matches_serve(bridged, serve_kw):
    sys_ = _port_system(bridged, **serve_kw)
    texts = [q.text for q in sys_.corpus.queries[:5]]  # uneven micro-batches
    barrier = sys_.serve(texts, max_new_tokens=4)
    streamed, seen = [None] * len(texts), []
    for qidx, out in sys_.serve_stream(texts, max_new_tokens=4, collect_batch=3):
        seen.append(qidx)
        streamed[qidx] = out
    assert sorted(seen) == list(range(len(texts))), "each query yields exactly once"
    for a, b in zip(barrier, streamed):
        _assert_same_result(a, b)
        assert b["latency_s"] is not None and b["latency_s"] > 0
    st = sys_.last_serve_stats
    assert st["n_done"] == len(texts) and "federation" in st


def test_serve_stream_matches_reference(bridged):
    """The same queries through both packages' pipelined front doors."""
    cfg, _, params, _ = bridged
    rtok = RTok()
    r_sys = RSystem(r_corpus(**CORPUS), RConfig(**SYS), tokenizer=rtok, reranker=r_launch.overlap_reranker(rtok),
                    generator=r_gen(REngine(cfg, POL, params, RServe(**SERVE))))
    t_sys = _port_system(bridged)
    texts = [q.text for q in r_sys.corpus.queries[:5]]
    want = dict(r_sys.serve_stream(texts, max_new_tokens=4, collect_batch=3))
    got = dict(t_sys.serve_stream(texts, max_new_tokens=4, collect_batch=3))
    assert sorted(got) == sorted(want) == list(range(len(texts)))
    for i in range(len(texts)):
        a, b = want[i], got[i]
        assert np.array_equal(a["prompt"], b["prompt"])
        assert list(a["context"]["chunk_ids"]) == list(b["context"]["chunk_ids"])
        w, g = np.asarray(a["answer_tokens"]), np.asarray(b["answer_tokens"])
        if not np.array_equal(w, g):
            j = next(k for k in range(min(len(w), len(g))) if w[k] != g[k])
            assert _margin(cfg, params, np.asarray(a["prompt"]), w[:j]) < 1e-4, (w, g)


def test_serve_stream_one_result_per_query_with_degraded_and_expired(bridged):
    """A micro-batch whose collect misses quorum yields flagged ``degraded``
    results, an expired request yields ``expired``, the rest are served:
    every query exactly once."""
    sys_ = _port_system(bridged)
    orch = sys_.orchestrator
    texts = [q.text for q in sys_.corpus.queries[:6]]
    real_collect, calls = orch.collect_contexts_batch, [0]

    def collect(chunk):
        calls[0] += 1
        if calls[0] == 2:
            raise QuorumNotMet(0, 1)
        return real_collect(chunk)

    orch.collect_contexts_batch = collect
    deadlines = [None, 0.0, None, None, None, None]  # query 1 expires before admission
    got = {}
    for qidx, out in sys_.serve_stream(texts, max_new_tokens=3, gen_deadline_s=deadlines, collect_batch=2):
        assert qidx not in got, f"query {qidx} yielded twice"
        got[qidx] = out
    assert sorted(got) == list(range(6))
    assert got[2]["status"] == got[3]["status"] == "degraded" and got[2]["degraded"]
    assert got[1]["status"] == "expired" and "answer_tokens" not in got[1]
    for i in (0, 4, 5):
        assert got[i]["status"] == "done" and len(got[i]["answer_tokens"]) >= 1
    assert sys_.last_serve_stats["n_expired"] == 1


def test_serve_stream_raises_collector_error_and_joins(bridged):
    sys_ = _port_system(bridged)
    orch = sys_.orchestrator
    texts = [q.text for q in sys_.corpus.queries[:6]]
    real_aggregate, calls = orch.aggregate_batch, [0]

    def aggregate(chunk, responses):
        calls[0] += 1
        if calls[0] == 2:
            raise KeyError("aggregation failed")
        return real_aggregate(chunk, responses)

    orch.aggregate_batch = aggregate
    before = threading.active_count()
    seen = []
    with pytest.raises(KeyError, match="aggregation failed"):
        for qidx, _ in sys_.serve_stream(texts, max_new_tokens=2, collect_batch=2):
            seen.append(qidx)
    assert sorted(seen) == [0, 1]  # the first micro-batch was still served
    assert threading.active_count() == before


def test_abandoned_serve_stream_joins_its_collector(bridged):
    sys_ = _port_system(bridged, paged=True, prefix_cache=True, block_size=16)
    texts = [q.text for q in sys_.corpus.queries[:4]]
    before = threading.active_count()
    stream = sys_.serve_stream(texts, max_new_tokens=4, collect_batch=2)
    next(stream)
    stream.close()
    assert threading.active_count() == before
    engine = sys_.orchestrator.generator.engine
    assert not engine._serving and engine._pool.used_blocks == 0
    # the resident engine serves again, and gives serve's answers
    again = sys_.serve(texts, max_new_tokens=4)
    assert all(r["status"] == "done" for r in again)


@pytest.mark.timing
def test_serve_stream_latency_covers_collect(bridged):
    sys_ = _port_system(bridged)
    texts = [q.text for q in sys_.corpus.queries[:2]]
    delay = 0.15
    for p in sys_.providers:
        p.delay_s = delay
    outs = dict(sys_.serve_stream(texts, max_new_tokens=2, collect_batch=2))
    assert len(outs) == 2
    for out in outs.values():
        assert out["latency_s"] >= delay, f"latency_s={out['latency_s']:.3f}s must cover the {delay}s collect"


@pytest.mark.parametrize(
    "spec", ["interactive=4:1,batch=1", " a=2 , b=0.5:3 ,", "solo=1", "x=1:2,x=3", "", ",,", "noeq", "=3", "a=x"],
)
def test_parse_tenant_spec_matches_reference(spec):
    try:
        want = r_launch.parse_tenant_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            t_launch.parse_tenant_spec(spec)
        assert str(got.value) == str(e)
        return
    assert t_launch.parse_tenant_spec(spec) == want


def test_launcher_prefix_cache_repeat_on_cpu(capsys):
    t_launch.main(["--queries", "4", "--n-facts", "16", "--max-new-tokens", "3", "--device", "cpu",
                   "--prefix-cache", "--repeat", "2", "--block-size", "16", "--spill-mb", "64"])
    out = capsys.readouterr().out
    assert "repeat 1/2: prefix hits" in out
    assert "repeat 2/2: prefix hits 4/4 (100%)" in out
    assert "prefix cache: 4/4 hits" in out and "spill tier:" in out and "recall@8" in out


def test_launcher_stream_with_tenants_on_cpu(capsys):
    t_launch.main(["--queries", "5", "--n-facts", "16", "--max-new-tokens", "3", "--device", "cpu",
                   "--stream", "--collect-batch", "2", "--tenants", "interactive=4:1,batch=1"])
    out = capsys.readouterr().out
    assert out.count("[stream] q") == 5 and "status=done" in out
    assert "tenant interactive: 3 done" in out and "tenant batch: 2 done" in out
    assert "generation latency on cpu" in out and "recall@8" in out
