"""End to end, port vs reference: ``CFedRAGSystem.serve`` on the same
corpus, queries and (bridged) smoke-width weights.

Prompts must be identical, dispatch counts equal, statuses and OOM
truncation flags equal, and answer tokens equal; a token may differ only
where the reference's top-2 logit margin at that step is under 1e-4
(a near-tie that float reassociation may flip).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as r_get, smoke_config as r_smoke  # noqa: E402
from repro.core.pipeline import CFedRAGConfig as RConfig, CFedRAGSystem as RSystem  # noqa: E402
from repro.data.corpus import make_federated_corpus as r_corpus  # noqa: E402
from repro.data.tokenizer import HashTokenizer as RTok  # noqa: E402
from repro.launch.serve import overlap_reranker as r_rerank  # noqa: E402
from repro.models import lm as RLM  # noqa: E402
from repro.models.params import init_params as r_init  # noqa: E402
from repro.runtime.sharding import ShardingPolicy, base_rules  # noqa: E402
from repro.serving.engine import ServeConfig as RServe, ServeEngine as REngine  # noqa: E402
from repro.serving.engine import engine_generator as r_gen  # noqa: E402
from repro_torch.configs import get_config as t_get, smoke_config as t_smoke  # noqa: E402
from repro_torch.core.pipeline import CFedRAGConfig as TConfig, CFedRAGSystem as TSystem  # noqa: E402
from repro_torch.data.corpus import make_federated_corpus as t_corpus  # noqa: E402
from repro_torch.data.tokenizer import HashTokenizer as TTok  # noqa: E402
from repro_torch.launch import serve as t_launch  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models.params import from_reference  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving.scheduler import Scheduler  # noqa: E402

POL = ShardingPolicy(rules=base_rules(False), mesh=None)
VOCAB = 8192  # the HashTokenizer's: the model must cover every prompt id


@pytest.fixture(scope="module")
def bridged():
    cfg = r_smoke(r_get("qwen3-0.6b")).with_overrides(dtype="float32", vocab_size=VOCAB)
    tcfg = t_smoke(t_get("qwen3-0.6b")).with_overrides(dtype="float32", vocab_size=VOCAB)
    params = r_init(RLM.param_specs(cfg), jax.random.PRNGKey(0))
    tparams = from_reference(TLM.param_specs(tcfg), jax.tree.map(np.asarray, params), device="cpu")
    return cfg, tcfg, params, tparams


def _margin(cfg, params, prompt, answer_prefix):
    seq = np.concatenate([prompt, answer_prefix]).astype(np.int32)[None]
    logits, _ = RLM.forward(cfg, POL, params, {"tokens": jnp.asarray(seq)})
    top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
    return float(top2[1] - top2[0])


@pytest.mark.parametrize(
    "serve_kw",
    [
        dict(max_batch=3, token_budget=40, block_size=8),  # prompts chunk across steps
        dict(max_batch=3, block_size=8, n_pool_blocks=16),  # tight pool: OOM truncation
    ],
    ids=["chunked", "oom"],
)
def test_serve_matches_reference(bridged, serve_kw):
    cfg, tcfg, params, tparams = bridged
    scfg = dict(paged=True, max_prompt_len=96, max_new_tokens=12, **serve_kw)
    kw = dict(n_facts=24, n_distractors=24, n_queries=8, seed=11)
    rc, tc = r_corpus(**kw), t_corpus(**kw)
    rtok, ttok = RTok(), TTok()
    sys_kw = dict(aggregation="rerank", m_local=4, n_global=4, chunk_max_len=16)
    r_sys = RSystem(
        rc, RConfig(**sys_kw), tokenizer=rtok, reranker=r_rerank(rtok),
        generator=r_gen(REngine(cfg, POL, params, RServe(**scfg))),
    )
    t_sys = TSystem(
        tc, TConfig(device="cpu", **sys_kw), tokenizer=ttok, reranker=t_launch.overlap_reranker(ttok),
        generator=TE.engine_generator(TE.ServeEngine(tcfg, tparams, TE.ServeConfig(**scfg), device="cpu")),
    )
    texts = [q.text for q in rc.queries]
    budgets = [12, 3, 12, 1, 7, 12, 5, 12]
    r_out = r_sys.serve(texts, max_new_tokens=budgets)
    t_out = t_sys.serve(texts, max_new_tokens=budgets)
    for a, b in zip(r_out, t_out):
        assert np.array_equal(a["prompt"], b["prompt"])
        assert a["status"] == b["status"] == "done"
        assert a.get("truncated", False) == b.get("truncated", False)
        ra, ta = np.asarray(a["answer_tokens"]), np.asarray(b["answer_tokens"])
        if not np.array_equal(ra, ta):
            j = next(i for i in range(min(len(ra), len(ta))) if ra[i] != ta[i])
            assert _margin(cfg, params, a["prompt"], ra[:j]) < 1e-4, (ra, ta)
    rs, ts = r_sys.last_serve_stats, t_sys.last_serve_stats
    for key in ("mixed_dispatches", "decode_dispatches", "engine_steps", "n_truncated"):
        assert rs[key] == ts[key], key
    if "n_pool_blocks" in serve_kw:
        assert ts["n_truncated"] > 0  # the tight pool really truncated someone
    else:
        assert ts["mixed_dispatches"] > 0 and ts["decode_dispatches"] > 0


@pytest.mark.parametrize(
    "override",
    [dict(paged=False), dict(prefix_cache=True), dict(spill_bytes=1 << 20), dict(draft_k=2), dict(shards=2)],
    ids=["contiguous", "prefix_cache", "spill", "draft_k", "shards"],
)
def test_unported_engine_options_raise(bridged, override):
    _, tcfg, _, tparams = bridged
    scfg = TE.ServeConfig(**{"paged": True, **override})
    with pytest.raises(NotImplementedError, match="later|slice"):
        TE.ServeEngine(tcfg, tparams, scfg, device="cpu")


def test_admission_deadlock_is_typed():
    assert TE.resolve_fill_deps({0: frozenset(), 2: frozenset({7})}, {7}) == [0]
    with pytest.raises(TE.AdmissionDeadlock) as exc:
        TE.resolve_fill_deps({1: frozenset({5}), 3: frozenset({6})}, {5, 6})
    assert exc.value.stuck == [1, 3]


def test_engine_serves_repeat_calls_and_streams(bridged):
    """The pool is resident across serve calls; serve_stream yields every
    request once; the engine leaves no block allocated."""
    _, tcfg, _, tparams = bridged
    eng = TE.ServeEngine(tcfg, tparams, TE.ServeConfig(paged=True, max_batch=2, max_prompt_len=32,
                                                       max_new_tokens=4, block_size=4), device="cpu")
    prompts = [np.arange(1, 1 + n, dtype=np.int32) + 100 for n in (5, 9, 3)]
    first = eng.serve_prompts(prompts)
    assert [len(a) for a in first] == [4, 4, 4]
    sched = Scheduler()
    rids = sched.submit_many(prompts)
    streamed = dict(eng.serve_stream(sched, drain=True))
    assert sorted(streamed) == sorted(rids)
    assert all(np.array_equal(streamed[r], a) for r, a in zip(rids, first))
    assert eng._pool.free_blocks == eng._n_pool_blocks


def test_launcher_main_runs_on_cpu(capsys):
    t_launch.main(["--queries", "3", "--n-facts", "16", "--generate", "--max-new-tokens", "3",
                   "--device", "cpu", "--token-budget", "48", "--block-size", "16"])
    out = capsys.readouterr().out
    assert "generation latency on cpu" in out and "recall@8" in out


def test_full_width_system_federation_matches_reference():
    """The configuration measured on the card, without its model: the
    same corpus gives the same contexts as the reference built likewise."""
    sys_, engine, texts = t_launch.full_width_system(4, "cpu", seed=0, generate=False)
    assert engine is None and len(texts) == 4
    rtok = RTok()
    r_sys = RSystem(r_corpus(n_facts=128, n_distractors=128, n_queries=4, seed=0), RConfig(),
                    tokenizer=rtok, reranker=r_rerank(rtok))
    assert texts == [q.text for q in r_sys.corpus.queries[:4]]
    ro, to = r_sys.orchestrator, sys_.orchestrator
    ref = ro.aggregate_batch(texts, ro.collect_contexts_batch(texts))
    got = to.aggregate_batch(texts, to.collect_contexts_batch(texts))
    assert [list(c["chunk_ids"]) for c in got] == [list(c["chunk_ids"]) for c in ref]


def test_cuda_default_without_card_raises(bridged):
    """Every entry point defaults to ``device="cuda"`` and refuses to run
    without a card rather than quietly using the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg, _, tparams = bridged
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.ServeEngine(tcfg, tparams, TE.ServeConfig(paged=True))
    corpus = t_corpus(n_facts=4, n_distractors=4, n_queries=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSystem(corpus)  # CFedRAGConfig.device defaults to "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_launch.main(["--queries", "1", "--n-facts", "4"])
