"""End to end, port vs reference: ``CFedRAGSystem.serve`` on the same
corpus, queries and (bridged) smoke-width weights, over the paged and the
contiguous engine; and the engines themselves (contiguous, paged,
lock-step) on the same prompts.

Prompts must be identical, dispatch counts equal, statuses and OOM
truncation flags equal, and answer tokens equal; a token may differ only
where the reference's top-2 logit margin at that step is under 1e-4
(a near-tie that float reassociation may flip).  Within the port, the
contiguous and paged engines give equal tokens for the same admission
order.  Smoke-width mamba2-1.3b (the ``ssm`` family) serves on the
contiguous engine and the lock-step baseline, held to the reference's the
same way; both packages refuse it on the paged engine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as r_get, smoke_config as r_smoke  # noqa: E402
from repro.core.pipeline import CFedRAGConfig as RConfig, CFedRAGSystem as RSystem  # noqa: E402
from repro.data.corpus import make_federated_corpus as r_corpus  # noqa: E402
from repro.data.tokenizer import PAD, HashTokenizer as RTok  # noqa: E402
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


def _ssm_margin(cfg, params, prompt, answer_prefix, width):
    """The reference's top-2 margin where the contiguous engine takes an
    SSM model's answer token ``len(answer_prefix)``: the first from the
    prompt's last position, the later ones after the PAD tail that the
    packed prefill (``width`` positions) folds into the state."""
    if len(answer_prefix):
        prompt = np.concatenate([prompt, np.full(width - len(prompt), PAD, np.int32), answer_prefix])
    return _margin(cfg, params, prompt, np.zeros(0, np.int32))


def _assert_same_tokens(cfg, params, prompt, want, got, width=None):
    """Equal, or first different where the reference's margin is a near-tie
    (``width``: the packed prefill width of an SSM model)."""
    want, got = np.asarray(want), np.asarray(got)
    if not np.array_equal(want, got):
        j = next((i for i in range(min(len(want), len(got))) if want[i] != got[i]), None)
        assert j is not None, (want, got)
        if width is None:
            margin = _margin(cfg, params, prompt, want[:j])
        else:
            margin = _ssm_margin(cfg, params, np.asarray(prompt), want[:j], width)
        assert margin < 1e-4, (want, got)


@pytest.mark.parametrize(
    "serve_kw",
    [
        dict(max_batch=3, token_budget=40, block_size=8),  # prompts chunk across steps
        dict(max_batch=3, block_size=8, n_pool_blocks=16),  # tight pool: OOM truncation
        dict(max_batch=3, paged=False),  # contiguous stripes, bucketed admit prefills
    ],
    ids=["chunked", "oom", "contiguous"],
)
def test_serve_matches_reference(bridged, serve_kw):
    cfg, tcfg, params, tparams = bridged
    scfg = dict(paged=True, max_prompt_len=96, max_new_tokens=12)
    scfg.update(serve_kw)
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
        _assert_same_tokens(cfg, params, a["prompt"], a["answer_tokens"], b["answer_tokens"])
    rs, ts = r_sys.last_serve_stats, t_sys.last_serve_stats
    for key in ("admit_dispatches", "mixed_dispatches", "decode_dispatches", "engine_steps", "n_truncated"):
        assert rs[key] == ts[key], key
    if "n_pool_blocks" in serve_kw:
        assert ts["n_truncated"] > 0  # the tight pool really truncated someone
    elif scfg["paged"]:
        assert ts["mixed_dispatches"] > 0 and ts["decode_dispatches"] > 0
    else:
        assert ts["admit_dispatches"] > 0 and ts["decode_dispatches"] > 0 and ts["mixed_dispatches"] == 0


_RAGGED = dict(lens=(9, 11, 6, 3, 11, 7), budgets=[5, 1, 4, 5, 2, 5],
               kw=dict(max_batch=2, max_prompt_len=11, max_new_tokens=5, sched_chunk=2))


@pytest.fixture(scope="module")
def ragged_reference(bridged):
    """The reference's contiguous engine on a ragged prompt / budget mix."""
    cfg, _, params, _ = bridged
    rng = np.random.default_rng(42)
    prompts = [rng.integers(8, VOCAB, size=n).astype(np.int32) for n in _RAGGED["lens"]]
    want = REngine(cfg, POL, params, RServe(**_RAGGED["kw"])).serve_prompts(prompts, max_new_tokens=_RAGGED["budgets"])
    return prompts, want


@pytest.mark.parametrize("block_size", [4, 8, 16])
def test_contiguous_matches_reference_and_paged(bridged, ragged_reference, block_size):
    """The port's contiguous engine gives the reference contiguous
    engine's tokens, and the port's paged engine gives the port's
    contiguous tokens exactly, for the same admission order
    (tests/test_serving.py ``test_paged_matches_contiguous_bitwise``)."""
    cfg, tcfg, params, tparams = bridged
    prompts, want = ragged_reference
    cont = TE.ServeEngine(tcfg, tparams, TE.ServeConfig(**_RAGGED["kw"]), device="cpu")
    got = cont.serve_prompts(prompts, max_new_tokens=_RAGGED["budgets"])
    paged = TE.ServeEngine(
        tcfg, tparams, TE.ServeConfig(paged=True, block_size=block_size, **_RAGGED["kw"]), device="cpu"
    ).serve_prompts(prompts, max_new_tokens=_RAGGED["budgets"])
    for p, w, g, pg in zip(prompts, want, got, paged):
        _assert_same_tokens(cfg, params, p, w, g)
        assert np.array_equal(g, pg), (g, pg)
    assert cont.admit_dispatches >= 2 and cont.admit_rows_total == len(prompts)


def test_lockstep_matches_reference(bridged):
    """``step_batch``: a ragged batch gives the reference's tokens, each row
    equals serving it alone (short rows never attend to PAD keys), and a
    queue of 5 drains as 2 + 2 + 1 (tests/test_serving.py)."""
    cfg, tcfg, params, tparams = bridged
    kw = dict(max_batch=3, max_prompt_len=16, max_new_tokens=4)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(8, VOCAB, size=n).astype(np.int32) for n in (10, 16, 13)]
    r_eng = REngine(cfg, POL, params, RServe(**kw))
    t_eng = TE.ServeEngine(tcfg, tparams, TE.ServeConfig(**kw), device="cpu")
    for p in prompts:
        r_eng.submit(p)
        t_eng.submit(p)
    want, got = r_eng.step_batch(), t_eng.step_batch()
    assert len(got) == 3 and t_eng.step_batch() == []
    for p, w, g in zip(prompts, want, got):
        _assert_same_tokens(cfg, params, p, w, g)
    solo = TE.ServeEngine(tcfg, tparams, TE.ServeConfig(**{**kw, "max_batch": 1}), device="cpu")
    for p, g in zip(prompts, got):
        solo.submit(p)
        s = solo.step_batch()[0]
        n = min(len(g), len(s))
        assert np.array_equal(g[:n], s[:n])
    small = TE.ServeEngine(tcfg, tparams, TE.ServeConfig(max_batch=2, max_prompt_len=8, max_new_tokens=2), device="cpu")
    for _ in range(5):
        small.submit(np.arange(1, 9, dtype=np.int32))
    sizes = []
    while small.queue:
        sizes.append(len(small.step_batch()))
    assert sizes == [2, 2, 1]


def test_lockstep_generator_serves_like_reference(bridged):
    """``engine_generator(mode="lockstep")`` behind ``CFedRAGSystem.serve``
    (which then answers through ``answer_batch``) gives the reference's
    prompts and answers."""
    cfg, tcfg, params, tparams = bridged
    kw = dict(n_facts=16, n_distractors=16, n_queries=4, seed=5)
    sys_kw = dict(aggregation="rerank", m_local=4, n_global=4, chunk_max_len=16)
    scfg = dict(max_batch=3, max_prompt_len=64, max_new_tokens=5)
    rtok, ttok = RTok(), TTok()
    r_sys = RSystem(r_corpus(**kw), RConfig(**sys_kw), tokenizer=rtok, reranker=r_rerank(rtok),
                    generator=r_gen(REngine(cfg, POL, params, RServe(**scfg)), mode="lockstep"))
    t_sys = TSystem(t_corpus(**kw), TConfig(device="cpu", **sys_kw), tokenizer=ttok,
                    reranker=t_launch.overlap_reranker(ttok),
                    generator=TE.engine_generator(TE.ServeEngine(tcfg, tparams, TE.ServeConfig(**scfg), device="cpu"),
                                                  mode="lockstep"))
    texts = [q.text for q in r_sys.corpus.queries]
    for a, b in zip(r_sys.serve(texts), t_sys.serve(texts)):
        assert np.array_equal(a["prompt"], b["prompt"])
        _assert_same_tokens(cfg, params, a["prompt"], a["answer_tokens"], b["answer_tokens"])


def test_contiguous_refuses_paged_only_options(bridged):
    _, tcfg, _, tparams = bridged
    with pytest.raises(ValueError, match="requires paged=True"):
        TE.ServeEngine(tcfg, tparams, TE.ServeConfig(token_budget=8), device="cpu")
    with pytest.raises(ValueError, match="mode"):
        TE.engine_generator(TE.ServeEngine(tcfg, tparams, TE.ServeConfig(), device="cpu"), mode="greedy")


@pytest.mark.parametrize(
    "override,exc,match",
    [
        (dict(prefix_cache=True, paged=False), ValueError, "requires paged"),
        (dict(spill_bytes=1 << 20), ValueError, "requires prefix_cache"),
        (dict(draft_k=2, paged=False), ValueError, "requires paged"),
        (dict(shards=2), NotImplementedError, "not ported"),
    ],
    ids=["prefix_cache", "spill", "draft_k", "shards"],
)
def test_unported_engine_options_raise(bridged, override, exc, match):
    """The sharded pool is not ported and raises; the prefix cache, its
    spill tier and speculative decoding are, and refuse what the reference
    refuses (tests/test_torch_prefix.py and tests/test_torch_spec_decode.py
    run them)."""
    _, tcfg, _, tparams = bridged
    scfg = TE.ServeConfig(**{"paged": True, **override})
    with pytest.raises(exc, match=match):
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
    assert "0 admit" in out and "KV blocks" in out  # --token-budget implies --paged


def test_launcher_generate_defaults_to_contiguous(capsys):
    """``--generate`` without ``--paged`` serves through the contiguous
    engine, as the reference's launcher does."""
    t_launch.main(["--queries", "3", "--n-facts", "16", "--generate", "--max-new-tokens", "3",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generation latency on cpu" in out and "recall@8" in out
    assert "2 admit + 1 decode + 0 mixed" in out and "KV blocks" not in out  # 3 admits: groups of 2 + 1


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


# ---------------- the ssm family: smoke-width mamba2-1.3b ----------------
@pytest.fixture(scope="module")
def bridged_mamba2():
    cfg = r_smoke(r_get("mamba2-1.3b")).with_overrides(dtype="float32", vocab_size=VOCAB)
    tcfg = t_smoke(t_get("mamba2-1.3b")).with_overrides(dtype="float32", vocab_size=VOCAB)
    params = r_init(RLM.param_specs(cfg), jax.random.PRNGKey(3))
    tparams = from_reference(TLM.param_specs(tcfg), jax.tree.map(np.asarray, params), device="cpu")
    return cfg, tcfg, params, tparams


def test_mamba2_contiguous_and_lockstep_match_reference(bridged_mamba2):
    """The contiguous engine (ragged prompts and budgets, bucketed admits
    over a 48-wide packed prefill: 3 SSD chunks of 16) and the lock-step
    baseline give the reference's tokens and dispatch counts."""
    cfg, tcfg, params, tparams = bridged_mamba2
    kw = dict(max_batch=2, max_prompt_len=48, max_new_tokens=5, sched_chunk=2)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(8, VOCAB, size=n).astype(np.int32) for n in (40, 17, 48, 5, 23)]
    budgets = [5, 2, 4, 5, 1]
    r_eng = REngine(cfg, POL, params, RServe(**kw))
    t_eng = TE.ServeEngine(tcfg, tparams, TE.ServeConfig(**kw), device="cpu")
    want = r_eng.serve_prompts(prompts, max_new_tokens=budgets)
    got = t_eng.serve_prompts(prompts, max_new_tokens=budgets)
    for p, w, g in zip(prompts, want, got):
        _assert_same_tokens(cfg, params, p, w, g, width=kw["max_prompt_len"])
    assert (r_eng.admit_dispatches, r_eng.decode_dispatches) == (t_eng.admit_dispatches, t_eng.decode_dispatches)
    assert t_eng.admit_dispatches >= 2
    r_lock, t_lock = r_gen(REngine(cfg, POL, params, RServe(**kw)), mode="lockstep"), TE.engine_generator(
        TE.ServeEngine(tcfg, tparams, TE.ServeConfig(**kw), device="cpu"), mode="lockstep")
    for p, w, g in zip(prompts, r_lock.generate_batch(prompts), t_lock.generate_batch(prompts)):
        _assert_same_tokens(cfg, params, p, w, g, width=kw["max_prompt_len"])


def test_mamba2_serve_matches_reference(bridged_mamba2):
    """``CFedRAGSystem.serve`` with the mamba2 engine: the reference's
    prompts, statuses, dispatch counts and answer tokens."""
    cfg, tcfg, params, tparams = bridged_mamba2
    scfg = dict(paged=False, max_batch=3, max_prompt_len=96, max_new_tokens=6)
    kw = dict(n_facts=16, n_distractors=16, n_queries=5, seed=2)
    sys_kw = dict(aggregation="rerank", m_local=4, n_global=4, chunk_max_len=16)
    rtok, ttok = RTok(), TTok()
    r_sys = RSystem(r_corpus(**kw), RConfig(**sys_kw), tokenizer=rtok, reranker=r_rerank(rtok),
                    generator=r_gen(REngine(cfg, POL, params, RServe(**scfg))))
    t_sys = TSystem(t_corpus(**kw), TConfig(device="cpu", **sys_kw), tokenizer=ttok,
                    reranker=t_launch.overlap_reranker(ttok),
                    generator=TE.engine_generator(TE.ServeEngine(tcfg, tparams, TE.ServeConfig(**scfg), device="cpu")))
    texts = [q.text for q in r_sys.corpus.queries]
    budgets = [6, 2, 6, 1, 4]
    for a, b in zip(r_sys.serve(texts, max_new_tokens=budgets), t_sys.serve(texts, max_new_tokens=budgets)):
        assert np.array_equal(a["prompt"], b["prompt"])
        assert a["status"] == b["status"] == "done"
        _assert_same_tokens(cfg, params, a["prompt"], a["answer_tokens"], b["answer_tokens"], width=96)
    rs, ts = r_sys.last_serve_stats, t_sys.last_serve_stats
    for key in ("admit_dispatches", "mixed_dispatches", "decode_dispatches", "engine_steps"):
        assert rs[key] == ts[key], key


def test_paged_ssm_raises_in_both_packages(bridged_mamba2):
    cfg, tcfg, params, tparams = bridged_mamba2
    with pytest.raises(ValueError, match="all-attention"):
        REngine(cfg, POL, params, RServe(paged=True))
    with pytest.raises(ValueError, match="all-attention"):
        TE.ServeEngine(tcfg, tparams, TE.ServeConfig(paged=True), device="cpu")
    with pytest.raises(ValueError, match="contiguous"):
        t_launch.full_width_system(1, "cpu", paged=True, arch="mamba2-1.3b")
