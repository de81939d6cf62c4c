"""Speculative decoding in the port's paged engine, against the reference.

``accept_prefix`` is held to the reference's as integers over random
draft / target streams and caps.  A torch twin of ``tests/_fake_lm.py``
(next token ``(cur + offset) % 256``, ``offset`` from the params) drives
the engine's control flow: ``draft_k=0`` is byte-identical to the plain
engine, a divergent drafter accepts nothing and changes no token, a round
costs at most two dispatches, and the speculation gauges equal the
reference engine's on the same workload, as integers.  On smoke-width
qwen3-0.6b (the reference's weights through ``from_reference``), spec is
token-exact against plain within the port at block sizes 4/8/16, with
the prefix cache, and with a smaller drafter of its own; the port's spec
tokens equal the reference's spec tokens, or differ first where the
reference's top-2 logit margin is under 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _fake_lm import expected_answer, make_fake_engine as r_make_fake_engine, prompt_ending  # noqa: E402
from repro.configs import get_config as r_get, smoke_config as r_smoke  # noqa: E402
from repro.data.tokenizer import EOS  # noqa: E402
from repro.models import lm as RLM  # noqa: E402
from repro.models.params import init_params as r_init  # noqa: E402
from repro.runtime.sharding import ShardingPolicy, base_rules  # noqa: E402
from repro.serving.engine import ServeConfig as RServe, ServeEngine as REngine  # noqa: E402
from repro.serving.engine import accept_prefix as r_accept_prefix  # noqa: E402
from repro.serving.scheduler import Scheduler as RScheduler  # noqa: E402
from repro_torch.configs import get_config as t_get, smoke_config as t_smoke  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models.params import from_reference, init_params  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving.scheduler import Scheduler  # noqa: E402

POL = ShardingPolicy(rules=base_rules(False), mesh=None)
VOCAB = 256


class FakeLM:
    """The port's twin of ``tests/_fake_lm.FakeLM``: the next token is
    ``(cur + offset) % 256`` with ``offset`` from the params (default 1),
    whatever the position, so every answer is known in closed form.  The
    surface is ``repro_torch.models.lm``'s, ``verify_step`` included; the
    caches carry nothing but keep the nested per-position layout."""

    @staticmethod
    def _offset(params):
        return params.get("offset", 1) if isinstance(params, dict) else 1

    @staticmethod
    def _logits(tokens, params):
        nxt = (tokens.long() + FakeLM._offset(params)) % VOCAB
        return torch.eye(VOCAB, dtype=torch.float32, device=tokens.device)[nxt]

    @staticmethod
    def init_cache(cfg, batch, cache_len, dtype=torch.float32, device="cpu"):
        return {"pos0": {"dummy": torch.zeros((1, batch, 1), dtype=torch.float32, device=device)}}

    @staticmethod
    def init_paged_cache(cfg, n_pool_blocks, block_size, dtype=torch.float32, device="cpu"):
        return {"pos0": {"dummy": torch.zeros((1, n_pool_blocks, 1), dtype=torch.float32, device=device)}}

    @staticmethod
    def paged_copy_block(cfg, cache, src, dst):
        return cache

    @staticmethod
    def prefill(cfg, params, batch, cache_len=None):
        tokens = batch["tokens"]
        return FakeLM._logits(tokens, params), FakeLM.init_cache(cfg, tokens.shape[0], cache_len, device=tokens.device)

    @staticmethod
    def decode_step(cfg, params, cache, tokens, pos, block_tables=None, block_size=0):
        return FakeLM._logits(tokens, params)

    @staticmethod
    def mixed_step(cfg, params, tokens, cache, block_tables, q_start, q_len, block_size):
        return FakeLM._logits(tokens, params)

    @staticmethod
    def verify_step(cfg, params, tokens, cache, block_tables, q_start, q_len, block_size):
        return FakeLM.mixed_step(cfg, params, tokens, cache, block_tables, q_start, q_len, block_size)


def make_fake_engine(monkeypatch, max_batch=2, max_new_tokens=6, sched_chunk=3, **scfg_kw):
    """The port's ServeEngine over FakeLM (patched in for the model module)
    with the smoke config's 256-token vocabulary, on the CPU."""
    monkeypatch.setattr(TE, "LM", FakeLM)
    cfg = t_smoke(t_get("qwen3-0.6b")).with_overrides(dtype="float32")
    assert cfg.vocab_size == VOCAB
    return TE.ServeEngine(
        cfg, {}, TE.ServeConfig(max_batch=max_batch, max_prompt_len=8, max_new_tokens=max_new_tokens,
                                sched_chunk=sched_chunk, **scfg_kw),
        device="cpu",
    )


# --------------------------------------------------------------------- #
# accept_prefix
# --------------------------------------------------------------------- #


def _streams(rng, k, rows=6, alphabet=5):
    """Draft / target streams over a tiny alphabet (EOS = 2 occurs), each
    row with a planted match prefix so every LCP length turns up."""
    t = rng.integers(0, alphabet, size=(rows, k + 1)).astype(np.int32)
    d = rng.integers(0, alphabet, size=(rows, k)).astype(np.int32)
    for r in range(rows):
        m = int(rng.integers(0, k + 1))
        d[r, :m] = t[r, :m]
    return d, t


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("caps", [False, True], ids=["uncapped", "capped"])
def test_accept_prefix_matches_reference(k, caps):
    rng = np.random.default_rng(k + 10 * caps)
    for _ in range(40):
        d, t = _streams(rng, k)
        rows = d.shape[0]
        kw = {}
        if caps:
            kw = dict(q_len=rng.integers(0, k + 2, size=rows).astype(np.int32),
                      rem=rng.integers(0, k + 3, size=rows).astype(np.int32),
                      done=rng.random(rows) < 0.3)
        n_r, can_r = r_accept_prefix(d, t, **kw)
        n_t, can_t = TE.accept_prefix(torch.as_tensor(d), torch.as_tensor(t),
                                      **{key: torch.as_tensor(v) for key, v in kw.items()})
        assert n_t.dtype == torch.int32
        np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_r))
        np.testing.assert_array_equal(can_t.numpy(), np.asarray(can_r))
        for r in range(rows):  # the committed lanes are a run from lane 0
            n = int(n_t[r])
            assert can_t[r, :n].all() and not can_t[r, n:].any()
            assert EOS not in t[r, : max(n - 1, 0)]


# --------------------------------------------------------------------- #
# the engine's control flow, on FakeLM
# --------------------------------------------------------------------- #

FAKE_KW = dict(max_batch=3, max_new_tokens=6, sched_chunk=2, paged=True, block_size=4, token_budget=6)
ENDS = [250, 0, 10, 253, 99, 30]
BUDGETS = [6, 3, 2, 6, 1, 4]


def _run_fake(engine, sched_cls=Scheduler, ends=ENDS, budgets=BUDGETS):
    sched = sched_cls()
    rids = sched.submit_many([prompt_ending(e) for e in ends], budgets)
    res = engine.serve(sched)
    return sched, [np.asarray(res[r]) for r in rids]


def test_draft_k_zero_is_byte_identical_to_plain(monkeypatch):
    eng0 = make_fake_engine(monkeypatch, draft_k=0, **FAKE_KW)
    sched0, outs0 = _run_fake(eng0)
    for e, b, got in zip(ENDS, BUDGETS, outs0):
        assert list(got) == expected_answer(e, b)
    assert eng0.draft_dispatches == 0 and eng0.spec_rounds == 0
    assert eng0._draft_pool is None, "draft_k=0 allocates no drafter pool"
    assert "spec_accept_rate" not in sched0.latency_stats()
    _, outs3 = _run_fake(make_fake_engine(monkeypatch, draft_k=3, **FAKE_KW))
    for a, b in zip(outs0, outs3):
        assert a.tobytes() == b.tobytes()


def test_divergent_drafter_accepts_nothing_and_changes_no_token(monkeypatch):
    eng = make_fake_engine(monkeypatch, draft_k=3, draft_params={"offset": 2}, **FAKE_KW)
    sched, outs = _run_fake(eng)
    for e, b, got in zip(ENDS, BUDGETS, outs):
        assert list(got) == expected_answer(e, b), f"end={e} budget={b}"
    assert eng.spec_tokens_proposed > 0 and eng.spec_tokens_accepted == 0
    st = sched.latency_stats()
    assert st["spec_accept_rate"] == 0.0
    assert st["spec_tokens_per_round"] >= 1.0  # each verify row emits its correction token


def test_spec_round_costs_at_most_two_dispatches(monkeypatch):
    eng = make_fake_engine(monkeypatch, max_batch=4, max_new_tokens=6, sched_chunk=2, paged=True,
                           block_size=4, token_budget=8, draft_k=3)
    ends = [250, 10, 99, 30, 200, 1]
    sched, outs = _run_fake(eng, ends=ends, budgets=[6] * len(ends))
    for e, got in zip(ends, outs):
        assert list(got) == expected_answer(e, 6)
    assert eng.decode_dispatches == 0 and eng.admit_dispatches == 0
    assert 0 < eng.spec_rounds and eng.draft_dispatches <= eng.spec_rounds
    st = sched.latency_stats()
    assert st["dispatches_per_spec_round"] <= 2.0
    assert st["spec_tokens_per_round"] > 1.0
    assert st["spec_accept_rate"] > 0.5
    assert st["engine_steps"] == st["mixed_dispatches"] + st["decode_dispatches"]
    assert st["dispatches_per_step"] == 1.0
    assert eng._draft_pool.free_blocks == eng._n_pool_blocks, "every drafter block released"
    assert st["min_draft_free_blocks"] < eng._n_pool_blocks


GAUGES = ("mixed_dispatches", "decode_dispatches", "draft_dispatches", "draft_fill_dispatches", "spec_rounds",
          "spec_tokens_proposed", "spec_tokens_accepted", "spec_tokens_emitted")


@pytest.mark.parametrize(
    "kw",
    [
        dict(FAKE_KW, draft_k=3),
        dict(FAKE_KW, draft_k=2, draft_params={"offset": 2}),
        dict(FAKE_KW, draft_k=3, n_pool_blocks=6),  # a tight pool: both pools run dry, rows truncate
        dict(max_batch=4, max_new_tokens=6, sched_chunk=2, paged=True, block_size=4, token_budget=8, draft_k=3),
    ],
    ids=["self", "divergent", "tight_pool", "budget8"],
)
def test_spec_gauges_equal_the_reference(monkeypatch, kw):
    """The same FakeLM workload through both packages' engines: the same
    tokens, statuses and speculation gauges, as integers."""
    r_eng = r_make_fake_engine(monkeypatch, **kw)
    t_eng = make_fake_engine(monkeypatch, **kw)
    r_sched, r_outs = _run_fake(r_eng, RScheduler)
    t_sched, t_outs = _run_fake(t_eng)
    for a, b in zip(r_outs, t_outs):
        assert list(a) == list(b)
    for g in GAUGES:
        assert getattr(t_eng, g) == getattr(r_eng, g), g
    rs, ts = r_sched.latency_stats(), t_sched.latency_stats()
    for key in ("spec_accept_rate", "spec_tokens_per_round", "dispatches_per_spec_round", "draft_free_blocks",
                "min_draft_free_blocks", "engine_steps", "n_truncated"):
        assert ts.get(key) == rs.get(key), key
    flags = [(r.status, r.truncated) for r in r_sched.results.values()]
    assert [(r.status, r.truncated) for r in t_sched.results.values()] == flags
    if "n_pool_blocks" in kw:
        assert ts["n_truncated"] > 0 and ts["min_draft_free_blocks"] == 0


def test_spec_config_errors(monkeypatch):
    cfg = t_smoke(t_get("qwen3-0.6b")).with_overrides(dtype="float32")
    p = init_params(TLM.param_specs(cfg), torch.Generator().manual_seed(0), device="cpu")

    def build(**kw):
        return TE.ServeEngine(cfg, p, TE.ServeConfig(max_prompt_len=8, **kw), device="cpu")

    with pytest.raises(ValueError, match="requires paged"):
        build(draft_k=3)
    with pytest.raises(ValueError, match="must be >= 0"):
        build(draft_k=-1, paged=True)
    with pytest.raises(ValueError, match="cannot fit one verify"):
        build(draft_k=4, paged=True, token_budget=4)
    with pytest.raises(ValueError, match="draft_config without draft_params"):
        build(draft_k=3, paged=True, draft_config=cfg)
    with pytest.raises(ValueError, match="vocab_size"):
        build(draft_k=3, paged=True, draft_config=cfg.with_overrides(vocab_size=128), draft_params={})
    ssm = t_smoke(t_get("mamba2-1.3b")).with_overrides(dtype="float32")
    with pytest.raises(ValueError, match="all-attention"):
        build(draft_k=3, paged=True, draft_config=ssm, draft_params={})


# --------------------------------------------------------------------- #
# smoke-width qwen3-0.6b
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def bridged():
    cfg = r_smoke(r_get("qwen3-0.6b")).with_overrides(dtype="float32")
    tcfg = t_smoke(t_get("qwen3-0.6b")).with_overrides(dtype="float32")
    params = r_init(RLM.param_specs(cfg), jax.random.PRNGKey(0))
    tparams = from_reference(TLM.param_specs(tcfg), jax.tree.map(np.asarray, params), device="cpu")
    return cfg, tcfg, params, tparams


def _ragged(vocab):
    """The paged parity workload of the reference's spec tests."""
    rng = np.random.default_rng(42)
    prompts = [rng.integers(8, vocab, size=n).astype(np.int32) for n in (9, 11, 6, 3, 11, 7)]
    return prompts, [5, 1, 4, 5, 2, 5]


BASE = dict(max_batch=2, max_prompt_len=11, max_new_tokens=5, sched_chunk=2)


@pytest.mark.parametrize("block_size", [4, 8, 16])
def test_spec_matches_plain(bridged, block_size):
    _, tcfg, _, tparams = bridged
    prompts, budgets = _ragged(tcfg.vocab_size)
    kw = dict(paged=True, block_size=block_size, token_budget=5, **BASE)
    want = TE.ServeEngine(tcfg, tparams, TE.ServeConfig(**kw), device="cpu").serve_prompts(prompts, budgets)
    spec = TE.ServeEngine(tcfg, tparams, TE.ServeConfig(draft_k=3, **kw), device="cpu")
    got = spec.serve_prompts(prompts, budgets)
    for i, (w, g) in enumerate(zip(want, got)):
        assert np.array_equal(w, g), f"prompt {i}: spec {list(g)} != plain {list(w)}"
    assert spec.spec_rounds > 0 and spec.spec_tokens_accepted > 0
    assert spec.decode_dispatches == 0


def test_spec_with_prefix_cache_matches_plain(bridged):
    """A COW and sibling workload (cold prompts, a same-pass sibling,
    full-prefix hits) under speculation against the contiguous engine."""
    _, tcfg, _, tparams = bridged
    base = dict(BASE, max_prompt_len=20)
    rng = np.random.default_rng(42)
    pre = rng.integers(8, tcfg.vocab_size, size=16).astype(np.int32)
    tails = [rng.integers(8, tcfg.vocab_size, size=n).astype(np.int32) for n in (1, 3, 2)]
    prompts = [np.concatenate([pre, tails[0]]), np.concatenate([pre, tails[1]]), pre.copy(),
               rng.integers(8, tcfg.vocab_size, size=9).astype(np.int32), pre.copy(),
               np.concatenate([pre, tails[2]])]
    budgets = [5, 1, 4, 5, 2, 3]
    want = TE.ServeEngine(tcfg, tparams, TE.ServeConfig(**base), device="cpu").serve_prompts(prompts, budgets)
    spec = TE.ServeEngine(tcfg, tparams, TE.ServeConfig(paged=True, prefix_cache=True, block_size=8, token_budget=7,
                                                         draft_k=3, **base), device="cpu")
    got = spec.serve_prompts(prompts, budgets)
    for i, (w, g) in enumerate(zip(want, got)):
        assert np.array_equal(w, g), f"prompt {i}: spec {list(g)} != contiguous {list(w)}"
    assert spec.prefix_hits >= 3 and spec.spec_tokens_accepted > 0


def test_smaller_drafter_matches_plain(bridged):
    """A drafter of its own (one layer, other weights): tokens equal plain
    decode's, whatever it proposes."""
    _, tcfg, _, tparams = bridged
    prompts, budgets = _ragged(tcfg.vocab_size)
    kw = dict(paged=True, block_size=4, token_budget=6, **BASE)
    dcfg = tcfg.with_overrides(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64)
    dparams = init_params(TLM.param_specs(dcfg), torch.Generator().manual_seed(5), device="cpu")
    want = TE.ServeEngine(tcfg, tparams, TE.ServeConfig(**kw), device="cpu").serve_prompts(prompts, budgets)
    spec = TE.ServeEngine(tcfg, tparams, TE.ServeConfig(draft_k=2, draft_config=dcfg, draft_params=dparams, **kw),
                          device="cpu")
    got = spec.serve_prompts(prompts, budgets)
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    assert spec.spec_rounds > 0 and spec.spec_tokens_proposed > 0
    assert spec._draft_cache["pos0"]["k"].shape[0] == 1  # the drafter's own one-layer pool


def _margin(cfg, params, prompt, answer_prefix):
    seq = np.concatenate([prompt, answer_prefix]).astype(np.int32)[None]
    logits, _ = RLM.forward(cfg, POL, params, {"tokens": jnp.asarray(seq)})
    top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
    return float(top2[1] - top2[0])


def test_spec_tokens_match_the_reference(bridged):
    """The port's spec tokens against the reference's spec tokens on the
    same weights: equal, or first different at a near-tie (reference
    margin < 1e-4); the gauges of a run whose tokens agree are equal."""
    cfg, tcfg, params, tparams = bridged
    prompts, budgets = _ragged(tcfg.vocab_size)
    kw = dict(paged=True, block_size=8, token_budget=5, draft_k=3, **BASE)
    r_eng = REngine(cfg, POL, params, RServe(**kw))
    want = r_eng.serve_prompts(prompts, max_new_tokens=budgets)
    t_eng = TE.ServeEngine(tcfg, tparams, TE.ServeConfig(**kw), device="cpu")
    got = t_eng.serve_prompts(prompts, budgets)
    same = True
    for p, w, g in zip(prompts, want, got):
        w, g = np.asarray(w), np.asarray(g)
        if not np.array_equal(w, g):
            same = False
            j = next((i for i in range(min(len(w), len(g))) if w[i] != g[i]), None)
            assert j is not None, (w, g)
            assert _margin(cfg, params, p, w[:j]) < 1e-4, (w, g)
    if same:
        for g in GAUGES:
            assert getattr(t_eng, g) == getattr(r_eng, g), g


def test_launcher_draft_k_on_cpu(capsys):
    from repro_torch.launch import serve as t_launch

    t_launch.main(["--queries", "4", "--n-facts", "16", "--max-new-tokens", "6", "--device", "cpu",
                   "--draft-k", "3"])
    out = capsys.readouterr().out
    assert "drafter pool:" in out
    line = next(ln for ln in out.splitlines() if ln.startswith("speculation:"))
    assert "accept rate 100%" in line and "(draft_k=3)" in line  # self-speculation accepts every draft
    assert "0 decode + " in out  # every token through the mixed dispatch
