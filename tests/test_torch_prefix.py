"""The paged engine's prefix cache, copy on write and host spill tier in
the port, against the reference and within the port.

Within the port, bitwise (tests/test_serving.py's contracts): shared ≡
unshared for block sizes 4/8/16 with the COW boundary, the unified path
with a prefix cache ≡ the contiguous engine, warm restart ≡ cold,
demote-then-readmit ≡ cold, readmitted payloads ≡ the demoted ones (a
bf16 pool included), and every shared chunk written by an earlier
dispatch than the first one that reads it.  Against the reference on the
same traffic: the gauges (lookups, hits, shared blocks, tokens saved,
demotions, readmits) exactly, the tokens under the top-2 margin rule,
``cache_nbytes`` exactly, and the configuration checks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as r_get, smoke_config as r_smoke  # noqa: E402
from repro.models import lm as RLM  # noqa: E402
from repro.models.params import init_params as r_init  # noqa: E402
from repro.runtime.sharding import ShardingPolicy, base_rules  # noqa: E402
from repro.serving.engine import ServeConfig as RServe, ServeEngine as REngine  # noqa: E402
from repro.serving.scheduler import Scheduler as RScheduler  # noqa: E402
from repro_torch.configs import get_config as t_get, smoke_config as t_smoke  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models.params import from_reference  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving.scheduler import Scheduler  # noqa: E402

POL = ShardingPolicy(rules=base_rules(False), mesh=None)
VOCAB = 8192
GAUGES = ("prefix_lookups", "prefix_hits", "prefix_shared_blocks", "prefill_tokens",
          "prefill_tokens_saved", "prefix_cached_blocks", "spill_demotions", "spill_readmits")


@pytest.fixture(scope="module")
def bridged():
    cfg = r_smoke(r_get("qwen3-0.6b")).with_overrides(dtype="float32", vocab_size=VOCAB)
    tcfg = t_smoke(t_get("qwen3-0.6b")).with_overrides(dtype="float32", vocab_size=VOCAB)
    params = r_init(RLM.param_specs(cfg), jax.random.PRNGKey(0))
    tparams = from_reference(TLM.param_specs(tcfg), jax.tree.map(np.asarray, params), device="cpu")
    return cfg, tcfg, params, tparams


def _engine(tcfg, tparams, **kw):
    return TE.ServeEngine(tcfg, tparams, TE.ServeConfig(**kw), device="cpu")


def _margin(cfg, params, prompt, answer_prefix):
    seq = np.concatenate([prompt, answer_prefix]).astype(np.int32)[None]
    logits, _ = RLM.forward(cfg, POL, params, {"tokens": jnp.asarray(seq)})
    top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
    return float(top2[1] - top2[0])


def _assert_same_tokens(cfg, params, prompt, want, got):
    want, got = np.asarray(want), np.asarray(got)
    if not np.array_equal(want, got):
        j = next((i for i in range(min(len(want), len(got))) if want[i] != got[i]), None)
        assert j is not None, (want, got)
        assert _margin(cfg, params, prompt, want[:j]) < 1e-4, (want, got)


def _cow_workload(rng, n_pre=16):
    """Cold prompts, a same-pass sibling, full-prefix hits on a block
    boundary (the COW case, once against a live chain and once against a
    parked one) and an unrelated prompt (tests/test_serving.py)."""
    pre = rng.integers(8, VOCAB, size=n_pre).astype(np.int32)  # 16 % {4, 8, 16} == 0
    tails = [rng.integers(8, VOCAB, size=n).astype(np.int32) for n in (1, 3, 2)]
    prompts = [
        np.concatenate([pre, tails[0]]),
        np.concatenate([pre, tails[1]]),
        pre.copy(),
        rng.integers(8, VOCAB, size=9).astype(np.int32),
        pre.copy(),
        np.concatenate([pre, tails[2]]),
    ]
    return prompts, [5, 1, 4, 5, 2, 3]


_KW = dict(max_batch=2, max_prompt_len=20, max_new_tokens=5, sched_chunk=2)


@pytest.mark.parametrize("block_size", [4, 8, 16])
def test_prefix_shared_matches_unshared_bitwise(bridged, block_size):
    _, tcfg, _, tparams = bridged
    prompts, budgets = _cow_workload(np.random.default_rng(42))
    want = _engine(tcfg, tparams, paged=True, block_size=block_size, **_KW).serve_prompts(prompts, budgets)
    eng = _engine(tcfg, tparams, paged=True, prefix_cache=True, block_size=block_size, **_KW)
    cows = []
    real_copy = TLM.paged_copy_block

    def spy(cfg, cache, src, dst):
        cows.append((src, dst))
        return real_copy(cfg, cache, src, dst)

    TE.LM.paged_copy_block = spy
    try:
        got = eng.serve_prompts(prompts, budgets)
    finally:
        TE.LM.paged_copy_block = real_copy
    for i, (w, g) in enumerate(zip(want, got)):
        assert np.array_equal(w, g), f"prompt {i}: shared {list(g)} != unshared {list(w)}"
    assert eng.prefix_lookups == len(prompts) and eng.prefix_hits >= 3
    assert eng.prefill_tokens_saved > 0
    assert len(cows) == 2, cows  # both full-prefix hits copied their boundary block
    # the retired chains stay parked, nothing else is held
    assert eng._pool.used_blocks == 0 and eng._pool.reclaimable_blocks == eng._index.n_cached_blocks


@pytest.mark.parametrize("block_size", [4, 8, 16])
def test_unified_prefix_shared_matches_contiguous_bitwise(bridged, block_size):
    """Prefix sharing through prompt chunks of 7 lanes (siblings wait on
    pending chunks) gives the contiguous engine's tokens."""
    _, tcfg, _, tparams = bridged
    prompts, budgets = _cow_workload(np.random.default_rng(42))
    want = _engine(tcfg, tparams, **_KW).serve_prompts(prompts, budgets)
    eng = _engine(tcfg, tparams, paged=True, prefix_cache=True, block_size=block_size, token_budget=7, **_KW)
    got = eng.serve_prompts(prompts, budgets)
    for i, (w, g) in enumerate(zip(want, got)):
        assert np.array_equal(w, g), f"prompt {i}: shared {list(g)} != contiguous {list(w)}"
    assert eng.prefix_hits >= 3 and eng.prefill_tokens_saved > 0


def _warm_prompts(rng):
    pre = rng.integers(8, VOCAB, size=12).astype(np.int32)
    return [np.concatenate([pre, rng.integers(8, VOCAB, size=n).astype(np.int32)]) for n in (2, 3)]


_WARM = dict(max_batch=2, max_prompt_len=20, max_new_tokens=4, sched_chunk=2, paged=True,
             prefix_cache=True, block_size=4)


def test_warm_restart_matches_cold(bridged):
    """The index and pool survive across serve calls: the second call is
    all hits and gives a cold engine's tokens; ``reset_cache`` starts cold."""
    _, tcfg, _, tparams = bridged
    prompts = _warm_prompts(np.random.default_rng(7))
    eng = _engine(tcfg, tparams, **_WARM)
    stats, outs = [], []
    for _ in range(2):
        s = Scheduler()
        rids = s.submit_many(prompts, 4)
        res = eng.serve(s)
        outs.append([res[r] for r in rids])
        stats.append(s.latency_stats())
    cold = _engine(tcfg, tparams, **_WARM).serve_prompts(prompts, max_new_tokens=4)
    for w, a, b in zip(cold, *outs):
        assert np.array_equal(a, w) and np.array_equal(b, w), "warm restart changed tokens"
    assert stats[0]["prefix_hits"] == 1  # only the same-pass sibling
    assert stats[1]["prefix_hits"] == len(prompts) and stats[1]["prefix_hit_rate"] == 1.0
    assert stats[1]["prefix_lookups"] == len(prompts)
    assert stats[1]["lifetime"]["prefix_lookups"] == eng.prefix_lookups == 2 * len(prompts)
    eng.reset_cache()
    assert eng._index is None and eng._pool is None
    s = Scheduler()
    s.submit_many(prompts, 4)
    eng.serve(s)
    assert s.latency_stats()["prefix_hits"] == 1


_SPILL = dict(max_batch=1, max_prompt_len=8, max_new_tokens=4, sched_chunk=2, paged=True,
              prefix_cache=True, block_size=4, n_pool_blocks=3, spill_bytes=4 << 20)


def _spill_prompts():
    rng = np.random.default_rng(9)
    return [rng.integers(8, VOCAB, size=8).astype(np.int32) for _ in range(2)]


def _spy_tier(eng):
    """Record every payload the engine demotes (copied at demotion, with
    the block's content just before it left) and every upload."""
    fetched, uploaded = [], []
    real_fetch, real_upload = eng._fetch_block, eng._upload_block

    def fetch(b):
        payload, nbytes = real_fetch(b)
        fetched.append((b, [p.clone() for p in payload], [leaf[:, b].cpu().clone() for leaf in eng._pool_leaves()]))
        return payload, nbytes

    def upload(payload, b):
        real_upload(payload, b)
        uploaded.append((b, [p.clone() for p in payload], [leaf[:, b].cpu().clone() for leaf in eng._pool_leaves()]))

    eng._fetch_block, eng._upload_block = fetch, upload
    return fetched, uploaded


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_demote_then_readmit_matches_cold(bridged, dtype):
    """A chain demoted to the host tier under pool pressure comes back by
    upload, bit for bit (in the pool's own dtype), and decodes the cold
    tokens."""
    _, tcfg, _, tparams = bridged
    tcfg = tcfg.with_overrides(dtype=dtype)
    a, b = _spill_prompts()
    eng = _engine(tcfg, tparams, **_SPILL)
    fetched, uploaded = _spy_tier(eng)
    cold_a = eng.serve_prompts([a], max_new_tokens=4)[0]
    eng.serve_prompts([b], max_new_tokens=4)  # pool pressure demotes a's chain
    assert eng._index.n_demotions >= 1 and eng._index.n_spilled >= 1
    assert 0 < eng._spill_store.used_bytes <= _SPILL["spill_bytes"]
    s = Scheduler()
    rids = s.submit_many([a], 4)
    warm_a = eng.serve(s)[rids[0]]
    assert eng._index.n_readmits >= 1 and uploaded, "the spilled chain must come back by upload"
    assert np.array_equal(warm_a, cold_a), "the readmitted chain changed tokens"
    st = s.latency_stats()
    assert st["spill_readmits"] >= 1 and st["prefix_hits"] == 1
    assert st["lifetime"]["spill_demotions"] == eng._index.n_demotions
    # every payload: the pool's dtype, equal to the block as it left the
    # device; every upload: one of those payloads, landed bit for bit
    want_dtype = getattr(torch, dtype)
    demoted = []
    for _, payload, before in fetched:
        assert all(p.dtype == want_dtype and p.device.type == "cpu" for p in payload)
        assert all(torch.equal(p, q) for p, q in zip(payload, before))
        demoted.append(payload)
    for _, payload, after in uploaded:
        assert all(torch.equal(p, q) for p, q in zip(payload, after))
        assert any(all(torch.equal(p, q) for p, q in zip(payload, d)) for d in demoted)
    nbytes = sum(p.numel() * p.element_size() for p in fetched[0][1])
    assert nbytes == 2 * tcfg.n_layers * 4 * tcfg.n_kv_heads * tcfg.resolved_head_dim * want_dtype.itemsize


def test_shared_chunks_written_before_read(bridged):
    """Host ordering of the fill dependencies: every pool position a row
    reads below its ``q_start`` was written by an earlier mixed dispatch
    (or by a boundary copy made before this one).  The dispatches run in
    order on one stream, so on the card the reads follow the writes."""
    _, tcfg, _, tparams = bridged
    prompts, budgets = _cow_workload(np.random.default_rng(42))
    eng = _engine(tcfg, tparams, paged=True, prefix_cache=True, block_size=4, token_budget=7, **_KW)
    written: dict[tuple, float] = {}
    step = [0]
    real_mixed, real_copy = TLM.mixed_step, TLM.paged_copy_block
    checked = [0]

    def mixed(cfg, params, tokens, cache, tables, lanes):
        t, bs = tables.cpu().numpy(), eng.scfg.block_size
        desc = lanes.desc.cpu().numpy()
        for r, qs, ql, _, _ in desc:
            assert ql > 0  # the packed step carries live rows only
            for pos in range(qs):
                key = (int(t[r, pos // bs]), pos % bs)
                assert key in written and written[key] < step[0], (r, pos, key)
                checked[0] += 1
        for r, qs, ql, _, _ in desc:
            for pos in range(qs, qs + ql):
                written[(int(t[r, pos // bs]), pos % bs)] = step[0]
        step[0] += 1
        return real_mixed(cfg, params, tokens, cache, tables, lanes)

    def decode(cfg, params, cache, tokens, pos, block_tables=None, block_size=0):
        t, ps = block_tables.cpu().numpy(), pos.cpu().numpy()
        for r in range(len(ps)):
            written[(int(t[r, ps[r] // block_size]), ps[r] % block_size)] = step[0]
        step[0] += 1
        return real_decode(cfg, params, cache, tokens, pos, block_tables=block_tables, block_size=block_size)

    def copy(cfg, cache, src, dst):
        for off in range(4):
            if (src, off) in written:
                written[(dst, off)] = step[0] - 0.5
        return real_copy(cfg, cache, src, dst)

    real_decode = TLM.decode_step
    TE.LM.mixed_step, TE.LM.decode_step, TE.LM.paged_copy_block = mixed, decode, copy
    try:
        eng.serve_prompts(prompts, budgets)
    finally:
        TE.LM.mixed_step, TE.LM.decode_step, TE.LM.paged_copy_block = real_mixed, real_decode, real_copy
    assert eng.prefix_hits >= 3 and checked[0] > 0


def test_abandoned_stream_leaves_a_consistent_index(bridged):
    """Closing a stream while a fill has registered chunks it has not yet
    written rolls them back and frees its blocks; the next serve, which
    would otherwise share those unwritten chunks, gives the cold tokens."""
    _, tcfg, _, tparams = bridged
    rng = np.random.default_rng(5)
    short = rng.integers(8, VOCAB, size=5).astype(np.int32)
    long = rng.integers(8, VOCAB, size=18).astype(np.int32)
    kw = dict(paged=True, block_size=4, token_budget=7, **_KW)
    cold = _engine(tcfg, tparams, **kw).serve_prompts([long], [4])[0]
    eng = _engine(tcfg, tparams, prefix_cache=True, **kw)
    s = Scheduler()
    s.submit_many([short, long], [1, 4])
    stream = eng.serve_stream(s, drain=True)
    next(stream)  # the short request retires after the first step; the long fill is 2 of 18 in
    stream.close()
    # only written chunks stay cached, parked; nothing else is held
    assert eng._pool.used_blocks == 0 and eng._pool.reclaimable_blocks == eng._index.n_cached_blocks
    assert eng._index.n_cached_blocks == 1  # the short prompt's one full chunk
    again = eng.serve_prompts([long], [4])[0]
    assert np.array_equal(cold, again)


def _reference_run(cfg, params, scfg, batches, budgets):
    eng = REngine(cfg, POL, params, RServe(**scfg))
    outs, stats = [], []
    for prompts in batches:
        s = RScheduler()
        rids = s.submit_many(prompts, budgets)
        res = eng.serve(s)
        outs.append([res[r] for r in rids])
        stats.append(s.latency_stats())
    return outs, stats


@pytest.mark.parametrize("case", ["cow", "warm", "spill"])
def test_prefix_gauges_and_tokens_match_reference(bridged, case):
    """The same traffic through both packages' engines: every prefix and
    spill gauge equal, every token equal or first different at a near-tie
    of the reference's logits."""
    cfg, tcfg, params, tparams = bridged
    if case == "cow":
        prompts, budgets = _cow_workload(np.random.default_rng(42))
        scfg, batches = dict(paged=True, prefix_cache=True, block_size=4, token_budget=7, **_KW), [prompts]
    elif case == "warm":
        prompts, budgets = _warm_prompts(np.random.default_rng(7)), 4
        scfg, batches = _WARM, [prompts, prompts]
    else:
        a, b = _spill_prompts()
        scfg, batches, budgets = _SPILL, [[a], [b], [a]], 4
    want, r_stats = _reference_run(cfg, params, scfg, batches, budgets)
    eng = _engine(tcfg, tparams, **scfg)
    for prompts, w_outs, r_st in zip(batches, want, r_stats):
        s = Scheduler()
        rids = s.submit_many(prompts, budgets)
        res = eng.serve(s)
        t_st = s.latency_stats()
        for p, w, rid in zip(prompts, w_outs, rids):
            _assert_same_tokens(cfg, params, p, w, res[rid])
        for key in GAUGES:
            assert t_st.get(key) == r_st.get(key), (key, t_st.get(key), r_st.get(key))
            assert t_st["lifetime"].get(key) == r_st["lifetime"].get(key), key
    if case == "spill":
        assert t_st["spill_readmits"] >= 1


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_cache_nbytes_matches_reference(bridged, paged):
    cfg, tcfg, params, tparams = bridged
    kw = dict(max_batch=3, max_prompt_len=20, max_new_tokens=5, paged=paged, block_size=8)
    assert _engine(tcfg, tparams, **kw).cache_nbytes() == REngine(cfg, POL, params, RServe(**kw)).cache_nbytes()


def test_prefix_cache_config_validation(bridged):
    _, tcfg, _, tparams = bridged
    with pytest.raises(ValueError, match="requires paged"):
        _engine(tcfg, tparams, prefix_cache=True, paged=False)
    with pytest.raises(ValueError, match="requires prefix_cache"):
        _engine(tcfg, tparams, paged=True, spill_bytes=1 << 20)
    with pytest.raises(ValueError, match="must be >= 1"):
        _engine(tcfg, tparams, paged=True, prefix_cache=True, spill_bytes=0)
    ssm = t_smoke(t_get("mamba2-1.3b")).with_overrides(dtype="float32", vocab_size=VOCAB)
    with pytest.raises(ValueError, match="all-attention"):
        TE.ServeEngine(ssm, {}, TE.ServeConfig(prefix_cache=True, paged=True), device="cpu")
    # speculation and the sharded pool compose with the prefix cache, and the
    # sharded pool refuses what the reference's refuses
    assert _engine(tcfg, tparams, paged=True, prefix_cache=True, draft_k=2)._draft_pool is None  # made at first serve
    assert _engine(tcfg, tparams, paged=True, prefix_cache=True, shards=2)._mesh.size == 2
    with pytest.raises(ValueError, match="must divide evenly"):
        _engine(tcfg, tparams, paged=True, prefix_cache=True, shards=3, n_pool_blocks=16, max_prompt_len=8,
                max_new_tokens=8, block_size=4)
