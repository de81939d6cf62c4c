"""Sharded serving in the port, against the JAX package and within itself.

One process, every shard on the CPU through ``mesh=`` (the port's analog
of the reference's fake host devices).  Against the reference, in
process, on the same seeded inputs: ``mixed_prefill_partials_plain`` with
and without ``owned`` (1e-5, f32), the port's ``dist_decode_attention``
against the dense decode oracle on the whole cache (1e-5; a row of length
0 gives exact zeros, as the reference's combine of exact-zero shards
does), the port's ``federated_topk`` over 4 providers against the
reference's mesh-free call (ids equal, scores 1e-5), and the port's
``shards=1`` engine against the reference's unsharded paged engine on the
same weights (tokens equal).  Within the port, the contracts of
``tests/test_sharded_serving.py``: the combine passes the owner through
bitwise, ``shards=4`` equals ``shards=1`` bit for bit (block sizes 4, 8,
16; with the prefix cache and spill tier; with self-speculation),
``shards=1`` equals the unsharded engine, capacity scales with the
shards, and the reference's ``ValueError``s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as r_get, smoke_config as r_smoke  # noqa: E402
from repro.core.retrieval import federated_topk as r_federated_topk  # noqa: E402
from repro.kernels.chunked_prefill.ref import mixed_prefill_partials as r_partials  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro.models import lm as RLM  # noqa: E402
from repro.models.params import init_params as r_init  # noqa: E402
from repro.runtime.sharding import ShardingPolicy, base_rules  # noqa: E402
from repro.serving.engine import ServeConfig as RServe, ServeEngine as REngine  # noqa: E402
from repro_torch.configs import get_config as t_get, smoke_config as t_smoke  # noqa: E402
from repro_torch.core.retrieval import federated_topk, federated_topk_jit  # noqa: E402
from repro_torch.kernels.chunked_prefill.ops import (  # noqa: E402
    mixed_prefill_attention_plain,
    mixed_prefill_partials,
    mixed_prefill_partials_plain,
)
from repro_torch.launch import serve as t_launch  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models.params import from_reference  # noqa: E402
from repro_torch.runtime.compat import gather, make_mesh  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving.dist_decode import combine_partials, dist_decode_attention  # noqa: E402
from repro_torch.serving.scheduler import Scheduler  # noqa: E402

POL = ShardingPolicy(rules=base_rules(False), mesh=None)


def _mesh(n):
    return make_mesh(["cpu"] * n)


@pytest.fixture(scope="module")
def bridged():
    """Smoke qwen3-0.6b in f32 (vocab 256), the reference's weights and
    the port's copy of them."""
    cfg = r_smoke(r_get("qwen3-0.6b")).with_overrides(dtype="float32")
    tcfg = t_smoke(t_get("qwen3-0.6b")).with_overrides(dtype="float32")
    params = r_init(RLM.param_specs(cfg), jax.random.PRNGKey(0))
    tparams = from_reference(TLM.param_specs(tcfg), jax.tree.map(np.asarray, params), device="cpu")
    return cfg, tcfg, params, tparams


# ------------------------------------------------------------------ #
# the kernels' partials forms against the reference
# ------------------------------------------------------------------ #


def _mixed_inputs(seed=3, b=3, w=4, kv=2, g=2, dh=8, bs=4, n_blk=6):
    rng = np.random.default_rng(seed)
    n_pool = b * n_blk
    q = rng.normal(size=(b, w, kv * g, dh)).astype(np.float32)
    k_pool = rng.normal(size=(n_pool + 1, bs, kv, dh)).astype(np.float32)
    v_pool = rng.normal(size=(n_pool + 1, bs, kv, dh)).astype(np.float32)
    tables = rng.permutation(n_pool).astype(np.int32).reshape(b, n_blk)
    # ragged rows (slot, q_start, q_len, kv_len): a warm chunk, a cold
    # prefill, a decode row
    desc = np.array([[0, 5, 3, 8], [1, 0, 4, 4], [2, 9, 1, 10]], np.int32)
    return q, k_pool, v_pool, tables, desc


@pytest.mark.parametrize("owned_kind", ["none", "parity", "row_affine", "nothing"])
def test_mixed_prefill_partials_plain_matches_reference(owned_kind):
    """``(o, m, l)`` of the port's plain partials equal the reference's at
    1e-5 (f32), with no ``owned`` mask, blocks split by parity, a whole row
    owned by one shard, and no block owned (exact zeros, m = -1e30)."""
    q, kp, vp, tables, desc = _mixed_inputs()
    owned = {
        "none": None,
        "parity": tables % 2 == 0,
        "row_affine": np.array([[True], [False], [True]]) & np.ones_like(tables, bool),
        "nothing": np.zeros_like(tables, bool),
    }[owned_kind]
    want = r_partials(*(jnp.asarray(a) for a in (q, kp, vp, tables, desc)),
                      owned=None if owned is None else jnp.asarray(owned))
    got = mixed_prefill_partials_plain(*(torch.as_tensor(a) for a in (q, kp, vp, tables, desc)),
                                       owned=None if owned is None else torch.as_tensor(owned))
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.float32 and tuple(g_.shape) == w_.shape
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-5, atol=1e-5)
    if owned_kind == "nothing":
        o, m, l = got
        assert bool((o == 0).all()) and bool((l == 0).all()) and bool((m == -1e30).all())
    # the CPU wrapper is the plain version
    again = mixed_prefill_partials(*(torch.as_tensor(a) for a in (q, kp, vp, tables, desc)),
                                   owned=None if owned is None else torch.as_tensor(owned))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_mixed_prefill_partials_combine_to_the_normalised_output():
    """Complementary ``owned`` masks, combined, give the normalised mixed
    prefill output on the live lanes (1e-5)."""
    q, kp, vp, tables, desc = (torch.as_tensor(a) for a in _mixed_inputs(seed=5))
    parts = [mixed_prefill_partials_plain(q, kp, vp, tables, desc, owned=(tables % 2) == s) for s in range(2)]
    out = combine_partials(*map(list, zip(*parts)))  # (R, KV, G, W, dh)
    b, w, h, dh = q.shape
    got = out.permute(0, 3, 1, 2, 4).reshape(b, w, h, dh)
    want = mixed_prefill_attention_plain(q, kp, vp, tables, desc)
    live = torch.arange(w)[None, :] < desc[:, 2:3]
    np.testing.assert_allclose(got[live].numpy(), want[live].numpy(), rtol=1e-5, atol=1e-5)


def test_combine_passes_owner_through_bitwise():
    """One shard holds finite partials, every other one the exact-zero
    triple: the combine returns the owner's ``o / max(l, 1e-30)`` bit for
    bit, whichever shard owns the row."""
    rng = np.random.default_rng(7)
    rows, kv, g, dh, n = 8, 2, 2, 8, 4
    o = torch.as_tensor(rng.normal(size=(rows, kv, g, dh)).astype(np.float32))
    m = torch.as_tensor(rng.normal(size=(rows, kv, g, 1)).astype(np.float32))
    l = torch.as_tensor(rng.uniform(0.5, 4.0, size=(rows, kv, g, 1)).astype(np.float32))
    owner = torch.arange(rows) % n
    os_, ms, ls = [], [], []
    for s in range(n):
        mine = (owner == s)[:, None, None, None]
        os_.append(torch.where(mine, o, 0.0))
        ms.append(torch.where(mine, m, -1e30))
        ls.append(torch.where(mine, l, 0.0))
    got = combine_partials(os_, ms, ls)
    assert torch.equal(got, o / torch.clamp(l, min=1e-30))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_dist_decode_matches_reference_oracle(n_shards):
    """Sequence-sharded flash-decode equals the dense decode oracle on the
    whole cache (1e-5): a one-key row, rows inside shard 0, a row ending
    on a shard boundary, a full row, ragged rows; a row of length 0 gives
    exact zeros, as the reference's combine of exact-zero shards does."""
    rng = np.random.default_rng(0)
    b, s, kv, g, dh = 7, 16, 2, 2, 8
    q = rng.normal(size=(b, kv * g, dh)).astype(np.float32)
    kc = rng.normal(size=(b, s, kv, dh)).astype(np.float32)
    vc = rng.normal(size=(b, s, kv, dh)).astype(np.float32)
    shard_len = s // n_shards
    lengths = np.array([1, shard_len - 1, shard_len, s, 3, s - 1, 0], np.int32)
    got = dist_decode_attention(*(torch.as_tensor(a) for a in (q, kc, vc, lengths)), _mesh(n_shards))
    want = np.asarray(decode_attention_ref(*(jnp.asarray(a) for a in (q, kc, vc, lengths))))
    np.testing.assert_allclose(got[:-1].numpy(), want[:-1], rtol=1e-5, atol=1e-5)
    assert bool((got[-1] == 0).all())
    # per-shard slices handed over as a list give the same answer
    kt, vt = torch.as_tensor(kc), torch.as_tensor(vc)
    sl = [kt[:, i * shard_len : (i + 1) * shard_len] for i in range(n_shards)]
    vl = [vt[:, i * shard_len : (i + 1) * shard_len] for i in range(n_shards)]
    assert torch.equal(dist_decode_attention(torch.as_tensor(q), sl, vl, torch.as_tensor(lengths),
                                             _mesh(n_shards)), got)


def test_dist_decode_refuses_an_uneven_split():
    q, c = torch.zeros(1, 2, 8), torch.zeros(1, 10, 1, 8)
    with pytest.raises(ValueError, match="does not split"):
        dist_decode_attention(q, c, c, torch.ones(1, dtype=torch.int32), _mesh(4))


# ------------------------------------------------------------------ #
# in-mesh federated retrieval
# ------------------------------------------------------------------ #


def _retrieval_inputs(seed=0, nq=4, n=128, d=32):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(nq, d)).astype(np.float32), rng.normal(size=(n, d)).astype(np.float32)


def test_federated_topk_matches_reference():
    """4 providers, merged: ids equal to the reference's mesh-free
    federated top-k (the centralized answer), scores at 1e-5; providers
    are the ids' row ranges.  The mesh-free call is the whole corpus."""
    q, c = _retrieval_inputs()
    r_s, r_i, _ = r_federated_topk(jnp.asarray(q), jnp.asarray(c), m_local=8, n_global=8, mesh=None)
    s, i, p = federated_topk(torch.as_tensor(q), torch.as_tensor(c), m_local=8, n_global=8, mesh=_mesh(4))
    assert np.array_equal(i.numpy(), np.asarray(r_i))
    np.testing.assert_allclose(s.numpy(), np.asarray(r_s), rtol=1e-5, atol=1e-5)
    assert np.array_equal(p.numpy(), i.numpy() // 32)
    s0, i0, p0 = federated_topk_jit(torch.as_tensor(q), torch.as_tensor(c), 8, 8, mesh=None)
    assert np.array_equal(i0.numpy(), np.asarray(r_i)) and bool((p0 == 0).all())


def test_federated_topk_alive_mask_against_numpy():
    """A dead provider's candidates never appear; the rest are the numpy
    top-k of the live providers' rows."""
    q, c = _retrieval_inputs(seed=1)
    alive = np.array([False, True, True, False])
    s, i, p = federated_topk(torch.as_tensor(q), torch.as_tensor(c), m_local=8, n_global=8,
                             mesh=_mesh(4), alive=torch.as_tensor(alive))
    assert bool(alive[p.numpy()].all())
    full = q @ c.T
    full[:, np.repeat(~alive, 32)] = -np.inf
    want_i = np.argsort(-full, axis=1, kind="stable")[:, :8]
    assert np.array_equal(i.numpy(), want_i)
    np.testing.assert_allclose(s.numpy(), np.take_along_axis(full, want_i, 1), rtol=1e-5, atol=1e-5)


def test_federated_topk_ties_go_to_the_lower_provider_major_index():
    """Equal scores keep ``lax.top_k``'s order: the lower flattened
    (provider-major) candidate first."""
    q = torch.ones(1, 4)
    c = torch.ones(16, 4)  # every score ties
    s, i, p = federated_topk(q, c, m_local=2, n_global=6, mesh=_mesh(4))
    assert i.tolist() == [[0, 1, 4, 5, 8, 9]] and p.tolist() == [[0, 0, 1, 1, 2, 2]]


@pytest.mark.parametrize("seed,m", [(0, 4), (17, 8), (123, 16), (401, 11)])
def test_federated_merge_property(seed, m):
    """With m_local >= n_global, merging per-shard top-m equals the global
    top-n scores, for the port's merge (tests/test_retrieval.py's property)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(3, 16)).astype(np.float32)
    c = rng.normal(size=(64, 16)).astype(np.float32)
    n_global = min(m, 8)
    expect = np.sort(q @ c.T, axis=1)[:, -n_global:][:, ::-1]
    s, _, _ = federated_topk(torch.as_tensor(q), torch.as_tensor(c), m_local=m, n_global=n_global, mesh=_mesh(4))
    np.testing.assert_allclose(s.numpy(), expect, rtol=1e-5)


# ------------------------------------------------------------------ #
# the sharded engine
# ------------------------------------------------------------------ #

_PROMPT_LENS = (9, 11, 6, 3, 11, 7)
_BUDGETS = [5, 1, 4, 5, 2, 5]


def _prompts(vocab, seed=42):
    rng = np.random.default_rng(seed)
    return [rng.integers(8, vocab, size=n).astype(np.int32) for n in _PROMPT_LENS]


def _kw(**extra):
    # 16 pool blocks in every arm (4 per shard at shards=4, enough for a
    # max-size request), so that the admission order is the same
    return dict(max_batch=2, max_prompt_len=11, max_new_tokens=5, sched_chunk=2, paged=True,
                **{"n_pool_blocks": 16, **extra})


def _serve(tcfg, tparams, shards, **extra):
    eng = TE.ServeEngine(tcfg, tparams, TE.ServeConfig(shards=shards, **_kw(**extra)), device="cpu")
    return eng.serve_prompts(_prompts(tcfg.vocab_size), max_new_tokens=_BUDGETS), eng


def _same(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def test_single_shard_matches_reference_unsharded_engine(bridged):
    """The port's shards=1 engine (the partials form, combined) gives the
    reference's unsharded paged engine's tokens on the same weights."""
    cfg, tcfg, params, tparams = bridged
    kw = _kw(block_size=4)
    want = REngine(cfg, POL, params, RServe(**kw)).serve_prompts(_prompts(cfg.vocab_size), max_new_tokens=_BUDGETS)
    got, eng = _serve(tcfg, tparams, 1, block_size=4)
    assert _same(want, got), (want, got)
    assert eng._mesh.size == 1


@pytest.mark.parametrize("block_size", [4, 8, 16])
def test_sharded_matches_single_shard_bitwise(bridged, block_size):
    """shards=4 gives shards=1's tokens bit for bit, and the same dispatch
    counts: non-owner shards contribute exact zeros."""
    _, tcfg, _, tparams = bridged
    want, e1 = _serve(tcfg, tparams, 1, block_size=block_size)
    got, e4 = _serve(tcfg, tparams, 4, block_size=block_size)
    assert _same(want, got)
    assert e4._mesh.size == 4 and len(e4._cache["pos0"]["k"]) == 4
    assert (e1.mixed_dispatches, e1.decode_dispatches) == (e4.mixed_dispatches, e4.decode_dispatches)


def test_single_shard_matches_unsharded_tokens(bridged):
    _, tcfg, _, tparams = bridged
    want, _ = _serve(tcfg, tparams, None, block_size=4)
    got, _ = _serve(tcfg, tparams, 1, block_size=4)
    assert _same(want, got)


def test_sharded_prefix_cache_and_spill_match_single_shard(bridged):
    """The prefix cache over 4 shards, the queries served twice on the
    resident engine, gives the 1-shard run's tokens.  With a host spill
    tier the chains that a shard's smaller pool evicts are demoted and
    uploaded back to their own shard, so the prefix hits equal the 1-shard
    run's too (without it they may be fewer: a quarter of the pool per
    shard parks fewer chains).  24 blocks, 6 per shard: at 4 per shard a
    row that adopts a chain on its neighbour's shard cannot grow and is
    truncated, in the reference's engine as in this one."""
    _, tcfg, _, tparams = bridged
    runs = {}
    for shards in (1, 4):
        for spill in (None, 1 << 20):
            eng = TE.ServeEngine(tcfg, tparams, TE.ServeConfig(
                shards=shards, prefix_cache=True, spill_bytes=spill,
                **_kw(block_size=4, n_pool_blocks=24)), device="cpu")
            out = [eng.serve_prompts(_prompts(tcfg.vocab_size), max_new_tokens=_BUDGETS) for _ in range(2)]
            runs[shards, spill] = (out, eng.prefix_hits, eng.prefix_lookups, eng._index.n_readmits)
    for spill in (None, 1 << 20):
        assert all(_same(a, b) for a, b in zip(runs[1, spill][0], runs[4, spill][0]))
    assert all(_same(a, b) for a, b in zip(runs[1, None][0], runs[4, 1 << 20][0]))
    (_, h1, l1, _), (_, h4, l4, readmits) = runs[1, 1 << 20], runs[4, 1 << 20]
    assert (h4, l4) == (h1, l1) and h4 > 0 and readmits > 0


def test_sharded_spill_tier_round_trips_on_the_owning_shard(bridged):
    """A block fetched to the host and uploaded back lands in its owning
    shard's pool, bit for bit, and leaves the other shards untouched."""
    _, tcfg, _, tparams = bridged
    eng = TE.ServeEngine(tcfg, tparams, TE.ServeConfig(shards=4, prefix_cache=True, spill_bytes=1 << 20,
                                                       **_kw(block_size=4)), device="cpu")
    eng.serve_prompts(_prompts(tcfg.vocab_size)[:2], max_new_tokens=2)
    b = 9  # shard 2, local block 1
    payload, nbytes = eng._fetch_block(b)
    leaf = eng._cache["pos0"]["k"]
    assert torch.equal(payload[0], leaf[2][:, 1]) and nbytes == sum(p.numel() * 4 for p in payload)
    before = [t.clone() for t in leaf]
    eng._upload_block([p + 1 for p in payload], b)
    assert torch.equal(leaf[2][:, 1], payload[0] + 1)
    assert all(torch.equal(a, c) for s, (a, c) in enumerate(zip(leaf, before)) if s != 2)


def test_sharded_spec_decode_matches_single_shard_bitwise(bridged):
    """Self-speculation with the drafter's pool sharded like the target's:
    shards=4 equals shards=1 bit for bit, and rounds ran."""
    _, tcfg, _, tparams = bridged
    want, _ = _serve(tcfg, tparams, 1, block_size=4, draft_k=2, token_budget=5)
    got, eng = _serve(tcfg, tparams, 4, block_size=4, draft_k=2, token_budget=5)
    assert _same(want, got)
    assert eng.spec_rounds > 0 and len(eng._draft_cache["pos0"]["k"]) == 4
    assert eng._draft_pool.n_shards == 4


def test_sharded_capacity_scales_with_shards(bridged):
    """At the same blocks per shard, 4 shards hold 4x the pool and admit
    at least 3x the concurrent rows, at parity with the 1-shard engine;
    ``cache_nbytes`` counts every shard's pool."""
    _, tcfg, _, tparams = bridged
    per_shard = 8
    rng = np.random.default_rng(5)
    prompts = [rng.integers(8, tcfg.vocab_size, size=6).astype(np.int32) for _ in range(12)]

    def run(shards):
        eng = TE.ServeEngine(tcfg, tparams, TE.ServeConfig(
            max_batch=12, max_prompt_len=12, max_new_tokens=3, sched_chunk=2, paged=True, block_size=4,
            n_pool_blocks=per_shard * shards, shards=shards), device="cpu")
        sched = Scheduler()
        sched.submit_many(prompts, 3)
        res = eng.serve(sched)
        return res, eng.scfg.max_batch - sched.latency_stats()["min_free_slots"], eng.cache_nbytes()

    res1, peak1, nb1 = run(1)
    res4, peak4, nb4 = run(4)
    assert all(np.array_equal(res1[r], res4[r]) for r in res1)
    assert peak4 >= 3 * peak1
    assert nb4 == 4 * nb1


def test_sharded_paged_copy_block_uses_global_ids():
    """Copy-on-write on a sharded cache: global ids resolve to (shard,
    local) on both ends."""
    cfg = t_smoke(t_get("qwen3-0.6b")).with_overrides(dtype="float32")
    cache = TLM.init_paged_cache(cfg, 5, 4, dtype=torch.float32, device="cpu", n_shards=3)
    leaf = cache["pos0"]["k"]
    assert len(leaf) == 3 and tuple(leaf[0].shape[1:3]) == (5, 4)
    leaf[1][:, 2] = 7.0  # global block 1 * 4 + 2 = 6
    TLM.paged_copy_block(cfg, cache, 6, 9)  # -> shard 2, local 1
    assert bool((leaf[2][:, 1] == 7.0).all()) and bool((leaf[2][:, 0] == 0).all())


def test_sharded_config_validation(bridged, monkeypatch):
    """The reference's ValueErrors, and the port's mesh checks."""
    _, tcfg, _, tparams = bridged

    def make(device="cpu", mesh=None, **kw):
        return TE.ServeEngine(tcfg, tparams, TE.ServeConfig(**{**_kw(block_size=4), **kw}), device=device, mesh=mesh)

    with pytest.raises(ValueError, match="requires paged=True"):
        make(shards=2, paged=False)
    with pytest.raises(ValueError, match="must be >= 1"):
        make(shards=0)
    with pytest.raises(ValueError, match="must divide evenly"):
        make(shards=3)
    with pytest.raises(ValueError, match="cannot hold one max-size request"):
        make(shards=8)  # 2 blocks per shard, a row needs 4
    with pytest.raises(ValueError, match="on a mesh of"):
        make(shards=4, mesh=_mesh(2))
    with pytest.raises(ValueError, match="needs shards"):
        make(mesh=_mesh(2))
    assert make(shards=2)._mesh.devices == (torch.device("cpu"),) * 2
    # a CUDA engine takes the first N cards: too few raise before anything is allocated
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs that many devices, have 1"):
        make(device="cuda", shards=2)
    assert make(device="cuda", shards=2, mesh=make_mesh(["cuda:0"] * 2))._mesh.size == 2


def test_mesh_and_gather():
    mesh = make_mesh(["cpu", "cpu", "cpu"])
    assert mesh.shape == {"data": 3} and mesh.size == 3 and mesh.lead == torch.device("cpu")
    t = [torch.full((2,), float(i)) for i in range(3)]
    g = gather(t, torch.device("cpu"))
    assert [x.data_ptr() for x in g] == [x.data_ptr() for x in t]  # already there: not copied
    # a flat list fills several axes only with a shape, as the reference's Mesh
    # takes only an array of its axes' rank
    with pytest.raises(ValueError):
        make_mesh(["cpu"] * 4, ("data", "model"))
    assert make_mesh(["cpu"] * 4, ("data", "model"), shape=(2, 2)).shape == {"data": 2, "model": 2}


def test_launcher_shards_on_cpu(capsys):
    """``launch.serve --shards 2 --device cpu`` serves through the sharded
    pool and prints the blocks free on each shard."""
    t_launch.main(["--queries", "2", "--n-facts", "16", "--max-new-tokens", "2", "--shards", "2",
                   "--block-size", "16", "--max-batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "sharded pool: 2 shards, blocks free by shard" in out and "recall@8" in out
