"""The port's hybrid family (jamba-1.5-large-398b) against the reference,
with the reference's own weights carried over by ``params.from_reference``.

Smoke-width jamba in f32: 16 layers (two scan periods of 8: attention at
period position 0, Mamba2 at 1-7, MoE of 8 experts top-2 at the odd
positions), d_model 64, 4 / 2 attention heads of 16, 8 SSM heads of 16 in
8 groups, state 16, chunk 16.  Tolerances: one layer from the
reference's own input 1e-4 (tests/test_kernels.py's SSD tolerance); the
whole 16-layer forward, prefill and decode 2e-3, as tests/test_models.py
holds chunked prefill against the recurrent decode: each layer's f32
reassociation (under 1.1e-5 at activations near 15) grows through the
Mamba2 layers' state to about 8e-4 at the logits.  Served tokens equal,
or first differ where the reference's top-2 logit margin at that step is
under 1e-4, that margin computed the way the reference's contiguous
engine computes the step (the prompt prefilled with its PAD tail, which
the Mamba2 layers fold into their state, then one decode step per earlier
answer token).  Both packages refuse the model on the paged engine.
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
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import mamba2 as TM  # noqa: E402
from repro_torch.models.params import from_reference, leaves, map_tree  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402

POL = ShardingPolicy(rules=base_rules(False), mesh=None)
T = torch.as_tensor
ARCH = "jamba-1.5-large-398b"
VOCAB = 8192  # the HashTokenizer's: the served model must cover every prompt id


def _bridge(vocab=None, key=1):
    kw = {} if vocab is None else dict(vocab_size=vocab)
    cfg = r_smoke(r_get(ARCH)).with_overrides(dtype="float32", attn_impl="naive", **kw)
    tcfg = t_smoke(t_get(ARCH)).with_overrides(dtype="float32", **kw)
    params = r_init(RLM.param_specs(cfg), jax.random.PRNGKey(key))
    return cfg, tcfg, params, from_reference(TLM.param_specs(tcfg), jax.tree.map(np.asarray, params), device="cpu")


@pytest.fixture(scope="module")
def bridged():
    return _bridge()


@pytest.fixture(scope="module")
def bridged_served():
    return _bridge(vocab=VOCAB, key=3)


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def _spec_map(specs, reference: bool):
    if reference:
        flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: hasattr(x, "fan_in_dims"))[0]
        return {"/".join(p.key for p in path): (s.shape, s.init, s.fan_in_dims) for path, s in flat}
    return {p: (s.shape, s.init, s.fan_in_dims) for p, s in leaves(specs)}


@pytest.mark.parametrize("width", ["smoke", "full"])
def test_param_specs_match_reference_tree(width):
    """Every leaf's path, shape, initializer and fan-in dims equal the
    reference's (so ``from_reference`` is one to one), at smoke width and
    at the published 72 layers; each period position holds the mixer and
    FFN that ``mixer_kind`` / ``ffn_kind`` name."""
    cfg, tcfg = r_get(ARCH), t_get(ARCH)
    if width == "smoke":
        cfg, tcfg = r_smoke(cfg), t_smoke(tcfg)
    t_specs = TLM.param_specs(tcfg)
    assert _spec_map(t_specs, False) == _spec_map(RLM.param_specs(cfg), True)
    assert tcfg.scan_period == 8
    for j in range(8):
        pos = t_specs["blocks"][f"pos{j}"]
        assert ("attn" in pos, "mamba" in pos) == (j == 0, j > 0), j
        assert ("moe" in pos, "mlp" in pos) == (j % 2 == 1, j % 2 == 0), j


@pytest.mark.parametrize("j", range(8))
def test_each_layer_matches_reference(bridged, j):
    """Period position ``j`` of both blocks (mixer and FFN) from the
    reference's own input: the same output at 1e-4, and the MoE layers'
    load-balance loss."""
    cfg, tcfg, params, tparams = bridged
    rng = np.random.default_rng(j)
    h = (rng.standard_normal((2, 24, cfg.d_model)) * 2).astype(np.float32)
    pos = np.broadcast_to(np.arange(24), (2, 24))
    for i in range(cfg.n_blocks):
        pp = jax.tree.map(lambda t: t[i], params["blocks"][f"pos{j}"])
        want, _, aux_r = RLM._run_position(cfg, POL, j, pp, jnp.asarray(h), jnp.asarray(pos), "train", None, 0)
        tpp = map_tree(lambda t: t[i], tparams["blocks"][f"pos{j}"])
        x = TL.rmsnorm(T(h), tpp["mixer_norm"], tcfg.norm_eps)
        o = TM.mamba_apply(tcfg, tpp["mamba"], x)[0] if j else TL.attn_apply(tcfg, tpp["attn"], x, T(pos.copy()))
        got, aux = TLM._ffn(tcfg, tpp, T(h) + o)
        _close(got, want, 1e-4)
        assert (aux is None) == (j % 2 == 0)
        if aux is not None:
            assert float(aux) == pytest.approx(float(aux_r), rel=1e-5)


def test_forward_matches_reference(bridged):
    cfg, tcfg, params, tparams = bridged
    tok = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    full_r, aux_r = RLM.forward(cfg, POL, params, {"tokens": jnp.asarray(tok)})
    full_t, aux_t = TLM.forward(tcfg, tparams, {"tokens": T(tok)})
    assert tuple(full_t.shape) == (2, 24, cfg.vocab_size)
    _close(full_t, full_r, 2e-3)
    assert float(aux_t) == pytest.approx(float(aux_r), rel=1e-4)


def test_prefill_and_decode_match_reference_and_forward(bridged):
    """``prefill`` (logits, every attention layer's K/V and every Mamba2
    layer's conv / SSM state) over a chunk and a padded partial chunk, then
    3 contiguous decode steps against the reference's, and against the
    port's own teacher-forced forward."""
    cfg, tcfg, params, tparams = bridged
    tok = np.random.default_rng(6).integers(0, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    full_t, _ = TLM.forward(tcfg, tparams, {"tokens": T(tok)})
    p = 13
    lg_r, cache = RLM.prefill(cfg, POL, params, {"tokens": jnp.asarray(tok[:, :p])}, cache_len=24)
    lg_t, tcache = TLM.prefill(tcfg, tparams, {"tokens": T(tok[:, :p])}, cache_len=24)
    _close(lg_t, lg_r, 2e-3)
    for t in range(p, p + 3):
        lr, cache = RLM.decode_step(cfg, POL, params, cache, jnp.asarray(tok[:, t : t + 1]), t)
        lt = TLM.decode_step(tcfg, tparams, tcache, T(tok[:, t : t + 1]), T(t))
        _close(lt, lr, 2e-3)
        np.testing.assert_allclose(lt[:, 0].numpy(), full_t[:, t].numpy(), rtol=2e-3, atol=2e-3)
    assert set(tcache) == set(cache) == {f"pos{j}" for j in range(8)}
    for key, sub in cache.items():
        if key == "pos0":
            for kk in ("k", "v"):
                _close(tcache[key][kk][:, :, : p + 3], sub[kk][:, :, : p + 3], 2e-3)
        else:
            _close(tcache[key]["ssm"], sub["ssm"], 2e-3)
            for a, b in zip(tcache[key]["conv"], sub["conv"]):
                _close(a, b, 2e-3)


def test_init_cache_leaves_per_mixer():
    """Attention positions get K/V stripes, Mamba2 positions three conv
    histories and an f32 SSM state: the reference's leaves, shapes and
    dtypes."""
    cfg, tcfg = r_smoke(r_get(ARCH)), t_smoke(t_get(ARCH))
    r = RLM.init_cache(cfg, 3, 40, dtype=jnp.float32)
    t = TLM.init_cache(tcfg, 3, 40, dtype=torch.bfloat16, device="cpu")
    assert set(t) == set(r)
    for key, sub in r.items():
        assert set(t[key]) == set(sub) == ({"k", "v"} if key == "pos0" else {"conv", "ssm"}), key
        if key == "pos0":
            for kk in ("k", "v"):
                assert tuple(t[key][kk].shape) == sub[kk].shape and t[key][kk].dtype == torch.bfloat16
        else:
            assert isinstance(t[key]["conv"], tuple) and len(t[key]["conv"]) == 3
            for a, b in zip(t[key]["conv"], sub["conv"]):
                assert tuple(a.shape) == b.shape and a.dtype == torch.bfloat16
            assert tuple(t[key]["ssm"].shape) == sub["ssm"].shape and t[key]["ssm"].dtype == torch.float32


def _engine_margin(cfg, params, prompt, prefix, width, n_new):
    """The reference's top-2 margin at answer token ``len(prefix)`` computed
    as its contiguous engine computes it: the prompt with its PAD tail to
    ``width`` prefilled, then one decode step per earlier answer token at
    the positions after the prompt."""
    row = np.full((1, width), PAD, np.int32)
    row[0, : len(prompt)] = prompt
    logits, cache = RLM.prefill(cfg, POL, params, {"tokens": jnp.asarray(row)}, cache_len=width + n_new)
    lg = logits[0, len(prompt) - 1]
    for t, tok in enumerate(prefix):
        logits, cache = RLM.decode_step(cfg, POL, params, cache, jnp.asarray([[tok]], jnp.int32),
                                        jnp.asarray([len(prompt) + t], jnp.int32))
        lg = logits[0, -1]
    top2 = np.sort(np.asarray(lg))[-2:]
    return float(top2[1] - top2[0])


def _assert_same_tokens(cfg, params, prompt, want, got, width, n_new):
    want, got = np.asarray(want), np.asarray(got)
    if not np.array_equal(want, got):
        j = next((i for i in range(min(len(want), len(got))) if want[i] != got[i]), None)
        assert j is not None, (want, got)
        assert _engine_margin(cfg, params, np.asarray(prompt), want[:j], width, n_new) < 1e-4, (want, got)


def test_contiguous_and_lockstep_match_reference(bridged_served):
    """The contiguous engine (ragged prompts and budgets, bucketed admits
    over a 48-wide packed prefill) and the lock-step baseline give the
    reference's tokens and dispatch counts."""
    cfg, tcfg, params, tparams = bridged_served
    kw = dict(max_batch=2, max_prompt_len=48, max_new_tokens=5, sched_chunk=2)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(8, VOCAB, size=n).astype(np.int32) for n in (40, 17, 48, 5, 23)]
    budgets = [5, 2, 4, 5, 1]
    r_eng = REngine(cfg, POL, params, RServe(**kw))
    t_eng = TE.ServeEngine(tcfg, tparams, TE.ServeConfig(**kw), device="cpu")
    want = r_eng.serve_prompts(prompts, max_new_tokens=budgets)
    got = t_eng.serve_prompts(prompts, max_new_tokens=budgets)
    for p, w, g in zip(prompts, want, got):
        _assert_same_tokens(cfg, params, p, w, g, 48, 5)
    assert (r_eng.admit_dispatches, r_eng.decode_dispatches) == (t_eng.admit_dispatches, t_eng.decode_dispatches)
    assert t_eng.admit_dispatches >= 2
    r_lock = r_gen(REngine(cfg, POL, params, RServe(**kw)), mode="lockstep")
    t_lock = TE.engine_generator(TE.ServeEngine(tcfg, tparams, TE.ServeConfig(**kw), device="cpu"), mode="lockstep")
    for p, w, g in zip(prompts, r_lock.generate_batch(prompts), t_lock.generate_batch(prompts)):
        _assert_same_tokens(cfg, params, p, w, g, 48, 5)


def test_serve_matches_reference(bridged_served):
    """``CFedRAGSystem.serve`` on the contiguous jamba engine: the
    reference's prompts, statuses, dispatch counts and answer tokens."""
    cfg, tcfg, params, tparams = bridged_served
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
        _assert_same_tokens(cfg, params, a["prompt"], a["answer_tokens"], b["answer_tokens"], 96, 6)
    rs, ts = r_sys.last_serve_stats, t_sys.last_serve_stats
    for key in ("admit_dispatches", "mixed_dispatches", "decode_dispatches", "engine_steps"):
        assert rs[key] == ts[key], key


def test_paged_path_refuses_hybrid(bridged_served):
    """The paged engine refuses jamba with the reference's ValueError, the
    launcher with its own; the paged cache, the unified mixed step and
    paged decode raise, as the reference's mixed mode does."""
    cfg, tcfg, params, tparams = bridged_served
    with pytest.raises(ValueError, match="all-attention"):
        REngine(cfg, POL, params, RServe(paged=True))
    with pytest.raises(ValueError, match="all-attention"):
        TE.ServeEngine(tcfg, tparams, TE.ServeConfig(paged=True), device="cpu")
    with pytest.raises(ValueError, match="contiguous"):
        t_launch.full_width_system(1, "cpu", paged=True, arch=ARCH)
    with pytest.raises(NotImplementedError, match="attention"):
        TLM.init_paged_cache(tcfg, 4, 8, dtype=torch.float32, device="cpu")
    cache = TLM.init_cache(tcfg, 1, 8, dtype=torch.float32, device="cpu")
    tok = T(np.zeros((1, 4), np.int32))
    tables = T(np.zeros((1, 1), np.int32))
    lanes = TLM.Lanes(*(T(a) for a in TLM.pack_lanes([0], [4], [1], np.zeros((1, 1), np.int32), 8).values()))
    with pytest.raises(NotImplementedError, match="attention"):
        TLM.mixed_step(tcfg, tparams, tok[0], cache, tables, lanes)
    with pytest.raises(NotImplementedError, match="attention"):
        TLM.decode_step(tcfg, tparams, cache, tok[:, :1], T([0]), block_tables=tables, block_size=8)


def test_full_width_cuts():
    """The launcher's jamba is one scan period with the routed experts'
    hidden width 4,096 (12.93 B parameters) and every other width as
    published."""
    from repro_torch.models.params import param_count

    full, cut = t_get(ARCH), t_launch.full_width_config(ARCH)
    assert (cut.n_layers, cut.scan_period, cut.moe_d_ff) == (8, 8, 4096)
    assert cut.with_overrides(n_layers=full.n_layers, moe_d_ff=full.moe_d_ff) == full
    assert param_count(TLM.param_specs(cut)) == 12_932_288_768
    assert t_launch.full_width_config("qwen3-0.6b") == t_get("qwen3-0.6b")


@pytest.mark.parametrize("j", range(8))
def test_layer_gradients_match_jax_vjp(bridged, j):
    """The backward of period position ``j`` (mixer and FFN, both blocks):
    the gradients of sum(out * cotangent) plus the MoE load-balance loss
    with respect to the layer's input and every parameter leaf, against
    ``jax.vjp`` of the reference's layer, at 1e-4 of each leaf's largest
    entry (tests/test_torch_train.py's gradient tolerance)."""
    cfg, tcfg, params, tparams = bridged
    rng = np.random.default_rng(10 + j)
    h = (rng.standard_normal((2, 32, cfg.d_model)) * 2).astype(np.float32)
    ct = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32), (2, 32)).copy()
    for i in range(cfg.n_blocks):
        pp = jax.tree.map(lambda t: t[i], params["blocks"][f"pos{j}"])

        def ref(hh, p):
            out, _, aux = RLM._run_position(cfg, POL, j, p, hh, jnp.asarray(pos), "train", None, 0)
            return jnp.sum(out * ct) + aux

        want_h, want_p = jax.grad(ref, argnums=(0, 1))(jnp.asarray(h), pp)
        tpp = map_tree(lambda t: t[i].clone().requires_grad_(True), tparams["blocks"][f"pos{j}"])
        th = T(h).requires_grad_(True)
        x = TL.rmsnorm(th, tpp["mixer_norm"], tcfg.norm_eps)
        o = TM.mamba_apply(tcfg, tpp["mamba"], x)[0] if j else TL.attn_apply(tcfg, tpp["attn"], x, T(pos))
        out, aux = TLM._ffn(tcfg, tpp, th + o)
        loss = (out * T(ct)).sum() + (aux if aux is not None else 0.0)
        got = torch.autograd.grad(loss, [th] + [t for _, t in leaves(tpp)])
        wants = [np.asarray(want_h)] + [np.asarray(w) for _, w in leaves(jax.tree.map(np.asarray, want_p))]
        names = ["input"] + [p for p, _ in leaves(tpp)]
        for name, g, w in zip(names, got, wants, strict=True):
            assert np.abs(g.numpy() - w).max() <= 1e-4 * max(float(np.abs(w).max()), 1e-12), (i, name)
