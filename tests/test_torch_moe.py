"""The port's MoE layer and MoE LM against the reference, on the
reference's own weights carried over by ``params.from_reference``.

``moe_apply`` (routed experts, shared experts and their sigmoid gate, the
load-balance loss) within rtol/atol 1e-5 of ``repro.models.moe``'s,
including capacity drops at slack 0.25; ``_capacity`` equal over a grid;
gates renormalised and padded experts never routed.  Smoke-width
qwen2-moe-a2.7b (H = KV = 4 heads, so one query head per KV head; 8
experts allocated as 16, top-4, one shared expert): ``forward`` with its
aux loss, ``prefill``, ``mixed_step`` and ``decode_step`` within 2e-5 in
f32; the paged, contiguous and lock-step engines token-exact within the
port and equal to the reference engine's tokens (or first different where
the reference's top-2 margin is under 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as r_get, smoke_config as r_smoke  # noqa: E402
from repro.configs.base import ModelConfig as RCfg  # noqa: E402
from repro.models import lm as RLM  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro.models.params import init_params as r_init  # noqa: E402
from repro.runtime.sharding import ShardingPolicy, base_rules  # noqa: E402
from repro.serving.engine import ServeConfig as RServe, ServeEngine as REngine  # noqa: E402
from repro_torch.configs import get_config as t_get, smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import ModelConfig as TCfg  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.params import from_reference  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402

POL = ShardingPolicy(rules=base_rules(False), mesh=None)
T = torch.as_tensor


def _layer(e=8, k=2, shared=0, slack=4.0, tp_hint=1, seed=0):
    kw = dict(name="t", family="moe", d_model=32, n_experts=e, moe_top_k=k, moe_d_ff=64, d_ff=64,
              n_shared_experts=shared, capacity_slack=slack)
    cfg, tcfg = RCfg(**kw), TCfg(**kw)
    p = r_init(RMOE.moe_specs(cfg, tp_hint=tp_hint), jax.random.PRNGKey(seed))
    tp = from_reference(TMOE.moe_specs(tcfg, tp_hint=tp_hint), jax.tree.map(np.asarray, p), device="cpu")
    x = np.random.default_rng(seed).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    return cfg, tcfg, p, tp, x


@pytest.mark.parametrize("e,k,shared", [(4, 1, 0), (8, 2, 0), (8, 2, 1), (16, 4, 0)])
def test_moe_apply_matches_reference(e, k, shared):
    cfg, tcfg, p, tp, x = _layer(e, k, shared)
    out_r, aux_r = RMOE.moe_apply(cfg, POL, p, jnp.asarray(x))
    out_t, aux_t = TMOE.moe_apply(tcfg, tp, T(x))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_r), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux_t), float(aux_r), rtol=1e-5)
    # and the port's own dense oracle (plus the shared experts) agrees
    ref, aux_o = TMOE.moe_reference(tcfg, tp, T(x))
    if shared:
        xt = T(x)
        gate = torch.sigmoid(xt @ tp["shared_gate"])
        ref = ref + TMOE.mlp_apply(tcfg, tp["shared"], xt) * gate
    np.testing.assert_allclose(out_t.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    assert float(aux_o) == float(aux_t)


def test_capacity_drops_match_reference():
    """At slack 0.25 the tail of the expert-sorted pairs drops: the port
    drops the same pairs as the reference, so the outputs agree, and both
    differ from the dense oracle."""
    cfg, tcfg, p, tp, x = _layer(slack=0.25)
    out_r, _ = RMOE.moe_apply(cfg, POL, p, jnp.asarray(x))
    out_t, _ = TMOE.moe_apply(tcfg, tp, T(x))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_r), rtol=1e-5, atol=1e-5)
    ref, _ = TMOE.moe_reference(tcfg, tp, T(x))
    assert float((out_t - ref).abs().max()) > 1e-3, "expected drops under tight capacity"
    assert bool(torch.isfinite(out_t).all())


@pytest.mark.parametrize("slack", [0.25, 1.0, 1.5])
def test_capacity_formula_matches_reference(slack):
    for t in (1, 2, 7, 64, 2048):
        for k in (1, 2, 4):
            for tp in (1, 2, 4, 16):
                kw = dict(name="t", n_experts=16, moe_top_k=k, capacity_slack=slack)
                assert TMOE._capacity(TCfg(**kw), t, tp) == RMOE._capacity(RCfg(**kw), t, tp)


def test_router_gates_renormalised_and_padding_never_routed():
    cfg, tcfg, p, tp, _ = _layer(e=6, k=2, tp_hint=4)  # 6 experts allocated as 8
    assert tp["router"].shape[-1] == 8 == TMOE.padded_experts(tcfg, 4)
    x = np.random.default_rng(3).standard_normal((64, cfg.d_model)).astype(np.float32)
    gates, ids, probs = TMOE._route(tcfg, tp["router"], T(x))
    np.testing.assert_allclose(gates.sum(-1).numpy(), np.ones(64), rtol=1e-6)
    assert bool((ids < tcfg.n_experts).all()), "padded experts must never be routed"
    assert bool((probs[:, tcfg.n_experts:] == 0).all())
    g_r, i_r, _ = RMOE._route(cfg, p["router"], jnp.asarray(x))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(i_r))
    np.testing.assert_allclose(gates.numpy(), np.asarray(g_r), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------- #
# smoke-width qwen2-moe-a2.7b
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def bridged():
    cfg = r_smoke(r_get("qwen2-moe-a2.7b")).with_overrides(dtype="float32", attn_impl="pallas")
    tcfg = t_smoke(t_get("qwen2-moe-a2.7b")).with_overrides(dtype="float32")
    assert tcfg.n_heads == tcfg.n_kv_heads == 4 and tcfg.n_experts == 8 and tcfg.moe_top_k == 4
    params = r_init(RLM.param_specs(cfg), jax.random.PRNGKey(1))
    tparams = from_reference(TLM.param_specs(tcfg), jax.tree.map(np.asarray, params), device="cpu")
    assert tparams["blocks"]["pos0"]["moe"]["wg"].shape[1] == 16  # 8 experts padded to 16
    return cfg, tcfg, params, tparams


def test_forward_and_prefill_match_reference(bridged):
    cfg, tcfg, params, tparams = bridged
    tok = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    lr, aux_r = RLM.forward(cfg, POL, params, {"tokens": jnp.asarray(tok)})
    lt, aux_t = TLM.forward(tcfg, tparams, {"tokens": T(tok)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lr), rtol=0, atol=2e-5)
    np.testing.assert_allclose(float(aux_t), float(aux_r), rtol=1e-5)
    assert float(aux_t) > 0
    lr_p, cache = RLM.prefill(cfg, POL, params, {"tokens": jnp.asarray(tok)}, cache_len=32)
    lt_p, tcache = TLM.prefill(tcfg, tparams, {"tokens": T(tok)}, cache_len=32)
    np.testing.assert_allclose(lt_p.numpy(), np.asarray(lr_p), rtol=0, atol=2e-5)
    for k in cache:
        for kk in cache[k]:
            np.testing.assert_allclose(tcache[k][kk].numpy(), np.asarray(cache[k][kk]), rtol=0, atol=2e-5)


def test_mixed_then_decode_match_reference(bridged):
    cfg, tcfg, params, tparams = bridged
    bs, n_pool = 4, 13
    rng = np.random.default_rng(0)
    tables = np.array([[0, 1, 2, 3], [4, 5, 6, 12], [7, 8, 12, 12]], np.int32)
    tok = rng.integers(0, cfg.vocab_size, size=(3, 5)).astype(np.int32)
    q_start, q_len = np.array([0, 3, 2], np.int32), np.array([5, 1, 0], np.int32)
    cache = RLM.init_paged_cache(cfg, n_pool, bs, 0, dtype=jnp.float32)
    cache = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape), jnp.float32), cache)
    tcache = {k: {kk: T(np.array(v)) for kk, v in d.items()} for k, d in cache.items()}
    lr, cache = RLM.mixed_step(cfg, POL, params, jnp.asarray(tok), cache, jnp.asarray(tables),
                               jnp.asarray(q_start), jnp.asarray(q_len), bs)
    lt = TLM.mixed_step(tcfg, tparams, T(tok), tcache, T(tables), T(q_start), T(q_len), bs)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lr), rtol=0, atol=2e-5)
    lv = TLM.verify_step(tcfg, tparams, T(tok), {k: {kk: v.clone() for kk, v in d.items()} for k, d in tcache.items()},
                         T(tables), T(q_start), T(q_len), bs)
    assert torch.equal(lv, lt)  # verify_step is mixed_step
    pos = np.array([5, 4, 2], np.int32)
    dtok = rng.integers(0, cfg.vocab_size, size=(3, 1)).astype(np.int32)
    lr2, cache = RLM.decode_step(cfg, POL, params, cache, jnp.asarray(dtok), jnp.asarray(pos),
                                 block_tables=jnp.asarray(tables), block_size=bs)
    lt2 = TLM.decode_step(tcfg, tparams, tcache, T(dtok), T(pos), T(tables), bs)
    np.testing.assert_allclose(lt2.numpy(), np.asarray(lr2), rtol=0, atol=2e-5)
    for k in cache:
        for kk in cache[k]:
            np.testing.assert_allclose(tcache[k][kk].numpy()[:, :-1], np.asarray(cache[k][kk])[:, :-1],
                                       rtol=0, atol=2e-5)


def _margin(cfg, params, prompt, answer_prefix):
    seq = np.concatenate([prompt, answer_prefix]).astype(np.int32)[None]
    logits, _ = RLM.forward(cfg, POL, params, {"tokens": jnp.asarray(seq)})
    top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
    return float(top2[1] - top2[0])


def test_engines_token_exact_and_match_reference(bridged):
    cfg, tcfg, params, tparams = bridged
    rng = np.random.default_rng(7)
    prompts = [rng.integers(8, cfg.vocab_size, size=n).astype(np.int32) for n in (9, 16, 5, 12, 3)]
    budgets = [6, 2, 6, 4, 6]
    base = dict(max_batch=3, max_prompt_len=16, max_new_tokens=6, sched_chunk=2)
    outs = {}
    for name, kw in (("paged", dict(paged=True, block_size=4, token_budget=10)), ("contiguous", {})):
        outs[name] = TE.ServeEngine(tcfg, tparams, TE.ServeConfig(**base, **kw), device="cpu").serve_prompts(
            prompts, budgets)
    lock = TE.engine_generator(TE.ServeEngine(tcfg, tparams, TE.ServeConfig(**base), device="cpu"), mode="lockstep")
    outs["lock-step"] = lock.generate_batch(prompts)
    for a, b, c, n in zip(outs["contiguous"], outs["paged"], outs["lock-step"], budgets):
        assert np.array_equal(a, b)
        assert np.array_equal(a, c[: len(a)]) and len(a) == n
    r_cfg = cfg.with_overrides(attn_impl="naive")  # the engines' reference run, without interpret-mode Pallas
    want = REngine(r_cfg, POL, params, RServe(**base)).serve_prompts(prompts, max_new_tokens=budgets)
    for p, w, g in zip(prompts, want, outs["contiguous"]):
        w = np.asarray(w)
        if not np.array_equal(w, g):
            j = next((i for i in range(min(len(w), len(g))) if w[i] != g[i]), None)
            assert j is not None, (w, g)
            assert _margin(r_cfg, params, p, w[:j]) < 1e-4, (w, g)
