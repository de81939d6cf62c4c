"""The port's dense LM against the reference, with the reference's own
weights carried over by ``params.from_reference``.

``mixed_step``, ``forward``, ``prefill`` and ``decode_step`` (paged and
contiguous) logits and updated caches are held to ``repro.models.lm`` run
with ``attn_impl="pallas"`` (interpret mode on the CPU) at atol 1e-4 in
f32, for qwen3-0.6b (qk-norm, tied embeddings) and llama3-8b (untied
head) at smoke width; the port's whole-sequence attention also against
the reference's oracles (``naive``, and ``flash_jnp`` past one chunk).
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
from repro_torch.configs import get_config as t_get, smoke_config as t_smoke  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models.params import ParamTree, from_reference, init_params, leaves  # noqa: E402

POL = ShardingPolicy(rules=base_rules(False), mesh=None)
T = torch.as_tensor


def _bridged(name, key=1):
    cfg = r_smoke(r_get(name)).with_overrides(dtype="float32", attn_impl="pallas")
    tcfg = t_smoke(t_get(name)).with_overrides(dtype="float32")
    params = r_init(RLM.param_specs(cfg), jax.random.PRNGKey(key))
    tparams = from_reference(TLM.param_specs(tcfg), jax.tree.map(np.asarray, params), device="cpu")
    return cfg, tcfg, params, tparams


@pytest.mark.parametrize("name", ["qwen3-0.6b", "llama3-8b"])
def test_mixed_then_decode_match_reference(name):
    cfg, tcfg, params, tparams = _bridged(name)
    assert ("head" in tparams) == (not tcfg.tie_embeddings)
    bs, n_pool = 4, 13
    rng = np.random.default_rng(0)
    # rows: a cold prompt chunk, a decode row, an idle slot; unallocated
    # table entries point at the trash block (index n_pool - 1)
    tables = np.array([[0, 1, 2, 3], [4, 5, 6, 12], [7, 8, 12, 12]], np.int32)
    tok = rng.integers(0, cfg.vocab_size, size=(3, 5)).astype(np.int32)
    q_start, q_len = np.array([0, 3, 2], np.int32), np.array([5, 1, 0], np.int32)
    cache = RLM.init_paged_cache(cfg, n_pool, bs, 0, dtype=jnp.float32)
    cache = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape), jnp.float32), cache)
    tcache = {k: {kk: T(np.array(v)) for kk, v in d.items()} for k, d in cache.items()}

    lr, cache = RLM.mixed_step(
        cfg, POL, params, jnp.asarray(tok), cache, jnp.asarray(tables),
        jnp.asarray(q_start), jnp.asarray(q_len), bs,
    )
    lt = TLM.mixed_step(tcfg, tparams, T(tok), tcache, T(tables), T(q_start), T(q_len), bs)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lr), rtol=0, atol=1e-4)
    for k in cache:
        for kk in cache[k]:
            live = np.asarray(cache[k][kk])[:, :-1]  # the trash block's content is unspecified
            np.testing.assert_allclose(tcache[k][kk].numpy()[:, :-1], live, rtol=0, atol=1e-4)

    pos = np.array([5, 4, 2], np.int32)
    dtok = rng.integers(0, cfg.vocab_size, size=(3, 1)).astype(np.int32)
    lr2, cache = RLM.decode_step(
        cfg, POL, params, cache, jnp.asarray(dtok), jnp.asarray(pos),
        block_tables=jnp.asarray(tables), block_size=bs,
    )
    lt2 = TLM.decode_step(tcfg, tparams, tcache, T(dtok), T(pos), T(tables), bs)
    np.testing.assert_allclose(lt2.numpy(), np.asarray(lr2), rtol=0, atol=1e-4)
    for k in cache:
        for kk in cache[k]:
            np.testing.assert_allclose(
                tcache[k][kk].numpy()[:, :-1], np.asarray(cache[k][kk])[:, :-1], rtol=0, atol=1e-4
            )


@pytest.mark.parametrize("name", ["qwen3-0.6b", "llama3-8b"])
@pytest.mark.parametrize("attn_impl", ["pallas", "naive", "flash_jnp"])
def test_forward_and_prefill_match_reference(name, attn_impl):
    """Whole-sequence logits; the prefill's contiguous cache; and the same
    logits from the port's paged ``mixed_step`` over the same prompt."""
    cfg, tcfg, params, tparams = _bridged(name)
    cfg = cfg.with_overrides(attn_impl=attn_impl, attn_chunk=16)  # flash_jnp: 48 keys = 3 chunks
    tok = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 48)).astype(np.int32)
    lr, _ = RLM.forward(cfg, POL, params, {"tokens": jnp.asarray(tok)})
    lt, aux = TLM.forward(tcfg, tparams, {"tokens": T(tok)})
    assert float(aux) == 0.0
    np.testing.assert_allclose(lt.numpy(), np.asarray(lr), rtol=0, atol=1e-4)

    lr_p, cache = RLM.prefill(cfg, POL, params, {"tokens": jnp.asarray(tok)}, cache_len=56)
    lt_p, tcache = TLM.prefill(tcfg, tparams, {"tokens": T(tok)}, cache_len=56)
    np.testing.assert_allclose(lt_p.numpy(), np.asarray(lr_p), rtol=0, atol=1e-4)
    for k in cache:
        for kk in cache[k]:
            assert tcache[k][kk].shape == cache[k][kk].shape
            np.testing.assert_allclose(tcache[k][kk].numpy(), np.asarray(cache[k][kk]), rtol=0, atol=1e-4)

    bs = 8
    pool = TLM.init_paged_cache(tcfg, 2 * 6 + 1, bs, dtype=torch.float32, device="cpu")
    tables = T(np.arange(12, dtype=np.int32).reshape(2, 6))
    lm = TLM.mixed_step(tcfg, tparams, T(tok), pool, tables, T([0, 0]), T([48, 48]), bs)
    np.testing.assert_allclose(lm.numpy(), lt.numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("per_row", [True, False], ids=["per_row_pos", "scalar_pos"])
def test_contiguous_decode_matches_reference(per_row):
    """``decode_step`` without block tables over ``prefill``'s stripes:
    logits and the updated stripes, per-row (ragged) and scalar pos."""
    cfg, tcfg, params, tparams = _bridged("qwen3-0.6b")
    rng = np.random.default_rng(4)
    tok = rng.integers(0, cfg.vocab_size, size=(3, 12)).astype(np.int32)
    _, cache = RLM.prefill(cfg, POL, params, {"tokens": jnp.asarray(tok)}, cache_len=20)
    _, tcache = TLM.prefill(tcfg, tparams, {"tokens": T(tok)}, cache_len=20)
    pos = np.array([12, 7, 9], np.int32) if per_row else np.int32(12)
    for step in range(3):
        dtok = rng.integers(0, cfg.vocab_size, size=(3, 1)).astype(np.int32)
        lr, cache = RLM.decode_step(cfg, POL, params, cache, jnp.asarray(dtok), jnp.asarray(pos + step))
        lt = TLM.decode_step(tcfg, tparams, tcache, T(dtok), T(pos + step))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lr), rtol=0, atol=1e-4)
    for k in cache:
        for kk in cache[k]:
            np.testing.assert_allclose(tcache[k][kk].numpy(), np.asarray(cache[k][kk]), rtol=0, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_core_matches_oracles(causal, dtype):
    """``attention_core`` (the kernel's plain version on the CPU) against
    the port's and the reference's materialised and chunked oracles."""
    from repro.models import layers as RL

    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((2, 32, h, 16)).astype(np.float32) for h in (8, 2, 2))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tq, tk, tv = (T(a).to(tdt) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    tcfg = t_smoke(t_get("qwen3-0.6b"))
    got = TL.attention_core(tcfg, tq, tk, tv, causal=causal).float().numpy()
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    wants = [
        TL.naive_attention(tq, tk, tv, causal=causal).float().numpy(),
        TL.flash_jnp_attention(tq, tk, tv, causal=causal, chunk=8).float().numpy(),
        np.asarray(RL.naive_attention(jq, jk, jv, causal=causal), np.float32),
        np.asarray(RL.flash_jnp_attention(jq, jk, jv, causal=causal, chunk=8), np.float32),
    ]
    for want in wants:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_param_specs_match_reference_tree():
    for name in ("qwen3-0.6b", "llama3-8b", "smollm-360m"):
        r_specs = RLM.param_specs(r_smoke(r_get(name)))
        t_specs = TLM.param_specs(t_smoke(t_get(name)))
        r_leaves = jax.tree_util.tree_flatten_with_path(r_specs, is_leaf=lambda x: hasattr(x, "fan_in_dims"))[0]
        r_map = {"/".join(p.key for p in path): (s.shape, s.init, s.fan_in_dims) for path, s in r_leaves}
        t_map = {p: (s.shape, s.init, s.fan_in_dims) for p, s in leaves(t_specs)}
        assert r_map == t_map


def test_init_params_follows_init_rules():
    tcfg = t_smoke(t_get("llama3-8b"))
    p = init_params(TLM.param_specs(tcfg), torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(p["final_norm"], torch.ones(tcfg.d_model))
    wq = p["blocks"]["pos0"]["attn"]["wq"]  # fan_in over d_model
    assert abs(wq.std().item() - tcfg.d_model ** -0.5) < 0.02
    assert abs(p["embed"]["tok"].std().item() - 0.02) < 0.002
    tree = ParamTree(p)
    assert all(not t.requires_grad for t in tree.parameters())
    assert torch.equal(tree.tree()["blocks"]["pos0"]["attn"]["wq"], wq)


def test_embed_rejects_out_of_range_ids():
    tcfg = t_smoke(t_get("qwen3-0.6b"))  # vocab 256
    p = {"tok": torch.zeros(tcfg.vocab_size, tcfg.d_model)}
    assert TL.embed_apply(tcfg, p, T([[0, 255]])).shape == (1, 2, tcfg.d_model)
    for bad in (256, 8191, -1):
        with pytest.raises(ValueError, match="outside the model's vocabulary"):
            TL.embed_apply(tcfg, p, T([[3, bad]]))


def test_non_dense_families_raise():
    # mamba2-1.3b (ssm) and qwen2-moe-a2.7b (moe) are ported:
    # tests/test_torch_mamba2.py, tests/test_torch_moe.py
    TLM.param_specs(t_smoke(t_get("qwen2-moe-a2.7b")))
    for name in ("jamba-1.5-large-398b", "pixtral-12b"):
        with pytest.raises(NotImplementedError):
            TLM.param_specs(t_smoke(t_get(name)))
