"""The port's dense LM against the reference, with the reference's own
weights carried over by ``params.from_reference``.

``mixed_step`` and paged ``decode_step`` logits and updated pools are
held to ``repro.models.lm`` run with ``attn_impl="pallas"`` (interpret
mode on the CPU) at atol 1e-4 in f32, for qwen3-0.6b (qk-norm, tied
embeddings) and llama3-8b (untied head) at smoke width.
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
    for name in ("qwen2-moe-a2.7b", "mamba2-1.3b", "jamba-1.5-large-398b"):
        with pytest.raises(NotImplementedError):
            TLM.param_specs(t_smoke(t_get(name)))
