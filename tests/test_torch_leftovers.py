"""The port's small leftovers against the reference: ``lm.generate`` and
the parameter helpers ``param_count``, ``param_bytes`` and ``cast_tree``.

Greedy ``generate`` gives the reference's tokens, or first differs where
the reference's top-2 margin is under 1e-4 (smoke-width dense, MoE and
Mamba2 models on the reference's weights).  A sampled ``generate`` draws
from an explicit ``torch.Generator``, which cannot reproduce JAX's keys:
it is held to its own determinism under one seed, to the vocabulary, and
to the greedy tokens as the temperature goes to 0.  ``param_count`` and
``param_bytes`` equal the reference's for every configuration the port
can build, at full width (declarations only: nothing is allocated).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as r_get, smoke_config as r_smoke  # noqa: E402
from repro.models import cross_encoder as RCE  # noqa: E402
from repro.models import dual_encoder as RDE  # noqa: E402
from repro.models import lm as RLM  # noqa: E402
from repro.models import params as RP  # noqa: E402
from repro.runtime.sharding import ShardingPolicy, base_rules  # noqa: E402
from repro_torch.configs import all_configs, get_config as t_get, smoke_config as t_smoke  # noqa: E402
from repro_torch.models import cross_encoder as TCE  # noqa: E402
from repro_torch.models import dual_encoder as TDE  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402

POL = ShardingPolicy(rules=base_rules(False), mesh=None)
T = torch.as_tensor


def _bridged(name):
    cfg = r_smoke(r_get(name)).with_overrides(dtype="float32", attn_impl="naive")
    tcfg = t_smoke(t_get(name)).with_overrides(dtype="float32")
    params = RP.init_params(RLM.param_specs(cfg), jax.random.PRNGKey(3))
    return cfg, tcfg, params, TP.from_reference(TLM.param_specs(tcfg), jax.tree.map(np.asarray, params), device="cpu")


def _margin(cfg, params, prompt, answer_prefix):
    seq = np.concatenate([prompt, answer_prefix]).astype(np.int32)[None]
    logits, _ = RLM.forward(cfg, POL, params, {"tokens": jnp.asarray(seq)})
    top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
    return float(top2[1] - top2[0])


@pytest.mark.parametrize("name", ["qwen3-0.6b", "llama3-8b", "qwen2-moe-a2.7b", "mamba2-1.3b"])
def test_greedy_generate_matches_reference(name):
    cfg, tcfg, params, tparams = _bridged(name)
    tok = np.random.default_rng(4).integers(8, cfg.vocab_size, size=(3, 12)).astype(np.int32)
    want = np.asarray(RLM.generate(cfg, POL, params, {"tokens": jnp.asarray(tok)}, 6))
    got = TLM.generate(tcfg, tparams, {"tokens": T(tok)}, 6)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 6)
    for p, w, g in zip(tok, want, got.numpy()):
        if not np.array_equal(w, g):
            j = next(i for i in range(len(w)) if w[i] != g[i])
            assert _margin(cfg, params, p, w[:j]) < 1e-4, (w, g)


def test_sampled_generate_is_deterministic_under_one_seed():
    _, tcfg, _, tparams = _bridged("qwen3-0.6b")
    tok = T(np.random.default_rng(5).integers(8, tcfg.vocab_size, size=(4, 10)).astype(np.int32))

    def run(seed, temperature=1.0):
        return TLM.generate(tcfg, tparams, {"tokens": tok}, 8, temperature=temperature,
                            generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b), "one seed, one draw"
    assert not torch.equal(a, c), "another seed draws otherwise"
    assert bool(((a >= 0) & (a < tcfg.vocab_size)).all())
    greedy = TLM.generate(tcfg, tparams, {"tokens": tok}, 8)
    assert torch.equal(run(0, temperature=1e-6), greedy)  # T -> 0 is the argmax
    with pytest.raises(ValueError, match="torch.Generator"):
        TLM.generate(tcfg, tparams, {"tokens": tok}, 2, temperature=1.0)


def _buildable():
    """(name, the port's `param_specs`, the reference's) of every model the
    port builds: every LM family it takes, and the two encoders."""
    out = []
    for name, cfg in all_configs().items():
        if cfg.family == "encoder":
            if name == "contriever-110m":
                out.append((name, TDE.param_specs, RDE.param_specs))
            elif name == "bge-reranker-base":
                out.append((name, TCE.param_specs, RCE.param_specs))
            continue
        try:
            TLM.param_specs(cfg)
        except NotImplementedError:
            continue
        out.append((name, TLM.param_specs, RLM.param_specs))
    return out


def test_param_count_and_bytes_match_reference():
    built = _buildable()
    assert {"qwen2-moe-a2.7b", "qwen3-4b", "qwen3-0.6b", "mamba2-1.3b", "contriever-110m"} <= {n for n, _, _ in built}
    for name, t_specs, r_specs in built:
        ts, rs = t_specs(t_get(name)), r_specs(r_get(name))
        assert TP.param_count(ts) == RP.param_count(rs), name
        assert TP.param_bytes(ts) == RP.param_bytes(rs), name
        assert TP.param_bytes(ts, torch.bfloat16) == RP.param_bytes(rs, jnp.bfloat16), name
    assert TP.param_count(TLM.param_specs(t_get("qwen2-moe-a2.7b"))) == 15_146_305_536


def test_cast_tree():
    tree = {"a": torch.ones(2, 3), "b": {"c": torch.arange(4, dtype=torch.int32), "d": torch.zeros(1, dtype=torch.float64)}}
    out = TP.cast_tree(tree, torch.bfloat16)
    assert out["a"].dtype == out["b"]["d"].dtype == torch.bfloat16
    assert out["b"]["c"].dtype == torch.int32 and torch.equal(out["b"]["c"], tree["b"]["c"])
    assert torch.equal(out["a"].float(), tree["a"])
    assert tree["a"].dtype == torch.float32  # the input is left as it was
    ref = RP.cast_tree({"a": jnp.ones((2, 3)), "c": jnp.arange(4, dtype=jnp.int32)}, jnp.bfloat16)
    assert (ref["a"].dtype, ref["c"].dtype) == (jnp.bfloat16, jnp.int32)
