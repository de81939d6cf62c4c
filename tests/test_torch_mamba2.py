"""The port's Mamba2 mixer and the ``ssm`` LM family against the reference,
with the reference's own weights carried over by ``params.from_reference``.

Smoke-width mamba2-1.3b in f32 (2 layers, d_model 64, 8 SSM heads of 16,
state 16, one group, chunk 16).  The mixer (chunked apply, decode, final
conv and SSM states) is held at 1e-4, the SSD tolerance of
tests/test_kernels.py; LM logits at 2e-3, as tests/test_models.py holds
chunked prefill against the recurrent decode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as r_get, smoke_config as r_smoke  # noqa: E402
from repro.models import lm as RLM  # noqa: E402
from repro.models import mamba2 as RM  # noqa: E402
from repro.models.params import init_params as r_init  # noqa: E402
from repro.runtime.sharding import ShardingPolicy, base_rules  # noqa: E402
from repro_torch.configs import get_config as t_get, smoke_config as t_smoke  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import mamba2 as TM  # noqa: E402
from repro_torch.models.params import from_reference, leaves  # noqa: E402

POL = ShardingPolicy(rules=base_rules(False), mesh=None)
T = torch.as_tensor
ARCH = "mamba2-1.3b"


def _cfgs(**kw):
    return (r_smoke(r_get(ARCH)).with_overrides(dtype="float32", **kw),
            t_smoke(t_get(ARCH)).with_overrides(dtype="float32", **kw))


def _mixer(key=0, **kw):
    cfg, tcfg = _cfgs(**kw)
    p = r_init(RM.mamba_specs(cfg), jax.random.PRNGKey(key))
    return cfg, tcfg, p, from_reference(TM.mamba_specs(tcfg), jax.tree.map(np.asarray, p), device="cpu")


def _lm(key=1):
    cfg, tcfg = _cfgs()
    params = r_init(RLM.param_specs(cfg), jax.random.PRNGKey(key))
    return cfg, tcfg, params, from_reference(TLM.param_specs(tcfg), jax.tree.map(np.asarray, params), device="cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_param_specs_match_reference_tree():
    """Every leaf of the ssm LM tree, and of the mixer's, has the
    reference's path, shape, initializer and fan-in dims, so
    ``from_reference`` maps the tree one to one."""
    cfg, tcfg = _cfgs()
    for r_specs, t_specs in ((RLM.param_specs(cfg), TLM.param_specs(tcfg)), (RM.mamba_specs(cfg), TM.mamba_specs(tcfg))):
        r_leaves = jax.tree_util.tree_flatten_with_path(r_specs, is_leaf=lambda x: hasattr(x, "fan_in_dims"))[0]
        r_map = {"/".join(p.key for p in path): (s.shape, s.init, s.fan_in_dims) for path, s in r_leaves}
        assert r_map == {p: (s.shape, s.init, s.fan_in_dims) for p, s in leaves(t_specs)}
    assert "mamba" in TLM.param_specs(tcfg)["blocks"]["pos0"]
    full = TLM.param_specs(t_get(ARCH))["blocks"]["pos0"]  # d_ff 0: no FFN
    assert set(full) == {"mixer_norm", "mamba"}


@pytest.mark.parametrize("s", [37, 16, 5], ids=["ragged_chunks", "one_chunk", "short"])
def test_mamba_apply_matches_reference(s):
    """Chunked apply from zero state (37 positions: two chunks of 16 and a
    padded third), and its final conv / SSM states."""
    cfg, tcfg, p, tp = _mixer()
    x = (np.random.default_rng(s).standard_normal((2, s, cfg.d_model)) * 0.5).astype(np.float32)
    y_r, (conv_r, ssm_r) = RM.mamba_apply(cfg, POL, p, jnp.asarray(x))
    y_t, (conv_t, ssm_t) = TM.mamba_apply(tcfg, tp, T(x))
    _close(y_t, y_r, 1e-4)
    _close(ssm_t, ssm_r, 1e-4)
    for a, b in zip(conv_t, conv_r):
        _close(a, b, 1e-4)


def test_mamba_apply_from_state_and_decode_match_reference():
    """A second apply from the first one's states, then recurrent decode
    steps, against the reference's."""
    cfg, tcfg, p, tp = _mixer(key=2)
    rng = np.random.default_rng(3)
    x1, x2 = (rng.standard_normal((2, n, cfg.d_model)).astype(np.float32) * 0.5 for n in (20, 13))
    _, st_r = RM.mamba_apply(cfg, POL, p, jnp.asarray(x1))
    _, st_t = TM.mamba_apply(tcfg, tp, T(x1))
    y_r, (conv_r, ssm_r) = RM.mamba_apply(cfg, POL, p, jnp.asarray(x2), init=st_r)
    y_t, (conv_t, ssm_t) = TM.mamba_apply(tcfg, tp, T(x2), init=st_t)
    _close(y_t, y_r, 1e-4)
    for step in range(3):
        xd = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32) * 0.5
        o_r, conv_r, ssm_r = RM.mamba_decode(cfg, POL, p, jnp.asarray(xd), conv_r, ssm_r)
        o_t, conv_t, ssm_t = TM.mamba_decode(tcfg, tp, T(xd), conv_t, ssm_t)
        _close(o_t, o_r, 1e-4)
        _close(ssm_t, ssm_r, 1e-4)
        for a, b in zip(conv_t, conv_r):
            _close(a, b, 1e-4)


def test_chunked_equals_sequential():
    """The port's chunked SSD (chunk 8 over 24 positions) equals its own
    step-by-step recurrence (tests/test_models.py)."""
    cfg, tcfg, p, tp = _mixer(ssd_chunk=8)
    x = T(np.random.default_rng(0).standard_normal((2, 24, cfg.d_model)).astype(np.float32) * 0.5)
    y_chunk, _ = TM.mamba_apply(tcfg, tp, x)
    np.testing.assert_allclose(y_chunk.numpy(), TM.mamba_reference(tcfg, tp, x).numpy(), rtol=1e-4, atol=1e-4)
    y_seq_r = RM.mamba_reference(cfg, p, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(y_chunk.numpy(), np.asarray(y_seq_r), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunked_matches_reference(groups):
    """``_ssd_chunked`` from a carried state, one group expanded over the
    heads and two groups repeated, against the reference's."""
    cfg, tcfg = _cfgs(ssm_groups=groups, ssd_chunk=8)
    rng = np.random.default_rng(groups)
    b, s, h, hd, ds = 2, 19, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    xh = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    bh, ch = (rng.standard_normal((b, s, groups, ds)).astype(np.float32) for _ in range(2))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h))).astype(np.float32)
    st0 = rng.standard_normal((b, h, hd, ds)).astype(np.float32)
    y_r, st_r = RM._ssd_chunked(cfg, *map(jnp.asarray, (xh, bh, ch, dt, a)), init_state=jnp.asarray(st0))
    y_t, st_t = TM._ssd_chunked(tcfg, *map(T, (xh, bh, ch, dt, a)), init_state=T(st0))
    _close(y_t, y_r, 1e-4)
    _close(st_t, st_r, 1e-4)


def test_lm_steps_match_reference():
    """``forward``, ``prefill`` (logits and the conv / SSM cache) and
    contiguous ``decode_step`` against the reference's, and the port's own
    prefill + decode against its teacher-forced forward."""
    cfg, tcfg, params, tparams = _lm()
    tok = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    full_r, _ = RLM.forward(cfg, POL, params, {"tokens": jnp.asarray(tok)})
    full_t, _ = TLM.forward(tcfg, tparams, {"tokens": T(tok)})
    _close(full_t, full_r, 2e-3)
    p = 13  # prefill over a chunk and a padded partial chunk
    lg_r, cache = RLM.prefill(cfg, POL, params, {"tokens": jnp.asarray(tok[:, :p])}, cache_len=24)
    lg_t, tcache = TLM.prefill(tcfg, tparams, {"tokens": T(tok[:, :p])}, cache_len=24)
    _close(lg_t, lg_r, 2e-3)
    for t in range(p, p + 4):
        lr, cache = RLM.decode_step(cfg, POL, params, cache, jnp.asarray(tok[:, t : t + 1]), t)
        lt = TLM.decode_step(tcfg, tparams, tcache, T(tok[:, t : t + 1]), T(t))
        _close(lt, lr, 2e-3)
        np.testing.assert_allclose(lt[:, 0].numpy(), full_t[:, t].numpy(), rtol=2e-3, atol=2e-3)
    for key in cache:
        _close(tcache[key]["ssm"], cache[key]["ssm"], 2e-3)
        for a, b in zip(tcache[key]["conv"], cache[key]["conv"]):
            _close(a, b, 2e-3)


def test_init_cache_matches_reference_layout():
    cfg, tcfg = _cfgs()
    r = RLM.init_cache(cfg, 3, 40, dtype=jnp.float32)
    t = TLM.init_cache(tcfg, 3, 40, dtype=torch.float32, device="cpu")
    assert set(t) == set(r) == {"pos0"}
    assert isinstance(t["pos0"]["conv"], tuple) and len(t["pos0"]["conv"]) == 3
    for a, b in zip(t["pos0"]["conv"], r["pos0"]["conv"]):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    assert tuple(t["pos0"]["ssm"].shape) == r["pos0"]["ssm"].shape and t["pos0"]["ssm"].dtype == torch.float32
    bf = TLM.init_cache(tcfg, 1, 8, dtype=torch.bfloat16, device="cpu")["pos0"]
    assert bf["conv"][0].dtype == torch.bfloat16 and bf["ssm"].dtype == torch.float32


def test_paged_steps_refuse_ssm():
    """The paged cache, the unified mixed step and paged decode take
    attention models only, as in the reference."""
    _, tcfg, _, tparams = _lm()
    with pytest.raises(NotImplementedError, match="attention"):
        TLM.init_paged_cache(tcfg, 4, 8, dtype=torch.float32, device="cpu")
    cache = TLM.init_cache(tcfg, 1, 8, dtype=torch.float32, device="cpu")
    tok = T(np.zeros((1, 4), np.int32))
    lanes = TLM.Lanes(*(T(a) for a in TLM.pack_lanes([0], [4], [1], np.zeros((1, 1), np.int32), 8).values()))
    with pytest.raises(NotImplementedError, match="attention"):
        TLM.mixed_step(tcfg, tparams, tok[0], cache, T(np.zeros((1, 1), np.int32)), lanes)
    with pytest.raises(NotImplementedError, match="attention"):
        TLM.decode_step(tcfg, tparams, cache, tok[:, :1], T([0]), block_tables=T(np.zeros((1, 1), np.int32)), block_size=8)
