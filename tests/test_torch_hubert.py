"""The port's HuBERT encoder (``models/encoder.py``) against the
reference at smoke width, f32, on the reference's weights: ``encode``
with and without the mask, ``loss_fn`` and its gradients, ``embed_corpus``
and the trainer's prefill step (the encoder's ``encode_step``).

Tolerances: 2e-5 (the same f32 arithmetic summed in another order);
gradients 1e-4 of each leaf's largest entry, as in
tests/test_torch_train.py.  HuBERT's full-width head_dim is 80, which the
card's ``flash_attention`` pads to 128; the smoke config cuts head_dim
to 16, so these tests set it back to 80, and the port's train step runs
with ``remat="block"``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as r_get, smoke_config as r_smoke  # noqa: E402
from repro.models import encoder as RENC  # noqa: E402
from repro.models import params as RP  # noqa: E402
from repro.runtime.sharding import ShardingPolicy, base_rules  # noqa: E402
from repro_torch.configs import get_config as t_get, smoke_config as t_smoke  # noqa: E402
from repro_torch.models import encoder as TENC  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.optim.optimizers import get_optimizer  # noqa: E402
from repro_torch.runtime import steps as TS  # noqa: E402

POL = ShardingPolicy(rules=base_rules(False), mesh=None)
TOL = 2e-5


@functools.lru_cache(maxsize=None)
def _bridged():
    cfg = r_smoke(r_get("hubert-xlarge")).with_overrides(dtype="float32", attn_impl="naive", head_dim=80)
    tcfg = t_smoke(t_get("hubert-xlarge")).with_overrides(dtype="float32", head_dim=80, remat="block")
    params = RP.init_params(RENC.param_specs(cfg), jax.random.PRNGKey(2))
    tparams = TP.from_reference(TENC.param_specs(tcfg), jax.tree.map(np.asarray, params), device="cpu")
    return cfg, tcfg, params, tparams


def _batch(cfg, seed=0, b=2, s=24):
    rng = np.random.default_rng(seed)
    return {
        "frames": rng.normal(size=(b, s, cfg.d_model)).astype(np.float32),
        "mask": rng.random((b, s)) < 0.3,
        "targets": rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32),
    }


def test_hubert_head_dim_is_80():
    _, tcfg, _, _ = _bridged()
    assert t_get("hubert-xlarge").resolved_head_dim == tcfg.resolved_head_dim == 80
    assert tcfg.family == "encoder" and not tcfg.causal


@pytest.mark.parametrize("masked", [False, True])
def test_encode_matches_reference(masked):
    cfg, tcfg, params, tparams = _bridged()
    b = _batch(cfg)
    mask = b["mask"] if masked else None
    want = RENC.encode(cfg, POL, params, jnp.asarray(b["frames"]), None if mask is None else jnp.asarray(mask))
    got = TENC.encode(tcfg, tparams, torch.as_tensor(b["frames"]), None if mask is None else torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_loss_fn_and_gradients_match_reference():
    cfg, tcfg, params, tparams = _bridged()
    b = _batch(cfg, seed=1)
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: RENC.loss_fn(cfg, POL, p, {k: jnp.asarray(v) for k, v in b.items()}), has_aux=True)(params)
    t_loss, t_metrics, t_grads = TS.value_and_grad(
        lambda p: TENC.loss_fn(tcfg, p, {k: torch.as_tensor(v) for k, v in b.items()}), tparams)
    assert float(t_loss) == pytest.approx(float(loss), rel=TOL)
    assert float(t_metrics["tokens"]) == float(metrics["tokens"]) == float(b["mask"].sum())
    got = dict(TP.leaves(t_grads))
    for path, w in TP.leaves(jax.tree.map(np.asarray, grads)):
        assert np.abs(got[path].numpy() - w).max() <= 1e-4 * max(float(np.abs(w).max()), 1e-12), path
    assert float(got["mask_embed"].abs().max()) > 0  # the masked positions reach the learned embedding


def test_embed_corpus_and_encode_step_match_reference():
    cfg, tcfg, params, tparams = _bridged()
    frames = _batch(cfg, seed=2)["frames"]
    want = RENC.embed_corpus(cfg, POL, params, jnp.asarray(frames))
    got = TENC.embed_corpus(tcfg, tparams, torch.as_tensor(frames))
    assert tuple(got.shape) == (frames.shape[0], cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    hidden = TS.make_prefill_step(tcfg)(tparams, {"frames": torch.as_tensor(frames)})
    assert torch.equal(hidden.mean(dim=1), got)


def test_hubert_train_steps_decrease_loss():
    _, tcfg, _, tparams = _bridged()
    b = {k: torch.as_tensor(v) for k, v in _batch(tcfg, seed=3).items()}
    opt = get_optimizer("adamw")
    state, params = opt.init(tparams), tparams
    step = TS.make_train_step(tcfg, opt, lambda s: 1e-2)
    losses = []
    for i in range(3):
        params, state, m = step(params, state, b, i)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] and all(np.isfinite(losses))
