"""The port's training path against the reference: ``lm.loss_fn`` /
``sharded_ce`` and per-leaf gradients, the autograd Functions around the
``flash_attention`` and ``ssd_chunk`` kernels, ``remat="block"``, the
train step, and the patch frontend.

Smoke-width models in f32 on the reference's weights (``from_reference``);
the reference runs its ``attn_impl="naive"`` oracle.  Tolerances: losses
2e-5 (the same f32 arithmetic summed in another order); gradients 1e-4
of the leaf's largest entry (a backward pass through 2-4 layers
reassociates more sums than the forward); the two Functions' backward
1e-6 against direct autograd of the plain versions (the same plain graph,
recomputed); two AdamW steps 1e-5 against the reference's jitted step.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as r_get, smoke_config as r_smoke  # noqa: E402
from repro.models import lm as RLM  # noqa: E402
from repro.models import params as RP  # noqa: E402
from repro.optim.optimizers import get_optimizer as r_opt  # noqa: E402
from repro.runtime.sharding import ShardingPolicy, base_rules  # noqa: E402
from repro.runtime.steps import make_train_step as r_train_step  # noqa: E402
from repro_torch.configs import get_config as t_get, smoke_config as t_smoke  # noqa: E402
from repro_torch.kernels.chunked_prefill import ops as cp_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.retrieval_topk import ops as rt_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ss_ops  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.optim.optimizers import get_optimizer as t_opt  # noqa: E402
from repro_torch.runtime import steps as TS  # noqa: E402

POL = ShardingPolicy(rules=base_rules(False), mesh=None)
ARCHS = ["qwen3-0.6b", "qwen2-moe-a2.7b", "mamba2-1.3b", "pixtral-12b"]
HYBRID = "jamba-1.5-large-398b"


@functools.lru_cache(maxsize=None)
def _bridged(name):
    cfg = r_smoke(r_get(name)).with_overrides(dtype="float32", attn_impl="naive")
    tcfg = t_smoke(t_get(name)).with_overrides(dtype="float32")
    params = RP.init_params(RLM.param_specs(cfg), jax.random.PRNGKey(1))
    np_params = jax.tree.map(np.asarray, params)
    return cfg, tcfg, params, np_params


def _tparams(name):
    _, tcfg, _, np_params = _bridged(name)
    return TP.from_reference(TLM.param_specs(tcfg), np_params, device="cpu")


def _batch(cfg, seed=0, b=2, s=32):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    tgt = tok.copy()
    tgt[:, ::5] = -1  # masked positions
    batch = {"tokens": tok, "targets": tgt}
    if cfg.frontend == "patches":
        batch["patch_embeds"] = rng.normal(size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference_grads(name):
    cfg, _, params, _ = _bridged(name)
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    (loss, metrics), grads = jax.value_and_grad(lambda p: RLM.loss_fn(cfg, POL, p, batch), has_aux=True)(params)
    return float(loss), {k: float(v) for k, v in metrics.items()}, jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("name", ARCHS + [HYBRID])
def test_loss_fn_matches_reference(name):
    cfg, tcfg, _, _ = _bridged(name)
    loss, metrics = TLM.loss_fn(tcfg, _tparams(name), _t(_batch(cfg)))
    want_loss, want_metrics, _ = _reference_grads(name)
    assert float(loss) == pytest.approx(want_loss, rel=2e-5)
    for k in ("ce", "aux", "tokens"):
        assert float(metrics[k]) == pytest.approx(want_metrics[k], rel=2e-5, abs=2e-5), k


@pytest.mark.parametrize("name", ARCHS)
def test_per_leaf_gradients_match_jax_grad(name):
    cfg, tcfg, _, _ = _bridged(name)
    _, _, want = _reference_grads(name)
    _, _, grads = TS.value_and_grad(lambda p: TLM.loss_fn(tcfg, p, _t(_batch(cfg))), _tparams(name))
    got = dict(TP.leaves(grads))
    for path, w in TP.leaves(want):
        g = got[path].numpy()
        scale = max(float(np.abs(w).max()), 1e-12)
        assert np.abs(g - w).max() <= 1e-4 * scale, path


def test_hybrid_gradients_within_the_references_own_spread():
    """jamba's whole-model gradients.  At this model the reference
    disagrees with itself: its ``naive`` and ``flash_jnp`` attention, which
    differ only in the order of their sums, give per-leaf gradients up to
    about 1e-2 of a leaf's largest entry apart (qwen2-moe's two differ by
    under 1e-6; here 16 layers amplify the sums' rounding, and the router's
    second and third probabilities of a token come within 6e-5 of each
    other), so the 1e-4 of the other models cannot hold.  The port is held to twice that spread, measured here, and each
    layer's backward to 1e-4 in tests/test_torch_hybrid.py."""
    cfg, tcfg, params, _ = _bridged(HYBRID)
    _, _, want = _reference_grads(HYBRID)
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    other = cfg.with_overrides(attn_impl="flash_jnp", attn_chunk=8)
    spread_grads = jax.grad(lambda p: RLM.loss_fn(other, POL, p, batch)[0])(params)
    _, _, grads = TS.value_and_grad(lambda p: TLM.loss_fn(tcfg, p, _t(_batch(cfg))), _tparams(HYBRID))
    got = dict(TP.leaves(grads))

    def rel(a, w):
        return float(np.abs(a - w).max()) / max(float(np.abs(w).max()), 1e-12)

    spread = max(rel(np.asarray(s), w) for (_, s), (_, w) in zip(TP.leaves(spread_grads), TP.leaves(want)))
    assert 1e-4 < spread < 5e-2, spread
    for path, w in TP.leaves(want):
        assert rel(got[path].numpy(), w) <= 2 * spread, path


def test_sharded_ce_matches_reference():
    rng = np.random.default_rng(2)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    targets = rng.integers(-1, 50, size=(3, 7)).astype(np.int32)
    mask = (targets >= 0).astype(np.float32)
    want = float(RLM.sharded_ce(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask)))
    got = float(TLM.sharded_ce(torch.as_tensor(logits), torch.as_tensor(targets), torch.as_tensor(mask)))
    assert got == pytest.approx(want, rel=2e-5)
    # nothing supervised: 0, not a division by zero
    assert float(TLM.sharded_ce(torch.as_tensor(logits), torch.as_tensor(targets), torch.zeros(3, 7))) == 0.0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv,dh", [(4, 2, 16), (4, 4, 80), (6, 3, 32)])
def test_flash_attention_function_backward_equals_plain_autograd(h, kv, dh, causal):
    g = torch.Generator().manual_seed(h * dh)
    q = torch.randn(2, 11, h, dh, generator=g, requires_grad=True)
    k = torch.randn(2, 11, kv, dh, generator=g, requires_grad=True)
    v = torch.randn(2, 11, kv, dh, generator=g, requires_grad=True)
    up = torch.randn(2, 11, h, dh, generator=g)
    out = fa_ops.flash_attention(q, k, v, causal=causal)
    assert isinstance(out.grad_fn, fa_ops.FlashAttention._backward_cls)
    got = torch.autograd.grad(out, (q, k, v), up)
    want = torch.autograd.grad(fa_ops.flash_attention_plain(q, k, v, causal=causal), (q, k, v), up)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.allclose(a, b, rtol=1e-6, atol=1e-6)
    # only the inputs that require grad get one
    dq, = torch.autograd.grad(fa_ops.flash_attention(q, k.detach(), v.detach(), causal=causal), (q,), up)
    assert torch.allclose(dq, got[0], rtol=1e-6, atol=1e-6)


def test_ssd_chunk_function_backward_equals_plain_autograd():
    g = torch.Generator().manual_seed(5)
    b, l, h, hd, ds = 2, 16, 4, 8, 8
    x = torch.randn(b, l, h, hd, generator=g, requires_grad=True)
    bg = torch.randn(b, l, 1, ds, generator=g, requires_grad=True)
    cg = torch.randn(b, l, 1, ds, generator=g, requires_grad=True)
    dt = torch.rand(b, l, h, generator=g).requires_grad_(True)
    a = (-torch.rand(h, generator=g)).requires_grad_(True)
    ups = tuple(torch.randn(*shape, generator=g) for shape in ((b, l, h, hd), (b, h, hd, ds), (b, h)))
    ins = (x, bg, cg, dt, a)

    def run(fn):
        outs = fn(x, bg.expand(b, l, h, ds), cg.expand(b, l, h, ds), dt, a)
        return torch.autograd.grad(outs, ins, ups)

    got, want = run(ss_ops.ssd_chunk), run(ss_ops.ssd_chunk_plain)
    for t, a_, w in zip(ins, got, want):
        assert a_.shape == t.shape and torch.allclose(a_, w, rtol=1e-6, atol=1e-6)


def test_serving_kernels_refuse_inputs_that_require_grad():
    q = torch.randn(2, 4, 16, requires_grad=True)
    kc = torch.randn(2, 8, 2, 16)
    lengths = torch.tensor([3, 8], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        da_ops.decode_attention(q, kc, kc, lengths)
    pool = torch.randn(5, 4, 2, 16)
    tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        da_ops.paged_decode_attention(q, pool, pool, tables, lengths)
    desc = torch.tensor([[0, 0, 3, 3], [1, 0, 2, 2]], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        cp_ops.mixed_prefill_attention(torch.randn(2, 3, 4, 16, requires_grad=True), pool, pool, tables, desc)
    with pytest.raises(RuntimeError, match="no backward"):
        rt_ops.retrieval_topk(torch.randn(3, 8, requires_grad=True), torch.randn(20, 8), 4)
    # without grad mode, or with no input requiring grad, they serve as before
    with torch.no_grad():
        assert da_ops.decode_attention(q, kc, kc, lengths).shape == (2, 4, 16)
    assert rt_ops.retrieval_topk(torch.randn(3, 8), torch.randn(20, 8), 4)[0].shape == (3, 4)


@pytest.mark.parametrize("name", ["qwen3-0.6b", "mamba2-1.3b", "jamba-1.5-large-398b"])
def test_remat_block_equals_none_bitwise(name):
    cfg, tcfg, _, _ = _bridged(name)
    params, batch = _tparams(name), _t(_batch(cfg))
    runs = {}
    for remat in ("none", "block"):
        c = tcfg.with_overrides(remat=remat)
        runs[remat] = TS.value_and_grad(lambda p: TLM.loss_fn(c, p, batch), params)
    assert torch.equal(runs["none"][0], runs["block"][0])
    for (path, a), (_, b) in zip(TP.leaves(runs["none"][2]), TP.leaves(runs["block"][2])):
        assert torch.equal(a, b), path


def test_two_adamw_train_steps_match_reference():
    """lr 1e-3: AdamW's m / sqrt(v) turns the gradients' 1e-6 differences
    at entries whose gradient is near 0 into step differences of up to a
    few 1e-3 of lr, so parameters are held to 1e-5 at this lr."""
    name = "qwen3-0.6b"
    cfg, tcfg, params, _ = _bridged(name)
    batch = _batch(cfg, seed=3)
    r_step = jax.jit(r_train_step(cfg, POL, r_opt("adamw"), lambda s: 1e-3))
    t_step = TS.make_train_step(tcfg, t_opt("adamw"), lambda s: 1e-3)
    rp, rs = params, r_opt("adamw").init(params)
    tp = _tparams(name)
    ts = t_opt("adamw").init(tp)
    for i in range(2):
        rp, rs, rm = r_step(rp, rs, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(i))
        tp, ts, tm = t_step(tp, ts, _t(batch), i)
        for k in ("loss", "grad_norm"):
            assert float(tm[k]) == pytest.approx(float(rm[k]), rel=1e-5), (i, k)
    assert int(ts["count"]) == 2
    for (path, a), (_, b) in zip(TP.leaves(jax.tree.map(np.asarray, rp)), TP.leaves(tp)):
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-5, err_msg=path)
    for moment in ("mu", "nu"):
        for (path, a), (_, b) in zip(TP.leaves(jax.tree.map(np.asarray, rs[moment])), TP.leaves(ts[moment])):
            assert np.abs(b.numpy() - a).max() <= 1e-5 * max(float(np.abs(a).max()), 1e-30), (moment, path)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b", "mamba2-1.3b", "pixtral-12b", "jamba-1.5-large-398b"])
def test_arch_train_step_decreases_loss(arch):
    """The port's version of tests/test_models.py's: four AdamW steps at lr
    1e-2 on one repeated batch, in the config's own dtype (bf16)."""
    cfg = t_smoke(t_get(arch))
    params = TP.init_params(TLM.param_specs(cfg), torch.Generator().manual_seed(0), device="cpu")
    opt = t_opt("adamw")
    state = opt.init(params)
    step = TS.make_train_step(cfg, opt, lambda s: 1e-2)
    rng = np.random.default_rng(0)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 32)).astype(np.int32))
    batch = {"tokens": tok, "targets": tok}
    if cfg.frontend == "patches":
        batch["patch_embeds"] = torch.randn(2, cfg.n_patches, cfg.d_model).to(torch.bfloat16)
    losses = []
    for i in range(4):
        params, state, metrics = step(params, state, batch, i)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], f"loss not decreasing: {losses}"
    assert all(np.isfinite(x) for x in losses)


def test_train_step_leaves_its_inputs_untouched_and_grads_reach_every_leaf():
    name = "qwen3-0.6b"
    cfg, tcfg, _, _ = _bridged(name)
    params = _tparams(name)
    before = {p: t.clone() for p, t in TP.leaves(params)}
    _, _, grads = TS.value_and_grad(lambda p: TLM.loss_fn(tcfg, p, _t(_batch(cfg))), params)
    for path, g in TP.leaves(grads):
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any()), path
    opt = t_opt("adamw")
    new, _, _ = TS.make_train_step(tcfg, opt)(params, opt.init(params), _t(_batch(cfg)), 0)
    for path, t in TP.leaves(params):
        assert torch.equal(t, before[path]) and not t.requires_grad, path
    assert not any(torch.equal(a, b) for (_, a), (_, b) in zip(TP.leaves(new), TP.leaves(params)))


def test_value_and_grad_raises_on_a_leaf_the_loss_does_not_reach():
    """A cut graph must not train with zero gradients: the missing leaf
    is named."""
    params = {"used": torch.ones(3), "cut": {"w": torch.ones(2)}}

    def loss_fn(p):
        cut = p["cut"]["w"].detach()  # what a kernel without autograd does
        return (p["used"] ** 2).sum() + cut.sum(), {}

    with pytest.raises(RuntimeError, match="cut/w"):
        TS.value_and_grad(loss_fn, params)


def test_bf16_grads_train_step_updates_f32_master_weights():
    cfg, tcfg, _, _ = _bridged("qwen3-0.6b")
    tcfg = tcfg.with_overrides(bf16_grads=True)
    params = _tparams("qwen3-0.6b")
    opt = t_opt("sgdm")
    new, state, metrics = TS.make_train_step(tcfg, opt, lambda s: 1e-2)(params, opt.init(params), _t(_batch(cfg)), 0)
    assert all(t.dtype == torch.float32 for _, t in TP.leaves(new))
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0


def test_vlm_patch_frontend_matches_reference_and_prefill():
    """Patches replace the first positions in forward, prefill and generate;
    other patch embeddings change the logits (tests/test_models.py's)."""
    cfg, tcfg, params, _ = _bridged("pixtral-12b")
    tparams = _tparams("pixtral-12b")
    batch = _batch(cfg, seed=4)
    want, _ = RLM.forward(cfg, POL, params, {k: jnp.asarray(v) for k, v in batch.items() if k != "targets"})
    tb = _t({k: v for k, v in batch.items() if k != "targets"})
    got, _ = TLM.forward(tcfg, tparams, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    pre, _ = TLM.prefill(tcfg, tparams, tb)
    assert torch.equal(pre, got)
    other = dict(tb, patch_embeds=tb["patch_embeds"] + 1.0)
    assert float((TLM.forward(tcfg, tparams, other)[0] - got).abs().max()) > 1e-3, "patch embeddings ignored"
    want_gen = np.asarray(RLM.generate(cfg, POL, params, {k: jnp.asarray(v) for k, v in batch.items()
                                                          if k != "targets"}, 4))
    got_gen = TLM.generate(tcfg, tparams, tb, 4)
    assert np.array_equal(got_gen.numpy(), want_gen)


def test_prefill_and_decode_steps():
    cfg, tcfg, _, _ = _bridged("qwen3-0.6b")
    params = _tparams("qwen3-0.6b")
    tok = _t(_batch(cfg))["tokens"]
    full, _ = TLM.forward(tcfg, params, {"tokens": tok})
    last, cache = TS.make_prefill_step(tcfg)(params, {"tokens": tok[:, :16]})
    assert torch.allclose(last[:, 0], full[:, 15], rtol=1e-4, atol=1e-4)
    _, cache = TLM.prefill(tcfg, params, {"tokens": tok[:, :16]}, cache_len=32)
    logits, cache = TS.make_decode_step(tcfg)(params, cache, tok[:, 16:17], 16)
    assert torch.allclose(logits[:, 0], full[:, 16], rtol=1e-3, atol=1e-3)
