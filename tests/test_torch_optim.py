"""The port's optimizers and gradient compression: the reference's
tests/test_optim.py re-asserted, and each optimizer held to the
reference's on the same gradients.

Tolerances: parameters 1e-6, states 1e-6 of each leaf's largest entry,
against the reference after several updates (the same f32 arithmetic;
XLA fuses it into multiply-adds, so the last bits may differ); int8
quantisation exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro.optim import compression as RC  # noqa: E402
from repro.optim.optimizers import cosine_schedule as r_cosine, get_optimizer as r_opt  # noqa: E402
from repro_torch.optim import compression as TC  # noqa: E402
from repro_torch.optim.optimizers import (  # noqa: E402
    clip_by_global_norm,
    cosine_schedule,
    get_optimizer,
    global_norm,
)


def _quadratic(name, lr, n=16, seed=0, steps=60):
    opt = get_optimizer(name)
    params = {"w": torch.as_tensor(np.random.default_rng(seed).normal(size=(n, n)), dtype=torch.float32)}
    target = torch.ones((n, n))
    state = opt.init(params)

    def loss(p):
        return torch.mean((p["w"] - target) ** 2)

    l0 = float(loss(params))
    for _ in range(steps):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss({"w": w}), (w,))
        with torch.no_grad():
            params, state, _ = opt.update({"w": g}, state, params, lr)
    return l0, float(loss(params)), state


@pytest.mark.parametrize("name,lr", [("adamw", 0.05), ("adafactor", 0.05), ("sgdm", 1.0)])
def test_optimizer_minimizes_quadratic(name, lr):
    l0, l1, _ = _quadratic(name, lr)
    assert l1 < 0.2 * l0, name


def test_adafactor_memory_is_factored():
    state = get_optimizer("adafactor").init({"w": torch.zeros((256, 512))})
    v = state["v"]["w"]
    assert set(v) == {"vr", "vc"} and v["vr"].shape == (256,) and v["vc"].shape == (512,)


def test_adafactor_factored_converges():
    l0, l1, state = _quadratic("adafactor", 0.05, n=256, seed=1)
    assert set(state["v"]["w"]) == {"vr", "vc"}
    assert l1 < 0.2 * l0  # the factored second moment still converges


@pytest.mark.parametrize("name,kw", [("adamw", {}), ("adamw", {"weight_decay": 0.0}), ("adafactor", {}),
                                     ("adafactor", {"weight_decay": 0.1}), ("sgdm", {})])
def test_optimizer_matches_reference_on_the_same_gradients(name, kw):
    rng = np.random.default_rng(3)
    shapes = {"mat": (130, 140), "stack": (2, 128, 129), "vec": (7,), "small": (4, 5)}
    p_np = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-3, 2)).astype(np.float32) for k, s in shapes.items()}
             for _ in range(4)]
    ropt, topt = r_opt(name, **kw), get_optimizer(name, **kw)
    rp, tp = {k: jnp.asarray(v) for k, v in p_np.items()}, {k: torch.as_tensor(v) for k, v in p_np.items()}
    rs, ts = ropt.init(rp), topt.init(tp)
    for i, g in enumerate(grads):
        lr = 0.01 * (i + 1)
        rp, rs, rn = ropt.update({k: jnp.asarray(v) for k, v in g.items()}, rs, rp, lr)
        tp, ts, tn = topt.update({k: torch.as_tensor(v) for k, v in g.items()}, ts, tp, lr)
        assert float(tn) == pytest.approx(float(rn), rel=1e-6)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]), rtol=1e-6, atol=1e-6, err_msg=k)
    r_leaves = jax.tree_util.tree_leaves_with_path(rs)
    t_flat = dict(_flat(ts))
    assert len(r_leaves) == len(t_flat)
    for path, leaf in r_leaves:
        key = jax.tree_util.keystr(path)
        want = np.asarray(leaf)
        assert np.abs(t_flat[key] - want).max() <= 1e-6 * max(float(np.abs(want).max()), 1e-30), key


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}[{k!r}]")
    else:
        yield path, tree.numpy()


@given(seed=st.integers(0, 1000), scale=st.floats(1e-3, 1e3))
@settings(max_examples=20, deadline=None)
def test_quantize_int8_error_bound_and_reference(seed, scale):
    x = np.random.default_rng(seed).normal(0, scale, (64,)).astype(np.float32)
    q, s = TC.quantize_int8(torch.as_tensor(x))
    err = (TC.dequantize_int8(q, s) - torch.as_tensor(x)).abs().max()
    assert float(err) <= float(s) * 0.5 + 1e-6  # half a step of the int8 grid
    rq, rs = RC.quantize_int8(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(rq)) and float(s) == float(rs)


def test_error_feedback_removes_bias():
    """With error feedback the long-run mean of the compressed gradients is
    the true gradient; the port's residuals equal the reference's."""
    rng = np.random.default_rng(0)
    g_np = rng.normal(0, 1, (128,)).astype(np.float32)
    g_true = {"w": torch.as_tensor(g_np)}
    ef, r_ef = TC.init_error_feedback(g_true), RC.init_error_feedback({"w": jnp.asarray(g_np)})
    acc = torch.zeros(128)
    n = 50
    for _ in range(n):
        comp, ef = TC.compress_with_ef(g_true, ef)
        r_comp, r_ef = RC.compress_with_ef({"w": jnp.asarray(g_np)}, r_ef)
        assert np.array_equal(comp["w"][0].numpy(), np.asarray(r_comp["w"][0]))
        acc = acc + TC.decompress(comp)["w"]
    np.testing.assert_allclose(ef["w"].numpy(), np.asarray(r_ef["w"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose((acc / n).numpy(), g_np, atol=2e-3)


def test_cosine_schedule_shape():
    lr, ref = cosine_schedule(1e-3, warmup=10, total=100), r_cosine(1e-3, warmup=10, total=100)
    assert lr(0) == 0.0
    assert lr(10) == pytest.approx(1e-3, rel=1e-5)
    assert lr(100) == pytest.approx(1e-4, rel=1e-3)
    assert lr(55) < lr(20)
    for s in range(0, 120, 7):
        assert lr(s) == pytest.approx(float(ref(s)), rel=1e-6)


def test_global_norm_clipping():
    g = {"a": torch.full((10,), 10.0), "b": {"c": torch.full((3,), -2.0)}}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(float(np.sqrt(1000 + 12)), rel=1e-6)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    same, _ = clip_by_global_norm({"a": torch.full((4,), 0.1)}, 1.0)  # under the cap: unchanged
    assert torch.equal(same["a"], torch.full((4,), 0.1))
