"""The port's federated training (paper §2.2) and the encoders' losses:
the reference's tests/test_federated.py re-asserted, secure aggregation
bitwise against the reference's, the toy embedder trajectory against the
reference's, and ``info_nce_loss`` / ``rank_loss`` against the reference
at smoke width.

Tolerances: secure ≡ plain mean to 2^-20 (the fixed-point grid is
2^-24), the reference's; trajectories 1e-5 (f32 losses of the same
arithmetic); the encoders' losses 2e-5 and their gradients 1e-4 of each
leaf's largest entry, as in tests/test_torch_train.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

from repro.configs import get_config as r_get, smoke_config as r_smoke  # noqa: E402
from repro.core import federated as RF  # noqa: E402
from repro.core.confidential import Enclave as REnclave  # noqa: E402
from repro.models import cross_encoder as RCE  # noqa: E402
from repro.models import dual_encoder as RDE  # noqa: E402
from repro.models import params as RP  # noqa: E402
from repro.runtime.sharding import ShardingPolicy, base_rules  # noqa: E402
from repro_torch.configs import get_config as t_get, smoke_config as t_smoke  # noqa: E402
from repro_torch.core.confidential import Enclave  # noqa: E402
from repro_torch.core.federated import (  # noqa: E402
    SecureAggregator,
    fedavg,
    federated_train_embedder,
    secure_fedavg,
)
from repro_torch.models import cross_encoder as TCE  # noqa: E402
from repro_torch.models import dual_encoder as TDE  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.runtime.steps import value_and_grad  # noqa: E402

POL = ShardingPolicy(rules=base_rules(False), mesh=None)


def _tree(rng, scale=1.0):
    return {
        "w": rng.normal(0, scale, (8, 16)).astype(np.float32),
        "b": rng.normal(0, scale, (16,)).astype(np.float32),
    }


def _torch(tree):
    return {k: torch.as_tensor(v) for k, v in tree.items()}


def test_secure_agg_equals_plain_mean_exactly(rng):
    """Masks cancel in exact modular arithmetic."""
    n = 4
    updates = [_torch(_tree(rng)) for _ in range(n)]
    agg = SecureAggregator([Enclave(f"c{i}") for i in range(n)])
    sec = secure_fedavg(updates, agg, round_id=3)
    for k in ("w", "b"):
        plain = sum(u[k].double() for u in updates) / n
        assert sec[k].dtype == torch.float32
        assert_allclose(sec[k].numpy(), plain.float().numpy(), rtol=0, atol=2 ** -20)


def test_secure_agg_bitwise_equals_the_reference(rng):
    n = 3
    updates = [_tree(rng) for _ in range(n)]
    want = RF.secure_fedavg(updates, RF.SecureAggregator([REnclave(f"c{i}") for i in range(n)]), round_id=5)
    got = secure_fedavg([_torch(u) for u in updates], SecureAggregator([Enclave(f"c{i}") for i in range(n)]), 5)
    for k in want:
        assert np.array_equal(got[k].numpy(), want[k])


def test_masked_update_leaks_nothing_obvious(rng):
    """A single masked update does not correlate with the raw update."""
    n = 3
    updates = [_tree(rng) for _ in range(n)]
    agg = SecureAggregator([Enclave(f"c{i}") for i in range(n)])
    masked = agg.mask_update(0, updates[0]["w"].ravel().astype(np.float64), 0)
    corr = np.corrcoef(masked.astype(np.float64), updates[0]["w"].ravel())[0, 1]
    assert abs(corr) < 0.3


@given(seed=st.integers(0, 1000), n=st.integers(2, 5))
@settings(max_examples=10, deadline=None)
def test_secure_agg_property(seed, n):
    rng = np.random.default_rng(seed)
    updates = [{"x": torch.as_tensor(rng.normal(0, 2, (5, 7)).astype(np.float32))} for _ in range(n)]
    agg = SecureAggregator([Enclave(f"c{i}") for i in range(n)])
    sec = secure_fedavg(updates, agg, round_id=seed)
    plain = sum(u["x"].double() for u in updates) / n
    assert_allclose(sec["x"].numpy(), plain.float().numpy(), atol=2 ** -18)


def test_fedavg_weighted():
    a = {"w": torch.ones((2, 2))}
    b = {"w": torch.zeros((2, 2))}
    out = fedavg([a, b], weights=[3, 1])
    assert out["w"].dtype == torch.float32
    assert_allclose(out["w"].numpy(), 0.75 * np.ones((2, 2)))
    rng = np.random.default_rng(1)
    trees = [_tree(rng) for _ in range(3)]
    want = RF.fedavg(trees, weights=[1, 2, 3])
    got = fedavg([_torch(t) for t in trees], weights=[1, 2, 3])
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))


def test_fedavg_one_local_step_equals_dp_gradient_mean(rng):
    """FedAvg of one local SGD step == the data-parallel gradient mean, run
    through ``federated_train_embedder`` with plain aggregation."""
    w0 = torch.as_tensor(rng.normal(size=(4,)).astype(np.float32))
    data = [torch.as_tensor(rng.normal(size=(4,)).astype(np.float32)) for _ in range(3)]
    lr = 0.1

    def grad_fn(params, x):  # grad of 0.5 ||w - x||^2
        return 0.5 * float(((params["w"] - x) ** 2).sum()), {"w": params["w"] - x}

    fed, _ = federated_train_embedder({"w": w0}, [lambda r, x=x: x for x in data], grad_fn,
                                      lambda p, g: {"w": p["w"] - lr * g["w"]}, n_rounds=1, secure=False)
    dp = w0 - lr * torch.stack([w0 - x for x in data]).mean(0)
    assert_allclose(fed["w"].numpy(), dp.numpy(), rtol=1e-6)


def _toy(secure, pkg):
    """The reference test's toy contrastive objective, its batches made
    with numpy; ``pkg`` picks whose federated_train_embedder runs it."""
    dim = 8

    def loss_of(w, q, d):
        qe, de = q @ w, d @ w
        sim = qe @ de.T
        return -torch.log_softmax(sim, -1)[torch.arange(q.shape[0]), torch.arange(q.shape[0])].mean()

    def t_grad_fn(params, batch):
        w = torch.as_tensor(params["w"]).requires_grad_(True)
        loss = loss_of(w, torch.as_tensor(batch["q"]), torch.as_tensor(batch["d"]))
        (g,) = torch.autograd.grad(loss, (w,))
        return float(loss.detach()), {"w": g}

    def r_grad_fn(params, batch):
        w = jnp.asarray(params["w"])
        q, d = jnp.asarray(batch["q"]), jnp.asarray(batch["d"])

        def loss(w):
            qe, de = q @ w, d @ w
            return -jnp.mean(jax.nn.log_softmax(qe @ de.T, -1)[jnp.arange(q.shape[0]), jnp.arange(q.shape[0])])

        val, g = jax.value_and_grad(loss)(w)
        return float(val), {"w": np.asarray(g)}

    def batch_fn_for(c):
        def fn(r):
            rng_ = np.random.default_rng((c, r))
            d = rng_.normal(size=(16, dim)).astype(np.float32)
            return {"q": d + 0.1 * rng_.normal(size=d.shape).astype(np.float32), "d": d}
        return fn

    init = np.eye(dim, dtype=np.float32) * 0.1
    if pkg == "port":
        fn, params, grad_fn = federated_train_embedder, {"w": torch.as_tensor(init)}, t_grad_fn
        update = lambda p, g: {"w": p["w"] - 0.5 * g["w"]}  # noqa: E731
    else:
        fn, params, grad_fn = RF.federated_train_embedder, {"w": init.copy()}, r_grad_fn
        update = lambda p, g: {"w": p["w"] - 0.5 * g["w"]}  # noqa: E731
    _, h = fn(params, [batch_fn_for(c) for c in range(3)], grad_fn, update, n_rounds=6, secure=secure)
    return [r["mean_loss"] for r in h]


def test_federated_embedder_training_improves_and_matches_the_reference():
    """FedAvg rounds on the toy contrastive objective reduce the loss;
    secure and plain aggregation give the same trajectory, and so does the
    reference."""
    hist = {}
    for secure in (False, True):
        hist[secure] = _toy(secure, "port")
        assert hist[secure][-1] < hist[secure][0], "FL training must reduce the loss"
        assert_allclose(hist[secure], _toy(secure, "reference"), rtol=1e-5)
    assert_allclose(hist[True], hist[False], rtol=1e-4), "secure aggregation changed the trajectory"


def test_federated_train_embedder_keeps_device_tensors_and_times_the_exchange():
    params = {"w": torch.ones(3, 2), "b": {"c": torch.zeros(5)}}

    def grad_fn(p, batch):
        return 1.0, {"w": torch.full((3, 2), batch), "b": {"c": torch.full((5,), -batch)}}

    def sgd(p, g):
        return {"w": p["w"] - 0.1 * g["w"], "b": {"c": p["b"]["c"] - 0.1 * g["b"]["c"]}}

    out, hist = federated_train_embedder(params, [lambda r: 1.0, lambda r: 3.0], grad_fn, sgd, n_rounds=2,
                                         secure=True)
    assert isinstance(out["w"], torch.Tensor) and out["b"]["c"].dtype == torch.float32
    assert_allclose(out["w"].numpy(), np.full((3, 2), 1 - 2 * 0.2), atol=2 ** -20)
    assert_allclose(out["b"]["c"].numpy(), np.full(5, 2 * 0.2), atol=2 ** -20)
    assert [h["round"] for h in hist] == [0, 1] and all(h["exchange_s"] >= 0 for h in hist)


# ------------------------------------------------------------------ #
# the encoders' training losses
# ------------------------------------------------------------------ #


@functools.lru_cache(maxsize=None)
def _encoder(name, mod_r, mod_t):
    cfg = r_smoke(r_get(name)).with_overrides(dtype="float32", attn_impl="naive", vocab_size=512)
    tcfg = t_smoke(t_get(name)).with_overrides(dtype="float32", vocab_size=512)
    rm, tm = {"RDE": RDE, "RCE": RCE}[mod_r], {"TDE": TDE, "TCE": TCE}[mod_t]
    params = RP.init_params(rm.param_specs(cfg), jax.random.PRNGKey(6))
    np_params = jax.tree.map(np.asarray, params)
    return cfg, tcfg, params, TP.from_reference(tm.param_specs(tcfg), np_params, device="cpu")


def _check_loss_and_grads(r_loss, t_loss, params, tparams):
    (loss, metrics), grads = jax.value_and_grad(r_loss, has_aux=True)(params)
    t_val, t_metrics, t_grads = value_and_grad(t_loss, tparams)
    assert float(t_val) == pytest.approx(float(loss), rel=2e-5)
    assert float(t_metrics["acc"]) == float(metrics["acc"])
    got = dict(TP.leaves(t_grads))
    for path, w in TP.leaves(jax.tree.map(np.asarray, grads)):
        assert np.abs(got[path].numpy() - w).max() <= 1e-4 * max(float(np.abs(w).max()), 1e-12), path


def test_info_nce_loss_matches_reference():
    cfg, tcfg, params, tparams = _encoder("contriever-110m", "RDE", "TDE")
    rng = np.random.default_rng(7)
    q = rng.integers(1, 512, size=(6, 12)).astype(np.int32)
    d = rng.integers(1, 512, size=(6, 20)).astype(np.int32)
    d[:, 15:] = 0  # PAD tail: pooled over the real tokens only
    rb = {"query_tokens": jnp.asarray(q), "doc_tokens": jnp.asarray(d)}
    tb = {"query_tokens": torch.as_tensor(q), "doc_tokens": torch.as_tensor(d)}
    _check_loss_and_grads(lambda p: RDE.info_nce_loss(cfg, POL, p, rb), lambda p: TDE.info_nce_loss(tcfg, p, tb),
                          params, tparams)


def test_rank_loss_matches_reference():
    cfg, tcfg, params, tparams = _encoder("bge-reranker-base", "RCE", "TCE")
    rng = np.random.default_rng(8)
    toks = rng.integers(1, 512, size=(3, 4, 16)).astype(np.int32)
    types = np.zeros_like(toks)
    types[..., 8:] = 1
    label = np.array([0, 3, 1], np.int32)
    rb = {"tokens": jnp.asarray(toks), "type_ids": jnp.asarray(types), "label": jnp.asarray(label)}
    tb = {"tokens": torch.as_tensor(toks), "type_ids": torch.as_tensor(types), "label": torch.as_tensor(label)}
    _check_loss_and_grads(lambda p: RCE.rank_loss(cfg, POL, p, rb), lambda p: TCE.rank_loss(tcfg, p, tb),
                          params, tparams)
