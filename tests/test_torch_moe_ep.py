"""The port's expert-parallel MoE against the reference's ``shard_map``
forms.

One module-scoped subprocess runs the reference on 8 fake host devices
(``--xla_force_host_platform_device_count=8``, as tests/test_moe.py does)
and writes its sharded ``moe_apply`` outputs, aux losses and gradients,
``psum`` and ``a2a`` on a 2 x 4 ``("data", "model")`` mesh, at slack 8
(nothing dropped) and at slack 0.25 (pairs dropped by both forms), to one
``.npz``.  The port runs the same weights and inputs on a 2 x 4 mesh of
``cpu``.  Tolerances: outputs 3e-5 (tests/test_moe.py:92-93) and aux 1e-5
relative; gradients 1e-4 of the leaf's largest entry (the train tests'
rule).  At slack 8 both forms also equal the port's dense
``moe_reference`` at 3e-5.  Within the port: ``psum`` on an ``(N, 1)``
mesh is bitwise the tp = 1 path run on each data shard's rows; rows in no
expert group are zeros even where the memory held NaN; the expert loop's
host syncs are one per model shard per data shard.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402
from repro_torch.runtime.compat import make_mesh  # noqa: E402
from repro_torch.runtime.sharding import PartitionSpec as P, ShardingPolicy, base_rules, make_policy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SLACKS = (8.0, 0.25)
SHAPE = (8, 32, 32)

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import ModelConfig
from repro.models.moe import moe_apply, moe_specs
from repro.models.params import init_params
from repro.runtime.compat import make_mesh
from repro.runtime.sharding import ShardingPolicy, base_rules

out = {}
mesh = make_mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
pol = ShardingPolicy(rules=base_rules(False), mesh=mesh)
rng = np.random.default_rng(0)
x = rng.standard_normal(SHAPE).astype(np.float32)
up = rng.standard_normal(SHAPE).astype(np.float32)
out["x"], out["up"] = x, up
for shared in (0, 1):
    base = ModelConfig(name="t", family="moe", d_model=32, n_experts=8, moe_top_k=2, moe_d_ff=64, d_ff=64,
                       n_shared_experts=shared)
    p = init_params(moe_specs(base, tp_hint=4), jax.random.PRNGKey(shared))
    for k, v in jax.tree_util.tree_flatten_with_path(p)[0]:
        out[f"p{shared}" + jax.tree_util.keystr(k)] = np.asarray(v)
    for slack in SLACKS:
        for impl in ("psum", "a2a"):
            cfg = base.with_overrides(capacity_slack=slack, moe_impl=impl)

            def f(p, x):
                o, a = moe_apply(cfg, pol, p, x)
                return jnp.sum(o * up) + a, (o, a)

            (_, (o, a)), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
            tag = f"{impl}_{slack}_{shared}"
            out[tag], out[tag + "_aux"], out[tag + "_gx"] = np.asarray(o), np.asarray(a), np.asarray(gx)
            for k, v in jax.tree_util.tree_flatten_with_path(gp)[0]:
                out[tag + "_g" + jax.tree_util.keystr(k)] = np.asarray(v)
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("moe_ep") / "ref.npz"
    code = f"SLACKS = {SLACKS!r}\nSHAPE = {SHAPE!r}\n" + textwrap.dedent(_REFERENCE)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", code, str(path)], capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert "REFERENCE_OK" in r.stdout, r.stderr[-3000:]
    return dict(np.load(path))


def _tree(ref, prefix):
    """The reference's flattened ``['a']['b']`` keys as a nested dict of tensors."""
    tree: dict = {}
    for k, v in ref.items():
        if not k.startswith(prefix + "["):
            continue
        parts = [s.strip("'") for s in k[len(prefix) + 1:-1].split("][")]
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = torch.as_tensor(v)
    return tree


def _cfg(slack, impl, shared=0):
    return ModelConfig(name="t", family="moe", d_model=32, n_experts=8, moe_top_k=2, moe_d_ff=64, d_ff=64,
                       n_shared_experts=shared, capacity_slack=slack, moe_impl=impl)


def _pol(dp=2, tp=4):
    return ShardingPolicy(rules=base_rules(False), mesh=make_mesh(["cpu"] * (dp * tp), ("data", "model"),
                                                                  shape=(dp, tp)))


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("slack", SLACKS)
@pytest.mark.parametrize("impl", ["psum", "a2a"])
def test_ep_forms_match_the_references_sharded_moe(ref, impl, slack, shared):
    cfg = _cfg(slack, impl, shared)
    p = _tree(ref, f"p{shared}")
    x = torch.as_tensor(ref["x"]).requires_grad_(True)
    live = {k: v.requires_grad_(True) if not isinstance(v, dict) else {a: b.requires_grad_(True) for a, b in v.items()}
            for k, v in p.items()}
    out, aux = MOE.moe_apply(cfg, live, x, pol=_pol())
    tag = f"{impl}_{slack}_{shared}"
    np.testing.assert_allclose(out.detach().numpy(), ref[tag], rtol=3e-5, atol=3e-5)
    assert float(aux.detach()) == pytest.approx(float(ref[tag + "_aux"]), rel=1e-5)
    ((out * torch.as_tensor(ref["up"])).sum() + aux).backward()
    grads = {"x": (x.grad, ref[tag + "_gx"])}
    for k, v in live.items():
        for name, t in (v.items() if isinstance(v, dict) else [(None, v)]):
            key = f"['{k}']" + (f"['{name}']" if name else "")
            grads[key] = (t.grad, ref[tag + "_g" + key])
    for key, (g, want) in grads.items():
        assert np.abs(g.numpy() - want).max() <= 1e-4 * max(float(np.abs(want).max()), 1e-12), (tag, key)
    if slack == 0.25 and not shared:  # pairs were dropped: the output is not the dense one
        dense, _ = MOE.moe_reference(cfg, p, x.detach())
        assert float((out - dense).detach().abs().max()) > 1e-3


@pytest.mark.parametrize("impl", ["psum", "a2a"])
def test_ep_forms_equal_the_dense_oracle_at_slack_8(ref, impl):
    cfg = _cfg(8.0, impl)
    p = _tree(ref, "p0")
    x = torch.as_tensor(ref["x"])
    out, aux = MOE.moe_apply(cfg, p, x, pol=_pol())
    dense, _ = MOE.moe_reference(cfg, p, x)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("slack", SLACKS)
def test_psum_on_an_n_by_1_mesh_is_the_tp1_path_on_each_data_shard_bitwise(ref, dp, slack):
    cfg = _cfg(slack, "psum")
    p = _tree(ref, "p0")
    x = torch.as_tensor(ref["x"])
    out, aux = MOE.moe_apply(cfg, p, x, pol=_pol(dp, 1))
    parts = [MOE.moe_apply(cfg, p, xi) for xi in torch.chunk(x, dp)]
    assert torch.equal(out, torch.cat([o for o, _ in parts]))
    total = parts[0][1]
    for _, a in parts[1:]:
        total = total + a
    assert torch.equal(aux, total / dp)


def test_a_mesh_without_a_model_axis_or_of_one_device_runs_the_tp1_path(ref):
    cfg = _cfg(1.5, "a2a")
    p = _tree(ref, "p0")
    x = torch.as_tensor(ref["x"])
    want = MOE.moe_apply(cfg, p, x)
    for mesh in (make_mesh(["cpu"] * 2), make_mesh(["cpu"], ("data", "model"), shape=(1, 1))):
        got = MOE.moe_apply(cfg, p, x, pol=ShardingPolicy(rules=base_rules(False), mesh=mesh))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_rows_in_no_group_are_zeros_on_poisoned_memory(ref):
    """The pad bucket's rows and the empty all-to-all slots are in no
    expert group; ``ragged_dot`` gives 0 there and so must the loop, or a
    NaN left in the memory reaches the output through a gate of 0."""
    cfg = _cfg(8.0, "psum")
    p = _tree(ref, "p0")
    xbuf = torch.randn(40, 32)
    for _ in range(4):  # freed NaN blocks of the output's size for the allocator to hand back
        junk = torch.full((40, 32), float("nan"))
        del junk
    y = MOE._expert_compute(p["wg"][:4], p["wu"][:4], p["wd"][:4], xbuf, torch.tensor([3, 0, 5, 2]))
    assert torch.equal(y[10:], torch.zeros(30, 32)) and bool(torch.isfinite(y).all())
    for impl in ("psum", "a2a"):
        for slack in SLACKS:
            out, aux = MOE.moe_apply(_cfg(slack, impl), p, torch.as_tensor(ref["x"]), pol=_pol())
            assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(aux))


def _group_size_syncs() -> int:
    return trace.counters().get("moe.group_sizes", 0)


@pytest.mark.parametrize("impl", ["psum", "a2a"])
def test_expert_loop_syncs_once_per_model_shard_per_data_shard(ref, impl):
    p = _tree(ref, "p0")
    before = _group_size_syncs()
    MOE.moe_apply(_cfg(1.5, impl), p, torch.as_tensor(ref["x"]), pol=_pol())
    assert _group_size_syncs() - before == 8
    # a batch smaller than the data axis: every data row holds the same tokens,
    # computed once (psum) -- a2a still splits them over the model axis
    mesh = make_mesh(["cpu"] * 8, ("data", "model"), shape=(2, 4))
    pol = make_policy(mesh, global_batch=1)
    before = _group_size_syncs()
    out, _ = MOE.moe_apply(_cfg(1.5, impl), p, torch.as_tensor(ref["x"][:1]), pol=pol)
    assert _group_size_syncs() - before == 4 and bool(torch.isfinite(out).all())


def test_moe_param_specs():
    p = {"router": torch.zeros(4, 8), "wg": torch.zeros(8, 4, 6), "wu": torch.zeros(8, 4, 6),
         "wd": torch.zeros(8, 6, 4), "shared": {"wg": torch.zeros(4, 6)}, "shared_gate": torch.zeros(4, 1)}
    specs = MOE._moe_param_specs(p)
    assert specs["wg"] == P("model", None, None) and specs["wd"] == P("model", None, None)
    assert specs["router"] == P(None, None) and specs["shared"] == {"wg": P()} and specs["shared_gate"] == P(None, None)
