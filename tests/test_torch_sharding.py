"""The port's sharding rules and meshes, against the JAX package.

Partition specs are data, so they are held to the reference's exactly,
as tuples: ``spec_to_pspec`` on ``tests/test_sharding.py``'s cases and its
hypothesis property, ``make_pspecs`` for every config in ``configs/`` on
the single-pod and the multi-pod mesh sizes, ``ShardingPolicy.spec``,
``make_policy``'s rules and ``lm.cache_pspecs``.  Then the port's own
meshes and placements: ``make_mesh`` reshaping, ``make_topology_mesh``
and ``make_production_mesh`` raising on too few devices, ``device_put`` /
``ShardedTensor.full`` and ``shard_batch`` round trips (blocks on their
coordinates' devices, views of one copy per device), gradients through a
placement.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec as RP  # noqa: E402

from repro.configs import all_configs as r_all, get_config as r_get  # noqa: E402
from repro.models import cross_encoder as RCE, dual_encoder as RDE, encoder as RENC, lm as RLM  # noqa: E402
from repro.models.params import ParamSpec as RSpec, make_pspecs as r_make_pspecs, spec_to_pspec as r_s2p  # noqa: E402
from repro.runtime import sharding as RS  # noqa: E402
from repro_torch.configs import all_configs as t_all, get_config as t_get  # noqa: E402
from repro_torch.data.pipeline import LMBatchStream, shard_batch  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.models import cross_encoder as TCE, dual_encoder as TDE, encoder as TENC, lm as TLM  # noqa: E402
from repro_torch.models.params import ParamSpec, make_pspecs, make_shardings, spec_to_pspec  # noqa: E402
from repro_torch.runtime import sharding as TS  # noqa: E402
from repro_torch.runtime.compat import make_mesh, make_topology_mesh  # noqa: E402

SIZES = {"pod": 2, "data": 16, "model": 16}
SINGLE = {"data": 16, "model": 16}
P = TS.PartitionSpec


def _flat(tree, path=""):
    """{path: spec as a plain tuple} of a nested dict / tuple of specs
    (either package's)."""
    if isinstance(tree, (RP, P)):
        return {path: tuple(tree)}
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        out.update(_flat(v, f"{path}/{k}"))
    return out


def _specs(pkg, cfg):
    name = cfg.name
    if name == "contriever-110m":
        return (RDE if pkg == "r" else TDE).param_specs(cfg)
    if name == "bge-reranker-base":
        return (RCE if pkg == "r" else TCE).param_specs(cfg)
    if cfg.family == "encoder":
        return (RENC if pkg == "r" else TENC).param_specs(cfg)
    return (RLM if pkg == "r" else TLM).param_specs(cfg)


class _StubMesh:
    """Production-mesh stand-in: only ``shape`` is read."""

    def __init__(self, shape):
        self.shape = shape


# --- tests/test_sharding.py's cases, on the port --------------------------


def test_divisible_dims_get_sharded():
    s = ParamSpec((1024, 4096), ("embed", "mlp"))
    assert spec_to_pspec(s, TS.base_rules(False), SIZES) == P("data", "model")


def test_non_divisible_dims_stay_replicated():
    s = ParamSpec((960, 15, 64), ("embed", "heads", "head_dim"))
    assert spec_to_pspec(s, TS.base_rules(False), SIZES) == P("data", None, None)


def test_mesh_axis_never_reused():
    s = ParamSpec((64, 4096, 4096), ("experts", "expert_in", "mlp"))
    rules = dict(TS.base_rules(False), expert_in="model")
    ps = spec_to_pspec(s, rules, SIZES)
    flat = [a for e in ps if e for a in ((e,) if isinstance(e, str) else e)]
    assert len(flat) == len(set(flat))
    assert tuple(ps) == tuple(r_s2p(RSpec((64, 4096, 4096), ("experts", "expert_in", "mlp")),
                                    dict(RS.base_rules(False), expert_in="model"), SIZES))


def test_multi_axis_batch_partial_divisibility():
    pol = TS.ShardingPolicy(rules=TS.base_rules(True), mesh=None)
    assert pol.spec("act_batch", shape=(32,)) == P(("pod", "data"))


@given(dim=st.integers(1, 4096), ax=st.sampled_from(["embed", "mlp", "vocab", "heads", "experts"]))
@settings(max_examples=40, deadline=None)
def test_filter_property_shard_divides(dim, ax):
    ps = spec_to_pspec(ParamSpec((dim,), (ax,)), TS.base_rules(False), SIZES)
    entry = ps[0]
    if entry is not None:
        axes = (entry,) if isinstance(entry, str) else entry
        assert dim % int(np.prod([SIZES[a] for a in axes])) == 0
    assert tuple(ps) == tuple(r_s2p(RSpec((dim,), (ax,)), RS.base_rules(False), SIZES))


def test_policy_small_batch_replicates_and_reshards_cache():
    pol = TS.make_policy(_StubMesh(SINGLE), shape_kind="decode", global_batch=1, seq_len=1 << 19, long_context=True)
    assert pol.rules["act_batch"] is None and pol.rules["cache_seq"] == "data"


def test_policy_normal_batch_keeps_data_sharding():
    pol = TS.make_policy(_StubMesh(SINGLE), shape_kind="decode", global_batch=128, seq_len=1 << 15)
    assert pol.rules["act_batch"] == ("data",) and pol.rules["cache_seq"] is None


# --- exact parity with the reference --------------------------------------


def test_base_rules_equal_the_reference():
    for multi in (False, True):
        assert TS.base_rules(multi) == RS.base_rules(multi)


@pytest.mark.parametrize("sizes", [SINGLE, SIZES], ids=["single_pod", "multi_pod"])
def test_make_pspecs_equal_the_reference_for_every_config(sizes):
    multi = "pod" in sizes
    r_cfgs, t_cfgs = r_all(), t_all()
    assert set(r_cfgs) == set(t_cfgs)
    for name in sorted(r_cfgs):
        want = _flat(r_make_pspecs(_specs("r", r_cfgs[name]), RS.base_rules(multi), sizes))
        got = _flat(make_pspecs(_specs("t", t_cfgs[name]), TS.base_rules(multi), sizes))
        assert got == want, name
        # and without sizes (no divisibility filter)
        assert _flat(make_pspecs(_specs("t", t_cfgs[name]), TS.base_rules(multi))) == _flat(
            r_make_pspecs(_specs("r", r_cfgs[name]), RS.base_rules(multi))), name


@pytest.mark.parametrize("kw", [
    dict(global_batch=256, seq_len=4096), dict(global_batch=8, seq_len=1 << 19, long_context=True),
    dict(global_batch=1, seq_len=1 << 17), dict(global_batch=4, seq_len=2048), dict(),
])
@pytest.mark.parametrize("shape", [SINGLE, SIZES, {"data": 2, "model": 4}, {"data": 4, "model": 1}],
                         ids=["16x16", "2x16x16", "2x4", "4x1"])
def test_make_policy_spec_and_cache_pspecs_equal_the_reference(shape, kw):
    multi = "pod" in shape
    r_pol = RS.make_policy(_StubMesh(shape), multi_pod=multi, **kw)
    t_pol = TS.make_policy(_StubMesh(shape), multi_pod=multi, **kw)
    assert t_pol.rules == r_pol.rules
    logical = [("act_batch", "act_seq", "act_embed"), ("act_batch", "act_seq", "act_heads", None),
               ("cache_batch", "cache_seq", "cache_kv", None), ("act_batch", "act_vocab"), ("embed", "embed"),
               (None, "act_ff")]
    for axes in logical:
        for dims in [(8, 256, 1024, 128), (3, 5, 7, 11), (1, 1 << 19, 64, 64), (32, 32, 32, 32)]:
            got = t_pol.spec(*axes, shape=dims[:len(axes)])
            assert tuple(got) == tuple(r_pol.spec(*axes, shape=dims[:len(axes)])), (axes, dims)
        assert tuple(t_pol.spec(*axes)) == tuple(r_pol.spec(*axes))
    for name in ("qwen3-0.6b", "qwen2-moe-a2.7b", "mamba2-1.3b", "jamba-1.5-large-398b"):
        assert _flat(TLM.cache_pspecs(t_get(name), t_pol)) == _flat(RLM.cache_pspecs(r_get(name), r_pol)), name


# --- meshes, placements -------------------------------------------------------


def test_make_mesh_reshapes_and_takes_nested_lists():
    flat = make_mesh(["cpu"] * 8, ("data", "model"), shape=(2, 4))
    nested = make_mesh([["cpu"] * 4, ["cpu"] * 4], ("data", "model"))
    for m in (flat, nested):
        assert m.shape == {"data": 2, "model": 4} and m.size == 8 and m.lead == torch.device("cpu")
        assert list(m.coords())[:5] == [(0, 0), (0, 1), (0, 2), (0, 3), (1, 0)]
    assert make_mesh(np.array(["cpu"] * 6, dtype=object).reshape(1, 2, 3), ("pod", "data", "model")).shape == {
        "pod": 1, "data": 2, "model": 3}
    sub = flat.submesh(data=1)
    assert sub.shape == {"data": 1, "model": 4} and sub.size == 4
    assert flat.axis_devices("model", data=1) == (torch.device("cpu"),) * 4
    assert make_mesh(["cpu"] * 3).shape == {"data": 3}  # the one-axis callers, unchanged
    with pytest.raises(ValueError):
        make_mesh(["cpu"] * 8, ("data", "model"))  # a flat list of two axes needs a shape
    with pytest.raises(ValueError):
        make_mesh(["cpu"] * 6, ("data", "model"), shape=(4, 2))
    with pytest.raises(ValueError):
        make_mesh([], ("data",))


def test_topology_and_production_meshes_raise_on_too_few_devices(monkeypatch):
    with pytest.raises(RuntimeError, match="needs 8"):
        make_topology_mesh((2, 4), ("data", "model"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="only 2"):
        make_topology_mesh((2, 4), ("data", "model"))
    m = make_topology_mesh((2, 1), ("data", "model"))
    assert m.devices == (torch.device("cuda:0"), torch.device("cuda:1"))  # never a silent repeat
    with pytest.raises(RuntimeError, match="needs 256"):
        t_mesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512"):
        t_mesh.make_production_mesh(multi_pod=True)
    assert t_mesh.make_smoke_mesh((2, 4), device="cpu").shape == {"data": 2, "model": 4}


@pytest.mark.parametrize("spec", [P("data", None), P(("data", "model")), P(None, "model"), P(), P("model", "data"),
                                  P(("model", "data"), None)])
def test_device_put_blocks_and_round_trip(spec):
    mesh = make_mesh(["cpu"] * 8, ("data", "model"), shape=(2, 4))
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    placed = TS.device_put(x, TS.NamedSharding(mesh, spec))
    assert torch.equal(placed.full(), x) and placed.shape == (8, 12)
    counts = TS.NamedSharding(mesh, spec).blocks_along(2)
    for coord in mesh.coords():
        blk = placed.block(coord)
        idx = TS.NamedSharding(mesh, spec).block_index(coord, 2)
        r, c = 8 // counts[0], 12 // counts[1]
        assert torch.equal(blk, x[idx[0] * r:(idx[0] + 1) * r, idx[1] * c:(idx[1] + 1) * c]), coord
        assert blk.device == mesh.device(coord)
        assert blk.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()  # a view, no copy
    with pytest.raises(ValueError):
        TS.device_put(torch.zeros(3, 4), TS.NamedSharding(mesh, P("model")))  # 3 rows over 4
    with pytest.raises(ValueError):
        TS.device_put(x, TS.NamedSharding(mesh, P("pod")))  # not an axis of the mesh


def test_gradients_flow_through_a_placement():
    mesh = make_mesh(["cpu"] * 4, ("data", "model"), shape=(2, 2))
    x = torch.randn(4, 6, requires_grad=True)
    placed = TS.device_put(x, TS.NamedSharding(mesh, P("data", "model")))
    (placed.full() * 3).sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, 3.0))
    pol = TS.make_policy(mesh, global_batch=4)
    assert pol.shard(x, "act_batch", None).sharding.spec == P("data", None)
    assert TS.ShardingPolicy(rules=TS.base_rules(False)).shard(x, "act_batch") is x
    assert TS.replicated(mesh).spec == P()


def test_shard_batch_puts_each_data_shards_rows_on_its_devices():
    mesh = make_mesh(["cpu"] * 8, ("data", "model"), shape=(2, 4))
    raw = LMBatchStream(4, 16, 256, seed=3).next()
    pol = TS.make_policy(mesh, global_batch=4, seq_len=16)
    placed = shard_batch(raw, mesh, pol.spec("act_batch", shape=(4,)))
    for k, v in raw.items():
        assert np.array_equal(placed[k].full().numpy(), v)
        for coord in mesh.coords():
            assert np.array_equal(placed[k].block(coord).numpy(), v[2 * coord[0]:2 * coord[0] + 2]), (k, coord)
    plain = shard_batch(raw, None, None, device="cpu")
    assert all(isinstance(t, torch.Tensor) and np.array_equal(t.numpy(), raw[k]) for k, t in plain.items())
    # a batch smaller than the data axis stays whole on every device
    small = TS.make_policy(make_mesh(["cpu"] * 4, ("data", "model"), shape=(4, 1)), global_batch=2)
    assert small.spec("act_batch", shape=(2,)) == P(None)
    assert [c for c, _ in TS.data_shards(small, 2)] == [(0, 0)]


def test_make_shardings_and_data_shards():
    mesh = make_mesh(["cpu"] * 8, ("data", "model"), shape=(2, 4))
    specs = TLM.param_specs(t_get("qwen2-moe-a2.7b"))
    sh = make_shardings(specs, mesh, TS.base_rules(False))
    want = _flat(r_make_pspecs(RLM.param_specs(r_get("qwen2-moe-a2.7b")), RS.base_rules(False),
                               {"data": 2, "model": 4}))
    got = {}
    from repro_torch.models.params import leaves
    for path, s in leaves(sh):
        assert s.mesh is mesh
        got["/" + path] = tuple(s.spec)
    assert got == want
    pol = TS.make_policy(mesh, global_batch=8)
    shards = TS.data_shards(pol, 8)
    assert [c for c, _ in shards] == [(0, 0), (1, 0)]
    assert [p.mesh.shape for _, p in shards] == [{"data": 1, "model": 4}] * 2
    assert shards[1][1].mesh.devices == mesh.axis_devices("model", data=1)
