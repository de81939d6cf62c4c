"""The port's data-parallel train step, ``grad_pspecs``, the elastic
restore and the launcher's meshes, against the JAX package.

qwen3-0.6b at smoke width in f32: the data-parallel gradients on ``(2,
1)`` and ``(4, 1)`` meshes of ``cpu`` against the reference's
single-device ``jax.value_and_grad`` (the dense model's global loss does
not depend on the mesh), on a batch whose rows mask very different
numbers of targets; two AdamW steps against the reference's jitted step.
qwen2-moe-a2.7b at smoke width: on ``(2, 1)`` and on 2 x 4 (``psum`` and
``a2a``) against the reference's SHARDED ``value_and_grad``, run in one
subprocess on 8 fake host devices: its per-shard capacity and averaged
aux loss differ from the single-device step's.  Tolerances are the train
tests' (tests/test_torch_train.py): losses 2e-5 relative, gradients 1e-4
of the leaf's largest entry, AdamW parameters 1e-5 at lr 1e-3.  Within the
port, bitwise: the reduce-scatter form (``grad_pspecs``) against the
all-reduce form, a batch smaller than the data axis against the
one-device step, the step without a mesh unchanged.  The elastic restore
(tests/test_checkpoint.py:92-103's contract, and a run saved on ``(2, 1)``
resumed on ``(4, 1)`` equal to one that changes mesh without a crash),
and ``launch/train.py --shards`` / ``--mesh`` on the CPU.
"""
import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as r_get, smoke_config as r_smoke  # noqa: E402
from repro.models import lm as RLM  # noqa: E402
from repro.models import params as RP  # noqa: E402
from repro.optim.optimizers import get_optimizer as r_opt  # noqa: E402
from repro.runtime.sharding import ShardingPolicy as RPol, base_rules as r_rules  # noqa: E402
from repro.runtime.steps import make_train_step as r_train_step  # noqa: E402
from repro_torch.checkpoint.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config as t_get, smoke_config as t_smoke  # noqa: E402
from repro_torch.data.pipeline import LMBatchStream, shard_batch  # noqa: E402
from repro_torch.launch import train as t_launch  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.optim.optimizers import get_optimizer as t_opt  # noqa: E402
from repro_torch.runtime import steps as TS  # noqa: E402
from repro_torch.runtime.compat import make_mesh  # noqa: E402
from repro_torch.runtime.sharding import (  # noqa: E402
    NamedSharding, PartitionSpec as P, ShardedTensor, make_policy,
)
from repro_torch.runtime.train_loop import SimulatedFailure, Trainer, TrainerConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MOE_CASES = [((2, 1), "psum"), ((2, 4), "psum"), ((2, 4), "a2a")]


def _batch(vocab, b=4, s=32, seed=0):
    """Rows that mask very different numbers of targets: row 0 keeps one,
    row 1 a third, the others all but the first."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    tgt = tok.copy()
    tgt[0, 1:] = -1
    tgt[1, ::3] = -1
    tgt[2:, 0] = -1
    return {"tokens": tok, "targets": tgt}


def _mesh(dp, tp=1):
    return make_mesh(["cpu"] * (dp * tp), ("data", "model"), shape=(dp, tp))


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _bridged(name):
    cfg = r_smoke(r_get(name)).with_overrides(dtype="float32", attn_impl="naive")
    tcfg = t_smoke(t_get(name)).with_overrides(dtype="float32")
    params = RP.init_params(RLM.param_specs(cfg), jax.random.PRNGKey(1))
    return cfg, tcfg, params, jax.tree.map(np.asarray, params)


def _tparams(name):
    _, tcfg, _, np_params = _bridged(name)
    return TP.from_reference(TLM.param_specs(tcfg), np_params, device="cpu")


def _close(grads, want):
    got = dict(TP.leaves(grads))
    for path, w in TP.leaves(want):
        g = got[path].numpy()
        assert np.abs(g - w).max() <= 1e-4 * max(float(np.abs(w).max()), 1e-12), path


# --- qwen3-0.6b: the dense model, against the single-device reference -------


@pytest.mark.parametrize("dp", [2, 4])
def test_dp_gradients_match_the_references_single_device_grad(dp):
    cfg, tcfg, params, _ = _bridged("qwen3-0.6b")
    batch = _batch(cfg.vocab_size)
    pol0 = RPol(rules=r_rules(False), mesh=None)
    (loss, m), want = jax.value_and_grad(lambda p: RLM.loss_fn(cfg, pol0, p, {k: jnp.asarray(v) for k, v in
                                                                             batch.items()}), has_aux=True)(params)
    mesh = _mesh(dp)
    pol = make_policy(mesh, global_batch=4, seq_len=32)
    placed = shard_batch(batch, mesh, pol.spec("act_batch", shape=(4,)))
    got_loss, got_m, grads = TS.data_parallel_grads(tcfg, pol, _tparams("qwen3-0.6b"), placed)
    assert float(got_loss) == pytest.approx(float(loss), rel=2e-5)
    assert float(got_m["ce"]) == pytest.approx(float(m["ce"]), rel=2e-5)
    assert float(got_m["tokens"]) == float(m["tokens"])
    _close(grads, jax.tree.map(np.asarray, want))
    # the unweighted mean of the shards' own losses is another number
    own = [float(TLM.loss_fn(tcfg, _tparams("qwen3-0.6b"), _t({k: np.split(v, dp)[i] for k, v in batch.items()}))[0])
           for i in range(dp)]
    assert abs(np.mean(own) - float(loss)) > 1e-3


def test_dp_two_adamw_steps_match_the_references_jitted_step():
    cfg, tcfg, params, _ = _bridged("qwen3-0.6b")
    batch = _batch(cfg.vocab_size, seed=3)
    pol0 = RPol(rules=r_rules(False), mesh=None)
    r_step = jax.jit(r_train_step(cfg, pol0, r_opt("adamw"), lambda s: 1e-3))
    mesh = _mesh(2)
    pol = make_policy(mesh, global_batch=4)
    t_step = TS.make_train_step(tcfg, t_opt("adamw"), lambda s: 1e-3, pol=pol)
    rp, rs = params, r_opt("adamw").init(params)
    tp = _tparams("qwen3-0.6b")
    ts = t_opt("adamw").init(tp)
    for i in range(2):
        rp, rs, rm = r_step(rp, rs, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(i))
        tp, ts, tm = t_step(tp, ts, shard_batch(batch, mesh, P("data")), i)
        for k in ("loss", "grad_norm"):
            assert float(tm[k]) == pytest.approx(float(rm[k]), rel=1e-5), (i, k)
    for (path, a), (_, b) in zip(TP.leaves(jax.tree.map(np.asarray, rp)), TP.leaves(tp)):
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-5, err_msg=path)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("dp", [2, 4])
def test_grad_pspecs_reduce_scatter_is_bitwise_the_all_reduce(dp, bf16):
    _, tcfg, _, _ = _bridged("qwen3-0.6b")
    tcfg = tcfg.with_overrides(bf16_grads=bf16)
    mesh = _mesh(dp)
    pol = make_policy(mesh, global_batch=4)
    pspecs = TP.make_pspecs(TLM.param_specs(tcfg), pol.rules, dict(mesh.shape))
    assert any("data" in s for _, s in TP.leaves(pspecs))  # some leaves are reduce-scattered
    batch = _t(_batch(tcfg.vocab_size))
    params = _tparams("qwen3-0.6b")
    a = TS.data_parallel_grads(tcfg, pol, params, batch)
    b = TS.data_parallel_grads(tcfg, pol, params, batch, grad_pspecs=pspecs)
    assert torch.equal(a[0], b[0])
    for (path, x), (_, y) in zip(TP.leaves(a[2]), TP.leaves(b[2])):
        assert x.dtype == (torch.bfloat16 if bf16 else torch.float32) and torch.equal(x, y), path
    opt = t_opt("adamw")
    sa = TS.make_train_step(tcfg, opt, pol=pol)(params, opt.init(params), batch, 0)
    sb = TS.make_train_step(tcfg, opt, grad_pspecs=pspecs, pol=pol)(params, opt.init(params), batch, 0)
    for (path, x), (_, y) in zip(TP.leaves(sa[0]), TP.leaves(sb[0])):
        assert torch.equal(x, y), path


def test_a_batch_smaller_than_the_data_axis_is_the_one_device_step():
    _, tcfg, _, _ = _bridged("qwen3-0.6b")
    batch = _t(_batch(tcfg.vocab_size, b=2))
    params = _tparams("qwen3-0.6b")
    pol = make_policy(_mesh(4), global_batch=2)
    assert pol.rules["act_batch"] is None
    loss, _, grads = TS.data_parallel_grads(tcfg, pol, params, batch)
    want_loss, _, want = TS.value_and_grad(lambda p: TLM.loss_fn(tcfg, p, batch), params)
    assert torch.equal(loss, want_loss)
    for (path, x), (_, y) in zip(TP.leaves(grads), TP.leaves(want)):
        assert torch.equal(x, y), path
    opt = t_opt("adamw")
    one = TS.make_train_step(tcfg, opt)(params, opt.init(params), batch, 0)
    none = TS.make_train_step(tcfg, opt, pol=make_policy(None))(params, opt.init(params), batch, 0)
    for (path, x), (_, y) in zip(TP.leaves(one[0]), TP.leaves(none[0])):
        assert torch.equal(x, y), path


# --- qwen2-moe-a2.7b: against the reference's sharded step ------------------

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, smoke_config
from repro.models import lm as LM
from repro.models.params import init_params
from repro.runtime.compat import make_mesh
from repro.runtime.sharding import make_policy

base = smoke_config(get_config("qwen2-moe-a2.7b")).with_overrides(dtype="float32", attn_impl="naive")
params = init_params(LM.param_specs(base), jax.random.PRNGKey(1))
batch = {k: jnp.asarray(v) for k, v in np.load(sys.argv[2]).items()}
out = {}
for (dp, tp), impl in CASES:
    cfg = base.with_overrides(moe_impl=impl)
    mesh = make_mesh(np.array(jax.devices()[:dp * tp]).reshape(dp, tp), ("data", "model"))
    pol = make_policy(mesh, global_batch=batch["tokens"].shape[0])
    (loss, m), g = jax.jit(jax.value_and_grad(lambda p: LM.loss_fn(cfg, pol, p, batch), has_aux=True))(params)
    tag = f"{dp}x{tp}_{impl}"
    out[tag + "_loss"], out[tag + "_ce"], out[tag + "_aux"] = np.asarray(loss), np.asarray(m["ce"]), np.asarray(m["aux"])
    for k, v in jax.tree_util.tree_flatten_with_path(g)[0]:
        out[tag + "_g" + jax.tree_util.keystr(k)] = np.asarray(v)
for k, v in jax.tree_util.tree_flatten_with_path(params)[0]:
    out["p" + jax.tree_util.keystr(k)] = np.asarray(v)
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
"""


def _tree(ref, prefix):
    tree: dict = {}
    for k, v in ref.items():
        if not k.startswith(prefix + "["):
            continue
        parts = [s.strip("'") for s in k[len(prefix) + 1:-1].split("][")]
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return tree


@pytest.fixture(scope="module")
def moe_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_moe")
    np.savez(d / "batch.npz", **_batch(t_smoke(t_get("qwen2-moe-a2.7b")).vocab_size))
    code = f"CASES = {MOE_CASES!r}\n" + textwrap.dedent(_REFERENCE)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", code, str(d / "ref.npz"), str(d / "batch.npz")], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    assert "REFERENCE_OK" in r.stdout, r.stderr[-3000:]
    return dict(np.load(d / "ref.npz")), dict(np.load(d / "batch.npz"))


@pytest.mark.parametrize("shape,impl", MOE_CASES)
def test_moe_dp_and_ep_gradients_match_the_references_sharded_step(moe_ref, shape, impl):
    ref, batch = moe_ref
    tcfg = t_smoke(t_get("qwen2-moe-a2.7b")).with_overrides(dtype="float32", moe_impl=impl)
    params = TP.from_reference(TLM.param_specs(tcfg), _tree(ref, "p"), device="cpu")
    mesh = _mesh(*shape)
    pol = make_policy(mesh, global_batch=4)
    loss, m, grads = TS.data_parallel_grads(tcfg, pol, params, shard_batch(batch, mesh, P("data")))
    tag = f"{shape[0]}x{shape[1]}_{impl}"
    assert float(loss) == pytest.approx(float(ref[tag + "_loss"]), rel=2e-5)
    assert float(m["aux"]) == pytest.approx(float(ref[tag + "_aux"]), rel=2e-5)
    assert float(m["ce"]) == pytest.approx(float(ref[tag + "_ce"]), rel=2e-5)
    _close(grads, _tree(ref, tag + "_g"))
    if shape == (2, 4):  # and the reduce-scatter form, bitwise
        pspecs = TP.make_pspecs(TLM.param_specs(tcfg), pol.rules, dict(mesh.shape))
        rs = TS.data_parallel_grads(tcfg, pol, params, _t(batch), grad_pspecs=pspecs)[2]
        for (path, x), (_, y) in zip(TP.leaves(grads), TP.leaves(rs)):
            assert torch.equal(x, y), path


# --- the elastic restore -----------------------------------------------------


def test_elastic_restore_to_different_sharding(tmp_path):
    """tests/test_checkpoint.py:92-103's contract, then onto 2 x 4."""
    m = CheckpointManager(str(tmp_path))
    t = {"w": torch.randn(8, 4)}
    m.save(0, t, sync=True)
    mesh = make_mesh(["cpu"], ("data",))
    sh = {"w": NamedSharding(mesh, P("data", None))}
    restored, _, _ = m.restore(t, shardings=sh)
    assert restored["w"].sharding == sh["w"]
    np.testing.assert_allclose(restored["w"].full().numpy(), t["w"].numpy())
    mesh = _mesh(2, 4)
    sh = {"w": NamedSharding(mesh, P("model", "data"))}
    restored, _, _ = m.restore(t, shardings=sh)
    assert torch.equal(restored["w"].full(), t["w"])
    assert torch.equal(restored["w"].block((1, 3)), t["w"][6:8, 2:4])


def test_a_run_saved_on_one_mesh_resumes_on_another(tmp_path):
    _, tcfg, _, _ = _bridged("qwen3-0.6b")
    specs = TLM.param_specs(tcfg)

    def trainer(tag, dp, steps, **kw):
        mesh = _mesh(dp)
        pol = make_policy(mesh, global_batch=4, seq_len=16)
        return Trainer(tcfg, t_opt("adamw"), LMBatchStream(4, 16, tcfg.vocab_size, seed=0),
                       TrainerConfig(total_steps=steps, ckpt_dir=str(tmp_path / tag), ckpt_every=2, **kw),
                       lr_fn=lambda s: 1e-3, pol=pol, shardings=TP.make_shardings(specs, mesh, pol.rules))

    crashed = trainer("crash", 2, 4, fail_at_step=2)
    with pytest.raises(SimulatedFailure):
        crashed.run(resume="never")
    # the checkpoint restored onto (4, 1): each leaf placed as its sharding names, bitwise the saved one
    mesh4 = _mesh(4)
    pol4 = make_policy(mesh4, global_batch=4)
    sh = TP.make_shardings(specs, mesh4, pol4.rules)
    like = trainer("crash", 4, 4).init_state(0)
    saved, _, _ = crashed.ckpt.restore(like, device="cpu")
    placed, _, _ = crashed.ckpt.restore(like, shardings=(sh, trainer("x", 4, 4).state_shardings(like[1])))
    for (path, a), (_, b), (_, s) in zip(TP.leaves(saved[0]), TP.leaves(placed[0]), TP.leaves(sh)):
        assert isinstance(b, ShardedTensor) and b.sharding == s and torch.equal(b.full(), a), path
    resumed = trainer("crash", 4, 4)
    resumed.run(resume="auto")
    first = trainer("switch", 2, 2)
    first.run(resume="never")
    second = trainer("switch", 4, 4)
    second.run(resume="auto")
    got = {m["step"]: m["loss"] for m in crashed.metrics_log + resumed.metrics_log}
    want = {m["step"]: m["loss"] for m in first.metrics_log + second.metrics_log}
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for i in range(4):
        assert got[i] == pytest.approx(want[i], rel=1e-5), i


@pytest.mark.parametrize("args,mesh", [(["--shards", "2"], "{'data': 2, 'model': 1}"),
                                       (["--arch", "qwen2-moe-a2.7b", "--mesh", "2x2"], "{'data': 2, 'model': 2}")])
def test_launcher_trains_on_a_cpu_mesh(tmp_path, capsys, args, mesh):
    t_launch.main(["--reduced", "--device", "cpu", "--steps", "2", "--batch", "4", "--seq", "16", "--ckpt-every", "1",
                   "--ckpt-dir", str(tmp_path), *args])
    out = capsys.readouterr().out
    assert f"mesh {mesh} on ['cpu'" in out and "final: {" in out
