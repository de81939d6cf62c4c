"""The port's checkpointing and restartable training: the reference's
tests/test_checkpoint.py re-asserted (all but the elastic-sharding test,
which waits for the multi-device slice), the on-disk layout held to the
reference's (names, shapes, dtypes, sha256), checkpoints read across the
two packages, the snapshot a copy, the launcher's crash-and-resume, and
``LMBatchStream`` against the reference's tokens.

Resumed losses equal the straight run's at rel 1e-5, as in the reference
test (the CPU run is deterministic, so they are in fact equal).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.checkpoint import CheckpointManager as RefManager  # noqa: E402
from repro.data.pipeline import LMBatchStream as RefStream  # noqa: E402
from repro_torch.checkpoint.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.data.pipeline import LMBatchStream  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.optim.optimizers import get_optimizer  # noqa: E402
from repro_torch.runtime.train_loop import SimulatedFailure, Trainer, TrainerConfig  # noqa: E402


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": rng.normal(size=(16, 8)).astype(np.float32),
        "nested": {"b": np.arange(10, dtype=np.int32), "c": np.float32(3.5)},
    }


def _tree(seed=0):
    return {
        "a": torch.as_tensor(_np_tree(seed)["a"]),
        "nested": {"b": torch.arange(10, dtype=torch.int32), "c": torch.tensor(3.5)},
    }


def _equal(a, b):
    for (x, y) in zip(_flat(a), _flat(b)):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def _flat(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _flat(t[k])]
    if isinstance(t, (tuple, list)):
        return [x for v in t for x in _flat(v)]
    return [t]


def test_roundtrip(tmp_path):
    m = CheckpointManager(str(tmp_path))
    t = _tree()
    m.save(7, t, extra={"stream": {"seed": 1, "step": 9}}, sync=True)
    restored, extra, step = m.restore(t)
    assert step == 7 and extra["stream"]["step"] == 9
    _equal(t, restored)
    assert restored["nested"]["b"].dtype == torch.int32


def test_async_save_then_restore(tmp_path):
    m = CheckpointManager(str(tmp_path))
    t = _tree()
    m.save(1, t, sync=False)
    m.wait()
    restored, _, _ = m.restore(t)
    assert torch.equal(restored["a"], t["a"])


def test_snapshot_is_a_copy(tmp_path):
    """An in-place update right after ``save`` returns does not reach the
    checkpoint being written."""
    m = CheckpointManager(str(tmp_path))
    t = _tree()
    want = t["a"].clone()
    m.save(2, t, sync=False)
    t["a"].add_(1.0)  # e.g. an optimizer's in-place step
    m.wait()
    restored, _, _ = m.restore(t)
    assert torch.equal(restored["a"], want)


def test_corruption_detected(tmp_path):
    m = CheckpointManager(str(tmp_path))
    t = _tree()
    m.save(0, t, sync=True)
    d = os.path.join(str(tmp_path), "step_0")
    victim = [f for f in os.listdir(d) if f.endswith(".npy")][0]
    with open(os.path.join(d, victim), "r+b") as f:
        f.seek(200)
        f.write(b"\xde\xad")
    with pytest.raises(IOError, match="corruption"):
        m.restore(t)


def test_keep_n_gc(tmp_path):
    m = CheckpointManager(str(tmp_path), keep_n=2)
    t = {"x": torch.zeros(4)}
    for s in range(5):
        m.save(s, t, sync=True)
    assert m.all_steps() == [3, 4]


def test_bf16_leaf_raises(tmp_path):
    with pytest.raises(ValueError, match="bf16"):
        CheckpointManager(str(tmp_path)).save(0, {"x": torch.zeros(4, dtype=torch.bfloat16)}, sync=True)


def test_manifest_equals_the_reference(tmp_path):
    """The same numpy tree saved by both packages: the same files, names,
    shapes, dtypes and sha256, and the same order."""
    tree = ({"params": _np_tree(1), "count": np.int32(4)},
            [np.ones(3, np.float32), {"z": np.zeros((2, 2), np.float32)}])
    RefManager(str(tmp_path / "ref")).save(5, jax.tree.map(jnp.asarray, tree), extra={"k": 1}, sync=True)
    torch_tree = jax.tree.map(lambda x: torch.as_tensor(np.asarray(x)), tree)
    CheckpointManager(str(tmp_path / "port")).save(5, torch_tree, extra={"k": 1}, sync=True)
    with open(tmp_path / "ref" / "step_5" / "manifest.json") as f:
        ref = json.load(f)
    with open(tmp_path / "port" / "step_5" / "manifest.json") as f:
        port = json.load(f)
    assert ref == port
    assert "0__params__nested__c.npy" in port["order"]


def test_reference_checkpoint_restores_exactly_into_the_port(tmp_path):
    key = jax.random.PRNGKey(3)
    ref_tree = {"w": jax.random.normal(key, (8, 4)), "opt": {"mu": jnp.zeros((8, 4)), "count": jnp.int32(7)}}
    RefManager(str(tmp_path)).save(11, ref_tree, extra={"stream": {"seed": 2, "step": 12}}, sync=True)
    like = {"w": torch.zeros(8, 4), "opt": {"mu": torch.ones(8, 4), "count": torch.tensor(0, dtype=torch.int32)}}
    got, extra, step = CheckpointManager(str(tmp_path)).restore(like)
    assert step == 11 and extra == {"stream": {"seed": 2, "step": 12}}
    assert np.array_equal(got["w"].numpy(), np.asarray(ref_tree["w"]))
    assert torch.equal(got["opt"]["mu"], torch.zeros(8, 4)) and int(got["opt"]["count"]) == 7
    # and the other way: a port checkpoint restores into the reference
    CheckpointManager(str(tmp_path / "p")).save(3, like, sync=True)
    back, _, _ = RefManager(str(tmp_path / "p")).restore(ref_tree)
    assert np.array_equal(np.asarray(back["opt"]["mu"]), np.ones((8, 4), np.float32))


def _mk_trainer(tmp_path, steps, fail_at=None):
    cfg = smoke_config(get_config("qwen3-0.6b"))
    stream = LMBatchStream(2, 32, cfg.vocab_size, seed=5)
    tcfg = TrainerConfig(total_steps=steps, ckpt_every=4, ckpt_dir=str(tmp_path), fail_at_step=fail_at)
    return Trainer(cfg, get_optimizer("adamw"), stream, tcfg, lr_fn=lambda s: 1e-3, device="cpu")


def test_failure_restart_resumes_exact_trajectory(tmp_path):
    """Train 12 steps straight vs crash-at-8 + resume: identical losses."""
    t_ref = _mk_trainer(tmp_path / "ref", 12)
    t_ref.run(resume="never")
    ref_losses = [m["loss"] for m in t_ref.metrics_log]

    t_crash = _mk_trainer(tmp_path / "crash", 12, fail_at=8)
    with pytest.raises(SimulatedFailure):
        t_crash.run(resume="never")
    t_resume = _mk_trainer(tmp_path / "crash", 12)
    t_resume.run(resume="auto")
    assert t_resume.metrics_log[0]["step"] == 8
    resumed = {m["step"]: m["loss"] for m in t_crash.metrics_log + t_resume.metrics_log}
    for i, ref in enumerate(ref_losses):
        assert resumed[i] == pytest.approx(ref, rel=1e-5), f"step {i} diverged after restart"


def test_launcher_fail_then_resume_equals_straight_run(tmp_path):
    common = ["--reduced", "--device", "cpu", "--steps", "6", "--batch", "2", "--seq", "16", "--ckpt-every", "2"]
    _, straight = launch_train.main(common + ["--ckpt-dir", str(tmp_path / "a"), "--resume", "never"])
    with pytest.raises(SimulatedFailure):
        launch_train.main(common + ["--ckpt-dir", str(tmp_path / "b"), "--fail-at", "3"])
    out = tmp_path / "metrics.json"
    _, resumed = launch_train.main(common + ["--ckpt-dir", str(tmp_path / "b"), "--metrics-out", str(out)])
    assert [m["step"] for m in resumed.metrics_log] == [2, 3, 4, 5]  # from the step-1 checkpoint
    want = {m["step"]: m["loss"] for m in straight.metrics_log}
    for m in resumed.metrics_log:
        assert m["loss"] == pytest.approx(want[m["step"]], rel=1e-5)
    assert [m["step"] for m in json.loads(out.read_text())] == [2, 3, 4, 5]


@pytest.mark.parametrize("vocab,markov", [(512, True), (8192, False), (151936, True)])
def test_lm_batch_stream_matches_reference_and_resumes(vocab, markov):
    ref, port = RefStream(3, 24, vocab, seed=7, markov=markov), LMBatchStream(3, 24, vocab, seed=7, markov=markov)
    for _ in range(3):
        a, b = ref.next(), port.next()
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a)
    state = port.state_dict()
    assert state == ref.state_dict() == {"seed": 7, "step": 3}
    again = LMBatchStream(3, 24, vocab, seed=0, markov=markov)
    again.load_state_dict(json.loads(json.dumps(state)))
    nxt, want = again.next(), port.next()
    assert all(np.array_equal(nxt[k], want[k]) for k in want)
