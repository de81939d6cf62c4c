"""Checkpointing with integrity checks and an asynchronous save, in the
reference's layout:

    <dir>/step_<N>/manifest.json   step, extra, and per file: sha256, shape, dtype
    <dir>/step_<N>/<leaf-name>.npy one file per leaf (the full logical array)

A tree is nested dicts, tuples and lists of tensors (or numpy arrays, or
scalars); leaves are named from their paths exactly as the reference
names them (``_leaf_paths``), so the two packages read each other's
checkpoints.  ``save`` snapshots every leaf to host memory as a COPY
before it returns (an optimizer update in place afterwards cannot race
the writer thread), then writes into a temporary directory, hashes each
file, and publishes it by an atomic rename; ``keep_n`` checkpoints are
kept.  ``restore`` checks every hash and rebuilds the structure of a
given tree, tensors on ``device`` (default: each like-leaf's own), or,
with ``shardings`` (a matching tree of ``runtime.sharding.NamedSharding``),
each leaf placed per its sharding: the elastic restore.  Leaves are
stored in their logical layout, so a checkpoint saved from one mesh
restores onto any other.  A bf16 leaf raises: numpy has no bf16, and the state this package
checkpoints (f32 master weights and optimizer moments, int32 counters)
has none.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.runtime.sharding import device_put


def _flatten(tree, path: str = ""):
    """(JAX-style key path, leaf) pairs in JAX's flattening order: dict
    keys sorted, sequences in order, None an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from _flatten(x, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the iterator
    ``leaves``."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(x, leaves) for x in like)
    if like is None:
        return None
    return next(leaves)


def _leaf_paths(tree) -> list[tuple[str, object]]:
    """(file stem, leaf) per leaf, named as the reference names them."""
    return [
        (path.replace("/", "_").strip("[']").replace("']['", "__").replace("'][", "__")
         .replace("][", "__").replace("'", ""), leaf)
        for path, leaf in _flatten(tree)
    ]


def _host_copy(x) -> np.ndarray:
    """A numpy copy of one leaf, owning its memory."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise ValueError("checkpoint: bf16 leaves are not supported (numpy has no bf16)")
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ---------------- save ----------------
    def save(self, step: int, tree, extra: dict | None = None, sync: bool = False):
        """Snapshot to host memory now (copies); write asynchronously unless
        ``sync``."""
        host = [(name, _host_copy(leaf)) for name, leaf in _leaf_paths(tree)]
        self.wait()
        if sync:
            self._write(step, host, extra or {})
        else:
            self._thread = threading.Thread(target=self._write, args=(step, host, extra or {}))
            self._thread.start()

    def _write(self, step: int, host: list, extra: dict):
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "tensors": {}, "treedef": None}
        names = []
        for name, arr in host:
            fn = f"{name}.npy"
            np.save(os.path.join(tmp, fn), arr)
            with open(os.path.join(tmp, fn), "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            manifest["tensors"][fn] = {"sha256": digest, "shape": list(arr.shape), "dtype": str(arr.dtype)}
            names.append(fn)
        manifest["order"] = names
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        for s in self.all_steps()[: -self.keep_n]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # ---------------- restore ----------------
    def all_steps(self) -> list[int]:
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir) if d.startswith("step_"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like, step: int | None = None, device=None, verify: bool = True, shardings=None):
        """Restore into the structure of ``tree_like``: a tensor leaf comes
        back as a tensor on ``device`` (default: the like-leaf's device),
        any other leaf as a numpy array; with ``shardings``, every leaf as
        the ``ShardedTensor`` its sharding places.  Returns ``(tree, extra,
        step)``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        out = []
        places = [s for _, s in _flatten(shardings)] if shardings is not None else None
        for i, ((_, like), fn) in enumerate(zip(_leaf_paths(tree_like), manifest["order"], strict=True)):
            path = os.path.join(d, fn)
            if verify:
                with open(path, "rb") as f:
                    digest = hashlib.sha256(f.read()).hexdigest()
                if digest != manifest["tensors"][fn]["sha256"]:
                    raise IOError(f"checkpoint corruption detected in {fn}")
            arr = np.load(path)
            if places is not None:
                out.append(device_put(torch.from_numpy(arr), places[i]))
            elif isinstance(like, torch.Tensor):
                out.append(torch.from_numpy(arr).to(device if device is not None else like.device))
            else:
                out.append(arr)
        return _unflatten(tree_like, iter(out)), manifest["extra"], step
