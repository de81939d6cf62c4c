"""Parameter declaration and initialisation.

A model declares its parameters once as a nested dict of ``ParamSpec``
(shape, logical axis names, initializer), with the same keys and shapes
as the JAX package's tree.  From it come ``init_params`` (random weights
drawn from a ``torch.Generator`` with the same init rules) and
``from_reference`` (the JAX package's parameter tree, given as numpy
arrays, turned into this package's tensors).  Both return the nested
dict of tensors the model functions take; ``ParamTree`` holds such a
dict as an ``nn.Module`` (device moves, ``state_dict``).  ``param_count``
and ``param_bytes`` size a declaration; ``cast_tree`` casts a tree.
``spec_to_pspec`` / ``make_pspecs`` map a declaration's logical axes to
mesh axes by the rules of ``runtime/sharding.py`` (the reference's
partition specs, tuple for tuple), and ``make_shardings`` to
``NamedSharding``s on a mesh.

The two packages draw different numbers from the same seed, so tests
that hold the port against the reference feed both the same weights
through ``from_reference``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.runtime.sharding import NamedSharding, PartitionSpec, resolve


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"  # normal | zeros | ones | fan_in
    scale: float = 0.02
    fan_in_dims: tuple[int, ...] = ()  # dims whose product is fan-in (for "fan_in")

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def leaves(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs of a nested dict in sorted-key order (the
    order ``jax.tree_util`` flattens a dict in), paths like ``a/b/c``."""
    out = []
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else key
        val = tree[key]
        if isinstance(val, dict):
            out.extend(leaves(val, path))
        else:
            out.append((path, val))
    return out


def map_tree(fn, tree, *rest):
    """``fn`` over the leaves of the nested dict ``tree``; the trees in
    ``rest`` are read at the same paths (a subtree of theirs where
    ``tree`` has a leaf is handed over whole)."""
    return {k: map_tree(fn, v, *(r[k] for r in rest)) if isinstance(v, dict) else fn(v, *(r[k] for r in rest))
            for k, v in tree.items()}


def init_params(specs, generator: torch.Generator, device="cuda", dtype=torch.float32):
    """Draw every leaf of ``specs`` from ``generator`` (which must live on
    ``device``): ``normal`` leaves ~ N(0, scale²), ``fan_in`` leaves ~
    N(0, 1/fan_in), ``zeros`` / ``ones`` constant."""

    def make(spec: ParamSpec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        if spec.init == "fan_in":
            fan = 1
            for d in spec.fan_in_dims or range(len(spec.shape) - 1):
                fan *= spec.shape[d]
            std = 1.0 / math.sqrt(max(fan, 1))
        else:
            std = spec.scale
        # scaled in place: a full-width expert leaf (qwen2-moe's wg is
        # 24 x 64 x 2048 x 1408 f32, 17.7 GB) must not be held twice
        v = torch.randn(spec.shape, generator=generator, dtype=torch.float32, device=device)
        return v.mul_(std).to(dtype)

    return map_tree(make, specs)


def from_reference(specs, tree_of_numpy, device="cuda", dtype=torch.float32):
    """Turn the JAX package's parameter tree (same keys and shapes, leaves
    as numpy arrays) into this package's tensors, checking every shape."""

    def walk(spec_node, ref_node, path):
        if isinstance(spec_node, ParamSpec):
            arr = np.asarray(ref_node)
            if tuple(arr.shape) != tuple(spec_node.shape):
                raise ValueError(f"{path}: reference shape {arr.shape} != {spec_node.shape}")
            return torch.as_tensor(np.array(arr, np.float32), device=device).to(dtype)
        if set(spec_node) != set(ref_node):
            raise ValueError(f"{path}: keys {sorted(ref_node)} != {sorted(spec_node)}")
        return {k: walk(spec_node[k], ref_node[k], f"{path}/{k}") for k in spec_node}

    return walk(specs, tree_of_numpy, "")


def spec_to_pspec(spec: ParamSpec, rules: dict[str, Any], axis_sizes: dict[str, int] | None = None) -> PartitionSpec:
    """Map logical axes -> mesh axes.  Guards: (a) never reuse a mesh axis
    within one spec; (b) with ``axis_sizes``, drop mesh axes that do not
    divide the dimension (smollm's 15 heads / 5 kv-heads stay replicated
    over model=16)."""
    return resolve(rules, spec.axes, spec.shape, axis_sizes)


def make_pspecs(specs, rules, axis_sizes=None):
    return map_tree(lambda s: spec_to_pspec(s, rules, axis_sizes), specs)


def make_shardings(specs, mesh, rules):
    axis_sizes = dict(mesh.shape)
    return map_tree(lambda s: NamedSharding(mesh, spec_to_pspec(s, rules, axis_sizes)), specs)


def param_count(specs) -> int:
    """Number of parameters ``specs`` declares."""
    return sum(math.prod(s.shape) for _, s in leaves(specs))


def param_bytes(specs, dtype=torch.float32) -> int:
    """Bytes of ``specs``' parameters stored in ``dtype``."""
    return param_count(specs) * torch.empty((), dtype=dtype).element_size()


def cast_tree(tree, dtype):
    """Every floating leaf of a nested dict of tensors cast to ``dtype``;
    other leaves (integer tables) as they are."""
    return map_tree(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


class ParamTree(nn.Module):
    """A nested dict of parameter tensors as an ``nn.Module``: its leaves
    are frozen ``nn.Parameter``s (serving never trains them), and
    ``tree()`` hands the nested dict back to the model functions."""

    def __init__(self, tree):
        super().__init__()
        self._paths = [path for path, _ in leaves(tree)]
        for path, t in leaves(tree):
            self.register_parameter(path.replace("/", "__"), nn.Parameter(t, requires_grad=False))

    def tree(self) -> dict:
        out: dict = {}
        for path in self._paths:
            *parents, last = path.split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = getattr(self, path.replace("/", "__"))
        return out
