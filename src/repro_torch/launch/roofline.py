"""Roofline terms of one step on one NVIDIA H100 SXM, counted from the
aten ops the port's own step issues.

compute  = FLOPs       / (chips * 989 TFLOP/s, bf16 dense)
memory   = bytes       / (chips * 3.35 TB/s HBM3)
collect. = coll_bytes  / (chips * 450 GB/s NVLink 4, one direction)

The reference compiled each step for a fake TPU mesh and read XLA's
``cost_analysis()`` and the HLO text.  The port has neither: a
``CostCounter`` is a ``TorchDispatchMode`` under which the step runs (on
``meta`` tensors for a dry run, nothing computed or allocated; on the card
to hold the count against a measured step), and which counts per aten op:

* ``flops``: ``torch.utils.flop_counter``'s formulas (the matmul family);
  elementwise ops count none;
* ``bytes``: the operand and result bytes of every op, unfused (XLA's
  "bytes accessed" before fusion).  A view moves nothing and is not
  counted; a result that aliases an operand (an in-place op) is not
  counted again; a broadcast (stride-0) dimension counts once; reads of a
  value to the host and copies between devices are not device traffic;
* ``convert_bytes``: ``_to_copy`` calls that change dtype, input plus
  output (the f32 -> bf16 weight casts at every matmul);
* ``dus_bytes``: whole-buffer out-of-place copies of a cache leaf (a
  copy or scatter op reading the whole of a leaf ``mark_cache`` names and
  writing as many bytes), the copy-on-write cost the reference read from
  ``dynamic-update-slice``;
* ``collectives``: bytes by the reference's kinds and ``collective_count``,
  which ``runtime.compat.gather`` / ``split`` record for the port's
  reductions (on one card they are copies inside HBM; the term prices them
  at the link's rate, as the reference priced ICI);
* ``peak_bytes``: the high-water mark of live bytes, counted per storage
  (so views are not counted twice), from the arguments ``track`` names
  on, each storage released by a finalizer when it dies (so tensors saved
  for autograd stay counted until they are freed).

A hand-written kernel's wrapper records its own cost hook instead of the
ops it issues (``kernels/_build.counted``): the CUDA kernel, the CPU plain
version and the empty result of a ``meta`` call count the same work.
Every FLOP is priced at the bf16 peak, so f32 work gives a lower bound,
never a higher one.  ``ssd_correction`` and ``model_flops_for`` are the
reference's arithmetic on the config.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.runtime.sharding import ShardedTensor

COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# ---------------- hardware model (one H100 SXM, NVIDIA's data sheet) ----------------
PEAK_FLOPS = 989e12  # bf16 dense tensor-core FLOP/s (without sparsity), at the 700 W limit
HBM_BW = 3.35e12  # HBM3, B/s
LINK_BW = 450e9  # NVLink 4: 900 GB/s per GPU both directions together, B/s one way

_HOST_READS = {torch.ops.aten._local_scalar_dense.default}
# ops that copy a tensor out of place, whole or with a part replaced: on a
# whole cache leaf, the copy-on-write that donation (or writing in place) saves
_COPIES = {torch.ops.aten.clone, torch.ops.aten.copy, torch.ops.aten._to_copy, torch.ops.aten.index_put,
           torch.ops.aten.index_copy, torch.ops.aten.index_add, torch.ops.aten.scatter,
           torch.ops.aten.slice_scatter, torch.ops.aten.select_scatter}
_NO_WRITE = {torch.ops.aten.empty, torch.ops.aten.empty_strided, torch.ops.aten.empty_like,
             torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided}


def tensors(tree) -> list[torch.Tensor]:
    """The tensors of nested lists, tuples and dicts (an op's arguments, a
    step's), a placement (``runtime.sharding.ShardedTensor``) by its blocks."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in tensors(x)]
    if isinstance(tree, ShardedTensor):
        return list(tree.blocks)
    return []


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` addresses (a stride-0 dimension
    counted once)."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n


class CostCounter(TorchDispatchMode):
    """Counts the FLOPs, bytes, dtype conversions, cache copies, collectives
    and live bytes of the ops run under it (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.convert_bytes = 0.0
        self.dus_bytes = 0.0
        self.collectives = dict.fromkeys(COLLECTIVES, 0)
        self.collectives["collective_count"] = 0
        self.kernels: dict[str, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}
        self._cache: set[int] = set()
        self._in_kernel = 0

    # -- what the caller tells it --------------------------------------- #
    def track(self, *trees) -> int:
        """Count the storages of every tensor in ``trees`` (nested dicts,
        lists and tuples) as live, once each; returns their bytes."""
        return sum(self._hold(t) for t in tensors(trees))

    def mark_cache(self, tree) -> None:
        """Name the cache leaves whose whole-buffer copies are ``dus_bytes``."""
        self.track(tree)
        self._cache |= {_key(t) for t in tensors(tree)}

    # -- what the port's code records ----------------------------------- #
    def record_kernel(self, name: str, flops: dict, nbytes: float, run):
        """One call of kernel ``name`` at its hook's cost; ``run()``'s own
        ops are not counted, its outputs are held as live."""
        self.flops += sum(flops.values())
        self.bytes += nbytes
        self.kernels[name] = self.kernels.get(name, 0) + 1
        self._in_kernel += 1
        try:
            out = run()
        finally:
            self._in_kernel -= 1
        self.track(out)
        return out

    def record_collective(self, kind: str, tensors) -> None:
        if kind not in COLLECTIVES:
            raise ValueError(f"unknown collective {kind!r}; one of {COLLECTIVES}")
        self.collectives[kind] += sum(tensor_bytes(t) for t in tensors)
        self.collectives["collective_count"] += 1

    # -- the ops ---------------------------------------------------------- #
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._in_kernel and func not in _HOST_READS:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ins = tensors((args, kwargs))
        outs = tensors(out)
        in_keys = {_key(t) for t in ins}
        new = [t for t in outs if _key(t) not in in_keys]
        if not new and not func._schema.is_mutable:
            return  # a view or a metadata op: nothing moves
        if ins and any(t.device != ins[0].device for t in outs):
            return  # a copy between devices (to the host): not device memory traffic
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        read = sum(tensor_bytes(t) for t in ins)
        written = 0 if packet in _NO_WRITE else sum(tensor_bytes(t) for t in new)
        self.bytes += read + written
        if packet is torch.ops.aten._to_copy and ins and any(t.dtype != ins[0].dtype for t in new):
            self.convert_bytes += read + written
        if self._cache and packet in _COPIES:
            whole = {tensor_bytes(t) for t in ins
                     if _key(t) in self._cache and tensor_bytes(t) == t.untyped_storage().nbytes()}
            self.dus_bytes += sum(tensor_bytes(t) for t in new if tensor_bytes(t) in whole)
        for t in new:
            self._hold(t)

    # -- live bytes ------------------------------------------------------ #
    def _hold(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return 0
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._release, key)
        return n

    def _release(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    hlo_flops: float  # global
    hlo_bytes: float  # global
    collective_bytes: float  # global
    collective_detail: dict
    model_flops: float
    memory_per_device: int  # high-water mark of live bytes

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / (self.n_chips * PEAK_FLOPS)

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / (self.n_chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / (self.n_chips * LINK_BW)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_frac(self) -> float:
        return self.model_flops / max(self.hlo_flops, 1.0)

    @property
    def mfu_bound(self) -> float:
        """Roofline fraction: model-useful FLOP/s at the step bound vs peak."""
        return self.model_flops / (self.n_chips * PEAK_FLOPS * max(self.step_bound_s, 1e-12))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(
            compute_s=self.compute_s,
            memory_s=self.memory_s,
            collective_s=self.collective_s,
            dominant=self.dominant,
            step_bound_s=self.step_bound_s,
            useful_flops_frac=self.useful_flops_frac,
            mfu_bound=self.mfu_bound,
        )
        return d


def ssd_correction(cfg, shape) -> dict:
    """Analytic cost of the (nc-1) SSD chunks the reference's measurement
    compiles do not count (the intra-chunk scan stays rolled; XLA counts its
    body once).  The port's counter sees every chunk's kernel call, so the
    dry run does not add it.

    Per chunk per (batch, head), f32:
      flops_fwd ~ 2L^2(ds+hd) [CB^T + scores@X] + 6L^2 [decay/mask/scale]
                  + 6L*hd*ds  [state update + inter-chunk output]
      bytes_fwd ~ 28 L^2      [cb/decay/scores materialized, ~7 f32 passes]
    Train multiplies by ~3 (remat fwd + bwd)."""
    if cfg.ssm_state == 0 or shape.kind == "decode":
        return {"flops": 0.0, "bytes": 0.0}
    n_mamba = sum(1 for i in range(cfg.n_layers) if cfg.mixer_kind(i) == "mamba")
    if n_mamba == 0:
        return {"flops": 0.0, "bytes": 0.0}
    l = min(cfg.ssd_chunk, shape.seq_len)
    nc = (shape.seq_len + l - 1) // l
    b, h = shape.global_batch, cfg.ssm_heads
    ds, hd = cfg.ssm_state, cfg.ssm_head_dim
    mult = 3.0 if shape.kind == "train" else 1.0
    per_chunk_flops = 2 * l * l * (ds + hd) + 6 * l * l + 6 * l * hd * ds
    per_chunk_bytes = 28.0 * l * l
    scale = b * h * n_mamba * (nc - 1) * mult
    return {"flops": per_chunk_flops * scale, "bytes": per_chunk_bytes * scale}


def model_flops_for(cfg, shape) -> float:
    """6·N_active·D (train) / 2·N_active·D (inference) + attention term."""
    n_active = cfg.param_count(active=True)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens, mult = b * s, 6
    elif shape.kind == "prefill":
        tokens, mult = b * s, 2
    else:  # decode: one token per sequence
        tokens, mult = b * 1, 2
    flops = mult * n_active * tokens
    # attention score/value FLOPs (not in 6ND):
    hd = cfg.resolved_head_dim
    n_attn = sum(1 for i in range(cfg.n_layers) if cfg.mixer_kind(i) == "attn")
    if shape.kind == "train":
        # fwd attn = 2 matmuls x 2*B*(S^2/2)*H*hd; train ~ 3x fwd
        flops += 3 * (2 * 2 * b * (s * s // 2) * cfg.n_heads * hd) * n_attn
    elif shape.kind == "prefill":
        flops += 2 * b * (s * s // 2) * cfg.n_heads * hd * 2 * n_attn
    else:
        flops += 2 * b * s * cfg.n_heads * hd * 2 * n_attn
    # SSD state-math term (the attention-equivalent for mamba mixers)
    n_mamba = sum(1 for i in range(cfg.n_layers) if cfg.mixer_kind(i) == "mamba")
    if n_mamba and cfg.ssm_state:
        h2, ds, hd2 = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
        if shape.kind == "decode":
            flops += 2 * b * h2 * hd2 * ds * 2 * n_mamba
        else:
            l = min(cfg.ssd_chunk, s)
            nc = (s + l - 1) // l
            per = 2 * l * l * (ds + hd2) + 6 * l * hd2 * ds
            mult = 3 if shape.kind == "train" else 1
            flops += per * b * h2 * nc * n_mamba * mult
    return float(flops)
