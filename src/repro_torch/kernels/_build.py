"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/<name>.cu`` is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC -Xptxas=-v

into ``kernels/.build/`` (listed in ``.gitignore``), its nvcc output
beside it (``.log``), and loaded with
``ctypes``; no library beyond the CUDA runtime is linked.  The sources
have a plain C interface: pointers and the CUDA stream pass as
``c_void_p``, sizes as ``c_int`` or ``c_longlong``, and every entry point
returns ``cudaGetLastError()`` after its launches, which ``check`` turns
into an exception.  The library file name carries a hash of its source
and of every shared header (``csrc/*.cuh``), so an edited kernel or
header is rebuilt and a stale library is never loaded.

Nothing here runs at import time: the CPU tests import every module,
and a machine without ``nvcc`` only fails when a kernel is asked for.

``counted`` runs a wrapper's body under a cost counter: the kernel's
own cost (its ``cost`` hook: FLOPs by operand dtype, and bytes, each
input read once and each output written once) is recorded in place of
the aten ops the body issues, so the CUDA kernel, the CPU plain version
and the empty result a ``meta`` call returns all count the same work.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / ".build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

# ctypes signatures of each library's C entry points
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "retrieval_topk": {
        # q, corpus, part_s, part_i, out_s, out_i, nq, n, d, k, splits,
        # rows_per_split, is_bf16, stream
        "retrieval_topk_launch": [P, P, P, P, P, P, I, I, I, I, I, I, I, P],
    },
    "mixed_prefill": {
        # q, k_pool, v_pool, tables, desc, out, r, w (0: packed), n, h, kv,
        # dh, bs, n_t, window (0: none), is_bf16, stream
        "mixed_prefill_launch": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, P],
        # q, k_pool, v_pool, tables, desc, owned, o, m, l, r, w (0:
        # packed), n, h, kv, dh, bs, n_t, is_bf16, stream
        "mixed_prefill_partials_launch": [P] * 9 + [I] * 9 + [P],
    },
    "paged_decode": {
        # q, k_pool, v_pool, tables, lengths, out, o_part, m_part, l_part,
        # b, h, kv, dh, bs, n_t, n_split, window (0: none), is_bf16, stream
        "paged_decode_launch": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P],
    },
    "flash_attention": {
        # q, k, v, out, b, sq, sk, h, kv, dh, scale_dh, q strides (batch,
        # seq, head), k strides, v strides, causal, is_bf16, stream
        "flash_attention_launch": [P, P, P, P, I, I, I, I, I, I, I, L, L, L, L, L, L, L, L, L, I, I, P],
    },
    "flash_decode": {
        # q, k_cache, v_cache, lengths, out, o, m, l, o_part, m_part,
        # l_part, b, h, kv, dh, s, n_split, k strides (batch, seq, head),
        # v strides, partials, empty_zero, is_bf16, stream
        "flash_decode_launch": [P] * 11 + [I] * 6 + [L] * 6 + [I, I, I, P],
    },
    "ssd_chunk": {
        # x, b, c, dt, a, scores scratch, y, state, decay, b, l, h, hd,
        # ds, groups, x strides (batch, seq, head), b strides, c strides,
        # dt strides, is_bf16, stream
        "ssd_chunk_launch": [P] * 9 + [I] * 6 + [L] * 12 + [I, P],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's output of each library built or found by this process: ptxas's
# registers, shared memory and spills per kernel (``-Xptxas=-v``)
logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels can only be built where the CUDA toolkit is")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str):
    """Start one nvcc for ``name`` unless its library exists; returns
    ``(process or None, tmp path, final path)``."""
    out = _lib_path(name)
    if out.exists():
        log = out.with_suffix(".log")
        if log.exists():
            logs[name] = log.read_text()
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    logs[name] = log
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a reader never sees a half-written library


def build_all(names=None) -> None:
    """Compile every kernel source at once, one nvcc process each."""
    names = list(names or SIGNATURES)
    with _lock:
        started = [(n, *_start(n)) for n in names]
        for n, proc, tmp, out in started:
            _finish(n, proc, tmp, out)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {err}")


def aligned16(t) -> bool:
    """Whether the kernels' 16-byte copies can read tensor ``t`` in place:
    its last axis contiguous, and the pointer and every stride that is
    ever stepped (of a dimension longer than 1) a multiple of 16 bytes."""
    es = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st * es % 16 == 0 for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1))


def flops(*pairs) -> dict[str, float]:
    """``(count, dtype)`` pairs summed by dtype name (``"bfloat16"``,
    ``"float32"``): a cost hook's FLOPs, each part at its operands' type."""
    out: dict[str, float] = {}
    for n, dtype in pairs:
        name = str(dtype).removeprefix("torch.")
        out[name] = out.get(name, 0) + n
    return out


def fresh(out):
    """A plain version's output (a tensor or a tuple of them) laid out as
    the kernel writes it, contiguous: the ops after a kernel call then see
    the same strides on the CPU, on the card and on ``meta``."""
    if isinstance(out, tuple):
        return tuple(t.contiguous() for t in out)
    return out.contiguous()


def counted(name: str, cost, run):
    """``run()``; under an active cost counter (``runtime.compat.counter``)
    the kernel ``name`` is recorded at ``cost()`` (``(flops by dtype,
    bytes)``) and the aten ops ``run`` issues are not counted."""
    from repro_torch.runtime.compat import counter

    c = counter()
    if c is None:
        return run()
    return c.record_kernel(name, *cost(), run)


def needs_grad(*tensors) -> bool:
    """Whether autograd is recording and one of ``tensors`` requires grad
    (non-tensor arguments are skipped)."""
    import torch

    return torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_grad(what: str, *tensors) -> None:
    """Raise when autograd would need a gradient through ``what``, a
    serving kernel with no backward: its output, written by the kernel,
    would carry no graph, and the inputs' gradients would be dropped
    silently."""
    if needs_grad(*tensors):
        raise RuntimeError(f"{what}: an input requires grad, and this kernel has no backward (serving only)")
