"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/<name>.cu`` is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

into ``kernels/.build/`` (listed in ``.gitignore``) and loaded with
``ctypes``.  The sources have a plain C interface: pointers and the CUDA
stream pass as ``c_void_p``, sizes as ``c_int``, and every entry point
returns ``cudaGetLastError()`` after its launches, which ``check`` turns
into an exception.  The library file name carries a hash of its source,
so an edited kernel is rebuilt and a stale one is never loaded.

Nothing here runs at import time: the CPU tests import every module,
and a machine without ``nvcc`` only fails when a kernel is asked for.
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
    "-shared", "-Xcompiler", "-fPIC",
]

# ctypes signatures of each library's C entry points
P, I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "retrieval_topk": {
        # q, corpus, part_s, part_i, out_s, out_i, nq, n, d, k, splits,
        # rows_per_split, is_bf16, stream
        "retrieval_topk_launch": [P, P, P, P, P, P, I, I, I, I, I, I, I, P],
    },
    "mixed_prefill": {
        # q, k_pool, v_pool, tables, desc, out, r, w, h, kv, dh, bs, n_t,
        # is_bf16, stream
        "mixed_prefill_launch": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, P],
    },
    "paged_decode": {
        # q, k_pool, v_pool, tables, lengths, out, b, h, kv, dh, bs, n_t,
        # is_bf16, stream
        "paged_decode_launch": [P, P, P, P, P, P, I, I, I, I, I, I, I, P],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels can only be built where the CUDA toolkit is")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + (CSRC / "common.cuh").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str):
    """Start one nvcc for ``name`` unless its library exists; returns
    ``(process or None, tmp path, final path)``."""
    out = _lib_path(name)
    if out.exists():
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
