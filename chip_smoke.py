#!/usr/bin/env python3
"""Chip smoke for the PyTorch port: the quickest proof that it still
starts on the GPU.

    python3 chip_smoke.py        # from the repository root, on a machine with one CUDA card
    python3 chip_smoke.py --parent-csrc DIR   # also time an earlier commit's six kernels

Phases (any failure exits non-zero, and the final ok line is printed
only when every phase passed):

1. device     the card's name and power limit, as nvidia-smi reports them;
2. build      the six CUDA kernels, one nvcc each, all started together,
              and ptxas's registers and spills of each;
3. kernels    each kernel against its plain PyTorch version on the card at
              the full-width path shapes, f32 and bf16 (tolerance 2e-5 f32:
              both sum in f32 but in another order; 2e-2 bf16), the ±1e4
              trash-poison checks, retrieval at provider scale (N =
              1,048,576 x D = 256 f32, Q = 32, k = 8) with bitwise
              batch-of-1 == batch-of-32 scores, retrieval at the served
              shape (Q = 16, N = 147, D = 256 and 768, timed) and past the
              old caps (k = 100 at D = 770, k = 8 at D = 1100), mixed prefill at
              the prefix cache's warm-admission shape (suffixes of 1-31 lanes
              from q_start = 32 * (L // 32), table entries aliased across
              rows, kv_len to 288), flash attention at the
              rerank, chunk-index and admit-prefill shapes and a ragged
              causal one, contiguous flash-decode at the phase-6 decode
              shape with its partials combined over 4 sequence shards
              against the monolithic answer, and the SSD chunk at the
              phase-7 admit shape (its outputs reach the hundreds, so its
              error is taken relative to the largest output); times of
              kernel, plain version, one PyTorch library call (never called
              by the port) where one computes the function, and the bound:
              the median of 20 calls taken in turns (a, b, b, a, ...), each
              after an L2 flush and a 1 ms device spin, so that the host's
              enqueue does not fall between the timing events.  With
              ``--parent-csrc DIR`` (an earlier commit's six kernel sources,
              their headers and its kernels/_build.py, whose nvcc flags and
              ctypes signatures are used) those six are built too, checked
              against the plain versions and timed in the same turns, and
              paged_decode (f32 and bf16), bf16 flash_attention,
              retrieval_topk (scores and ids, f32 and bf16) and ssd_chunk
              (f32 and bf16) must give outputs bitwise equal to the
              parent's build.  Then, at qwen2-moe-a2.7b's heads (H = KV =
              16, one query head per KV head), mixed prefill at the step's
              mix above, paged decode, the causal admit prefill and
              flash-decode, checked and timed the same way; and verify rows
              (q_len 4 from the committed position) bitwise equal, lane by
              lane, to q_len = 1 rows at the same positions (f32 and bf16,
              G = 2 and G = 1);
4. paged      ``CFedRAGSystem.serve`` on 16 queries at the full width of
              qwen3-0.6b (28 layers, bf16, random weights from a seed) on
              the paged engine with the bag embedder; then retrieval
              against the CPU run of the same system and a smoke-width
              model against its CPU run;
5. paper      the same serve with the paper's models at full width:
              contriever-110m embeds every provider's chunks (the index)
              and queries, bge-reranker-base reranks; then the contexts of
              an f32 build against its CPU run, near-ties aside;
6. contiguous the phase-4 system on the contiguous engine (the
              reference's default), its decode through flash-decode; then,
              at smoke width and f32 on the card, contiguous == paged ==
              lock-step tokens, and the card's contiguous tokens == the CPU
              run's;
7. mamba2     the phase-4 federation serving mamba2-1.3b at full width (48
              layers, bf16, random weights from a seed) on the contiguous
              engine, its prefills through the SSD chunk kernel; the
              full-width logits of one prompt finite; then, at smoke width
              (chunk 16, so the prefill carries state over many chunks) and
              f32 on the card, contiguous == lock-step tokens, and the
              card's tokens == the CPU run's;
8. prefix     the phase-4 configuration with the prefix cache, served twice
              on one resident engine: repeat 1's tokens == phase 4's (cache
              on == cache off), repeat 2's == repeat 1's with >= 15/16 prompts
              hitting; then with a pool of max_batch rows' blocks plus 8 and a
              512 MiB host spill tier, where repeat 1's parked chains are
              demoted and repeat 2 readmits them by upload: demotions and
              readmits > 0 and repeat 2's tokens == phase 4's; prefill tokens,
              tokens saved, dispatches, mixed_prefill launches, p50,
              cache_nbytes, spill bytes and peak memory printed;
9. stream     the phase-4 system through ``serve``, then through the
              pipelined ``serve_stream`` (micro-batches of 4, tenants
              interactive=4:1 and batch=1): every query yields once, its
              context and tokens == phase 4's; both p50/p95 and the
              per-tenant gauges printed;
10. table1    ``launch/table1.run()`` on the card: every row's recall@8 and
              MRR == the CPU run's, and the two claim checks hold; the
              paper's models (contriever-110m, bge-reranker-base) federated
              and centralized, recall printed, f32 contexts on the card ==
              the CPU run's near-ties aside; one ``answer_batch`` routed by
              ``ProviderSelector(top_p=1)``: the picks and contexts == the
              CPU run's, every context from its selected provider alone;
11. spec      speculative decoding on the paged engine: (a) the phase-4
              configuration with draft_k = 3, the model drafting for
              itself: every status done, contexts == phase 4's, tokens ==
              phase 4's but at rounding ties, rounds > 0, drafts accepted,
              no decode dispatch, drafter dispatches <= rounds; the first
              verify dispatch's descriptors and tables recorded, and
              mixed prefill checked and timed at them; (b) qwen3-4b at full
              width (36 layers) served plain, then over the same parameter
              tensors with draft_k = 3 and a qwen3-0.6b drafter of another
              seed: tokens equal but at rounding ties, the accept rate
              printed; (c) smoke width, f32: spec == plain, token for token,
              with and without the prefix cache;
12. moe       the phase-4 federation serving qwen2-moe-a2.7b at full width
              (24 layers, d_model 2048, 16/16 heads of 128, 60 experts
              allocated as 64, top-4, d_ff 1408, 4 shared experts, 60.6 GB
              of f32 weights) on the paged engine, after the earlier phases'
              models are freed, then on the contiguous engine over the same
              parameter tensors: statuses done, contexts == phase 4's, a
              prompt's mixed-step logits finite, tokens equal across the
              engines but at rounding ties, one MoE layer at 2048 tokens in
              bf16 within 2e-2 of the dense oracle; at smoke width in f32,
              paged == contiguous == the CPU run; resident and peak memory
              printed.

Each phase prints its seconds.  Every kernel's launch counter is set to 0 just before each main-path run
(the serves, phase 5's index build, phase 10's retrievals) and read just
after; a kernel of that path left at 0 fails the run.

The line before the last lines is ``{"kernels": [...]}``, then the card's
nvidia-smi line, then ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
MEM_BW = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK = {"float32": 67e12, "bfloat16": 989e12}  # FLOP/s: f32 off the tensor cores, bf16 dense
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median device time of one call, by CUDA events around each call,
    with the 50 MB L2 flushed before every call (each serving step finds
    its layer's pool cold in L2: 28 layers of K/V do not fit).  After the
    flush the device spins (``torch.cuda._sleep``, 1 ms) before the start
    event, so the host has queued the whole call before the device reaches
    it and the host's enqueue time does not fall between the events; the
    calls whose enqueue took longer than the spin are counted per function.
    A 0.1 ms spin was not enough: with the host loaded, short calls read
    2-3x high in one run and not in the next.  ``turns`` times several
    functions in turns (a, b, b, a, ...)."""

    SPIN_MS = 1.0  # the spin before each call

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")  # 128 MiB
        # _sleep counts the SM's clock64 cycles: size the spin on this card
        self.cycles = 1_000_000
        self.spin_ms()  # warm-up: the first launch of the spin kernel loads it
        self.cycles = max(1, int(self.cycles * self.SPIN_MS / self.spin_ms()))
        self.spin = self.spin_ms()

    def spin_ms(self) -> float:
        """What one spin takes on this card."""
        torch = self.torch
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        torch.cuda._sleep(self.cycles)
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e)

    def turns(self, fns: dict, iters: int = 20) -> dict:
        """{name: median ms} over ``iters`` calls of each of ``fns`` (name ->
        callable or None), called in turns, the order reversed every round,
        and under "late" {name: calls whose enqueue outlasted the spin}."""
        torch = self.torch
        live = [n for n, f in fns.items() if f is not None]
        for n in live:
            for _ in range(3):
                fns[n]()
        torch.cuda.synchronize()
        times, late = {n: [] for n in live}, {}
        for i in range(iters):
            ev = []
            for n in live if i % 2 == 0 else live[::-1]:
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                self.flush.zero_()
                torch.cuda._sleep(self.cycles)
                s.record()
                t0 = time.perf_counter()
                fns[n]()
                if (time.perf_counter() - t0) * 1e3 >= self.spin:
                    late[n] = late.get(n, 0) + 1
                e.record()
                ev.append((n, s, e))
            torch.cuda.synchronize()
            for n, s, e in ev:
                times[n].append(s.elapsed_time(e))
        return {**{n: (statistics.median(times[n]) if n in times else None) for n in fns}, "late": late}


def demangle(name: str) -> str:
    """``name`` through c++filt where there is one, without its namespace
    and parameter list."""
    try:
        name = subprocess.run(["c++filt"], input=name, capture_output=True, text=True, timeout=30).stdout.strip() or name
    except (OSError, subprocess.SubprocessError):
        return name
    return name.replace("(anonymous namespace)::", "").split("(")[0]


def ptxas_entries(log: str) -> list[tuple]:
    """(kernel, registers, static smem bytes, spill stores, spill loads) of
    every kernel in nvcc's ``-Xptxas=-v`` output."""
    out, fn, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append((demangle(fn), int(m.group(1)), int(smem.group(1)) if smem else 0, *spill))
    return out


ATTENTION = ("flash_attention", "paged_decode", "mixed_prefill", "flash_decode")
KERNELS = (*ATTENTION, "retrieval_topk", "ssd_chunk")


def on_path(name: str, fn: str) -> bool:
    """Whether a kernel instantiation is one the path runs: head_dim 128
    for attention, hd 64 / ds 128 for the SSD chunk, every top-k one."""
    if name == "ssd_chunk":
        return ("ssd_scores" in fn and fn.endswith(", 128>")) or re.search(r"ssd_chunk<\w+, 64, 128\b", fn) is not None
    return name == "retrieval_topk" or "128" in fn


def print_ptxas(logs: dict, tag: str = "") -> None:
    """Registers and spills of the kernels at the path's shapes, and
    whether any instantiation of each library spills."""
    for name in KERNELS:
        if name not in logs:
            continue
        entries = ptxas_entries(logs[name])
        for fn, regs, smem, st, ld in entries:
            if on_path(name, fn):
                print(f"  ptxas{tag} {fn}: {regs} registers, {smem} bytes static smem, "
                      f"spill {st} / {ld} bytes stored / loaded", flush=True)
        spilled = [e[0] for e in entries if e[3] or e[4]]
        print(f"  ptxas{tag} {name}: {len(entries)} kernels, "
              f"{'spills in ' + ', '.join(spilled) if spilled else 'no spill'}", flush=True)


class Parent:
    """The six kernels of an earlier commit (``--parent-csrc DIR``: a
    directory holding that commit's ``csrc/*.cu``, the headers they include
    and its ``kernels/_build.py``), built with that ``_build.py``'s nvcc
    flags, bound with its ctypes signatures, called with its own argument
    conventions and timed in turns with the current kernels on the same
    inputs."""

    NAMES = KERNELS

    def __init__(self, torch, csrc: Path):
        import ctypes
        import importlib.util

        from repro_torch.kernels import _build

        self.torch = torch
        spec = importlib.util.spec_from_file_location("parent_build", csrc / "_build.py")
        pb = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(pb)  # the standard library only: nothing is built or loaded here
        out = _build.BUILD_DIR / "parent"
        out.mkdir(parents=True, exist_ok=True)
        procs = {
            # -fno-gnu-unique: a function-local static of a header template
            # (the shared-memory size a kernel was allowed) would otherwise be
            # one object for both builds, and the parent's launch would skip
            # raising its own kernel's limit
            n: subprocess.Popen([_build._nvcc(), *pb.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique", "-o",
                                 str(out / f"lib{n}.so"), str(csrc / f"{n}.cu")],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for n in self.NAMES
        }
        self.logs, self.fns = {}, {}
        for n, proc in procs.items():
            self.logs[n], _ = proc.communicate()
            if proc.returncode != 0:
                fail(f"the parent's {n}.cu does not build:\n{self.logs[n]}")
            fn = getattr(ctypes.CDLL(str(out / f"lib{n}.so")), f"{n}_launch")
            fn.argtypes, fn.restype = pb.SIGNATURES[n][f"{n}_launch"], ctypes.c_int
            self.fns[n] = fn

    def _call(self, name: str, *args) -> None:
        import ctypes

        fn = self.fns[name]
        if len(args) + 1 != len(fn.argtypes):
            fail(f"the parent's {name}_launch takes {len(fn.argtypes)} arguments, a convention this script "
                 f"does not know")
        err = fn(*args, ctypes.c_void_p(self.torch.cuda.current_stream().cuda_stream))
        if err:
            fail(f"the parent's {name} failed with cudaError_t {err}")

    def _split_scratch(self, b, kv, g, dh, cap) -> list:
        """The o, m, l f32 partials of ceil(cap / 64) position splits."""
        n_split = -(-cap // 64)
        return [self.torch.empty(sh, dtype=self.torch.float32, device="cuda")
                for sh in ((b, kv, n_split, g, dh), (b, kv, n_split, g), (b, kv, n_split, g))]

    def flash_attention(self, q, k, v, causal: bool):
        b, sq, h, dh = q.shape
        out = self.torch.empty_like(q)
        self._call("flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, k.shape[1], h,
                   k.shape[2], dh, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
                   int(q.dtype == self.torch.bfloat16))
        return out

    def mixed_prefill(self, q, kp, vp, tables, desc):
        r, w, h, dh = q.shape
        out = self.torch.empty_like(q)
        self._call("mixed_prefill", q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(), desc.data_ptr(),
                   out.data_ptr(), r, w, h, kp.shape[2], dh, kp.shape[1], tables.shape[1],
                   int(q.dtype == self.torch.bfloat16))
        return out

    def paged_decode(self, q, kp, vp, tables, lengths):
        """The split kernel's entry point, with its o / m / l scratch."""
        b, h, dh = q.shape
        bs, kv, n_t = kp.shape[1], kp.shape[2], tables.shape[1]
        out = self.torch.empty_like(q)
        scratch = self._split_scratch(b, kv, h // kv, dh, n_t * bs)
        self._call("paged_decode", q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
                   out.data_ptr(), *(t.data_ptr() for t in scratch), b, h, kv, dh, bs, n_t, scratch[1].shape[2],
                   int(q.dtype == self.torch.bfloat16))
        return out

    def retrieval_topk(self, q, c, k):
        """The wrapper's splits (multiples of 256 rows, which every earlier
        build of the kernel takes) and scratch."""
        from repro_torch.kernels.retrieval_topk import ops as rt

        torch = self.torch
        nq, d = q.shape
        n = c.shape[0]
        splits, rows = rt._plan(nq, n, q.device)
        f32 = dict(dtype=torch.float32, device=q.device)
        i32 = dict(dtype=torch.int32, device=q.device)
        ps, pi = torch.empty((nq, splits, k), **f32), torch.empty((nq, splits, k), **i32)
        out_s, out_i = torch.empty((nq, k), **f32), torch.empty((nq, k), **i32)
        self._call("retrieval_topk", q.data_ptr(), c.data_ptr(), ps.data_ptr(), pi.data_ptr(), out_s.data_ptr(),
                   out_i.data_ptr(), nq, n, d, k, splits, rows, int(q.dtype == torch.bfloat16))
        return out_s, out_i

    def ssd_chunk(self, x, b, c, dt, a):
        """The entry point of the kernel that computed C.B^T in every head's
        block (27 arguments), or the one with the wrapper's C.B^T scratch and
        group count (29)."""
        from repro_torch.kernels.ssd_scan import ops as ss

        torch = self.torch
        bsz, l, h, hd = x.shape
        ds = b.shape[3]
        f32 = dict(dtype=torch.float32, device=x.device)
        y, st, dec = torch.empty((bsz, l, h, hd), **f32), torch.empty((bsz, h, hd, ds), **f32), torch.empty((bsz, h), **f32)
        strides = (*x.stride()[:3], *b.stride()[:3], *c.stride()[:3], *dt.stride(), int(x.dtype == torch.bfloat16))
        ins = (x.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(), a.data_ptr())
        outs = (y.data_ptr(), st.data_ptr(), dec.data_ptr())
        if len(self.fns["ssd_chunk"].argtypes) == 27:
            self._call("ssd_chunk", *ins, *outs, bsz, l, h, hd, ds, *strides)
        else:
            groups, cbt = ss._scores_scratch(b, c, bsz, l, h)
            self._call("ssd_chunk", *ins, cbt.data_ptr(), *outs, bsz, l, h, hd, ds, groups, *strides)
        return y, st, dec

    def flash_decode(self, q, kc, vc, lengths):
        """The normalised output, through the entry point of the kernel with
        one block per (row, KV head) (22 arguments) or of the split kernel
        (its o / m / l scratch besides)."""
        b, h, dh = q.shape
        s, kv = kc.shape[1], kc.shape[2]
        out = self.torch.empty_like(q)
        head = (q.data_ptr(), kc.data_ptr(), vc.data_ptr(), lengths.data_ptr(), out.data_ptr(), 0, 0, 0)
        tail = (*kc.stride()[:3], *vc.stride()[:3], 0, int(q.dtype == self.torch.bfloat16))
        if len(self.fns["flash_decode"].argtypes) == 22:
            self._call("flash_decode", *head, b, h, kv, dh, s, *tail)
        else:
            scratch = self._split_scratch(b, kv, h // kv, dh, s)
            self._call("flash_decode", *head, *(t.data_ptr() for t in scratch), b, h, kv, dh, s, scratch[1].shape[2],
                       *tail)
        return out


def bound(nbytes: float, *ops: tuple[float, str]) -> tuple[float, str]:
    """The larger of the bytes' time and the operations' time, in ms; ``ops``
    are (FLOPs, operand dtype) pairs, each part at its type's peak."""
    t_b, t_o = nbytes / MEM_BW * 1e3, sum(f / PEAK[dt] for f, dt in ops) * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def check(name: str, err: float, dtype: str) -> None:
    ok = err <= TOL[dtype]
    print(f"  {name}: max_abs_err={err:.3e} (tol {TOL[dtype]:g}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")


# --------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------- #


def counters():
    """The launch counter of every kernel, by name: (module, attribute)."""
    from repro_torch.kernels.chunked_prefill import ops as cp
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.retrieval_topk import ops as rt
    from repro_torch.kernels.ssd_scan import ops as ss

    return {
        "retrieval_topk": (rt, "launches"), "mixed_prefill": (cp, "launches"), "paged_decode": (da, "launches"),
        "flash_attention": (fa, "launches"), "flash_decode": (da, "flash_decode_launches"),
        "ssd_chunk": (ss, "launches"),
    }


def reset_launches() -> None:
    for mod, attr in counters().values():
        setattr(mod, attr, 0)


def read_launches(what: str, need) -> dict:
    got = {name: getattr(mod, attr) for name, (mod, attr) in counters().items()}
    print(f"  launches during {what}: {got}", flush=True)
    if any(got[n] == 0 for n in need):
        fail(f"a kernel of the path was never launched during {what}: {got}")
    return got


def mixed_prefill_row(torch, timer, gen, desc_h: list, tables, n_pool: int, h: int, kv: int, dtype: str,
                      label: str) -> dict:
    """``mixed_prefill`` at the descriptors ``desc_h`` ((slot, q_start,
    q_len, kv_len) by row) over a random pool of ``n_pool`` blocks of 32
    positions and ``tables``, R = 8 rows of W = 256 lanes, ``h`` query and
    ``kv`` KV heads of 128: checked against its plain version (dead lanes
    exactly 0), then timed beside the plain version and SDPA over the
    gathered views, with its bound from what these descriptors need."""
    import torch.nn.functional as F

    from repro_torch.kernels.chunked_prefill import ops as cp

    dev = torch.device("cuda")
    r, w, dh, bs = len(desc_h), 256, 128, 32
    tdt = getattr(torch, dtype)
    es = torch.empty((), dtype=tdt).element_size()
    desc = torch.tensor(desc_h, dtype=torch.int32, device=dev)
    q = torch.randn(r, w, h, dh, generator=gen, device=dev).to(tdt)
    kp = torch.randn(n_pool, bs, kv, dh, generator=gen, device=dev).to(tdt)
    vp = torch.randn(n_pool, bs, kv, dh, generator=gen, device=dev).to(tdt)
    o = cp.mixed_prefill_attention(q, kp, vp, tables, desc)
    err = (o.float() - cp.mixed_prefill_attention_plain(q, kp, vp, tables, desc).float()).abs().max().item()
    check(f"mixed_prefill {label} H={h} KV={kv} {dtype}", err, dtype)
    lane = torch.arange(w, device=dev)
    if not bool((o[lane[None, :] >= desc[:, 2:3]] == 0).all()):
        fail(f"mixed_prefill {label}: dead lanes are not exactly 0")
    s_pad = tables.shape[1] * bs
    kpos = torch.arange(s_pad, device=dev)
    qpos = desc[:, 1:2] + lane[None, :]
    mask = (kpos[None, None, :] <= qpos[:, :, None]) & (kpos[None, None, :] < desc[:, 3, None, None])
    mask = (mask | (kpos[None, None, :] == 0))[:, None]  # keeps dead lanes finite
    kv_k = kp[tables.long()].reshape(r, s_pad, kv, dh).permute(0, 2, 1, 3)
    kv_v = vp[tables.long()].reshape(r, s_pad, kv, dh).permute(0, 2, 1, 3)
    qt = q.permute(0, 2, 1, 3)
    n_q = sum(d[2] for d in desc_h)
    n_kv = [min(kl, q0 + ql) if ql > 0 else 0 for _, q0, ql, kl in desc_h]
    flops = sum(4 * h * dh * min(q0 + j + 1, kl) for _, q0, ql, kl in desc_h for j in range(ql))
    nbytes = (n_q * h * dh * es + r * w * h * dh * es + 2 * sum(n_kv) * kv * dh * es + desc.numel() * 4
              + sum(-(-n // bs) for n in n_kv) * 4)
    b_ms, b_by = bound(nbytes, (flops, dtype))
    return dict(
        **timer.turns(dict(
            ms=lambda: cp.mixed_prefill_attention(q, kp, vp, tables, desc),
            plain_ms=lambda: cp.mixed_prefill_attention_plain(q, kp, vp, tables, desc),
            library_ms=lambda: F.scaled_dot_product_attention(qt, kv_k, kv_v, attn_mask=mask, enable_gqa=True),
        )),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
        shape=f"{label}: R={r} W={w} H={h} KV={kv} dh={dh} bs={bs}, (q_start, q_len, kv_len) "
              f"{[d[1:] for d in desc_h]} {dtype}",
    )


def verify_lanes_check(torch, gen, h: int, kv: int, dtype: str) -> None:
    """Verify rows (q_len = 4 lanes from the committed position) against
    q_len = 1 rows at each lane's position over the same pool: bitwise
    equal, the lane's trailing fully masked key tiles leaving its m, l and
    output exact.  Windows end on, before and past a block and a 64-key
    tile."""
    from repro_torch.kernels.chunked_prefill import ops as cp

    dev = torch.device("cuda")
    r, w, dh, bs, n_t, k1 = 8, 256, 128, 32, 9, 4
    n_pool = r * n_t + 1
    tdt = getattr(torch, dtype)
    kp = torch.randn(n_pool, bs, kv, dh, generator=gen, device=dev).to(tdt)
    vp = torch.randn(n_pool, bs, kv, dh, generator=gen, device=dev).to(tdt)
    tables = torch.randperm(n_pool - 1, generator=torch.Generator().manual_seed(SEED))[: r * n_t]
    tables = tables.reshape(r, n_t).to(torch.int32).to(dev)
    q0 = [0, 27, 28, 31, 62, 63, 100, 283]
    q = torch.randn(r, w, h, dh, generator=gen, device=dev).to(tdt)
    ver = cp.mixed_prefill_attention(q, kp, vp, tables, torch.tensor(
        [(i, s, k1, s + k1) for i, s in enumerate(q0)], dtype=torch.int32, device=dev))
    for j in range(k1):
        qj = torch.zeros_like(q)
        qj[:, 0] = q[:, j]
        one = cp.mixed_prefill_attention(qj, kp, vp, tables, torch.tensor(
            [(i, s + j, 1, s + j + 1) for i, s in enumerate(q0)], dtype=torch.int32, device=dev))
        if not torch.equal(ver[:, j], one[:, 0]):
            fail(f"mixed_prefill H={h} KV={kv} {dtype}: verify lane {j} differs from a q_len=1 row at its position")
    print(f"  mixed_prefill H={h} KV={kv} {dtype}: every lane of 8 verify rows (q_len 4, q_start {q0}) bitwise "
          f"equal to a q_len=1 row at its position", flush=True)


def kernel_phase(torch, timer, parent: Parent | None) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.chunked_prefill import ops as cp
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.retrieval_topk import ops as rt
    from repro_torch.kernels.ssd_scan import ops as ss

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}

    # ---- retrieval top-k ----
    def topk_case(q, n, d, k, dtype, label):
        # unit-norm rows, as the bag embedder hands the providers
        qs = F.normalize(torch.randn(q, d, generator=gen, device=dev), dim=1).to(getattr(torch, dtype))
        cs = F.normalize(torch.randn(n, d, generator=gen, device=dev), dim=1).to(getattr(torch, dtype))
        s, i = rt.retrieval_topk(qs, cs, k)
        s_p, i_p = rt.retrieval_topk_plain(qs, cs, k)
        full_at = (qs.float() @ cs.float().T).gather(1, i.long())  # scores of the kernel's ids
        err = max((s - s_p).abs().max().item(), (full_at - s_p).abs().max().item())
        check(f"retrieval_topk {label} Q={q} N={n} D={d} k={k} {dtype}", err, dtype)
        if not torch.equal(i, i_p):  # random unit vectors: no ties, so the ids must agree
            fail(f"retrieval_topk {label} {dtype}: ids differ from the plain version's")
        print("    ids equal to plain", flush=True)
        if parent and k <= 32 and d % 4 == 0 and d <= 1024:  # what the parent takes
            s_par, i_par = parent.retrieval_topk(qs, cs, k)
            if not (torch.equal(s_par, s) and torch.equal(i_par, i)):
                fail(f"retrieval_topk {label} {dtype}: scores or ids differ from the parent's build")
            print("    scores and ids bitwise equal to the parent's build", flush=True)
        return qs, cs, err

    def topk_row(qs, cs, k, dtype, err):
        (nq, d), n, es = qs.shape, cs.shape[0], qs.element_size()
        b_ms, b_by = bound(nq * d * es + n * d * es + nq * k * 8, (2 * nq * n * d, dtype))
        return dict(
            **timer.turns(dict(
                ms=lambda: rt.retrieval_topk(qs, cs, k),
                plain_ms=lambda: rt.retrieval_topk_plain(qs, cs, k),
                library_ms=lambda: torch.topk(qs @ cs.T, k, dim=1),
                parent_ms=parent and (lambda: parent.retrieval_topk(qs, cs, k)),
            )),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err, shape=f"Q={nq} N={n} D={d} k={k} {dtype}",
        )

    nq, n, d, k = 32, 1 << 20, 256, 8  # provider scale
    for dtype in ("float32", "bfloat16"):
        topk_case(16, 256, d, k, dtype, "path")
        qs, cs, err = topk_case(nq, n, d, k, dtype, "provider")
        s32, i32 = rt.retrieval_topk(qs, cs, k)
        for r in (0, 13, 31):
            s1, i1 = rt.retrieval_topk(qs[r : r + 1], cs, k)
            if not (torch.equal(s1[0], s32[r]) and torch.equal(i1[0], i32[r])):
                fail(f"retrieval_topk {dtype}: batch-of-1 scores of query {r} differ from batch-of-32")
        print(f"  retrieval_topk {dtype}: batch-of-1 == batch-of-32 bitwise (queries 0, 13, 31)", flush=True)
        rows["retrieval_topk", dtype] = topk_row(qs, cs, k, dtype, err)
        del qs, cs
        # past the caps of the kernel before the shared-memory tiles: k > 32
        # with D not a multiple of 4, and D > 1024
        topk_case(8, 20000, 770, 100, dtype, "long lists")
        topk_case(32, 50000, 1100, 8, dtype, "wide rows")
    # the served shape: 16 queries against a provider's 147 chunks, with the
    # bag embedder's D and contriever's
    for d_s in (256, 768):
        qs, cs, err = topk_case(16, 147, d_s, k, "float32", "served")
        rows["retrieval_topk", "float32", f"served D={d_s}"] = topk_row(qs, cs, k, "float32", err)

    # ---- attention at the serving shapes ----
    R, W, H, KV, DH, BS, NT = 8, 256, 16, 8, 128, 32, 9  # max_batch, token_budget, qwen3-0.6b
    G = H // KV
    s_pad = NT * BS
    n_pool = R * NT + 1
    perm = torch.randperm(n_pool - 1, generator=torch.Generator().manual_seed(SEED))
    tables = perm[: R * NT].reshape(R, NT).to(torch.int32)
    # a step's mix: a cold prompt chunk, a warm chunk, five decode rows, an idle slot
    desc_h = [(0, 0, 180, 180), (1, 100, 76, 176)] + [(r, 120 + 25 * r, 1, 121 + 25 * r) for r in range(2, 7)] + [(7, 0, 0, 0)]
    lens_h = [288, 17, 200, 64, 250, 131, 99, 1]
    for r in range(R):  # table entries no lane needs point at the trash block, as in the engine
        tables[r, -(-max(desc_h[r][3], lens_h[r]) // BS):] = n_pool - 1
    tables = tables.to(dev)
    desc = torch.tensor(desc_h, dtype=torch.int32, device=dev)
    lens = torch.tensor(lens_h, dtype=torch.int32, device=dev)
    # what these descriptors and lengths need: bytes read once, FLOPs of QK and PV
    # (a dead lane's output is 0 whatever its q holds, so only live lanes read q)
    n_q = sum(ql for _, _, ql, _ in desc_h)
    n_kv = [min(kl, qs0 + ql) if ql > 0 else 0 for _, qs0, ql, kl in desc_h]
    flops_m = sum(4 * H * DH * min(qs0 + j + 1, kl) for _, qs0, ql, kl in desc_h for j in range(ql))
    flops_d = 4 * sum(lens_h) * H * DH
    # SDPA yardsticks over the gathered views (the gather is not timed)
    lane = torch.arange(W, device=dev)
    kpos = torch.arange(s_pad, device=dev)
    qpos = desc[:, 1:2] + lane[None, :]
    mask_m = (kpos[None, None, :] <= qpos[:, :, None]) & (kpos[None, None, :] < desc[:, 3, None, None])
    mask_m = (mask_m | (kpos[None, None, :] == 0))[:, None]  # keeps dead lanes finite
    mask_d = (kpos[None, :] < lens[:, None])[:, None, None, :]

    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        es = torch.empty((), dtype=tdt).element_size()
        q = torch.randn(R, W, H, DH, generator=gen, device=dev).to(tdt)
        qd = torch.randn(R, H, DH, generator=gen, device=dev).to(tdt)
        kp = torch.randn(n_pool, BS, KV, DH, generator=gen, device=dev).to(tdt)
        vp = torch.randn(n_pool, BS, KV, DH, generator=gen, device=dev).to(tdt)

        o = cp.mixed_prefill_attention(q, kp, vp, tables, desc)
        om_plain = cp.mixed_prefill_attention_plain(q, kp, vp, tables, desc).float()
        err = (o.float() - om_plain).abs().max().item()
        check(f"mixed_prefill W*G={W * G} {dtype}", err, dtype)
        if parent:
            check(f"  the parent's mixed_prefill {dtype}",
                  (parent.mixed_prefill(q, kp, vp, tables, desc).float() - om_plain).abs().max().item(), dtype)
        dead = lane[None, :] >= desc[:, 2:3]
        if not bool((o[dead] == 0).all()):
            fail("mixed_prefill: dead lanes are not exactly 0")
        kp2, vp2 = kp.clone(), vp.clone()
        for t in (kp2, vp2):
            t[n_pool - 1] = 1e4  # trash block
            t[tables[0, 5].long(), 20:] = -1e4  # masked tail of row 0's last live block (kv_len 180)
        if not torch.equal(cp.mixed_prefill_attention(q, kp2, vp2, tables, desc), o):
            fail("mixed_prefill: the poisoned trash block changed the output")
        print(f"  mixed_prefill {dtype}: dead lanes exactly 0; trash-poison diff 0", flush=True)
        if dtype == "bfloat16":
            # which rows set the pace: each live block's walk (key tiles of
            # 64, one block per KV head), and the kernel on the decode rows
            # alone and on the prefill rows alone (the others' lanes dead)
            walks = {}
            for r, (_, q0, ql, kl) in enumerate(desc_h):
                for i0 in range(0, W * G, 64):
                    if i0 // G < ql:
                        last = min((min(W * G, i0 + 64) - 1) // G, ql - 1)
                        walks.setdefault(r, []).append(-(-min(kl, s_pad, q0 + last + 1) // 64))
            print(f"  mixed_prefill walks, key tiles per live lane tile, by row: {walks}", flush=True)
            desc_dec, desc_pre = desc.clone(), desc.clone()
            desc_dec[:2, 2] = 0
            desc_pre[2:, 2] = 0
            split = timer.turns(dict(
                all=lambda: cp.mixed_prefill_attention(q, kp, vp, tables, desc),
                decode_rows=lambda: cp.mixed_prefill_attention(q, kp, vp, tables, desc_dec),
                prefill_rows=lambda: cp.mixed_prefill_attention(q, kp, vp, tables, desc_pre),
            ))
            print(f"  mixed_prefill {dtype}: all rows {split['all']:.4f} ms, the five decode rows alone "
                  f"{split['decode_rows']:.4f} ms, the two prefill rows alone {split['prefill_rows']:.4f} ms", flush=True)

        od = da.paged_decode_attention(qd, kp, vp, tables, lens)
        od_plain = da.paged_decode_attention_plain(qd, kp, vp, tables, lens).float()
        err_d = (od.float() - od_plain).abs().max().item()
        check(f"paged_decode B={R} {dtype}", err_d, dtype)
        if parent:
            od_parent = parent.paged_decode(qd, kp, vp, tables, lens)
            check(f"  the parent's paged_decode {dtype}", (od_parent.float() - od_plain).abs().max().item(), dtype)
            if not torch.equal(od_parent, od):
                fail(f"paged_decode {dtype}: the output differs from the parent's build")
            print(f"  paged_decode {dtype}: bitwise equal to the parent's build", flush=True)
        kp3, vp3 = kp.clone(), vp.clone()
        for t in (kp3, vp3):
            t[n_pool - 1] = 1e4
            t[tables[1, 0].long(), 17:] = -1e4  # past row 1's length 17
        if not torch.equal(da.paged_decode_attention(qd, kp3, vp3, tables, lens), od):
            fail("paged_decode: the poisoned trash block changed the output")
        print(f"  paged_decode {dtype}: trash-poison diff 0", flush=True)

        kv_k = kp[tables.long()].reshape(R, s_pad, KV, DH).permute(0, 2, 1, 3)
        kv_v = vp[tables.long()].reshape(R, s_pad, KV, DH).permute(0, 2, 1, 3)
        qt = q.permute(0, 2, 1, 3)
        nbytes = (n_q * H * DH * es + R * W * H * DH * es  # q of live lanes in, every lane out
                  + 2 * sum(n_kv) * KV * DH * es + desc.numel() * 4 + sum(-(-n // BS) for n in n_kv) * 4)
        b_ms, b_by = bound(nbytes, (flops_m, dtype))
        rows["mixed_prefill", dtype] = dict(
            **timer.turns(dict(
                ms=lambda: cp.mixed_prefill_attention(q, kp, vp, tables, desc),
                plain_ms=lambda: cp.mixed_prefill_attention_plain(q, kp, vp, tables, desc),
                library_ms=lambda: F.scaled_dot_product_attention(qt, kv_k, kv_v, attn_mask=mask_m, enable_gqa=True),
                parent_ms=parent and (lambda: parent.mixed_prefill(q, kp, vp, tables, desc)),
            )),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
            shape=f"R={R} W={W} H={H} KV={KV} dh={DH} bs={BS} n_t={NT} {dtype}",
        )
        nbytes_d = (2 * R * H * DH * es + 2 * sum(lens_h) * KV * DH * es
                    + sum(-(-n // BS) for n in lens_h) * 4 + R * 4)  # table entries the lengths reach
        b_ms, b_by = bound(nbytes_d, (flops_d, dtype))
        rows["paged_decode", dtype] = dict(
            **timer.turns(dict(
                ms=lambda: da.paged_decode_attention(qd, kp, vp, tables, lens),
                plain_ms=lambda: da.paged_decode_attention_plain(qd, kp, vp, tables, lens),
                library_ms=lambda: F.scaled_dot_product_attention(
                    qd[:, :, None], kv_k, kv_v, attn_mask=mask_d, enable_gqa=True),
                parent_ms=parent and (lambda: parent.paged_decode(qd, kp, vp, tables, lens)),
            )),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err_d,
            shape=f"B={R} H={H} KV={KV} dh={DH} bs={BS} n_t={NT} {dtype}",
        )

    # ---- mixed_prefill at the warm-admission shape (the prefix cache) ----
    # each row's prompt of L tokens finds its first L // 32 blocks cached:
    # rows 0-3 share chain A, rows 4-7 chain B, so their table entries alias;
    # the row prefills only its suffix, q_start = 32 * (L // 32), q_len 1-31.
    # A prompt ending on a block boundary (rows 4 and 7) recomputes its last
    # token from q_start = L - 1 in a private copy of the boundary block
    warm_len = [200, 231, 257, 287, 192, 150, 95, 288]
    chain = {0: list(range(0, NT)), 1: list(range(NT, 2 * NT))}
    nxt_block = 2 * NT
    tables_w = torch.full((R, NT), n_pool - 1, dtype=torch.int32)
    desc_w_h = []
    for r, ln in enumerate(warm_len):
        n_sh = ln // BS
        cow = ln % BS == 0
        own = chain[r // 4][: n_sh - cow]
        if cow:
            q0 = ln - 1
        else:
            q0 = n_sh * BS
        for c in range(-(-ln // BS)):
            if c < len(own):
                tables_w[r, c] = own[c]
            else:
                tables_w[r, c] = nxt_block
                nxt_block += 1
        desc_w_h.append((r, q0, ln - q0, ln))
    tables_w = tables_w.to(dev)
    desc_w = torch.tensor(desc_w_h, dtype=torch.int32, device=dev)
    n_q_w = sum(ql for _, _, ql, _ in desc_w_h)
    # K/V the rows need, each pool position read once however many rows alias it
    kv_pos = {(int(tables_w[r, p // BS]), p % BS) for r, _, _, kl in desc_w_h for p in range(kl)}
    flops_w = sum(4 * H * DH * (q0 + j + 1) for _, q0, ql, _ in desc_w_h for j in range(ql))
    qpos_w = desc_w[:, 1:2] + lane[None, :]
    mask_w = (kpos[None, None, :] <= qpos_w[:, :, None]) & (kpos[None, None, :] < desc_w[:, 3, None, None])
    mask_w = (mask_w | (kpos[None, None, :] == 0))[:, None]
    print(f"  mixed_prefill warm admission: (q_start, q_len, kv_len) by row "
          f"{[d[1:] for d in desc_w_h]}, {len(kv_pos)} distinct K/V positions for "
          f"{sum(d[3] for d in desc_w_h)} read", flush=True)
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        es = torch.empty((), dtype=tdt).element_size()
        q = torch.randn(R, W, H, DH, generator=gen, device=dev).to(tdt)
        kp = torch.randn(n_pool, BS, KV, DH, generator=gen, device=dev).to(tdt)
        vp = torch.randn(n_pool, BS, KV, DH, generator=gen, device=dev).to(tdt)
        o = cp.mixed_prefill_attention(q, kp, vp, tables_w, desc_w)
        err = (o.float() - cp.mixed_prefill_attention_plain(q, kp, vp, tables_w, desc_w).float()).abs().max().item()
        check(f"mixed_prefill warm admission {dtype}", err, dtype)
        if not bool((o[lane[None, :] >= desc_w[:, 2:3]] == 0).all()):
            fail("mixed_prefill warm admission: dead lanes are not exactly 0")
        # the same positions prefilled cold, each row from 0 in lanes 0..L-1
        # over the same pool: a lane's output must not depend on its lane
        qc = torch.zeros((R, 320, H, DH), dtype=tdt, device=dev)
        desc_c = desc_w.clone()
        for r, (_, q0, ql, ln) in enumerate(desc_w_h):
            qc[r, q0 : q0 + ql] = q[r, :ql]
            desc_c[r, 1], desc_c[r, 2] = 0, ln
        oc = cp.mixed_prefill_attention(qc, kp, vp, tables_w, desc_c)
        if not all(torch.equal(o[r, :ql], oc[r, q0 : q0 + ql]) for r, (_, q0, ql, _) in enumerate(desc_w_h)):
            fail(f"mixed_prefill {dtype}: warm-admission lanes differ from the same positions prefilled cold")
        print(f"  mixed_prefill warm admission {dtype}: dead lanes exactly 0; every suffix lane bitwise equal to "
              f"its position prefilled cold from 0", flush=True)
        del qc, oc
        kv_k = kp[tables_w.long()].reshape(R, s_pad, KV, DH).permute(0, 2, 1, 3)
        kv_v = vp[tables_w.long()].reshape(R, s_pad, KV, DH).permute(0, 2, 1, 3)
        qt = q.permute(0, 2, 1, 3)
        nbytes = (n_q_w * H * DH * es + R * W * H * DH * es + 2 * len(kv_pos) * KV * DH * es
                  + desc_w.numel() * 4 + sum(-(-d[3] // BS) for d in desc_w_h) * 4)
        b_ms, b_by = bound(nbytes, (flops_w, dtype))
        rows["mixed_prefill", dtype, "warm"] = dict(
            **timer.turns(dict(
                ms=lambda: cp.mixed_prefill_attention(q, kp, vp, tables_w, desc_w),
                plain_ms=lambda: cp.mixed_prefill_attention_plain(q, kp, vp, tables_w, desc_w),
                library_ms=lambda: F.scaled_dot_product_attention(qt, kv_k, kv_v, attn_mask=mask_w, enable_gqa=True),
                parent_ms=parent and (lambda: parent.mixed_prefill(q, kp, vp, tables_w, desc_w)),
            )),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
            shape=f"warm admission: R={R} W={W} H={H} KV={KV} dh={DH} bs={BS}, q_len 1-31, kv_len to 288, "
                  f"aliased table entries {dtype}",
        )
        del q, kp, vp, kv_k, kv_v, qt

    # ---- dense flash attention at the path shapes ----
    flash_cases = [
        # (label, B, Sq = Sk, H, KV, dh, causal)
        ("rerank", 256, 64, 12, 12, 64, False),  # 16 queries x 16 candidates, bge-reranker-base
        ("chunk index", 147, 40, 12, 12, 64, False),  # the larger provider's 147 chunks, contriever-110m
        ("admit prefill", 8, 256, 16, 8, 128, True),  # contiguous qwen3-0.6b admit group
        ("ragged causal", 3, 100, 16, 8, 128, True),  # 100 positions: no tile multiple
    ]
    for label, b, sl, h, kv, dh, causal in flash_cases:
        pairs = sum(min(i + 1, sl) for i in range(sl)) if causal else sl * sl
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            es = torch.empty((), dtype=tdt).element_size()
            q = torch.randn(b, sl, h, dh, generator=gen, device=dev).to(tdt)
            k = torch.randn(b, sl, kv, dh, generator=gen, device=dev).to(tdt)
            v = torch.randn(b, sl, kv, dh, generator=gen, device=dev).to(tdt)
            o = fa.flash_attention(q, k, v, causal=causal)
            o_plain = fa.flash_attention_plain(q, k, v, causal=causal).float()
            err = (o.float() - o_plain).abs().max().item()
            shape = f"B={b} S={sl} H={h} KV={kv} dh={dh} {'causal' if causal else 'non-causal'} {dtype}"
            check(f"flash_attention {label} {shape}", err, dtype)
            if parent:
                o_parent = parent.flash_attention(q, k, v, causal)
                check(f"  the parent's flash_attention, {label} {dtype}",
                      (o_parent.float() - o_plain).abs().max().item(), dtype)
                if dtype == "bfloat16":
                    if not torch.equal(o_parent, o):
                        fail(f"flash_attention {label} {dtype}: the output differs from the parent's build")
                    print(f"  flash_attention {label} {dtype}: bitwise equal to the parent's build", flush=True)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            b_ms, b_by = bound(es * (2 * b * sl * h * dh + 2 * b * sl * kv * dh), (4 * b * h * dh * pairs, dtype))
            rows["flash_attention", dtype, label] = dict(
                **timer.turns(dict(
                    ms=lambda: fa.flash_attention(q, k, v, causal=causal),
                    plain_ms=lambda: fa.flash_attention_plain(q, k, v, causal=causal),
                    library_ms=lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True),
                    parent_ms=parent and (lambda: parent.flash_attention(q, k, v, causal)),
                )),
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err, shape=f"{label}: {shape}",
            )
            del q, k, v, qt, kt, vt

    # ---- contiguous flash-decode at the phase-6 decode shape ----
    S = 272  # max_prompt_len + max_new_tokens: the contiguous engine's stripe
    lens_c = [272, 17, 200, 64, 250, 131, 99, 1]  # ragged, one full stripe, one single position
    lens_t = torch.tensor(lens_c, dtype=torch.int32, device=dev)
    mask_c = (torch.arange(S, device=dev)[None, :] < lens_t[:, None])[:, None, None, :]
    shards, step = 4, S // 4
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        es = torch.empty((), dtype=tdt).element_size()
        qd = torch.randn(R, H, DH, generator=gen, device=dev).to(tdt)
        kc = torch.randn(R, S, KV, DH, generator=gen, device=dev).to(tdt)
        vc = torch.randn(R, S, KV, DH, generator=gen, device=dev).to(tdt)
        o = da.decode_attention(qd, kc, vc, lens_t)
        oc_plain = da.decode_attention_plain(qd, kc, vc, lens_t).float()
        err = (o.float() - oc_plain).abs().max().item()
        check(f"flash_decode B={R} S={S} {dtype}", err, dtype)
        if parent:
            check(f"  the parent's flash_decode {dtype}",
                  (parent.flash_decode(qd, kc, vc, lens_t).float() - oc_plain).abs().max().item(), dtype)
        # partials of 4 sequence shards, combined, against the monolithic partials
        o_m, _, l_m = da.decode_attention(qd, kc, vc, lens_t, return_partials=True)
        parts = [
            da.decode_attention(qd, kc[:, i * step : (i + 1) * step], vc[:, i * step : (i + 1) * step],
                                torch.clamp(lens_t - i * step, 0, step), return_partials=True)
            for i in range(shards)
        ]
        err_c = (da.combine_partials(*zip(*parts)) - o_m / torch.clamp(l_m, min=1e-30)).abs().max().item()
        check(f"flash_decode partials, {shards} shards combined vs monolithic, {dtype} cache", err_c, "float32")
        b_ms, b_by = bound(es * (2 * R * H * DH + 2 * sum(lens_c) * KV * DH) + 4 * R, (4 * sum(lens_c) * H * DH, dtype))
        rows["flash_decode", dtype] = dict(
            **timer.turns(dict(
                ms=lambda: da.decode_attention(qd, kc, vc, lens_t),
                plain_ms=lambda: da.decode_attention_plain(qd, kc, vc, lens_t),
                library_ms=lambda: F.scaled_dot_product_attention(
                    qd[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2), attn_mask=mask_c, enable_gqa=True),
                parent_ms=parent and (lambda: parent.flash_decode(qd, kc, vc, lens_t)),
            )),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err, combine_err=err_c,
            shape=f"B={R} H={H} KV={KV} dh={DH} S={S} lengths {min(lens_c)}-{max(lens_c)} (sum {sum(lens_c)}) {dtype}",
        )
        del qd, kc, vc

    # ---- SSD chunk at the phase-7 admit shape (mamba2-1.3b, one group) ----
    SB, SL, SH, SHD, SDS, SG = 8, 256, 64, 64, 128, 1
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        es = torch.empty((), dtype=tdt).element_size()
        # as the mixer hands them over: silu'd x, B, C (one group, expanded
        # over the heads), softplus'd dt, a = -exp(A_log)
        x = F.silu(torch.randn(SB, SL, SH, SHD, generator=gen, device=dev)).to(tdt)
        bg = F.silu(torch.randn(SB, SL, SG, SDS, generator=gen, device=dev)).to(tdt).expand(SB, SL, SH, SDS)
        cg = F.silu(torch.randn(SB, SL, SG, SDS, generator=gen, device=dev)).to(tdt).expand(SB, SL, SH, SDS)
        dt = F.softplus(torch.randn(SB, SL, SH, generator=gen, device=dev))
        a = -torch.exp(0.5 * torch.randn(SH, generator=gen, device=dev))
        outs, plain = ss.ssd_chunk(x, bg, cg, dt, a), ss.ssd_chunk_plain(x, bg, cg, dt, a)
        err = max((o - p).abs().max().item() for o, p in zip(outs, plain))
        rel = max((o - p).abs().max().item() / p.abs().max().item() for o, p in zip(outs, plain))
        print(f"  ssd_chunk B={SB} L={SL} H={SH} {dtype}: max |kernel - plain| = {err:.3e} at max |y| = "
              f"{plain[0].abs().max().item():.3e}", flush=True)
        # bf16 inputs are upcast exactly and every product is f32, so both
        # rows are held to the f32 tolerance
        check(f"ssd_chunk B={SB} L={SL} H={SH} hd={SHD} ds={SDS} {dtype}, error / max |output|", rel, "float32")
        if parent:
            if not all(torch.equal(o, p) for o, p in zip(outs, parent.ssd_chunk(x, bg, cg, dt, a))):
                fail(f"ssd_chunk {dtype}: the outputs differ from the parent's build")
            print(f"  ssd_chunk {dtype}: bitwise equal to the parent's build", flush=True)
        # bytes: x in, one group of B and C, dt, a; y, state, decay out.
        # FLOPs over the causal half (j <= i) that the function needs: C.B^T
        # once per (batch, group), on the inputs' own type (bf16 x bf16 is
        # exact with f32 accumulation); the score-weighted x and the state
        # product once per (batch, head), f32 since the decay weights are f32
        tri = SL * (SL + 1) // 2
        nbytes = es * (SB * SL * SH * SHD + 2 * SB * SL * SG * SDS) + 4 * (SB * SL * SH + SH) \
            + 4 * (SB * SL * SH * SHD + SB * SH * SHD * SDS + SB * SH)
        b_ms, b_by = bound(
            nbytes,
            (SB * SG * tri * 2 * SDS, dtype),
            (SB * SH * (tri * 2 * SHD + 2 * SL * SHD * SDS), "float32"),
        )
        rows["ssd_chunk", dtype] = dict(
            **timer.turns(dict(
                ms=lambda: ss.ssd_chunk(x, bg, cg, dt, a),
                plain_ms=lambda: ss.ssd_chunk_plain(x, bg, cg, dt, a),
                library_ms=None,  # no single PyTorch call computes the chunk terms
                parent_ms=parent and (lambda: parent.ssd_chunk(x, bg, cg, dt, a)),
            )),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err, max_rel_err=rel,
            shape=f"B={SB} L={SL} H={SH} hd={SHD} ds={SDS} G={SG} {dtype} x/B/C, f32 dt/a",
        )
        del x, bg, cg, dt, outs, plain

    # ---- one query head per KV head: qwen2-moe-a2.7b (H = KV = 16, dh 128) ----
    # the paged and admit shapes above with qwen2-moe's heads; and the
    # verify rows of speculative decoding against single-lane rows
    HM = 16
    for dtype in ("float32", "bfloat16"):
        rows["mixed_prefill", dtype, "G=1"] = mixed_prefill_row(
            torch, timer, gen, desc_h, tables, n_pool, HM, HM, dtype, "qwen2-moe heads, the step's mix above")
        tdt = getattr(torch, dtype)
        es = torch.empty((), dtype=tdt).element_size()
        qd = torch.randn(R, HM, DH, generator=gen, device=dev).to(tdt)
        kp = torch.randn(n_pool, BS, HM, DH, generator=gen, device=dev).to(tdt)
        vp = torch.randn(n_pool, BS, HM, DH, generator=gen, device=dev).to(tdt)
        od = da.paged_decode_attention(qd, kp, vp, tables, lens)
        err = (od.float() - da.paged_decode_attention_plain(qd, kp, vp, tables, lens).float()).abs().max().item()
        check(f"paged_decode B={R} H=KV={HM} {dtype}", err, dtype)
        kv_k = kp[tables.long()].reshape(R, s_pad, HM, DH).permute(0, 2, 1, 3)
        kv_v = vp[tables.long()].reshape(R, s_pad, HM, DH).permute(0, 2, 1, 3)
        b_ms, b_by = bound(2 * R * HM * DH * es + 2 * sum(lens_h) * HM * DH * es
                           + sum(-(-n // BS) for n in lens_h) * 4 + R * 4, (4 * sum(lens_h) * HM * DH, dtype))
        rows["paged_decode", dtype, "G=1"] = dict(
            **timer.turns(dict(
                ms=lambda: da.paged_decode_attention(qd, kp, vp, tables, lens),
                plain_ms=lambda: da.paged_decode_attention_plain(qd, kp, vp, tables, lens),
                library_ms=lambda: F.scaled_dot_product_attention(qd[:, :, None], kv_k, kv_v, attn_mask=mask_d),
            )),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
            shape=f"B={R} H=KV={HM} dh={DH} bs={BS} n_t={NT} lengths {min(lens_h)}-{max(lens_h)} {dtype}",
        )
        del kp, vp, kv_k, kv_v
        q = torch.randn(8, 256, HM, DH, generator=gen, device=dev).to(tdt)
        k = torch.randn(8, 256, HM, DH, generator=gen, device=dev).to(tdt)
        v = torch.randn(8, 256, HM, DH, generator=gen, device=dev).to(tdt)
        o = fa.flash_attention(q, k, v, causal=True)
        err = (o.float() - fa.flash_attention_plain(q, k, v, causal=True).float()).abs().max().item()
        check(f"flash_attention admit prefill B=8 S=256 H=KV={HM} causal {dtype}", err, dtype)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        pairs = 256 * 257 // 2
        b_ms, b_by = bound(es * 4 * 8 * 256 * HM * DH, (4 * 8 * HM * DH * pairs, dtype))
        rows["flash_attention", dtype, "G=1"] = dict(
            **timer.turns(dict(
                ms=lambda: fa.flash_attention(q, k, v, causal=True),
                plain_ms=lambda: fa.flash_attention_plain(q, k, v, causal=True),
                library_ms=lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
            )),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
            shape=f"admit prefill: B=8 S=256 H=KV={HM} dh={DH} causal {dtype}",
        )
        del q, k, v, qt, kt, vt
        kc = torch.randn(R, S, HM, DH, generator=gen, device=dev).to(tdt)
        vc = torch.randn(R, S, HM, DH, generator=gen, device=dev).to(tdt)
        o = da.decode_attention(qd, kc, vc, lens_t)
        err = (o.float() - da.decode_attention_plain(qd, kc, vc, lens_t).float()).abs().max().item()
        check(f"flash_decode B={R} S={S} H=KV={HM} {dtype}", err, dtype)
        b_ms, b_by = bound(es * (2 * R * HM * DH + 2 * sum(lens_c) * HM * DH) + 4 * R,
                           (4 * sum(lens_c) * HM * DH, dtype))
        rows["flash_decode", dtype, "G=1"] = dict(
            **timer.turns(dict(
                ms=lambda: da.decode_attention(qd, kc, vc, lens_t),
                plain_ms=lambda: da.decode_attention_plain(qd, kc, vc, lens_t),
                library_ms=lambda: F.scaled_dot_product_attention(
                    qd[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2), attn_mask=mask_c),
            )),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
            shape=f"B={R} H=KV={HM} dh={DH} S={S} lengths {min(lens_c)}-{max(lens_c)} {dtype}",
        )
        del qd, kc, vc
        for h, kv in ((H, KV), (HM, HM)):
            verify_lanes_check(torch, gen, h, kv, dtype)

    for key, row in rows.items():
        print_row(key[0], row)
    return rows


def print_row(name: str, row: dict) -> None:
    lib = "-" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms (kernel / library {row['ms'] / row['library_ms']:.2f})"
    par = "" if row.get("parent_ms") is None else f", parent {row['parent_ms']:.4f} ms (parent / kernel {row['parent_ms'] / row['ms']:.2f})"
    late = "".join(f", {n} late {c}/20" for n, c in row["late"].items())
    print(
        f"  {name} [{row['shape']}]: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"library {lib}, bound {row['bound_ms']:.6f} ms ({row['bound_by']}; kernel / bound "
        f"{row['ms'] / row['bound_ms']:.1f}){par}{late}",
        flush=True,
    )


# --------------------------------------------------------------------- #
# phases 4-7: end to end
# --------------------------------------------------------------------- #


def serve_phase(torch, smi: str, sys_, engine, texts, label: str, need, warm_up: bool = True,
                serve=None) -> tuple[list, dict]:
    """Warm up (unless ``warm_up`` is false), then one ``CFedRAGSystem.serve``
    of ``texts`` (or ``serve(texts)``, which returns the results in query
    order) with every launch counter at 0 just before and read just after;
    every status must be ``done`` and every answer token in the vocabulary."""
    if warm_up:
        sys_.serve(texts[:2], max_new_tokens=2)  # warm-up: allocator, first launches
    gc.collect()  # earlier phases' systems, held only by reference cycles
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    results = (serve or sys_.serve)(texts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(f"the {label} serve", need)
    statuses = [r["status"] for r in results]
    if statuses != ["done"] * len(texts):
        fail(f"{label}: statuses {statuses}")
    vocab = engine.cfg.vocab_size
    if any(((r["answer_tokens"] < 0) | (r["answer_tokens"] >= vocab)).any() for r in results):
        fail(f"{label}: answer token outside the vocabulary")
    n_tok = sum(len(r["answer_tokens"]) for r in results)
    st = sys_.last_serve_stats
    lats = sorted(r["latency_s"] for r in results)
    p50, p95 = lats[len(lats) // 2], lats[min(len(lats) - 1, int(len(lats) * 0.95))]
    print(
        f"  e2e {label}: {len(texts)} queries, max_batch {engine.scfg.max_batch}: p50 {p50 * 1e3:.1f} ms, "
        f"p95 {p95 * 1e3:.1f} ms, {n_tok / wall:.1f} tokens/s ({n_tok} tokens in {wall:.3f} s), "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({resident / 2**30:.2f} GiB resident "
        f"before the serve), {st['admit_dispatches']} admit + "
        f"{st['mixed_dispatches']} mixed + {st['decode_dispatches']} decode dispatches [{smi}]",
        flush=True,
    )
    return results, launches


def small_model(torch, vocab: int, arch: str = "qwen3-0.6b"):
    """Smoke-width ``arch`` in f32, weights drawn on the CPU from SEED:
    the CPU copy and the card copy hold the same numbers."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import lm as LM
    from repro_torch.models.params import init_params, map_tree

    small = smoke_config(get_config(arch)).with_overrides(dtype="float32", vocab_size=vocab)
    p_cpu = init_params(LM.param_specs(small), torch.Generator().manual_seed(SEED), device="cpu")
    return small, p_cpu, map_tree(lambda t: t.to("cuda"), p_cpu)


def paged_phase(torch, smi: str) -> tuple[dict, list]:
    import numpy as np

    from repro_torch.launch.serve import full_width_system
    from repro_torch.models import lm as LM
    from repro_torch.serving.engine import ServeConfig, ServeEngine

    # qwen3-0.6b at full width, 28 layers, bf16 activations and pool
    sys_, engine, texts = full_width_system(16, "cuda", SEED)
    cfg, scfg = engine.cfg, engine.scfg
    results, launches = serve_phase(
        torch, smi, sys_, engine, texts, "paged qwen3-0.6b full width bf16, bag embedder",
        ("retrieval_topk", "mixed_prefill", "paged_decode"),
    )

    # logits of the full-width model on the first prompt: finite, right shape
    prompt = torch.as_tensor(np.asarray(results[0]["prompt"]).reshape(1, -1), device="cuda")
    bpp = -(-prompt.shape[1] // scfg.block_size)
    cache = LM.init_paged_cache(cfg, bpp + 1, scfg.block_size, dtype=torch.bfloat16, device="cuda")
    tables = torch.arange(bpp, dtype=torch.int32, device="cuda")[None, :]
    logits = LM.mixed_step(
        cfg, engine.params, prompt, cache, tables, torch.tensor([0], device="cuda"),
        torch.tensor([prompt.shape[1]], device="cuda"), scfg.block_size,
    )
    if tuple(logits.shape) != (1, prompt.shape[1], cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        fail(f"full-width logits: shape {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    print(f"  full-width logits {tuple(logits.shape)} all finite", flush=True)
    del cache, logits

    # retrieval and contexts: the card's run against the CPU run (plain versions)
    cpu_ctx = full_width_system(16, "cpu", SEED, generate=False)[0].orchestrator
    ref = cpu_ctx.aggregate_batch(texts, cpu_ctx.collect_contexts_batch(texts))
    for r, c in zip(results, ref):
        if list(r["context"]["chunk_ids"]) != list(c["chunk_ids"]):
            fail("contexts on the card differ from the CPU run")
    print("  16 contexts equal to the CPU run", flush=True)

    # a smoke-width model on the card (kernels) against its CPU run (plain)
    small, p_cpu, p_gpu = small_model(torch, sys_.tok.vocab_size)
    prompts = [np.asarray(r["prompt"]).reshape(-1) for r in results[:4]]
    outs = {}
    for device, p in (("cpu", p_cpu), ("cuda", p_gpu)):
        eng = ServeEngine(small, p, ServeConfig(paged=True, max_batch=4, max_prompt_len=256,
                                                max_new_tokens=8, block_size=16), device=device)
        outs[device] = eng.serve_prompts(prompts)
    same = all(np.array_equal(a, b) for a, b in zip(outs["cpu"], outs["cuda"]))
    print(f"  smoke-width answers on the card equal the CPU run: {same}", flush=True)
    if not same:
        fail("smoke-width answers differ between the card and the CPU")
    return launches, results


CTX_TOL = 1e-3  # rerank scores, card f32 vs CPU f32 through 12 layers


def paper_phase(torch, smi: str) -> list[dict]:
    from repro_torch.launch.serve import paper_models_system

    # contriever-110m + bge-reranker-base at full width (bf16) + paged qwen3-0.6b
    reset_launches()
    t0 = time.perf_counter()
    sys_, engine, texts = paper_models_system(16, "cuda", SEED)
    torch.cuda.synchronize()
    n_chunks = [len(p.chunks) for p in sys_.providers]
    print(f"  built the paper-models system in {time.perf_counter() - t0:.1f} s "
          f"(index of {n_chunks} chunks x 40 tokens)", flush=True)
    built = read_launches("the providers' index build", ("flash_attention",))
    _, served = serve_phase(
        torch, smi, sys_, engine, texts,
        "paper models (contriever-110m + bge-reranker-base bf16, paged qwen3-0.6b bf16)",
        ("retrieval_topk", "flash_attention", "mixed_prefill"),
    )
    del sys_, engine

    # contexts: an f32 build on the card against the same build on the CPU
    ctx = {}
    for device in ("cuda", "cpu"):
        orch = paper_models_system(16, device, SEED, generate=False, encoder_dtype="float32")[0].orchestrator
        ctx[device] = orch.aggregate_batch(texts, orch.collect_contexts_batch(texts))
    worst, skipped = match_contexts(ctx["cuda"], ctx["cpu"], "paper-models")
    print(f"  16 f32 contexts equal to the CPU run (rerank scores within {worst:.3e}, "
          f"{skipped} near-tie places set aside)", flush=True)
    return [built, served]


def match_contexts(card: list, cpu: list, what: str) -> tuple[float, int]:
    """Contexts of a card run against the CPU run's: chunk ids equal, except
    where the CPU's rerank scores are a near-tie; scores within CTX_TOL.
    Returns (the largest score difference, the near-tie places)."""
    worst, skipped = 0.0, 0
    for g, c in zip(card, cpu, strict=True):
        g_sc, c_sc = [float(x) for x in g["scores"]], [float(x) for x in c["scores"]]
        worst = max([worst] + [abs(a - b) for a, b in zip(g_sc, c_sc)])
        for j, (gi, ci) in enumerate(zip(g["chunk_ids"], c["chunk_ids"])):
            if gi == ci:
                continue
            # ids may swap only where the CPU's scores are a near-tie (a
            # neighbour within tolerance, or the last place, whose
            # runner-up the context does not carry)
            near = j == len(c_sc) - 1 or any(
                0 <= i < len(c_sc) and abs(c_sc[i] - c_sc[j]) <= 2 * CTX_TOL for i in (j - 1, j + 1)
            )
            if not near:
                fail(f"{what} context differs from the CPU run at place {j}: {list(g['chunk_ids'])} vs "
                     f"{list(c['chunk_ids'])}, CPU scores {c_sc}")
            skipped += 1
    if worst > CTX_TOL:
        fail(f"{what} rerank scores differ from the CPU run by {worst:.3e} (tol {CTX_TOL:g})")
    return worst, skipped


def contiguous_phase(torch, smi: str) -> dict:
    import numpy as np

    from repro_torch.launch.serve import full_width_system
    from repro_torch.serving.engine import ServeConfig, ServeEngine, engine_generator

    sys_, engine, texts = full_width_system(16, "cuda", SEED, paged=False)
    results, launches = serve_phase(
        torch, smi, sys_, engine, texts, "contiguous qwen3-0.6b full width bf16, bag embedder",
        ("retrieval_topk", "flash_attention", "flash_decode"),
    )
    prompts = [np.asarray(r["prompt"]).reshape(-1) for r in results[:4]]
    vocab = sys_.tok.vocab_size
    del sys_, engine

    # smoke width, f32: contiguous == paged == lock-step on the card, and
    # the card's contiguous tokens == the CPU run's
    small, p_cpu, p_gpu = small_model(torch, vocab)
    kw = dict(max_batch=4, max_prompt_len=256, max_new_tokens=8)
    cont = ServeEngine(small, p_gpu, ServeConfig(**kw), device="cuda").serve_prompts(prompts)
    paged = ServeEngine(small, p_gpu, ServeConfig(paged=True, block_size=16, **kw), device="cuda").serve_prompts(prompts)
    lock = engine_generator(ServeEngine(small, p_gpu, ServeConfig(**kw), device="cuda"), mode="lockstep")
    lock = lock.generate_batch(prompts)
    cpu = ServeEngine(small, p_cpu, ServeConfig(**kw), device="cpu").serve_prompts(prompts)
    checks = {
        "paged": all(np.array_equal(a, b) for a, b in zip(cont, paged)),
        # lock-step decodes every row to the cap (PAD after EOS)
        "lock-step": all(np.array_equal(a, b[: len(a)]) for a, b in zip(cont, lock)),
        "CPU": all(np.array_equal(a, b) for a, b in zip(cont, cpu)),
    }
    print(f"  smoke-width contiguous tokens on the card equal: {checks}", flush=True)
    if not all(checks.values()):
        fail(f"smoke-width contiguous tokens differ: {checks}")
    return launches


def mamba2_phase(torch, smi: str) -> dict:
    import numpy as np

    from repro_torch.launch.serve import full_width_system
    from repro_torch.models import lm as LM
    from repro_torch.serving.engine import ServeConfig, ServeEngine, engine_generator

    # mamba2-1.3b at full width, 48 layers, bf16 activations, f32 SSM state
    sys_, engine, texts = full_width_system(16, "cuda", SEED, paged=False, arch="mamba2-1.3b")
    results, launches = serve_phase(
        torch, smi, sys_, engine, texts, "contiguous mamba2-1.3b full width bf16, bag embedder",
        ("retrieval_topk", "ssd_chunk"),
    )
    cfg = engine.cfg
    prompt = torch.as_tensor(np.asarray(results[0]["prompt"]).reshape(1, -1), device="cuda")
    logits, _ = LM.forward(cfg, engine.params, {"tokens": prompt})
    if tuple(logits.shape) != (1, prompt.shape[1], cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        fail(f"mamba2 full-width logits: shape {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    print(f"  mamba2 full-width logits {tuple(logits.shape)} all finite", flush=True)
    prompts = [np.asarray(r["prompt"]).reshape(-1) for r in results[:4]]
    vocab = sys_.tok.vocab_size
    del sys_, engine, logits

    # smoke width (ssd_chunk 16: a 256-wide prefill runs 16 chunks), f32:
    # contiguous == lock-step on the card, and the card's tokens == the CPU run's
    small, p_cpu, p_gpu = small_model(torch, vocab, "mamba2-1.3b")
    kw = dict(max_batch=4, max_prompt_len=256, max_new_tokens=8)
    cont = ServeEngine(small, p_gpu, ServeConfig(**kw), device="cuda").serve_prompts(prompts)
    lock = engine_generator(ServeEngine(small, p_gpu, ServeConfig(**kw), device="cuda"), mode="lockstep")
    lock = lock.generate_batch(prompts)
    cpu = ServeEngine(small, p_cpu, ServeConfig(**kw), device="cpu").serve_prompts(prompts)
    checks = {
        "lock-step": all(np.array_equal(a, b[: len(a)]) for a, b in zip(cont, lock)),
        "CPU": all(np.array_equal(a, b) for a, b in zip(cont, cpu)),
    }
    print(f"  smoke-width mamba2 tokens on the card equal: {checks}", flush=True)
    if not all(checks.values()):
        fail(f"smoke-width mamba2 tokens differ: {checks}")
    return launches


# --------------------------------------------------------------------- #
# phases 8-10: the prefix cache, the pipelined front door, Table 1
# --------------------------------------------------------------------- #


def rounding_tie(torch, engine, prompt, prefix, contiguous: bool = False) -> tuple[bool, float, float]:
    """Whether the token after ``prompt + prefix`` is decided by rounding on
    the card: its logits, computed the ways the engines compute a decode
    token (a lane of one mixed step over the whole sequence; a decode step
    after a mixed step over the rest; with ``contiguous``, also the
    contiguous engine's: a prefill over the prompt padded to
    ``max_prompt_len`` for the first token, a contiguous decode step after
    a prefill of the rest for a later one), differ by at least half their
    top-2 gap.  Returns (tie, gap, largest difference)."""
    import numpy as np

    from repro_torch.models import lm as LM

    cfg, bs, params = engine.cfg, engine.scfg.block_size, engine.params
    seq = torch.as_tensor(np.concatenate([prompt, prefix]).astype(np.int32)[None], device="cuda")
    n = seq.shape[1]
    nb = -(-(n + 1) // bs)
    i32 = dict(dtype=torch.int32, device="cuda")
    tables = torch.arange(nb, **i32)[None, :]
    zero = torch.zeros((1,), **i32)
    with torch.no_grad():
        cache = LM.init_paged_cache(cfg, nb + 1, bs, dtype=torch.bfloat16, device="cuda")
        a = LM.mixed_step(cfg, params, seq, cache, tables, zero, torch.tensor([n], **i32), bs)[0, n - 1].float()
        cache = LM.init_paged_cache(cfg, nb + 1, bs, dtype=torch.bfloat16, device="cuda")
        LM.mixed_step(cfg, params, seq[:, : n - 1], cache, tables, zero, torch.tensor([n - 1], **i32), bs)
        b = LM.decode_step(cfg, params, cache, seq[:, n - 1 :], torch.tensor([n - 1], **i32),
                           block_tables=tables, block_size=bs)[0, -1].float()
        ways = [a, b]
        if contiguous:
            width = engine.scfg.max_prompt_len
            m = n if len(prefix) == 0 else n - 1  # the prefilled positions
            padded = torch.zeros((1, width), **i32)
            padded[0, :m] = seq[0, :m]
            logits, cache = LM.prefill(cfg, params, {"tokens": padded}, cache_len=width + engine.scfg.max_new_tokens)
            if len(prefix) == 0:
                ways.append(logits[0, n - 1].float())
            else:
                ways.append(LM.decode_step(cfg, params, cache, seq[:, n - 1 :], torch.tensor([n - 1], **i32))[0, -1].float())
    top = torch.topk(a, 2).values
    gap = (top[0] - top[1]).item()
    diff = max((x - y).abs().max().item() for i, x in enumerate(ways) for y in ways[i + 1 :])
    return gap <= 2 * diff, gap, diff


def same_answers(want: list, got: list, what: str, engine=None, contiguous: bool = False) -> None:
    """Every query's answer tokens equal; prints, then fails on, the queries
    that differ, each with its first differing place.  With ``engine`` (runs
    whose engine steps were composed differently, so that a row's decode
    token may come from a mixed step in one run and a decode step in the
    other) a query may differ from a later place than its first token,
    where ``rounding_tie`` finds the token decided by rounding; with
    ``contiguous`` (one of the runs on the contiguous engine, whose first
    token comes from a packed prefill) at its first token too."""
    import numpy as np
    import torch

    diff = {}
    for i, (a, b) in enumerate(zip(want, got, strict=True)):
        a, b = list(a["answer_tokens"]), list(b["answer_tokens"])
        if a != b:
            diff[i] = next((j for j in range(min(len(a), len(b))) if a[j] != b[j]), min(len(a), len(b)))
    print(f"  {what}: {len(want) - len(diff)}/{len(want)} queries' tokens equal"
          + (f"; first differing place by query {diff}" if diff else ""), flush=True)
    for i, j in diff.items():
        if engine is None or (j == 0 and not contiguous):
            fail(f"{what}: answer tokens differ")
        prompt = np.asarray(want[i]["prompt"]).reshape(-1)
        tie, gap, d = rounding_tie(torch, engine, prompt, np.asarray(want[i]["answer_tokens"][:j]), contiguous)
        print(f"    query {i}, place {j}: top-2 gap {gap:.4e}, the two step kinds' logits differ by up to "
              f"{d:.4e}: {'decided by rounding' if tie else 'NOT a rounding tie'}", flush=True)
        if not tie:
            fail(f"{what}: query {i} differs at place {j} where its top-2 gap ({gap:.4e}) exceeds rounding ({d:.4e})")


def prefix_phase(torch, smi: str, cold: list) -> list[dict]:
    """[8] the phase-4 configuration with the prefix cache, served twice on
    one resident engine; then with a small pool and the host spill tier."""
    from repro_torch.launch.serve import full_width_system
    from repro_torch.serving.kv_cache import blocks_for

    need = ("retrieval_topk", "mixed_prefill", "paged_decode")
    runs = []

    def repeats(sys_, engine, texts, tag):
        sys_.serve(texts[:2], max_new_tokens=2)  # warm-up
        engine.reset_cache()  # start cold: the warm-up's prompts seed nothing
        out = []
        for rep in (1, 2):
            res, launches = serve_phase(torch, smi, sys_, engine, texts, f"{tag}, repeat {rep}", need, warm_up=False)
            st = sys_.last_serve_stats
            lats = sorted(r["latency_s"] for r in res)
            print(f"  {tag} repeat {rep}: prefix hits {st['prefix_hits']}/{st['prefix_lookups']}, prefill tokens "
                  f"{st['prefill_tokens'] - st['prefill_tokens_saved']} of {st['prefill_tokens']} "
                  f"({st['prefill_tokens_saved']} saved), {st['mixed_dispatches']} mixed + "
                  f"{st['decode_dispatches']} decode dispatches, mixed_prefill launches {launches['mixed_prefill']}, "
                  f"p50 {lats[len(lats) // 2] * 1e3:.1f} ms", flush=True)
            runs.append(launches)
            out.append((res, st))
        return out

    # a pool of two waves of max_batch rows' blocks, so that every prompt's
    # chain stays cached (the default pool, one wave, holds only the second
    # wave's chains, which the first wave's admissions evict in repeat 2)
    per_row = blocks_for(256 + 16, 32)
    sys_, engine, texts = full_width_system(16, "cuda", SEED, prefix_cache=True, n_pool_blocks=2 * 8 * per_row)
    (r1, st1), (r2, st2) = repeats(sys_, engine, texts, "prefix cache")
    # the same engine steps as phase 4 (repeat 1 finds nothing cached): the
    # same bits; repeat 2's steps differ (short tails), so a decode token may
    # come from another step kind
    same_answers(cold, r1, "prefix cache repeat 1 against phase 4 (cache off)")
    same_answers(r1, r2, "prefix cache repeat 2 (warm) against repeat 1", engine)
    if st2["prefix_hits"] * 16 < 15 * st2["prefix_lookups"]:
        fail(f"prefix cache repeat 2 hit {st2['prefix_hits']}/{st2['prefix_lookups']} prompts, want >= 15/16")
    if st2["mixed_dispatches"] >= st1["mixed_dispatches"]:
        fail("prefix cache repeat 2 took no fewer mixed dispatches than repeat 1")
    del sys_, engine, r1, r2
    gc.collect()
    torch.cuda.empty_cache()

    # a pool of max_batch rows' blocks plus 8: repeat 1's parked chains are
    # demoted to the host tier as later prompts need their blocks
    n_pool = 8 * per_row + 8
    sys_, engine, texts = full_width_system(16, "cuda", SEED, prefix_cache=True, spill_bytes=512 << 20,
                                            n_pool_blocks=n_pool)
    (_, _), (s2, st) = repeats(sys_, engine, texts, "spill tier")
    index, store = engine._index, engine._spill_store
    print(f"  spill tier: pool {n_pool} blocks, cache_nbytes {engine.cache_nbytes() / 2**20:.1f} MiB, "
          f"{index.n_demotions} demotions and {index.n_readmits} readmits over both repeats, "
          f"{store.used_bytes / 2**20:.1f} MiB of 512 on the host now, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]", flush=True)
    if not (index.n_demotions > 0 and index.n_readmits > 0 and st["spill_readmits"] > 0):
        fail(f"spill tier: {index.n_demotions} demotions, {index.n_readmits} readmits")
    same_answers(cold, s2, "spill tier repeat 2 (readmitted chains) against phase 4", engine)
    vocab = sys_.tok.vocab_size
    del sys_, engine, s2
    gc.collect()
    torch.cuda.empty_cache()

    # smoke width, f32, on the card: the phase-4 prompts, cache off, warm
    # and through the spill tier, all the same tokens
    import numpy as np

    from repro_torch.serving.engine import ServeConfig, ServeEngine

    small, _, p_gpu = small_model(torch, vocab)
    prompts = [np.asarray(r["prompt"]).reshape(-1) for r in cold]
    kw = dict(paged=True, max_batch=4, max_prompt_len=256, max_new_tokens=8, block_size=16)
    per_row = blocks_for(256 + 8, 16)
    off = ServeEngine(small, p_gpu, ServeConfig(**kw), device="cuda").serve_prompts(prompts)
    checks = {}
    for name, extra in (("warm", dict(n_pool_blocks=16 * per_row)),
                        ("spill", dict(n_pool_blocks=4 * per_row + 8, spill_bytes=64 << 20))):
        eng = ServeEngine(small, p_gpu, ServeConfig(prefix_cache=True, **kw, **extra), device="cuda")
        outs = [eng.serve_prompts(prompts) for _ in range(2)]
        checks[name] = all(np.array_equal(a, b) for o in outs for a, b in zip(off, o))
        tier = f", {eng._index.n_demotions} demotions, {eng._index.n_readmits} readmits" if name == "spill" else ""
        print(f"  smoke width f32 on the card, {name}: {eng.prefix_hits}/{eng.prefix_lookups} hits{tier}; "
              f"both repeats' tokens equal the cache-off engine's: {checks[name]}", flush=True)
        if name == "spill" and not (eng._index.n_demotions and eng._index.n_readmits):
            fail("smoke-width spill run: nothing demoted or readmitted")
    if not all(checks.values()):
        fail(f"smoke-width prefix-cache tokens differ from the cache-off engine's: {checks}")
    return runs


def stream_phase(torch, smi: str, cold: list) -> list[dict]:
    """[9] the phase-4 system through ``serve`` and then the pipelined
    ``serve_stream`` (micro-batches of 4, two tenants)."""
    from repro_torch.launch.serve import full_width_system, parse_tenant_spec

    need = ("retrieval_topk", "mixed_prefill", "paged_decode")
    sys_, engine, texts = full_width_system(16, "cuda", SEED)
    _, served = serve_phase(torch, smi, sys_, engine, texts, "serve, for the stream's comparison", need)
    weights, prios = parse_tenant_spec("interactive=4:1,batch=1")
    names = list(weights)
    tenants = [names[i % len(names)] for i in range(len(texts))]

    def stream(texts):
        out = [None] * len(texts)
        for qidx, r in sys_.serve_stream(texts, collect_batch=4, tenants=tenants,
                                         priorities=[prios[t] for t in tenants], tenant_weights=weights):
            if out[qidx] is not None:
                fail(f"serve_stream yielded query {qidx} twice")
            out[qidx] = r
        if any(r is None for r in out):
            fail("serve_stream did not yield every query")
        return out

    res, streamed = serve_phase(torch, smi, sys_, engine, texts, "serve_stream, collect_batch 4, two tenants",
                                need, warm_up=False, serve=stream)
    print("  serve_stream yielded every query exactly once", flush=True)
    for r, c in zip(res, cold):
        if list(r["context"]["chunk_ids"]) != list(c["context"]["chunk_ids"]):
            fail("serve_stream contexts differ from phase 4's serve")
    print("  serve_stream contexts equal to phase 4's", flush=True)
    # micro-batches and tenants admit in another order than phase 4's serve,
    # so a row's decode token may come from another step kind
    same_answers(cold, res, "serve_stream against phase 4's serve", engine)
    for name, ts in sorted(sys_.last_serve_stats["tenants"].items()):
        print(f"  tenant {name}: {ts['n_done']} done, {ts['n_expired']} expired, {ts.get('n_admitted', 0)} "
              f"admitted, p50 {ts['p50_s'] * 1e3:.1f} ms, p95 {ts['p95_s'] * 1e3:.1f} ms", flush=True)

    # smoke width, f32, on the card: serve_stream == serve, token for token
    import numpy as np

    from repro_torch.serving.engine import ServeConfig, ServeEngine, engine_generator

    small, _, p_gpu = small_model(torch, sys_.tok.vocab_size)
    sys_.orchestrator.generator = engine_generator(ServeEngine(
        small, p_gpu, ServeConfig(paged=True, max_batch=4, max_prompt_len=256, max_new_tokens=8, block_size=16),
        device="cuda"))
    del engine
    gc.collect()
    want = sys_.serve(texts)
    got = stream(texts)
    same = all(np.array_equal(a["answer_tokens"], b["answer_tokens"]) for a, b in zip(want, got))
    print(f"  smoke width f32 on the card: serve_stream tokens equal serve's: {same}", flush=True)
    if not same:
        fail("smoke-width serve_stream tokens differ from serve's")
    return [served, streamed]


def table1_phase(torch, smi: str) -> list[dict]:
    """[10] Table 1 on the card against the CPU run; the paper's models,
    federated against centralized; a selector-routed ``answer_batch``."""
    from repro_torch.core.advanced import ProviderSelector
    from repro_torch.core.pipeline import CFedRAGConfig, centralized_system
    from repro_torch.launch import table1
    from repro_torch.launch.serve import full_width_system, paper_models_system

    reset_launches()
    card = table1.run(device="cuda")
    runs = [read_launches("the Table-1 run", ("retrieval_topk",))]
    cpu = table1.run(device="cpu")
    for a, b in zip(card, cpu, strict=True):
        print(f"  {a['method']:30s} recall@8 {a['recall_at_8']:.4f} MRR {a['mrr']:.4f} "
              f"({a['us_per_query']:.1f} us/query; CPU {b['recall_at_8']:.4f} / {b['mrr']:.4f})", flush=True)
        if (a["method"], a["recall_at_8"], a["mrr"]) != (b["method"], b["recall_at_8"], b["mrr"]):
            fail(f"Table 1 row {a['method']} differs from the CPU run")
    for name, (ok, lhs, rhs) in table1.claim_checks(card).items():
        print(f"  claim {name}: {ok} ({lhs:.3f} vs {rhs:.3f})", flush=True)
        if not ok:
            fail(f"Table-1 claim fails on the card: {name}")

    # the paper's models, federated and centralized: bf16 on the card (the
    # served dtype), then f32 on the card against f32 on the CPU
    recall, ctx = {}, {}
    for device, dt in (("cuda", "bfloat16"), ("cuda", "float32"), ("cpu", "float32")):
        if device == "cuda" and dt == "bfloat16":
            reset_launches()
        fed, _, texts = paper_models_system(16, device, SEED, generate=False, encoder_dtype=dt)
        cent = centralized_system(fed.corpus, CFedRAGConfig(device=device), tokenizer=fed.tok,
                                  embed_fn=fed.embed_fn, reranker=fed.orchestrator.reranker)
        for name, s in (("federated", fed), ("centralized", cent)):
            orch = s.orchestrator
            ctx[device, dt, name] = orch.aggregate_batch(texts, orch.collect_contexts_batch(texts))
            r = s.eval_retrieval(16)
            recall[device, dt, name] = (r["recall_at_n"], r["mrr"])
        if device == "cuda" and dt == "bfloat16":
            runs.append(read_launches("the paper models' federated and centralized runs",
                                      ("retrieval_topk", "flash_attention")))
        del fed, cent
    for (device, dt, name), (rc, mrr) in recall.items():
        print(f"  paper models {name} on {device} {dt}: recall@8 {rc:.4f}, MRR {mrr:.4f}", flush=True)
    for name in ("federated", "centralized"):
        worst, skipped = match_contexts(ctx["cuda", "float32", name], ctx["cpu", "float32", name],
                                        f"paper models {name}")
        print(f"  paper models {name}: 16 f32 contexts equal to the CPU run (rerank scores within {worst:.3e}, "
              f"{skipped} near-tie places set aside)", flush=True)

    # one answer_batch routed by the provider selector to one provider
    picks = {}
    for device in ("cuda", "cpu"):
        s, _, texts = full_width_system(16, device, SEED, generate=False)
        sel = ProviderSelector(s.providers, s.embed_fn)
        s.orchestrator.selector, s.orchestrator.selector_top_p = sel, 1
        if device == "cuda":
            reset_launches()
        res = s.answer_batch(texts)
        if device == "cuda":
            runs.append(read_launches("the selector-routed answer_batch", ("retrieval_topk",)))
        chosen = [sel.select(s.tok.encode(t, max_len=24), s.providers, 1)[0].provider_id for t in texts]
        for r, c in zip(res, chosen):
            if set(int(x) for x in r["context"]["providers"]) != {c}:
                fail(f"selector-routed context on {device} holds chunks of providers "
                     f"{sorted(set(int(x) for x in r['context']['providers']))}, selected {c}")
        picks[device] = (chosen, [list(r["context"]["chunk_ids"]) for r in res])
    print(f"  selector (top_p 1) picks on the card {picks['cuda'][0]}, equal to the CPU run's: "
          f"{picks['cuda'] == picks['cpu']}; every context from its provider alone", flush=True)
    if picks["cuda"] != picks["cpu"]:
        fail("the selector's picks or contexts on the card differ from the CPU run")
    return runs


# --------------------------------------------------------------------- #
# phases 11-12: speculative decoding, the MoE family
# --------------------------------------------------------------------- #


def free_device(torch) -> None:
    """Drop what earlier phases left: their systems sit in reference cycles,
    and the allocator keeps their segments cached."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def spec_gauges(st: dict, label: str) -> str:
    line = (f"  {label}: {st['spec_rounds']} rounds, {st['draft_dispatches']} drafter + "
            f"{st['draft_fill_dispatches']} drafter-fill + {st['mixed_dispatches']} mixed + {st['decode_dispatches']} "
            f"decode dispatches, {st['spec_tokens_proposed']} drafts proposed, {st['spec_tokens_accepted']} accepted, "
            f"{st['spec_tokens_emitted']} tokens emitted: accept rate {st.get('spec_accept_rate', 0.0):.4f}, "
            f"{st.get('spec_tokens_per_round', 0.0):.3f} tokens/round, "
            f"{st.get('dispatches_per_spec_round', 0.0):.3f} dispatches/round, drafter pool "
            f"{st['min_draft_free_blocks']} blocks free at its lowest")
    print(line, flush=True)
    return line


def spec_phase(torch, smi: str, cold: list, timer, rows: dict) -> list[dict]:
    """[11] speculative decoding on the paged engine: (a) self-speculation
    in the phase-4 configuration; (b) qwen3-4b plain, then verified against
    a qwen3-0.6b drafter; (c) smoke width, f32, spec == plain."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import full_width_system
    from repro_torch.models import lm as LM
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import ServeConfig, ServeEngine, engine_generator

    runs = []
    # (a) qwen3-0.6b drafting for itself, draft_k = 3; the first verify
    # dispatch's descriptors and tables are recorded for the kernel row
    sys_, engine, texts = full_width_system(16, "cuda", SEED, draft_k=3)
    first: dict = {}
    step = engine._spec_mixed_rows

    def record(st, tok, q_start_h, q_len, is_spec, drafts, row_len, b_new, tables):
        if not first and bool((is_spec & (q_len > 1)).any()):
            q_start = torch.where(is_spec, st[1] + st[2] - 1, q_start_h)
            first["desc"] = [(i, a, n, a + n) for i, (a, n) in enumerate(zip(q_start.tolist(), q_len.tolist()))]
            first["tables"] = tables.clone()
        return step(st, tok, q_start_h, q_len, is_spec, drafts, row_len, b_new, tables)

    engine._spec_mixed_rows = record
    res, launches = serve_phase(torch, smi, sys_, engine, texts, "self-speculation, qwen3-0.6b full width bf16, "
                                "draft_k 3", ("retrieval_topk", "mixed_prefill"))
    runs.append(launches)
    st = sys_.last_serve_stats
    spec_gauges(st, "self-speculation")
    print(f"  self-speculation: mixed_prefill launches {launches['mixed_prefill']}, paged_decode launches "
          f"{launches['paged_decode']}", flush=True)
    if not (st["spec_rounds"] > 0 and st["spec_tokens_accepted"] > 0 and st["decode_dispatches"] == 0
            and st["draft_dispatches"] <= st["spec_rounds"]):
        fail(f"self-speculation gauges: {st}")
    for r, c in zip(res, cold):
        if list(r["context"]["chunk_ids"]) != list(c["context"]["chunk_ids"]):
            fail("self-speculation contexts differ from phase 4's")
    print("  self-speculation contexts equal to phase 4's", flush=True)
    # verify lanes are mixed-step lanes where phase 4 decoded with decode steps
    same_answers(cold, res, "self-speculation against phase 4 (plain)", engine)
    print(f"  the first verify dispatch: (q_start, q_len, kv_len) by row {[d[1:] for d in first['desc']]}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows["mixed_prefill", "bfloat16", "verify"] = row = mixed_prefill_row(
        torch, timer, gen, first["desc"], first["tables"], engine._n_pool_blocks + 1, 16, 8, "bfloat16",
        "the first verify dispatch of the self-speculation serve")
    print_row("mixed_prefill", row)
    prompts = [np.asarray(r["prompt"]).reshape(-1) for r in res[:4]]
    vocab = sys_.tok.vocab_size
    del sys_, engine, res
    free_device(torch)

    # (b) qwen3-4b verified against a qwen3-0.6b drafter of another seed;
    # the plain engine runs over the same parameter tensors
    q06 = get_config("qwen3-0.6b")
    dparams = init_params(LM.param_specs(q06), torch.Generator(device="cuda").manual_seed(SEED + 1), device="cuda")
    sys_, spec_eng, texts = full_width_system(16, "cuda", SEED, arch="qwen3-4b", draft_k=3, draft_config=q06,
                                              draft_params=dparams)
    plain_eng = ServeEngine(spec_eng.cfg, spec_eng.params, ServeConfig(paged=True, max_batch=8, max_prompt_len=256,
                                                                        max_new_tokens=16))
    spec_gen = sys_.orchestrator.generator
    sys_.orchestrator.generator = engine_generator(plain_eng)
    plain, launches = serve_phase(torch, smi, sys_, plain_eng, texts, "qwen3-4b full width bf16, plain",
                                  ("retrieval_topk", "mixed_prefill", "paged_decode"))
    runs.append(launches)
    plain_eng.reset_cache()
    sys_.orchestrator.generator = spec_gen
    spec, launches = serve_phase(torch, smi, sys_, spec_eng, texts, "qwen3-4b full width bf16, draft_k 3, "
                                 "qwen3-0.6b drafter (seed 1)", ("retrieval_topk", "mixed_prefill"))
    runs.append(launches)
    st = sys_.last_serve_stats
    spec_gauges(st, "qwen3-4b <- qwen3-0.6b")
    if not (st["spec_rounds"] > 0 and st["decode_dispatches"] == 0):
        fail(f"qwen3-4b speculation gauges: {st}")
    same_answers(plain, spec, "qwen3-4b speculative against plain", plain_eng)
    del sys_, spec_eng, plain_eng, spec_gen, dparams, plain, spec
    free_device(torch)

    # (c) smoke width, f32, on the card: spec == plain, token for token,
    # with and without the prefix cache (two repeats on the warm engine)
    small, _, p_gpu = small_model(torch, vocab)
    kw = dict(paged=True, max_batch=4, max_prompt_len=256, max_new_tokens=8, block_size=16)
    want = ServeEngine(small, p_gpu, ServeConfig(**kw), device="cuda").serve_prompts(prompts)
    checks = {}
    for name, extra in (("spec", {}), ("spec + prefix cache", dict(prefix_cache=True))):
        eng = ServeEngine(small, p_gpu, ServeConfig(draft_k=3, **kw, **extra), device="cuda")
        outs = [eng.serve_prompts(prompts) for _ in range(2 if extra else 1)]
        checks[name] = all(np.array_equal(a, b) for o in outs for a, b in zip(want, o))
        print(f"  smoke width f32 on the card, {name}: {eng.spec_rounds} rounds, {eng.spec_tokens_accepted}/"
              f"{eng.spec_tokens_proposed} drafts accepted, {eng.prefix_hits} prefix hits; tokens equal plain's: "
              f"{checks[name]}", flush=True)
    if not all(checks.values()):
        fail(f"smoke-width speculative tokens differ from plain: {checks}")
    return runs


def moe_phase(torch, smi: str, cold: list) -> list[dict]:
    """[12] qwen2-moe-a2.7b at full width, on the paged engine and then on
    the contiguous engine over the same parameter tensors."""
    import numpy as np

    from repro_torch.launch.serve import full_width_system
    from repro_torch.models import lm as LM
    from repro_torch.models import moe as MOE
    from repro_torch.models.params import map_tree, param_bytes
    from repro_torch.serving.engine import ServeConfig, ServeEngine, engine_generator

    free_device(torch)
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    sys_, engine, texts = full_width_system(16, "cuda", SEED, arch="qwen2-moe-a2.7b")
    torch.cuda.synchronize()
    cfg = engine.cfg
    print(f"  built qwen2-moe-a2.7b ({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads of {cfg.resolved_head_dim}, {cfg.n_experts} experts allocated as "
          f"{engine.params['blocks']['pos0']['moe']['wg'].shape[1]}, top-{cfg.moe_top_k}, d_ff {cfg.moe_d_ff}, "
          f"{cfg.n_shared_experts} shared) in {time.perf_counter() - t0:.1f} s: "
          f"{param_bytes(LM.param_specs(cfg)) / 1e9:.2f} GB of f32 weights; resident "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB (was {before / 2**30:.2f}), peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} [{smi}]", flush=True)
    runs = []
    paged, launches = serve_phase(torch, smi, sys_, engine, texts, "qwen2-moe-a2.7b full width bf16, paged",
                                  ("retrieval_topk", "mixed_prefill", "paged_decode"))
    runs.append(launches)
    for r, c in zip(paged, cold):
        if list(r["context"]["chunk_ids"]) != list(c["context"]["chunk_ids"]):
            fail("qwen2-moe contexts differ from phase 4's")
    print("  qwen2-moe contexts equal to phase 4's", flush=True)

    prompt = torch.as_tensor(np.asarray(paged[0]["prompt"]).reshape(1, -1), device="cuda")
    bs = engine.scfg.block_size
    bpp = -(-prompt.shape[1] // bs)
    cache = LM.init_paged_cache(cfg, bpp + 1, bs, dtype=torch.bfloat16, device="cuda")
    logits = LM.mixed_step(cfg, engine.params, prompt, cache, torch.arange(bpp, dtype=torch.int32, device="cuda")[None],
                           torch.tensor([0], device="cuda"), torch.tensor([prompt.shape[1]], device="cuda"), bs)
    if tuple(logits.shape) != (1, prompt.shape[1], cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        fail(f"qwen2-moe full-width logits: shape {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    print(f"  qwen2-moe full-width mixed_step logits {tuple(logits.shape)} all finite", flush=True)
    del cache, logits

    # one MoE layer at the mixed step's 2048 tokens, bf16, against the dense oracle
    p0 = map_tree(lambda t: t[0], engine.params["blocks"]["pos0"]["moe"])
    x = torch.randn(8, 256, cfg.d_model, generator=torch.Generator(device="cuda").manual_seed(SEED),
                    device="cuda").to(torch.bfloat16)
    out, aux = MOE.moe_apply(cfg, p0, x)
    ref, aux_r = MOE.moe_reference(cfg, p0, x)
    gate = torch.sigmoid((x @ p0["shared_gate"].to(x.dtype)).float())
    ref = ref + MOE.mlp_apply(cfg, p0["shared"], x) * gate.to(x.dtype)
    check(f"moe_apply layer 0, 2048 tokens bf16, vs moe_reference + shared (max |out| "
          f"{out.float().abs().max().item():.3f})", (out.float() - ref.float()).abs().max().item(), "bfloat16")
    if float(aux) != float(aux_r):
        fail(f"moe_apply aux {float(aux)} != moe_reference's {float(aux_r)}")
    del x, out, ref, gate, p0

    # the contiguous engine over the same parameter tensors
    engine.reset_cache()
    cont_eng = ServeEngine(cfg, engine.params, ServeConfig(max_batch=8, max_prompt_len=256, max_new_tokens=16))
    sys_.orchestrator.generator = engine_generator(cont_eng)
    cont, launches = serve_phase(torch, smi, sys_, cont_eng, texts, "qwen2-moe-a2.7b full width bf16, contiguous",
                                 ("retrieval_topk", "flash_attention", "flash_decode"))
    runs.append(launches)
    # another engine: other kernels, other matmul shapes, other expert groups
    same_answers(paged, cont, "qwen2-moe paged against contiguous", engine, contiguous=True)
    prompts = [np.asarray(r["prompt"]).reshape(-1) for r in paged[:4]]
    vocab = sys_.tok.vocab_size
    del sys_, engine, cont_eng, paged, cont
    free_device(torch)

    # smoke width (H = KV = 4, 8 experts), f32: paged == contiguous on the
    # card == the CPU run, token for token
    small, p_cpu, p_gpu = small_model(torch, vocab, "qwen2-moe-a2.7b")
    kw = dict(max_batch=4, max_prompt_len=256, max_new_tokens=8)
    cont = ServeEngine(small, p_gpu, ServeConfig(**kw), device="cuda").serve_prompts(prompts)
    pg = ServeEngine(small, p_gpu, ServeConfig(paged=True, block_size=16, **kw), device="cuda").serve_prompts(prompts)
    cpu = ServeEngine(small, p_cpu, ServeConfig(**kw), device="cpu").serve_prompts(prompts)
    checks = {"paged": all(np.array_equal(a, b) for a, b in zip(cont, pg)),
              "CPU": all(np.array_equal(a, b) for a, b in zip(cont, cpu))}
    print(f"  smoke-width qwen2-moe tokens on the card (contiguous) equal: {checks}", flush=True)
    if not all(checks.values()):
        fail(f"smoke-width qwen2-moe tokens differ: {checks}")
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-csrc", help="a directory holding an earlier commit's six kernel sources (csrc/*.cu), "
                    "their headers and its kernels/_build.py, timed beside the current kernels in phase 3")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", flush=True)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is false)", flush=True)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _build
    except ImportError:
        print("FAIL: the repro_torch package is not next to this script", flush=True)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    print("[1] device", flush=True)
    smi = nvidia_smi()
    print(f"  {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    print("[2] build", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"  built {len(_build.SIGNATURES)} kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    print_ptxas(_build.logs)
    parent = None
    if args.parent_csrc:
        t0 = time.perf_counter()
        parent = Parent(torch, Path(args.parent_csrc).resolve())
        print(f"  built the parent's {', '.join(Parent.NAMES)} from {args.parent_csrc} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        print_ptxas(parent.logs, " (parent)")

    print("[3] kernels against their plain versions", flush=True)
    t0 = time.perf_counter()
    timer = Timer(torch)
    print(f"  timer: median of 20 calls in turns; the spin before each call: {timer.cycles} cycles, "
          f"{timer.spin:.4f} ms; a row names the calls whose enqueue outlasted it (late)", flush=True)
    rows = kernel_phase(torch, timer, parent)
    print(f"  [3] took {time.perf_counter() - t0:.1f} s", flush=True)

    def phase(title: str, fn, *args):
        print(title, flush=True)
        t = time.perf_counter()
        out = fn(torch, smi, *args)
        print(f"  {title.split()[0]} took {time.perf_counter() - t:.1f} s", flush=True)
        return out

    launches, cold = phase("[4] end to end: paged engine, bag embedder", paged_phase)
    runs = [launches]
    runs += phase("[5] end to end: the paper's models", paper_phase)
    runs.append(phase("[6] end to end: contiguous engine", contiguous_phase))
    runs.append(phase("[7] end to end: mamba2-1.3b, contiguous engine", mamba2_phase))
    runs += phase("[8] end to end: the prefix cache and its host spill tier", prefix_phase, cold)
    runs += phase("[9] end to end: the pipelined serve_stream", stream_phase, cold)
    runs += phase("[10] Table 1, the paper's models federated and centralized, the provider selector", table1_phase)
    runs += phase("[11] speculative decoding: self-speculation, qwen3-4b with a qwen3-0.6b drafter", spec_phase,
                  cold, timer, rows)
    runs += phase("[12] the MoE family: qwen2-moe-a2.7b at full width, paged and contiguous", moe_phase, cold)

    meta = {
        "retrieval_topk": ("src/repro_torch/kernels/csrc/retrieval_topk.cu", "src/repro/kernels/retrieval_topk/kernel.py:105"),
        "mixed_prefill": ("src/repro_torch/kernels/csrc/mixed_prefill.cu", "src/repro/kernels/chunked_prefill/kernel.py:80"),
        "paged_decode": ("src/repro_torch/kernels/csrc/paged_decode.cu", "src/repro/kernels/decode_attention/kernel.py:160"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:68"),
        "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu", "src/repro/kernels/decode_attention/kernel.py:63"),
        "ssd_chunk": ("src/repro_torch/kernels/csrc/ssd_chunk.cu", "src/repro/kernels/ssd_scan/kernel.py:49"),
    }
    # one row per kernel at the dtype the path gives it (f32 provider
    # embeddings; bf16 activations, KV pool and encoders) and, for
    # flash_attention, its largest path shape (the rerank), with the
    # further path shapes beside it; launches are summed over the
    # main-path runs of phases 4-12
    path_row = {
        "retrieval_topk": ("retrieval_topk", "float32"), "mixed_prefill": ("mixed_prefill", "bfloat16"),
        "paged_decode": ("paged_decode", "bfloat16"), "flash_attention": ("flash_attention", "bfloat16", "rerank"),
        "flash_decode": ("flash_decode", "bfloat16"), "ssd_chunk": ("ssd_chunk", "bfloat16"),
    }
    kernels = []
    for name, (src, rep) in meta.items():
        row = rows[path_row[name]]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(r[name] for r in runs), "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"], "shape": row["shape"],
            **{k: row[k] for k in ("combine_err", "max_rel_err", "parent_ms") if row.get(k) is not None},
        })
        # the prefix cache's warm-admission shape, the first verify dispatch,
        # and qwen2-moe's heads (one query head per KV head), beside the path row
        for tag, key in (("warm_admission", "warm"), ("verify", "verify"), ("one_head_per_kv_head", "G=1")):
            extra = rows.get((name, "bfloat16", key))
            if extra is not None:
                kernels[-1][tag] = {k: extra[k] for k in (
                    "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")}
    if any(not math.isfinite(k["ms"]) for k in kernels):
        fail("a kernel time is not finite")
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
