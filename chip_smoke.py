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
              parent's build.  mixed_prefill is checked and timed in the
              packed form the serving path launches (q (N, H, dh), a lane
              offset a row), bitwise equal to the padded form over the same
              rows: at the step's mix above, the warm admission and
              qwen3-4b's admission step (32 / 8 heads of 128, one fill of
              1,057 lanes beside 31 decode rows: the kernels line's row);
              the padded form is timed at the step's mix as an extra row.
              Then, at qwen2-moe-a2.7b's heads (H = KV =
              16, one query head per KV head), mixed prefill at the step's
              mix above, paged decode, the causal admit prefill and
              flash-decode, checked and timed the same way; and verify rows
              (q_len 4 from the committed position) bitwise equal, lane by
              lane, to q_len = 1 rows at the same positions (f32 and bf16,
              G = 2 and G = 1); at jamba-1.5-large-398b's shapes (G = 8),
              the causal admit prefill (B=8, S=256, 64/8 heads of 128) and
              flash-decode (S=272), and ssd_chunk at B=8, L=256, 256 heads
              of 64, state 16, with B and C of 8 groups repeated per head,
              checked and timed the same way.  Training: flash_attention's output and
              gradient (the autograd Function: kernel forward, plain
              recompute backward) against the plain version's autograd at
              the train (B=8, S=256, 16/8 heads of 128, causal), HuBERT
              (B=4, S=256, 16 heads of 80) and contriever (16 x 40, 12 heads
              of 64) shapes, error over the largest entry at 2e-5 f32 and
              2e-2 bf16; the head_dim-80 forward timed against SDPA and the
              backward against the forward kernel and SDPA's backward;
              ssd_chunk's gradient at the shape above at 1e-4; the four
              serving kernels raise on an input that requires grad; with
              --parent-csrc, bf16 flash_attention at dh 16-128 bitwise equal
              to the parent's build;
4. paged      ``CFedRAGSystem.serve`` on 16 queries at the full width of
              qwen3-0.6b (28 layers, bf16, random weights from a seed) on
              the paged engine with the bag embedder, its first mixed
              dispatch's packed descriptors and tables recorded and
              mixed prefill checked and timed at them; then retrieval
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
              printed, and four queries' first-token top-2 gaps beside how
              far the step's shapes alone move those logits (the row alone,
              beside companion rows, and chunked); (c) smoke width, f32: spec == plain, token for token,
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
              printed;
13. train     qwen3-0.6b at full width (f32 master weights and AdamW moments,
              bf16 activations, remat per block) through the Trainer on
              LMBatchStream batches of 8 x 256: a straight run of 4 steps,
              and a run killed at step 3 and resumed from its step-1
              checkpoint, losses equal at rel 1e-5, every step's gradient
              norm finite and positive (a leaf the loss does not reach
              raises in value_and_grad); flash_attention launched at least
              forward + recompute times; 4 steps on one repeated batch
              through value_and_grad with the loss falling, every leaf's
              gradient finite and non-zero, each step split into forward /
              backward / update;
              mamba2-1.3b two steps on a repeated batch through ssd_chunk;
14. hubert    hubert-xlarge at full width (1.26 B parameters, head_dim 80),
              frames 4 x 256 at a 0.3 mask rate: loss_fn, two AdamW steps
              with finite, falling loss, embed_corpus; its first layer's q, k,
              v through the dh-80 kernel against the plain version, forward
              and gradient, bf16;
15. pixtral   pixtral-12b at full width (12.25 B parameters, 49.0 GB f32)
              with 64 patch embeddings on B=2, S=256: prefill's logits ==
              forward's, other patches move the logits, generate 8 tokens;
16. fedembed  the paper's §2.2: federated_train_embedder over the phase-4
              corpus's two providers, contriever-110m at full width (f32) as
              F_emb, InfoNCE on 16 (query, gold chunk) pairs per provider,
              clipped SGD; 3 rounds with secure aggregation and 3 plain:
              trajectories equal at rtol 1e-4, the loss falling; the masked
              exchange's host seconds; one rank_loss step of
              bge-reranker-base;
17. sharded   the sharded paths with every shard on the one card
              (``mesh=``): mixed_prefill's partials kernel, packed, at the
              phase-3 step's mix (bitwise the padded form's lanes) with an
              ``owned`` mask split row-affine over 4
              shards against its plain version (m, l and o / l at the
              dtype's tolerance), the 4 shards' partials combined bitwise
              equal to 1 shard's, the rows of other shards exact zeros with
              m = -1e30 (trash blocks poisoned with NaN and 1e4), timed;
              dist_decode over 2 and 4 shards against flash-decode on the
              whole cache (a row of length 0 gives 0), and one shard's
              exact-zero flash-decode partials, timed; federated top-k over
              4 providers at provider scale: ids equal and scores bitwise
              equal to the whole-corpus kernel, a dead provider's ids
              absent; then the phase-4 configuration on a pool of 144
              blocks at shards 1, 2 and 4: the same dispatches, N times the
              shards-1 mixed_prefill launches, tokens of 2 and 4 bitwise
              equal to 1's, and 1's equal to phase 4's but at rounding ties;
              the prefix cache with the spill tier on phase 8's tight pool
              at 4 shards against 1 (hits equal, chains demoted and
              readmitted, tokens equal but at rounding ties);
              self-speculation at 4 shards bitwise equal to 1; at smoke
              width in f32, shards 1, 2 and 4 on the card equal the CPU run;
18. hybrid    the phase-4 federation serving jamba-1.5-large-398b on the
              contiguous engine, after the earlier phases' models are freed:
              one scan period of 8 layers (attention, then 7 Mamba2 layers,
              MoE on the odd ones) with the routed experts' hidden width cut
              from 24,576 to 4,096 (12.93 B parameters, 51.7 GB of f32
              weights), every other width as published, bf16: statuses done,
              contexts == phase 4's, one prompt's full-width logits finite,
              flash_attention, flash_decode and ssd_chunk launched during the
              serve, a paged ServeConfig refused with a ValueError; at smoke
              width in f32, contiguous == lock-step tokens and the card's
              tokens == the CPU run's; resident and peak memory printed;
19. multidev  multi-device training with every mesh coordinate on the one
              card (one card stands in for several: the machinery's cost
              shows, not several cards' memory): qwen3-0.6b at full width
              (phase 13's settings) data-parallel through the Trainer on
              (2, 1) and (4, 1) ("data", "model") meshes of cuda:0, 3 steps
              each: step 0's loss within 1e-3 relative of the unsharded
              step's, the loss falling over 3 steps on one repeated batch,
              every gradient leaf finite and non-zero, the grad_pspecs (reduce-scatter) form bitwise the
              all-reduce form, each step split into forward + backward per
              shard, the rest (the reduction, the batch's placement) and
              the update; the elastic restore: a crash at step 2 on (2, 1)
              resumed through restore(shardings=) onto (4, 1) (each leaf
              bitwise the saved one, each block on its coordinate), its
              losses equal at rel 1e-5 to a run that changes mesh at step 2
              without a crash; mamba2-1.3b 2 steps on (2, 1) through
              ssd_chunk; qwen2-moe-a2.7b's expert parallelism on (2, 4),
              psum and a2a: one MoE layer at the published widths (60
              experts as 64, top-4, moe_d_ff 1408, 4 shared) against
              moe_reference at slack 8 (3e-5 of the largest output) and the
              CPU run at the config's slack (1e-5), its backward finite;
              a train step cut in depth from 24 to 2 layers, 2 AdamW
              steps per form; the expert loop's host syncs; at smoke width
              in f32, the DP and EP gradients on the card equal the CPU
              run's;
20. roofline  ``launch/dryrun.py``'s count on ``meta`` against the card:
              qwen3-0.6b's train step (phase 13's settings), its prefill
              and decode at phase 6's shapes, mamba2-1.3b's train step and
              qwen3-0.6b's on phase 19's (2, 1) mesh, each run on meta and
              on cuda:0 under ``launch/roofline.CostCounter``: FLOPs,
              bytes, conversions, collectives and kernel calls equal;
              flash_attention, ssd_chunk and flash_decode launched on the
              card, none on meta; each step timed (median of 5 after 2
              warm-ups) against its one-card bound: bound_s, measured_s,
              share and mfu printed, a share above 1.05 (a bound the card
              beats: a wrong count) fails; the counter's peak beside
              max_memory_allocated; the hillclimb baselines (A0, B0, C0)
              on the (16, 16) meta mesh each ok;
21. window    the sliding window at Mellum2-12B-A2.5B's heads (32 query
              heads over 4 KV heads, head_dim 128, window 1,024):
              ``mixed_prefill`` (a fill's chunk across the window's edge,
              one-lane rows around it; packed, bitwise the padded form)
              and ``paged_decode`` (lengths 1-2,240) against their plain
              versions, f32 and bf16; a window past every row bitwise the
              window-0 kernels; both timed in turns with their window-0
              launches at the cell's serving mix, with both bounds.

Each phase prints its seconds and peak memory.  Every kernel's launch
counter is set to 0 just before each main-path run (the serves, phase 5's
index build, phase 10's retrievals, the training runs and steps of
13-16 and 19, the sharded serves of 17, the serve of 18 and the counted
steps of 20) and read just after; a kernel of that path left at 0 fails
the run.

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
    for attention, hd 64 / ds 128 (mamba2) or 16 (jamba) for the SSD
    chunk, every top-k one."""
    if name == "ssd_chunk":
        return ("ssd_scores" in fn and fn.endswith((", 128>", ", 16>"))) or \
            re.search(r"ssd_chunk<\w+, 64, (128|16)>", fn) is not None
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
        """The entry point without the softmax scale's head_dim (22
        arguments) or with it (23; dh itself here)."""
        b, sq, h, dh = q.shape
        out = self.torch.empty_like(q)
        dims = (dh,) if len(self.fns["flash_attention"].argtypes) == 22 else (dh, dh)
        self._call("flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, k.shape[1], h,
                   k.shape[2], *dims, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
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
        (its o / m / l scratch besides; 26 arguments, or 27 with the
        empty-row rule, passed as the mean rule)."""
        b, h, dh = q.shape
        s, kv = kc.shape[1], kc.shape[2]
        out = self.torch.empty_like(q)
        head = (q.data_ptr(), kc.data_ptr(), vc.data_ptr(), lengths.data_ptr(), out.data_ptr(), 0, 0, 0)
        rule = (0,) if len(self.fns["flash_decode"].argtypes) == 27 else ()
        tail = (*kc.stride()[:3], *vc.stride()[:3], 0, *rule, int(q.dtype == self.torch.bfloat16))
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


def bound_of(cost) -> tuple[float, str]:
    """``bound`` of a kernel's cost hook, ``(FLOPs by operand dtype, bytes)``:
    the same arithmetic the cost counter records (``kernels/_build.py``)."""
    flops, nbytes = cost
    return bound(nbytes, *((f, dt) for dt, f in flops.items()))


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


def launch_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in counters().items()}


def read_launches(what: str, need) -> dict:
    got = launch_counts()
    print(f"  launches during {what}: {got}", flush=True)
    if any(got[n] == 0 for n in need):
        fail(f"a kernel of the path was never launched during {what}: {got}")
    return got


def packed_row(torch, timer, gen, desc_h: list, tables, kp, vp, h: int, label: str, tables_host=None,
               parent=None) -> dict:
    """``mixed_prefill`` in the packed form the serving path launches, over
    the rows of ``desc_h``: (slot, q_start, q_len, kv_len, q_off) as a step
    hands them to the kernel, or (slot, q_start, q_len, kv_len), whose rows
    with lanes are then packed back to back in order.  q (N, ``h``, dh)
    drawn from ``gen``; pools ``kp`` / ``vp`` and ``tables`` as given.
    Checked against its plain version (tolerance of the dtype) and bitwise
    against the padded form over the same rows (q (R, W, H, dh), W the
    longest row), then timed beside the plain version, SDPA over the
    padded views (library), the padded form (``padded_ms``) and, with
    ``parent``, the parent's padded build; the bound is what the packed
    descriptors need (with ``tables_host``, an aliased position read
    once)."""
    import torch.nn.functional as F

    from repro_torch.kernels.chunked_prefill import ops as cp

    dev = torch.device("cuda")
    rows4 = [tuple(int(x) for x in d[:4]) for d in desc_h if d[2] > 0]
    if len(desc_h[0]) == 5:
        offs = [int(d[4]) for d in desc_h if d[2] > 0]
    else:
        offs = [sum(d[2] for d in rows4[:i]) for i in range(len(rows4))]
    d5_h = [(*d, o) for d, o in zip(rows4, offs)]
    n = max(o + d[2] for d, o in zip(rows4, offs))
    r, w, dh, bs, kv = len(rows4), max(d[2] for d in rows4), kp.shape[3], kp.shape[1], kp.shape[2]
    d4 = torch.tensor(rows4, dtype=torch.int32, device=dev)
    d5 = torch.tensor(d5_h, dtype=torch.int32, device=dev)
    q = torch.randn(n, h, dh, generator=gen, device=dev).to(kp.dtype)
    o = cp.mixed_prefill_attention(q, kp, vp, tables, d5)
    err = (o.float() - cp.mixed_prefill_attention_plain(q, kp, vp, tables, d5).float()).abs().max().item()
    dtype = str(kp.dtype).removeprefix("torch.")
    check(f"mixed_prefill packed, {label} {dtype}", err, dtype)
    # the padded form over the same rows: row i's lanes at i * w
    at_r = torch.tensor([i for i, d in enumerate(rows4) for _ in range(d[2])], device=dev)
    at_j = torch.tensor([j for d in rows4 for j in range(d[2])], device=dev)
    at_n = torch.tensor([o_ + j for d, o_ in zip(rows4, offs) for j in range(d[2])], device=dev)
    qp = torch.zeros((r, w, h, dh), dtype=q.dtype, device=dev)
    qp[at_r, at_j] = q[at_n]
    op = cp.mixed_prefill_attention(qp, kp, vp, tables, d4)
    if not torch.equal(op[at_r, at_j], o[at_n]):
        fail(f"mixed_prefill packed, {label}: lanes differ from the padded form's over the same rows")
    print(f"  mixed_prefill packed, {label}: N={n} lanes in {r} rows, bitwise equal to the padded form's "
          f"(W={w})", flush=True)
    tbl = tables.long()[d4[:, 0].long()]
    s_pad = tbl.shape[1] * bs
    lane = torch.arange(w, device=dev)
    kpos = torch.arange(s_pad, device=dev)
    qpos = d4[:, 1:2] + lane[None, :]
    mask = (kpos[None, None, :] <= qpos[:, :, None]) & (kpos[None, None, :] < d4[:, 3, None, None])
    mask = (mask | (kpos[None, None, :] == 0))[:, None]  # keeps dead lanes finite
    kv_k = kp[tbl].reshape(r, s_pad, kv, dh).permute(0, 2, 1, 3)
    kv_v = vp[tbl].reshape(r, s_pad, kv, dh).permute(0, 2, 1, 3)
    qt = qp.permute(0, 2, 1, 3)
    b_ms, b_by = bound_of(cp.cost(q, kp, vp, tables, d5, desc_host=d5_h, tables_host=tables_host))
    row = dict(
        **timer.turns(dict(
            ms=lambda: cp.mixed_prefill_attention(q, kp, vp, tables, d5),
            plain_ms=lambda: cp.mixed_prefill_attention_plain(q, kp, vp, tables, d5),
            library_ms=lambda: F.scaled_dot_product_attention(qt, kv_k, kv_v, attn_mask=mask, enable_gqa=True),
            padded_ms=lambda: cp.mixed_prefill_attention(qp, kp, vp, tables, d4),
            parent_ms=parent and (lambda: parent.mixed_prefill(qp, kp, vp, tables, d4)),
        )),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
        shape=f"packed, {label}: N={n} R={r} H={h} KV={kv} dh={dh} bs={bs}, (q_start, q_len, kv_len) "
              f"{[d[1:] for d in rows4] if r <= 8 else f'{r} rows, q_len {sorted({d[2] for d in rows4})}'} {dtype}",
    )
    del qp, kv_k, kv_v, qt, mask
    return row


def mixed_prefill_row(torch, timer, gen, desc_h: list, tables, n_pool: int, h: int, kv: int, dtype: str,
                      label: str, bs: int = 32, dh: int = 128) -> dict:
    """``packed_row`` at the descriptors ``desc_h`` over a random pool of
    ``n_pool`` blocks of ``bs`` positions of ``kv`` KV heads of ``dh``."""
    dev = torch.device("cuda")
    tdt = getattr(torch, dtype)
    kp = torch.randn(n_pool, bs, kv, dh, generator=gen, device=dev).to(tdt)
    vp = torch.randn(n_pool, bs, kv, dh, generator=gen, device=dev).to(tdt)
    return packed_row(torch, timer, gen, desc_h, tables, kp, vp, h, f"{label} H={h} KV={kv}")


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


def jamba_kernels(torch, timer, gen, rows: dict) -> None:
    """The three kernels of the hybrid path at jamba-1.5-large-398b's own
    shapes (phase 18's contiguous engine, max_batch 8, prompts padded to
    256): the attention layer's admit prefill through flash_attention and
    its decode through flash_decode, 64 query heads over 8 KV heads of 128
    (G = 8: a 64-row tile holds 8 positions); the Mamba2 layers' prefill
    chunk through ssd_chunk, 256 heads of 64 at state 16, B and C of 8
    groups repeated per head (``repeat_interleave``, so the kernel computes
    C . B^T once per head).  Each checked against its plain version and
    timed beside it, SDPA for the attention rows, and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ss

    dev = torch.device("cuda")
    B, S, H, KV, DH = 8, 256, 64, 8, 128
    SC = 272  # the contiguous stripe: max_prompt_len + max_new_tokens
    lens_c = [272, 17, 200, 64, 250, 131, 99, 1]
    lens_t = torch.tensor(lens_c, dtype=torch.int32, device=dev)
    mask_c = (torch.arange(SC, device=dev)[None, :] < lens_t[:, None])[:, None, None, :]
    SH, SHD, SDS, SG = 256, 64, 16, 8
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        q = torch.randn(B, S, H, DH, generator=gen, device=dev).to(tdt)
        k = torch.randn(B, S, KV, DH, generator=gen, device=dev).to(tdt)
        v = torch.randn(B, S, KV, DH, generator=gen, device=dev).to(tdt)
        o = fa.flash_attention(q, k, v, causal=True)
        err = (o.float() - fa.flash_attention_plain(q, k, v, causal=True).float()).abs().max().item()
        shape = f"jamba admit prefill: B={B} S={S} H={H} KV={KV} (G={H // KV}) dh={DH} causal {dtype}"
        check(f"flash_attention {shape}", err, dtype)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        b_ms, b_by = bound_of(fa.cost(q, k, v, True))
        rows["flash_attention", dtype, "jamba"] = dict(
            **timer.turns(dict(
                ms=lambda: fa.flash_attention(q, k, v, causal=True),
                plain_ms=lambda: fa.flash_attention_plain(q, k, v, causal=True),
                library_ms=lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True),
            )),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err, shape=shape,
        )
        del q, k, v, qt, kt, vt, o

        qd = torch.randn(B, H, DH, generator=gen, device=dev).to(tdt)
        kc = torch.randn(B, SC, KV, DH, generator=gen, device=dev).to(tdt)
        vc = torch.randn(B, SC, KV, DH, generator=gen, device=dev).to(tdt)
        o = da.decode_attention(qd, kc, vc, lens_t)
        err = (o.float() - da.decode_attention_plain(qd, kc, vc, lens_t).float()).abs().max().item()
        shape = (f"jamba decode: B={B} H={H} KV={KV} (G={H // KV}) dh={DH} S={SC} lengths "
                 f"{min(lens_c)}-{max(lens_c)} (sum {sum(lens_c)}) {dtype}")
        check(f"flash_decode {shape}", err, dtype)
        b_ms, b_by = bound_of(da.decode_cost(qd, kc, vc, lens_t, lengths_host=lens_c))
        rows["flash_decode", dtype, "jamba"] = dict(
            **timer.turns(dict(
                ms=lambda: da.decode_attention(qd, kc, vc, lens_t),
                plain_ms=lambda: da.decode_attention_plain(qd, kc, vc, lens_t),
                library_ms=lambda: F.scaled_dot_product_attention(
                    qd[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2), attn_mask=mask_c, enable_gqa=True),
            )),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err, shape=shape,
        )
        del qd, kc, vc, o

        # as the mixer hands them over: silu'd x, B, C (8 groups, each
        # repeated over its 32 heads), softplus'd dt, a = -exp(A_log)
        x = F.silu(torch.randn(B, S, SH, SHD, generator=gen, device=dev)).to(tdt)
        bh = F.silu(torch.randn(B, S, SG, SDS, generator=gen, device=dev)).to(tdt).repeat_interleave(SH // SG, 2)
        ch = F.silu(torch.randn(B, S, SG, SDS, generator=gen, device=dev)).to(tdt).repeat_interleave(SH // SG, 2)
        dt = F.softplus(torch.randn(B, S, SH, generator=gen, device=dev))
        a = -torch.exp(0.5 * torch.randn(SH, generator=gen, device=dev))
        groups, cbt = ss._scores_scratch(bh, ch, B, S, SH)
        if groups != SH:
            fail(f"ssd_chunk at jamba's shape: {groups} groups for per-head B and C, not {SH}")
        outs, plain = ss.ssd_chunk(x, bh, ch, dt, a), ss.ssd_chunk_plain(x, bh, ch, dt, a)
        err = max((o - p).abs().max().item() for o, p in zip(outs, plain))
        rel = max((o - p).abs().max().item() / p.abs().max().item() for o, p in zip(outs, plain))
        shape = f"jamba Mamba2 prefill chunk: B={B} L={S} H={SH} hd={SHD} ds={SDS}, {SG} groups repeated per head"
        print(f"  ssd_chunk {shape} {dtype}: max |kernel - plain| = {err:.3e} at max |y| = "
              f"{plain[0].abs().max().item():.3e}; the per-head C.B^T scratch {cbt.numel() * 4 / 1e6:.1f} MB "
              f"({groups} groups)", flush=True)
        check(f"ssd_chunk {shape} {dtype}, error / max |output|", rel, "float32")
        # the per-head B and C as handed over: C.B^T once per (batch, head)
        b_ms, b_by = bound_of(ss.cost(x, bh, ch, dt, a))
        rows["ssd_chunk", dtype, "jamba"] = dict(
            **timer.turns(dict(
                ms=lambda: ss.ssd_chunk(x, bh, ch, dt, a),
                plain_ms=lambda: ss.ssd_chunk_plain(x, bh, ch, dt, a),
                library_ms=None,  # no single PyTorch call computes the chunk terms
            )),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err, max_rel_err=rel, shape=f"{shape} {dtype}",
        )
        del x, bh, ch, dt, a, cbt, outs, plain


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
        (nq, d), n = qs.shape, cs.shape[0]
        b_ms, b_by = bound_of(rt.cost(qs, cs, k))
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
    # SDPA yardsticks over the gathered views (the gather is not timed)
    lane = torch.arange(W, device=dev)
    kpos = torch.arange(s_pad, device=dev)
    qpos = desc[:, 1:2] + lane[None, :]
    mask_m = (kpos[None, None, :] <= qpos[:, :, None]) & (kpos[None, None, :] < desc[:, 3, None, None])
    mask_m = (mask_m | (kpos[None, None, :] == 0))[:, None]  # keeps dead lanes finite
    mask_d = (kpos[None, :] < lens[:, None])[:, None, None, :]

    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
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
        b_ms, b_by = bound_of(cp.cost(q, kp, vp, tables, desc, desc_host=desc_h))
        rows["mixed_prefill", dtype, "padded"] = dict(
            **timer.turns(dict(
                ms=lambda: cp.mixed_prefill_attention(q, kp, vp, tables, desc),
                plain_ms=lambda: cp.mixed_prefill_attention_plain(q, kp, vp, tables, desc),
                library_ms=lambda: F.scaled_dot_product_attention(qt, kv_k, kv_v, attn_mask=mask_m, enable_gqa=True),
                parent_ms=parent and (lambda: parent.mixed_prefill(q, kp, vp, tables, desc)),
            )),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
            shape=f"padded (no serving path launches it): R={R} W={W} H={H} KV={KV} dh={DH} bs={BS} n_t={NT} {dtype}",
        )
        rows["mixed_prefill", dtype, "step mix"] = packed_row(torch, timer, gen, desc_h, tables, kp, vp, H,
                                                              "the step's mix above", parent=parent)
        b_ms, b_by = bound_of(da.paged_cost(qd, kp, vp, tables, lens, lengths_host=lens_h))
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
    # K/V the rows need, each pool position read once however many rows alias it
    kv_pos = {(int(tables_w[r, p // BS]), p % BS) for r, _, _, kl in desc_w_h for p in range(kl)}
    print(f"  mixed_prefill warm admission: (q_start, q_len, kv_len) by row "
          f"{[d[1:] for d in desc_w_h]}, {len(kv_pos)} distinct K/V positions for "
          f"{sum(d[3] for d in desc_w_h)} read", flush=True)
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
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
        rows["mixed_prefill", dtype, "warm"] = packed_row(torch, timer, gen, desc_w_h, tables_w, kp, vp, H,
                                                          "warm admission, aliased table entries",
                                                          tables_host=tables_w.tolist(), parent=parent)
        del q, kp, vp

    # ---- packed mixed_prefill at qwen3-4b's admission step ----
    # the benchmark's qwen3-4b cells (32 slots, token_budget 1,088): one
    # fill of 1,057 lanes from position 0 beside 31 decode rows, 1,088
    # lanes; H = 32, KV = 8, dh = 128, tables of 35 blocks of 32
    B4, NT4, H4 = 32, 35, 32
    n_pool4 = B4 * NT4 + 1
    tables4 = torch.randperm(n_pool4 - 1, generator=torch.Generator().manual_seed(SEED))[: B4 * NT4]
    tables4 = tables4.reshape(B4, NT4).to(torch.int32).to(dev)
    desc4_h = [(0, 0, 1057, 1057)] + [(r, 1057 + (37 * r) % 63, 1, 1058 + (37 * r) % 63) for r in range(1, B4)]
    kp = torch.randn(n_pool4, BS, KV, DH, generator=gen, device=dev).to(torch.bfloat16)
    vp = torch.randn(n_pool4, BS, KV, DH, generator=gen, device=dev).to(torch.bfloat16)
    rows["mixed_prefill", "bfloat16", "qwen3-4b admission"] = packed_row(
        torch, timer, gen, desc4_h, tables4, kp, vp, H4, "qwen3-4b's admission step, one fill of 1,057 lanes "
        "beside 31 decode rows (q_start 1,057-1,119)", parent=parent)
    del kp, vp

    # ---- dense flash attention at the path shapes ----
    flash_cases = [
        # (label, B, Sq = Sk, H, KV, dh, causal)
        ("rerank", 256, 64, 12, 12, 64, False),  # 16 queries x 16 candidates, bge-reranker-base
        ("chunk index", 147, 40, 12, 12, 64, False),  # the larger provider's 147 chunks, contriever-110m
        ("admit prefill", 8, 256, 16, 8, 128, True),  # contiguous qwen3-0.6b admit group
        ("ragged causal", 3, 100, 16, 8, 128, True),  # 100 positions: no tile multiple
    ]
    for label, b, sl, h, kv, dh, causal in flash_cases:
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
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
            b_ms, b_by = bound_of(fa.cost(q, k, v, causal))
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
        b_ms, b_by = bound_of(da.decode_cost(qd, kc, vc, lens_t, lengths_host=lens_c))
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
        # one group of B and C (expanded over the heads): C.B^T once per batch
        b_ms, b_by = bound_of(ss.cost(x, bg, cg, dt, a))
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
        qd = torch.randn(R, HM, DH, generator=gen, device=dev).to(tdt)
        kp = torch.randn(n_pool, BS, HM, DH, generator=gen, device=dev).to(tdt)
        vp = torch.randn(n_pool, BS, HM, DH, generator=gen, device=dev).to(tdt)
        od = da.paged_decode_attention(qd, kp, vp, tables, lens)
        err = (od.float() - da.paged_decode_attention_plain(qd, kp, vp, tables, lens).float()).abs().max().item()
        check(f"paged_decode B={R} H=KV={HM} {dtype}", err, dtype)
        kv_k = kp[tables.long()].reshape(R, s_pad, HM, DH).permute(0, 2, 1, 3)
        kv_v = vp[tables.long()].reshape(R, s_pad, HM, DH).permute(0, 2, 1, 3)
        b_ms, b_by = bound_of(da.paged_cost(qd, kp, vp, tables, lens, lengths_host=lens_h))
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
        b_ms, b_by = bound_of(fa.cost(q, k, v, True))
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
        b_ms, b_by = bound_of(da.decode_cost(qd, kc, vc, lens_t, lengths_host=lens_c))
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

    jamba_kernels(torch, timer, gen, rows)
    training_checks(torch, timer, gen, parent, rows)
    per_shard_kernels(torch, timer, gen, rows)

    for key, row in rows.items():
        print_row(key[0], row)
    return rows


def grads_through(torch, fn, ins, ups):
    """(outputs, gradients) of sum(out * up) + sum(out^2) / 2 with respect
    to ``ins``: the second term carries the forward's own output (and so
    the kernel's error) into the gradients."""
    leaves = [t.detach().requires_grad_(True) for t in ins]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    loss = sum((o.float() * u).sum() + 0.5 * (o.float() ** 2).sum() for o, u in zip(outs, ups))
    return outs, torch.autograd.grad(loss, leaves)


def rel_err(got, want) -> float:
    """max |got - want| over max |want|, across pairs of tensors."""
    a_, b_ = ([t.detach().float() for t in ts] for ts in (got, want))
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30) for a, b in zip(a_, b_))


def training_checks(torch, timer, gen, parent: Parent | None, rows: dict) -> None:
    """Phase 3's training part: ``flash_attention``'s and ``ssd_chunk``'s
    gradients (the autograd Functions: kernel forward, plain recompute
    backward) against the plain versions' autograd; head_dim 80; the
    serving kernels' requires-grad raise; timed rows for the head_dim-80
    forward and the backward; with ``--parent-csrc``, bf16 flash attention
    at dh 16-128 bitwise equal to the parent's build."""
    import torch.nn.functional as F

    from repro_torch.kernels.chunked_prefill import ops as cp
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.retrieval_topk import ops as rt
    from repro_torch.kernels.ssd_scan import ops as ss

    dev = torch.device("cuda")
    cases = [
        # (label, B, S, H, KV, dh, causal): the shapes phases 13, 14 and 16 train at
        ("train", 8, 256, 16, 8, 128, True),  # qwen3-0.6b, LMBatchStream batch 8 x 256
        ("hubert", 4, 256, 16, 16, 80, False),  # hubert-xlarge frames 4 x 256, head_dim 80
        ("contriever", 16, 40, 12, 12, 64, False),  # 16 (query, chunk) pairs x 40 tokens
    ]
    for label, b, sl, h, kv, dh, causal in cases:
        pairs = sum(min(i + 1, sl) for i in range(sl)) if causal else sl * sl
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            es = torch.empty((), dtype=tdt).element_size()
            q = torch.randn(b, sl, h, dh, generator=gen, device=dev).to(tdt)
            k = torch.randn(b, sl, kv, dh, generator=gen, device=dev).to(tdt)
            v = torch.randn(b, sl, kv, dh, generator=gen, device=dev).to(tdt)
            up = (torch.randn(b, sl, h, dh, generator=gen, device=dev),)
            (o,), g = grads_through(torch, lambda *t: fa.flash_attention(*t, causal=causal), (q, k, v), up)
            (o_p,), g_p = grads_through(torch, lambda *t: fa.flash_attention_plain(*t, causal=causal), (q, k, v), up)
            if o.grad_fn is None or any(x.dtype != tdt for x in g):
                fail(f"flash_attention {label} {dtype}: no grad_fn, or gradients in another dtype")
            shape = f"B={b} S={sl} H={h} KV={kv} dh={dh} {'causal' if causal else 'non-causal'} {dtype}"
            check(f"flash_attention {label} {shape} forward, error / max |out|", rel_err([o], [o_p]), dtype)
            err_g = rel_err(g, g_p)
            check(f"flash_attention {label} {shape} dq, dk, dv, error / max |grad|", err_g, dtype)
            if dtype != "bfloat16":
                continue
            # timed: the head_dim-80 forward against SDPA; the backward (the
            # plain version recomputed and differentiated) against the forward
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            fwd_bytes = es * (2 * b * sl * h * dh + 2 * b * sl * kv * dh)
            if dh == 80:
                b_ms, b_by = bound_of(fa.cost(q, k, v, causal))
                rows["flash_attention", dtype, "dh80"] = dict(
                    **timer.turns(dict(
                        ms=lambda: fa.flash_attention(q, k, v, causal=causal),
                        plain_ms=lambda: fa.flash_attention_plain(q, k, v, causal=causal),
                        library_ms=lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                                          enable_gqa=True),
                    )),
                    bound_ms=b_ms, bound_by=b_by, max_abs_err=rel_err([o], [o_p]),
                    shape=f"{label} forward (padded to dh 128 in the wrapper): {shape}",
                )
            live = [t.detach().requires_grad_(True) for t in (q, k, v)]
            live_t = [t.transpose(1, 2) for t in live]
            out_k = fa.flash_attention(*live, causal=causal)
            out_p = fa.flash_attention_plain(*live, causal=causal)
            out_l = F.scaled_dot_product_attention(*live_t, is_causal=causal, enable_gqa=True)
            d_o = up[0].to(tdt)
            # the least work: P = softmax(QK^T) again, dV, dP, dQ, dK (5 products)
            # over q, k, v, dO read once and dq, dk, dv written once
            b_ms, b_by = bound(fwd_bytes + es * (b * sl * h * dh + 2 * b * sl * kv * dh),
                               (10 * b * h * dh * pairs, dtype))
            t = timer.turns(dict(
                ms=lambda: torch.autograd.grad(out_k, live, d_o, retain_graph=True),
                plain_ms=lambda: torch.autograd.grad(out_p, live, d_o, retain_graph=True),
                library_ms=lambda: torch.autograd.grad(out_l, live, d_o.transpose(1, 2), retain_graph=True),
                fwd_ms=lambda: fa.flash_attention(q, k, v, causal=causal),
            ))
            rows["flash_attention", dtype, f"backward {label}"] = dict(
                **t, bound_ms=b_ms, bound_by=b_by, max_abs_err=err_g,
                shape=f"{label} backward (plain recompute + autograd; plain: autograd of the plain forward's graph; "
                      f"library: SDPA's backward): {shape}",
            )
            print(f"  flash_attention {label} {dtype}: backward {t['ms']:.4f} ms = {t['ms'] / t['fwd_ms']:.1f}x the "
                  f"forward kernel's {t['fwd_ms']:.4f} ms", flush=True)
            del live, live_t, out_k, out_p, out_l, qt, kt, vt
            del q, k, v, o, o_p, g, g_p

    if parent:  # bf16 at every head_dim the parent takes: bitwise
        for dh in (16, 32, 64, 128):
            for causal in (True, False):
                q = torch.randn(3, 100, 8, dh, generator=gen, device=dev).to(torch.bfloat16)
                k = torch.randn(3, 100, 4, dh, generator=gen, device=dev).to(torch.bfloat16)
                v = torch.randn(3, 100, 4, dh, generator=gen, device=dev).to(torch.bfloat16)
                if not torch.equal(fa.flash_attention(q, k, v, causal=causal), parent.flash_attention(q, k, v, causal)):
                    fail(f"flash_attention bf16 dh={dh} causal={causal}: differs from the parent's build")
        print("  flash_attention bf16 at dh 16, 32, 64, 128, causal and not: bitwise equal to the parent's build",
              flush=True)

    # ssd_chunk's gradient at the phase-7 shape (mamba2-1.3b, one group)
    SB, SL, SH, SHD, SDS = 8, 256, 64, 64, 128
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        x = F.silu(torch.randn(SB, SL, SH, SHD, generator=gen, device=dev)).to(tdt)
        bg = F.silu(torch.randn(SB, SL, 1, SDS, generator=gen, device=dev)).to(tdt)
        cg = F.silu(torch.randn(SB, SL, 1, SDS, generator=gen, device=dev)).to(tdt)
        dt = F.softplus(torch.randn(SB, SL, SH, generator=gen, device=dev))
        a = -torch.exp(0.5 * torch.randn(SH, generator=gen, device=dev))
        ups = (torch.randn(SB, SL, SH, SHD, generator=gen, device=dev), torch.randn(SB, SH, SHD, SDS, generator=gen,
               device=dev), torch.randn(SB, SH, generator=gen, device=dev))

        def run(fn):
            return lambda x_, b_, c_, dt_, a_: fn(x_, b_.expand(SB, SL, SH, SDS), c_.expand(SB, SL, SH, SDS), dt_, a_)

        outs, g = grads_through(torch, run(ss.ssd_chunk), (x, bg, cg, dt, a), ups)
        outs_p, g_p = grads_through(torch, run(ss.ssd_chunk_plain), (x, bg, cg, dt, a), ups)
        if any(o.grad_fn is None for o in outs):
            fail(f"ssd_chunk {dtype}: an output has no grad_fn")
        # the gradients pass the forward's outputs (into the hundreds) back
        # through exp and sums of 256 terms: held to 1e-4 of their largest,
        # the reference's own SSD tolerance, in both dtypes (bf16 inputs are
        # upcast exactly; every product is f32)
        err = rel_err(g, g_p)
        print(f"  ssd_chunk gradient B={SB} L={SL} H={SH} hd={SHD} ds={SDS} {dtype}: dx, dB, dC, ddt, da "
              f"error / max |grad| {err:.3e} (tol 1e-4) {'ok' if err <= 1e-4 else 'FAIL'}", flush=True)
        if err > 1e-4:
            fail(f"ssd_chunk {dtype}: the gradient disagrees with the plain version's autograd")
        del x, bg, cg, dt, a, outs, g, outs_p, g_p

    # the serving kernels refuse an input that requires grad
    q = torch.randn(2, 4, 64, device=dev, requires_grad=True)
    kc = torch.randn(2, 8, 2, 64, device=dev)
    lengths = torch.tensor([3, 8], dtype=torch.int32, device=dev)
    pool = torch.randn(5, 4, 2, 64, device=dev)
    tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device=dev)
    desc = torch.tensor([[0, 0, 3, 3], [1, 0, 2, 2]], dtype=torch.int32, device=dev)
    calls = {
        "flash_decode": lambda: da.decode_attention(q, kc, kc, lengths),
        "paged_decode": lambda: da.paged_decode_attention(q, pool, pool, tables, lengths),
        "mixed_prefill": lambda: cp.mixed_prefill_attention(torch.randn(2, 3, 4, 64, device=dev, requires_grad=True),
                                                            pool, pool, tables, desc),
        "retrieval_topk": lambda: rt.retrieval_topk(torch.randn(3, 64, device=dev, requires_grad=True),
                                                    torch.randn(20, 64, device=dev), 4),
    }
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            fail(f"{name}: an input that requires grad did not raise")
    print(f"  {', '.join(calls)}: an input that requires grad raises", flush=True)


def per_shard_kernels(torch, timer, gen, rows: dict) -> None:
    """Phase 3's rows at phase 19's per-data-shard batches, bf16: the
    train forward's attention for one of 4 data shards (qwen3-0.6b, B = 8
    / 4 = 2) and the SSD chunk for one of 2 (mamba2-1.3b, B = 8 / 2 = 4),
    each held to its plain version (output and gradient) and timed beside
    SDPA (attention) and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ss

    dev, dtype, tdt = torch.device("cuda"), "bfloat16", torch.bfloat16
    b, sl, h, kv, dh = 2, 256, 16, 8, 128
    q = torch.randn(b, sl, h, dh, generator=gen, device=dev).to(tdt)
    k = torch.randn(b, sl, kv, dh, generator=gen, device=dev).to(tdt)
    v = torch.randn(b, sl, kv, dh, generator=gen, device=dev).to(tdt)
    up = (torch.randn(b, sl, h, dh, generator=gen, device=dev),)
    (o,), g = grads_through(torch, lambda *t: fa.flash_attention(*t, causal=True), (q, k, v), up)
    (o_p,), g_p = grads_through(torch, lambda *t: fa.flash_attention_plain(*t, causal=True), (q, k, v), up)
    shape = f"B={b} S={sl} H={h} KV={kv} dh={dh} causal {dtype}"
    err = rel_err([o], [o_p])
    check(f"flash_attention per-shard (dp 4) {shape} forward, error / max |out|", err, dtype)
    check(f"flash_attention per-shard (dp 4) {shape} dq, dk, dv, error / max |grad|", rel_err(g, g_p), dtype)
    b_ms, b_by = bound_of(fa.cost(q, k, v, True))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rows["flash_attention", dtype, "per-shard B=2"] = dict(
        **timer.turns(dict(
            ms=lambda: fa.flash_attention(q, k, v, causal=True),
            plain_ms=lambda: fa.flash_attention_plain(q, k, v, causal=True),
            library_ms=lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True),
        )),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
        shape=f"the train forward of one of 4 data shards (qwen3-0.6b 8 x 256 over dp 4): {shape}",
    )
    del q, k, v, qt, kt, vt, o, o_p, g, g_p

    SB, SL, SH, SHD, SDS = 4, 256, 64, 64, 128
    x = F.silu(torch.randn(SB, SL, SH, SHD, generator=gen, device=dev)).to(tdt)
    bg = F.silu(torch.randn(SB, SL, 1, SDS, generator=gen, device=dev)).to(tdt)
    cg = F.silu(torch.randn(SB, SL, 1, SDS, generator=gen, device=dev)).to(tdt)
    dt = F.softplus(torch.randn(SB, SL, SH, generator=gen, device=dev))
    a = -torch.exp(0.5 * torch.randn(SH, generator=gen, device=dev))
    ups = (torch.randn(SB, SL, SH, SHD, generator=gen, device=dev),
           torch.randn(SB, SH, SHD, SDS, generator=gen, device=dev), torch.randn(SB, SH, generator=gen, device=dev))

    def run(fn):
        return lambda x_, b_, c_, dt_, a_: fn(x_, b_.expand(SB, SL, SH, SDS), c_.expand(SB, SL, SH, SDS), dt_, a_)

    outs, g = grads_through(torch, run(ss.ssd_chunk), (x, bg, cg, dt, a), ups)
    outs_p, g_p = grads_through(torch, run(ss.ssd_chunk_plain), (x, bg, cg, dt, a), ups)
    shape = f"B={SB} L={SL} H={SH} hd={SHD} ds={SDS} G=1 {dtype}"
    err = rel_err(outs, outs_p)
    # bf16 inputs are upcast exactly and every product is f32: the f32
    # tolerance for the outputs, 1e-4 of the largest for the gradients
    check(f"ssd_chunk per-shard (dp 2) {shape}, error / max |output|", err, "float32")
    err_g = rel_err(g, g_p)
    print(f"  ssd_chunk per-shard (dp 2) {shape}: dx, dB, dC, ddt, da error / max |grad| {err_g:.3e} (tol 1e-4) "
          f"{'ok' if err_g <= 1e-4 else 'FAIL'}", flush=True)
    if err_g > 1e-4:
        fail("ssd_chunk per-shard: the gradient disagrees with the plain version's autograd")
    bx, cx = bg.expand(SB, SL, SH, SDS), cg.expand(SB, SL, SH, SDS)
    b_ms, b_by = bound_of(ss.cost(x, bx, cx, dt, a))
    rows["ssd_chunk", dtype, "per-shard B=4"] = dict(
        **timer.turns(dict(
            ms=lambda: ss.ssd_chunk(x, bx, cx, dt, a),
            plain_ms=lambda: ss.ssd_chunk_plain(x, bx, cx, dt, a),
            library_ms=None,  # no single PyTorch call computes the chunk terms
        )),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
        shape=f"the train chunk of one of 2 data shards (mamba2-1.3b 8 x 256 over dp 2): {shape} x/B/C, f32 dt/a",
    )
    del x, bg, cg, bx, cx, dt, a, outs, g, outs_p, g_p


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


def one_row_step(torch, cfg, params, seq, cache, tables, bs: int, n_read: int, mesh=None, q_start: int = 0):
    """``lm.mixed_step`` over one row carrying all of ``seq`` (1, n) from
    position ``q_start`` through ``tables`` (1, n_t), its last ``n_read``
    lanes read: logits (n_read, V)."""
    from repro_torch.models import lm as LM

    host = LM.pack_lanes([q_start], [seq.shape[1]], [n_read], tables.cpu().numpy(), bs)
    lanes = LM.Lanes(*(torch.as_tensor(host[f], device=seq.device) for f in LM.Lanes._fields))
    return LM.mixed_step(cfg, params, seq[0], cache, tables, lanes, **({} if mesh is None else {"mesh": mesh}))


def paged_phase(torch, smi: str, timer, rows: dict) -> tuple[dict, list]:
    import numpy as np

    from repro_torch.launch.serve import full_width_system
    from repro_torch.models import lm as LM
    from repro_torch.serving.engine import ServeConfig, ServeEngine

    # qwen3-0.6b at full width, 28 layers, bf16 activations and pool; the
    # serve's first mixed dispatch's packed descriptors and tables are
    # recorded for the kernel row
    sys_, engine, texts = full_width_system(16, "cuda", SEED)
    cfg, scfg = engine.cfg, engine.scfg
    sys_.serve(texts[:2], max_new_tokens=2)  # warm-up, before the recorder
    first: dict = {}
    step = engine._mixed_rows

    def record(st, d, drafts=None):
        if not first:
            first["desc"], first["tables"] = d["desc"].tolist(), d["tables"].clone()
        return step(st, d, drafts)

    engine._mixed_rows = record
    results, launches = serve_phase(
        torch, smi, sys_, engine, texts, "paged qwen3-0.6b full width bf16, bag embedder",
        ("retrieval_topk", "mixed_prefill", "paged_decode"), warm_up=False,
    )
    engine._mixed_rows = step
    print(f"  the first mixed dispatch: (q_start, q_len, kv_len, q_off) by row {[d[1:] for d in first['desc']]}",
          flush=True)
    rows["mixed_prefill", "bfloat16", "first mixed"] = row = mixed_prefill_row(
        torch, timer, torch.Generator(device="cuda").manual_seed(SEED), first["desc"], first["tables"],
        engine._n_pool_blocks + 1, cfg.n_heads, cfg.n_kv_heads, "bfloat16", "the paged serve's first mixed dispatch",
        scfg.block_size, cfg.resolved_head_dim)
    print_row("mixed_prefill", row)

    # logits of the full-width model on the first prompt: finite, right shape
    prompt = torch.as_tensor(np.asarray(results[0]["prompt"]).reshape(1, -1), device="cuda")
    bpp = -(-prompt.shape[1] // scfg.block_size)
    cache = LM.init_paged_cache(cfg, bpp + 1, scfg.block_size, dtype=torch.bfloat16, device="cuda")
    tables = torch.arange(bpp, dtype=torch.int32, device="cuda")[None, :]
    logits = one_row_step(torch, cfg, engine.params, prompt, cache, tables, scfg.block_size, prompt.shape[1])
    if tuple(logits.shape) != (prompt.shape[1], cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
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


def beside_step(torch, cfg, params, seq, bs: int, rows, mesh=None):
    """``lm.mixed_step`` with ``seq`` (1, n) from position 0 as the first
    row, its last lane read, beside companion ``rows`` of (q_len, n_read)
    (``seq``'s tokens over again, each row from position 0 in blocks of its
    own, its last ``n_read`` lanes read), so that the step packs N = n +
    the companions' lanes through the layers' matmuls and 1 + their reads
    through the head's: the first row's logits (V,)."""
    from repro_torch.models import lm as LM

    q_len = [seq.shape[1]] + [q for q, _ in rows]
    nt = max(-(-(n + 1) // bs) for n in q_len)
    tables = torch.arange(len(q_len) * nt, dtype=torch.int32).reshape(len(q_len), nt)
    cache = LM.init_paged_cache(cfg, len(q_len) * nt + 1, bs, dtype=torch.bfloat16, device="cuda", mesh=mesh)
    host = LM.pack_lanes([0] * len(q_len), q_len, [1] + [r for _, r in rows], tables.numpy(), bs)
    lanes = LM.Lanes(*(torch.as_tensor(host[f], device=seq.device) for f in LM.Lanes._fields))
    tok = torch.cat([seq[0]] + [seq[0].repeat(-(-n // seq.shape[1]))[:n] for n, _ in rows])
    return LM.mixed_step(cfg, params, tok, cache, tables.to(seq.device), lanes,
                         **({} if mesh is None else {"mesh": mesh}))[0]


def rounding_tie(torch, engine, prompt, prefix, contiguous: bool = False,
                 sharded: bool = False) -> tuple[float, float, float, dict]:
    """How far rounding on the card moves the token after ``prompt +
    prefix``: its logits computed the ways the engines compute a decode
    token (a lane of one mixed step over the whole sequence, alone and
    beside companion rows that change the step's shapes: a decode row, 7
    decode rows, 7 verify rows of 4 lanes read whole, and a fill to the
    token budget read whole, so N, the layers' matmul rows, and the head's
    rows; and chunked as the engine chunks a fill, the last 1, 7 or 33
    tokens alone in a second mixed step of that N; a decode step after a
    mixed step over the rest; with ``contiguous``,
    also the contiguous engine's: a prefill over the prompt padded to
    ``max_prompt_len`` for the first token, a contiguous decode step after
    a prefill of the rest for a later one; with ``sharded``, also the two
    paged ways over a one-shard pool, through the partials kernel and the
    combine).  Returns (top-2 gap, largest difference between the mixed
    steps of other shapes, largest difference between any two ways, each
    way's largest difference from the first).
    Fails where the companions move the row's logits by more than 32 of
    bf16's units in the last place of its largest logit: rounding moves
    them by a few, a lane that reads another row's data by far more."""
    import numpy as np

    from repro_torch.models import lm as LM

    cfg, bs, params = engine.cfg, engine.scfg.block_size, engine.params
    seq = torch.as_tensor(np.concatenate([prompt, prefix]).astype(np.int32)[None], device="cuda")
    n = seq.shape[1]
    nb = -(-(n + 1) // bs)
    i32 = dict(dtype=torch.int32, device="cuda")
    tables = torch.arange(nb, **i32)[None, :]
    with torch.no_grad():
        cache = LM.init_paged_cache(cfg, nb + 1, bs, dtype=torch.bfloat16, device="cuda")
        a = one_row_step(torch, cfg, params, seq, cache, tables, bs, 1)[0].float()
        fill = max(1, engine._token_budget - n)
        named = {"alone": a}
        for tag, rows in (("+1 decode", ((1, 1),)), ("+7 decode", ((1, 1),) * 7), ("+7 verify", ((4, 4),) * 7),
                          ("+fill", ((fill, fill),))):
            named[tag] = beside_step(torch, cfg, params, seq, bs, rows).float()
        for k in (1, 7, 33):
            if k < n:
                cache = LM.init_paged_cache(cfg, nb + 1, bs, dtype=torch.bfloat16, device="cuda")
                one_row_step(torch, cfg, params, seq[:, : n - k], cache, tables, bs, 0)
                named[f"last {k} chunked"] = one_row_step(torch, cfg, params, seq[:, n - k :], cache, tables, bs, 1,
                                                          q_start=n - k)[0].float()
        by_n = list(named.values())
        cache = LM.init_paged_cache(cfg, nb + 1, bs, dtype=torch.bfloat16, device="cuda")
        one_row_step(torch, cfg, params, seq[:, : n - 1], cache, tables, bs, 0)
        named["decode"] = b = LM.decode_step(cfg, params, cache, seq[:, n - 1 :], torch.tensor([n - 1], **i32),
                                             block_tables=tables, block_size=bs)[0, -1].float()
        ways = by_n + [b]
        if sharded:
            from repro_torch.runtime.compat import make_mesh

            mesh = make_mesh(["cuda:0"])
            cache = LM.init_paged_cache(cfg, nb + 1, bs, dtype=torch.bfloat16, device="cuda", mesh=mesh)
            ways.append(one_row_step(torch, cfg, params, seq, cache, tables, bs, 1, mesh)[0].float())
            cache = LM.init_paged_cache(cfg, nb + 1, bs, dtype=torch.bfloat16, device="cuda", mesh=mesh)
            one_row_step(torch, cfg, params, seq[:, : n - 1], cache, tables, bs, 0, mesh)
            ways.append(LM.decode_step(cfg, params, cache, seq[:, n - 1 :], torch.tensor([n - 1], **i32),
                                       block_tables=tables, block_size=bs, mesh=mesh)[0, -1].float())
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

    def spread(xs):
        return max((x - y).abs().max().item() for i, x in enumerate(xs) for y in xs[i + 1 :])

    d_n, ulp = spread(by_n), 2.0 ** (math.floor(math.log2(a.abs().max().item())) - 7)
    if d_n > 32 * ulp:
        fail(f"one row's logits move by {d_n:.4e} beside companion rows, past rounding (32 x {ulp:.4e})")
    return (top[0] - top[1]).item(), d_n, spread(ways), {k: (v - a).abs().max().item() for k, v in named.items()}


def same_answers(want: list, got: list, what: str, engine=None, contiguous: bool = False,
                 sharded: bool = False) -> None:
    """Every query's answer tokens equal; prints, then fails on, the queries
    that differ, each with its first differing place.  With ``engine`` (runs
    whose engine steps were composed differently: a row's decode token may
    come from a mixed step in one run and a decode step in the other, and a
    mixed step packs the live tokens of other rows, whose count N sets the
    matmuls' shapes, and its head runs over every read lane of the step) a
    query may differ where ``rounding_tie`` finds the token decided by
    rounding: its top-2 gap at most twice the largest difference between
    the ways.  At the first token, which both runs take from a mixed step,
    only the mixed steps of other shapes count, unless
    ``contiguous`` (one of the runs on the contiguous engine, whose first
    token comes from a padded prefill) or ``sharded`` (one of the runs on
    a sharded pool, every token through the partials form) add those
    ways."""
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
        if engine is None:
            fail(f"{what}: answer tokens differ")
        prompt = np.asarray(want[i]["prompt"]).reshape(-1)
        gap, d_n, d, by_way = rounding_tie(torch, engine, prompt, np.asarray(want[i]["answer_tokens"][:j]),
                                           contiguous, sharded)
        bound = d_n if j == 0 and not (contiguous or sharded) else d
        tie = gap <= 2 * bound
        print(f"    query {i}, place {j}: top-2 gap {gap:.4e}; the mixed steps of other shapes differ by up to {d_n:.4e}, "
              f"all the ways by up to {d:.4e}: {'decided by rounding' if tie else 'NOT a rounding tie'}; each way "
              f"against the row alone {({k: f'{v:.3e}' for k, v in by_way.items()})}", flush=True)
        if not tie:
            fail(f"{what}: query {i} differs at place {j} where its top-2 gap ({gap:.4e}) exceeds rounding "
                 f"({bound:.4e})")


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
    step = engine._mixed_rows

    def record(st, d, drafts=None):
        if not first and drafts is not None and bool(((d["is_dec"] != 0) & (d["q_len"] > 1)).any()):
            first["desc"], first["tables"] = d["desc"].tolist(), d["tables"].clone()
        return step(st, d, drafts)

    engine._mixed_rows = record
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
    print(f"  the first verify dispatch: (q_start, q_len, kv_len, q_off) by row {[d[1:] for d in first['desc']]}",
          flush=True)
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
    # what the step's shapes alone move: a query's first-token logits, its
    # row alone against beside companion rows
    gaps = [rounding_tie(torch, plain_eng, np.asarray(r["prompt"]).reshape(-1), np.zeros((0,), np.int32))
            for r in plain[:4]]
    print(f"  qwen3-4b first tokens of queries 0-3: top-2 gaps {[f'{g[0]:.4e}' for g in gaps]}; the mixed steps of "
          f"other shapes differ by up to {[f'{g[1]:.4e}' for g in gaps]}", flush=True)
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
    logits = one_row_step(torch, cfg, engine.params, prompt, cache,
                          torch.arange(bpp, dtype=torch.int32, device="cuda")[None], bs, prompt.shape[1])
    if tuple(logits.shape) != (prompt.shape[1], cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
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


# --------------------------------------------------------------------- #
# phases 13-16: training, HuBERT, pixtral's patches, federated F_emb
# --------------------------------------------------------------------- #


def peak_line(torch, smi: str) -> str:
    return (f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB of "
            f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} [{smi}]")


def check_grads(torch, name: str, grads) -> None:
    """Fail unless every leaf of a gradient tree is finite and non-zero."""
    from repro_torch.models.params import leaves

    bad = [path for path, g in leaves(grads) if not bool(torch.isfinite(g).all())]
    zero = [path for path, g in leaves(grads) if not bool((g != 0).any())]
    if bad or zero:
        fail(f"{name}: gradient leaves non-finite {bad}, all zero {zero}")


def timed_step(torch, cfg, opt, params, state, batch, lr: float):
    """One train step as ``make_train_step`` runs it (``steps.value_and_grad``
    of the family's loss, then the optimizer's update under ``no_grad``;
    ``bf16_grads`` is off in every config trained here), timed in three
    synchronised parts: forward (the loss function, synchronised at its
    end), backward (the rest of ``value_and_grad``), update.  Every leaf's
    gradient must be finite and non-zero.  Returns (params, state, loss,
    {part: seconds})."""
    from repro_torch.runtime.steps import model_loss_fn, value_and_grad

    loss_fn = model_loss_fn(cfg)
    marks = {}

    def timed_loss(p):
        out = loss_fn(cfg, p, batch)
        torch.cuda.synchronize()
        marks["forward"] = time.perf_counter()
        return out

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _, grads = value_and_grad(timed_loss, params)
    torch.cuda.synchronize()
    times = {"forward": marks["forward"] - t0, "backward": time.perf_counter() - marks["forward"]}
    check_grads(torch, cfg.name, grads)
    t0 = time.perf_counter()
    with torch.no_grad():
        params, state, _ = opt.update(grads, state, params, lr)
    torch.cuda.synchronize()
    times["update"] = time.perf_counter() - t0
    return params, state, float(loss), times


def train_phase(torch, smi: str) -> list[dict]:
    """[13] qwen3-0.6b at full width through ``launch/train.py``'s
    ``Trainer``: a straight run, a run killed at ``fail_at_step`` and
    resumed with ``resume="auto"`` (losses equal at rel 1e-5); loss falling
    over 4 AdamW steps on one repeated batch with every parameter leaf's
    gradient finite and non-zero; mamba2-1.3b two steps on a repeated
    batch."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import LMBatchStream
    from repro_torch.models import lm as LM
    from repro_torch.models.params import init_params, param_count
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.runtime.train_loop import SimulatedFailure, Trainer, TrainerConfig

    free_device(torch)
    cfg = get_config("qwen3-0.6b")  # bf16 activations, f32 master weights, remat="block"
    steps, lr, batch, seq = 4, 3e-4, 8, 256
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    runs = []
    try:
        def trainer(tag, **kw):
            tcfg = TrainerConfig(total_steps=steps, ckpt_dir=str(root / tag), **kw)
            return Trainer(cfg, get_optimizer("adamw"), LMBatchStream(batch, seq, cfg.vocab_size, seed=SEED), tcfg,
                           lr_fn=lambda s: lr, device="cuda")

        torch.cuda.reset_peak_memory_stats()
        straight = trainer("straight", ckpt_every=steps)
        reset_launches()
        t0 = time.perf_counter()
        straight.run(resume="never", seed=SEED)
        wall = time.perf_counter() - t0
        runs.append(read_launches("the straight training run", ("flash_attention",)))
        n_blocks_run = cfg.n_blocks * steps
        if runs[-1]["flash_attention"] < 2 * n_blocks_run:
            fail(f"flash_attention launched {runs[-1]['flash_attention']} times in {steps} steps of {cfg.n_blocks} "
                 f"layers: fewer than forward + remat recompute ({2 * n_blocks_run})")
        losses = [m["loss"] for m in straight.metrics_log]
        norms = [m["grad_norm"] for m in straight.metrics_log]
        step_s = straight.step_times
        print(f"  qwen3-0.6b full width ({param_count(LM.param_specs(cfg)) / 1e9:.3f} B parameters, f32 master "
              f"weights and AdamW moments, bf16 activations, remat per block), batch {batch} x {seq}, lr {lr:g}: "
              f"losses {[round(x, 4) for x in losses]}, step seconds {[round(x, 3) for x in step_s]} (median after "
              f"the first {statistics.median(step_s[1:]):.3f} s), {wall:.1f} s with one checkpoint; "
              f"flash_attention launches {runs[-1]['flash_attention']} = forward + remat recompute of "
              f"{cfg.n_blocks} layers x {steps} steps; gradient norms {[round(g, 4) for g in norms]}; "
              f"{peak_line(torch, smi)}", flush=True)
        if not all(np.isfinite(losses)) or not all(math.isfinite(g) and g > 0 for g in norms):
            fail(f"qwen3-0.6b training: losses {losses}, gradient norms {norms} (finite, norms positive)")
        shutil.rmtree(root / "straight", ignore_errors=True)

        crashed = trainer("crash", ckpt_every=2, fail_at_step=3)
        try:
            crashed.run(resume="never", seed=SEED)
            fail("the run with fail_at_step=3 did not fail")
        except SimulatedFailure as e:
            print(f"  killed: {e} (the last checkpoint at step {crashed.ckpt.latest_step()})", flush=True)
        t0 = time.perf_counter()
        resumed = trainer("crash", ckpt_every=2)
        resumed.run(resume="auto", seed=SEED)
        got = {m["step"]: m["loss"] for m in crashed.metrics_log + resumed.metrics_log}
        print(f"  resumed at step {resumed.metrics_log[0]['step']} in {time.perf_counter() - t0:.1f} s (restore "
              f"included): losses {[round(got[i], 4) for i in range(steps)]}", flush=True)
        for i, want in enumerate(losses):
            if not math.isclose(got[i], want, rel_tol=1e-5):
                fail(f"step {i}: resumed loss {got[i]} != the straight run's {want} (rel 1e-5)")
        print("  resumed losses equal the straight run's at rel 1e-5", flush=True)
        del straight, crashed, resumed
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free_device(torch)

    # loss falls over 4 steps on one repeated batch; every leaf's gradient
    # finite and non-zero; each step split into forward / backward / update
    opt = get_optimizer("adamw")
    params = init_params(LM.param_specs(cfg), torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    state = opt.init(params)
    one = {k: torch.as_tensor(v, device="cuda") for k, v in LMBatchStream(batch, seq, cfg.vocab_size, seed=SEED + 1)
           .next().items()}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, parts = [], []
    for _ in range(4):
        params, state, loss, t = timed_step(torch, cfg, opt, params, state, one, lr)
        losses.append(loss)
        parts.append(t)
    runs.append(read_launches("four steps on one repeated batch", ("flash_attention",)))
    mean = {k: statistics.median(p[k] for p in parts[1:]) for k in parts[0]}
    total = sum(mean.values())
    print(f"  one repeated batch, lr {lr:g}: losses {[round(x, 4) for x in losses]}; every leaf's gradient finite "
          f"and non-zero; step {total:.3f} s (median of steps 2-4): forward {mean['forward']:.3f} s, backward "
          f"{mean['backward']:.3f} s ({mean['backward'] / total:.1%}), update {mean['update']:.3f} s; "
          f"{peak_line(torch, smi)}", flush=True)
    if not losses[-1] < losses[0]:
        fail(f"qwen3-0.6b loss does not fall over 4 steps on one batch: {losses}")
    del params, state, one
    free_device(torch)

    # mamba2-1.3b: two steps on a repeated batch, through ssd_chunk
    mcfg = get_config("mamba2-1.3b")
    params = init_params(LM.param_specs(mcfg), torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    state = opt.init(params)
    one = {k: torch.as_tensor(v, device="cuda") for k, v in LMBatchStream(batch, seq, mcfg.vocab_size, seed=SEED)
           .next().items()}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, parts = [], []
    for _ in range(2):
        params, state, loss, t = timed_step(torch, mcfg, opt, params, state, one, lr)
        losses.append(loss)
        parts.append(t)
    runs.append(read_launches("two mamba2-1.3b steps", ("ssd_chunk",)))
    print(f"  mamba2-1.3b full width ({param_count(LM.param_specs(mcfg)) / 1e9:.3f} B parameters), batch {batch} x "
          f"{seq}: losses {[round(x, 4) for x in losses]}; every leaf's gradient finite and non-zero; second step "
          f"forward {parts[1]['forward']:.3f} s, backward {parts[1]['backward']:.3f} s, update "
          f"{parts[1]['update']:.3f} s; {peak_line(torch, smi)}", flush=True)
    if not all(np.isfinite(losses)):
        fail(f"mamba2-1.3b losses not finite: {losses}")
    del params, state, one
    free_device(torch)
    return runs


def hubert_phase(torch, smi: str) -> list[dict]:
    """[14] hubert-xlarge at full width: ``encoder.loss_fn``, two train
    steps with finite, falling loss, ``embed_corpus``; its first layer's
    own q, k, v through head_dim-80 ``flash_attention`` against the plain
    version, forward and gradient, bf16."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import encoder as ENC
    from repro_torch.models import layers as L
    from repro_torch.models.params import init_params, map_tree, param_count
    from repro_torch.optim.optimizers import get_optimizer

    free_device(torch)
    cfg = get_config("hubert-xlarge")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(ENC.param_specs(cfg), gen, device="cuda")
    b, sl, lr = 4, 256, 1e-4
    batch = {
        "frames": torch.randn(b, sl, cfg.d_model, generator=gen, device="cuda"),
        "mask": torch.rand(b, sl, generator=gen, device="cuda") < 0.3,
        "targets": torch.randint(0, cfg.vocab_size, (b, sl), generator=gen, device="cuda"),
    }
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with torch.no_grad():
        loss0, metrics = ENC.loss_fn(cfg, params, batch)
    opt = get_optimizer("adamw")
    state = opt.init(params)
    losses, times = [], []
    for _ in range(2):  # make_train_step's value_and_grad and update, timed in parts, every leaf checked
        params, state, loss, t = timed_step(torch, cfg, opt, params, state, batch, lr)
        losses.append(loss)
        times.append(t)
    with torch.no_grad():
        loss2, _ = ENC.loss_fn(cfg, params, batch)
        emb = ENC.embed_corpus(cfg, params, batch["frames"])
    torch.cuda.synchronize()
    runs = [read_launches("the hubert-xlarge loss, train steps and embed_corpus", ("flash_attention",))]
    print(f"  hubert-xlarge full width ({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
          f"{param_count(ENC.param_specs(cfg)) / 1e9:.3f} B parameters), frames {b} x {sl}, mask rate 0.3 "
          f"({int(metrics['tokens'])} masked): loss_fn {float(loss0):.4f}; AdamW lr {lr:g} steps: losses "
          f"{[round(x, 4) for x in losses]}, then {float(loss2):.4f}; every leaf's gradient finite and non-zero; "
          f"second step forward {times[1]['forward']:.3f} s, backward {times[1]['backward']:.3f} s, update "
          f"{times[1]['update']:.3f} s; embed_corpus {tuple(emb.shape)}; {peak_line(torch, smi)}", flush=True)
    if not (all(math.isfinite(x) for x in losses + [float(loss2)]) and float(loss2) < losses[0]
            and losses[1] < losses[0]):
        fail(f"hubert-xlarge losses not finite and falling: {losses}, then {float(loss2)}")
    if tuple(emb.shape) != (b, cfg.d_model) or not bool(torch.isfinite(emb).all()):
        fail(f"hubert embed_corpus: shape {tuple(emb.shape)}, finite {bool(torch.isfinite(emb).all())}")

    # the first layer's own q, k, v (bf16, head_dim 80) through the kernel and the plain version
    p0 = map_tree(lambda t: t[0], params["blocks"])
    with torch.no_grad():
        h = torch.where(batch["mask"][..., None], params["mask_embed"].to(torch.bfloat16),
                        batch["frames"].to(torch.bfloat16))
        x = L.rmsnorm(h, p0["mixer_norm"], cfg.norm_eps)
        q, k, v = L.attn_qkv(cfg, p0["attn"], x, torch.arange(sl, device=x.device)[None].expand(b, sl))
    up = (torch.randn(q.shape, generator=gen, device="cuda"),)
    (o,), g = grads_through(torch, lambda *t: fa.flash_attention(*t, causal=False), (q, k, v), up)
    (o_p,), g_p = grads_through(torch, lambda *t: fa.flash_attention_plain(*t, causal=False), (q, k, v), up)
    check("hubert layer 0 q, k, v (B=4 S=256 H=KV=16 dh=80 non-causal bf16) forward, error / max |out|",
          rel_err([o], [o_p]), "bfloat16")
    check("hubert layer 0 dq, dk, dv, error / max |grad|", rel_err(g, g_p), "bfloat16")
    del params, state, batch, emb, q, k, v, o, o_p, g, g_p
    free_device(torch)
    return runs


def pixtral_phase(torch, smi: str) -> list[dict]:
    """[15] pixtral-12b at full width with 64 patch embeddings: forward and
    prefill (logits equal), other patches change the logits, ``generate``
    takes 8 tokens."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import lm as LM
    from repro_torch.models.params import init_params, param_bytes, param_count

    free_device(torch)
    cfg = get_config("pixtral-12b")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(LM.param_specs(cfg), gen, device="cuda")
    torch.cuda.synchronize()
    print(f"  built pixtral-12b ({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads "
          f"of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, untied; "
          f"{param_count(LM.param_specs(cfg)) / 1e9:.3f} B parameters, {param_bytes(LM.param_specs(cfg)) / 1e9:.2f} "
          f"GB f32) in {time.perf_counter() - t0:.1f} s; resident {torch.cuda.memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    b, sl = 2, 256
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(8, cfg.vocab_size, size=(b, sl)).astype(np.int32), device="cuda")
    pe = (0.02 * torch.randn(b, cfg.n_patches, cfg.d_model, generator=gen, device="cuda")).to(torch.bfloat16)
    batch = {"tokens": tokens, "patch_embeds": pe}
    reset_launches()
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, _ = LM.forward(cfg, params, batch)
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        pre, cache = LM.prefill(cfg, params, batch)
        del cache
        other, _ = LM.forward(cfg, params, dict(batch, patch_embeds=pe + 0.02))
        t0 = time.perf_counter()
        out = LM.generate(cfg, params, batch, 8)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
    runs = [read_launches("pixtral-12b forward, prefill and generate", ("flash_attention", "flash_decode"))]
    diff = float((other - logits).abs().max())
    print(f"  pixtral-12b B={b} S={sl}, {cfg.n_patches} patch embeddings: forward {t_fwd:.3f} s, logits "
          f"{tuple(logits.shape)} finite {bool(torch.isfinite(logits).all())}; prefill logits equal forward's: "
          f"{torch.equal(pre, logits)} (max diff {float((pre - logits).abs().max()):.3e}); other patches move the "
          f"logits by {diff:.3e}; generate 8 tokens {out.tolist()} in {t_gen:.3f} s; {peak_line(torch, smi)}",
          flush=True)
    if tuple(logits.shape) != (b, sl, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        fail("pixtral-12b logits: wrong shape or not finite")
    if not torch.equal(pre, logits):
        fail("pixtral-12b prefill's logits differ from forward's")
    if diff <= 1e-3:
        fail("pixtral-12b: the patch embeddings do not reach the logits")
    if tuple(out.shape) != (b, 8) or bool(((out < 0) | (out >= cfg.vocab_size)).any()):
        fail(f"pixtral-12b generate: {tuple(out.shape)}, tokens outside the vocabulary")
    del params, logits, pre, other, out
    free_device(torch)
    return runs


def fedembed_phase(torch, smi: str) -> list[dict]:
    """[16] the paper's §2.2: ``federated_train_embedder`` over the phase-4
    federation's two providers (sites), contriever-110m at full width as
    F_emb; 3 rounds secure and 3 plain from the same weights (mean-loss
    trajectories equal at rtol 1e-4, the loss falling); one ``rank_loss``
    step of bge-reranker-base."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.federated import federated_train_embedder
    from repro_torch.data.corpus import make_federated_corpus
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.models import cross_encoder as CE
    from repro_torch.models import dual_encoder as DE
    from repro_torch.models.params import init_params, param_count
    from repro_torch.optim.optimizers import clip_by_global_norm
    from repro_torch.runtime.steps import value_and_grad

    free_device(torch)
    tok = HashTokenizer()
    # the phase-4 corpus (128 facts, 128 distractors), a question per fact
    corpus = make_federated_corpus(n_facts=128, n_distractors=128, n_queries=128, seed=SEED)
    chunks = {c.chunk_id: c for c in corpus.chunks}
    n_pairs, max_len, lr = 16, 40, 0.5
    clients = []
    for site in (0, 1):
        qs = [q for q in corpus.queries if chunks[q.gold_chunk_id].site == site][:n_pairs]
        clients.append({
            "query_tokens": torch.as_tensor(np.stack([tok.encode(q.text, max_len=max_len) for q in qs]), device="cuda"),
            "doc_tokens": torch.as_tensor(np.stack([tok.encode(chunks[q.gold_chunk_id].text, max_len=max_len)
                                                    for q in qs]), device="cuda"),
        })
    cfg = get_config("contriever-110m").with_overrides(dtype="float32")
    init = init_params(DE.param_specs(cfg), torch.Generator(device="cuda").manual_seed(SEED), device="cuda")

    def grad_fn(params, batch):
        loss, _, grads = value_and_grad(lambda p: DE.info_nce_loss(cfg, p, batch), params)
        return float(loss), grads

    def apply_update(params, grads):  # SGD on the clipped gradient
        with torch.no_grad():
            return _sgd(params, clip_by_global_norm(grads, 1.0)[0], lr)

    torch.cuda.reset_peak_memory_stats()
    hist, runs = {}, []
    for secure in (True, False):
        reset_launches()
        t0 = time.perf_counter()
        _, h = federated_train_embedder(init, [lambda r, b=b: b for b in clients], grad_fn, apply_update, n_rounds=3,
                                        secure=secure)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append(read_launches(f"3 federated rounds, secure={secure}", ("flash_attention",)))
        hist[secure] = h
        print(f"  federated F_emb, contriever-110m full width f32 ({param_count(DE.param_specs(cfg)) / 1e6:.1f} M "
              f"parameters), 2 providers x {n_pairs} (query, gold chunk) pairs x {max_len} tokens, clipped SGD lr "
              f"{lr:g}, secure={secure}: mean loss by round {[round(r['mean_loss'], 6) for r in h]}; update exchange "
              f"{[round(r['exchange_s'], 3) for r in h]} s host time by round; {wall:.1f} s in all", flush=True)
    sec, plain = ([r["mean_loss"] for r in hist[s]] for s in (True, False))
    if not all(math.isclose(a, b, rel_tol=1e-4) for a, b in zip(sec, plain)):
        fail(f"secure and plain federated trajectories differ: {sec} vs {plain}")
    if not (sec[-1] < sec[0] and plain[-1] < plain[0]):
        fail(f"the federated InfoNCE loss does not fall: {sec}, {plain}")
    n_par = param_count(DE.param_specs(cfg))
    ex = [r["exchange_s"] for r in hist[True]]
    print(f"  secure == plain trajectories at rtol 1e-4, loss falling; the masked exchange of {n_par / 1e6:.1f} M "
          f"parameters (f64 -> fixed point uint64 mod 2^62, one pair mask per client, 2 clients) took "
          f"{statistics.median(ex):.3f} s of host time per round (median; plain "
          f"{statistics.median(r['exchange_s'] for r in hist[False]):.3f} s); {peak_line(torch, smi)}", flush=True)
    del init

    # one rank_loss step of bge-reranker-base (F_aggr): each query's gold
    # chunk among 4 candidates of its provider
    rcfg = get_config("bge-reranker-base")
    rparams = init_params(CE.param_specs(rcfg), torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    site0 = [c for c in corpus.chunks if c.site == 0]
    qs = [q for q in corpus.queries if chunks[q.gold_chunk_id].site == 0][:8]
    toks, types = [], []
    for i, q in enumerate(qs):
        others = [c for c in site0 if c.chunk_id != q.gold_chunk_id]
        cands = [chunks[q.gold_chunk_id]] + others[3 * i: 3 * i + 3]
        t, ty = CE._pack_pairs(tok.encode(q.text, max_len=24), np.stack([tok.encode(c.text, max_len=max_len)
                                                                          for c in cands]), 64)
        toks.append(t)
        types.append(ty)
    rbatch = {"tokens": torch.as_tensor(np.stack(toks), device="cuda"),
              "type_ids": torch.as_tensor(np.stack(types), device="cuda"),
              "label": torch.zeros(len(qs), dtype=torch.int32, device="cuda")}
    reset_launches()
    loss, metrics, grads = value_and_grad(lambda p: CE.rank_loss(rcfg, p, rbatch), rparams)
    with torch.no_grad():
        rparams = _sgd(rparams, clip_by_global_norm(grads, 1.0)[0], lr)
        loss2, _ = CE.rank_loss(rcfg, rparams, rbatch)
    runs.append(read_launches("the rank_loss step", ("flash_attention",)))
    print(f"  bge-reranker-base full width bf16, {len(qs)} queries x 4 candidates x 64 tokens: rank_loss "
          f"{float(loss):.4f} (acc {float(metrics['acc']):.3f}), after one clipped SGD step {float(loss2):.4f}",
          flush=True)
    if not (math.isfinite(float(loss)) and math.isfinite(float(loss2))):
        fail("bge-reranker-base rank_loss not finite")
    del rparams, grads
    free_device(torch)
    return runs


# --------------------------------------------------------------------- #
# phase 17: sharded serving, every shard on the one card through mesh=
# --------------------------------------------------------------------- #


def partials_err(got, want) -> float:
    """Largest of |m - m'|, |l - l'| / max(l', 1) and |o / l - o' / l'| over
    the lanes that saw a key; the lanes that saw none must be exact zeros
    with m = -1e30 in both."""
    o, m, l = got
    o_p, m_p, l_p = want
    seen = l_p[..., 0] > 0
    if not (bool((o[~seen] == 0).all()) and bool((l[~seen] == 0).all()) and bool((m[~seen] == -1e30).all())
            and bool((m_p[~seen] == -1e30).all())):
        fail("partials: a lane that saw no key is not o = 0, l = 0, m = -1e30 exactly")
    return max((m - m_p).abs().max().item(), ((l - l_p).abs() / l_p.clamp(min=1)).max().item(),
               (o / l.clamp(min=1e-30) - o_p / l_p.clamp(min=1e-30))[seen].abs().max().item())


def sharded_kernels(torch, timer, rows: dict) -> None:
    """[17a] the partials kernels of the sharded paths at the path shapes,
    against their plain versions, the combine's bitwise pass-through, and
    federated top-k over 4 providers against the whole-corpus kernel."""
    import torch.nn.functional as F

    from repro_torch.core.retrieval import federated_topk
    from repro_torch.kernels.chunked_prefill import ops as cp
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.retrieval_topk import ops as rt
    from repro_torch.runtime.compat import make_mesh
    from repro_torch.serving.dist_decode import combine_partials, dist_decode_attention

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    # the phase-3 step's mix (R = 8 rows of W = 256 lanes, qwen3-0.6b's 16 / 8
    # heads of 128, blocks of 32, 9 per row) over a pool split row-affine
    # over 4 shards: row r's blocks on shard r % 4, n_local = 2 rows' blocks
    R, W, H, KV, DH, BS, NT, N_SH = 8, 256, 16, 8, 128, 32, 9, 4
    desc_h = [(0, 0, 180, 180), (1, 100, 76, 176)] + [(r, 120 + 25 * r, 1, 121 + 25 * r) for r in range(2, 7)] \
        + [(7, 0, 0, 0)]
    n_local = 2 * NT
    tables_h = [[N_SH * n_local] * NT for _ in range(R)]  # the global trash
    for r, (_, _, _, kl) in enumerate(desc_h):
        s, slot = r % N_SH, r // N_SH
        for e in range(-(-max(kl, 1) // BS)):
            tables_h[r][e] = s * n_local + slot * NT + e
    tables = torch.tensor(tables_h, dtype=torch.int32, device=dev)
    desc = torch.tensor(desc_h, dtype=torch.int32, device=dev)
    # the packed form the sharded dispatch launches: the live rows' lanes
    # back to back (row r's from q_off), and each lane's padded (row, lane)
    live = [d for d in desc_h if d[2] > 0]
    d5_h = [(*d, sum(x[2] for x in live[:i])) for i, d in enumerate(live)]
    d5 = torch.tensor(d5_h, dtype=torch.int32, device=dev)
    at_r = torch.tensor([d[0] for d in live for _ in range(d[2])], device=dev)
    at_j = torch.tensor([j for d in live for j in range(d[2])], device=dev)
    owned_1 = (tables // (N_SH * n_local)) == 0  # one shard: every block but the trash
    s_pad, lane, kpos = NT * BS, torch.arange(W, device=dev), torch.arange(NT * BS, device=dev)
    mask = (kpos[None, None, :] <= (desc[:, 1:2] + lane[None, :])[:, :, None]) & (kpos[None, None, :] < desc[:, 3, None, None])
    mask = (mask | (kpos[None, None, :] == 0))[:, None]  # keeps dead lanes finite
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        q_pad = torch.randn(R, W, H, DH, generator=gen, device=dev).to(tdt)
        q = q_pad[at_r, at_j].contiguous()
        kp = torch.randn(N_SH * n_local + 1, BS, KV, DH, generator=gen, device=dev).to(tdt)
        vp = torch.randn(N_SH * n_local + 1, BS, KV, DH, generator=gen, device=dev).to(tdt)
        got = cp.mixed_prefill_partials(q, kp, vp, tables, d5, owned=owned_1)
        err = partials_err(got, cp.mixed_prefill_partials_plain(q, kp, vp, tables, d5, owned=owned_1))
        padded = cp.mixed_prefill_partials(q_pad, kp, vp, tables, desc, owned=owned_1)
        if not all(torch.equal(t.permute(0, 3, 1, 2, 4)[at_r, at_j], g) for t, g in zip(padded, got)):
            fail(f"mixed_prefill partials {dtype}: packed lanes differ from the padded form's over the same rows")
        # each shard's own pool (its blocks, a trash block poisoned with NaN
        # and 1e4), local table and mask
        shard = []
        for s in range(N_SH):
            kl, vl = kp[s * n_local : (s + 1) * n_local + 1].clone(), vp[s * n_local : (s + 1) * n_local + 1].clone()
            kl[-1], vl[-1] = float("nan"), 1e4
            owned = (tables // n_local) == s
            shard.append((kl, vl, torch.where(owned, tables % n_local, n_local), owned))
        parts = [cp.mixed_prefill_partials(q, kl, vl, loc, d5, owned=own) for kl, vl, loc, own in shard]
        for s, ((kl, vl, loc, own), part) in enumerate(zip(shard, parts)):
            err = max(err, partials_err(part, cp.mixed_prefill_partials_plain(q, kl.nan_to_num(0.0), vl, loc, d5,
                                                                              owned=own)))
            lanes_s = at_r % N_SH != s
            if not (bool((part[0][lanes_s] == 0).all()) and bool((part[2][lanes_s] == 0).all())
                    and bool((part[1][lanes_s] == -1e30).all())):
                fail(f"mixed_prefill partials {dtype}: shard {s}'s lanes of other shards' rows are not exact zeros")
        check(f"mixed_prefill partials packed, owned over {N_SH} shards (row-affine), m / l / o over l, {dtype}", err,
              dtype)
        four = combine_partials(*map(list, zip(*parts)))
        one = combine_partials(*[[t] for t in got])
        if not (torch.equal(four, one) and bool(torch.isfinite(four).all())):
            fail(f"mixed_prefill partials {dtype}: {N_SH} shards combined differ from 1 shard combined")
        print(f"  mixed_prefill partials packed {dtype}: bitwise the padded form's lanes; {N_SH} shards combined == "
              f"1 shard combined bitwise; the non-owner lanes exact zeros with m = -1e30 (trash blocks poisoned "
              f"with NaN and 1e4)", flush=True)
        kv_k = kp[tables.long()].reshape(R, s_pad, KV, DH).permute(0, 2, 1, 3)
        kv_v = vp[tables.long()].reshape(R, s_pad, KV, DH).permute(0, 2, 1, 3)
        qt = q_pad.permute(0, 2, 1, 3)
        # q of live lanes in; o, m, l of every lane out (f32)
        b_ms, b_by = bound_of(cp.cost(q, kp, vp, tables, d5, owned_1, partials=True, desc_host=d5_h))
        row = dict(
            **timer.turns(dict(
                ms=lambda: cp.mixed_prefill_partials(q, kp, vp, tables, d5, owned=owned_1),
                plain_ms=lambda: cp.mixed_prefill_partials_plain(q, kp, vp, tables, d5, owned=owned_1),
                library_ms=lambda: F.scaled_dot_product_attention(qt, kv_k, kv_v, attn_mask=mask, enable_gqa=True),
                padded_ms=lambda: cp.mixed_prefill_partials(q_pad, kp, vp, tables, desc, owned=owned_1),
                four_shards_ms=lambda: [cp.mixed_prefill_partials(q, kl, vl, loc, d5, owned=own)
                                        for kl, vl, loc, own in shard],
            )),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
            shape=f"partials packed, owned: N={q.shape[0]} lanes of the phase-3 step's mix, H={H} KV={KV} dh={DH} "
                  f"bs={BS} n_t={NT}, one shard owning every block (four_shards_ms: the {N_SH} row-affine shards' "
                  f"calls; padded_ms: the padded form, R={R} W={W}) {dtype}",
        )
        rows["mixed_prefill", dtype, "partials_owned"] = row
        print_row("mixed_prefill", row)
        print(f"  mixed_prefill partials {dtype}: the {N_SH} shards' calls in turn {row['four_shards_ms']:.4f} ms",
              flush=True)
        del q, q_pad, kp, vp, shard, parts, kv_k, kv_v, qt, padded

    # flash-decode over a cache split in 4 along the sequence (the phase-6
    # decode shape): one shard's exact-zero partials timed; dist_decode over 2
    # and 4 shards against flash-decode on the whole cache
    S = 272
    lens_h = [272, 17, 0, 64, 250, 131, 99, 1]
    lens = torch.tensor(lens_h, dtype=torch.int32, device=dev)
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        qd = torch.randn(R, H, DH, generator=gen, device=dev).to(tdt)
        kc = torch.randn(R, S, KV, DH, generator=gen, device=dev).to(tdt)
        vc = torch.randn(R, S, KV, DH, generator=gen, device=dev).to(tdt)
        whole = da.decode_attention(qd, kc, vc, lens, empty_zero=True)
        err = 0.0
        for n in (2, 4):
            got = dist_decode_attention(qd, kc, vc, lens, make_mesh(["cuda:0"] * n))
            if not bool((got[2] == 0).all()):
                fail(f"dist_decode {n} shards {dtype}: the row of length 0 is not 0")
            err = max(err, (got.float() - whole.float()).abs().max().item())
        check(f"dist_decode over 2 and 4 shards against flash_decode on the whole cache, lengths {lens_h}, {dtype}",
              err, dtype)
        step, sh = S // 4, 1  # shard 1: positions 68-135, rows 1, 2 and 3 hold none
        ks, vs = kc[:, sh * step : (sh + 1) * step], vc[:, sh * step : (sh + 1) * step]
        loc = torch.clamp(lens - sh * step, 0, step)
        part = da.decode_attention(qd, ks, vs, loc, return_partials=True, empty_zero=True)
        err_p = partials_err(part, da.decode_attention_plain(qd, ks, vs, loc, return_partials=True, empty_zero=True))
        check(f"flash_decode partials, exact-zero empty rows, shard {sh} of 4 (local lengths {loc.tolist()}), {dtype}",
              err_p, dtype)
        loc_h = loc.tolist()
        mask_s = (torch.arange(step, device=dev)[None, :] < loc[:, None]) | (torch.arange(step, device=dev) == 0)
        b_ms, b_by = bound_of(da.decode_cost(qd, ks, vs, loc, return_partials=True, lengths_host=loc_h))
        row = dict(
            **timer.turns(dict(
                ms=lambda: da.decode_attention(qd, ks, vs, loc, return_partials=True, empty_zero=True),
                plain_ms=lambda: da.decode_attention_plain(qd, ks, vs, loc, return_partials=True, empty_zero=True),
                library_ms=lambda: F.scaled_dot_product_attention(
                    qd[:, :, None], ks.transpose(1, 2), vs.transpose(1, 2), attn_mask=mask_s[:, None, None, :],
                    enable_gqa=True),
            )),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err_p,
            shape=f"partials, exact-zero empty rows: B={R} H={H} KV={KV} dh={DH}, shard {sh} of a 4-way split of "
                  f"S={S} (a strided view of {step} positions), local lengths {loc_h} {dtype}",
        )
        rows["flash_decode", dtype, "partials_empty_zero"] = row
        print_row("flash_decode", row)
        del qd, kc, vc, ks, vs

    # federated top-k over 4 providers at provider scale (phase 3's N = 2^20 x
    # D = 256, Q = 32, k = 8), every provider on the card
    qs = F.normalize(torch.randn(32, 256, generator=gen, device=dev), dim=1)
    cs = F.normalize(torch.randn(1 << 20, 256, generator=gen, device=dev), dim=1)
    mesh = make_mesh(["cuda:0"] * 4)
    s_f, i_f, p_f = federated_topk(qs, cs, m_local=8, n_global=8, mesh=mesh)
    s_w, i_w = rt.retrieval_topk(qs, cs, 8)
    if not (torch.equal(i_f, i_w) and torch.equal(s_f, s_w) and torch.equal(p_f, i_f // (1 << 18))):
        fail("federated_topk over 4 providers differs from retrieval_topk over the whole corpus")
    _, _, p_d = federated_topk(qs, cs, m_local=8, n_global=8, mesh=mesh, alive=torch.tensor([True, False, True, True]))
    if bool((p_d == 1).any()):
        fail("federated_topk: a dead provider's ids appear")
    t = timer.turns(dict(federated=lambda: federated_topk(qs, cs, m_local=8, n_global=8, mesh=mesh),
                         whole=lambda: rt.retrieval_topk(qs, cs, 8)))
    print(f"  federated_topk, 4 providers of 262144 x 256 f32, Q=32, k=8: ids equal and scores bitwise equal to "
          f"retrieval_topk over the whole corpus; a dead provider's ids never appear; {t['federated']:.4f} ms "
          f"against {t['whole']:.4f} ms for the whole corpus in one call", flush=True)
    del qs, cs


def sharded_phase(torch, smi: str, cold: list, timer, rows: dict) -> list[dict]:
    """[17] sharded serving with every shard on the one card (``mesh=``):
    the kernels of [17a]; the phase-4 configuration at shards 1, 2 and 4;
    the prefix cache with its spill tier and self-speculation at 4 shards
    against 1; smoke width f32 against the CPU run."""
    import dataclasses

    import numpy as np

    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.launch.serve import full_width_system
    from repro_torch.runtime.compat import make_mesh
    from repro_torch.serving.engine import ServeConfig, ServeEngine, engine_generator

    sharded_kernels(torch, timer, rows)
    need = ("retrieval_topk", "mixed_prefill")  # decode steps run the partials form too
    runs, served = [], {}
    POOL = 144  # divisible by 4; 36 blocks a shard >= a row's 9, so every arm admits in the same order

    def on_card(n):
        return make_mesh(["cuda:0"] * n)

    sys_, engine, texts = full_width_system(16, "cuda", SEED, n_pool_blocks=POOL, shards=1, mesh=on_card(1))
    engines = {1: engine}
    for n in (1, 2, 4):
        if n not in engines:
            engines[n] = ServeEngine(engine.cfg, engine.params, dataclasses.replace(engine.scfg, shards=n),
                                     device="cuda", mesh=on_card(n))
        sys_.orchestrator.generator = engine_generator(engines[n])
        t0 = time.perf_counter()
        res, launches = serve_phase(torch, smi, sys_, engines[n], texts,
                                    f"sharded pool, {n} shard(s) on cuda:0, qwen3-0.6b full width bf16, pool {POOL}", need)
        st = sys_.last_serve_stats
        served[n] = (res, launches, (st["mixed_dispatches"], st["decode_dispatches"]))
        runs.append(launches)
        print(f"  shards {n}: serve {(time.perf_counter() - t0) * 1e3:.1f} ms with its warm-up, mixed_prefill "
              f"(partials) launches {launches['mixed_prefill']}, paged_decode launches {launches['paged_decode']}, "
              f"dispatches (mixed, decode) {served[n][2]}, cache_nbytes {engines[n].cache_nbytes() / 2**20:.1f} MiB",
              flush=True)
    for n in (2, 4):
        if served[n][2] != served[1][2] or served[n][1]["mixed_prefill"] != n * served[1][1]["mixed_prefill"]:
            fail(f"shards {n}: dispatches {served[n][2]} / launches {served[n][1]['mixed_prefill']} against "
                 f"{served[1][2]} / {n} x {served[1][1]['mixed_prefill']} at shards 1")
        same_answers(served[1][0], served[n][0], f"shards {n} against shards 1 (bitwise)")
    same_answers(cold, served[1][0], "shards 1 against phase 4 (unsharded)", engine, sharded=True)
    del engines, served
    free_device(torch)

    # the prefix cache with the spill tier, two repeats, 4 shards against 1,
    # on phase 8's pool of max_batch rows' blocks plus 8 (80, 20 a shard):
    # the parked chains that later prompts need room for go to the host tier
    # and come back by upload to their own shard, so the hits must equal the
    # 1-shard run's
    out, keep = {}, None
    for n in (1, 4):
        sys_, eng, texts = full_width_system(16, "cuda", SEED, n_pool_blocks=8 * 9 + 8, shards=n, mesh=on_card(n),
                                             prefix_cache=True, spill_bytes=512 << 20)
        sys_.serve(texts[:2], max_new_tokens=2)
        eng.reset_cache()
        reps = []
        for rep in (1, 2):
            res, launches = serve_phase(torch, smi, sys_, eng, texts, f"prefix cache + spill tier, {n} shard(s), "
                                        f"repeat {rep}", need, warm_up=False)
            st = sys_.last_serve_stats
            reps.append((res, st["prefix_hits"], st["prefix_lookups"]))
            runs.append(launches)
        out[n] = (reps, eng._index.n_demotions, eng._index.n_readmits)
        print(f"  prefix cache + spill, {n} shard(s): hits by repeat {[(h, lk) for _, h, lk in reps]}, "
              f"{eng._index.n_demotions} demotions, {eng._index.n_readmits} readmits", flush=True)
        keep = keep or eng  # the 1-shard engine, for the rounding-tie rule below
        del sys_, eng
        free_device(torch)
    if not (out[4][1] > 0 and out[4][2] > 0):
        fail(f"prefix cache + spill at 4 shards: {out[4][1]} demotions, {out[4][2]} readmits")
    for rep in range(2):
        (r1, h1, l1), (r4, h4, l4) = out[1][0][rep], out[4][0][rep]
        if (h1, l1) != (h4, l4):
            fail(f"prefix cache repeat {rep + 1}: hits {h4}/{l4} at 4 shards, {h1}/{l1} at 1")
        # equal hits leave each row's work the same, but a readmission's wait
        # may compose the engine steps differently: the tie rule applies
        same_answers(r1, r4, f"prefix cache + spill repeat {rep + 1}, shards 4 against shards 1", keep, sharded=True)
    del keep
    free_device(torch)

    # self-speculation, draft_k = 3, the drafter's pool sharded like the target's
    spec = {}
    for n in (1, 4):
        sys_, eng, texts = full_width_system(16, "cuda", SEED, n_pool_blocks=POOL, shards=n, mesh=on_card(n),
                                             draft_k=3)
        res, launches = serve_phase(torch, smi, sys_, eng, texts, f"self-speculation draft_k 3, {n} shard(s)", need)
        runs.append(launches)
        st = sys_.last_serve_stats
        spec[n] = res
        print(f"  self-speculation, {n} shard(s): {st['spec_rounds']} rounds, accept rate "
              f"{st.get('spec_accept_rate', 0.0):.4f}", flush=True)
        if st["spec_rounds"] == 0:
            fail("sharded self-speculation ran no rounds")
        del sys_, eng
        free_device(torch)
    same_answers(spec[1], spec[4], "self-speculation, shards 4 against shards 1 (bitwise)")

    # smoke width, f32: shards 1, 2 and 4 on the card and shards 1 on the CPU
    small, p_cpu, p_gpu = small_model(torch, HashTokenizer().vocab_size)
    prompts = [np.asarray(r["prompt"]).reshape(-1) for r in cold[:4]]
    kw = dict(paged=True, max_batch=4, max_prompt_len=256, max_new_tokens=8, block_size=16, n_pool_blocks=68)
    toks = {("cpu", 1): ServeEngine(small, p_cpu, ServeConfig(shards=1, **kw), device="cpu").serve_prompts(prompts)}
    for n in (1, 2, 4):
        toks["cuda", n] = ServeEngine(small, p_gpu, ServeConfig(shards=n, **kw), device="cuda",
                                      mesh=on_card(n)).serve_prompts(prompts)
    checks = {f"{d} x{n}": all(np.array_equal(a, b) for a, b in zip(toks["cpu", 1], t)) for (d, n), t in toks.items()}
    print(f"  smoke width f32, tokens equal to the CPU run's (shards 1): {checks}", flush=True)
    if not all(checks.values()):
        fail(f"smoke-width sharded tokens differ: {checks}")
    return runs


# --------------------------------------------------------------------- #
# phase 18: the hybrid family
# --------------------------------------------------------------------- #


def hybrid_phase(torch, smi: str, cold: list) -> list[dict]:
    """[18] jamba-1.5-large-398b on the contiguous engine: one scan period
    (8 layers: attention, then 7 Mamba2 layers, MoE on the odd ones) with
    the routed experts' hidden width cut to 4,096, every other width as
    published (``launch.serve.FULL_WIDTH_CUTS``), bf16 activations, random
    weights from SEED; then at smoke width in f32."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import FULL_WIDTH_CUTS, full_width_system
    from repro_torch.models import lm as LM
    from repro_torch.models.params import param_bytes
    from repro_torch.serving.engine import ServeConfig, ServeEngine, engine_generator

    arch = "jamba-1.5-large-398b"
    free_device(torch)
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    sys_, engine, texts = full_width_system(16, "cuda", SEED, paged=False, arch=arch)
    torch.cuda.synchronize()
    cfg, pub = engine.cfg, get_config(arch)
    print(f"  built {arch} cut to {FULL_WIDTH_CUTS[arch]} (published: {pub.n_layers} layers, moe_d_ff "
          f"{pub.moe_d_ff}): mixers {[cfg.mixer_kind(i) for i in range(cfg.n_layers)]}, FFNs "
          f"{[cfg.ffn_kind(i) for i in range(cfg.n_layers)]}; d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, d_inner {cfg.d_inner} ({cfg.ssm_heads} SSM heads of "
          f"{cfg.ssm_head_dim}, {cfg.ssm_groups} groups, state {cfg.ssm_state}), {cfg.n_experts} experts top-"
          f"{cfg.moe_top_k}, vocab {cfg.vocab_size}; in {time.perf_counter() - t0:.1f} s: "
          f"{param_bytes(LM.param_specs(cfg)) / 1e9:.2f} GB of f32 weights; resident "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB (was {before / 2**30:.2f}), peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} [{smi}]", flush=True)
    results, launches = serve_phase(torch, smi, sys_, engine, texts, f"contiguous {arch} one period bf16",
                                    ("retrieval_topk", "flash_attention", "flash_decode", "ssd_chunk"))
    for r, c in zip(results, cold, strict=True):
        if list(r["context"]["chunk_ids"]) != list(c["context"]["chunk_ids"]):
            fail("jamba contexts differ from phase 4's")
    print("  jamba contexts equal to phase 4's", flush=True)
    prompt = torch.as_tensor(np.asarray(results[0]["prompt"]).reshape(1, -1), device="cuda")
    with torch.no_grad():
        logits, _ = LM.forward(cfg, engine.params, {"tokens": prompt})
    if tuple(logits.shape) != (1, prompt.shape[1], cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        fail(f"jamba full-width logits: shape {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    print(f"  jamba full-width logits {tuple(logits.shape)} all finite", flush=True)
    try:
        ServeEngine(cfg, engine.params, ServeConfig(paged=True, max_batch=8, max_prompt_len=256, max_new_tokens=16))
    except ValueError as e:
        print(f"  the paged engine refuses jamba: {e}", flush=True)
    else:
        fail("the paged engine took jamba")
    prompts = [np.asarray(r["prompt"]).reshape(-1) for r in results[:4]]
    vocab = sys_.tok.vocab_size
    del sys_, engine, logits, results
    free_device(torch)

    # smoke width (16 layers, 8 groups, chunk 16: a 256-wide prefill runs 16
    # chunks), f32: contiguous == lock-step on the card, and the card's
    # tokens == the CPU run's
    small, p_cpu, p_gpu = small_model(torch, vocab, arch)
    kw = dict(max_batch=4, max_prompt_len=256, max_new_tokens=8)
    cont = ServeEngine(small, p_gpu, ServeConfig(**kw), device="cuda").serve_prompts(prompts)
    lock = engine_generator(ServeEngine(small, p_gpu, ServeConfig(**kw), device="cuda"), mode="lockstep")
    lock = lock.generate_batch(prompts)
    cpu = ServeEngine(small, p_cpu, ServeConfig(**kw), device="cpu").serve_prompts(prompts)
    checks = {
        "lock-step": all(np.array_equal(a, b[: len(a)]) for a, b in zip(cont, lock)),
        "CPU": all(np.array_equal(a, b) for a, b in zip(cont, cpu)),
    }
    print(f"  smoke-width jamba tokens on the card equal: {checks}", flush=True)
    if not all(checks.values()):
        fail(f"smoke-width jamba tokens differ: {checks}; card {[list(t) for t in cont]}, "
             f"CPU {[list(t) for t in cpu]}")
    return [launches]


# --------------------------------------------------------------------- #
# phase 19: multi-device training, every coordinate on the one card
# --------------------------------------------------------------------- #


class StepParts:
    """Inside ``with``: the data-parallel step's parts on the host clock,
    each synchronised: every data shard's forward + backward
    (``steps.value_and_grad``, which ``data_parallel_grads`` calls once a
    shard) and, through ``opt()``, the optimizer's update.  The rest of a
    step (the batch's placement, the global token count, the gradient
    reduction in shard order, the metrics) is its time less those."""

    def __init__(self, torch):
        from repro_torch.runtime import steps

        self.torch, self.steps, self.orig = torch, steps, steps.value_and_grad
        self.shard: list[float] = []
        self.update: list[float] = []

    def _timed(self, fn, into: list):
        def call(*a, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.torch.cuda.synchronize()
            into.append(time.perf_counter() - t0)
            return out

        return call

    def __enter__(self):
        self.steps.value_and_grad = self._timed(self.orig, self.shard)
        return self

    def __exit__(self, *exc):
        self.steps.value_and_grad = self.orig

    def opt(self, opt):
        from repro_torch.optim.optimizers import Optimizer

        return Optimizer(init=opt.init, update=self._timed(opt.update, self.update), name=opt.name)

    def summary(self, step_times: list, dp: int) -> str:
        """Medians over the steps after the first."""
        n = len(step_times)
        per = [sum(self.shard[i * dp:(i + 1) * dp]) for i in range(n)]
        rest = [t - s - u for t, s, u in zip(step_times, per, self.update)]
        med = {k: statistics.median(v[1:] if n > 1 else v) for k, v in
               (("step", step_times), ("shards", per), ("rest", rest), ("update", self.update))}
        each = statistics.median(self.shard[dp:] if n > 1 else self.shard)
        return (f"step {med['step']:.3f} s (median of steps 2-{n}): forward + backward {med['shards']:.3f} s over "
                f"{dp} shards ({each:.3f} s a shard), reduction and the rest {med['rest']:.3f} s, update "
                f"{med['update']:.3f} s")


def window_phase(torch, smi: str, timer) -> list[dict]:
    """Mellum2-12B-A2.5B's sliding window on the kernels: ``mixed_prefill``
    and ``paged_decode`` with a window of 1,024 keys at its heads (32 query
    heads over 4 KV heads, G = 8, head_dim 128, bs 32), f32 and bf16,
    against their plain versions at the dtype's tolerance: a fill's chunk
    across position 1,024 (the window's edge inside it), its first chunk, a
    chunk past 1,900 and one-lane rows around the window's length, packed
    (bitwise the padded form over the same rows), and decode rows from 1 to
    2,240 positions.  A window wider than every row gives the window-0
    kernels' output bit for bit.  Then, in bf16 at the cell's serving mix
    (one fill of 2,900 lanes beside 15 decode rows of 2,900-4,100
    positions, 16 rows of 4,448 positions), each windowed kernel timed in
    turns with its window-0 launch, with both bounds."""
    import numpy as np

    from repro_torch.kernels.chunked_prefill import ops as cp
    from repro_torch.kernels.decode_attention import ops as da

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(30)
    h, kv, dh, bs, win = 32, 4, 128, 32, 1024

    def pool(b, n_t, tdt):
        n_pool = b * n_t + 1
        kp, vp = (torch.randn(n_pool, bs, kv, dh, generator=gen, device=dev).to(tdt) for _ in range(2))
        tables = torch.randperm(n_pool - 1, device=dev, generator=gen)[: b * n_t].view(b, n_t).int()
        return kp, vp, tables

    def packed(rows4):
        offs = np.cumsum([0] + [d[2] for d in rows4])[:-1]
        d4 = torch.tensor(rows4, dtype=torch.int32, device=dev)
        d5 = torch.tensor([(*d, int(o)) for d, o in zip(rows4, offs)], dtype=torch.int32, device=dev)
        at_r = torch.tensor([i for i, d in enumerate(rows4) for _ in range(d[2])], device=dev)
        at_j = torch.tensor([j for d in rows4 for j in range(d[2])], device=dev)
        return d4, d5, at_r, at_j

    rows4 = [(0, 600, 1200, 1800), (1, 0, 600, 600), (2, 1900, 300, 2200), (3, 1022, 1, 1023), (4, 1023, 1, 1024),
             (5, 1024, 1, 1025), (6, 2239, 1, 2240), (7, 0, 1, 1)]
    lens = torch.tensor([1, 1023, 1024, 1025, 1087, 1500, 2200, 2240], dtype=torch.int32, device=dev)
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        kp, vp, tables = pool(8, 70, tdt)
        d4, d5, at_r, at_j = packed(rows4)
        q = torch.randn(int(d5[-1, 4] + d5[-1, 2]), h, dh, generator=gen, device=dev).to(tdt)
        o = cp.mixed_prefill_attention(q, kp, vp, tables, d5, window=win)
        plain = cp.mixed_prefill_attention_plain(q, kp, vp, tables, d5, win)
        check(f"mixed_prefill window {win}, G=8, packed, {dtype}", (o.float() - plain.float()).abs().max().item(),
              dtype)
        del plain
        qp = torch.zeros((len(rows4), max(d[2] for d in rows4), h, dh), dtype=tdt, device=dev)
        qp[at_r, at_j] = q
        if not torch.equal(cp.mixed_prefill_attention(qp, kp, vp, tables, d4, window=win)[at_r, at_j], o):
            fail(f"mixed_prefill window {win} {dtype}: the packed lanes differ from the padded form's")
        if not torch.equal(cp.mixed_prefill_attention(q, kp, vp, tables, d5, window=10**6),
                           cp.mixed_prefill_attention(q, kp, vp, tables, d5)):
            fail(f"mixed_prefill {dtype}: a window past every row differs from the window-0 kernel")
        qd = torch.randn(8, h, dh, generator=gen, device=dev).to(tdt)
        od = da.paged_decode_attention(qd, kp, vp, tables, lens, window=win)
        err = (od.float() - da.paged_decode_attention_plain(qd, kp, vp, tables, lens, win).float()).abs().max()
        check(f"paged_decode window {win}, G=8, lengths 1-2,240, {dtype}", err.item(), dtype)
        if not torch.equal(da.paged_decode_attention(qd, kp, vp, tables, lens, window=10**6),
                           da.paged_decode_attention(qd, kp, vp, tables, lens)):
            fail(f"paged_decode {dtype}: a window past every row differs from the window-0 kernel")
        print(f"  window {win} {dtype}: packed == padded bitwise; a window past every row == window 0 bitwise, "
              f"both kernels", flush=True)
        del kp, vp, q, qp

    # the cell's serving mix, bf16: windowed against window 0, in turns
    kp, vp, tables = pool(16, 139, torch.bfloat16)
    ctx = [int(x) for x in torch.randint(2900, 4100, (15,), generator=gen, device=dev)]
    rows4 = [(0, 0, 2900, 2900)] + [(i + 1, c - 1, 1, c) for i, c in enumerate(ctx)]
    _, d5, _, _ = packed(rows4)
    d5_h = d5.tolist()
    q = torch.randn(2915, h, dh, generator=gen, device=dev).to(torch.bfloat16)
    t = timer.turns(dict(window=lambda: cp.mixed_prefill_attention(q, kp, vp, tables, d5, window=win),
                         full=lambda: cp.mixed_prefill_attention(q, kp, vp, tables, d5)))
    b_w, by_w = bound_of(cp.cost(q, kp, vp, tables, d5, desc_host=d5_h, window=win))
    b_f, by_f = bound_of(cp.cost(q, kp, vp, tables, d5, desc_host=d5_h))
    out = [{"kernel": "mixed_prefill", "window_ms": t["window"], "full_ms": t["full"], "window_bound_ms": b_w,
            "full_bound_ms": b_f}]
    print(f"  mixed_prefill, one fill of 2,900 lanes + 15 decode rows of 2,900-4,100, H=32 KV=4 dh=128 bf16: "
          f"window {win} {t['window']:.4f} ms (bound {b_w:.6f}, {by_w}; {100 * b_w / t['window']:.1f}%), "
          f"window 0 {t['full']:.4f} ms (bound {b_f:.6f}, {by_f}; {100 * b_f / t['full']:.1f}%)", flush=True)
    lens = torch.tensor([2900] + ctx, dtype=torch.int32, device=dev)
    qd = torch.randn(16, h, dh, generator=gen, device=dev).to(torch.bfloat16)
    t = timer.turns(dict(window=lambda: da.paged_decode_attention(qd, kp, vp, tables, lens, window=win),
                         full=lambda: da.paged_decode_attention(qd, kp, vp, tables, lens)))
    b_w, by_w = bound_of(da.paged_cost(qd, kp, vp, tables, lens, lengths_host=lens.tolist(), window=win))
    b_f, by_f = bound_of(da.paged_cost(qd, kp, vp, tables, lens, lengths_host=lens.tolist()))
    out.append({"kernel": "paged_decode", "window_ms": t["window"], "full_ms": t["full"], "window_bound_ms": b_w,
                "full_bound_ms": b_f})
    print(f"  paged_decode, 16 rows of 2,900-4,100 positions, H=32 KV=4 dh=128 bf16: window {win} "
          f"{t['window']:.4f} ms (bound {b_w:.6f}, {by_w}; {100 * b_w / t['window']:.1f}%), window 0 "
          f"{t['full']:.4f} ms (bound {b_f:.6f}, {by_f}; {100 * b_f / t['full']:.1f}%)", flush=True)
    print(f"  {json.dumps({'window_kernels': out})}", flush=True)
    return []


def mesh_of(dp: int, tp: int = 1, device: str = "cuda:0"):
    from repro_torch.runtime.compat import make_mesh

    return make_mesh([device] * (dp * tp), ("data", "model"), shape=(dp, tp))


def placed_right(torch, full, st) -> bool:
    """Whether the placement ``st`` holds ``full``: each coordinate's block
    bitwise its slice, on that coordinate's device."""
    sh = st.sharding
    counts = sh.blocks_along(full.ndim)
    for coord, blk in zip(sh.mesh.coords(), st.blocks):
        want = full
        for d, (i, n) in enumerate(zip(sh.block_index(coord, full.ndim), counts)):
            step = full.shape[d] // n
            want = want.narrow(d, i * step, step)
        if blk.device != sh.mesh.device(coord) or not torch.equal(blk, want):
            return False
    return torch.equal(st.full(), full)


def smoke_dp_matches_cpu(torch, arch: str, shape, impl: str = "psum") -> None:
    """Smoke width, f32: the data-parallel gradients on a mesh of cuda:0
    against the same step on a mesh of cpu (loss 1e-5 relative, each leaf
    1e-4 of its largest entry)."""
    import numpy as np

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.models import lm as LM
    from repro_torch.models.params import init_params, leaves, map_tree
    from repro_torch.runtime.sharding import make_policy
    from repro_torch.runtime.steps import data_parallel_grads

    cfg = smoke_config(get_config(arch)).with_overrides(dtype="float32", remat="block", vocab_size=512,
                                                        moe_impl=impl)
    p_cpu = init_params(LM.param_specs(cfg), torch.Generator().manual_seed(SEED), device="cpu")
    rng = np.random.default_rng(SEED)
    tok = rng.integers(0, 512, size=(8, 64)).astype(np.int32)
    tgt = tok.copy()
    tgt[0, 3:] = -1
    tgt[5, ::2] = -1
    batch = {"tokens": tok, "targets": tgt}
    out = {}
    for dev in ("cpu", "cuda:0"):
        mesh = mesh_of(*shape, device=dev)
        pol = make_policy(mesh, global_batch=8)
        params = p_cpu if dev == "cpu" else map_tree(lambda t: t.to(dev), p_cpu)
        out[dev] = data_parallel_grads(cfg, pol, params, shard_batch(batch, mesh, pol.spec("act_batch", shape=(8,))))
    torch.cuda.synchronize()
    loss_err = abs(float(out["cuda:0"][0]) - float(out["cpu"][0])) / abs(float(out["cpu"][0]))
    want = dict(leaves(out["cpu"][2]))
    err = max(float((g.cpu() - want[path]).abs().max()) / max(float(want[path].abs().max()), 1e-30)
              for path, g in leaves(out["cuda:0"][2]))
    ok = loss_err <= 1e-5 and err <= 1e-4
    print(f"  smoke width f32, {arch} on {shape} ({impl}): card against CPU, loss {loss_err:.2e} relative (tol "
          f"1e-5), gradients {err:.2e} of the leaf's largest (tol 1e-4) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"smoke-width {arch} {shape} {impl}: the card's data-parallel step differs from the CPU's")


def multidevice_phase(torch, smi: str) -> list[dict]:
    """[19] multi-device training on one card: the data-parallel step, the
    elastic restore and expert parallelism over meshes of cuda:0."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import LMBatchStream, shard_batch
    from repro_torch.models import lm as LM
    from repro_torch.models import moe as MOE
    from repro_torch.models.layers import mlp_apply
    from repro_torch.models.params import init_params, leaves, make_pspecs, make_shardings, map_tree, param_count
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.runtime import trace
    from repro_torch.runtime.sharding import ShardedTensor, ShardingPolicy, base_rules, make_policy
    from repro_torch.runtime.steps import data_parallel_grads, make_train_step
    from repro_torch.runtime.train_loop import SimulatedFailure, Trainer, TrainerConfig

    free_device(torch)
    runs = []
    cfg = get_config("qwen3-0.6b")  # phase 13's: bf16 activations, f32 weights and AdamW moments, remat per block
    lr, batch, seq = 3e-4, 8, 256
    specs = LM.param_specs(cfg)
    first = LMBatchStream(batch, seq, cfg.vocab_size, seed=SEED).next()
    params = init_params(specs, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    with torch.no_grad():
        want0 = float(LM.loss_fn(cfg, params, {k: torch.as_tensor(v, device="cuda") for k, v in first.items()})[0])
    print(f"  qwen3-0.6b full width ({param_count(specs) / 1e9:.3f} B parameters), batch {batch} x {seq}: the "
          f"unsharded step 0's loss {want0:.6f}", flush=True)
    for dp in (2, 4):  # every leaf's gradient; the reduce-scatter form bitwise the all-reduce form
        mesh = mesh_of(dp)
        pol = make_policy(mesh, global_batch=batch, seq_len=seq)
        placed = shard_batch(first, mesh, pol.spec("act_batch", shape=(batch,)))
        _, _, grads = data_parallel_grads(cfg, pol, params, placed)
        check_grads(torch, f"qwen3-0.6b dp {dp}", grads)
        pspecs = make_pspecs(specs, pol.rules, dict(mesh.shape))
        _, _, rs = data_parallel_grads(cfg, pol, params, placed, grad_pspecs=pspecs)
        bad = [path for (path, a), (_, b) in zip(leaves(grads), leaves(rs)) if not torch.equal(a, b)]
        n_rs = sum(any(e == "data" for e in spec) for _, spec in leaves(pspecs))
        print(f"  dp {dp}: every leaf's gradient finite and non-zero; grad_pspecs reduce-scatters {n_rs} of "
              f"{len(leaves(pspecs))} leaves over data, bitwise equal to the all-reduce form: {not bad}", flush=True)
        if bad:
            fail(f"dp {dp}: the reduce-scatter form differs from the all-reduce form at {bad[:5]}")
        del grads, rs
        # the loss falls over 3 steps on one repeated batch (the stream's own
        # losses need not: phase 13's rise over its first 3 fresh batches)
        opt = get_optimizer("adamw")
        step = make_train_step(cfg, opt, lambda s: lr, pol=pol)
        p, st, rep = params, opt.init(params), []
        for i in range(3):
            p, st, m = step(p, st, placed, i)
            rep.append(float(m["loss"]))
        print(f"  dp {dp}, one repeated batch: losses {[round(x, 4) for x in rep]}", flush=True)
        if not rep[-1] < rep[0] or not all(np.isfinite(rep)):
            fail(f"dp {dp}: the loss does not fall over 3 steps on one batch: {rep}")
        del p, st, m, step, placed
    del params
    free_device(torch)

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_dp_"))
    try:
        def trainer(tag, dp, steps, clock=None, **kw):
            mesh = mesh_of(dp)
            pol = make_policy(mesh, global_batch=batch, seq_len=seq)
            opt = get_optimizer("adamw")
            return Trainer(cfg, clock.opt(opt) if clock else opt, LMBatchStream(batch, seq, cfg.vocab_size, seed=SEED),
                           TrainerConfig(total_steps=steps, ckpt_dir=str(root / tag), **kw), lr_fn=lambda s: lr,
                           pol=pol, shardings=make_shardings(specs, mesh, pol.rules))

        losses = {}
        for dp in (2, 4):
            with StepParts(torch) as clock:
                t = trainer(f"dp{dp}", dp, 3, clock, ckpt_every=2 if dp == 2 else 3)  # dp 2's step 1: the mesh change
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                t.run(resume="never", seed=SEED)
                runs.append(read_launches(f"the dp-{dp} training run", ("flash_attention",)))
            if runs[-1]["flash_attention"] < 2 * cfg.n_blocks * dp * 3:
                fail(f"dp {dp}: flash_attention launched {runs[-1]['flash_attention']} times, fewer than forward + "
                     f"remat recompute of {cfg.n_blocks} layers x {dp} shards x 3 steps")
            losses[dp] = [m["loss"] for m in t.metrics_log]
            rel0 = abs(losses[dp][0] - want0) / abs(want0)
            print(f"  dp {dp} on {[str(d) for d in t.mesh.devices]}: losses {[round(x, 4) for x in losses[dp]]}, "
                  f"step 0 {rel0:.2e} relative to the unsharded (tol 1e-3); {clock.summary(t.step_times, dp)}; "
                  f"{peak_line(torch, smi)}", flush=True)
            if rel0 > 1e-3 or not all(np.isfinite(losses[dp])):
                fail(f"dp {dp}: losses {losses[dp]} (step 0 within 1e-3 of {want0}, finite)")
            del t
            if dp == 4:
                shutil.rmtree(root / "dp4", ignore_errors=True)
            free_device(torch)

        # the elastic restore: a crash at step 2 on (2, 1), resumed onto (4, 1)
        crashed = trainer("crash", 2, 3, ckpt_every=2, fail_at_step=2)
        try:
            crashed.run(resume="never", seed=SEED)
            fail("the run with fail_at_step=2 did not fail")
        except SimulatedFailure as e:
            print(f"  killed: {e} (the last checkpoint at step {crashed.ckpt.latest_step()})", flush=True)
        same = [m["loss"] for m in crashed.metrics_log] == losses[2][:2]
        print(f"  the crashed run's losses equal the dp-2 run's before the crash, bitwise: {same}", flush=True)
        if not same:
            fail(f"the crashed run's losses {[m['loss'] for m in crashed.metrics_log]} != {losses[2][:2]}")
        mesh4 = mesh_of(4)
        pol4 = make_policy(mesh4, global_batch=batch, seq_len=seq)
        resumer = trainer("crash", 4, 3)
        like = resumer.init_state(SEED)
        t0 = time.perf_counter()
        saved, extra, at = crashed.ckpt.restore(like, device="cuda")
        placed, _, _ = crashed.ckpt.restore(like, shardings=(resumer.shardings, resumer.state_shardings(like[1])))
        t_restore = time.perf_counter() - t0
        flat_saved = leaves(saved[0]) + leaves(saved[1])
        flat_placed = leaves(placed[0]) + leaves(placed[1])
        bad = [path for (path, a), (_, b) in zip(flat_saved, flat_placed)
               if not (isinstance(b, ShardedTensor) and placed_right(torch, a, b))]
        n_split = sum(any(e is not None for e in b.sharding.spec) for _, b in flat_placed)
        print(f"  restored step {at} onto (4, 1) in {t_restore:.1f} s (two restores, hashes checked): "
              f"{len(flat_placed)} leaves, {n_split} of them split over data, each bitwise the saved one with "
              f"every block on its coordinate: {not bad}", flush=True)
        if bad:
            fail(f"the elastic restore differs from the saved tree at {bad[:5]}")
        del like, placed
        # the run that changes mesh at step 2 without a crash: the dp-2 run's
        # checkpoint of step 1, its next batch, one step on (4, 1)
        plain = CheckpointManager(str(root / "dp2"))
        state, extra2, _ = plain.restore(saved, step=1, device="cuda")
        stream = LMBatchStream(batch, seq, cfg.vocab_size, seed=SEED)
        stream.load_state_dict(extra2["stream"])
        step4 = make_train_step(cfg, get_optimizer("adamw"), lambda s: lr, pol=pol4)
        _, _, m = step4(state[0], state[1], shard_batch(stream.next(), mesh4, pol4.spec("act_batch", shape=(batch,))), 2)
        switch = float(m["loss"])
        del state, saved, m
        shutil.rmtree(root / "dp2", ignore_errors=True)
        free_device(torch)
        reset_launches()
        t0 = time.perf_counter()
        resumer.run(resume="auto", seed=SEED)
        runs.append(read_launches("the resumed run on (4, 1)", ("flash_attention",)))
        got = resumer.metrics_log[0]["loss"]
        print(f"  resumed on (4, 1) at step {resumer.metrics_log[0]['step']} in {time.perf_counter() - t0:.1f} s "
              f"(restore included): loss {got:.6f}; the mesh changed at step 2 without a crash: {switch:.6f}; the "
              f"dp-2 run's step 2: {losses[2][2]:.6f}", flush=True)
        if not math.isclose(got, switch, rel_tol=1e-5):
            fail(f"resumed loss {got} != the uncrashed mesh change's {switch} (rel 1e-5)")
        del crashed, resumer
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free_device(torch)

    # mamba2-1.3b: 2 steps on (2, 1) through ssd_chunk
    mcfg = get_config("mamba2-1.3b")
    mesh = mesh_of(2)
    pol = make_policy(mesh, global_batch=batch, seq_len=seq)
    opt = get_optimizer("adamw")
    params = init_params(LM.param_specs(mcfg), torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    stream = LMBatchStream(batch, seq, mcfg.vocab_size, seed=SEED)
    raw = stream.next()
    with torch.no_grad():
        want0 = float(LM.loss_fn(mcfg, params, {k: torch.as_tensor(v, device="cuda") for k, v in raw.items()})[0])
    state = opt.init(params)
    step = make_train_step(mcfg, opt, lambda s: lr, pol=pol)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    mlosses, times = [], []
    for i in range(2):
        t0 = time.perf_counter()
        params, state, m = step(params, state, shard_batch(raw, mesh, pol.spec("act_batch", shape=(batch,))), i)
        mlosses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
        raw = stream.next()
    runs.append(read_launches("two mamba2-1.3b steps on (2, 1)", ("ssd_chunk",)))
    rel0 = abs(mlosses[0] - want0) / abs(want0)
    print(f"  mamba2-1.3b full width on (2, 1): losses {[round(x, 4) for x in mlosses]}, step 0 {rel0:.2e} relative "
          f"to the unsharded {want0:.6f} (tol 1e-3); steps {[round(x, 3) for x in times]} s; {peak_line(torch, smi)}",
          flush=True)
    if rel0 > 1e-3 or not all(np.isfinite(mlosses)):
        fail(f"mamba2-1.3b on (2, 1): losses {mlosses} against the unsharded {want0}")
    del params, state, step
    free_device(torch)

    # expert parallelism (a): one MoE layer at qwen2-moe-a2.7b's published widths
    mesh24 = mesh_of(2, 4)
    base = get_config("qwen2-moe-a2.7b").with_overrides(dtype="float32")
    p = init_params(MOE.moe_specs(base), torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x = torch.randn(8, 256, base.d_model, generator=gen, device="cuda")
    up = torch.randn(8, 256, base.d_model, generator=gen, device="cuda")
    pol24 = ShardingPolicy(rules=base_rules(False), mesh=mesh24)
    dense, _ = MOE.moe_reference(base, p, x)
    with torch.no_grad():
        dense = dense + mlp_apply(base, p["shared"], x) * torch.sigmoid(x @ p["shared_gate"])
    p_cpu, x_cpu = map_tree(lambda t: t.cpu(), p), x.cpu()
    pol_cpu = ShardingPolicy(rules=base_rules(False), mesh=mesh_of(2, 4, "cpu"))
    print(f"  qwen2-moe-a2.7b MoE layer: d {base.d_model}, {base.n_experts} experts as "
          f"{p['wg'].shape[0]} ({p['wg'].shape[0] // 4} a model shard), top-{base.moe_top_k}, moe_d_ff "
          f"{base.moe_d_ff}, {base.n_shared_experts} shared; x (8, 256, {base.d_model}) f32 on (2, 4)", flush=True)
    for impl in ("psum", "a2a"):
        with torch.no_grad():
            at8, _ = MOE.moe_apply(base.with_overrides(capacity_slack=8.0, moe_impl=impl), p, x, pol=pol24)
        err8 = float((at8 - dense).abs().max()) / float(dense.abs().max())
        cfg_i = base.with_overrides(moe_impl=impl)
        live = map_tree(lambda t: t.detach().requires_grad_(True), p)
        xl = x.detach().requires_grad_(True)
        syncs = trace.counters().get("moe.group_sizes", 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, aux = MOE.moe_apply(cfg_i, live, xl, pol=pol24)
        torch.cuda.synchronize()
        t_fwd, syncs = time.perf_counter() - t0, trace.counters().get("moe.group_sizes", 0) - syncs
        grads = torch.autograd.grad((out * up).sum() + aux, [xl] + [t for _, t in leaves(live)])
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        with torch.no_grad():
            ref_cpu, aux_cpu = MOE.moe_apply(cfg_i, p_cpu, x_cpu, pol=pol_cpu)
        err_cpu = float((out.detach().cpu() - ref_cpu).abs().max()) / float(ref_cpu.abs().max())
        aux = aux.detach()
        aux_err = abs(float(aux) - float(aux_cpu)) / abs(float(aux_cpu))
        ok = err8 <= 3e-5 and err_cpu <= 1e-5 and aux_err <= 1e-5 and finite
        print(f"  {impl}: slack 8 against moe_reference {err8:.2e} of the largest output (tol 3e-5); at the config's "
              f"slack {base.capacity_slack} against the CPU run {err_cpu:.2e} (tol 1e-5), aux {float(aux):.6f} "
              f"({aux_err:.1e} off); backward finite: {finite}; forward {t_fwd:.3f} s with {syncs} expert-loop host "
              f"syncs {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"qwen2-moe EP layer {impl} disagrees")
        del at8, live, xl, out, aux, grads, ref_cpu
    del p, p_cpu, x, x_cpu, up, dense
    free_device(torch)

    # expert parallelism (b): a train step, depth cut 24 -> 2 (all 24 layers'
    # 15.15 B parameters with AdamW's moments and gradients in f32 are about
    # 242 GB; 2 layers are 1.83 B, about 37 GB before activations at dp 2)
    for impl in ("psum", "a2a"):
        ecfg = get_config("qwen2-moe-a2.7b").with_overrides(n_layers=2, moe_impl=impl)
        pol = make_policy(mesh24, global_batch=batch, seq_len=seq)
        params = init_params(LM.param_specs(ecfg), torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
        state = opt.init(params)
        step = make_train_step(ecfg, opt, lambda s: lr, pol=pol)
        stream = LMBatchStream(batch, seq, ecfg.vocab_size, seed=SEED)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        syncs = trace.counters().get("moe.group_sizes", 0)
        elosses, auxes, times = [], [], []
        for i in range(2):
            t0 = time.perf_counter()
            params, state, m = step(params, state, shard_batch(stream.next(), mesh24,
                                                               pol.spec("act_batch", shape=(batch,))), i)
            elosses.append(float(m["loss"]))
            auxes.append(float(m["aux"]))
            times.append(time.perf_counter() - t0)
        syncs = trace.counters().get("moe.group_sizes", 0) - syncs
        runs.append(read_launches(f"two qwen2-moe-a2.7b {impl} steps on (2, 4)", ("flash_attention",)))
        print(f"  qwen2-moe-a2.7b {impl} on (2, 4), depth cut 24 -> 2 ({param_count(LM.param_specs(ecfg)) / 1e9:.3f} B "
              f"parameters; published {param_count(LM.param_specs(get_config('qwen2-moe-a2.7b'))) / 1e9:.2f} B), "
              f"batch {batch} x {seq}: losses {[round(v, 4) for v in elosses]}, aux {[round(v, 4) for v in auxes]}; "
              f"steps {[round(v, 3) for v in times]} s; {syncs // 2} expert-loop host syncs a step (2 layers x 2 data "
              f"shards x 4 model shards a pass; remat {ecfg.remat!r}); {peak_line(torch, smi)}", flush=True)
        if not all(np.isfinite(elosses + auxes)):
            fail(f"qwen2-moe {impl} train step: losses {elosses}, aux {auxes}")
        del params, state, step
        free_device(torch)

    # smoke width, f32: the card's DP and EP steps equal the CPU run's
    smoke_dp_matches_cpu(torch, "qwen3-0.6b", (2, 1))
    smoke_dp_matches_cpu(torch, "qwen3-0.6b", (4, 1))
    for impl in ("psum", "a2a"):
        smoke_dp_matches_cpu(torch, "qwen2-moe-a2.7b", (2, 4), impl)
    return runs


def _sgd(params, grads, lr: float):
    from repro_torch.models.params import map_tree

    return map_tree(lambda p, g: p - lr * g, params, grads)



# --------------------------------------------------------------------- #
# phase 20: the dry run's roofline held against steps timed on the card
# --------------------------------------------------------------------- #


def roofline_phase(torch, smi: str) -> list[dict]:
    """[20] ``launch/dryrun.py``'s count on ``meta`` against the same step
    counted on the card, the step's share of its bound, memory, and the
    hillclimb baselines on the meta mesh."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.roofline import PEAK_FLOPS, Roofline, model_flops_for
    from repro_torch.runtime.sharding import make_policy

    free_device(torch)
    train = ShapeConfig("train_8x256", 256, 8, "train")  # phase 13's batch; f32 weights and AdamW, bf16, remat
    cells = [  # (arch, shape, data shards of a (dp, 1) mesh or None, the kernels the step launches)
        ("qwen3-0.6b", train, None, ("flash_attention",)),
        ("qwen3-0.6b", ShapeConfig("prefill_8x256", 256, 8, "prefill"), None, ("flash_attention",)),  # phase 6's admit
        ("qwen3-0.6b", ShapeConfig("decode_8x272", 272, 8, "decode"), None, ("flash_decode",)),  # phase 6's stripe
        ("mamba2-1.3b", train, None, ("ssd_chunk",)),
        ("qwen3-0.6b", train, 2, ("flash_attention",)),  # phase 19's (2, 1) mesh
    ]
    runs = []
    for arch, shape, dp, need in cells:
        cfg = get_config(arch)
        label = f"{arch} {shape.name}" + (f" on ({dp}, 1) x cuda:0" if dp else "")

        def policy(device):
            if dp is None:
                return make_policy(None)
            return make_policy(mesh_of(dp, device=device), shape_kind=shape.kind, global_batch=shape.global_batch,
                               seq_len=shape.seq_len)

        # (a) the dry run's count on meta, the same step's on the card
        before = launch_counts()
        t0 = time.perf_counter()
        meta, _ = D._run_cell(cfg, shape, policy("meta"), "adamw")
        meta_s = time.perf_counter() - t0
        if launch_counts() != before:
            fail(f"{label}: a kernel launched during the meta run: {before} -> {launch_counts()}")
        step, args, info = D.cell_args(cfg, shape, policy("cuda:0"), "adamw", device="cuda:0",
                                       generator=torch.Generator(device="cuda").manual_seed(SEED))
        free_device(torch)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        card, _, _ = D.count_step(step, args, info["cache"])
        torch.cuda.synchronize()
        runs.append(read_launches(f"the counted {label} step", need))
        peak_card = torch.cuda.max_memory_allocated()
        pairs = {k: (getattr(meta, k), getattr(card, k)) for k in ("flops", "bytes", "convert_bytes")}
        pairs["collective_count"] = (meta.collectives["collective_count"], card.collectives["collective_count"])
        print(f"  {label}: meta (in {meta_s:.1f} s) / card: " + ", ".join(
            f"{k} {m:.6e} / {c:.6e}" for k, (m, c) in pairs.items()) + f"; kernels {card.kernels}", flush=True)
        if any(m != c for m, c in pairs.values()) or meta.collectives != card.collectives or \
                meta.kernels != card.kernels:
            fail(f"{label}: the meta count differs from the card's: {pairs}, {meta.collectives} / "
                 f"{card.collectives}, {meta.kernels} / {card.kernels}")
        # (b) the measured step against its bound: every coordinate's work
        # runs on the one card, so the bound is the one card's
        times = []
        for i in range(7):  # 2 warm-ups, then the median of 5
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            if i >= 2:
                times.append(time.perf_counter() - t0)
            del out
        measured = statistics.median(times)
        rl = Roofline(arch, shape.name, "one card", 1, card.flops, card.bytes,
                      sum(v for k, v in card.collectives.items() if k != "collective_count"),
                      dict(card.collectives), model_flops_for(cfg, shape), card.peak_bytes)
        share = rl.step_bound_s / measured
        mfu = rl.model_flops / (PEAK_FLOPS * measured)
        print(f"  {label}: bound_s {rl.step_bound_s:.6f} ({rl.dominant}: compute {rl.compute_s:.6f}, memory "
              f"{rl.memory_s:.6f}, collective {rl.collective_s:.6f}), measured_s {measured:.6f} (median of 5 after 2 "
              f"warm-ups, {min(times):.6f}-{max(times):.6f}), share {share:.4f}, mfu {mfu:.4f}; convert_bytes "
              f"{card.convert_bytes / card.bytes:.1%} of bytes ({smi})", flush=True)
        # (c) memory: the counter's high-water mark beside the allocator's
        print(f"  {label}: counter peak {card.peak_bytes / 2**30:.3f} GiB, max_memory_allocated "
              f"{peak_card / 2**30:.3f} GiB (ratio {card.peak_bytes / peak_card:.3f})", flush=True)
        if share > 1.05:
            fail(f"{label}: the card beat the bound ({share:.4f} of it): a wrong count")
        del step, args, info, meta, card
        free_device(torch)

    # (d) the hillclimb baselines on the meta mesh
    before = launch_counts()
    t0, c0 = time.perf_counter(), time.process_time()
    for tag, arch, shape_name in (("A0", "qwen3-4b", "decode_32k"), ("B0", "qwen2-moe-a2.7b", "train_4k"),
                                  ("C0", "smollm-360m", "train_4k")):
        r = D.dryrun_cell(arch, shape_name, "single", verbose=False)
        if r["status"] != "ok":
            fail(f"hillclimb baseline {tag} ({arch} x {shape_name}): {r}")
        print(f"  {tag} {arch} x {shape_name} on the (16, 16) meta mesh: {r['compile_s']:.1f} s, bound "
              f"{r['step_bound_s'] * 1e3:.2f} ms ({r['dominant']}), mfu_bound {r['mfu_bound']:.4f}, mem/device "
              f"{r['memory_analysis']['peak_bytes_per_device'] / 2**30:.2f} GiB (arithmetic on the H100 SXM peaks)",
              flush=True)
    if launch_counts() != before:
        fail(f"a kernel launched during the meta dry runs: {before} -> {launch_counts()}")
    print(f"  the three baselines: {time.perf_counter() - t0:.1f} s wall, {time.process_time() - c0:.1f} s of this "
          f"process's CPU (a train cell's three depths run in worker processes)", flush=True)
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
        torch.cuda.reset_peak_memory_stats()
        out = fn(torch, smi, *args)
        print(f"  {title.split()[0]} took {time.perf_counter() - t:.1f} s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        return out

    launches, cold = phase("[4] end to end: paged engine, bag embedder", paged_phase, timer, rows)
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
    runs += phase("[13] training: qwen3-0.6b at full width through the Trainer, crash and resume; mamba2-1.3b",
                  train_phase)
    runs += phase("[14] hubert-xlarge at full width: masked prediction, head_dim 80", hubert_phase)
    runs += phase("[15] pixtral-12b at full width: the patch frontend", pixtral_phase)
    runs += phase("[16] federated F_emb (paper section 2.2): secure aggregation, contriever-110m", fedembed_phase)
    runs += phase("[17] sharded serving: 1, 2 and 4 shards of the paged pool on one card, dist_decode, "
                  "federated top-k", sharded_phase, cold, timer, rows)
    runs += phase("[18] the hybrid family: jamba-1.5-large-398b, one scan period, contiguous engine", hybrid_phase,
                  cold)
    runs += phase("[19] multi-device training on one card: data-parallel qwen3-0.6b and mamba2-1.3b, the elastic "
                  "restore, qwen2-moe-a2.7b expert parallelism", multidevice_phase)
    runs += phase("[20] roofline: the dry run's count on meta against the card's, each step's share of its bound, "
                  "the hillclimb baselines", roofline_phase)
    runs += phase("[21] the sliding window: mixed_prefill and paged_decode at Mellum2's heads, window 1,024",
                  window_phase, timer)

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
    # main-path runs of phases 4-20
    path_row = {
        "retrieval_topk": ("retrieval_topk", "float32"), "mixed_prefill": ("mixed_prefill", "bfloat16", "qwen3-4b admission"),
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
        # qwen2-moe's heads (one query head per KV head), HuBERT's head_dim
        # 80 and the training backward (plain recompute; fwd_ms the forward
        # kernel at its shape), beside the path row
        for tag, key in (("step_mix", "step mix"), ("first_mixed_dispatch", "first mixed"), ("padded", "padded"),
                         ("warm_admission", "warm"), ("verify", "verify"), ("one_head_per_kv_head", "G=1"),
                         ("head_dim_80", "dh80"), ("backward_train", "backward train"),
                         ("backward_hubert", "backward hubert"), ("backward_contriever", "backward contriever"),
                         ("partials_owned", "partials_owned"), ("partials_empty_zero", "partials_empty_zero"),
                         ("jamba", "jamba"), ("per_shard_b2", "per-shard B=2"), ("per_shard_b4", "per-shard B=4")):
            extra = rows.get((name, "bfloat16", key))
            if extra is not None:
                kernels[-1][tag] = {k: extra[k] for k in (
                    "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err", "fwd_ms",
                    "four_shards_ms", "padded_ms", "parent_ms") if extra.get(k) is not None}
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
