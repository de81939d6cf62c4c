#!/usr/bin/env python3
"""Chip smoke for the PyTorch port: the quickest proof that it still
starts on the GPU.

    python3 chip_smoke.py        # from the repository root, on a machine with one CUDA card

Phases (any failure exits non-zero, and the final ok line is printed
only when every phase passed):

1. device  the card's name and power limit, as nvidia-smi reports them;
2. build   the three CUDA kernels, one nvcc each, all started together;
3. kernels each kernel against its plain PyTorch version on the card at
           the full-width path shapes, f32 and bf16 (tolerance 2e-5 f32:
           both sum in f32 but in another order; 2e-2 bf16), the ±1e4
           trash-poison checks, retrieval at provider scale (N = 1,048,576
           x D = 256 f32, Q = 32, k = 8) with bitwise batch-of-1 ==
           batch-of-32 scores; times of kernel, plain version, one
           PyTorch library call (never called by the port) and the bound;
4. e2e     ``CFedRAGSystem.serve`` on 16 queries at the full width of
           qwen3-0.6b (28 layers, bf16, random weights from a seed), every
           kernel's launch counter set to 0 just before and read just
           after; then retrieval against the CPU run of the same system
           and a smoke-width model against its CPU run.

The line before the last lines is ``{"kernels": [...]}``, then the card's
nvidia-smi line, then ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
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
    """Mean device time of one call, by CUDA events around each call, with
    the 50 MB L2 flushed before every call (each serving step finds its
    layer's pool cold in L2: 28 layers of K/V do not fit)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")  # 128 MiB

    def ms(self, fn, iters: int = 20) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for s, e in ev:
            self.flush.zero_()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in ev) / iters


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_b, t_o = nbytes / MEM_BW * 1e3, flops / PEAK[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def check(name: str, err: float, dtype: str) -> None:
    ok = err <= TOL[dtype]
    print(f"  {name}: max_abs_err={err:.3e} (tol {TOL[dtype]:g}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")


# --------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------- #


def kernel_phase(torch, timer) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.chunked_prefill import ops as cp
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.retrieval_topk import ops as rt

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
        return qs, cs, err

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
        es = qs.element_size()
        b_ms, b_by = bound(nq * d * es + n * d * es + nq * k * 8, 2 * nq * n * d, dtype)
        rows["retrieval_topk", dtype] = dict(
            ms=timer.ms(lambda: rt.retrieval_topk(qs, cs, k)),
            plain_ms=timer.ms(lambda: rt.retrieval_topk_plain(qs, cs, k), iters=5),
            library_ms=timer.ms(lambda: torch.topk(qs @ cs.T, k, dim=1)),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
            shape=f"Q={nq} N={n} D={d} k={k} {dtype}",
        )
        del qs, cs

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
        err = (o.float() - cp.mixed_prefill_attention_plain(q, kp, vp, tables, desc).float()).abs().max().item()
        check(f"mixed_prefill W*G={W * G} {dtype}", err, dtype)
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

        od = da.paged_decode_attention(qd, kp, vp, tables, lens)
        err_d = (od.float() - da.paged_decode_attention_plain(qd, kp, vp, tables, lens).float()).abs().max().item()
        check(f"paged_decode B={R} {dtype}", err_d, dtype)
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
        b_ms, b_by = bound(nbytes, flops_m, dtype)
        rows["mixed_prefill", dtype] = dict(
            ms=timer.ms(lambda: cp.mixed_prefill_attention(q, kp, vp, tables, desc)),
            plain_ms=timer.ms(lambda: cp.mixed_prefill_attention_plain(q, kp, vp, tables, desc)),
            library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                qt, kv_k, kv_v, attn_mask=mask_m, enable_gqa=True)),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
            shape=f"R={R} W={W} H={H} KV={KV} dh={DH} bs={BS} n_t={NT} {dtype}",
        )
        nbytes_d = (2 * R * H * DH * es + 2 * sum(lens_h) * KV * DH * es
                    + sum(-(-n // BS) for n in lens_h) * 4 + R * 4)  # table entries the lengths reach
        b_ms, b_by = bound(nbytes_d, flops_d, dtype)
        rows["paged_decode", dtype] = dict(
            ms=timer.ms(lambda: da.paged_decode_attention(qd, kp, vp, tables, lens)),
            plain_ms=timer.ms(lambda: da.paged_decode_attention_plain(qd, kp, vp, tables, lens)),
            library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                qd[:, :, None], kv_k, kv_v, attn_mask=mask_d, enable_gqa=True)),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err_d,
            shape=f"B={R} H={H} KV={KV} dh={DH} bs={BS} n_t={NT} {dtype}",
        )
    for (name, _), row in rows.items():
        print(
            f"  {name} [{row['shape']}]: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"library {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})",
            flush=True,
        )
    return rows


# --------------------------------------------------------------------- #
# phase 4: end to end
# --------------------------------------------------------------------- #


def e2e_phase(torch, smi: str) -> dict:
    import numpy as np

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels.chunked_prefill import ops as cp
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.retrieval_topk import ops as rt
    from repro_torch.launch.serve import full_width_system
    from repro_torch.models import lm as LM
    from repro_torch.models.params import init_params, map_tree
    from repro_torch.serving.engine import ServeConfig, ServeEngine

    # qwen3-0.6b at full width, 28 layers, bf16 activations and pool
    sys_, engine, texts = full_width_system(16, "cuda", SEED)
    cfg, scfg, tok = engine.cfg, engine.scfg, sys_.tok
    sys_.serve(texts[:2], max_new_tokens=2)  # warm-up: allocator, first launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rt.launches = cp.launches = da.launches = 0
    t0 = time.perf_counter()
    results = sys_.serve(texts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"retrieval_topk": rt.launches, "mixed_prefill": cp.launches, "paged_decode": da.launches}
    print(f"  launches during the serve: {launches}", flush=True)
    if any(v == 0 for v in launches.values()):
        fail(f"a kernel of the path was never launched: {launches}")
    statuses = [r["status"] for r in results]
    if statuses != ["done"] * 16:
        fail(f"statuses {statuses}")
    n_tok = sum(len(r["answer_tokens"]) for r in results)
    if any(((r["answer_tokens"] < 0) | (r["answer_tokens"] >= cfg.vocab_size)).any() for r in results):
        fail("answer token outside the vocabulary")
    st = sys_.last_serve_stats
    lats = sorted(r["latency_s"] for r in results)
    p50, p95 = lats[len(lats) // 2], lats[min(len(lats) - 1, int(len(lats) * 0.95))]
    peak = torch.cuda.max_memory_allocated()
    print(
        f"  e2e qwen3-0.6b full width bf16, 16 queries, max_batch 8: p50 {p50 * 1e3:.1f} ms, "
        f"p95 {p95 * 1e3:.1f} ms, {n_tok / wall:.1f} tokens/s ({n_tok} tokens in {wall:.3f} s), "
        f"peak memory {peak / 2**30:.2f} GiB, {st['mixed_dispatches']} mixed + "
        f"{st['decode_dispatches']} decode dispatches [{smi}]",
        flush=True,
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
    small = smoke_config(get_config("qwen3-0.6b")).with_overrides(dtype="float32", vocab_size=tok.vocab_size)
    p_cpu = init_params(LM.param_specs(small), torch.Generator().manual_seed(SEED), device="cpu")
    p_gpu = map_tree(lambda t: t.to("cuda"), p_cpu)
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
    return launches


def main() -> int:
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

    print("[3] kernels against their plain versions", flush=True)
    rows = kernel_phase(torch, Timer(torch))

    print("[4] end to end", flush=True)
    launches = e2e_phase(torch, smi)

    meta = {
        "retrieval_topk": ("src/repro_torch/kernels/csrc/retrieval_topk.cu", "src/repro/kernels/retrieval_topk/kernel.py:105"),
        "mixed_prefill": ("src/repro_torch/kernels/csrc/mixed_prefill.cu", "src/repro/kernels/chunked_prefill/kernel.py:80"),
        "paged_decode": ("src/repro_torch/kernels/csrc/paged_decode.cu", "src/repro/kernels/decode_attention/kernel.py:160"),
    }
    # one row per kernel at the dtype the path gives it: f32 provider
    # embeddings, bf16 activations and KV pool
    path_dtype = {"retrieval_topk": "float32", "mixed_prefill": "bfloat16", "paged_decode": "bfloat16"}
    kernels = []
    for name, (src, rep) in meta.items():
        row = rows[name, path_dtype[name]]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"], "shape": row["shape"],
        })
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
