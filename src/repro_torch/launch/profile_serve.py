"""Where the time of one full-width serve goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve [--queries 16] [--trace out.json]

Builds the configuration ``chip_smoke.py`` serves
(``launch.serve.full_width_system``, random weights from ``--seed``), warms it up,
then runs ``CFedRAGSystem.serve`` on ``--queries`` queries under
``torch.profiler`` and prints the wall time, the device's busy share
(summed kernel time over wall time; one stream, so kernels never
overlap), the number of kernel launches, and the kernels that take the
most device time, grouped by kind.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import time


def _kind(name: str) -> str:
    n = name.lower()
    if "mixed_prefill" in n:
        return "mixed_prefill kernel"
    if "paged_decode" in n:
        return "paged_decode kernel"
    if "topk_partial" in n or "topk_merge" in n:
        return "retrieval_topk kernel"
    if "gemm" in n or "cutlass" in n or "sm90_xmma" in n or "nvjet" in n:
        return "matmul (cuBLAS)"
    if "copy" in n or "cast" in n or "to_copy" in n:
        return "copy / cast"
    if "index" in n or "scatter" in n or "gather" in n:
        return "index / scatter"
    if "reduce" in n or "argmax" in n or "softmax" in n:
        return "reduction"
    return "elementwise / other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import full_width_system

    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    sys_, _, texts = full_width_system(args.queries, "cuda", args.seed)
    sys_.serve(texts[:2], max_new_tokens=2)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sys_.serve(texts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    st = sys_.last_serve_stats
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    print(f"[{smi}] torch {torch.__version__}")
    print(
        f"serve of {len(texts)} queries: wall {wall * 1e3:.1f} ms (profiled), device busy "
        f"{busy_ms:.1f} ms = {100 * busy_ms / (wall * 1e3):.1f}% of wall, {launches} kernel launches, "
        f"{st['mixed_dispatches']} mixed + {st['decode_dispatches']} decode engine dispatches"
    )
    by_kind: dict[str, list] = {}
    for e in kernels:
        k = by_kind.setdefault(_kind(e.key), [0.0, 0])
        k[0] += e.self_device_time_total / 1e3
        k[1] += e.count
    print("device time by kind:")
    for kind, (ms, n) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        print(f"  {kind:24s} {ms:9.2f} ms  {100 * ms / busy_ms:5.1f}%  {n} launches")
    print(f"top {args.top} kernels by device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[: args.top]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  {e.key[:100]}")
    cpu_ops = [e for e in prof.key_averages() if e.device_type.name == "CPU"]
    print(f"top {args.top} host ops by self CPU time:")
    for e in sorted(cpu_ops, key=lambda e: -e.self_cpu_time_total)[: args.top]:
        print(f"  {e.self_cpu_time_total / 1e3:9.2f} ms  {e.count:6d}x  {e.key[:80]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
