"""Where the time of one full-width serve goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve [--system paged] [--queries 16] [--trace out.json]
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --system paged --prefix-cache --repeat 2
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --system paged --shards 4

Builds one of the configurations ``chip_smoke.py`` serves, random
weights from ``--seed``: ``--system paged`` (default) or ``contiguous``
is ``launch.serve.full_width_system`` with that engine layout, ``paper``
is ``launch.serve.paper_models_system``, ``mamba2`` is
``full_width_system`` with mamba2-1.3b on the contiguous engine, ``spec``
the paged qwen3-0.6b engine with ``draft_k=3`` (self-speculation), ``moe``
qwen2-moe-a2.7b at full width on the paged engine, ``hybrid``
jamba-1.5-large-398b (one scan period, ``launch.serve.FULL_WIDTH_CUTS``)
on the contiguous engine.  It warms the system up,
then runs ``CFedRAGSystem.serve`` on ``--queries`` queries under
``torch.profiler`` and prints the wall time, the device's busy share
(summed kernel time over wall time; one stream, so kernels never
overlap), the number of kernel launches, and the kernels that take the
most device time, grouped by kind; for ``moe`` and ``hybrid`` also the device time of
the kernels launched inside ``models/moe``'s expert loop (its
``moe_expert_loop`` profiler range) and its share, for ``spec`` the
drafter dispatches and the speculation gauges.  ``--prefix-cache`` (paged only)
builds the engine with its prefix cache and serves the queries
``--repeat`` times on the one resident engine, the last repeat under the
profiler: with ``--repeat 2`` that is the warm repeat, whose prompts
find their prefixes cached.  Its pool then holds two waves of
``max_batch`` rows' blocks (144), so that every prompt's chain stays
cached.  ``--shards N`` (paged only) splits a pool of 144 blocks over N
shards, on the first N cards or, with fewer cards, all on the first one,
so that the sharded dispatch's device time is filed by kernel beside the
rest.  The program's flight-recorder spans (``runtime/trace.py``) are
mirrored into the profiled serve as profiler ranges, which the kernel
sums leave out; each idle gap between the device's busy intervals is
named by the innermost span that covers most of it (the most covering
one where none covers half), and the longest gaps, the share of idle
time under each span name and under none, and the share of idle time
that some span covers are printed.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import bisect
import subprocess
import time


LOOP = "moe_expert_loop"  # models/moe.py's profiler range around the expert loop


def _inside(e) -> bool:
    """Whether profiler event ``e`` or one of its CPU parents is the expert loop's range."""
    while e is not None:
        if e.name == LOOP:
            return True
        e = e.cpu_parent
    return False


def _kind(name: str) -> str:
    n = name.lower()
    if "flash_attention" in n:
        return "flash_attention kernel"
    if "mixed_prefill" in n:
        return "mixed_prefill kernel"
    if "pagedkv" in n:  # decode_split / decode_combine through a block table
        return "paged_decode kernel"
    if "stridedkv" in n:  # the same over a contiguous cache
        return "flash_decode kernel"
    if "ssd_chunk" in n or "ssd_scores" in n:
        return "ssd_chunk kernel"
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


def _union(intervals) -> list:
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def idle_by_span(events, ranges: set) -> tuple[list, float]:
    """The idle gaps between the device's busy intervals, each as ``(us,
    name)``: the innermost of the program ranges that cover at least half
    of it, else the one covering most, else "no span"; and the idle time
    the ranges cover, in us.  ``events``: a profile's events; ``ranges``:
    the names of the program's ranges."""
    dev = [e for e in events if e.device_type.name == "CUDA" and e.name != LOOP and e.name not in ranges
           and e.time_range.elapsed_us() > 0]
    merged = _union([(e.time_range.start, e.time_range.end) for e in dev])
    spans = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                    if e.device_type.name == "CPU" and e.name in ranges), key=lambda x: x[0])
    starts = [sp[0] for sp in spans]
    gaps, covered, active, nxt = [], 0.0, [], 0
    for (_, a), (b, _) in zip(merged, merged[1:]):
        hi = bisect.bisect_left(starts, b)
        active.extend(spans[nxt:hi])
        nxt = max(nxt, hi)
        active = [sp for sp in active if sp[1] > a]
        over = [(min(b, e) - max(a, s), e - s, name) for s, e, name in active]
        half = [o for o in over if 2 * o[0] >= b - a]
        best = min(half, key=lambda o: o[1]) if half else max(over, default=None)
        gaps.append((b - a, best[2] if best is not None and best[0] > 0 else "no span"))
        covered += sum(e - s for s, e in _union([(max(a, s), min(b, e)) for s, e, _ in active]))
    return gaps, covered


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--system", default="paged", choices=["paged", "contiguous", "paper", "mamba2", "spec", "moe",
                                                             "hybrid"])
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    ap.add_argument("--prefix-cache", action="store_true", help="the paged engine with its prefix cache")
    ap.add_argument("--repeat", type=int, default=1, help="serves on the resident engine; the last is profiled")
    ap.add_argument("--shards", type=int, default=None, help="the sharded paged pool over this many shards")
    args = ap.parse_args(argv)
    if args.prefix_cache and args.system != "paged":
        ap.error("--prefix-cache needs --system paged")
    if args.shards is not None and args.system != "paged":
        ap.error("--shards needs --system paged")

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import full_width_system, paper_models_system
    from repro_torch.runtime import trace
    from repro_torch.runtime.compat import make_mesh
    from repro_torch.serving.kv_cache import blocks_for

    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    if args.system == "paper":
        sys_, _, texts = paper_models_system(args.queries, "cuda", args.seed)
    elif args.system == "mamba2":
        sys_, _, texts = full_width_system(args.queries, "cuda", args.seed, paged=False, arch="mamba2-1.3b")
    elif args.system == "hybrid":
        sys_, _, texts = full_width_system(args.queries, "cuda", args.seed, paged=False, arch="jamba-1.5-large-398b")
    elif args.system == "spec":
        sys_, _, texts = full_width_system(args.queries, "cuda", args.seed, draft_k=3)
    elif args.system == "moe":
        sys_, _, texts = full_width_system(args.queries, "cuda", args.seed, arch="qwen2-moe-a2.7b")
    else:
        pool = 2 * 8 * blocks_for(256 + 16, 32) if args.prefix_cache or args.shards else None
        mesh = None
        if args.shards is not None:
            n_dev = torch.cuda.device_count()
            mesh = make_mesh([f"cuda:{i}" if n_dev >= args.shards else "cuda:0" for i in range(args.shards)])
            print(f"{args.shards} shards on {[str(d) for d in mesh.devices]}, {pool} pool blocks")
        sys_, _, texts = full_width_system(args.queries, "cuda", args.seed, paged=args.system == "paged",
                                           prefix_cache=args.prefix_cache, n_pool_blocks=pool,
                                           shards=args.shards, mesh=mesh)
    sys_.serve(texts[:2], max_new_tokens=2)  # warm-up
    if args.prefix_cache:  # the warm-up's prompts must not seed the cache
        sys_.orchestrator.generator.engine.reset_cache()
    for rep in range(1, args.repeat):
        sys_.serve(texts)
        st = sys_.last_serve_stats
        print(f"repeat {rep} (not profiled): {st.get('prefix_hits', 0)}/{st.get('prefix_lookups', 0)} prefix hits, "
              f"{st.get('prefill_tokens_saved', 0)}/{st.get('prefill_tokens', 0)} prefill tokens saved, "
              f"{st['mixed_dispatches']} mixed + {st['decode_dispatches']} decode dispatches")
    torch.cuda.synchronize()
    trace.mirror(True)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            m0, t0 = time.monotonic(), time.perf_counter()
            sys_.serve(texts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        n_spans = len(trace.spans(m0))
    finally:
        trace.mirror(False)
    st = sys_.last_serve_stats
    # a profiler range (``record_function``: the expert loop's and the
    # program's mirrored spans) also shows on the device timeline as a
    # span from its first kernel to its last, idle gaps included: it is no
    # kernel, so it is left out of the sums
    ranges = trace.names()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total > 0 and e.key != LOOP
               and e.key not in ranges]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    print(f"[{smi}] torch {torch.__version__}, system {args.system}"
          + (f", prefix cache, repeat {args.repeat} of {args.repeat}" if args.prefix_cache else "")
          + (f", {args.shards} shards" if args.shards else ""))
    if args.prefix_cache:
        print(f"profiled repeat: {st['prefix_hits']}/{st['prefix_lookups']} prefix hits, "
              f"{st['prefill_tokens_saved']}/{st['prefill_tokens']} prefill tokens saved")
    print(
        f"serve of {len(texts)} queries: wall {wall * 1e3:.1f} ms (profiled), device busy "
        f"{busy_ms:.1f} ms = {100 * busy_ms / (wall * 1e3):.1f}% of wall, {launches} kernel launches, "
        f"{st['admit_dispatches']} admit + {st['mixed_dispatches']} mixed + "
        f"{st['decode_dispatches']} decode engine dispatches"
    )
    if args.system == "spec":
        print(f"speculation: {st['draft_dispatches']} drafter + {st['draft_fill_dispatches']} drafter-fill "
              f"dispatches, {st['spec_rounds']} rounds, accept rate {st.get('spec_accept_rate', 0.0):.4f}, "
              f"{st.get('spec_tokens_per_round', 0.0):.3f} tokens/round, "
              f"{st.get('dispatches_per_spec_round', 0.0):.3f} dispatches/round")
    loops = [e for e in prof.events() if e.name == LOOP and e.device_type.name == "CPU"]
    if loops:
        # the kernels of the ops launched inside the expert loop's range
        loop_ms = sum(k.duration for e in prof.events() if e.kernels and e.name != LOOP and _inside(e.cpu_parent)
                      for k in e.kernels) / 1e3
        print(f"expert loop ({LOOP}): {len(loops)} calls, device time of its kernels {loop_ms:.1f} ms = "
              f"{100 * loop_ms / busy_ms:.1f}% of device busy, host time in the range "
              f"{sum(e.cpu_time_total for e in loops) / 1e3:.1f} ms = {100 * sum(e.cpu_time_total for e in loops) / 1e3 / (wall * 1e3):.1f}% of wall")
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
    gaps, covered = idle_by_span(prof.events(), ranges)
    idle = sum(us for us, _ in gaps)
    print(f"program spans mirrored: {n_spans} in the profiled serve; device idle between its first and last "
          f"kernel {idle / 1e3:.1f} ms in {len(gaps)} gaps, {100 * covered / max(idle, 1e-9):.1f}% of it "
          f"covered by some span")
    by_name: dict[str, float] = {}
    for us, name in gaps:
        by_name[name] = by_name.get(name, 0.0) + us
    print("idle time by the span that covers most of each gap:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1]):
        print(f"  {name:20s} {us / 1e3:9.2f} ms  {100 * us / max(idle, 1e-9):5.1f}%")
    print(f"top {args.top} idle gaps:")
    for us, name in sorted(gaps, reverse=True)[: args.top]:
        print(f"  {us / 1e3:9.3f} ms  {name}")
    cpu_ops = [e for e in prof.key_averages() if e.device_type.name == "CPU"]
    print(f"top {args.top} host ops by self CPU time:")
    for e in sorted(cpu_ops, key=lambda e: -e.self_cpu_time_total)[: args.top]:
        print(f"  {e.self_cpu_time_total / 1e3:9.2f} ms  {e.count:6d}x  {e.key[:80]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
