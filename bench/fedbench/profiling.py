"""One profiled slice of the window, reduced to what the readers need.

In a ``--trace 1`` run, ``torch.profiler`` (CPU and CUDA activities)
records one slice of ``SLICE_S`` seconds that starts ``SLICE_AT`` of the
way into the window, the same in every cell.  It starts and stops on
the engine's own thread, between two dispatches, after a synchronise,
so the slice holds whole steps; events stay in memory, no trace file is
written.

From the slice: the device operations (kernels, copies, fills; a
profiler range's device-side span is no operation, and leaves them by its
event type, a user annotation) with their intervals, so the busy time is
the union of those intervals; each operation's total time by its full
name; each kernel's kind, by a copy of the classifier of the program's
``launch/profile_serve.py``; for every profiler range opened in the
slice (``models/moe.py``'s ``moe_expert_loop``, any range a later
program opens, the harness's ``bench.*`` spans), the device time of the
kernels launched under it, found through their host-side parents as
``profile_serve`` finds the expert loop's; the engine steps the slice
holds, from the engine's dispatch counters; and the longest idle gaps,
each named by the benchmark's span (a ``bench.*`` profiler range) that
covers most of it: what the host was doing while the device idled.
"""
from __future__ import annotations

import dataclasses
import time

import torch

SLICE_AT = 0.4  # the slice starts this share of the way into the window
SLICE_S = 4.0
LOOP = "moe_expert_loop"  # models/moe.py's profiler range around the expert loop
SPAN_PREFIX = "bench."


def kind(name: str) -> str:
    """The kind of a device operation, by its name (``profile_serve._kind``)."""
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


ATTENTION_KINDS = ("mixed_prefill kernel", "paged_decode kernel")


def _ranges_over(e, memo: dict) -> frozenset:
    """The names of the profiler ranges among ``e`` and its host-side parents."""
    if e is None:
        return frozenset()
    if id(e) not in memo:
        up = _ranges_over(e.cpu_parent, memo)
        memo[id(e)] = up | {e.name} if e.is_user_annotation else up
    return memo[id(e)]


@dataclasses.dataclass
class SliceData:
    window_s: float  # host wall from start to stop, both after a synchronise
    busy_s: float  # union of device-operation intervals
    launches: int  # device operations
    engine_steps: int  # engine dispatches the slice holds
    attn_s: float  # the paged attention kernels' device time
    device_ops: list  # [name, seconds] by total time, longest first, the top few, names cut
    idle_gaps: list  # [span name, seconds], longest first
    op_s: dict  # every device operation's total seconds, by its full name
    range_s: dict  # range name -> device seconds of the kernels launched under it; every range opened

    @property
    def loop_s(self) -> float | None:
        """Device time of the kernels under the expert loop; None without one."""
        return self.range_s.get(LOOP)


def _union(intervals):
    total, end = 0.0, None
    merged = []
    for s, e in sorted(intervals):
        if end is None or s > end:
            merged.append([s, e])
            end = e
        elif e > end:
            merged[-1][1] = e
            end = e
    for s, e in merged:
        total += e - s
    return total, merged


def reduce(prof, window_s: float, engine_steps: int, top: int = 10) -> SliceData:
    events = prof.events()
    dev = [e for e in events if e.device_type.name == "CUDA" and not e.is_user_annotation
           and e.time_range.elapsed_us() > 0]
    busy_us, merged = _union([(e.time_range.start, e.time_range.end) for e in dev])
    by_name: dict[str, float] = {}
    attn_us = 0.0
    for e in dev:
        d = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + d
        if kind(e.name) in ATTENTION_KINDS:
            attn_us += d
    host = [e for e in events if e.device_type.name == "CPU"]
    range_us = {e.name: 0.0 for e in host if e.is_user_annotation}
    memo: dict = {}
    for e in host:
        for k in e.kernels:
            for name in _ranges_over(e, memo):
                range_us[name] += k.duration
    spans = [e for e in host if e.name.startswith(SPAN_PREFIX)]
    gaps = []
    for (_, a_end), (b_start, _) in zip(merged, merged[1:]):
        # the span that covers most of the gap, the innermost of equals
        best, name = 0.0, "host: no span"
        for sp in sorted(spans, key=lambda sp: sp.time_range.elapsed_us()):
            over = min(b_start, sp.time_range.end) - max(a_end, sp.time_range.start)
            if over > best:
                best, name = over, sp.name
        gaps.append([name, (b_start - a_end) / 1e6])
    gaps.sort(key=lambda g: -g[1])
    op_s = {n: us / 1e6 for n, us in by_name.items()}
    ops = sorted(([n[:160], s] for n, s in op_s.items()), key=lambda x: -x[1])
    return SliceData(
        window_s=window_s, busy_s=busy_us / 1e6, launches=len(dev), engine_steps=engine_steps,
        attn_s=attn_us / 1e6, device_ops=ops[:top], idle_gaps=gaps[:top],
        op_s=op_s, range_s={n: us / 1e6 for n, us in range_us.items()},
    )


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Slicer:
    """Starts and stops the profiler from the engine's thread: ``step()``
    runs before every engine dispatch, once ``arm`` has placed the slice
    in the window."""

    def __init__(self, engine):
        self.engine = engine
        self.t_start = float("inf")
        self.prof = None
        self.t0 = self.t1 = None
        self.steps0 = self.steps1 = 0

    def arm(self, t_open: float, seconds: float) -> None:
        self.t_start = t_open + SLICE_AT * seconds

    def _steps(self) -> int:
        e = self.engine
        return e.mixed_dispatches + e.decode_dispatches + e.admit_dispatches

    def step(self) -> None:
        now = time.monotonic()
        if self.prof is None and self.t1 is None and now >= self.t_start:
            _sync()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self.t0, self.steps0 = time.monotonic(), self._steps()
        elif self.prof is not None and self.t1 is None and now >= self.t0 + SLICE_S:
            self.stop()

    def stop(self) -> None:
        if self.prof is None or self.t1 is not None:
            return
        _sync()
        self.t1, self.steps1 = time.monotonic(), self._steps()
        self.prof.stop()

    def result(self) -> SliceData | None:
        if self.prof is None:
            return None
        self.stop()
        return reduce(self.prof, self.t1 - self.t0, self.steps1 - self.steps0)
