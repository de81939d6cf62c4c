"""The attention work of a generator with windowed and full layers, from
the program's own recorder: what the readers of ``window_read_share`` and
``mixed_prefill_roofline`` share.

Every ``engine.step`` span carries, as host integers from the step's
descriptors, the key positions one full and one windowed attention layer
read over its rows (``kv_read_full``, ``kv_read_window``) and the
query-key pairs they score (``kv_pairs_full``, ``kv_pairs_window``).  A
program without them reads None.

The profiled slice starts at the first engine dispatch at or after
``profiling.SLICE_AT`` of the window (the slicer is called before each
dispatch, inside its ``engine.launch``) and holds ``engine_steps``
dispatches, so the steps it holds are found in the ring by their first
launch.
"""
from __future__ import annotations

from fedbench import flops, flops_window, profiling, ring

MIXED = ("mixed", "spec")  # the steps whose attention runs through mixed_prefill
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def _counted(spans) -> list:
    return [s for s in spans or () if s.name == ring.STEP and "kv_read_full" in s.attrs]


def read_share(spans) -> float | None:
    """Σ kv_read_window over Σ kv_read_full of the engine steps, in %."""
    steps = _counted(spans)
    full = sum(s.attrs["kv_read_full"] for s in steps)
    return 100.0 * sum(s.attrs["kv_read_window"] for s in steps) / full if full else None


def slice_steps(run) -> list | None:
    """The engine steps the run's profiled slice holds, oldest first."""
    spans = ring.window_spans(run)
    if run.slice is None or spans is None:
        return None
    first_launch: dict[int, float] = {}
    for s in spans:
        if s.name == "engine.launch" and s.parent is not None:
            first_launch[s.parent] = min(first_launch.get(s.parent, s.start), s.start)
    t = run.window.t_open + profiling.SLICE_AT * run.seconds
    steps = sorted((s for s in spans if s.name == ring.STEP and s.id in first_launch and first_launch[s.id] >= t),
                   key=lambda s: first_launch[s.id])
    return steps[: run.slice.engine_steps]


def mixed_prefill_work(m: dict, step) -> list[tuple[float, float, int]]:
    """The ``mixed_prefill`` launches of one mixed step, as ``(FLOPs,
    bytes, launches)`` for its windowed and its full layers: Q.K and P.V
    over the query-key pairs (4 x heads x head_dim a pair); q of the live
    lanes read and their output written, the K/V of the positions read and
    the descriptors once (the block-table entries are left out, so the
    bytes are a floor)."""
    a = step.attrs
    h, kv, dh = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    es = BYTES[m.get("dtype", "bfloat16")]
    lanes, rows = a.get("lanes_live", 0), a.get("rows", 0)
    fixed = 2 * lanes * h * dh * es + rows * 5 * 4
    n_win, n_full = flops_window.layer_kinds(m)
    return [(4.0 * h * dh * a[f"kv_pairs_{k}"], fixed + 2.0 * a[f"kv_read_{k}"] * kv * dh * es, n)
            for k, n in (("window", n_win), ("full", n_full)) if n]


def mixed_prefill_roofline(run) -> float | None:
    """The slice's ``mixed_prefill`` launches' bound, each max(bytes / HBM
    bandwidth, FLOPs / bf16 peak), over their device time, in %."""
    steps = slice_steps(run)
    if not steps or any("kv_pairs_full" not in s.attrs for s in steps):
        return None
    bound = sum(n * max(b / flops.HBM_BW, f / flops.PEAK_BF16)
                for s in steps if s.attrs.get("kind") in MIXED
                for f, b, n in mixed_prefill_work(run.model, s))
    dev = sum(t for name, t in run.slice.op_s.items() if profiling.kind(name) == "mixed_prefill kernel")
    return 100.0 * bound / dev if dev > 0 and bound > 0 else None
