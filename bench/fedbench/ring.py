"""The program's own flight recorder (``repro_torch.runtime.trace``) as
the readers of ``bench/metrics/`` see it: the spans one run left in it,
and the arithmetic those readers share.

A reader takes the spans that started inside the window (``t_open <=
start < t_close``, as ``readers.span_ms_per_query`` takes the harness's
own), or for set-up those that started in the ``setup_s`` before it.  A
checkout whose program has no recorder, or a ring that holds nothing the
reader needs, reads None.
"""
from __future__ import annotations

import importlib
import statistics

STEP = "engine.step"
# the engine thread's spans outside a step; syncs inside a step count in the step's own
ENGINE_TOP = ("engine.admit", "engine.retire")
LOAD = ("provider.tokenize", "provider.index")


def _spans(t0: float, t1: float) -> list | None:
    try:
        trace = importlib.import_module("repro_torch.runtime.trace")
    except ImportError:  # a program from before the recorder
        return None
    return trace.spans(t0, t1)


def window_spans(run) -> list | None:
    return _spans(run.window.t_open, run.window.t_close)


def setup_spans(run) -> list | None:
    return _spans(run.window.t_open - run.setup_s, run.window.t_open)


def live_lane_share(spans) -> float | None:
    """Σ live lanes over Σ lanes run of the engine steps, in %."""
    steps = [s for s in spans or () if s.name == STEP]
    run = sum(s.attrs.get("lanes_run", 0) for s in steps)
    return 100.0 * sum(s.attrs.get("lanes_live", 0) for s in steps) / run if run else None


def host_syncs_per_step(spans) -> float | None:
    """The engine thread's device->host reads over its steps: those inside
    the steps, in admission and retirement, and a readback outside any step."""
    spans = spans or ()
    steps = {s.id for s in spans if s.name == STEP}
    if not steps:
        return None
    syncs = sum(s.attrs.get("syncs", 0) for s in spans
                if s.name == STEP or s.name in ENGINE_TOP
                or (s.name == "engine.readback" and s.parent not in steps))
    return syncs / len(steps)


def between_steps_ms(spans) -> float | None:
    """Mean host time from one step's last child (its readback, else its
    launch) closing to the next step's launch, on each engine thread."""
    spans = spans or ()
    steps = sorted((s for s in spans if s.name == STEP), key=lambda s: s.start)
    first_launch: dict[int, float] = {}
    last_end: dict[int, float] = {}
    for s in spans:
        if s.parent is None or s.name not in ("engine.launch", "engine.readback"):
            continue
        if s.name == "engine.launch":
            first_launch[s.parent] = min(first_launch.get(s.parent, s.start), s.start)
        last_end[s.parent] = max(last_end.get(s.parent, s.end), s.end)
    prev: dict[int, object] = {}
    gaps = []
    for s in steps:
        p = prev.get(s.thread)
        if p is not None and p.id in last_end and s.id in first_launch:
            gaps.append(first_launch[s.id] - last_end[p.id])
        prev[s.thread] = s
    return 1e3 * sum(gaps) / len(gaps) if gaps else None


def first_token_ms(spans) -> float | None:
    """Median submit-to-first-token time of the requests whose queue wait
    and prefill spans the window holds (filed at the first token)."""
    spans = spans or ()
    prefill = {s.attrs.get("rid"): s for s in spans if s.name == "request.prefill"}
    waits = [1e3 * (prefill[s.attrs.get("rid")].end - s.start) for s in spans
             if s.name == "request.queued" and s.attrs.get("rid") in prefill]
    return statistics.median(waits) if waits else None


def index_build_s(spans) -> float | None:
    """Seconds the providers spent tokenising their chunks and building
    their F_emb index."""
    load = [s for s in spans or () if s.name in LOAD]
    return sum(s.end - s.start for s in load) if load else None
