"""Drive the system under test through one window.

An offline batch (``loop: offline``): ``CFedRAGSystem.serve_stream``
over the whole batch, abandoned when the window closes; the window
opens ``ramp_s`` after the stream starts, so it opens in steady state.
The program has no front door that follows an arrival schedule
(``serve_stream`` takes a finished list and paces it by backpressure),
so the benchmark has no open-loop cell (PERF.md).

Spans: each collect and rerank call is timed (and, in a traced run,
wrapped in a ``bench.*`` profiler range) by wrapping the orchestrator's
two methods on its instance.  Each record keeps what the check needs:
the providers' answers, the context, the prompt and the answer tokens.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
from torch.profiler import record_function


@dataclasses.dataclass(eq=False)
class Record:
    """One request as the window saw it (times on ``time.monotonic``)."""

    qidx: int
    text: str
    budget: int
    finished: float | None = None  # retired
    status: str = "pending"  # pending | done | failed
    prompt: np.ndarray | None = None
    answer: np.ndarray | None = None
    context: dict | None = None
    responses: list | None = None  # per provider: {"provider", "scores", "chunk_ids"} rows


@dataclasses.dataclass
class Span:
    name: str
    t0: float
    t1: float
    n: int  # queries the call covered


@dataclasses.dataclass
class Window:
    t_open: float
    t_close: float
    records: list
    spans: list
    counters: dict  # engine counters at open and close


def _span(trace: bool, name: str):
    return record_function(f"bench.{name}") if trace else contextlib.nullcontext()


def _rows(responses, b: int) -> list:
    return [{"provider": int(r["provider"]), "scores": np.asarray(r["scores"])[b],
             "chunk_ids": np.asarray(r["chunk_ids"])[b]} for r in responses]


def _engine_counters(engine) -> dict:
    return {"prefill_tokens": engine.prefill_tokens_total, "prefill_saved": engine.prefill_tokens_saved}


def _hook_engine(engine, slicer) -> None:
    """Before every engine dispatch: the slicer's start/stop check, and a span."""
    for name in ("_mixed_rows", "_decode_chunk"):
        inner = getattr(engine, name)

        def hooked(*a, _inner=inner, **kw):
            slicer.step()
            with record_function("bench.engine_dispatch"):
                return _inner(*a, **kw)

        setattr(engine, name, hooked)


def run_offline(built, schedule, traffic: dict, seconds: float, trace: bool, slicer=None) -> Window:
    system, engine = built.system, built.engine
    orch = system.orchestrator
    n = len(schedule.qid)
    texts = [schedule.questions.strings[schedule.qid[i]] for i in range(n)]
    recs = [Record(i, texts[i], int(schedule.budget[i])) for i in range(n)]
    spans: list[Span] = []
    collected: list = []
    collect, aggregate = orch.collect_contexts_batch, orch.aggregate_batch

    def collect_w(queries, **kw):
        out = None
        try:
            with _span(trace, "collect"):
                a = time.monotonic()
                out = collect(queries, **kw)
                spans.append(Span("collect", a, time.monotonic(), len(queries)))
        finally:
            collected.append(out)  # a batch that missed quorum keeps its place
        return out

    def aggregate_w(queries, responses):
        with _span(trace, "rerank"):
            a = time.monotonic()
            out = aggregate(queries, responses)
            spans.append(Span("rerank", a, time.monotonic(), len(queries)))
        return out

    orch.collect_contexts_batch, orch.aggregate_batch = collect_w, aggregate_w
    cb = int(traffic["collect_batch"])
    counters: dict = {}
    t_s = time.monotonic()
    t_open = t_s + traffic["ramp_s"]
    t_close = t_open + seconds
    if slicer is not None:
        slicer.arm(t_open, seconds)
        _hook_engine(engine, slicer)
    stream = system.serve_stream(texts, max_new_tokens=[int(b) for b in schedule.budget], collect_batch=cb)
    try:
        for qidx, res in stream:
            now = time.monotonic()
            if "open" not in counters and now >= t_open:
                counters["open"] = _engine_counters(engine)
            r = recs[qidx]
            r.finished = now
            r.status = "done" if res.get("status") == "done" and not res.get("truncated") else "failed"
            r.prompt = None if res.get("prompt") is None else np.asarray(res["prompt"])[0]
            r.answer = None if res.get("answer_tokens") is None else np.asarray(res["answer_tokens"])
            r.context = res.get("context")
            if now >= t_close:
                break
    finally:
        stream.close()
        orch.collect_contexts_batch, orch.aggregate_batch = collect, aggregate
        if slicer is not None:
            slicer.stop()
    counters["close"] = _engine_counters(engine)
    counters.setdefault("open", counters["close"])
    for k, responses in enumerate(collected):  # serve_stream collects batch k as queries [k cb, (k + 1) cb)
        if responses is None:
            continue
        for j in range(len(np.asarray(responses[0]["scores"]))):
            i = k * cb + j
            if i < n:
                recs[i].responses = _rows(responses, j)
    return Window(t_open, t_close, recs, spans, counters)
