"""The port's flight recorder (``repro_torch/runtime/trace.py``): the ring,
the span tree and its sync counts; and what the serving path records on a
tiny CPU engine: each mixed step runs its live lanes alone, which add
up to the engine's computed prefill tokens, and the head sees only the
lanes the engine reads; a decode chunk of n tokens checks its stop at most n
times, every request's first token lies between its admission and its
finish on the paged, speculative and contiguous paths and is filed before
the request finishes, and the profiler
sees the program's spans only with the mirror on; and how
``launch/profile_serve.py`` names the device's idle gaps."""
import dataclasses
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.profile_serve import idle_by_span
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models.params import init_params
from repro_torch.runtime import trace
from repro_torch.serving.engine import ServeConfig, ServeEngine
from repro_torch.serving.scheduler import Scheduler

B, WIDTH, BUDGET = 3, 32, 12


def _engine(arch="qwen3-0.6b", **kw):
    cfg = smoke_config(get_config(arch))
    params = init_params(LM.param_specs(cfg), torch.Generator().manual_seed(0), device="cpu")
    scfg = ServeConfig(max_batch=B, max_prompt_len=WIDTH, max_new_tokens=6, **kw)
    return ServeEngine(cfg, params, scfg, device="cpu")


def _prompts(n=7, seed=0):
    """Ragged prompts, every other one sharing a 16-token prefix."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(8, 256, size=16)
    return [np.concatenate([shared, rng.integers(8, 256, size=rng.integers(1, 12))]) if i % 2
            else rng.integers(8, 256, size=rng.integers(3, 30)) for i in range(n)]


def _serve(eng, prompts, budgets=(6, 1, 4, 2, 6, 3, 5)):
    t0 = time.monotonic()
    sched = Scheduler()
    sched.submit_many(prompts, list(budgets[: len(prompts)]))
    eng.serve(sched)
    return sched, [s for s in trace.spans(t0) if s.thread == threading.get_ident()]


def test_the_ring_holds_its_capacity():
    rec = trace.Recorder(capacity=4)
    ids = [rec.record("x", float(i), float(i) + 0.5, i=i) for i in range(10)]
    kept = rec.spans()
    assert len(kept) == 4 and [s.id for s in kept] == ids[-4:] and [s.attrs["i"] for s in kept] == [6, 7, 8, 9]
    assert [s.attrs["i"] for s in rec.spans(7.0, 9.0)] == [7, 8]


def test_spans_nest_and_count_the_reads_inside_them():
    rec = trace.Recorder()
    x = torch.arange(4)
    with rec.span("outer", a=1) as outer:
        with rec.span("inner") as inner:
            y = rec.to_host(x, "site.a", copy=True)
        assert rec.to_host(x, "site.b") is x  # already on the host
        rec.count("site.b", 2)
    with rec.span("after") as after:
        pass
    assert inner.parent == outer.id and outer.parent is None and after.parent is None
    assert inner.attrs == {"syncs": 1} and outer.attrs == {"a": 1, "syncs": 2} and after.attrs == {}
    assert rec.counters() == {"site.a": 1, "site.b": 3}
    assert outer.start <= inner.start <= inner.end <= outer.end
    x[0] = 7
    assert int(y[0]) == 0  # asked for a copy: no alias, even on the CPU
    assert [s.name for s in rec.spans()] == ["inner", "outer", "after"] and rec.names() == {"inner", "outer", "after"}


def _model_calls(monkeypatch):
    """Each ``mixed_step`` call's (tokens run, the rows' summed q_len), and
    the rows of each ``head_apply`` call made inside one, in call order."""
    steps, heads, inside = [], [], [False]
    mixed_step, head_apply = LM.mixed_step, L.head_apply

    def mixed(cfg, params, tokens, cache, tables, lanes, *a, **kw):
        steps.append((tokens.shape[0], int(lanes.desc[:, 2].sum())))
        inside[0] = True
        try:
            return mixed_step(cfg, params, tokens, cache, tables, lanes, *a, **kw)
        finally:
            inside[0] = False

    def head(cfg, params, x):
        if inside[0]:
            heads.append(x.shape[0])
        return head_apply(cfg, params, x)

    monkeypatch.setattr(LM, "mixed_step", mixed)
    monkeypatch.setattr(L, "head_apply", head)
    return steps, heads


def test_mixed_steps_fill_lanes_add_up_to_the_computed_prefill(monkeypatch):
    eng = _engine(paged=True, block_size=4, prefix_cache=True, token_budget=BUDGET)
    prompts = _prompts()
    calls, _ = _model_calls(monkeypatch)
    for _ in range(2):  # the second serve finds the prefixes cached
        pt, ps = eng.prefill_tokens_total, eng.prefill_tokens_saved
        del calls[:]
        _, spans = _serve(eng, prompts)
        steps = [s for s in spans if s.name == "engine.step"]
        mixed = [s for s in steps if s.attrs["kind"] == "mixed"]
        assert mixed and len(mixed) == len(calls)
        assert all(s.attrs["lanes_run"] == s.attrs["lanes_live"] == n == q for s, (n, q) in zip(mixed, calls))
        assert any(s.attrs["lanes_run"] < B * BUDGET for s in mixed)
        assert all(0 <= s.attrs["fill_lanes"] <= s.attrs["lanes_live"] <= s.attrs["lanes_run"] for s in steps)
        assert sum(s.attrs["fill_lanes"] for s in steps) == (eng.prefill_tokens_total - pt) - (
            eng.prefill_tokens_saved - ps)
    assert eng.prefill_tokens_saved > 0


@pytest.mark.parametrize("draft_k", [0, 2], ids=["mixed", "spec"])
def test_the_head_sees_only_the_lanes_the_engine_reads(monkeypatch, draft_k):
    """A mixed step applies the head to one lane a row with lanes (B when
    every slot is busy), a verify step to at most draft_k + 1 lanes a
    verify row plus one a fill row, the drafter's k-loop to every row's
    lane but in its trailing write-only step, and the drafter's fill pass
    to none; each step's ``head_lanes`` says how many."""
    eng = _engine(paged=True, block_size=4, token_budget=BUDGET, draft_k=draft_k)
    _, heads = _model_calls(monkeypatch)
    _, spans = _serve(eng, _prompts())
    steps = [s for s in spans if s.name == "engine.step" and s.attrs["kind"] != "decode"]
    assert steps and sum(heads) == sum(s.attrs["head_lanes"] for s in steps)
    for s in steps:
        kind, rows = s.attrs["kind"], s.attrs["rows"]
        assert s.attrs["lanes_run"] >= s.attrs["lanes_live"]
        if kind == "mixed":
            assert s.attrs["head_lanes"] == rows <= B
        elif kind == "spec":
            assert rows <= s.attrs["head_lanes"] <= rows * (draft_k + 1) and s.attrs["lanes_run"] == s.attrs["lanes_live"]
        else:
            assert kind == "draft" and s.attrs["head_lanes"] == B * draft_k
    if draft_k:
        assert {s.attrs["kind"] for s in steps} == {"spec", "draft"}
        # B rows a k-loop step; none for the fill pass or the trailing write
        n_draft = sum(s.attrs["kind"] == "draft" for s in steps)
        assert heads.count(B) >= n_draft * draft_k and heads.count(0) >= n_draft
    else:
        assert max(heads) == B and {s.attrs["kind"] for s in steps} == {"mixed"}


@pytest.mark.parametrize("paged", [True, False])
def test_a_decode_chunk_checks_its_stop_at_most_once_a_token(paged):
    eng = _engine(paged=paged, sched_chunk=4, **({"block_size": 8} if paged else {}))
    calls = []
    inner = eng._decode_chunk

    def counted(st, n, *a, **kw):
        c0 = trace.counters().get("engine.decode_stop", 0)
        out = inner(st, n, *a, **kw)
        calls.append((n, trace.counters()["engine.decode_stop"] - c0))
        return out

    eng._decode_chunk = counted
    _, spans = _serve(eng, _prompts(5), budgets=(6, 6, 5, 6, 4))
    decode = [s for s in spans if s.name == "engine.step" and s.attrs["kind"] == "decode"]
    assert len(decode) == len(calls) > 0
    for s, (n, checks) in zip(decode, calls):
        stepped = s.attrs["lanes_run"] // B
        assert checks <= n and stepped <= checks <= stepped + 1  # one check a step, and the one that stops
        assert s.attrs["lanes_live"] <= s.attrs["lanes_run"] and s.attrs["syncs"] >= checks + 2


def _windowed_engine(window, **kw):
    """qwen3's smoke engine with a sliding window of ``window`` keys on
    every other layer (0: none)."""
    cfg = smoke_config(get_config("qwen3-0.6b"))
    if window:
        cfg = dataclasses.replace(cfg, window=window, full_every=2, full_offset=1)
    params = init_params(LM.param_specs(cfg), torch.Generator().manual_seed(0), device="cpu")
    return ServeEngine(cfg, params, ServeConfig(max_batch=B, max_prompt_len=WIDTH, max_new_tokens=6, **kw),
                       device="cpu")


def _hand_count(rows, window):
    """(kv_read_full, kv_read_window, kv_pairs_full, kv_pairs_window) of
    ``(q_start, q_len, kv_len)`` rows, key by key."""
    out = np.zeros(4, np.int64)
    for q0, ql, kl in rows:
        seen_full, seen_win = set(), set()
        for j in range(ql):
            keys = range(min(q0 + j + 1, kl))
            near = [k for k in keys if k > q0 + j - window]
            seen_full |= set(keys)
            seen_win |= set(near)
            out[2:] += (len(keys), len(near))
        out[:2] += (len(seen_full), len(seen_win))
    return out.tolist()


def test_a_steps_kv_reads_are_a_hand_count_of_its_descriptors(monkeypatch):
    """Every mixed step's and decode chunk's ``kv_read_*`` / ``kv_pairs_*``
    equal a key-by-key count of what its attention calls were handed (a
    decode chunk: the rows that were decoding at its start, at each of its
    steps' positions), fills split over steps with the window's edge inside
    chunks; and the steps' host reads are the window-0 engine's."""
    window = 8
    eng = _windowed_engine(window, paged=True, block_size=4, token_budget=BUDGET, sched_chunk=3)
    calls = []
    mixed_step, decode_step, chunk = LM.mixed_step, LM.decode_step, eng._decode_chunk

    def mixed(cfg, params, tokens, cache, tables, lanes, *a, **kw):
        calls.append(("mixed", [(q0, ql, kl) for _, q0, ql, kl, _ in lanes.desc.tolist()]))
        return mixed_step(cfg, params, tokens, cache, tables, lanes, *a, **kw)

    def decode(cfg, params, cache, tokens, pos, *a, **kw):
        live = calls[-1][2]
        calls[-1][1].extend((int(p), 1, int(p) + 1) for r, p in enumerate(pos.tolist()) if live[r])
        return decode_step(cfg, params, cache, tokens, pos, *a, **kw)

    def decode_chunk(st, n, *a, **kw):
        calls.append(("decode", [], ~st[3].numpy()))  # the rows not done at the chunk's start
        return chunk(st, n, *a, **kw)

    monkeypatch.setattr(LM, "mixed_step", mixed)
    monkeypatch.setattr(LM, "decode_step", decode)
    eng._decode_chunk = decode_chunk
    prompts = _prompts()
    _, spans = _serve(eng, prompts)
    steps = [s for s in spans if s.name == "engine.step"]
    assert [s.attrs["kind"] for s in steps] == [c[0] for c in calls] and {"mixed", "decode"} <= {c[0] for c in calls}
    names = ("kv_read_full", "kv_read_window", "kv_pairs_full", "kv_pairs_window")
    for s, call in zip(steps, calls):
        assert [s.attrs[k] for k in names] == _hand_count(call[1], window), s.attrs
    assert any(s.attrs["kv_read_window"] < s.attrs["kv_read_full"] for s in steps)
    monkeypatch.undo()
    _, plain = _serve(_windowed_engine(0, paged=True, block_size=4, token_budget=BUDGET, sched_chunk=3), prompts)
    plain = [s for s in plain if s.name == "engine.step"]
    assert all(s.attrs["kv_read_window"] == s.attrs["kv_read_full"] for s in plain)

    def reads(ss, kind):
        """A step's host reads, less a decode chunk's one stop check a token."""
        return {s.attrs["syncs"] - (s.attrs["lanes_run"] // B if kind == "decode" else 0)
                for s in ss if s.attrs["kind"] == kind}

    for kind in ("mixed", "decode"):  # the counters read nothing from the device
        assert reads(steps, kind) == reads(plain, kind), kind


@pytest.mark.parametrize("kw", [dict(paged=True, block_size=8, token_budget=BUDGET),
                                dict(paged=True, block_size=8, token_budget=BUDGET, draft_k=2),
                                dict(paged=False)], ids=["paged", "spec", "contiguous"])
def test_first_token_lies_between_admission_and_finish(kw):
    sched, spans = _serve(_engine(**kw), _prompts())
    reqs = list(sched.results.values())
    assert len(reqs) == 7
    for r in reqs:
        assert r.submitted_at <= r.started_at <= r.first_token_at <= r.finished_at, r
    for name in ("request.queued", "request.prefill", "request.decode"):
        assert sorted(s.attrs["rid"] for s in spans if s.name == name) == sorted(r.rid for r in reqs)
    steps = [s for s in spans if s.name == "engine.step"]
    assert steps and all(s.parent is None for s in steps)
    assert {s.name for s in spans if s.parent in {st.id for st in steps}} == {"engine.launch", "engine.readback"}


def test_a_request_files_its_first_token_before_it_finishes():
    eng = _engine(paged=True, block_size=8, token_budget=BUDGET, sched_chunk=2)
    t0 = time.monotonic()
    sched = Scheduler()
    reqs = [sched.submit(p, max_new_tokens=b) for p, b in zip(_prompts(), (6, 1, 4, 2, 6, 3, 5))]
    stream = eng.serve_stream(sched, drain=True)
    rid, _ = next(stream)  # the first request done, the others still decoding
    spans = [s for s in trace.spans(t0) if s.thread == threading.get_ident()]
    stream.close()
    filed = {name: {s.attrs["rid"] for s in spans if s.name == name}
             for name in ("request.queued", "request.prefill", "request.decode")}
    assert filed["request.decode"] == {rid} and filed["request.queued"] == filed["request.prefill"] <= set(reqs)
    assert len(filed["request.prefill"]) > 1  # requests with a first token that did not finish count too


def _profiled(eng, prompts):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(eng, prompts)
    return prof.events()


def test_the_profiler_sees_the_spans_only_through_the_mirror():
    eng = _engine("qwen2-moe-a2.7b", paged=True, block_size=8, token_budget=BUDGET)
    prompts = _prompts(4)
    _serve(eng, prompts)  # warm
    off = _profiled(eng, prompts)
    assert {e.name for e in off if e.is_user_annotation} == {"moe_expert_loop"}
    d0 = eng.mixed_dispatches + eng.decode_dispatches
    trace.mirror(True)
    try:
        on = _profiled(eng, prompts)
    finally:
        trace.mirror(False)
    steps = [e for e in on if e.name == "engine.step"]
    assert len(steps) == eng.mixed_dispatches + eng.decode_dispatches - d0
    assert {e.name for e in on if e.is_user_annotation} <= trace.names() | {"moe_expert_loop"}

    def under(e, name):
        while e is not None and e.name != name:
            e = e.cpu_parent
        return e

    dispatched = [e for e in on if e.name.startswith("aten::") and under(e, "engine.launch") is not None]
    assert dispatched and all(under(e, "engine.step") is not None for e in dispatched)
    for s in steps:  # each step's range holds the ops its dispatch issued
        ops = [e for e in dispatched if under(e, "engine.step") is s]
        assert ops and all(s.time_range.start <= e.time_range.start <= e.time_range.end <= s.time_range.end
                           for e in ops)


def _ev(name, start, end, dev="CPU"):
    tr = types.SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start)
    return types.SimpleNamespace(name=name, device_type=types.SimpleNamespace(name=dev), time_range=tr)


def test_idle_gaps_go_to_the_innermost_span_covering_half():
    kernels = [_ev(f"k{i}", a, a + 10, "CUDA") for i, a in enumerate((0, 20, 50, 100))]
    ranges = [_ev("engine.step", 0, 110, "CUDA"), _ev("moe_expert_loop", 0, 110, "CUDA"),  # no device work
              _ev("engine.readback", 9, 14), _ev("engine.step", 12, 48), _ev("engine.retire", 31, 49),
              _ev("engine.launch", 40, 49), _ev("engine.wait", 70, 80)]
    gaps, covered = idle_by_span(kernels + ranges, {"engine.step", "engine.readback", "engine.retire",
                                                    "engine.launch", "engine.wait"})
    # (10, 20): the step covers 8; (30, 50): the retire's 18 of its 18 beat the step's;
    # (60, 100): nothing covers half, the wait covers most
    assert gaps == [(10, "engine.step"), (20, "engine.retire"), (40, "engine.wait")]
    assert covered == 10 + 19 + 10
    assert idle_by_span(kernels, set()) == ([(10, "no span"), (20, "no span"), (40, "no span")], 0.0)
