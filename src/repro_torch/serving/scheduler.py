"""Request scheduler for continuous-batching serving.

The scheduler owns the *admission* side of the serving stack: requests
enter per-tenant queues with an optional per-request generation budget
and an optional admission deadline; ``ServeEngine.serve``/``serve_stream``
pull from it whenever a cache slot frees up, so short generations retire
and hand their slot to queued work while long generations keep decoding.

**Tenant SLO classes.**  Every request carries a ``tenant`` label and an
integer ``priority``.  Admission picks the next request in three steps:

  1. strict priority — among the tenant queues' *heads*, only the highest
     priority class is eligible (an interactive class preempts the
     *queue*; it never preempts a running slot — decode always finishes
     or retires on its own terms);
  2. weighted-fair within a class — stride scheduling over per-tenant
     virtual ``pass`` values (each admission advances the winner's pass
     by ``1 / weight``), so a tenant with weight 3 gets ~3x the admission
     slots of a weight-1 tenant under contention;
  3. FIFO within a tenant — a tenant's own requests never reorder.

With a single tenant and uniform priority this degenerates to exactly
the old global FIFO, so engine-vs-engine parity oracles are unaffected.
``fifo=True`` forces global submission-order admission across tenants
(the benchmark baseline that lets an interactive class collapse behind a
batch flood) while still tracking per-tenant stats.

The scheduler is **thread-safe**: a producer thread may ``submit`` while
an engine thread is consuming via ``pop_ready``/``finish`` (the pipelined
front door runs collect for micro-batch N+1 on a collector thread while
the engine decodes micro-batch N).  The producer signals end-of-stream
with ``close()``; the engine blocks in ``wait_for_work`` when the queue
is momentarily empty and exits once the scheduler is closed and drained.

**Windows vs lifetime.**  A resident engine serves many calls against
long-lived state, so every ``latency_stats()`` quantity comes in two
flavors: the *window* (since the engine last called ``begin_window()``,
i.e. the current/most recent serve call) at the top level — keeping the
one-shot reading identical to before — and cumulative *lifetime* totals
nested under ``"lifetime"``.  Without ``begin_window`` the window spans
the scheduler's whole life and the two coincide.

Contracts:
  * ``submit`` is cheap and returns a request id immediately; submitting
    to a closed scheduler raises.
  * ``pop_ready`` admits per the class/weight/FIFO order above; a request
    whose admission deadline has already passed is marked ``expired``
    (recorded in ``results``) and never admitted — the continuous-
    batching analogue of the orchestrator dropping stragglers at the
    collect deadline.  A selected request the engine's gate rejects
    stays at its queue head and ``None`` is returned: big requests wait
    for KV blocks rather than being overtaken, so admission order never
    depends on pool pressure.
  * ``close()`` ends admission; ``drain()`` blocks until every submitted
    request reached a terminal state (done or expired).
  * Completion timestamps are recorded on ``finish`` so per-request
    latency distributions (p50/p95) fall out for free.  ``submit`` takes
    an optional ``t0`` anchor so ``latency_s`` can cover an upstream
    stage (e.g. collect start), not just generation — the anchor moves
    ONLY the latency origin; ``deadline_s`` expiry always counts from
    the actual submit time, so upstream stage cost is never charged
    against the generation SLO.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request tracked through the admission queue."""

    rid: int
    tokens: np.ndarray  # (S,) prompt token ids
    max_new_tokens: int | None = None  # None -> engine's configured cap
    deadline_s: float | None = None  # admission budget from submit time
    submitted_at: float = 0.0  # actual submit time: the expiry clock
    anchor_t0: float | None = None  # optional upstream anchor for latency_s only
    started_at: float | None = None  # slot admission time
    finished_at: float | None = None
    answer: np.ndarray | None = None
    status: str = "queued"  # queued | active | done | expired
    truncated: bool = False  # done, but cut short by KV-pool OOM
    deadlocked: bool = False  # done empty: admission dependency deadlock
    tag: Any = None  # caller-side routing key (e.g. query index)
    tenant: str = "default"  # SLO class label
    priority: int = 0  # higher admits first (queue preemption only)

    @property
    def latency_s(self) -> float | None:
        if self.finished_at is None:
            return None
        start = self.submitted_at if self.anchor_t0 is None else self.anchor_t0
        return self.finished_at - start


def _broadcast(values, n: int, what: str) -> list:
    """Scalar-or-per-request broadcast shared by every serve entry point.

    A 0-d numpy array is a *scalar* (``isinstance(x, np.ndarray)`` alone
    would send it down the ``list(x)`` path, which raises); a list-typed
    value must match ``len(prompts)`` exactly — silent ``zip`` truncation
    would drop requests."""
    if isinstance(values, np.ndarray) and values.ndim == 0:
        values = values.item()
    if isinstance(values, (list, tuple, np.ndarray)):
        out = [None if v is None else v for v in list(values)]
        if len(out) != n:
            raise ValueError(
                f"{what} has {len(out)} entries for {n} prompts; "
                "per-request values must match the prompt count"
            )
        return out
    return [values] * n


def _percentiles(reqs) -> dict:
    """n_done/expiry/flag counts + p50/p95/mean over a request set."""
    done = [r for r in reqs if r.status == "done"]
    out = {
        "n_done": len(done),
        "n_expired": sum(1 for r in reqs if r.status == "expired"),
        "n_truncated": sum(1 for r in done if r.truncated),
        "n_deadlocked": sum(1 for r in done if r.deadlocked),
    }
    lats = sorted(r.latency_s for r in done)
    if lats:
        arr = np.asarray(lats)
        out["p50_s"] = float(np.percentile(arr, 50))
        out["p95_s"] = float(np.percentile(arr, 95))
        out["mean_s"] = float(arr.mean())
    return out


class Scheduler:
    """Thread-safe multi-tenant admission queue feeding a ``ServeEngine``
    slot pool.  See the module docstring for the admission order."""

    def __init__(self, tenant_weights: dict[str, float] | None = None,
                 fifo: bool = False, deadline_slack_s: float | None = None):
        self._queues: dict[str, collections.deque[Request]] = {}
        self._weights = {k: float(v) for k, v in (tenant_weights or {}).items()}
        bad = [k for k, v in self._weights.items() if v <= 0]
        if bad:
            raise ValueError(f"tenant weight(s) must be positive: {bad}")
        if deadline_slack_s is not None and deadline_slack_s < 0:
            raise ValueError(f"deadline_slack_s={deadline_slack_s} must be >= 0")
        self._fifo = bool(fifo)
        # deadline-aware admission boost: a queue head within this many
        # seconds of its admission-deadline expiry is promoted to top
        # priority (fair-share heads can otherwise starve into expiry
        # behind heavier tenants).  None disables the boost; expiry
        # accounting itself is untouched — an already-overdue head still
        # expires before selection ever sees it
        self._deadline_slack = deadline_slack_s
        self._pass: dict[str, float] = {}  # stride-scheduling virtual time
        self._next_rid = 0
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False
        self.results: dict[int, Request] = {}
        # occupancy gauges (engine-reported): last + extremes, so memory
        # headroom falls out of latency_stats() alongside the percentiles
        self._peak_backlog = 0
        self._occupancy: dict[str, int] = {}
        self._prefix: dict[str, int | float] | None = None
        self._prefix_lifetime: dict[str, int | float] | None = None
        self._dispatch: dict[str, int] | None = None
        self._dispatch_lifetime: dict[str, int] | None = None
        # per-tenant admission gauges (engine-reported, window + lifetime)
        self._tenant_admit: dict[str, dict[str, int]] = {}
        self._tenant_admit_life: dict[str, dict[str, int]] = {}
        self._window_t0 = 0.0  # window == lifetime until begin_window()

    def submit(
        self,
        prompt_tokens: np.ndarray,
        *,
        max_new_tokens: int | None = None,
        deadline_s: float | None = None,
        tag: Any = None,
        t0: float | None = None,
        tenant: str = "default",
        priority: int = 0,
    ) -> int:
        tokens = np.asarray(prompt_tokens).ravel()
        if tokens.size == 0:
            # an empty prompt has no last position to read first-token
            # logits from, yet would still allocate a KV block
            # (blocks_for(0) == 1) — reject at the door, loudly
            raise ValueError(
                "empty prompt: a request must carry at least one token "
                "(zero-length prompts have no position to decode from)"
            )
        req = Request(
            rid=-1,
            tokens=tokens,
            max_new_tokens=None if max_new_tokens is None else int(max_new_tokens),
            deadline_s=deadline_s,
            submitted_at=time.monotonic(),
            anchor_t0=t0,
            tag=tag,
            tenant=str(tenant),
            priority=int(priority),
        )
        with self._cond:
            if self._closed:
                raise RuntimeError("scheduler is closed; no further submissions")
            req.rid = self._next_rid
            self._next_rid += 1
            q = self._queues.get(req.tenant)
            if q is None:
                q = self._queues[req.tenant] = collections.deque()
                # a tenant joining late starts at the current virtual time,
                # not at zero — otherwise it would monopolize admission
                # until its pass catches up with the incumbents
                self._pass.setdefault(
                    req.tenant, min(self._pass.values(), default=0.0)
                )
            q.append(req)
            self._peak_backlog = max(
                self._peak_backlog, sum(len(x) for x in self._queues.values())
            )
            self._cond.notify_all()
        return req.rid

    def submit_many(
        self,
        prompts,
        max_new_tokens=None,
        deadlines=None,
        *,
        tags=None,
        t0: float | None = None,
        tenants=None,
        priorities=None,
    ) -> list[int]:
        """Submit a batch of prompts; ``max_new_tokens``/``deadlines``/
        ``tenants``/``priorities`` may each be a scalar (broadcast) or a
        per-request sequence whose length must equal ``len(prompts)``."""
        n = len(prompts)
        budgets = _broadcast(max_new_tokens, n, "max_new_tokens")
        deads = _broadcast(deadlines, n, "deadlines")
        tens = _broadcast("default" if tenants is None else tenants, n, "tenants")
        prios = _broadcast(0 if priorities is None else priorities, n, "priorities")
        tags = list(tags) if tags is not None else [None] * n
        if len(tags) != n:
            raise ValueError(f"tags has {len(tags)} entries for {n} prompts")
        return [
            self.submit(
                np.asarray(p).ravel(), max_new_tokens=b, deadline_s=d, tag=g,
                t0=t0, tenant=te, priority=pr,
            )
            for p, b, d, g, te, pr in zip(prompts, budgets, deads, tags, tens, prios)
        ]

    @property
    def n_queued(self) -> int:
        return sum(len(q) for q in self._queues.values())

    @property
    def has_pending(self) -> bool:
        return any(self._queues.values())

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self):
        """End of admission: no further ``submit`` calls are accepted and
        consumers blocked in ``wait_for_work`` wake up to drain and exit."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def wait_for_work(self, timeout: float | None = None) -> bool:
        """Block until a queue is non-empty or the scheduler is closed.
        Returns True if there is work (or close) to act on, False on
        timeout — the consumer side of the submit/close handshake."""
        with self._cond:
            return self._cond.wait_for(
                lambda: any(self._queues.values()) or self._closed, timeout=timeout
            )

    def drain(self, timeout: float | None = None) -> bool:
        """Block until every submitted request reached a terminal state
        (done or expired) — the producer side of the handshake."""
        with self._cond:
            return self._cond.wait_for(
                lambda: len(self.results) >= self._next_rid, timeout=timeout
            )

    @property
    def n_in_flight(self) -> int:
        """Submitted requests not yet terminal (queued or active)."""
        with self._lock:
            return self._next_rid - len(self.results)

    def wait_backlog_below(self, n: int, timeout: float | None = None) -> bool:
        """Block until fewer than ``n`` submitted requests are non-terminal
        — producer-side backpressure, so a fast collector stays a bounded
        number of micro-batches ahead of a slow engine instead of
        materializing the whole workload in the queue.  Expired requests
        count as terminal the moment ``pop_ready`` drops them, so a
        deadline-heavy workload can never wedge a waiting producer."""
        with self._cond:
            return self._cond.wait_for(
                lambda: self._next_rid - len(self.results) < n, timeout=timeout
            )

    def _expire_heads(self, now: float) -> None:
        """Drop overdue requests from every queue head (holding the lock)."""
        for q in self._queues.values():
            while q:
                req = q[0]
                if req.deadline_s is not None and now - req.submitted_at > req.deadline_s:
                    q.popleft()
                    req.status = "expired"
                    req.finished_at = now
                    self.results[req.rid] = req
                    self._cond.notify_all()  # wake drain() waiters
                else:
                    break

    def pop_ready(self, admit_if=None) -> Request | None:
        """Next admissible request per class priority -> tenant weighted-
        fair -> per-tenant FIFO (see module docstring); expires overdue
        queue heads in passing.

        ``admit_if(req) -> bool`` is the engine's memory-aware admission
        gate (paged KV: does the pool have blocks for this prompt?).  A
        selected request the gate rejects stays AT ITS QUEUE HEAD and
        ``None`` is returned: big requests wait for blocks rather than
        being overtaken (no cross-tenant overtake under memory pressure
        either — admission order stays deterministic, so paged-vs-
        contiguous bit-parity never depends on pool pressure)."""
        with self._cond:
            now = time.monotonic()
            self._expire_heads(now)
            heads = [q[0] for q in self._queues.values() if q]
            if not heads:
                return None
            if self._fifo:
                req = min(heads, key=lambda r: r.rid)
            else:
                # deadline boost: heads whose expiry is within the slack
                # outrank every priority class (they would expire waiting
                # their fair-share turn); ties among urgent heads fall
                # back to the same weighted-fair order
                urgent = [
                    r for r in heads
                    if self._deadline_slack is not None
                    and r.deadline_s is not None
                    and r.deadline_s - (now - r.submitted_at) <= self._deadline_slack
                ]
                eligible = urgent
                if not eligible:
                    top = max(r.priority for r in heads)
                    eligible = [r for r in heads if r.priority == top]
                req = min(
                    eligible,
                    key=lambda r: (self._pass.get(r.tenant, 0.0), r.rid),
                )
            if admit_if is not None and not admit_if(req):
                return None  # head stays queued until resources free up
            self._queues[req.tenant].popleft()
            if not self._fifo:
                w = self._weights.get(req.tenant, 1.0)
                self._pass[req.tenant] = self._pass.get(req.tenant, 0.0) + 1.0 / w
            req.status = "active"
            req.started_at = now
            return req

    def finish(self, req: Request, answer: np.ndarray, truncated: bool = False,
               deadlocked: bool = False):
        """``truncated=True`` marks a request the engine force-retired on
        KV-pool OOM: terminal and answered, but the answer is a prefix of
        what the budget allowed — callers watching degradation under
        memory pressure read it off the request / ``n_truncated``.
        ``deadlocked=True`` marks a request force-done (empty answer) when
        its admission hit a prefix-dependency deadlock — the graceful
        degradation of ``AdmissionDeadlock``, same contract as truncation:
        terminal, flagged, neighbors unharmed."""
        req.status = "done"
        req.truncated = truncated
        req.deadlocked = deadlocked
        req.finished_at = time.monotonic()
        req.answer = np.asarray(answer)
        with self._cond:
            self.results[req.rid] = req
            self._cond.notify_all()  # wake drain() waiters

    # ---- observability ----
    def begin_window(self):
        """Start a stats window: subsequent ``latency_stats()`` top-level
        numbers cover completions (and engine-reported window gauges)
        from this point on, with cumulative totals under ``"lifetime"``.
        The engine calls this on every ``serve``/``serve_stream`` entry,
        so on a resident engine each call reads as its own window."""
        with self._lock:
            self._window_t0 = time.monotonic()
            self._tenant_admit = {}
            self._prefix = None
            self._dispatch = None

    def record_occupancy(self, *, free_slots: int | None = None, free_blocks: int | None = None,
                         reclaimable_blocks: int | None = None,
                         draft_free_blocks: int | None = None):
        """Engine-side memory gauges, sampled once per scheduler pass.

        ``free_slots``: open decode slots right now; ``free_blocks``: free
        KV blocks in the TARGET pool (paged engines only — contiguous
        engines pass None); ``reclaimable_blocks``: parked zero-ref
        prefix-cache blocks the pool can evict under pressure
        (prefix-cache engines only); ``draft_free_blocks``: free blocks
        in the DRAFTER's pool (speculative engines only — a drafter-side
        OOM breaks speculation for the row, so its headroom needs its own
        gauge).  Keeps the last sample plus the running minimum of each,
        so "how close did serving get to the memory wall" (peak
        concurrency = ``max_batch - min_free_slots``, block headroom =
        ``min_free_blocks`` + reclaimable) is answerable after the fact."""
        with self._lock:
            for key, val in (
                ("free_slots", free_slots),
                ("free_blocks", free_blocks),
                ("reclaimable_blocks", reclaimable_blocks),
                ("draft_free_blocks", draft_free_blocks),
            ):
                if val is None:
                    continue
                self._occupancy[key] = int(val)
                low = f"min_{key}"
                self._occupancy[low] = min(self._occupancy.get(low, int(val)), int(val))

    def record_prefix_stats(self, window: dict, lifetime: dict | None = None):
        """Prefix-cache counters, engine-reported each pass.  ``window``
        covers the current serve call (deltas since ``begin_window``) and
        lands at the TOP level of ``latency_stats()``; ``lifetime`` holds
        the engine's cumulative totals (a resident engine outlives many
        windows) and nests under ``"lifetime"``.  Expected keys:
        ``prefix_lookups``/``prefix_hits``/``prefill_tokens``/
        ``prefill_tokens_saved``/``prefix_shared_blocks``/
        ``prefix_cached_blocks`` plus, on a tiered cache, the spill
        gauges (``spilled_blocks``, ``spill_bytes_used``,
        ``spill_demotions``, ``spill_readmits``).  ``latency_stats``
        derives ``prefix_hit_rate`` and ``prefill_saved_frac``."""
        with self._lock:
            self._prefix = {k: v for k, v in window.items()}
            if lifetime is not None:
                self._prefix_lifetime = {k: v for k, v in lifetime.items()}

    def record_dispatch_stats(self, *, admit_dispatches: int, decode_dispatches: int,
                              mixed_dispatches: int, steps: int,
                              lifetime: dict | None = None,
                              draft_dispatches: int = 0,
                              draft_fill_dispatches: int = 0,
                              spec_rounds: int = 0,
                              spec_tokens_proposed: int = 0,
                              spec_tokens_accepted: int = 0,
                              spec_tokens_emitted: int = 0):
        """Dispatch counters for THIS serve window (engine deltas,
        overwritten each pass): fused admit prefills, fused decode
        chunks, and unified mixed prefill+decode dispatches, plus the
        number of engine scheduler steps — ``latency_stats`` derives
        ``dispatches_per_step`` from them (the O(1)-per-step regression
        gauge of the unified path).  ``lifetime`` optionally carries the
        engine's cumulative totals for the nested lifetime view.

        Speculative engines (``draft_k > 0``) additionally report:
        drafter k-loop dispatches, drafter prefill-only dispatches
        (``draft_fill_dispatches`` — admission cost, like target
        prefill, excluded from the per-round bound), spec rounds
        (verify dispatches that carried at least one ``q_len > 1``
        descriptor), and per-round token
        tallies (proposed drafts / accepted drafts / committed tokens,
        where committed includes the correction token).  These stay OUT
        of ``dispatches_per_step`` — ``latency_stats`` derives the
        speculative gauges ``spec_accept_rate``,
        ``spec_tokens_per_round`` (the tokens/step > 1 headline), and
        ``dispatches_per_spec_round`` (the O(2) bound) from them."""
        with self._lock:
            self._dispatch = {
                "admit_dispatches": int(admit_dispatches),
                "decode_dispatches": int(decode_dispatches),
                "mixed_dispatches": int(mixed_dispatches),
                "engine_steps": int(steps),
            }
            if draft_dispatches or draft_fill_dispatches or spec_rounds:
                self._dispatch.update(
                    draft_dispatches=int(draft_dispatches),
                    draft_fill_dispatches=int(draft_fill_dispatches),
                    spec_rounds=int(spec_rounds),
                    spec_tokens_proposed=int(spec_tokens_proposed),
                    spec_tokens_accepted=int(spec_tokens_accepted),
                    spec_tokens_emitted=int(spec_tokens_emitted),
                )
            if lifetime is not None:
                self._dispatch_lifetime = {k: int(v) for k, v in lifetime.items()}

    def record_tenant_admit(self, tenant: str, *, prefill_tokens: int,
                            prefill_tokens_saved: int = 0, hit: bool = False):
        """One admission's prefix accounting, attributed to a tenant (the
        engine calls this at every slot admit).  Accumulated per window
        AND per scheduler lifetime; surfaced under
        ``latency_stats()["tenants"][tenant]``."""
        with self._lock:
            for book in (self._tenant_admit, self._tenant_admit_life):
                acc = book.setdefault(
                    tenant,
                    {"n_admitted": 0, "prefix_lookups": 0, "prefix_hits": 0,
                     "prefill_tokens": 0, "prefill_tokens_saved": 0},
                )
                acc["n_admitted"] += 1
                acc["prefix_lookups"] += 1
                acc["prefix_hits"] += int(bool(hit))
                acc["prefill_tokens"] += int(prefill_tokens)
                acc["prefill_tokens_saved"] += int(prefill_tokens_saved)

    @staticmethod
    def _derive_prefix(g: dict) -> dict:
        out = dict(g)
        if out.get("prefix_lookups"):
            out["prefix_hit_rate"] = out["prefix_hits"] / out["prefix_lookups"]
        if out.get("prefill_tokens"):
            out["prefill_saved_frac"] = (
                out["prefill_tokens_saved"] / out["prefill_tokens"]
            )
        return out

    def _tenant_stats(self, reqs, admit_book) -> dict:
        """Per-tenant view over ``reqs`` (window or lifetime): completion
        counts, percentiles, output tokens, and admission/prefix gauges
        from the matching accounting book."""
        by_tenant: dict[str, list[Request]] = {}
        for r in reqs:
            by_tenant.setdefault(r.tenant, []).append(r)
        tenants = {}
        for name in sorted(set(by_tenant) | set(admit_book)):
            treqs = by_tenant.get(name, [])
            st = _percentiles(treqs)
            st["tokens_out"] = int(
                sum(len(r.answer) for r in treqs if r.status == "done" and r.answer is not None)
            )
            admit = admit_book.get(name)
            if admit is not None:
                st.update(self._derive_prefix(admit))
            tenants[name] = st
        return tenants

    def latency_stats(self) -> dict:
        """p50/p95/mean submit->finish latency plus occupancy, prefix-
        cache, dispatch, and per-tenant gauges.

        Top-level numbers cover the current WINDOW (since the last
        ``begin_window()``; the scheduler's whole life if never called).
        ``"lifetime"`` nests the cumulative view — completion counts and
        percentiles over every request this scheduler ever finished, plus
        the engine's lifetime prefix/dispatch totals when reported.
        ``"tenants"`` (present when tenants completed work or admitted in
        the window) maps tenant -> per-tenant window stats."""
        with self._lock:
            all_reqs = list(self.results.values())
            window = [
                r for r in all_reqs
                if r.finished_at is not None and r.finished_at >= self._window_t0
            ]
            gauges: dict[str, Any] = {"peak_backlog": self._peak_backlog, **self._occupancy}
            if self._dispatch is not None:
                gauges.update(self._dispatch)
                if self._dispatch["engine_steps"]:
                    gauges["dispatches_per_step"] = (
                        self._dispatch["admit_dispatches"]
                        + self._dispatch["decode_dispatches"]
                        + self._dispatch["mixed_dispatches"]
                    ) / self._dispatch["engine_steps"]
                if self._dispatch.get("spec_tokens_proposed"):
                    gauges["spec_accept_rate"] = (
                        self._dispatch["spec_tokens_accepted"]
                        / self._dispatch["spec_tokens_proposed"]
                    )
                if self._dispatch.get("spec_rounds"):
                    gauges["spec_tokens_per_round"] = (
                        self._dispatch["spec_tokens_emitted"]
                        / self._dispatch["spec_rounds"]
                    )
                    # every drafter dispatch + its paired verify dispatch;
                    # the unified-path O(2)-per-spec-round regression gauge
                    gauges["dispatches_per_spec_round"] = (
                        self._dispatch.get("draft_dispatches", 0)
                        + self._dispatch["spec_rounds"]
                    ) / self._dispatch["spec_rounds"]
            if self._prefix is not None:
                gauges.update(self._derive_prefix(self._prefix))
            lifetime = _percentiles(all_reqs)
            if self._prefix_lifetime is not None:
                lifetime.update(self._derive_prefix(self._prefix_lifetime))
            if self._dispatch_lifetime is not None:
                lifetime.update(self._dispatch_lifetime)
            lt_tenants = self._tenant_stats(all_reqs, self._tenant_admit_life)
            if lt_tenants:
                lifetime["tenants"] = lt_tenants
            tenants = self._tenant_stats(window, self._tenant_admit)
            win = _percentiles(window)
        out = {**win, **gauges, "lifetime": lifetime}
        if win["n_done"] == 0:
            # preserve the historical empty-window shape: n_done plus
            # gauges only (tests and callers probe keys conditionally)
            out = {"n_done": 0, **gauges, "lifetime": lifetime}
        if tenants:
            out["tenants"] = tenants
        return out
