"""The port's flight recorder: spans and counters kept in memory.

One recorder per process (the module functions below), always on, with
no switch.  It holds:

* **Spans** in a bounded ring (the newest ``CAPACITY``; a long-lived
  server cannot grow it): ``with span(name, **attrs) as sp:`` records the
  span's id, its parent's id (by default the innermost span open on the
  calling thread), name, thread, ``start`` and ``end`` on
  ``time.monotonic()``, and ``attrs`` (``sp.attrs`` may be filled in
  before the span closes).  ``record`` files a span whose times are
  already known: a request's queue wait and prefill, recorded at its
  first token, and its decode, recorded when it finishes.  A span that
  saw device→host reads on its thread carries their number as
  ``attrs["syncs"]``, its children's included.
* **Counters**, process-wide by site: ``count(site, n)``, and
  ``to_host(tensor, site)``, the one way the serving path reads the
  device from the host: it counts the read under ``site`` and against
  the calling thread's open spans.

Reading: ``spans(t0, t1)`` (those that started in ``[t0, t1)``, oldest
first) and ``counters()``.  Nothing is written out.

``mirror(True)`` makes every span also open a ``torch.profiler``
``record_function`` range of its name, so that the spans land on the
profiler's timeline beside the kernels; only an operator's profiling
tool turns it on (``launch/profile_serve.py``, for its profiled serve).
Off, the profiler sees none of them.

The names, by layer: ``engine.step`` (one per engine dispatch; children
``engine.launch``, the enqueue, and ``engine.readback``, the wait for the
rows' state), ``engine.admit``, ``engine.retire``, ``engine.wait``,
``stream.yield`` (the consumer's time at the engine's ``yield``);
``request.queued``, ``request.prefill``, ``request.decode``;
``fed.collect``, ``fed.rerank``, ``fed.prompt``; ``provider.tokenize``,
``provider.index``.  Counter sites: ``engine.readback``,
``engine.decode_stop``, ``engine.retire``, ``engine.spill``,
``model.token_check``, ``moe.group_sizes``, ``provider.topk``,
``rerank.scores``.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time

CAPACITY = 1 << 16  # spans the ring holds, the newest


class _Thread(threading.local):
    def __init__(self):
        self.stack: list[Span] = []  # open spans, innermost last
        self.syncs = 0  # device->host reads made on this thread


class Span:
    __slots__ = ("id", "parent", "name", "thread", "start", "end", "attrs", "_rec", "_syncs0", "_range")

    def __init__(self, rec: Recorder, name: str, parent: int | None, attrs: dict):
        self._rec = rec
        self.id = next(rec._ids)
        self.name = name
        self.parent = parent
        self.attrs = attrs
        self.thread = threading.get_ident()
        self.start = self.end = None
        self._range = None

    def __enter__(self) -> Span:
        rec = self._rec
        local = rec._local
        stack = local.stack
        if self.parent is None and stack:
            self.parent = stack[-1].id
        stack.append(self)
        self._syncs0 = local.syncs
        if rec.mirroring:
            from torch.profiler import record_function

            self._range = record_function(self.name)
            self._range.__enter__()
        self.start = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.monotonic()
        rec, local = self._rec, self._rec._local
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        stack = local.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # closed out of order (a generator abandoned on another thread)
            stack.remove(self)
        n = local.syncs - self._syncs0
        if n:
            self.attrs["syncs"] = n
        rec._ring.append(self)


class Recorder:
    """A ring of spans and a table of counters (see the module docstring)."""

    def __init__(self, capacity: int = CAPACITY):
        # appending to the ring and copying it are each one step under the
        # interpreter lock; the counters' read-modify-write takes a lock
        self._ring: collections.deque[Span] = collections.deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._counters: collections.Counter[str] = collections.Counter()
        self._lock = threading.Lock()
        self._local = _Thread()
        self.mirroring = False

    def span(self, name: str, parent: int | None = None, **attrs) -> Span:
        return Span(self, name, parent, attrs)

    def record(self, name: str, start: float, end: float, parent: int | None = None, **attrs) -> int:
        """File a span whose times are known; returns its id."""
        sp = Span(self, name, parent, attrs)
        sp.start, sp.end = start, end
        self._ring.append(sp)
        return sp.id

    def count(self, site: str, n: int = 1) -> None:
        with self._lock:
            self._counters[site] += n

    def to_host(self, tensor, site: str, copy: bool = False):
        """``tensor`` on the host, counted under ``site`` and against the
        calling thread's open spans: a copy from a device, the tensor
        itself on the CPU unless ``copy``."""
        self.count(site)
        self._local.syncs += 1
        return tensor.to("cpu", copy=copy)

    def spans(self, t0: float = float("-inf"), t1: float = float("inf")) -> list[Span]:
        """The ring's spans that started in ``[t0, t1)``, in the order they closed."""
        return [s for s in list(self._ring) if t0 <= s.start < t1]

    def counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def names(self) -> set[str]:
        """The names of the ring's spans (the ranges ``mirror`` adds to a profile)."""
        return {s.name for s in list(self._ring)}

    def mirror(self, on: bool) -> None:
        self.mirroring = bool(on)


_RECORDER = Recorder()
span = _RECORDER.span
record = _RECORDER.record
count = _RECORDER.count
to_host = _RECORDER.to_host
spans = _RECORDER.spans
counters = _RECORDER.counters
names = _RECORDER.names
mirror = _RECORDER.mirror
