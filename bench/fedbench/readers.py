"""What a metric's reader is handed, and the arithmetic readers share.

A reader (``bench/metrics/<metric>.py``) is a function ``read(run)`` of a
``RunData`` that returns a number, or None where the run holds nothing
for it to read (no profiled slice, no expert loop, no spans): the
harness then leaves the metric out of the result.  One quantity split
by the end-to-end metric it moves (``collect_ms.offline``,
``collect_ms.decode``) has one reader, ``bench/metrics/collect_ms.py``,
unless a file of the whole name is there.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from fedbench import flops


@dataclasses.dataclass
class RunData:
    seconds: float  # the window's length
    setup_s: float  # process start to the window's opening
    window: object  # drive.Window
    slice: object | None  # profiling.SliceData of a traced run
    model: dict  # the generator's model block of the configuration file
    flops: object = flops  # the module that counts the generator's FLOPs: the configuration's ``flops`` file


def window_requests(run: RunData) -> list:
    """The requests that retired inside the window."""
    w = run.window
    return [r for r in w.records if r.finished is not None and w.t_open <= r.finished < w.t_close]


def span_ms_per_query(run: RunData, name: str) -> float | None:
    """Wall time of the window's ``name`` calls over the queries they covered."""
    w = run.window
    spans = [s for s in w.spans if s.name == name and w.t_open <= s.t0 < w.t_close]
    n = sum(s.n for s in spans)
    return 1e3 * sum(s.t1 - s.t0 for s in spans) / n if n else None


def counter_delta(run: RunData, key: str) -> int:
    c = run.window.counters
    return c["close"][key] - c["open"][key]


def mfu_percent(run: RunData) -> float | None:
    """The model's FLOPs the window completed, over the card's bf16 peak:
    the prompt tokens the engine computed (not served from the prefix
    cache) in the window, at the mean context of the retired prompts, and
    the answer tokens of the requests retired in the window, each counted
    by the run's FLOP file."""
    done = [r for r in window_requests(run) if r.status == "done" and r.prompt is not None and r.answer is not None]
    if not done:
        return None
    m = run.model
    computed = counter_delta(run, "prefill_tokens") - counter_delta(run, "prefill_saved")
    mean_ctx = float(np.mean([len(r.prompt) for r in done])) / 2
    total = run.flops.prefill_flops(m, computed, mean_ctx)
    total += sum(run.flops.decode_flops(m, len(r.prompt), len(r.answer) - 1) for r in done)
    return 100.0 * total / (flops.PEAK_BF16 * run.seconds)


def sliced(run: RunData, fn):
    return None if run.slice is None else fn(run.slice)
