"""The readers of ``window_read_share`` and ``mixed_prefill_roofline``
(``bench/fedbench/window.py``) on a hand-made ring and profiled slice: the
share sums the window's steps, the roofline takes the steps the slice
holds (its first dispatch at ``SLICE_AT`` of the window, then
``engine_steps`` of them) and prices each one's windowed and full layers
apart; None where the program records no read counters or has no
recorder."""
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [p for p in (str(BENCH), str(BENCH.parent / "src")) if p not in sys.path]

from fedbench import cell, flops, profiling, window  # noqa: E402
from fedbench.drive import Window  # noqa: E402
from fedbench.readers import RunData  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402

M = {"n_layers": 28, "n_heads": 32, "n_kv_heads": 4, "head_dim": 128, "dtype": "bfloat16", "window": 1024,
     "full_every": 4, "full_offset": 3}
KERNEL = "void (anonymous namespace)::mixed_prefill_window_bf16<128>(...)"
READS = dict(kv_read_full=5000, kv_read_window=2000, kv_pairs_full=3_000_000, kv_pairs_window=1_500_000)


def _slice(steps: int, op_s: dict) -> profiling.SliceData:
    return profiling.SliceData(window_s=4.0, busy_s=1.0, launches=100, engine_steps=steps, attn_s=0.0,
                               device_ops=[], idle_gaps=[], op_s=op_s, range_s={})


def _step(t, kind="mixed", launch_at=None, **attrs):
    sid = trace.record("engine.step", t, t + 0.05, kind=kind, **attrs)
    at = t + 0.001 if launch_at is None else launch_at
    trace.record("engine.launch", at, t + 0.03, parent=sid)
    return sid


@pytest.fixture(scope="module")
def ring_run():
    """A window of 10 s opening 3e6 s before the clock's zero: the slice
    starts 4 s in.  Steps: one before the window, one inside it before the
    slice (its launch at 3.999 s), three in the slice (a decode chunk among
    them), one the slice does not hold."""
    t = -3e6
    _step(t - 1.0, kv_read_full=10**9, kv_read_window=0, kv_pairs_full=1, kv_pairs_window=1, lanes_live=1, rows=1)
    _step(t + 3.95, launch_at=t + 3.999, lanes_live=100, rows=2, **READS)
    _step(t + 4.01, lanes_live=1000, rows=3, **READS)
    _step(t + 4.10, kind="decode", lanes_live=16, rows=16, kv_read_full=30000, kv_read_window=16000,
          kv_pairs_full=30000, kv_pairs_window=16000)
    _step(t + 4.20, lanes_live=200, rows=4, **dict(READS, kv_pairs_window=100, kv_read_window=1000))
    _step(t + 4.30, lanes_live=300, rows=5, **READS)
    win = Window(t, t + 10.0, [], [], {})
    return RunData(seconds=10.0, setup_s=5.0, window=win, slice=_slice(3, {KERNEL: 2e-3, "other": 1.0}), model=M)


def _bound(lanes, rows, reads):
    es, h, kv, dh = 2, 32, 4, 128
    fixed = 2 * lanes * h * dh * es + rows * 5 * 4
    out = 0.0
    for kind, n in (("window", 21), ("full", 7)):
        b = fixed + 2 * reads[f"kv_read_{kind}"] * kv * dh * es
        f = 4 * h * dh * reads[f"kv_pairs_{kind}"]
        out += n * max(b / flops.HBM_BW, f / flops.PEAK_BF16)
    return out


def test_the_share_sums_the_windows_steps(ring_run):
    full = 4 * 5000 + 30000
    win = 2000 * 3 + 16000 + 1000
    assert cell.load_reader("window_read_share.offline")(ring_run) == pytest.approx(100 * win / full)


def test_the_roofline_prices_the_slices_mixed_steps(ring_run):
    assert [s.attrs["lanes_live"] for s in window.slice_steps(ring_run)] == [1000, 16, 200]
    bound = _bound(1000, 3, READS) + _bound(200, 4, dict(READS, kv_pairs_window=100, kv_read_window=1000))
    got = cell.load_reader("mixed_prefill_roofline.offline")(ring_run)
    assert got == pytest.approx(100 * bound / 2e-3)
    assert 0 < got <= 100


def test_no_counters_or_no_recorder_read_none(ring_run, monkeypatch):
    bare = RunData(seconds=10.0, setup_s=5.0, window=Window(-5e6, -5e6 + 10.0, [], [], {}),
                   slice=_slice(1, {KERNEL: 1e-3}), model=M)
    trace.record("engine.step", -5e6 + 5.0, -5e6 + 5.1, kind="mixed", lanes_live=10, rows=1)  # no counters
    for name in ("window_read_share.offline", "mixed_prefill_roofline.offline"):
        assert cell.load_reader(name)(bare) is None
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.trace", None)
    for name in ("window_read_share.offline", "mixed_prefill_roofline.offline"):
        assert cell.load_reader(name)(ring_run) is None
