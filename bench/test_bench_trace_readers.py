"""The readers of the program's own recorder (``bench/fedbench/ring.py``):
their arithmetic on hand-made ring entries, entries outside the window
(or outside set-up) ignored; None where the program has no recorder; and
one shrunk MoE cell on the CPU, whose traced result line carries all
five quantities."""
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [p for p in (str(BENCH), str(BENCH.parent / "src")) if p not in sys.path]

from fedbench import cell  # noqa: E402
from fedbench.drive import Window  # noqa: E402
from fedbench.readers import RunData  # noqa: E402
from fedbench.testing import WINDOW_S, shrink  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402

QUANTITIES = ["live_lane_share", "host_syncs_per_step", "between_steps_ms", "first_token_ms", "index_build_s"]


def _run(t_open: float) -> RunData:
    return RunData(seconds=10.0, setup_s=5.0, window=Window(t_open, t_open + 10.0, [], [], {}), slice=None, model={})


def _step(t0, launch, readback, end, **attrs) -> int:
    sid = trace.record("engine.step", t0, end, **attrs)
    trace.record("engine.launch", *launch, parent=sid)
    if readback is not None:
        trace.record("engine.readback", *readback, parent=sid, syncs=2)
    return sid


@pytest.fixture(scope="module")
def ring_run():
    """A run whose window opens 1e6 s before the clock's zero: no span the
    program records can fall into it."""
    t = -1e6
    trace.record("provider.tokenize", t - 6.0, t - 5.5)  # before set-up
    trace.record("provider.tokenize", t - 4.0, t - 3.0, provider=0)
    trace.record("provider.index", t - 3.0, t - 1.0, provider=0)
    trace.record("provider.index", t + 1.0, t + 2.0, provider=1)  # inside the window, not set-up
    _step(t - 0.5, (t - 0.4, t - 0.3), (t - 0.3, t + 0.1), t + 0.1, kind="mixed",
          lanes_live=999, lanes_run=999, syncs=50)  # started before the window
    _step(t + 1.0, (t + 1.2, t + 1.3), (t + 1.3, t + 1.5), t + 1.5, kind="mixed",
          lanes_live=30, lanes_run=400, fill_lanes=28, syncs=3)
    _step(t + 1.7, (t + 1.75, t + 1.8), None, t + 1.8, kind="admit", lanes_live=10, lanes_run=100, syncs=1)
    _step(t + 2.0, (t + 2.1, t + 2.4), (t + 2.4, t + 2.5), t + 2.5, kind="decode",
          lanes_live=60, lanes_run=100, syncs=10)
    trace.record("engine.retire", t + 2.5, t + 2.6, syncs=1)
    trace.record("engine.admit", t + 2.6, t + 2.7, syncs=2)
    trace.record("engine.readback", t + 2.7, t + 2.8, syncs=2)  # outside any step: counts
    trace.record("fed.collect", t + 1.0, t + 1.1, syncs=40)  # another thread's reads: not the engine's
    _step(t + 10.0, (t + 10.1, t + 10.2), None, t + 10.3, lanes_live=1, lanes_run=1e6, syncs=99)  # after
    for rid, (sub, first) in enumerate([(2.0, 2.3), (3.0, 3.5), (4.0, 4.1)]):
        attrs = dict(rid=rid, tag=rid, prompt=10, answer=3)
        trace.record("request.queued", t + sub, t + sub + 0.05, **attrs)
        trace.record("request.prefill", t + sub + 0.05, t + first, **attrs)
        trace.record("request.decode", t + first, t + first + 0.5, **attrs)
    trace.record("request.queued", t + 9.9, t + 10.5, rid=9)  # its prefill starts after the window
    trace.record("request.prefill", t + 10.5, t + 10.6, rid=9)
    return _run(t)


def test_lane_share_sums_lanes_over_the_windows_steps(ring_run):
    assert cell.load_reader("live_lane_share.offline")(ring_run) == pytest.approx(100 * 100 / 600)


def test_syncs_count_the_engine_threads_spans_over_its_steps(ring_run):
    # 3 + 1 + 10 in the steps, 1 retire, 2 admit, 2 in the readback outside a step
    assert cell.load_reader("host_syncs_per_step.decode")(ring_run) == pytest.approx(19 / 3)


def test_between_steps_runs_from_the_last_child_to_the_next_launch(ring_run):
    # 1.5 -> 1.75 (an admit step has no readback: its launch's end) and 1.8 -> 2.1
    assert cell.load_reader("between_steps_ms.offline")(ring_run) == pytest.approx(1e3 * (0.25 + 0.3) / 2)


def test_first_token_is_submit_to_first_token(ring_run):
    assert cell.load_reader("first_token_ms.decode")(ring_run) == pytest.approx(300.0)  # median of 300, 500, 100


def test_index_build_reads_set_up_alone(ring_run):
    assert cell.load_reader("index_build_s")(ring_run) == pytest.approx(3.0)


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_an_empty_window_reads_none(quantity):
    assert cell.load_reader(quantity)(_run(-2e6)) is None


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_a_program_without_the_recorder_reads_none(quantity, ring_run, monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.trace", None)
    assert cell.load_reader(quantity)(ring_run) is None


def test_a_shrunk_moe_cell_carries_every_quantity():
    spec = cell.load_spec()
    res = shrink(cell.resolve(spec, "qwen2-moe.mcq-offline"))
    out = cell.execute(res, seed=2**31 + 91, seconds=WINDOW_S, trace=True, device="cpu", log=lambda *a, **k: None)
    line = cell.result_line(spec, res, out, True, "cpu", 1)
    got = {q: line["metrics"][name]["value"] for q in QUANTITIES
           for name in [q if q == "index_build_s" else f"{q}.offline"]}
    assert 0 < got["live_lane_share"] <= 100
    assert got["host_syncs_per_step"] >= res["config"]["generator"]["model"]["n_layers"]  # group sizes, a layer
    assert got["between_steps_ms"] >= 0 and got["first_token_ms"] > 0 and got["index_build_s"] > 0
