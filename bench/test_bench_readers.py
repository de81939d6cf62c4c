"""The readers' arithmetic: rates over the requests retired in the
window, idle from the union of kernel intervals, a range's kernels and
each operation's time, mfu against a hand count, and a split metric read
by its quantity's reader."""
import sys
import types
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [p for p in (str(BENCH), str(BENCH.parent / "src")) if p not in sys.path]

from fedbench import flops, profiling  # noqa: E402
from fedbench.cell import load_reader  # noqa: E402
from fedbench.drive import Record, Span, Window  # noqa: E402
from fedbench.readers import RunData  # noqa: E402

MODEL = {"n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1, "head_dim": 4, "d_ff": 16, "qk_norm": True}


def _run(records, spans=(), counters=None, slice_=None):
    w = Window(10.0, 20.0, list(records), list(spans),
               counters or {"open": {"prefill_tokens": 0, "prefill_saved": 0},
                            "close": {"prefill_tokens": 0, "prefill_saved": 0}})
    return RunData(seconds=10.0, setup_s=3.5, window=w, slice=slice_, model=MODEL)


def _rec(finished, status="done", prompt=10, answer=3):
    return Record(0, "q", answer, finished=finished, status=status,
                  prompt=np.zeros(prompt, np.int32), answer=np.zeros(answer, np.int32))


def test_offline_rate_counts_answers_retired_inside_the_window():
    recs = [_rec(t) for t in (9.9, 10.0, 12.0, 19.99, 20.0)] + [_rec(15.0, status="failed")]
    assert load_reader("requests_per_s")(_run(recs)) == pytest.approx(3 / 10.0)
    assert load_reader("setup_s")(_run(recs)) == 3.5


def test_token_rate_counts_the_answers_retired_inside_the_window():
    recs = [_rec(9.9, answer=100), _rec(10.0, answer=64), _rec(19.0, answer=200), _rec(15.0, "failed", answer=50)]
    assert load_reader("answer_tokens_per_s")(_run(recs)) == pytest.approx((64 + 200) / 10.0)


def test_a_split_metric_is_read_by_its_quantitys_reader(tmp_path):
    spans = [Span("collect", 11.0, 11.5, 4)]
    run = _run([_rec(12.0)], spans)
    assert load_reader("collect_ms.decode")(run) == load_reader("collect_ms")(run) == pytest.approx(125.0)
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "collect_ms.py").write_text("def read(run):\n    return 1.0\n")
    (tmp_path / "metrics" / "collect_ms.other.py").write_text("def read(run):\n    return 2.0\n")
    assert load_reader("collect_ms.new", bench=tmp_path)(run) == 1.0
    assert load_reader("collect_ms.other", bench=tmp_path)(run) == 2.0  # a file of the whole name wins


def test_span_and_counter_readers():
    spans = [Span("collect", 11.0, 11.5, 4), Span("collect", 12.0, 12.1, 2), Span("collect", 21.0, 22.0, 8),
             Span("rerank", 11.5, 11.8, 4)]
    run = _run([_rec(12.0)], spans)
    assert load_reader("collect_ms.offline")(run) == pytest.approx(1e3 * 0.6 / 6)
    assert load_reader("rerank_ms.offline")(run) == pytest.approx(1e3 * 0.3 / 4)


def test_mfu_matches_a_hand_count():
    counters = {"open": {"prefill_tokens": 0, "prefill_saved": 0},
                "close": {"prefill_tokens": 30, "prefill_saved": 10}}
    run = _run([_rec(12.0, prompt=10, answer=3), _rec(13.0, prompt=20, answer=1), _rec(21.0, prompt=5, answer=9)],
               counters=counters)  # the third retired after the window: not counted
    # by hand: attention 2*8*4*(2+2*1) + 2*4*8 + 2*4 (q/k norms); SwiGLU 3*8*16; norms 2*8; final norm 8
    n = 2 * (8 * 4 * 4 + 2 * 4 * 8 + 2 * 4 + 3 * 8 * 16 + 2 * 8) + 8
    assert flops.active_params(MODEL) == n
    per_ctx = 4 * 2 * 4 * 2
    prefill = 20 * (2 * n + per_ctx * 15 / 2)  # 20 computed tokens at the mean context 15 / 2
    decode = 2 * (2 * n) + per_ctx * (11 + 12)  # the first request's 2 decode forwards read 11 and 12 positions
    want = 100 * (prefill + decode) / (989e12 * 10.0)
    assert load_reader("mfu.offline")(run) == pytest.approx(want)


def _ev(name, start, end, dev="CUDA", kernels=(), parent=None, user=None):
    """A profiler event; ``user`` marks a range (``record_function``), on the host and as its device-side
    span, which by default the program's expert loop and the harness's ``bench.*`` spans are."""
    tr = types.SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start)
    if user is None:
        user = name == profiling.LOOP or name.startswith(profiling.SPAN_PREFIX)
    return types.SimpleNamespace(name=name, time_range=tr, device_type=types.SimpleNamespace(name=dev),
                                 kernels=list(kernels), cpu_parent=parent, is_user_annotation=user)


def _kernel(ev):  # a CPU op's kernel, as the profiler lists it there: a name and a duration
    return types.SimpleNamespace(name=ev.name, duration=ev.time_range.elapsed_us())


def test_idle_and_gaps_come_from_kernel_intervals():
    loop = _ev(profiling.LOOP, 0, 1000, dev="CPU")
    k1, k2 = _ev("ampere_bf16_gemm", 100, 300), _ev("void mixed_prefill_kernel<1>", 250, 400)
    k3, k4 = _ev("Memcpy HtoD", 600, 700), _ev("elementwise_add", 900, 1000)
    op = _ev("aten::mm", 90, 95, dev="CPU", kernels=[_kernel(k1)], parent=loop)
    span = _ev("bench.collect", 450, 650, dev="CPU")
    ann = _ev("bench.collect", 100, 700)  # the range's device-side shadow: no operation
    prof = types.SimpleNamespace(events=lambda: [loop, op, span, ann, k1, k2, k3, k4])
    s = profiling.reduce(prof, window_s=2e-3, engine_steps=4)
    assert s.busy_s == pytest.approx((300 + 100 + 100) * 1e-6)  # 100-400, 600-700, 900-1000
    assert s.launches == 4 and s.attn_s == pytest.approx(150e-6) and s.loop_s == pytest.approx(200e-6)
    assert sorted(g[0] for g in s.idle_gaps) == ["bench.collect", "host: no span"]  # 400-600 and 700-900
    assert [g[1] for g in s.idle_gaps] == [pytest.approx(200e-6)] * 2
    run = _run([], slice_=s)
    assert load_reader("device_idle.offline")(run) == pytest.approx(100 * (1 - 500e-6 / 2e-3))
    assert load_reader("launches_per_step.decode")(run) == pytest.approx(1.0)
    assert load_reader("attn_ms_per_step.offline")(run) == pytest.approx(150e-3 / 4)
    assert load_reader("moe_loop_share.offline")(run) == pytest.approx(100 * 200 / 500)


def test_readers_without_a_slice_read_nothing():
    run = _run([])
    for name in ("device_idle.decode", "launches_per_step.offline", "attn_ms_per_step.decode", "moe_loop_share.offline"):
        assert load_reader(name)(run) is None


def test_a_range_is_read_by_the_kernels_launched_under_it():
    disp = _ev("bench.engine_dispatch", 0, 1000, dev="CPU")
    mixer = _ev("mamba2_mixer", 10, 990, dev="CPU", parent=disp, user=True)  # a range a later program opens
    shadow = _ev("mamba2_mixer", 100, 900, user=True)  # its device-side span: no operation
    k1, k2 = _ev("ssd_chunk_kernel", 100, 300), _ev("ssd_chunk_kernel", 500, 600)
    k3, k4 = _ev("nvjet_gemm", 700, 900), _ev("elementwise_add", 950, 1000)
    op = _ev("aten::ssd", 20, 30, dev="CPU", kernels=[_kernel(k1), _kernel(k2)], parent=mixer)
    mixer.kernels = [_kernel(k3)]  # launched straight under the range: a ctypes call opens no op
    after = _ev("aten::add", 992, 995, dev="CPU", kernels=[_kernel(k4)], parent=disp)
    prof = types.SimpleNamespace(events=lambda: [disp, mixer, op, after, shadow, k1, k2, k3, k4])
    s = profiling.reduce(prof, window_s=2e-3, engine_steps=2)
    assert s.launches == 4 and s.busy_s == pytest.approx((200 + 100 + 200 + 50) * 1e-6)  # no shadow in either
    assert s.range_s == {"mamba2_mixer": pytest.approx(500e-6), "bench.engine_dispatch": pytest.approx(550e-6)}
    assert s.op_s == {"ssd_chunk_kernel": pytest.approx(300e-6), "nvjet_gemm": pytest.approx(200e-6),
                      "elementwise_add": pytest.approx(50e-6)}
    assert s.loop_s is None and s.attn_s == 0.0
    assert [o[0] for o in s.device_ops] == ["ssd_chunk_kernel", "nvjet_gemm", "elementwise_add"]
