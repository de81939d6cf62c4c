"""A cell, a traffic mix, a per-layer metric and an architecture added as
data alone: new files and new entries, no file of the benchmark edited,
and the cell runs (on the CPU, cut to smoke size).  The architecture
brings its own reference, FLOP count and smoke cut, and a metric that
reads a profiler range's kernels and each device operation's time."""
import dataclasses
import hashlib
import json
import shutil
import sys
import types
from pathlib import Path

import pytest

pytest.importorskip("torch")

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [p for p in (str(BENCH), str(BENCH.parent / "src")) if p not in sys.path]

from fedbench import cell, flops, load_file, profiling, readers  # noqa: E402
from fedbench.testing import WINDOW_S, shrink  # noqa: E402

def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_cell_added_from_data_runs(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    before = _digests(bench)

    mix = json.loads((bench / "traffic" / "mcq-offline.json").read_text())
    mix.update(who="a later cell", collect_batch=4, answer_tokens={"dist": "fixed", "tokens": 3})
    (bench / "traffic" / "mcq-short-offline.json").write_text(json.dumps(mix))
    (bench / "limits" / "qwen3-4b.mcq-short-offline.json").write_text(
        json.dumps({k: 1e6 for k in cell.NAMES}))
    (bench / "metrics" / "answer_tokens.new.py").write_text(
        "def read(run):\n    return float(sum(len(r.answer) for r in run.window.records if r.answer is not None))\n")
    spec["workloads"].append({"name": "qwen3-4b.mcq-short-offline", "config": "medrag-qwen3-4b",
                              "traffic": "mcq-short-offline", "chips": 1, "why": "a test"})
    next(m for m in spec["end_to_end"] if m["name"] == "requests_per_s")["workloads"].append(
        "qwen3-4b.mcq-short-offline")
    spec["per_layer"].append({"name": "answer_tokens.new", "unit": "tokens", "better": "higher",
                              "source": "program_counter", "layer": "engine", "moves": "requests_per_s",
                              "workloads": ["qwen3-4b.mcq-short-offline"]})
    spec["per_layer"].append({"name": "collect_ms.short", "unit": "ms", "better": "lower",
                              "source": "host_clock", "layer": "federation", "moves": "requests_per_s",
                              "workloads": ["qwen3-4b.mcq-short-offline"]})  # read by collect_ms.py
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before  # nothing edited, only added
    res = shrink(cell.resolve(cell.load_spec(root), "qwen3-4b.mcq-short-offline", bench=bench))
    assert res["traffic"]["collect_batch"] == 4
    out = cell.execute(res, seed=2**31 + 77, seconds=WINDOW_S, trace=True, device="cpu", log=lambda *a, **k: None)
    line = cell.result_line(spec, res, out, True, "cpu", 1, bench=bench)
    assert line["metrics"]["answer_tokens.new"]["value"] == 3 * 16  # every answer of the batch, 3 tokens each
    assert line["metrics"]["collect_ms.short"]["value"] > 0
    assert set(line["metrics"]) == {"answer_tokens.new", "collect_ms.short"}  # the per-layer metrics listed
    assert line["correct"] is True and line["attempted"] == 16 and list(line)[-1] == "checks"
    untraced = cell.result_line(spec, res, out, False, "cpu", 1, bench=bench)
    assert set(untraced["metrics"]) == {"requests_per_s", "setup_s"}


def test_every_entry_of_the_benchmark_resolves():
    spec = cell.load_spec()
    for w in spec["workloads"]:
        res = cell.resolve(spec, w["name"])
        assert res["limits"] and set(res["limits"]) <= set(cell.NAMES), w["name"]
        assert res["reference"].is_file() and res["flops"].is_file(), w["name"]
        assert res["traffic"]["loop"] == "offline" and res["config"]["name"] == w["config"]
        for trace in (False, True):
            for m in cell.metrics_for(spec, w["name"], trace):
                assert callable(cell.load_reader(m["name"])), m["name"]
        assert {m["name"] for m in cell.metrics_for(spec, w["name"], False)} >= {"setup_s"}
        assert cell.metrics_for(spec, w["name"], True), w["name"]


ARCH, ARCH_CELL, RANGE = "medrag-later-arch", "later-arch.mcq-offline", "later_mixer"
FILES = {
    "reference/later_arch.py": '''"""A later architecture's plain reference: here the Qwen3 decoder's."""
from reference import models


def decoder_logits(cfg, params, tokens, n_last, prec):
    return models.decoder_logits(cfg, params, tokens, n_last, prec)
''',
    "reference/later_arch_shifted.py": '''"""A wrong reference: each served token it is handed lies 1.0 below the
best other logit of its position."""
import torch

from reference import models


def decoder_logits(cfg, params, tokens, n_last, prec):
    lg = models.decoder_logits(cfg, params, tokens, n_last, prec)
    rows = torch.arange(n_last - 1, device=lg.device)
    served = tokens[tokens.shape[0] - n_last + 1 :].long()  # the answer's tokens but its last
    top2 = lg[:-1].topk(2, dim=-1).values
    other = torch.where(top2[:, 0] == lg[rows, served], top2[:, 1], top2[:, 0])
    lg[rows, served] = other - 1.0
    return lg
''',
    "fedbench/flops_later_arch.py": '''"""A later architecture's FLOP count: flops.py's, with a state update of
8 d_model^2 a token in every layer beside it, which the context does not grow."""
from fedbench import flops


def per_token(m):
    return 2 * flops.active_params(m) + 8 * m["d_model"] ** 2 * m["n_layers"]


def prefill_flops(m, tokens, mean_context):
    return flops.prefill(per_token(m), flops.attn_flops_per_context(m), tokens, mean_context)


def decode_flops(m, prompt_len, n_tokens):
    return flops.decode(per_token(m), flops.attn_flops_per_context(m), prompt_len, n_tokens)
''',
    "metrics/mixer_share.py": f'''"""Mixer: device time of the kernels launched under the {RANGE} range over
every device operation's, in the slice, in %."""
from fedbench.readers import sliced


def read(run):
    return sliced(run, lambda s: 100.0 * s.range_s["{RANGE}"] / sum(s.op_s.values())
                  if "{RANGE}" in s.range_s and s.op_s else None)
''',
}


def _ev(name, start, end, dev="CUDA", kernels=(), parent=None, user=False):
    tr = types.SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start)
    return types.SimpleNamespace(name=name, time_range=tr, device_type=types.SimpleNamespace(name=dev),
                                 kernels=list(kernels), cpu_parent=parent, is_user_annotation=user)


class _Profile:
    """``torch.profiler.profile`` on a card, as far as the slice reads it: the
    mixer's range over one kernel of 300 us, and a kernel of 200 us outside it."""

    def __init__(self, activities):
        mixer = _ev(RANGE, 0, 400, dev="CPU", user=True)
        shadow, k1, k2 = _ev(RANGE, 100, 400, user=True), _ev("ssd_kernel", 100, 400), _ev("gemm", 500, 700)
        op = _ev("aten::ssd", 10, 20, dev="CPU", parent=mixer,
                 kernels=[types.SimpleNamespace(name=k1.name, duration=300)])
        gemm = _ev("aten::mm", 450, 460, dev="CPU", kernels=[types.SimpleNamespace(name=k2.name, duration=200)])
        self._events = [mixer, op, gemm, shadow, k1, k2]

    def start(self):
        pass

    def stop(self):
        pass

    def events(self):
        return self._events


def _add_architecture(root: Path, spec: dict) -> dict:
    """The architecture's files and entries: a configuration that names its
    reference, FLOP file and smoke cut, a cell with its limits, a metric."""
    bench = root / "bench"
    for rel, text in FILES.items():
        (bench / rel).write_text(text)
    conf = json.loads((bench / "configs" / "medrag-qwen3-4b.json").read_text())
    conf["name"] = ARCH
    conf["generator"].update(reference="later_arch.py", flops="flops_later_arch.py", smoke={"n_layers": 3})
    (bench / "configs" / f"{ARCH}.json").write_text(json.dumps(conf))
    # the numbers the generator's reference decides, at the qwen3 cells' limits
    (bench / "limits" / f"{ARCH_CELL}.json").write_text(json.dumps({"prompt_mismatch": 0, "answer_gap": 0.3}))
    spec["configs"].append({"name": ARCH, "source": "https://example.org/later-arch", "file": f"bench/configs/{ARCH}.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": ARCH_CELL, "config": ARCH, "traffic": "mcq-offline", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("requests_per_s", "mfu.offline"):
            m["workloads"].append(ARCH_CELL)
    spec["per_layer"].append({"name": "mixer_share.offline", "unit": "%", "better": "lower", "source": "device_trace",
                              "layer": "kernels", "moves": "requests_per_s", "workloads": [ARCH_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return conf


def test_an_architecture_added_from_files_runs(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    bench = root / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    before = _digests(bench)
    conf = _add_architecture(root, spec)
    assert {k: v for k, v in _digests(bench).items() if k in before} == before  # nothing edited, only added

    res = shrink(cell.resolve(cell.load_spec(root), ARCH_CELL, bench=bench))
    assert res["config"]["generator"]["model"]["n_layers"] == 3  # the configuration's own smoke cut
    assert res["reference"] == bench / "reference" / "later_arch.py"
    monkeypatch.setattr(profiling, "SLICE_AT", 0.0)
    monkeypatch.setattr(profiling.torch.profiler, "profile", _Profile)
    out = cell.execute(res, seed=2**31 + 29, seconds=WINDOW_S, trace=True, device="cpu", log=lambda *a, **k: None)
    line = cell.result_line(spec, res, out, True, "cpu", 1, bench=bench)
    assert line["correct"] is True, line["checks"]
    own = load_file(bench / "fedbench" / "flops_later_arch.py", "test_flops_later_arch")
    want = readers.mfu_percent(dataclasses.replace(out["data"], flops=own))
    assert line["metrics"]["mfu.offline"]["value"] == want > readers.mfu_percent(
        dataclasses.replace(out["data"], flops=flops)) > 0  # the architecture's count, not flops.py's
    assert line["metrics"]["mixer_share.offline"]["value"] == pytest.approx(100 * 300 / 500)

    conf["generator"]["reference"] = "later_arch_shifted.py"
    (bench / "configs" / f"{ARCH}.json").write_text(json.dumps(conf))
    res = shrink(cell.resolve(cell.load_spec(root), ARCH_CELL, bench=bench))
    out = cell.execute(res, seed=2**31 + 29, seconds=WINDOW_S, trace=False, device="cpu", log=lambda *a, **k: None)
    line = cell.result_line(spec, res, out, False, "cpu", 1, bench=bench)
    assert line["correct"] is False and line["checks"]["answer_gap"]["value"] == pytest.approx(1.0), line["checks"]
