"""A cell, a traffic mix and a per-layer metric added as data alone: new
files and new entries, no file of the benchmark edited, and the cell runs
(on the CPU, cut to smoke size)."""
import hashlib
import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [p for p in (str(BENCH), str(BENCH.parent / "src")) if p not in sys.path]

from fedbench import cell  # noqa: E402
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
        assert res["traffic"]["loop"] == "offline" and res["config"]["name"] == w["config"]
        for trace in (False, True):
            for m in cell.metrics_for(spec, w["name"], trace):
                assert callable(cell.load_reader(m["name"])), m["name"]
        assert {m["name"] for m in cell.metrics_for(spec, w["name"], False)} >= {"setup_s"}
        assert cell.metrics_for(spec, w["name"], True), w["name"]
