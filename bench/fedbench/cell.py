"""One run of one cell, and its result line.

Everything a cell is made of is found by name, from ``BENCHMARK.json``
at the root of the checkout: the workload names a configuration (whose
entry names its file under ``bench/configs/``) and a traffic mix
(``bench/traffic/<traffic>.json``); the correctness limits are
``bench/limits/<workload>.json``, whose keys are the numbers the cell
compares; each metric is read by
``bench/metrics/<metric>.py``, or, for a metric ``<quantity>.<split>``
without a file of its own, by ``bench/metrics/<quantity>.py``.  The
configuration's ``generator`` block may name the generator's own plain
reference (``"reference"``, a file under ``bench/reference/`` with
``decoder_logits(cfg, params, tokens, n_last, prec)``; ``models.py`` when
absent) and FLOP count (``"flops"``, a file under ``bench/fedbench/`` with
``prefill_flops`` and ``decode_flops``; ``flops.py`` when absent), and
its CPU tests' cut (``"smoke"``, see ``testing.py``).  A later cell,
configuration, architecture, mix or metric adds files and entries and
edits none.

A run: the corpus, the questions and the schedule from the seed; the
system with weights made on the card from the seed; a warm-up through
the whole path (and the prefix cache emptied after it); the window;
then, with the program's state freed, the check against the reference
on a sample of what the window finished.
"""
from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path

import numpy as np

from fedbench import load_file
from fedbench.check import NAMES

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")  # top-level module names, compared whole
KERNELS = ["retrieval_topk", "flash_attention", "mixed_prefill", "paged_decode"]


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def generator_files(config: dict, bench: Path = BENCH) -> dict:
    """The files that reference and count a configuration's generator."""
    g = config["generator"]
    return {"reference": bench / "reference" / g.get("reference", "models.py"),
            "flops": bench / "fedbench" / g.get("flops", "flops.py")}


def resolve(spec: dict, workload: str, bench: Path = BENCH) -> dict:
    """The workload's entry with its configuration, traffic and limits read,
    and its generator's reference and FLOP files found."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = json.loads((bench.parent / conf["file"]).read_text())
    limits = bench / "limits" / f"{workload}.json"
    return {
        "cell": cell,
        "config": config,
        "traffic": json.loads((bench / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads(limits.read_text()) if limits.exists() else None,
        **generator_files(config, bench),
    }


def metrics_for(spec: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics this cell reports: its end-to-end ones untraced, its
    per-layer ones traced (a metric without ``workloads`` goes wherever the
    end-to-end metric it moves is reported)."""
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]


def load_reader(name: str, bench: Path = BENCH):
    """The metric's reader: its own file, else its quantity's (the name up
    to the first dot)."""
    path = bench / "metrics" / f"{name}.py"
    if not path.exists():
        path = bench / "metrics" / f"{name.split('.')[0]}.py"
    return load_file(path, f"bench_metric_{name.replace('.', '_')}").read


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def warm_up(built, corpus, seed: int, traffic: dict) -> None:
    """Every shape the window uses, once: a full collect batch through
    retrieval, the rerank and the prompt, then the engine's mixed and
    fused decode steps; the prefix cache is emptied after."""
    from fedbench.traffic import rng

    g = rng(seed, "warm-up")
    texts = [" ".join(np.asarray(corpus.pool, dtype=object)[g.integers(0, len(corpus.pool), 20)])
             for _ in range(int(traffic["collect_batch"]))]
    built.system.serve(texts, max_new_tokens=4)
    built.engine.reset_cache()


def execute(resolved: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
            control: bool = False, t_start: float | None = None, log=print) -> dict:
    """One run; returns the window, the readings and what the result line needs."""
    import torch

    from fedbench import check as C
    from fedbench import drive, profiling, system
    from fedbench.readers import RunData, window_requests
    from fedbench.traffic import make_corpus, make_schedule
    from reference.models import no_tf32

    t_start = time.monotonic() if t_start is None else t_start
    cfg, traffic = resolved["config"], resolved["traffic"]
    torch.set_num_threads(4)
    build_s = None
    if device == "cuda":
        from repro_torch.kernels import _build

        t = time.monotonic()
        _build.build_all(KERNELS)
        build_s = time.monotonic() - t
    corpus = make_corpus(cfg["corpus"], seed)
    schedule = make_schedule(traffic, corpus, seed)
    built = system.build(cfg, corpus, seed, device)
    warm_up(built, corpus, seed, traffic)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    slicer = profiling.Slicer(built.engine) if trace else None
    window = drive.run_offline(built, schedule, traffic, seconds, trace, slicer)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    sl = None
    if slicer is not None:
        sl = slicer.result()
        slicer.engine = slicer.prof = None
    found = forbidden_modules()
    data = RunData(seconds=seconds, setup_s=window.t_open - t_start, window=window, slice=sl,
                   model=cfg["generator"]["model"], flops=load_file(resolved["flops"], "bench_flops"))
    retired = window_requests(data)
    # the program's state goes before the reference runs: the weights stay,
    # the reference reads them
    weights, models = built.weights, built.models
    del built
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    no_tf32()
    t = time.monotonic()
    ref = C.Reference(cfg, corpus, weights, models, device, resolved["reference"])
    chk = traffic["check"]
    picked, checked = C.sample(retired, seed, chk["answer_tokens"], chk["min_answers"], chk["requests"])
    readings = C.check(ref, schedule, picked, checked, control=control)
    log(f"check: {len(picked)} answers ({sum(len(r.answer) for r in picked)} tokens), "
        f"{len(checked)} retrievals in {time.monotonic() - t:.1f} s", file=sys.stderr)
    return {"data": data, "readings": readings, "peak": peak, "forbidden": found, "build_s": build_s,
            "n_retired": len(retired), "n_failed": sum(r.status != "done" for r in retired),
            "n_checked": (len(picked), len(checked))}


def result_line(spec: dict, resolved: dict, out: dict, trace: bool, device_kind: str, count: int,
                bench: Path = BENCH) -> dict:
    workload = resolved["cell"]["name"]
    data = out["data"]
    metrics = {}
    for m in metrics_for(spec, workload, trace):
        v = load_reader(m["name"], bench)(data)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    limits = resolved["limits"] or {}  # the numbers this cell compares, each with its limit
    readings = out["readings"]["program"]
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in NAMES if k in limits}
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values()) and out["n_checked"][0] > 0
    dev = {"platform": "gpu", "kind": device_kind, "count": count, "memory_peak_bytes": int(out["peak"])}
    line = {"correct": correct, "attempted": out["n_retired"], "failed": out["n_failed"], "metrics": metrics,
            "device": dev}
    if trace and data.slice is not None:
        dev["busy_s"], dev["window_s"] = data.slice.busy_s, data.slice.window_s
        line["breakdown"] = {"device_ops": data.slice.device_ops, "idle_gaps": data.slice.idle_gaps}
    line["checks"] = checks
    return line


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec()
    resolved = resolve(spec, args.workload)
    chips = int(resolved["cell"]["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = execute(resolved, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    if out["forbidden"]:
        print(f"the run loaded {out['forbidden']}: the benchmark measures the PyTorch port alone",
              file=sys.stderr)
        return 3
    if out["build_s"] is not None:
        print(f"kernel build (a checkout's first run builds, later ones load; counted in setup_s): "
              f"{out['build_s']:.3f} s", file=sys.stderr)
    line = result_line(spec, resolved, out, bool(args.trace), torch.cuda.get_device_name(0), chips)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0
