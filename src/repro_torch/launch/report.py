"""Render the dry-run / roofline tables from ``launch/dryrun.py``'s JSON
(the reference's report on the H100 model: the fit column is one card's
80 GiB).

  python -m repro_torch.launch.report results/dryrun.json --section roofline
"""
from __future__ import annotations

import argparse
import json


def fmt_s(x):
    if x is None:
        return "-"
    if x >= 1.0:
        return f"{x:.2f}s"
    return f"{x*1e3:.2f}ms"


def fmt_b(x):
    for unit, f in (("PB", 2**50), ("TB", 2**40), ("GB", 2**30), ("MB", 2**20)):
        if x >= f:
            return f"{x/f:.2f}{unit}"
    return f"{x:.0f}B"


def roofline_table(results, mesh="single"):
    rows = [r for r in results if r.get("mesh") == mesh and r["status"] == "ok"]
    out = [
        "| arch | shape | compute | memory | collective | dominant | bound | "
        "MODEL_FLOPs/HLO | mfu_bound | mem/dev | one-line fix |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        fix = suggest_fix(r)
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} "
            f"| {fmt_s(r['collective_s'])} | **{r['dominant']}** | {fmt_s(r['step_bound_s'])} "
            f"| {r['useful_flops_frac']:.2f} | {r['mfu_bound']:.3f} "
            f"| {fmt_b(r['memory_analysis']['peak_bytes_per_device'])} | {fix} |"
        )
    return "\n".join(out)


def suggest_fix(r) -> str:
    d = r["dominant"]
    if d == "memory":
        return "fuse attention/SSD softmax chain into a hand-written CUDA kernel (on-chip resident)"
    if d == "collective":
        det = r.get("collective_detail", {})
        big = max((k for k in det if k != "collective_count"), key=lambda k: det[k], default="all-reduce")
        return f"cut {big} bytes: bf16 collectives / a2a EP / kv-replicated TP"
    return "increase per-chip work (larger per-device batch) or reduce redundant compute"


def skip_table(results):
    rows = [r for r in results if r["status"] == "skip" and r["mesh"] == "single"]
    out = ["| arch | shape | reason |", "|---|---|---|"]
    for r in rows:
        out.append(f"| {r['arch']} | {r['shape']} | {r['reason']} |")
    return "\n".join(out)


def dryrun_table(results):
    out = [
        "| arch | shape | mesh | compile | peak mem/device | fits 80G H100 |",
        "|---|---|---|---|---|---|",
    ]
    for r in results:
        if r["status"] != "ok":
            continue
        mem = r["memory_analysis"]["peak_bytes_per_device"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['compile_s']:.1f}s "
            f"| {fmt_b(mem)} | {'yes' if mem < 80*2**30 else 'NO'} |"
        )
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("json")
    ap.add_argument("--section", default="roofline", choices=["roofline", "dryrun", "skips"])
    args = ap.parse_args()
    results = json.load(open(args.json))
    if args.section == "roofline":
        print(roofline_table(results))
    elif args.section == "dryrun":
        print(dryrun_table(results))
    else:
        print(skip_table(results))


if __name__ == "__main__":
    main()
