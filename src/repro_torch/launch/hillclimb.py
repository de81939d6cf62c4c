"""Hillclimbing on the three selected cells, on the H100 model.

Each iteration is an explicit hypothesis -> change -> re-run -> validate
cycle; every run is a full ``dryrun_cell`` with the lever applied, so the
before/after numbers come from the same measurement as the baseline
table (``launch/dryrun.py``: the port's own step on ``meta`` tensors under
the cost counter).

  cell A  qwen3-4b x decode_32k   (serving path; the paper's F_inf decode)
  cell B  qwen2-moe-a2.7b x train_4k  (most collective-bound: MoE EP; the
          ``a2a`` form and ``capacity_slack`` reach the port's
          expert-parallel forms, ``models/moe.py``)
  cell C  smollm-360m x train_4k  (worst roofline fraction: unshardable TP)

Lever A2 (``decode_donate``) reports no change: the port's decode step
already writes the cache in place, so there is no copy-on-write for
donation to remove.

  python -m repro_torch.launch.hillclimb --cell A --out hillclimb_A.json
"""
import argparse
import json

from repro_torch.launch.dryrun import dryrun_cell

PURE_DP_PATCH = {
    # small models whose heads don't divide TP: use the model axis as extra
    # data parallelism (DDP, replicated weights) instead of wasting it.
    "act_batch": ("data", "model"),
    "embed": None, "heads": None, "kv_heads": None, "mlp": None,
    "vocab": ("data", "model"),
    "act_heads": None, "act_kv_heads": None, "act_ff": None, "act_vocab": None,
    "dt": None, "ssm_heads": None, "experts": None, "expert_in": None,
    "cache_batch": ("data", "model"), "cache_kv": None,
}


def run_cell(tag, **kw):
    r = dryrun_cell(**kw)
    r["tag"] = tag
    keep = (
        "tag arch shape mesh status compute_s memory_s collective_s dominant "
        "step_bound_s useful_flops_frac mfu_bound bytes_raw dus_bytes "
        "hlo_flops hlo_bytes collective_bytes collective_detail".split()
    )
    slim = {k: r.get(k) for k in keep}
    slim["mem_per_dev_gib"] = r["memory_analysis"]["peak_bytes_per_device"] / 2**30 if r["status"] == "ok" else None
    return slim


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, choices=["A", "B", "C"])
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    runs = []

    if args.cell == "A":
        # baseline
        runs.append(run_cell("A0-baseline", arch="qwen3-4b", shape_name="decode_32k", mesh_kind="single"))
        # A1: kv-head replication 8 -> 16 (math-identical weight duplication;
        # hypothesis on the TPU: cache + K/V reads stop being replicated over
        # model=16; the port reads each coordinate's rows with every head, so
        # here it doubles the cache the step reads)
        runs.append(run_cell("A1-kv-replicate-16", arch="qwen3-4b", shape_name="decode_32k",
                             mesh_kind="single", cfg_overrides={"n_kv_heads": 16}))
        # A2: + donate cache (a no-op in the port: the cache is written in place)
        runs.append(run_cell("A2-kv16+donate", arch="qwen3-4b", shape_name="decode_32k",
                             mesh_kind="single", cfg_overrides={"n_kv_heads": 16},
                             decode_donate=True))
    elif args.cell == "B":
        runs.append(run_cell("B0-baseline", arch="qwen2-moe-a2.7b", shape_name="train_4k", mesh_kind="single"))
        # B1: all-to-all EP (hypothesis: psum moves 2xT_loc x d per direction
        # over model; a2a moves only the routed tokens cap*tp*d ~ k*slack/tp
        # of that -> collective term drops several x)
        runs.append(run_cell("B1-a2a-EP", arch="qwen2-moe-a2.7b", shape_name="train_4k",
                             mesh_kind="single", cfg_overrides={"moe_impl": "a2a"}))
        # B2: a2a + tighter capacity (slack 1.5 -> 1.25: buffer + flops trim)
        runs.append(run_cell("B2-a2a+slack1.25", arch="qwen2-moe-a2.7b", shape_name="train_4k",
                             mesh_kind="single",
                             cfg_overrides={"moe_impl": "a2a", "capacity_slack": 1.25}))
    else:
        runs.append(run_cell("C0-baseline", arch="smollm-360m", shape_name="train_4k", mesh_kind="single"))
        # C1: pure-DP resharding (hypothesis: 15 heads / 5 kv can't use TP;
        # batch over (data x model) spreads the batch over all 256
        # coordinates -> compute & memory terms / ~16; grads all-reduce over
        # 256 shards instead of 16 adds collective bytes)
        runs.append(run_cell("C1-pure-DP", arch="smollm-360m", shape_name="train_4k",
                             mesh_kind="single", rules_patch=PURE_DP_PATCH))
    with open(args.out, "w") as f:
        json.dump(runs, f, indent=1, default=str)
    for r in runs:
        if r["status"] != "ok":
            print(r["tag"], r["status"])
            continue
        print(
            f"{r['tag']:22s} compute={r['compute_s']*1e3:9.2f}ms memory={r['memory_s']*1e3:9.2f}ms "
            f"coll={r['collective_s']*1e3:8.2f}ms bound={r['step_bound_s']*1e3:9.2f}ms "
            f"dominant={r['dominant']:10s} mfu={r['mfu_bound']:.4f} mem/dev={r['mem_per_dev_gib']:.1f}GiB"
        )


if __name__ == "__main__":
    main()
