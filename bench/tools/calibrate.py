"""Readings from which a cell's correctness limits are set: the program on
many seeds, and the float8 control on some, in one process.

    python3 bench/tools/calibrate.py --workload <cell> --seeds 1,2,3 --control-seeds 1,2 --seconds 10

Each seed is a whole run of the cell (its window at the cell's own load,
shortened to ``--seconds``; its end-to-end metrics over that window)
followed by the check; on a control seed the
check also reads the same numbers for the reference computed in float8
in the program's place.  Prints one JSON line a seed (``--out`` also
writes them all to that file, as JSON).  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parents[1] / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None, help="also write the readings here, as JSON")
    args = ap.parse_args(argv)

    import torch

    from fedbench import cell

    if not torch.cuda.is_available():
        raise SystemExit("calibration needs a CUDA device")
    spec = cell.load_spec()
    res = cell.resolve(spec, args.workload)
    kind = torch.cuda.get_device_name(0)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.monotonic()
        out = cell.execute(res, seed, args.seconds, False, control=seed in controls)
        row = {"seed": seed, "seconds": time.monotonic() - t, "n_retired": out["n_retired"], "failed": out["n_failed"],
               "checked": out["n_checked"], "peak": out["peak"],
               "metrics": {k: v["value"] for k, v in cell.result_line(spec, res, out, False, kind, 1)["metrics"].items()},
               **out["readings"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            Path(args.out).write_text(json.dumps(rows, indent=1))
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
