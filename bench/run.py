#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for.  The cells, their configurations, traffic mixes, metrics and
correctness limits are found by name from ``BENCHMARK.json`` (see
``bench/fedbench/cell.py``).  Prints the checks on standard error as its
last lines and one JSON object as the last line of standard output; exits
non-zero, with no result, without the cards, without the program
(``src/repro_torch``), or when the run loaded JAX or the JAX package.
"""
import time

T_START = time.monotonic()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(_HERE), str(_HERE.parent / "src")]

from fedbench.cell import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main(t_start=T_START))
