"""The control of a cell's check: the plain reference put in the
program's place, accumulating in a narrower integer than the
configuration states, judged by the cell's own comparison at the cell's
size (the records one run consumes, spread over the window).  The check
is sound only if the control comes out not correct.

    python3 benchmark/control.py --workload ysb_kf.full \\
        --records 500000000 --seconds 30 --seeds 1 2 3 --acc int16

prints one JSON line a seed and accumulator with the compared numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402
from benchmark.reference import compare  # noqa: E402


class Schedule:
    """The chunks a run of `records` sends over `seconds`, evenly."""

    def __init__(self, records: int, chunk: int, seconds: float):
        n = max(1, -(-records // chunk))
        self.due = [c * seconds / n for c in range(n)]


def delivered(index, values):
    """(key, window, values) of a program that delivers every due result
    once, in per-key order, with `values`."""
    key, wid = np.nonzero(index >= 0)
    return key, wid, values[index[key, wid]]


def readings(cell, seed, records, seconds, acc):
    system = cell.system(seed, "cpu")
    paced = Schedule(records, cell.mix["chunk"], seconds)
    index, want = system.expected(paced)
    c_index, c_vals = system.expected(paced, acc=acc)
    return compare.compare(*delivered(c_index, c_vals), index, want)


def main(argv=None):
    ap = argparse.ArgumentParser(description="the cell check's control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--records", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--acc", nargs="+", default=["int16"])
    a = ap.parse_args(argv)
    cell = harness.Cell(a.workload, harness.load_json(os.getcwd(),
                                                      "BENCHMARK.json"))
    for seed in a.seeds:
        for acc in a.acc:
            r = readings(cell, seed, a.records, a.seconds, getattr(np, acc))
            print(json.dumps({"workload": a.workload, "seed": seed,
                              "acc": acc, "correct": compare.passed(r),
                              **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
