"""The comparison that decides ``correct``: every expected window result
delivered exactly once, in per-key order, with the expected values.

Each number is a count of faults and its limit is 0: the guarantees of
both deployments are exact (integer results, exactly-once delivery,
per-key order).
"""

from __future__ import annotations

import numpy as np

#: the numbers compared, each with its limit
LIMITS = {"missing": 0, "extra": 0, "out_of_order": 0, "wrong": 0}


def compare(key, wid, vals, index, expected):
    """Fault counts of delivered results against the expected ones.

    key, wid: (n,) integer arrays of the delivered results in arrival
    order; vals: (n, f) their values.  index: (n_keys, n_windows) int64,
    the row of `expected` ((m, f)) that result (key, window) must equal,
    or -1 where no result is due.  Returns {"missing", "extra",
    "out_of_order", "wrong"} (results that never came; results not due,
    or due and delivered again; results of a key that came after a later
    window of that key; results whose values differ), "results" (n) and
    "expected" (m)."""
    key = np.asarray(key, dtype=np.int64)
    wid = np.asarray(wid, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.int64).reshape(len(key), -1)
    expected = np.asarray(expected, dtype=np.int64).reshape(
        len(expected), -1)
    n_keys, n_win = index.shape
    inside = (key >= 0) & (key < n_keys) & (wid >= 0) & (wid < n_win)
    row = np.full(len(key), -1, dtype=np.int64)
    row[inside] = index[key[inside], wid[inside]]
    due = row >= 0
    counts = np.bincount(row[due], minlength=len(expected))
    order = np.argsort(key, kind="stable")
    k, w = key[order], wid[order]
    same = k[1:] == k[:-1]
    return {"missing": int((counts == 0).sum()),
            "extra": int((~due).sum() + (counts[counts > 1] - 1).sum()),
            "out_of_order": int((same & (w[1:] <= w[:-1])).sum()),
            "wrong": int((vals[due] != expected[row[due]]).any(axis=1).sum()),
            "results": int(len(key)), "expected": int(len(expected))}


def passed(readings) -> bool:
    return all(readings[name] <= limit for name, limit in LIMITS.items())
