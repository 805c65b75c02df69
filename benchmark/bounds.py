"""The ring kernel's least times: bytes and operations from a launch's
shapes, over the card's published peaks.

Frozen copies of ``chip_smoke.py``'s ``append_eval_bound`` and
``covered_outside`` (``ring_append_eval``), rewritten over host arrays so
that a launch is costed from its descriptors after the run.  Each input
byte is counted once and each output byte once.
"""

from __future__ import annotations

import numpy as np

#: one NVIDIA H100 SXM (data sheet, 700 W): HBM3 bytes/s, float32 ops/s
#: outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def least_s(nbytes: float, ops: float) -> float:
    """The least time of a launch: its bytes or its operations at peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def covered_outside(rows, starts, lens, pad, cap, offs, Rb):
    """Ring cells the windows read outside the rectangle, each counted
    once (a column past the row's end reads its last cell)."""
    rows = np.asarray(rows, np.int64)
    s = np.maximum(np.asarray(starts, np.int64), 0)
    n = np.clip(np.asarray(lens, np.int64), 0, int(pad))
    lo = np.minimum(s, cap - 1)
    hi = np.where(n > 0, np.maximum(np.minimum(s + n, cap), lo + 1), lo)
    offs = np.asarray(offs, np.int64)
    total = 0
    for r in np.unique(rows[n > 0]):
        sel = (rows == r) & (n > 0)
        a, b = lo[sel], hi[sel]
        order = np.argsort(a)
        o0, o1 = max(int(offs[r]), 0), min(int(offs[r]) + Rb, cap)
        end = -1
        for x, y in zip(a[order], b[order]):
            x = max(int(x), end)
            if y > x:
                total += (y - x) - max(0, min(y, o1) - max(x, o0))
                end = int(y)
    return int(total)


def append_eval(KP, cap, ring_size, Rb, blk_size, offs, ops, rows, starts,
                lens, pad):
    """(bytes, operations) of one ``ring_append_eval`` launch: the
    rectangle read and written once, the offsets and the (row, start,
    len) descriptors, the ring cells the windows read outside the
    rectangle once, one output a window and op; one combine a cell and
    value op."""
    B = len(starts)
    cells = covered_outside(rows, starts, lens, pad, cap, offs, Rb)
    nbytes = (KP * Rb * (blk_size + ring_size) + 4 * KP
              + ring_size * cells + 12 * B + ring_size * B * len(ops))
    n_ops = (sum(op != "count" for op in ops)
             * int(np.clip(np.asarray(lens, np.int64), 0, pad).sum()))
    return nbytes, n_ops
