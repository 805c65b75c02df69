"""Per-key stream archive: ordered buffer of in-flight tuples.

Equivalent of the reference ``stream_archive.hpp`` (binary-search insert,
range query, purge) redesigned for batch appends: streams arrive as sorted
chunks, so the common case is an O(chunk) tail append into a contiguous
growable buffer, keeping the window content contiguous for device staging
(the property the reference's GPU path gets from its vector-backed archive,
``win_seq_gpu.hpp:96``).  Purge advances a start offset instead of erasing
(compaction is amortised).
"""

from __future__ import annotations

import numpy as np


class KeyArchive:
    """Ordered (by `pos_field`) buffer of tuples for one key."""

    __slots__ = ("pos_field", "_buf", "_start", "_end")

    def __init__(self, dtype: np.dtype, pos_field: str, capacity: int = 64):
        self.pos_field = pos_field
        self._buf = np.empty(capacity, dtype=dtype)
        self._start = 0
        self._end = 0

    def __len__(self):
        return self._end - self._start

    @property
    def rows(self) -> np.ndarray:
        """Live contents, ordered by pos (view, do not mutate)."""
        return self._buf[self._start:self._end]

    @property
    def positions(self) -> np.ndarray:
        return self._buf[self.pos_field][self._start:self._end]

    def _reserve(self, extra: int):
        n = len(self)
        if self._end + extra <= len(self._buf):
            return
        cap = max(len(self._buf) * 2, n + extra, 64)
        newbuf = np.empty(cap, dtype=self._buf.dtype)
        newbuf[:n] = self._buf[self._start:self._end]
        self._buf = newbuf
        self._start, self._end = 0, n

    def append(self, rows: np.ndarray):
        """Append a chunk already sorted by pos, all >= current max pos
        (the in-order fast path; out-of-order rows were dropped upstream)."""
        if len(rows) == 0:
            return
        self._reserve(len(rows))
        self._buf[self._end:self._end + len(rows)] = rows
        self._end += len(rows)

    def insert_sorted(self, rows: np.ndarray):
        """General insert preserving order (used for equal-pos duplicates
        arriving interleaved); O(n + chunk)."""
        if len(rows) == 0:
            return
        live = self.rows
        merged = np.concatenate([live, rows])
        order = np.argsort(merged[self.pos_field], kind="stable")
        merged = merged[order]
        self._buf = merged
        self._start, self._end = 0, len(merged)

    def lower_bound(self, pos: int) -> int:
        """Index (relative to .rows) of the first row with pos >= `pos`."""
        return int(np.searchsorted(self.positions, pos, side="left"))

    def range(self, lo_pos: int, hi_pos: int) -> np.ndarray:
        """Rows with pos in [lo_pos, hi_pos) — one window's content
        (reference stream_archive.hpp:104)."""
        p = self.positions
        lo = np.searchsorted(p, lo_pos, side="left")
        hi = np.searchsorted(p, hi_pos, side="left")
        return self.rows[lo:hi]

    def tail_from(self, lo_pos: int) -> np.ndarray:
        """Rows with pos >= lo_pos (EOS flush range, win_seq.hpp:452)."""
        lo = np.searchsorted(self.positions, lo_pos, side="left")
        return self.rows[lo:]

    def purge_below(self, pos: int):
        """Drop rows with pos < `pos` (reference stream_archive.hpp:71)."""
        self._start += self.lower_bound(pos)
        # amortised compaction so the buffer doesn't grow without bound
        if self._start > 4096 and self._start > (self._end - self._start):
            n = len(self)
            self._buf[:n] = self._buf[self._start:self._end]
            self._start, self._end = 0, n
