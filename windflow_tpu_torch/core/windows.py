"""Window model: count/time windows, triggerer math, farm distribution math.

Re-derivation of the reference's window engine (reference ``window.hpp`` and
``basic.hpp:136``) in closed form so that it vectorises:

* Count-based (CB) window ``wid`` over a keyed substream whose first id is
  ``initial_id`` covers ids ``[initial_id + wid*slide, initial_id + wid*slide
  + win_len)`` and FIRES on the first id ``>= initial_id + wid*slide +
  win_len`` (reference ``window.hpp:63-66``).
* Time-based (TB) window ``wid`` covers ts ``[initial_ts + wid*slide,
  initial_ts + wid*slide + win_len)`` and fires on the first ts ``>=
  initial_ts + wid*slide + win_len`` (reference ``window.hpp:84-87``).

Instead of keeping one heap-allocated ``Window`` object with a closure per
open window, we keep *arithmetic*: for an in-order substream the set of open /
fired / created windows is a pure function of (next_lwid, max id seen), which
is what lets the bookkeeping run as array ops over whole batches.

``PatternConfig`` carries the two-level farm-distribution parameters
(outer x inner nesting) exactly as the reference does (``basic.hpp:136``,
consumed at ``win_seq.hpp:307-314``).
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass

import numpy as np


class WinType(enum.Enum):
    CB = "count"  # count-based: windows defined over tuple ids
    TB = "time"   # time-based: windows defined over tuple timestamps


class Role(enum.Enum):
    """Role of a window core inside a composed pattern (basic.hpp:84)."""

    SEQ = "seq"        # standalone sequential core
    PLQ = "plq"        # pane-level query stage of Pane_Farm
    WLQ = "wlq"        # window-level query stage of Pane_Farm
    MAP = "map"        # map stage of Win_MapReduce
    REDUCE = "reduce"  # reduce stage of Win_MapReduce


class OptLevel(enum.IntEnum):
    """Graph-optimisation level (basic.hpp:94). In this framework the
    runtime fuses nodes dynamically, so levels only gate fusion choices."""

    LEVEL0 = 0
    LEVEL1 = 1
    LEVEL2 = 2


@dataclass(frozen=True)
class PatternConfig:
    """Two-level distribution parameters for nested farm workers.

    ``id_outer/n_outer/slide_outer`` describe this worker's position in the
    outer farm, ``id_inner/n_inner/slide_inner`` in the inner pattern
    (reference basic.hpp:136-160).  A plain Win_Seq uses (0,1,slide,0,1,slide).
    """

    id_outer: int = 0
    n_outer: int = 1
    slide_outer: int = 0
    id_inner: int = 0
    n_inner: int = 1
    slide_inner: int = 0

    @staticmethod
    def plain(slide_len: int) -> "PatternConfig":
        return PatternConfig(0, 1, slide_len, 0, 1, slide_len)

    def first_gwid(self, key: int) -> int:
        """gwid of the first window of `key` assigned to this worker
        (win_seq.hpp:307)."""
        no, ni = self.n_outer, self.n_inner
        a = (self.id_inner - (key % ni) + ni) % ni
        b = (self.id_outer - (key % no) + no) % no
        return a * no + b

    def initial_id(self, key: int, role: Role) -> int:
        """First id/ts of the keyed substream reaching this worker
        (win_seq.hpp:309-314)."""
        no, ni = self.n_outer, self.n_inner
        initial_outer = ((self.id_outer - (key % no) + no) % no) * self.slide_outer
        initial_inner = ((self.id_inner - (key % ni) + ni) % ni) * self.slide_inner
        if role in (Role.WLQ, Role.REDUCE):
            return initial_inner
        return initial_outer + initial_inner

    def gwid_stride(self) -> int:
        """gwids assigned to one worker advance by n_outer*n_inner
        (win_seq.hpp:346)."""
        return self.n_outer * self.n_inner


@dataclass(frozen=True)
class WindowSpec:
    """A sliding/tumbling/hopping window definition."""

    win_len: int
    slide_len: int
    win_type: WinType

    def __post_init__(self):
        if self.win_len <= 0 or self.slide_len <= 0:
            raise ValueError("window length and slide must be positive")

    @property
    def is_tumbling(self) -> bool:
        return self.win_len == self.slide_len

    @property
    def is_hopping(self) -> bool:
        return self.slide_len > self.win_len

    def pane_len(self) -> int:
        """Pane decomposition length: gcd(win, slide) (pane_farm.hpp:148)."""
        return math.gcd(self.win_len, self.slide_len)

    # ---- closed-form window arithmetic (all positions relative to
    # ---- initial_id of the substream; works elementwise on numpy arrays) ----

    def _div_slide(self, x):
        """Floor-divide by slide_len; a power-of-two slide rides an
        arithmetic right shift (floor semantics for negatives too) —
        int64 division was the WF emitter's second-largest per-batch cost
        (~19 ms/M rows vs ~2 ms shifted)."""
        s = int(self.slide_len)   # numpy-int slide_lens lack bit_length
        if s & (s - 1) == 0:
            return x >> (s.bit_length() - 1)
        return x // s

    def last_win_containing(self, pos):
        """Local id of the last window containing position `pos` (>=0).

        Sliding/tumbling: ceil((pos+1)/slide) - 1  (win_seq.hpp:324)
        Hopping:          floor(pos/slide)         (win_seq.hpp:327)
        """
        pos = np.asarray(pos, dtype=np.int64)
        if self.is_hopping:
            return self._div_slide(pos)
        return np.maximum(self._div_slide(pos + self.slide_len) - 1, -1)

    def first_win_containing(self, pos):
        """Local id of the first window containing `pos`, i.e.
        max(0, ceil((pos - win + 1)/slide)) for sliding (wf_nodes.hpp:138-144);
        for hopping the only candidate is floor(pos/slide)."""
        pos = np.asarray(pos, dtype=np.int64)
        if self.is_hopping:
            return self._div_slide(pos)
        # floor division handles the pos < win_len operand range (the
        # quotient is <= 0 exactly there), so clamping replaces the
        # two-branch where — one fewer full-array pass
        return np.maximum(
            self._div_slide(pos - self.win_len + self.slide_len),
            np.int64(0))

    def in_any_window(self, pos):
        """Hopping streams have gaps: positions outside every window are
        dropped (win_seq.hpp:330). Always true for sliding windows."""
        pos = np.asarray(pos, dtype=np.int64)
        if not self.is_hopping:
            return np.ones(pos.shape, dtype=bool)
        off = pos % self.slide_len
        return off < self.win_len

    def fired_before(self, pos):
        """Number of windows already FIRED once position `pos` has been seen:
        window w fires on the first pos >= w*slide + win, so the count is
        floor((pos - win)/slide) + 1 for pos >= win, else 0."""
        pos = np.asarray(pos, dtype=np.int64)
        return np.where(
            pos >= self.win_len,
            (pos - self.win_len) // self.slide_len + 1,
            np.int64(0),
        )

    def win_start(self, lwid):
        return np.asarray(lwid, dtype=np.int64) * self.slide_len

    def win_end(self, lwid):
        """Exclusive end position of window `lwid`."""
        return np.asarray(lwid, dtype=np.int64) * self.slide_len + self.win_len
