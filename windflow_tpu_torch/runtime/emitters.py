"""Routing nodes: the batch-native versions of the reference's L2 graph
nodes (``standard.hpp``): pass-through / round-robin / keyed emitters and the
trivial merging collector.

Routing a batch means *splitting* it by destination with a vectorised
predicate — the analog of per-tuple ``ff_send_out_to`` (standard.hpp:73-81)
— so routing cost is O(batch), not O(tuple) dispatches.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..core.tuples import MARKER_FIELD
from .node import Node

_NEG_INF = np.int64(-(2 ** 62))
_P64 = ctypes.POINTER(ctypes.c_longlong)


def _p64(a: np.ndarray):
    return a.ctypes.data_as(_P64)


class KeyedStreamState:
    """Per-key last-tuple bookkeeping shared by window emitters: the
    out-of-order drop and the EOS-marker source (wf_nodes.hpp:60-121,
    wm_nodes.hpp:52-104).  Also absorbs markers arriving from an enclosing
    nesting emitter so this emitter's own markers carry the key's global
    last tuple.

    State is slot-indexed parallel arrays (core/slots.py).  When the
    native library is available, slot lookup and the in-order check ride
    ONE memory-speed C pass per batch (wf_keymap_lookup +
    wf_keyscan_ordered) instead of a binary-search lookup + stable
    argsort + segmented running max — together ~150 ms per 1M-row batch
    of pure host time on the pipe benchmark, the farm emitter's largest
    cost.  The numpy slot path remains both the no-toolchain fallback
    and the out-of-order general path (identical semantics, pinned by
    the emitter differential tests)."""

    __slots__ = ("pos_field", "_slots", "_last_pos", "_rows", "_n", "_cap",
                 "_lib", "_km", "_last_idx", "_touched", "_nt", "pos_cache")

    def __init__(self, pos_field: str):
        from ..native import load
        self.pos_field = pos_field
        self._lib = load()
        self._km = (self._lib.wf_keymap_new()
                    if self._lib is not None else None)
        if self._km is None:
            from ..core.slots import SlotMap
            self._slots = SlotMap(on_register=self._on_register)
        else:
            self._slots = None
        self._last_pos = np.zeros(0, dtype=np.int64)
        self._rows = None     # (cap,) structured array, slot-indexed
        self._n = 0
        self._cap = 0
        self._last_idx = np.empty(0, dtype=np.int64)   # scan scratch
        self._touched = np.empty(0, dtype=np.int64)
        self._nt = ctypes.c_longlong(0)
        #: after filter(): the contiguous int64 pos column of the batch
        #: filter RETURNED, when that batch is the unmodified input (the
        #: in-order fast path) — callers reuse it instead of re-gathering
        #: the strided field; None whenever rows were dropped/changed
        self.pos_cache = None

    def __del__(self):
        km = getattr(self, "_km", None)
        if km is not None:
            self._lib.wf_keymap_free(km)
            self._km = None

    def _on_register(self, new_keys):
        self._grow_count(len(new_keys))

    def _grow_count(self, m):
        if self._n + m > self._cap:
            # amortised doubling: exact-size concatenate per registration
            # is quadratic when keys trickle in across batches
            self._cap = max(self._cap * 2, self._n + m, 1024)
            grown = np.full(self._cap, _NEG_INF, dtype=np.int64)
            grown[:self._n] = self._last_pos[:self._n]
            self._last_pos = grown
            if self._rows is not None:
                gr = np.zeros(self._cap, dtype=self._rows.dtype)
                gr[:self._n] = self._rows[:self._n]
                self._rows = gr
            if self._km is not None:
                li = np.full(self._cap, -1, dtype=np.int64)
                li[:self._n] = self._last_idx[:self._n]
                self._last_idx = li
                self._touched = np.empty(self._cap, dtype=np.int64)
        self._n += m

    def _lookup(self, keys: np.ndarray) -> np.ndarray:
        """Slots for `keys`, registering unseen keys (first-appearance
        order — identical numbering in both implementations)."""
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        if self._km is None:
            return self._slots.lookup(keys)
        slots = np.empty(len(keys), dtype=np.int64)
        ns = self._lib.wf_keymap_lookup(self._km, _p64(keys), len(keys),
                                        _p64(slots))
        if ns > self._n:
            self._grow_count(ns - self._n)
        return slots

    def _rows_buf(self, dtype):
        if self._rows is None:
            self._rows = np.zeros(self._cap, dtype=dtype)
        elif self._rows.dtype != dtype:
            # a mid-stream schema change would silently zero the columns
            # absent from the old dtype in every captured last-row (EOS
            # marker replay) — upstream schemas are fixed at build time, so
            # this is a bug upstream: fail loudly (ADVICE r2)
            raise TypeError(
                f"batch dtype changed mid-stream: {self._rows.dtype} -> "
                f"{dtype} (operator schemas are fixed at graph build)")
        return self._rows

    def _store_last(self, slots_of_rows, rows, sorted_order=None):
        """Per-slot last-row capture: rows are in priority order (arrival,
        or pos for markers), so the LAST occurrence per slot wins.
        ``sorted_order`` passes a precomputed stable slot sort to avoid
        re-sorting on the hot path."""
        buf = self._rows_buf(rows.dtype)
        order = (np.argsort(slots_of_rows, kind="stable")
                 if sorted_order is None else sorted_order)
        s = slots_of_rows[order]
        last = np.ones(len(s), dtype=bool)
        last[:-1] = s[1:] != s[:-1]
        buf[s[last]] = rows[order[last]]

    def filter(self, batch: np.ndarray) -> np.ndarray:
        """Absorb marker rows and drop out-of-order rows; returns the
        surviving (real) rows, arrival order preserved."""
        self.pos_cache = None
        mk = batch[MARKER_FIELD]
        if np.any(mk):
            mrows = batch[mk]
            mpos = mrows[self.pos_field].astype(np.int64)
            mslots = self._lookup(mrows["key"])
            ok = mpos >= self._last_pos[mslots]
            if not ok.all():
                mrows, mpos, mslots = mrows[ok], mpos[ok], mslots[ok]
            if len(mrows):
                # order by pos so the stored last row is the max-pos
                # marker (ties: later arrival wins, like the dict form)
                mo = np.argsort(mpos, kind="stable")
                self._store_last(mslots[mo], mrows[mo])
                np.maximum.at(self._last_pos, mslots, mpos)
            batch = batch[~mk]
        if len(batch) == 0:
            return batch
        slots = self._lookup(batch["key"])
        pos = np.ascontiguousarray(batch[self.pos_field], dtype=np.int64)
        if self._km is not None:
            ok = self._lib.wf_keyscan_ordered(
                _p64(slots), _p64(pos), len(batch), _p64(self._last_pos),
                _p64(self._last_idx), _p64(self._touched),
                ctypes.byref(self._nt))
            t = self._touched[:self._nt.value]
            li = self._last_idx[t]
            self._last_idx[t] = -1        # scratch hygiene for next batch
            if ok:
                # in-order: capture each touched slot's last row + pos
                # (tiny gathers — one row per distinct key)
                buf = self._rows_buf(batch.dtype)
                buf[t] = batch[li]
                self._last_pos[t] = pos[li]
                self.pos_cache = pos
                return batch
        return self._filter_general(batch, slots, pos)

    def _filter_general(self, batch, slots, pos):
        """The numpy path: in-order store, or the out-of-order drop via
        the segmented exclusive running max."""
        from ..core.slots import segmented_excl_running_max, segments
        order = np.argsort(slots, kind="stable")
        s = slots[order]
        ps = pos[order]
        starts, ends = segments(s)
        seg_first = np.zeros(len(s), dtype=bool)
        seg_first[starts] = True
        within_bad = np.zeros(len(s), dtype=bool)
        within_bad[1:] = (np.diff(ps) < 0) & ~seg_first[1:]
        head_bad = ps[starts] < self._last_pos[s[starts]]
        if not within_bad.any() and not head_bad.any():
            # in-order fast path: store each key's last row, done
            lasts = ends - 1
            self._last_pos[s[lasts]] = ps[lasts]
            self._store_last(slots, batch, sorted_order=order)
            self.pos_cache = pos
            return batch
        # out-of-order: the shared segmented exclusive running max
        # (core/slots.py; also the vecinc drop pass)
        excl = segmented_excl_running_max(s, ps, starts,
                                          self._last_pos[s[starts]])
        keep_sorted = ps >= excl
        liv = np.flatnonzero(keep_sorted)
        if len(liv):
            ls, le = segments(s[liv])
            self._last_pos[s[liv[ls]]] = ps[liv[le - 1]]
            self._store_last(slots[order[liv]], batch[order[liv]],
                             sorted_order=np.arange(len(liv)))
        keep = np.empty(len(batch), dtype=bool)
        keep[order] = keep_sorted
        return batch if keep.all() else batch[keep]

    def state_snapshot(self):
        """Recovery snapshot of the per-key bookkeeping, numpy path only
        — the native keymap keeps key->slot in a C table with no
        extraction API, so the native path returns None (the owning
        emitter then raises SnapshotUnsupported and a crash there fails
        the graph exactly like the seed engine)."""
        if self._km is not None:
            return None
        return {
            "slots": self._slots.state_snapshot(),
            "last_pos": self._last_pos.copy(),
            "rows": None if self._rows is None else self._rows.copy(),
            "n": self._n, "cap": self._cap,
        }

    def state_restore(self, snap):
        self._slots.state_restore(snap["slots"])
        self._last_pos = snap["last_pos"].copy()
        self._rows = None if snap["rows"] is None else snap["rows"].copy()
        self._n = snap["n"]
        self._cap = snap["cap"]
        self.pos_cache = None

    def marker_batch(self) -> np.ndarray | None:
        """One marker row per key (its last tuple), for EOS replay."""
        if self._rows is None or self._n == 0:
            return None
        seen = self._last_pos[:self._n] > _NEG_INF
        if not seen.any():
            return None
        markers = self._rows[:self._n][seen].copy()
        markers[MARKER_FIELD] = True
        return markers


def default_routing(keys: np.ndarray, n: int) -> np.ndarray:
    """key -> destination in [0, n): the reference default is k % n
    (builders.hpp:190)."""
    return keys % n


class StandardEmitter(Node):
    """Pass-through (n=1), block round-robin, or keyed routing emitter
    (standard.hpp:40-88).

    ``n_active`` <= ``n_dest`` is the width actually routed over: equal
    by default (seed behavior), narrower when the control plane
    pre-provisioned the farm to a ``Rescale`` rule's ``max_workers``
    (docs/CONTROL.md) — the controller then moves ``n_active`` at epoch
    barriers, and a crash-restore replays routing decisions at the width
    the snapshot pinned (``state_attrs``)."""

    quarantine_exempt = True    # framework shell: errors here fail fast
    shed_safe = True            # farm head: shedding drops raw stream rows
    recoverable = True          # round-robin cursor + active width
    state_attrs = ("_rr", "n_active")

    def __init__(self, n_dest: int, routing=None, name="emitter"):
        super().__init__(name)
        self.n_dest = n_dest
        self.n_active = n_dest
        self.routing = routing  # vectorised fn(keys, n) -> dest indices
        self._rr = 0

    def svc(self, batch, channel=0):
        n = self.n_active
        if n == 1:
            self.emit_to(0, batch)
            return
        if self.routing is None:
            # round-robin whole chunks: preserves per-key order only within a
            # replica, exactly like the reference's per-tuple round-robin
            self.emit_to(self._rr, batch)
            self._rr = (self._rr + 1) % n
            return
        dest = np.asarray(self.routing(batch["key"], n))
        if len(batch) and (dest[0] == dest[-1]) and not np.any(dest != dest[0]):
            self.emit_to(int(dest[0]), batch)
            return
        for d in range(n):
            sub = batch[dest == d]
            if len(sub):
                self.emit_to(d, sub)


class Collector(Node):
    """Trivial multi-in merge (standard.hpp:91-94)."""

    quarantine_exempt = True    # framework shell: errors here fail fast
    recoverable = True          # stateless pass-through merge

    def __init__(self, name="collector"):
        super().__init__(name)

    def svc(self, batch, channel=0):
        self.emit(batch)


# NOTE: the reference's broadcast_node (multipipe.hpp:50-115) has no node
# here on purpose: it exists only to feed CB-window farms the whole stream
# inside MultiPipe, and this framework's MultiPipe covers that case with a
# TS_RENUMBERING ordered merge instead (api/multipipe.py:_maybe_order) —
# a broadcast + per-worker renumber pair never materialises.
