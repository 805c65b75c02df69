"""Ordering nodes: k-way merge of per-channel ordered streams with per-key
watermarks — the reference ``OrderingNode`` (orderingNode.hpp:49-225).

Semantics reproduced exactly:

* per key, ``maxs[c]`` tracks the greatest position seen from channel ``c``
  for THAT key (Key_Descriptor::maxs, orderingNode.hpp:72); buffered rows
  are released once their position is <= min(maxs)
  (orderingNode.hpp:151-162);
* EOS *markers* are set aside (keeping the max-position one per key) and
  re-emitted last at EOS, after the residual buffer flush
  (orderingNode.hpp:134-147, 188-220);
* ``TS_RENUMBERING`` rewrites ids with a dense per-key counter after the
  time-ordered merge (orderingNode.hpp:167-172) — this is what lets
  count-windows sit behind a broadcast in MultiPipe.

Batch-native: rows are buffered per (key, channel) as column chunks and the
releasable prefix is computed with numpy merges, so cost is O(rows log k)
with tiny constants rather than a per-tuple priority queue.
"""

from __future__ import annotations

import enum

import numpy as np

from ..core.tuples import MARKER_FIELD
from .node import Node

_NEG_INF = -(2 ** 62)


class OrderingMode(enum.Enum):
    ID = "id"                      # merge by tuple id
    TS = "ts"                      # merge by timestamp
    TS_RENUMBERING = "ts_renum"    # merge by ts, then renumber ids densely


class _KeyBuf:
    __slots__ = ("chans", "marker_row", "marker_pos", "emit_counter",
                 "maxs")

    def __init__(self, n_channels, per_key):
        self.chans = [[] for _ in range(n_channels)]  # lists of row chunks
        self.marker_row = None
        self.marker_pos = _NEG_INF
        self.emit_counter = 0
        # per-channel greatest position seen FOR THIS KEY — the reference's
        # Key_Descriptor::maxs (orderingNode.hpp:72, per key, not global:
        # producers like PLQ/MAP workers emit per-key-monotone ids that are
        # NOT globally monotone across keys, so a global watermark would
        # release rows early and downstream cores would drop their
        # out-of-order siblings).  Allocated only in per-key mode; the
        # default global-watermark mode never reads it.
        self.maxs = (np.full(n_channels, _NEG_INF, dtype=np.int64)
                     if per_key else None)

    def has_rows(self):
        return any(self.chans)


class OrderingCore:
    """Reusable merge engine (also fused in front of farm workers, the
    ff_comb(OrderingNode, worker) analog, win_farm.hpp:157-162).

    Two watermark granularities, for two classes of producer:

    * ``per_key_watermarks=True`` — the reference's semantics
      (Key_Descriptor::maxs, orderingNode.hpp:72,151-162): per key,
      ``maxs[c]`` tracks the greatest position channel ``c`` delivered for
      THAT key.  Required when channels are only per-key monotone — e.g.
      PLQ/MAP workers emitting per-key-renumbered ids (the LEVEL2 fused
      merge), where a global watermark would release rows early and the
      downstream core would drop their out-of-order siblings.
    * ``per_key_watermarks=False`` (default) — one watermark per channel,
      global across keys.  Valid only when each channel's stream is
      GLOBALLY nondecreasing in position (sources are monotone; union
      branches, multi-emitter splits of a monotone stream), and required
      there for liveness: a key flowing on only one channel still advances
      instead of buffering until EOS.

    A channel that reaches EOS is excluded from the min (its watermark
    jumps to +inf, orderingNode.hpp:182-221) so the merge never stalls on
    finished producers."""

    def __init__(self, n_channels: int, mode: OrderingMode,
                 per_key_watermarks: bool = False,
                 ordered_input: bool = False,
                 owned_input: bool = False):
        self.n_channels = n_channels
        self.mode = mode
        self.per_key = per_key_watermarks
        #: the wiring layer proved every pushed batch is handed off
        #: (producer yields_fresh — node.py ownership protocol): the
        #: renumbering fast path may write ids into the batch in place
        #: instead of taking a private copy (0.2-0.3 s of the 8M-row
        #: pipe run)
        self.owned_input = bool(owned_input)
        #: the caller vouches the (single) channel is ts-ordered per key
        #: WITHIN each batch — the precondition for the renumbering fast
        #: path.  A disordered single tail (TS_RENUMBERING chosen via
        #: `not ordered`) must take the general path, whose per-release
        #: stable ts-sort fixes intra-batch inversions before ids are
        #: assigned.
        self.ordered_input = bool(ordered_input)
        self.pos_field = "id" if mode is OrderingMode.ID else "ts"
        self._keys: dict[int, _KeyBuf] = {}
        #: channels that reached EOS (excluded from every key's min)
        self._eos = np.zeros(n_channels, dtype=bool)
        self.watermark = np.full(n_channels, _NEG_INF, dtype=np.int64)
        self._released_upto = _NEG_INF
        #: native per-key counter table for the single-channel fast path
        #: (lazy; None = numpy fallback with per-key emit_counters)
        self._renum = None
        self._renum_lib = None

    def __del__(self):
        if getattr(self, "_renum", None) is not None:
            self._renum_lib.wf_renum_free(self._renum)
            self._renum = None

    def state_snapshot(self):
        """Recovery snapshot of the merge state (buffered chunks,
        watermarks, renumbering counters).  Returns None when the native
        per-key renumbering table is active — its counters live in a C
        table with no extraction API, so the owning node reports
        SnapshotUnsupported and a crash there fails as in the seed
        engine (snapshots taken *before* the table's lazy creation are
        fine: a fresh table equals the all-zero counter state)."""
        if self._renum is not None:
            return None
        import copy
        return {
            "keys": copy.deepcopy(self._keys),
            "eos": self._eos.copy(),
            "watermark": self.watermark.copy(),
            "released_upto": self._released_upto,
        }

    def state_restore(self, snap):
        import copy
        self._keys = copy.deepcopy(snap["keys"])
        self._eos = snap["eos"].copy()
        self.watermark = snap["watermark"].copy()
        self._released_upto = snap["released_upto"]
        if self._renum is not None:
            # table created after the snapshot was taken — the snapshot
            # predates every fast-path push, so all counters were zero:
            # a fresh table (lazily recreated on the next push) matches
            self._renum_lib.wf_renum_free(self._renum)
            self._renum = None

    def _buf(self, key):
        b = self._keys.get(key)
        if b is None:
            b = _KeyBuf(self.n_channels, self.per_key)
            self._keys[key] = b
        return b

    def _upto(self, kb: _KeyBuf) -> int:
        live = kb.maxs[~self._eos]
        return int(live.min()) if len(live) else 2 ** 62

    def _release(self, kb: _KeyBuf, key: int, upto: int) -> np.ndarray | None:
        """Pop every buffered row with pos <= upto, merged in pos order."""
        take = []
        for c, chunks in enumerate(kb.chans):
            if not chunks:
                continue
            rows = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
            pos = rows[self.pos_field]
            cut = int(np.searchsorted(pos, upto, side="right"))
            if cut:
                take.append(rows[:cut])
                kb.chans[c] = [rows[cut:]] if cut < len(rows) else []
            else:
                kb.chans[c] = [rows]
        if not take:
            return None
        merged = take[0] if len(take) == 1 else np.concatenate(take)
        order = np.argsort(merged[self.pos_field], kind="stable")
        merged = merged[order]     # advanced indexing: always a fresh array
        if self.mode is OrderingMode.TS_RENUMBERING:
            merged["id"] = kb.emit_counter + np.arange(len(merged))
            kb.emit_counter += len(merged)
        return merged

    def _push_single_channel(self, batch: np.ndarray):
        """SINGLE-upstream TS_RENUMBERING fast path: with one channel
        there is nothing to merge — every row is releasable the moment it
        arrives, already in per-key order (the per-channel contract), so
        the whole push reduces to a vectorised per-key cumcount over the
        batch IN ARRIVAL ORDER: no pos argsort, no per-key buffer
        fragmentation, one output batch instead of one array per key.
        Measured 2026-07-31: the general path ran this exact case at
        5.3 M rows/s and was the pipe benchmark's single largest host
        cost (1.2 s of a 2.9 s run).  The renumbering itself rides the
        native per-key counter loop when available (wf_renum_run, one
        GIL-released memory-speed pass — the numpy groupby-cumcount
        needs a stable argsort per batch, ~6.5 M rows/s); per-key
        emit_counters are the fallback."""
        out = batch if self.owned_input else batch.copy()
        if self._renum is None and self._renum_lib is None:
            from ..native import load
            lib = load()
            # False = tried-and-unavailable sentinel: never re-attempt
            # the load on this hot path
            self._renum_lib = lib if lib is not None else False
            if lib is not None:
                self._renum = lib.wf_renum_new()
        if self._renum is not None:
            import ctypes
            p64 = ctypes.POINTER(ctypes.c_longlong)
            keys_c = np.ascontiguousarray(batch["key"])
            ids = np.empty(len(batch), dtype=np.int64)
            self._renum_lib.wf_renum_run(
                self._renum, keys_c.ctypes.data_as(p64), len(batch),
                ids.ctypes.data_as(p64))
            out["id"] = ids
        else:
            keys = batch["key"]
            order = np.argsort(keys, kind="stable")
            sk = keys[order]
            bounds = np.flatnonzero(np.diff(sk)) + 1
            starts = np.concatenate(([0], bounds))
            # position of each (key-sorted) row within its key group
            grp = np.zeros(len(sk), dtype=np.int64)
            grp[bounds] = 1
            np.cumsum(grp, out=grp)
            within = np.arange(len(sk), dtype=np.int64) - starts[grp]
            base = np.empty(len(starts), dtype=np.int64)
            for g, s in enumerate(starts):
                kb = self._buf(int(sk[s]))
                n_g = (bounds[g] if g < len(bounds) else len(sk)) - s
                base[g] = kb.emit_counter
                kb.emit_counter += int(n_g)
            ids_sorted = base[grp] + within
            new_ids = np.empty(len(batch), dtype=np.int64)
            new_ids[order] = ids_sorted
            out["id"] = new_ids
        # keep the watermark honest for flush()/diagnostics
        self.watermark[0] = max(int(self.watermark[0]),
                                int(batch[self.pos_field].max()))
        return [out]

    def push(self, batch: np.ndarray, channel: int):
        """Buffer one per-key-ordered batch from `channel`; yield releasable
        merged chunks."""
        out = []
        marker = batch[MARKER_FIELD]
        if np.any(marker):
            for row in batch[marker]:
                kb = self._buf(int(row["key"]))
                p = int(row[self.pos_field])
                if p > kb.marker_pos or kb.marker_row is None:
                    kb.marker_pos = p
                    kb.marker_row = row.copy()
            batch = batch[~marker]
        if len(batch) == 0:
            return out
        if (self.n_channels == 1 and not self.per_key
                and self.ordered_input
                and self.mode is OrderingMode.TS_RENUMBERING):
            out.extend(self._push_single_channel(batch))
            return out
        keys = batch["key"]
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
        bounds = np.flatnonzero(np.diff(sk)) + 1
        touched = []
        for grp in np.split(order, bounds):
            key = int(keys[grp[0]])
            kb = self._buf(key)
            rows = batch[grp]
            kb.chans[channel].append(rows)
            if self.per_key:
                # per-key watermark advance (orderingNode.hpp:151-152);
                # only this key's buffered rows can become releasable
                kb.maxs[channel] = max(int(kb.maxs[channel]),
                                       int(rows[self.pos_field][-1]))
                rel = self._release(kb, key, self._upto(kb))
                if rel is not None:
                    out.append(rel)
            else:
                touched.append((key, kb))
        if self.per_key:
            return out
        wm = self.watermark
        wm[channel] = max(int(wm[channel]),
                          int(batch[self.pos_field].max()))
        upto = int(wm[~self._eos].min()) if not self._eos.all() else 2 ** 62
        if upto > self._released_upto:
            # watermark advanced: rows of ANY key may become releasable
            self._released_upto = upto
            out.extend(self._release_all(upto))
        else:
            # no advance: only this batch's keys can have new releasable
            # rows (those below the standing watermark) — skip the
            # every-key scan on the merge hot path
            for key, kb in touched:
                rel = self._release(kb, key, upto)
                if rel is not None:
                    out.append(rel)
        return out

    def _release_all(self, upto: int):
        """A watermark advance can release buffered rows of ANY key."""
        out = []
        for key, kb in self._keys.items():
            if not kb.has_rows():
                continue
            rel = self._release(kb, key, upto)
            if rel is not None:
                out.append(rel)
        return out

    def channel_eos(self, channel: int):
        """Exclude a finished channel from the watermark min and release
        what that unblocks (orderingNode.hpp:182-221)."""
        self._eos[channel] = True
        if not self.per_key:
            self.watermark[channel] = 2 ** 62
            upto = (int(self.watermark[~self._eos].min())
                    if not self._eos.all() else 2 ** 62)
            self._released_upto = max(self._released_upto, upto)
            return self._release_all(upto)
        out = []
        for key, kb in self._keys.items():
            if not kb.has_rows():
                continue
            rel = self._release(kb, key, self._upto(kb))
            if rel is not None:
                out.append(rel)
        return out

    def flush(self):
        """EOS: release everything, then the per-key marker (renumbered too,
        orderingNode.hpp:197-219)."""
        out = []
        for key, kb in self._keys.items():
            rel = self._release(kb, key, 2 ** 62)
            if rel is not None:
                out.append(rel)
            if kb.marker_row is not None:
                m = kb.marker_row.copy().reshape(1)
                if self.mode is OrderingMode.TS_RENUMBERING:
                    if self._renum is not None:
                        # the native counter table owns this key's ids
                        m["id"] = self._renum_lib.wf_renum_next(
                            self._renum, int(key))
                    else:
                        m["id"] = kb.emit_counter
                        kb.emit_counter += 1
                out.append(m)
                kb.marker_row = None
        return out


class OrderingNode(Node):
    """Standalone ordering node (multi-in)."""

    #: outputs are merge gathers, renumbered copies, or (owned elision)
    #: batches that were themselves handed off — fresh either way
    yields_fresh = True
    #: framework merge, not user code: a dropped batch here would
    #: silently corrupt the ordered stream — always fail fast
    quarantine_exempt = True
    #: recovery: merge buffers + watermarks snapshot as plain data (the
    #: native renumbering table is the one dynamic exception, see
    #: OrderingCore.state_snapshot)
    recoverable = True

    def __init__(self, n_channels: int, mode: OrderingMode, name="ordering",
                 ordered_input: bool = False, owned_input: bool = False):
        super().__init__(name)
        self.core = OrderingCore(n_channels, mode,
                                 ordered_input=ordered_input,
                                 owned_input=owned_input)

    def state_snapshot(self):
        snap = self.core.state_snapshot()
        if snap is None:
            from .node import SnapshotUnsupported
            raise SnapshotUnsupported(
                f"{self.name}: native renumbering counters are not "
                "snapshotable")
        return snap

    def state_restore(self, snap):
        self.core.state_restore(snap)

    def svc(self, batch, channel=0):
        for out in self.core.push(batch, channel):
            self.emit(out)

    def on_channel_eos(self, channel: int):
        for out in self.core.channel_eos(channel):
            self.emit(out)

    def eosnotify(self):
        for out in self.core.flush():
            self.emit(out)
