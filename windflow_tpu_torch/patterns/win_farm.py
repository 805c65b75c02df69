"""Win_Farm: window parallelism — windows are assigned round-robin to
workers, each worker running the sequential core with a private slide of
``slide * pardegree`` (reference win_farm.hpp:134-143).

The emitter multicasts each tuple to exactly the workers whose windows
contain it (wf_nodes.hpp:90-174); in the reference this uses a refcounted
shared wrapper to avoid copies — here batches are immutable arrays, so the
per-worker "copy" is a numpy boolean take of the batch (and the device-side
analog goes further: the archive slice is staged once, see ops/device).

At EOS the emitter replays each key's last tuple to ALL workers as an EOS
marker (wf_nodes.hpp:177-191) so every worker opens/fires the same trailing
windows Win_Seq would have.
"""

from __future__ import annotations

import numpy as np

from ..core.windows import PatternConfig, Role, WindowSpec, WinType
from ..runtime.emitters import Collector, KeyedStreamState
from ..runtime.node import Node, RuntimeContext
from ..runtime.ordering import OrderingCore, OrderingMode
from .basic import _Pattern
from .win_seq import WinSeq, WinSeqNode

_NEG_INF = np.int64(-(2 ** 62))


class WFEmitterNode(Node):
    """Window-range multicast emitter (wf_nodes.hpp:40-195)."""

    quarantine_exempt = True    # framework shell: errors here fail fast
    shed_safe = True            # farm head: shedding drops raw stream rows
    #: recovery: the per-key last-tuple bookkeeping snapshots on the
    #: numpy path; the native keymap path raises SnapshotUnsupported
    #: (emitters.KeyedStreamState.state_snapshot)
    recoverable = True

    def state_snapshot(self):
        snap = self._state.state_snapshot()
        if snap is None:
            from ..runtime.node import SnapshotUnsupported
            raise SnapshotUnsupported(
                f"{self.name}: native keymap state is not snapshotable")
        return snap

    def state_restore(self, snap):
        self._state.state_restore(snap)

    def __init__(self, spec: WindowSpec, pardegree: int, id_outer=0, n_outer=1,
                 slide_outer=None, role: Role = Role.SEQ, name="wf_emitter"):
        super().__init__(name)
        self.spec = spec
        self.pardegree = pardegree
        self.id_outer = id_outer
        self.n_outer = n_outer
        self.slide_outer = spec.slide_len if slide_outer is None else slide_outer
        self.role = role
        self.pos_field = "id" if spec.win_type is WinType.CB else "ts"
        self._state = KeyedStreamState(self.pos_field)

    def _initial_id(self, keys: np.ndarray) -> np.ndarray:
        first_gwid = (self.id_outer - (keys % self.n_outer) + self.n_outer) % self.n_outer
        init = first_gwid * self.slide_outer
        if self.role in (Role.WLQ, Role.REDUCE):
            init = np.zeros_like(init)
        return init

    def svc(self, batch, channel=0):
        spec = self.spec
        # marker absorption + out-of-order drop (wf_nodes.hpp:104-121)
        batch = self._state.filter(batch)
        if len(batch) == 0:
            return
        pos = self._state.pos_cache   # contiguous copy filter already made
        if pos is None:
            pos = batch[self.pos_field].astype(np.int64)
        keys = batch["key"]
        if self.n_outer == 1:
            rel = pos          # non-nested: _initial_id is identically 0
        else:
            rel = pos - self._initial_id(keys)
        keep = rel >= 0
        if spec.is_hopping:
            keep &= spec.in_any_window(np.maximum(rel, 0))
        if not np.all(keep):
            batch = batch[keep]
            rel = rel[keep]
            keys = keys[keep]
        if len(batch) == 0:
            return
        # window range per row (wf_nodes.hpp:134-157)
        first_w = spec.first_win_containing(rel)
        last_w = spec.last_win_containing(rel)
        count = last_w - first_w + 1
        n = self.pardegree
        # steady state of sliding windows (win > slide): every row belongs
        # to >= pardegree windows, so every worker gets every row — detect
        # it once and multicast the SAME array instead of gathering a full
        # copy per worker (workers only read; ~2x the stream size saved
        # per batch on the pipe benchmark)
        if count.min() >= n:
            for d in range(n):
                self.emit_to(d, batch)
            return
        start_dst = (keys & (n - 1)) if n & (n - 1) == 0 else keys % n
        for d in range(n):
            # worker d gets the row iff some w in [first, first+min(count,n))
            # satisfies (key%n + w) % n == d
            r = (d - start_dst - first_w) % n
            m = (count >= n) | (r < count)
            sub = batch[m]
            if len(sub):
                self.emit_to(d, sub)

    def eosnotify(self):
        # per-key EOS markers to every worker (wf_nodes.hpp:177-191)
        markers = self._state.marker_batch()
        if markers is None:
            return
        for d in range(self.pardegree):
            self.emit_to(d, markers)


class WFCollectorNode(Node):
    """Ordered collector: per-key reorder over dense result ids
    (wf_nodes.hpp:401-468), fully vectorised — pending rows of ALL keys are
    one buffer; the releasable contiguous id-run per key is a segmented
    prefix test over a (key, id) lexsort, and each svc emits at most ONE
    batch (per-key tiny emits would turn 10^5 keys into 10^5 downstream
    svc calls).

    Where the node keeps operator states (node logs), its log counts
    ``reorder_released`` (rows released in order) and ``reorder_held_max``
    (the most rows held back at once)."""

    quarantine_exempt = True    # framework shell: errors here fail fast
    recoverable = True          # reorder state is plain numpy data

    def __init__(self, name="wf_collector"):
        super().__init__(name)
        from ..core.slots import SlotMap
        self._slots = SlotMap(on_register=self._on_register)
        self._next = np.zeros(0, dtype=np.int64)   # slot -> next expected id
        self._pend_rows = None                     # structured array
        self._pend_slots = np.zeros(0, dtype=np.int64)
        self._counts = None    # the node log's counters, only with logs

    def svc_init(self):
        st = self.stats
        if st is not None and st.states:
            self._counts = st.counters
            self._counts.update(reorder_released=0, reorder_held_max=0)

    def state_snapshot(self):
        return {
            "slots": self._slots.state_snapshot(),
            "next": self._next.copy(),
            "pend_rows": (None if self._pend_rows is None
                          else self._pend_rows.copy()),
            "pend_slots": self._pend_slots.copy(),
        }

    def state_restore(self, snap):
        self._slots.state_restore(snap["slots"])
        self._next = snap["next"].copy()
        self._pend_rows = (None if snap["pend_rows"] is None
                           else snap["pend_rows"].copy())
        self._pend_slots = snap["pend_slots"].copy()

    def _on_register(self, new_keys):
        self._next = np.concatenate(
            (self._next, np.zeros(len(new_keys), dtype=np.int64)))

    def svc(self, batch, channel=0):
        slots = self._slots.lookup(batch["key"].astype(np.int64, copy=False))
        if self._pend_rows is not None and len(self._pend_rows):
            # only slots present in this batch can make progress (release
            # needs new rows; _next only advances on release) — leave the
            # rest of the pending buffer untouched instead of re-sorting it
            touched = np.isin(self._pend_slots, slots)
            if touched.any():
                rows = np.concatenate((self._pend_rows[touched], batch))
                slots = np.concatenate((self._pend_slots[touched], slots))
                unt = ~touched
                self._pend_rows = self._pend_rows[unt] if unt.any() else None
                self._pend_slots = (self._pend_slots[unt] if unt.any()
                                    else np.zeros(0, dtype=np.int64))
            else:
                rows = batch
        else:
            rows = batch
        ids = rows["id"].astype(np.int64, copy=False)
        order = np.lexsort((ids, slots))
        s = slots[order]
        sid = ids[order]
        starts = np.concatenate(([0], np.flatnonzero(np.diff(s)) + 1))
        rank = np.arange(len(s), dtype=np.int64)
        rank -= np.repeat(starts, np.diff(np.concatenate((starts, [len(s)]))))
        ok = sid == self._next[s] + rank
        # release the per-segment all-ok prefix: rows before a segment's
        # first gap (segmented cumulative-bad == 0)
        bad_cum = np.cumsum(~ok)
        seg_base = np.repeat(bad_cum[starts] - (~ok[starts]),
                             np.diff(np.concatenate((starts, [len(s)]))))
        release = (bad_cum - seg_base) == 0
        if release.any():
            n_rel = np.add.reduceat(release, starts)
            u = s[starts]
            self._next[u] += n_rel
            out = rows[order[release]]
            keep = ~release
            held = rows[order[keep]] if keep.any() else None
            held_slots = slots[order[keep]] if keep.any() else None
            self._stash(held, held_slots)
            self.emit(out)
            released = len(out)
        else:
            self._stash(rows[order], s)
            released = 0
        if self._counts is not None:
            self._count(released)

    def _count(self, released: int):
        c = self._counts
        c["reorder_released"] += released
        held = 0 if self._pend_rows is None else len(self._pend_rows)
        if held > c["reorder_held_max"]:
            c["reorder_held_max"] = held

    def _stash(self, held, held_slots):
        """Park unreleased rows, joining any untouched pending buffer."""
        if held is None:
            return  # untouched pending (if any) already lives in _pend_rows
        if self._pend_rows is not None and len(self._pend_rows):
            self._pend_rows = np.concatenate((self._pend_rows, held))
            self._pend_slots = np.concatenate((self._pend_slots, held_slots))
        else:
            self._pend_rows = held
            self._pend_slots = held_slots


class _OrderedWorkerNode(WinSeqNode):
    """OrderingCore fused in front of a window core — the
    ff_comb(OrderingNode, Win_Seq) worker used behind multiple emitters
    (win_farm.hpp:157-162)."""

    def __init__(self, core, n_channels, mode, name, per_key=False):
        super().__init__(core, name)
        # per_key=True for merges of per-key-renumbered producer streams
        # (LEVEL2 fusion); plain multi-emitter splits are globally
        # monotone per channel and keep the liveness-preserving global
        # watermark (see OrderingCore)
        self.ordering = OrderingCore(n_channels, mode,
                                     per_key_watermarks=per_key)

    def state_snapshot(self):
        merge = self.ordering.state_snapshot()
        if merge is None:
            from ..runtime.node import SnapshotUnsupported
            raise SnapshotUnsupported(
                f"{self.name}: native renumbering counters are not "
                "snapshotable")
        snap = super().state_snapshot()
        snap["ordering"] = merge
        return snap

    def state_restore(self, snap):
        self.ordering.state_restore(snap["ordering"])
        super().state_restore({k: v for k, v in snap.items()
                               if k != "ordering"})

    def svc_init(self):
        super().svc_init()
        if self.n_input_channels != self.ordering.n_channels:
            raise RuntimeError(
                f"{self.name}: wired with {self.n_input_channels} input "
                f"channels but ordering expects {self.ordering.n_channels} "
                "(n_emitters mismatch — results would buffer until EOS)")

    def svc(self, batch, channel=0):
        for merged in self.ordering.push(batch, channel):
            super().svc(merged)

    def on_channel_eos(self, channel):
        for merged in self.ordering.channel_eos(channel):
            super().svc(merged)

    def eosnotify(self):
        for merged in self.ordering.flush():
            WinSeqNode.svc(self, merged)
        super().eosnotify()


class WinFarm(_Pattern):
    """Window-parallel farm of sequential cores (win_farm.hpp)."""

    def __init__(self, winfunc, win_len, slide_len, win_type=WinType.CB,
                 pardegree=2, name="win_farm", incremental=None,
                 result_fields=None, ordered=True, n_emitters=1,
                 config: PatternConfig = None, role: Role = Role.SEQ):
        super().__init__(name, pardegree)
        self.spec = WindowSpec(win_len, slide_len, win_type)
        self.ordered = ordered
        self.n_emitters = n_emitters
        #: LEVEL2 fusion flips this: the fused upstreams emit per-key
        #: renumbered ids, so the workers' merge needs per-key watermarks
        self.ordering_per_key = False
        self.config = config or PatternConfig.plain(slide_len)
        self.role = role
        # worker template: private slide, nested PatternConfig
        # (win_farm.hpp:134-143)
        self._workers = []
        for i in range(pardegree):
            cfg = PatternConfig(
                id_outer=self.config.id_inner, n_outer=self.config.n_inner,
                slide_outer=self.config.slide_inner,
                id_inner=i, n_inner=pardegree, slide_inner=slide_len)
            self._workers.append(WinSeq(
                winfunc, win_len, slide_len * pardegree, win_type,
                name=f"{name}_wf.{i}", incremental=incremental,
                result_fields=result_fields, config=cfg, role=role,
                result_ts_slide=slide_len))

    @property
    def result_schema(self):
        return self._workers[0].result_schema

    def emitter(self):
        return WFEmitterNode(self.spec, self.parallelism,
                             id_outer=self.config.id_inner,
                             n_outer=self.config.n_inner,
                             slide_outer=self.config.slide_inner,
                             role=self.role, name=f"{self.name}.emitter")

    def collector(self):
        if self.ordered:
            return WFCollectorNode(name=f"{self.name}.collector")
        return Collector(name=f"{self.name}.collector")

    def _make_core(self, worker: WinSeq, i=0):
        """Core-factory hook: TPU farms override to build device cores
        (worker index `i` drives per-worker device placement)."""
        return worker.make_core()

    def _make_replica(self, i):
        core = self._make_core(self._workers[i], i)
        if self.n_emitters > 1:
            mode = OrderingMode.ID if self.spec.win_type is WinType.CB else OrderingMode.TS
            node = _OrderedWorkerNode(core, self.n_emitters, mode,
                                      f"{self.name}.{i}",
                                      per_key=self.ordering_per_key)
        else:
            node = WinSeqNode(core, f"{self.name}.{i}")
        node.ctx = RuntimeContext(self.parallelism, i, self.name)
        return node
