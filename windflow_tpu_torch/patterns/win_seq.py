"""Win_Seq pattern: the sequential window core as a dataflow node
(reference win_seq.hpp — also the building block of every windowed farm).
"""

from __future__ import annotations

from ..core.windows import PatternConfig, Role, WindowSpec, WinType
from ..core.winseq import WinSeqCore
from ..ops.functions import WindowFunction, WindowUpdate, as_window_function, as_window_update
from ..runtime.node import Node, RuntimeContext
from .basic import _Pattern


class WinSeqNode(Node):
    """Runtime node driving a WinSeqCore.

    A REDUCE core's node (Win_MapReduce's second stage) counts into its
    node log, where it keeps operator states, ``reduce_windows`` (every
    window it fired) and ``reduce_eos_windows`` (those fired only by the
    end-of-stream flush)."""

    #: svc folds rows into per-key window/ordering state BEFORE any
    #: raise, so a quarantined batch would leave that state partially
    #: mutated (silently wrong windows) — never quarantine under the
    #: dataflow-wide error_budget; fail fast (runtime/overload.py)
    quarantine_exempt = True
    #: recovery (docs/ROBUSTNESS.md): window state restores from an
    #: epoch snapshot — host cores by whole-core deep copy (archives,
    #: vecinc lanes, ordering buffers are all plain numpy/dict state),
    #: device cores via their own snapshot hooks (ring archive handle +
    #: host bookkeeping) — and supervised restart replays the journal
    recoverable = True

    def __init__(self, core: WinSeqCore, name="win_seq"):
        super().__init__(name)
        self.core = core
        self._reduce_counts = None   # the node log's counters (REDUCE)

    def svc_init(self):
        st = self.stats
        if (st is not None and st.states
                and getattr(self.core, "role", None) is Role.REDUCE):
            self._reduce_counts = st.counters
            st.counters.update(reduce_windows=0, reduce_eos_windows=0)

    def _count_reduced(self, n: int, eos: bool = False):
        c = self._reduce_counts
        c["reduce_windows"] += n
        if eos:
            c["reduce_eos_windows"] += n

    def checkpoint_prepare(self):
        """Device cores buffer fired windows in an async launch queue;
        at an epoch barrier their results pre-date the snapshot cut, so
        flush + drain them for emission first — per launch, keeping the
        emission seq numbering independent of harvest timing (host
        cores: no-op)."""
        drain = getattr(self.core, "checkpoint_drain_batches", None)
        return None if drain is None else drain()

    def state_snapshot(self):
        snap_fn = getattr(self.core, "state_snapshot", None)
        if snap_fn is not None:
            return snap_fn()
        import copy
        try:
            return {"core": copy.deepcopy(self.core)}
        except Exception as e:
            # a core holding native/device handles without its own
            # snapshot hooks cannot deep-copy — decline loudly so the
            # supervisor degrades to fail-like-seed for this node
            from ..runtime.node import SnapshotUnsupported
            raise SnapshotUnsupported(
                f"{self.name}: core {type(self.core).__name__} is not "
                f"deep-copyable ({type(e).__name__}: {e})") from e

    def state_restore(self, snap):
        # the native core's snapshot is a lazy handle object, not a
        # dict — anything that isn't the deep-copy form goes to the
        # core's own restore hook
        if isinstance(snap, dict) and "core" in snap:
            import copy
            self.core = copy.deepcopy(snap["core"])
        else:
            self.core.state_restore(snap)

    def svc(self, batch, channel=0):
        if self._recov is not None:
            # recovery mode + async device core: emit ONE batch per
            # completed launch, in launch order.  Launch boundaries are
            # count-triggered (deterministic); how many launches a given
            # poll() harvests is wall-clock — concatenating them per svc
            # (the seed path) would make replayed emission grouping
            # diverge from the original run's and break the per-edge
            # seq dedup (a split regroup would double-deliver windows).
            pb = getattr(self.core, "process_batches", None)
            if pb is not None:
                self._emit_each(pb(batch), triggering=True)
                return
        out = self.core.process(batch)
        if len(out):
            # triggering vs non-triggering split (win_seq.hpp:479-501)
            if self.stats is not None:
                self.stats.bump("windows_fired", len(out))
                self.stats.bump("triggering_batches")
                if self._reduce_counts is not None:
                    self._count_reduced(len(out))
            self.emit(out)
        elif self.stats is not None:
            self.stats.bump("non_triggering_batches")

    def _emit_each(self, outs, triggering=False):
        fired = 0
        for out in outs:
            if len(out):
                fired += len(out)
                self.emit(out)
        if self.stats is not None:
            if fired:
                self.stats.bump("windows_fired", fired)
                if self._reduce_counts is not None:
                    self._count_reduced(fired, eos=not triggering)
                if triggering:
                    self.stats.bump("triggering_batches")
            elif triggering:
                self.stats.bump("non_triggering_batches")

    def eosnotify(self):
        if self._recov is not None:
            fb = getattr(self.core, "flush_batches", None)
            if fb is not None:
                self._emit_each(fb())
                return
        out = self.core.flush()
        if len(out):
            if self.stats is not None:
                self.stats.bump("windows_fired", len(out))
                if self._reduce_counts is not None:
                    self._count_reduced(len(out), eos=True)
            self.emit(out)


class WinSeq(_Pattern):
    """Sequential window pattern (parallelism is always 1; farms build
    parallelism around it, win_farm.hpp:134)."""

    def __init__(self, winfunc, win_len: int, slide_len: int,
                 win_type: WinType = WinType.CB, name="win_seq",
                 incremental: bool = None, result_fields=None,
                 config: PatternConfig = None, role: Role = Role.SEQ,
                 map_indexes=(0, 1), result_ts_slide: int = None):
        super().__init__(name, parallelism=1)
        self.spec = WindowSpec(win_len, slide_len, win_type)
        self.result_ts_slide = result_ts_slide
        # resolve the function flavour (meta_utils.hpp signature deduction
        # becomes an explicit `incremental` switch)
        if incremental is True:
            winfunc = as_window_update(winfunc, result_fields)
        elif incremental is False or isinstance(winfunc, WindowFunction):
            winfunc = as_window_function(winfunc, result_fields)
        elif isinstance(winfunc, WindowUpdate):
            incremental = True
        else:
            winfunc = as_window_function(winfunc, result_fields)
        self.winfunc = winfunc
        self.incremental = bool(incremental)
        self.config = config
        self.role = role
        self.map_indexes = map_indexes

    def make_core(self) -> WinSeqCore:
        # Tumbling/sliding windows over a monoid reducer take the
        # vectorised multi-key core: identical INC semantics (== NIC for a
        # monoid), O(rows log rows) per chunk regardless of key
        # cardinality.  WF_NO_VECCORE=1 forces the reference per-key core
        # (debugging / differential runs).
        import os
        from ..core.vecinc import make_vec_core, vec_core_supported
        if (vec_core_supported(self.spec, self.winfunc)
                and not os.environ.get("WF_NO_VECCORE")):
            return make_vec_core(
                self.spec, self.winfunc, config=self.config, role=self.role,
                map_indexes=self.map_indexes,
                result_ts_slide=self.result_ts_slide)
        core = WinSeqCore(self.spec, self.winfunc, config=self.config,
                          role=self.role, map_indexes=self.map_indexes,
                          result_ts_slide=self.result_ts_slide)
        if self.incremental:
            core.use_incremental()
        return core

    def _make_replica(self, i):
        node = WinSeqNode(self.make_core(), f"{self.name}.{i}")
        node.ctx = RuntimeContext(1, 0, self.name)
        return node

    @property
    def result_schema(self):
        from ..core.tuples import Schema
        return Schema(**self.winfunc.result_fields)
