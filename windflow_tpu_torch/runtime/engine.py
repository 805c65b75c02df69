"""Threaded dataflow engine — the runtime replacing FastFlow's pipeline of
pinned threads + lock-free SPSC queues (SURVEY.md §2.8).

Host-side dataflow stays on CPU threads exactly like the reference; the
difference is that channel payloads are whole batches, so queue traffic is
O(stream/chunk) instead of O(stream), and the Python GIL is released inside
the numpy/XLA kernels doing the real work.  When the native C++ substrate is
built (native/), Inbox transparently switches to the native blocking MPSC
ring (mutex + condvar — the win over queue.Queue is GIL-released futex
waits instead of 50 ms polling, not lock-freedom).

Topology model: a directed graph of Nodes. Each node owns one Inbox; an edge
(a -> b) reserves a source-slot in b's inbox so b can count per-channel EOS
(the FastFlow multi-in protocol) and ordering nodes can tell channels apart.
"""

from __future__ import annotations

import os
import queue
import threading
from collections import defaultdict
from time import monotonic as _monotonic
from time import perf_counter_ns as _pc_ns
from time import sleep as _sleep

from .node import (Node, RuntimeContext, SnapshotUnsupported, SourceNode,
                   blocked_put_ns)
from .overload import DeadLetter, OverloadError, OverloadPolicy
from ..recovery.epoch import EpochMarker, Tagged, is_ctrl_payload
from ..utils.profile import timeline_record as _tl_record
from ..utils.profile import timeline_stamp as _tl_stamp

_EOS = object()


class _Cancelled(BaseException):
    """Raised inside a node thread when the dataflow failed elsewhere —
    unblocks producers stuck on a dead consumer's bounded queue."""


class Inbox:
    """MPSC channel carrying (src_slot, batch) pairs.  Blocking operations
    poll the dataflow's failure flag so a raised node cannot deadlock the
    graph (a full queue whose consumer died would block producers
    forever).

    An :class:`~windflow_tpu_torch.runtime.overload.OverloadPolicy` reshapes the
    ``put`` side only (shed_oldest / shed_newest / deadline-bounded block);
    ``put_eos`` and ``get`` are policy-exempt — an EOS that is shed or
    timed out would corrupt the per-channel EOS counting.  Shed items are
    counted in ``self.shed`` (surfaced per node via tracing.NodeStats and
    ``Dataflow.shed_counts``)."""

    def __init__(self, capacity: int = 0, failed: threading.Event = None,
                 policy: OverloadPolicy = None):
        self._q = queue.Queue(maxsize=capacity)
        self.n_sources = 0
        self._failed = failed
        self._policy = policy if (policy is not None
                                  and policy.reshapes_put) else None
        self.shed = 0
        self._shed_lock = threading.Lock()
        #: occupancy high-water mark, maintained only when the dataflow
        #: is observed (metrics/sample_period): the put-side cost is a
        #: single predictable `_track` branch when off.  Updated without
        #: a lock — a lost race understates the mark by at most one
        #: concurrent put, a fine trade for a telemetry-only value.
        self.hwm = 0
        self._track = False
        #: ns each source slot spent inside put (blocked on this inbox
        #: when it is full), kept only when the dataflow writes node logs
        #: (trace_dir): the engine sets it, and the producer's NodeStats
        #: sums its slots when it ends.  None = one dead branch a put.
        self._put_ns = None

    def register_source(self) -> int:
        slot = self.n_sources
        self.n_sources += 1
        return slot

    def _blocking(self, op):
        while True:
            try:
                return op()
            except (queue.Full, queue.Empty):
                if self._failed is not None and self._failed.is_set():
                    raise _Cancelled() from None

    def _record_shed(self):
        with self._shed_lock:
            self.shed += 1

    def _cancelled(self) -> bool:
        return self._failed is not None and self._failed.is_set()

    def put(self, src: int, item):
        put_ns = self._put_ns
        if put_ns is not None:
            stamp = _tl_stamp()
            t0 = _pc_ns()
        pol = self._policy
        if pol is None:
            self._blocking(lambda: self._q.put((src, item), timeout=0.05))
        elif pol.shed == "shed_newest":
            lim = pol.soft_limit
            if lim is not None and self._q.qsize() >= lim:
                # adaptive soft limit (control plane, docs/CONTROL.md):
                # start dropping before the queue is hard-full
                if self._cancelled():
                    raise _Cancelled() from None
                self._record_shed()
            else:
                try:
                    self._q.put_nowait((src, item))
                except queue.Full:
                    if self._cancelled():
                        # shed_newest never blocks, so this is the only
                        # spot a producer can observe a failed graph —
                        # without it an unbounded source would generate
                        # forever
                        raise _Cancelled() from None
                    self._record_shed()
        elif pol.shed == "shed_oldest":
            self._put_shed_oldest(src, item)
        else:  # block with a deadline
            self._put_deadline(src, item, pol.put_deadline)
        if self._track:
            depth = self._q.qsize()
            if depth > self.hwm:
                self.hwm = depth
        if put_ns is not None:
            put_ns[src] += _pc_ns() - t0
            if stamp is not None:
                _tl_record("put_wait", stamp)

    def depth(self) -> int:
        """Current occupancy (items incl. queued EOS frames) — sampled
        by the observability layer, racy by design."""
        return self._q.qsize()

    def _put_shed_oldest(self, src: int, item):
        while True:
            lim = self._policy.soft_limit
            if lim is None or self._q.qsize() < lim:
                try:
                    return self._q.put_nowait((src, item))
                except queue.Full:
                    if self._cancelled():
                        raise _Cancelled() from None
            elif self._cancelled():
                # at/above the adaptive soft limit: evict before
                # admitting, exactly the full-queue path below
                raise _Cancelled() from None
            # evict the head to admit the new item.  EOS frames must
            # survive: re-queue them at the tail (safe — EOS is its
            # channel's LAST frame, so per-channel order is preserved)
            try:
                victim = self._q.get_nowait()
            except queue.Empty:
                continue    # consumer drained it meanwhile; retry the put
            if victim[1] is _EOS or is_ctrl_payload(victim[1]):
                # EOS and epoch-marker control frames survive eviction
                # (a shed marker would stall downstream barrier
                # alignment the way a shed EOS would corrupt the
                # per-channel EOS count)
                self._blocking(
                    lambda: self._q.put(victim, timeout=0.05))
                # shutdown skew: a full queue of only EOS frames would
                # otherwise hot-spin evict/re-queue until the (slow —
                # that's why shedding is on) consumer drains one
                _sleep(0.001)
            else:
                self._record_shed()

    def _put_deadline(self, src: int, item, deadline: float):
        t_end = _monotonic() + deadline
        while True:
            try:
                return self._q.put((src, item), timeout=0.05)
            except queue.Full:
                if self._cancelled():
                    raise _Cancelled() from None
                if _monotonic() >= t_end:
                    raise OverloadError(
                        f"inbox put blocked longer than the "
                        f"{deadline}s deadline (capacity "
                        f"{self._q.maxsize}): downstream stage is not "
                        f"keeping up") from None

    def put_eos(self, src: int):
        self._blocking(lambda: self._q.put((src, _EOS), timeout=0.05))

    def put_ctrl(self, src: int, item):
        """Policy-exempt blocking put for control frames (epoch barrier
        markers): like ``put_eos``, never shed and never deadlined."""
        self._blocking(lambda: self._q.put((src, item), timeout=0.05))

    def get(self):
        return self._blocking(lambda: self._q.get(timeout=0.05))

    def cancel(self):
        """Failure path: wake any blocked producer/consumer (the Python
        queue relies on the 50 ms poll; the native ring wakes instantly)."""


class NativeInbox:
    """Inbox over the C++ blocking ring (native/wf_native.cpp NativeQueue):
    blocking push/pop wait on a futex with the GIL released instead of the
    Python queue's 50 ms timeout polling.  Batch objects never cross the
    ABI — they sit in a side table keyed by the slot id the ring carries
    (the payload-pointer discipline of FastFlow's SPSC queues)."""

    def __init__(self, capacity: int, failed: threading.Event = None,
                 lib=None, policy: OverloadPolicy = None):
        self._lib = lib
        self._failed = failed
        self._h = lib.wf_queue_new(capacity)
        self._items = {}
        self._seq = 0
        self._seq_lock = threading.Lock()
        self.n_sources = 0
        self._policy = policy if (policy is not None
                                  and policy.reshapes_put) else None
        self.shed = 0
        self._shed_lock = threading.Lock()
        self.hwm = 0         # see Inbox: observed-dataflow occupancy mark
        self._track = False
        self._put_ns = None  # see Inbox: per-slot ns inside put

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            # wf_queue_free closes first and spins until the last blocked
            # thread has left push/pop before destroying the mutex
            self._lib.wf_queue_free(h)
            self._h = None

    def register_source(self) -> int:
        slot = self.n_sources
        self.n_sources += 1
        return slot

    def _slot_for(self, item) -> int:
        with self._seq_lock:
            self._seq += 1
            slot = self._seq
        self._items[slot] = item
        return slot

    def _push(self, src: int, item):
        slot = self._slot_for(item)
        if self._lib.wf_queue_push(self._h, src, slot) != 0:
            self._items.pop(slot, None)
            raise _Cancelled()

    def _record_shed(self):
        with self._shed_lock:
            self.shed += 1

    def put(self, src: int, item):
        put_ns = self._put_ns
        if put_ns is not None:
            stamp = _tl_stamp()
            t0 = _pc_ns()
        pol = self._policy
        if pol is None:
            self._push(src, item)
        elif pol.shed == "shed_newest":
            lim = pol.soft_limit
            if lim is not None and len(self._items) >= lim:
                # adaptive soft limit (see Inbox.put): drop before full.
                # This path never touches the ring, so it must observe a
                # failed graph itself or an unbounded source spins forever
                if self._failed is not None and self._failed.is_set():
                    raise _Cancelled()
                self._record_shed()
            else:
                slot = self._slot_for(item)
                rc = self._lib.wf_queue_try_push(self._h, src, slot)
                if rc != 0:
                    self._items.pop(slot, None)
                    if rc < 0:
                        raise _Cancelled()
                    self._record_shed()
        elif pol.shed == "shed_oldest":
            self._put_shed_oldest(src, self._slot_for(item))
        else:  # block with a deadline
            slot = self._slot_for(item)
            rc = self._lib.wf_queue_push_timed(
                self._h, src, slot, int(pol.put_deadline * 1000))
            if rc != 0:
                self._items.pop(slot, None)
                if rc < 0:
                    raise _Cancelled()
                raise OverloadError(
                    f"inbox put blocked longer than the "
                    f"{pol.put_deadline}s deadline (native ring): "
                    f"downstream stage is not keeping up")
        if self._track:
            depth = len(self._items)
            if depth > self.hwm:
                self.hwm = depth
        if put_ns is not None:
            put_ns[src] += _pc_ns() - t0
            if stamp is not None:
                _tl_record("put_wait", stamp)

    def depth(self) -> int:
        """Occupancy proxy: the payload side table holds exactly the
        items whose slot ids sit in the ring (plus any mid-handoff)."""
        return len(self._items)

    def _put_shed_oldest(self, src: int, slot: int):
        import ctypes
        lib = self._lib
        vsrc = ctypes.c_longlong()
        vslot = ctypes.c_longlong()
        while True:
            lim = self._policy.soft_limit
            if lim is None or len(self._items) < lim + 1:
                # +1: our own slot already sits in the side table
                rc = lib.wf_queue_try_push(self._h, src, slot)
                if rc == 0:
                    return
                if rc < 0:
                    self._items.pop(slot, None)
                    raise _Cancelled()
            # full: evict the head to admit the new item (EOS survives —
            # re-queued at the tail, see Inbox._put_shed_oldest)
            rc2 = lib.wf_queue_try_pop(self._h, ctypes.byref(vsrc),
                                       ctypes.byref(vslot))
            if rc2 < 0:
                self._items.pop(slot, None)
                raise _Cancelled()
            if rc2 == 1:
                continue    # consumer drained it meanwhile; retry the push
            victim = self._items.pop(vslot.value)
            if victim is _EOS or is_ctrl_payload(victim):
                # control frames survive eviction (see Inbox)
                self._push(vsrc.value, victim)
                _sleep(0.001)   # see Inbox._put_shed_oldest: no hot spin
            else:
                self._record_shed()

    def put_eos(self, src: int):
        self._push(src, _EOS)

    def put_ctrl(self, src: int, item):
        """Policy-exempt blocking push for control frames (see Inbox)."""
        self._push(src, item)

    def get(self):
        import ctypes
        src = ctypes.c_longlong()
        slot = ctypes.c_longlong()
        if self._lib.wf_queue_pop(self._h, ctypes.byref(src),
                                  ctypes.byref(slot)) != 0:
            raise _Cancelled()
        return src.value, self._items.pop(slot.value)

    def cancel(self):
        self._lib.wf_queue_close(self._h)


def _make_inbox(capacity: int, failed: threading.Event,
                policy: OverloadPolicy = None):
    if capacity > 0:  # capacity 0 = unbounded, which only the Python
        from ..native import enabled  # queue implements
        lib = enabled()
        if lib is not None and (
                policy is None or not policy.reshapes_put
                or getattr(lib, "wf_has_overload_queue", False)):
            # an old .so without the overload entry points still serves
            # every default path; only active shed/deadline knobs fall
            # back to the Python queue
            return NativeInbox(capacity, failed, lib=lib, policy=policy)
    return Inbox(capacity, failed, policy)


class Dataflow:
    """A graph of nodes executed by one thread per node
    (MultiPipe::run_and_wait_end spawns cardinality()-1 threads,
    multipipe.hpp:1010; same model here)."""

    #: valid ``check=`` modes (docs/CHECKS.md): None/'off' = seed
    #: behavior, the check package is never imported; 'warn' = run the
    #: static validator at run() and report diagnostics as warnings;
    #: 'error' = additionally raise CheckError (before any thread
    #: starts) when an error-severity diagnostic survives suppression
    CHECK_MODES = (None, "off", "warn", "error")

    def __init__(self, name: str = "dataflow", capacity: int = 16,
                 trace_dir: str = None, overload: OverloadPolicy = None,
                 metrics=None, sample_period: float = None,
                 recovery=None, check: str = None, control=None,
                 trace=None, federate=None):
        # bounded inboxes give natural backpressure (FastFlow's
        # FF_BOUNDED_BUFFER, the yahoo Makefile default): a source cannot
        # run unboundedly ahead of a slow consumer, keeping queue latency
        # proportional to capacity x batch size.  0 = unbounded.
        # `overload` (runtime/overload.py) opts the graph into shedding /
        # put deadlines / poison-tuple quarantine; None = seed behavior.
        # `metrics` (a MetricsRegistry, or truthy for a fresh one) and
        # `sample_period` (seconds; also the WF_SAMPLE_PERIOD env hook)
        # opt into the observability layer (docs/OBSERVABILITY.md):
        # a background sampler owned by this graph writes
        # <trace_dir>/metrics.jsonl and a structured event log writes
        # <trace_dir>/events.jsonl.  Both unset = no thread, no files,
        # and inbox hot paths keep a single disabled branch.
        from ..utils.tracing import default_sample_period, default_trace_dir
        if overload is not None and overload.reshapes_put and capacity <= 0:
            # an unbounded queue never fills: every shed/deadline knob
            # would be silently inert while memory grows without bound
            raise ValueError(
                f"OverloadPolicy with shed={overload.shed!r}/"
                f"put_deadline={overload.put_deadline} needs a bounded "
                f"inbox (capacity > 0, got {capacity}): an unbounded "
                f"queue never sheds and never times out")
        # `recovery` (recovery/policy.RecoveryPolicy) opts the graph into
        # epoch checkpoints + supervised node restart (docs/ROBUSTNESS.md
        # "Recovery"); None = seed behavior: no markers, no journals, no
        # supervisor thread, one dead branch on the emit hot path.
        if recovery is not None:
            from ..recovery.policy import RecoveryPolicy
            if not isinstance(recovery, RecoveryPolicy):
                raise TypeError(f"recovery= wants a RecoveryPolicy, got "
                                f"{type(recovery).__name__}")
        if check not in self.CHECK_MODES:
            raise ValueError(f"check= wants one of {self.CHECK_MODES}, "
                             f"got {check!r}")
        # `control` (control/policy.ControlPolicy) opts the graph into the
        # closed-loop control plane (docs/CONTROL.md): a controller fed by
        # the observability sampler drives elastic rescale, adaptive
        # shedding, and source admission.  None = seed behavior, and the
        # control package is never imported (same contract as check=).
        if control is not None:
            from ..control.policy import ControlPolicy
            if not isinstance(control, ControlPolicy):
                raise TypeError(f"control= wants a ControlPolicy, got "
                                f"{type(control).__name__}")
            if control.has_rescale and recovery is None:
                # a rescale seals at an epoch barrier; without recovery=
                # no source ever injects a marker, so the rule could
                # never fire — refuse the silently-inert pair outright
                # (check/ reports it as WF211 on a not-yet-built
                # MultiPipe, mirroring the WF208 split)
                raise ValueError(
                    f"[WF211] Dataflow {name!r}: control= has Rescale "
                    f"rules but recovery= is unset — live rescale seals "
                    f"at epoch barriers, which only a RecoveryPolicy's "
                    f"epoch triggers inject (docs/CONTROL.md)")
        self.control = control
        self._controller = None
        #: rescalable-farm registry stamped by runtime/farm.py at wiring
        #: time: {"pattern", "rule", "emitter", "workers", "width"} per
        #: farm a Rescale rule targets (inert metadata when control is
        #: unset — nothing reads it)
        self._farms: list[dict] = []
        self.name = name
        self.capacity = capacity
        self.trace_dir = trace_dir or default_trace_dir()
        self.overload = overload
        self.recovery = recovery
        #: pre-flight static-analysis mode (docs/CHECKS.md); run() defers
        #: to check/ lazily, so the unset default never imports it
        self.check = check
        self._supervisor = None
        #: callbacks fired (epoch:int) each time the supervisor seals a
        #: checkpoint epoch manifest — the hook the resumable row plane
        #: uses to ack sealed epochs back to remote senders so their
        #: journals trim (docs/ROBUSTNESS.md "Wire resume").  Read live
        #: by Supervisor._seal_ready, so registration after run() works.
        self._seal_listeners: list = []
        if sample_period is None:
            sample_period = default_sample_period()
        if sample_period is not None and float(sample_period) <= 0:
            raise ValueError(f"sample_period must be positive seconds, "
                             f"got {sample_period}")
        self.sample_period = sample_period
        self._sampler = None
        # truthiness, not `is not None`: metrics=False/0 must mean OFF
        # (docs/OBSERVABILITY.md — "any truthy value for a fresh one")
        if metrics or sample_period is not None:
            if not self.trace_dir:
                # the silent no-op (WF207): the sampler and
                # event log run, but with no resolvable directory no
                # metrics.jsonl/events.jsonl is ever written.  Warn once
                # per graph, here at construction, naming the missing
                # knob — the string carries the WF id so the message and
                # the check/ diagnostic stay greppable as one, without
                # importing check/ on this path.
                import warnings
                warnings.warn(
                    f"[WF207] Dataflow {name!r}: metrics=/sample_period= "
                    f"is set but no trace_dir resolves (trace_dir= or "
                    f"WF_LOG_DIR) — the live registry works, but "
                    f"metrics.jsonl/events.jsonl will not be written",
                    stacklevel=2)
            from ..obs import EventLog, MetricsRegistry
            #: live metrics registry shared with channels/user functions
            self.metrics = (metrics if isinstance(metrics, MetricsRegistry)
                            else MetricsRegistry())
            #: structured runtime event log (file iff trace_dir is set;
            #: the file opens lazily, so a never-run preview graph
            #: creates nothing on disk)
            self.events = EventLog(
                os.path.join(self.trace_dir, "events.jsonl")
                if self.trace_dir else None)
        else:
            self.metrics = None
            self.events = None
        # `trace` (obs/trace.TracePolicy, or a sample-rate fraction; any
        # falsy value = OFF) opts the graph into end-to-end span tracing
        # (docs/OBSERVABILITY.md §tracing): a sampled fraction of source
        # batches carries a trace context, every traversed node records
        # queue-wait + service spans, device launches become child spans,
        # and <trace_dir>/trace.jsonl feeds scripts/wf_trace.py.  Unset
        # means the obs.trace module is never imported — the same
        # contract as check=/control=.
        if trace:
            from ..obs.trace import Tracer, as_policy
            self.trace = as_policy(trace)
            if not self.trace_dir:
                # the WF207 shape of silent no-op (docs/CHECKS.md
                # WF213): spans stay in the bounded in-memory ring and
                # trace.jsonl is never written.  The live percentile
                # sensors still work, so this is a warning, not an
                # error — but it is almost always a missing trace_dir.
                import warnings
                warnings.warn(
                    f"[WF213] Dataflow {name!r}: trace= is set but no "
                    f"trace_dir resolves (trace_dir= or WF_LOG_DIR) — "
                    f"sampled spans stay in the in-memory ring and "
                    f"trace.jsonl is never written", stacklevel=2)
            #: per-graph span tracer; file opens lazily, so a never-run
            #: preview graph still creates nothing on disk
            self.tracer = Tracer(self.name, self.trace,
                                 trace_dir=self.trace_dir,
                                 metrics=self.metrics, events=self.events)
            from ..obs.trace import Stamped as _StampedCls
            self._Stamped = _StampedCls
        else:
            self.trace = None
            self.tracer = None
            self._Stamped = None
        # `federate` (obs/federation.FederationPolicy, or True; any
        # falsy value = OFF) opts the process into the plane-wide
        # telemetry tier (docs/OBSERVABILITY.md "Federation & SLOs"): a
        # shipper rides the sampler and ships compact snapshots over
        # the row plane's -8 frames (once the app binds the plane's
        # senders, `df.federation.bind(senders)`), local SLO objectives
        # evaluate per sample, and the black-box flight recorder dumps
        # the bounded in-memory rings on node_error / recovery give-up.
        # Unset means obs.federation / obs.slo are never imported and
        # no -8 frame is ever sent — the same contract as trace=.
        if federate:
            from ..obs.federation import as_policy as _fed_as_policy
            self.federate = _fed_as_policy(federate)
            if self.metrics is None:
                # the shipper's only source is the sampler: with
                # neither metrics= nor sample_period= no snapshot is
                # ever built and the whole tier is silently inert —
                # the WF209 shape of silent no-op, warned once here
                # and reported by check/ as WF217 (docs/CHECKS.md)
                import warnings
                warnings.warn(
                    f"[WF217] Dataflow {name!r}: federate= is set but "
                    f"neither metrics= nor sample_period= is — the "
                    f"shipper's only source is the sampler, so nothing "
                    f"is ever shipped and federation is inert",
                    stacklevel=2)
        else:
            self.federate = None
        #: the live FederationShipper (built in run(), before the node
        #: threads, when federate= and metrics= are both set); apps bind
        #: the row plane with ``df.federation.bind(senders)``
        self.federation = None
        self._blackbox = None
        if control is not None and self.metrics is None:
            # the controller's only sensor is the sampler (obs/sampler.py
            # subscription); with neither metrics= nor sample_period= it
            # never receives a snapshot and every rule is silently inert
            # — the WF207 shape of silent no-op, warned once here and
            # reported by check/ as WF209 (docs/CHECKS.md)
            import warnings
            warnings.warn(
                f"[WF209] Dataflow {name!r}: control= is set but neither "
                f"metrics= nor sample_period= is — the controller is "
                f"blind (no sampler snapshots) and no rule will ever "
                f"fire", stacklevel=2)
        self.nodes: list[Node] = []
        self._inboxes: dict[int, Inbox] = {}
        self._edges: list[tuple[Node, Node]] = []
        self._threads: list[threading.Thread] = []
        self._errors: list[BaseException] = []
        self._failed = threading.Event()
        #: quarantined poison batches (DeadLetter records, arrival order);
        #: inspect after wait() — only ever populated when an error budget
        #: is set (overload.error_budget or a node/pattern-level budget)
        self.dead_letters: list[DeadLetter] = []
        self._dead_lock = threading.Lock()
        self._stop_logged = False

    def _inbox_policy(self, node: Node) -> OverloadPolicy:
        """Shedding applies only at shed-safe inboxes (farm heads and
        stateless operators — dropping there means dropping raw stream
        items).  Internal farm edges (window multicast copies, dense-id
        result streams, ordering merges) keep blocking, so overload
        backpressures through them to the nearest shed-safe inbox
        upstream instead of silently corrupting window state.  A put
        deadline (block policy) is loud, not lossy, so it applies
        everywhere."""
        pol = self.overload
        if (pol is not None and pol.shed != "block"
                and not getattr(node, "shed_safe", False)):
            return None
        return pol

    def add(self, node: Node, ctx: RuntimeContext = None) -> Node:
        if ctx is not None:
            node.ctx = ctx
        self.nodes.append(node)
        inbox = _make_inbox(self.capacity, self._failed,
                            self._inbox_policy(node))
        if self.metrics is not None or self.sample_period is not None:
            inbox._track = True  # maintain the occupancy high-water mark
        if self.trace_dir:
            inbox._put_ns = defaultdict(int)   # the producers' put waits
        self._inboxes[id(node)] = inbox
        return node

    def connect(self, src: Node, dst: Node):
        """Add an edge; the order of connect() calls from one src defines its
        output-channel indexing (emit_to)."""
        inbox = self._inboxes[id(dst)]
        slot = inbox.register_source()
        src._outputs.append((inbox, slot))
        self._edges.append((src, dst))

    def on_epoch_sealed(self, fn):
        """Register ``fn(epoch)`` to fire each time the recovery
        supervisor seals a checkpoint epoch (every expected node's blob
        committed).  This is the durability boundary a resumable wire
        edge cares about: wiring ``receiver.ack_epoch`` here acks
        sealed epochs back to remote RowSenders so their replay
        journals trim (docs/ROBUSTNESS.md "Wire resume").  Listeners
        run on the checkpoint-writer thread; exceptions are swallowed
        (a telemetry hook must not fail a seal).  Requires
        ``recovery=`` with a checkpoint_dir — without a store nothing
        ever seals, so the hook never fires.  Returns ``fn`` for
        decorator use."""
        self._seal_listeners.append(fn)
        return fn

    def request_drain(self, timeout: float = None) -> bool:
        """Gate every source and wait for the in-flight work to settle
        (the quiesce leg of a rolling restart, docs/ROBUSTNESS.md
        "Cross-host recovery").  Requires a running graph with a
        ``control=`` policy declaring a :class:`~windflow_tpu_torch.control.
        Drain` rule; returns whether the graph fully quiesced within
        the deadline.  Pair with :meth:`release_drain`."""
        if self._controller is None:
            raise RuntimeError(
                "request_drain() needs a running dataflow with "
                "control=ControlPolicy([..., Drain(...)]) — call after "
                "run() (docs/CONTROL.md)")
        return self._controller.request_drain(timeout)

    def release_drain(self):
        """Reopen the source gate closed by :meth:`request_drain`."""
        if self._controller is None:
            raise RuntimeError(
                "release_drain() needs a running dataflow with "
                "control=ControlPolicy([..., Drain(...)])")
        self._controller.release_drain()

    # ------------------------------------------------------------------ run

    def _error_budget_of(self, node: Node) -> int:
        """Effective poison-tuple allowance: node-level override first
        (builders' withErrorBudget / a pattern's error_budget, propagated
        onto replicas by runtime/farm.py), then the dataflow policy —
        except for quarantine-exempt framework shells (emitters,
        collectors, ordering merges), which never inherit the policy
        default: an error there is a framework bug, not a poison tuple."""
        budget = getattr(node, "error_budget", None)
        if budget is None:
            if getattr(node, "quarantine_exempt", False):
                return 0
            budget = (self.overload.error_budget
                      if self.overload is not None else 0)
        return int(budget)

    def _quarantine(self, node: Node, batch, channel: int,
                    error: BaseException):
        letter = DeadLetter(node.name, batch, channel, error)
        with self._dead_lock:
            self.dead_letters.append(letter)
        if node.stats is not None:
            node.stats.record_quarantined()
        if self.events is not None:
            self.events.emit("quarantine", dataflow=self.name,
                             **letter.to_event())

    def _run_node(self, node: Node):
        events = self.events
        tracer = self.tracer
        _Stamped = self._Stamped
        try:
            node.n_input_channels = self._inboxes[id(node)].n_sources
            if self.trace_dir or self.metrics is not None \
                    or self.sample_period is not None \
                    or tracer is not None:
                from ..utils.tracing import node_stats_name
                # index disambiguates same-named nodes (two 'map.0' stages)
                idx = self.nodes.index(node)
                node._hop_id = node_stats_name(self.name, idx, node.name)
            if self.trace_dir or self.metrics is not None \
                    or self.sample_period is not None:
                from ..utils.tracing import NodeStats
                # operator states only for the node logs, their reader
                node.stats = NodeStats(node._hop_id,
                                       states=bool(self.trace_dir))
            if tracer is not None:
                # span-sampling hooks (obs/trace.py): sources make the
                # sampling/adoption decision at emit; every node wraps
                # traced emissions for the inbox crossing (Comb forwards
                # these onto its fused stages in svc_init)
                node._tracer = tracer
                node._trace_origin = isinstance(node, SourceNode)
            if self.metrics is not None:
                # rich user functions may bump custom metrics through
                # their RuntimeContext (ctx.metrics.counter(...).inc())
                node.ctx.metrics = self.metrics
            if events is not None:
                events.emit("node_start", dataflow=self.name,
                            node=node.name,
                            source=isinstance(node, SourceNode))
            node.svc_init()
            supervised = (node._recov is not None
                          and not isinstance(node, SourceNode))
            if isinstance(node, SourceNode):
                if node._recov is not None:
                    # sequence-tag emissions + epoch-marker injection
                    # (recovery/epoch.py); sources are not restartable —
                    # a generate() failure propagates exactly as today
                    node._recov.begin(len(node._outputs), 0, 0)
                if node.stats is None or not node.stats.states:
                    node.generate()
                else:
                    t0 = _pc_ns()
                    node.generate()
                    node.stats.generate_ns_total = _pc_ns() - t0
            elif supervised:
                self._run_supervised(node, events)
            else:
                inbox = self._inboxes[id(node)]
                live = inbox.n_sources
                stats = node.stats
                states = stats is not None and stats.states
                budget = self._error_budget_of(node)
                while live > 0:
                    if not states:
                        src, item = inbox.get()
                    else:
                        src, item = self._timed_get(inbox, stats)
                    if item is _EOS:
                        live -= 1
                        if tracer is not None:
                            # channel-EOS flushes (ordering drains, farm
                            # collector merges) are not attributable to
                            # any sampled batch: clear the previous
                            # iteration's span before they emit
                            tracer.set_current(None)
                        node.on_channel_eos(src)
                        if events is not None:
                            events.emit("eos", dataflow=self.name,
                                        node=node.name, channel=src,
                                        live=live)
                        continue
                    ctx = None
                    if tracer is not None:
                        # unwrap a traced batch and expose its span to
                        # this svc call's emissions via the thread-local
                        # (set for EVERY batch — a stale ctx must never
                        # leak onto the next, untraced one)
                        if type(item) is _Stamped:
                            item, ctx, parent, span, q_ns = \
                                tracer.incoming(item)
                            tracer.set_current(ctx, span, node._hop_id)
                        else:
                            tracer.set_current(None)
                    timed = stats is not None or ctx is not None
                    if budget > 0:
                        # poison-tuple quarantine: an svc error within
                        # budget parks the batch in the dead-letter queue
                        # and the node lives on; once the budget is spent
                        # the next error fails fast exactly like default
                        try:
                            if timed:
                                stamp = _tl_stamp()
                                t0 = _pc_ns()
                                node.svc(item, src)
                                dt = _pc_ns() - t0
                                if stats is not None:
                                    stats.record_svc(len(item), dt)
                                if stamp is not None:
                                    _tl_record("svc:" + node.name, stamp)
                            else:
                                node.svc(item, src)
                        except OverloadError:
                            # a put deadline expiring inside svc's emit is
                            # backpressure failure, not a poison tuple —
                            # it must fail fast, not burn the budget
                            raise
                        except Exception as e:  # _Cancelled passes through
                            budget -= 1
                            self._quarantine(node, item, src, e)
                            continue    # no span: the batch died here
                    elif timed:
                        stamp = _tl_stamp()
                        t0 = _pc_ns()
                        node.svc(item, src)
                        dt = _pc_ns() - t0
                        if stats is not None:
                            stats.record_svc(len(item), dt)
                        if stamp is not None:
                            _tl_record("svc:" + node.name, stamp)
                    else:
                        node.svc(item, src)
                    if ctx is not None:
                        tracer.record_hop(ctx, node._hop_id, span, parent,
                                          q_ns, dt, len(item))
            if tracer is not None:
                # EOS flushes are not attributable to any sampled batch:
                # clear the thread-local so the last traced batch's span
                # cannot leak onto eosnotify emissions
                tracer.set_current(None)
            if not supervised:
                # the supervised loop already ran eosnotify inside its
                # restart-protected region (a flush crash restores +
                # replays + re-flushes)
                node.eosnotify()
            node.svc_end()
            if node.stats is not None:
                if node.stats.states:
                    node.stats.put_wait_ns_total = blocked_put_ns(
                        node._outputs)
                shed = getattr(self._inboxes[id(node)], "shed", 0)
                if shed:
                    node.stats.record_shed(shed)
                if self.trace_dir:
                    node.stats.write(self.trace_dir)
            if events is not None:
                stop = {"dataflow": self.name, "node": node.name}
                if node.stats is not None:
                    stop["rcv_batches"] = node.stats.rcv_batches
                    stop["rcv_tuples"] = node.stats.rcv_tuples
                    stop.update({k: v for k, v
                                 in node.stats.counters.items()
                                 if k not in ("t", "event")})
                events.emit("node_stop", **stop)
        except _Cancelled:
            pass  # the graph failed elsewhere; exit quietly
        except BaseException as e:  # propagate to run_and_wait_end
            self._errors.append(e)
            self._failed.set()  # unblock producers stuck on our inbox
            if events is not None:
                events.emit("node_error", dataflow=self.name,
                            node=node.name, error=type(e).__name__,
                            message=str(e))
            if self._blackbox is not None:
                # flight recorder (docs/OBSERVABILITY.md "Federation &
                # SLOs"): dump the bounded rings while they still hold
                # the moments before the failure
                self._blackbox.dump("node_error", failed_node=node.name,
                                    error=type(e).__name__,
                                    message=str(e))
            for inbox in self._inboxes.values():
                inbox.cancel()  # native rings wake instantly
        finally:
            try:
                for inbox, src in node._outputs:
                    inbox.put_eos(src)
            except _Cancelled:
                pass

    # ----------------------------------------------------------- recovery
    # The supervised receive loop (docs/ROBUSTNESS.md "Recovery"): only
    # entered when `recovery=` is set, so the seed loop above stays
    # byte-identical.  Items arrive as Tagged envelopes (per-edge seq
    # numbers, recovery/epoch.py); epoch barrier markers align across
    # input channels Chandy-Lamport style; on alignment the node drains
    # device queues (checkpoint_prepare), snapshots, and forwards the
    # marker; on failure the Supervisor authorizes restore-last-snapshot
    # + journal replay on this same thread, under the restart budget.

    def _run_supervised(self, node: Node, events):
        rec = node._recov
        inbox = self._inboxes[id(node)]
        rec.begin(len(node._outputs), inbox.n_sources,
                  self._error_budget_of(node))
        # epoch-0 snapshot: a crash before the first barrier must still
        # have a restore point (state fresh out of svc_init)
        self._checkpoint_node(node, rec, events, 0)
        restoring = False
        states = node.stats is not None and node.stats.states
        while True:
            try:
                if restoring:
                    # inside the protected region: a deterministic fault
                    # re-hit DURING replay burns another restart from
                    # the budget instead of tearing the graph down
                    restoring = False
                    self._restore_and_replay(node, rec, events)
                while rec.live > 0:
                    if not states:
                        src, item = inbox.get()
                    else:
                        src, item = self._timed_get(inbox, node.stats)
                    if self._dispatch_supervised(node, rec, events, src,
                                                 item):
                        self._complete_barriers(node, rec, events)
                if self.tracer is not None:
                    # EOS flushes are not attributable to any sampled
                    # batch (see the seed loop)
                    self.tracer.set_current(None)
                node.eosnotify()
                return
            except (_Cancelled, OverloadError):
                # graph failed elsewhere / backpressure deadline: both
                # must fail exactly like the seed engine (a restart
                # would re-block on the same saturated downstream)
                raise
            except Exception as e:
                if getattr(e, "wf_no_restart", False):
                    # e.g. a failed rescale migration (control/rescale.py)
                    # left SIBLING workers' state inconsistent: restoring
                    # this node alone cannot fix the farm — fail the
                    # graph like the seed engine
                    raise
                if not self._supervisor.authorize_restart(node, rec, e):
                    raise
                restoring = True

    @staticmethod
    def _timed_get(inbox, stats):
        """inbox.get(), its time added to the node's idle wait for input."""
        stamp = _tl_stamp()
        t0 = _pc_ns()
        got = inbox.get()
        stats.wait_in_ns_total += _pc_ns() - t0
        if stamp is not None:
            _tl_record("wait_in", stamp)
        return got

    def _dispatch_supervised(self, node: Node, rec, events, src, item,
                             lvl: int = None) -> bool:
        """Handle one inbox item; True when barrier alignment may have
        advanced (the caller then completes any ready barriers — kept
        out of this function so a held-item drain can't checkpoint
        mid-iteration).  ``lvl`` is the item's channel epoch level at
        ARRIVAL: None for a fresh inbox item (the current level), an
        explicit value when replaying from the journal — replay must
        repeat the original hold-or-process decisions, and the restored
        ``chan_epoch`` only knows the commit-time (possibly later)
        level."""
        if item is _EOS:
            if lvl is None:
                lvl = rec.chan_epoch.get(src, 0)
            rec.journal_append(src, item, lvl)
            if lvl > rec.epoch:
                # the channel ran ahead of the node's epoch and its data
                # is held back — processing its EOS now would lift
                # order-sensitive consumers' watermarks past the held
                # rows, so the EOS waits its turn in arrival order
                rec.held.append((src, item, lvl))
                return False
            rec.live -= 1
            rec.eos.add(src)
            if self.tracer is not None:
                self.tracer.set_current(None)   # see the seed loop
            node.on_channel_eos(src)
            if events is not None:
                events.emit("eos", dataflow=self.name, node=node.name,
                            channel=src, live=rec.live)
            return True
        if type(item) is Tagged:
            seq, payload = item.seq, item.payload
            stale = seq <= rec.last_seen.get(src, -1)
        else:
            payload = item
            stale = False
        if type(payload) is EpochMarker:
            # markers apply EVEN when their seq is stale: a shed_oldest
            # eviction re-queues a marker at the inbox tail, behind
            # later same-channel seqs — dropping it as a duplicate
            # would stall barrier alignment forever.  The update is a
            # monotone max, so re-applying a truly replayed marker is
            # harmless.
            if not stale:
                rec.journal_append(src, item, 0)
                if type(item) is Tagged:
                    rec.last_seen[src] = item.seq
            if payload.epoch > rec.chan_epoch.get(src, 0):
                rec.chan_epoch[src] = payload.epoch
            return True
        if stale:
            return False            # duplicate from a restarted producer
        if lvl is None:
            lvl = rec.chan_epoch.get(src, 0)
        rec.journal_append(src, item, lvl)
        if type(item) is Tagged:
            rec.last_seen[src] = item.seq
        if lvl > rec.epoch:
            # this channel is past the node's epoch: hold its data back
            # until the barrier completes, so the snapshot is a
            # consistent cut.  ``lvl`` pins the item's content epoch
            # (lvl+1) — the barrier drain orders by it, since the
            # channel's CURRENT epoch may advance further meanwhile.
            rec.held.append((src, item, lvl))
            return False
        self._svc_supervised(node, rec, src, payload)
        return False

    def _apply_held(self, node: Node, rec, events, src, item):
        """Process one held-back item: already deduped and journaled on
        first receipt, and its turn has come — no further checks."""
        if item is _EOS:
            rec.live -= 1
            rec.eos.add(src)
            if self.tracer is not None:
                self.tracer.set_current(None)   # see the seed loop
            node.on_channel_eos(src)
            if events is not None:
                events.emit("eos", dataflow=self.name, node=node.name,
                            channel=src, live=rec.live)
            return
        payload = item.payload if type(item) is Tagged else item
        self._svc_supervised(node, rec, src, payload)

    def _svc_supervised(self, node: Node, rec, src, payload):
        """svc + stats + poison-tuple quarantine, mirroring the seed
        loop; budget lives on the recovery record so restarts restore
        it with the snapshot.  Traced batches (obs/trace.py Stamped —
        the recovery envelope wraps outside it, so held-back and
        journal-replayed items arrive here still stamped) unwrap and
        record their hop span; a replayed hop re-records honestly, with
        the restore time inside its queue wait."""
        stats = node.stats
        tracer = self.tracer
        ctx = None
        if tracer is not None:
            if type(payload) is self._Stamped:
                payload, ctx, parent, span, q_ns = \
                    tracer.incoming(payload)
                tracer.set_current(ctx, span, node._hop_id)
            else:
                tracer.set_current(None)
        timed = stats is not None or ctx is not None
        if rec.budget > 0:
            try:
                if timed:
                    stamp = _tl_stamp()
                    t0 = _pc_ns()
                    node.svc(payload, src)
                    dt = _pc_ns() - t0
                    if stats is not None:
                        stats.record_svc(len(payload), dt)
                    if stamp is not None:
                        _tl_record("svc:" + node.name, stamp)
                else:
                    node.svc(payload, src)
            except OverloadError:
                raise
            except Exception as e:
                rec.budget -= 1
                if rec.requarantine_skip > 0:
                    # journal replay re-raising on an already-
                    # quarantined batch: spend the budget again (the
                    # snapshot restored it) but don't duplicate the
                    # dead letter / event the original pass recorded
                    rec.requarantine_skip -= 1
                else:
                    rec.quarantined += 1
                    self._quarantine(node, payload, src, e)
                return      # no span: the batch died here
        elif timed:
            stamp = _tl_stamp()
            t0 = _pc_ns()
            node.svc(payload, src)
            dt = _pc_ns() - t0
            if stats is not None:
                stats.record_svc(len(payload), dt)
            if stamp is not None:
                _tl_record("svc:" + node.name, stamp)
        else:
            node.svc(payload, src)
        if ctx is not None:
            tracer.record_hop(ctx, node._hop_id, span, parent, q_ns, dt,
                              len(payload))

    def _complete_barriers(self, node: Node, rec, events):
        while True:
            epoch = rec.barrier_ready()
            if epoch is None:
                return
            if epoch == "eos":
                # every channel reached EOS: no further barrier can
                # complete, so the remaining held items process now, in
                # arrival order, ahead of the EOS flush (EOS aligns a
                # channel to every epoch)
                rec.epoch = max(rec.chan_epoch.values(),
                                default=rec.epoch)
                pending, rec.held = rec.held, []
                for src, item, _lvl in pending:
                    self._apply_held(node, rec, events, src, item)
                continue
            # a held item at level L is content of epoch L+1.  When the
            # barrier min jumps several epochs at once (a lagging
            # channel EOSing, wire sources skipping epochs), items with
            # L < epoch are content the epoch-`epoch` snapshot claims to
            # cover — they process BEFORE it; items at exactly L ==
            # epoch open the next epoch and process after the marker.
            early = [(s, i) for s, i, l in rec.held if l < epoch]
            # keep the still-unprocessed items in rec.held through the
            # checkpoint: commit() journals exactly this set
            rec.held = [(s, i, l) for s, i, l in rec.held if l >= epoch]
            for src, item in early:
                self._apply_held(node, rec, events, src, item)
            self._checkpoint_node(node, rec, events, epoch)
            hook = node._ctl_epoch_hook
            if hook is not None:
                # control plane (docs/CONTROL.md): a pending live rescale
                # seals HERE — after the snapshot committed and the
                # marker went downstream, before any post-barrier item
                # processes, so the migration cut is exactly this epoch
                hook(epoch)
            if events is not None:
                events.emit("epoch", dataflow=self.name,
                            node=node.name, epoch=epoch)
            now = [(s, i) for s, i, l in rec.held if l <= epoch]
            rec.held = [(s, i, l) for s, i, l in rec.held if l > epoch]
            for src, item in now:
                self._apply_held(node, rec, events, src, item)

    def _checkpoint_node(self, node: Node, rec, events, epoch: int):
        """Snapshot one node at a completed barrier: drain async device
        work (its results pre-date the barrier), snapshot state, commit
        in-memory, and hand the blob to the supervisor's writer."""
        t0 = _monotonic()
        if self.tracer is not None:
            # barrier drains are not attributable to any sampled batch
            # (the EOS-flush rule): without this clear, the LAST
            # processed batch's span would leak onto every
            # checkpoint_prepare emission below
            self.tracer.set_current(None)
        for out in (node.checkpoint_prepare() or ()):
            if out is not None and len(out):
                node.emit(out)
        if epoch > 0:
            pre = node._ctl_seal_hook
            if pre is not None:
                # control plane: a farm emitter ANNOUNCES a pending
                # rescale's seal epoch before the marker leaves, so a
                # worker racing ahead on the marker always finds the
                # seal already published (control/rescale.py)
                pre(epoch)
            # forward the barrier BEFORE committing, so the snapshot's
            # output sequence counters include the marker — a restored
            # node's first re-emission must not collide with the
            # marker's seq (downstream would drop it as a duplicate)
            rec.forward_marker(node._outputs, epoch)
        if not rec.journaling:
            # non-snapshotable node: just track the epoch so held-back
            # items and marker forwarding stay aligned
            rec.epoch = epoch
            return
        try:
            state = node.state_snapshot()
        except SnapshotUnsupported as e:
            rec.mark_unrecoverable(str(e) or type(e).__name__)
            rec.epoch = epoch
            return
        rec.commit(epoch, state)
        self._supervisor.note_checkpoint(node, rec, epoch,
                                         _monotonic() - t0)
        self._supervisor.enqueue_blob(rec, epoch, state)
        if self.tracer is not None:
            # control-plane span (obs/trace.py): the barrier stall this
            # node's traced batches sat behind, on the Perfetto timeline
            self.tracer.record_ctrl(node._hop_id or node.name,
                                    "checkpoint", epoch,
                                    _monotonic() - t0)

    def _restore_and_replay(self, node: Node, rec, events):
        t0 = _monotonic()
        node_state, todo = rec.restore()
        replayed = -1      # -1: state_restore itself not yet done
        try:
            node.state_restore(node_state)
            replayed = 0
            for src, item, lvl in todo:
                if self._dispatch_supervised(node, rec, events, src, item,
                                             lvl=lvl):
                    self._complete_barriers(node, rec, events)
                replayed += 1
        except BaseException:
            # a fault re-hit mid-replay: the crashing item is already
            # back in the journal (dispatch appends before handling) —
            # re-attach the unreplayed tail so the NEXT restore still
            # sees the full post-snapshot input sequence.  A failure in
            # state_restore itself (replayed == -1) re-attaches ALL of
            # it: nothing was consumed yet.
            rec.journal.extend(todo[replayed + 1:] if replayed >= 0
                               else todo)
            raise
        # a transient original fault may not re-raise on replay:
        # leftover skips must never swallow a future real quarantine
        rec.requarantine_skip = 0
        self._supervisor.note_restored(node, rec, len(todo),
                                       _monotonic() - t0)

    # ---------------------------------------------------------------- run

    def run(self):
        if self._threads:
            raise RuntimeError(
                f"Dataflow {self.name!r} already started; a graph runs once")
        if self.check not in (None, "off"):
            # pre-flight static analysis (docs/CHECKS.md): warn or — in
            # 'error' mode — raise CheckError BEFORE any thread (node,
            # sampler, supervisor writer) starts.  Lazily imported: the
            # unset default never touches the check package.
            from ..check import enforce
            enforce(self)
        if self.recovery is not None and self._supervisor is None:
            from ..recovery.supervisor import Supervisor
            self._supervisor = Supervisor(self, self.recovery)
            self._supervisor.attach_all()
        if (self.control is not None and self._controller is None
                and self.metrics is not None):
            # after the supervisor (rescale validation needs the
            # NodeRecovery records), before any thread (the controller
            # wraps source emission and installs epoch hooks)
            from ..control.controller import Controller
            self._controller = Controller(self, self.control)
            self._controller.attach()
        if self.events is not None:
            self.events.emit("dataflow_start", dataflow=self.name,
                             nodes=len(self.nodes),
                             sample_period=self.sample_period)
        period = self.sample_period
        if period is None and self._controller is not None:
            # control without an explicit cadence: the sampler is the
            # controller's sensor bus, so run it at the policy's period
            period = self.control.period
        if (period is None and self.federate is not None
                and self.metrics is not None):
            # federation without an explicit cadence: the shipper rides
            # the sampler, so run it at the ship period
            period = self.federate.period
        if self.federate is not None and self.metrics is not None:
            # the plane-wide telemetry tier (docs/OBSERVABILITY.md
            # "Federation & SLOs"): the shipper rides the sampler like the
            # controller does; the app binds the row plane's senders with
            # df.federation.bind(senders).  Built BEFORE the node threads:
            # a node that fails on its first batch must find the black box
            # in place, or its node_error dumps nothing.
            from ..obs.federation import BlackBox, FederationShipper
            self.federation = FederationShipper(
                self.federate, host=self.federate.host or self.name,
                dataflow_name=self.name, metrics=self.metrics,
                events=self.events)
            if self.federate.blackbox:
                self._blackbox = BlackBox(
                    self.trace_dir, self.name, events=self.events,
                    tracer=self.tracer, shipper=self.federation)
        for node in self.nodes:
            t = threading.Thread(target=self._run_node, args=(node,),
                                 name=f"{self.name}/{node.name}", daemon=True)
            self._threads.append(t)
            t.start()
        if period is not None and self._sampler is None:
            from ..obs.sampler import Sampler
            self._sampler = Sampler(self, period)
            if self._controller is not None:
                self._sampler.subscribe(self._controller.on_sample)
            if self.federation is not None:
                self._sampler.subscribe(self.federation.on_sample)
            self._sampler.start()

    def wait(self, timeout: float = None):
        """Join every node thread and re-raise the first node error.

        ``timeout`` (seconds, None = wait forever) bounds a hung graph:
        on expiry the graph is cancelled (failure flag + inbox wakeups,
        so blocked threads exit) and :class:`TimeoutError` is raised
        naming the still-running nodes — for soaks and CI, a loud bound
        instead of a suite-level kill.

        When several nodes failed, the first error is raised with the
        second chained as its ``__cause__`` and the full tuple attached
        as ``error.dataflow_errors`` — multi-node crashes stay
        diagnosable instead of silently dropping all but one."""
        timed_out = False
        try:
            if timeout is None:
                for t in self._threads:
                    t.join()
            else:
                t_end = _monotonic() + float(timeout)
                for t in self._threads:
                    t.join(max(t_end - _monotonic(), 0.0))
                    if t.is_alive():
                        timed_out = True
                        break
                if timed_out:
                    # unblock everything, then a short grace to exit
                    self._failed.set()
                    for inbox in self._inboxes.values():
                        inbox.cancel()
                    for t in self._threads:
                        t.join(timeout=1.0)
        finally:
            if self._sampler is not None:
                self._sampler.stop()   # takes the final flush sample
                self._sampler = None
            if self._controller is not None:
                # restore controller-tuned knobs on user-owned policy
                # objects (idempotent; controller.py close())
                self._controller.close()
            if self._supervisor is not None:
                # flush pending checkpoint blobs — briefly on the
                # timeout path, so wait(timeout=) keeps its bound
                self._supervisor.stop(wait_s=1.0 if timed_out else 30.0)
            if self.tracer is not None:
                self.tracer.close()     # flush buffered spans to disk
            if self.events is not None and not self._stop_logged:
                self._stop_logged = True
                self.events.emit("dataflow_stop", dataflow=self.name,
                                 errors=len(self._errors),
                                 dead_letters=len(self.dead_letters))
                self.events.close()
        if timed_out:
            alive = [t.name for t in self._threads if t.is_alive()]
            err = TimeoutError(
                f"Dataflow {self.name!r} still running after {timeout}s "
                f"(alive: {alive or 'draining'}); graph cancelled")
            if self._errors:
                # a node failure often CAUSES the hang (a sibling stuck
                # in user code past the cancel): keep the root cause
                # visible instead of masking it with the timeout
                err.dataflow_errors = tuple(self._errors)
                raise err from self._errors[0]
            raise err
        if self._errors:
            first = self._errors[0]
            rest = [e for e in self._errors[1:] if e is not first]
            if rest:
                first.dataflow_errors = tuple(self._errors)
                if first.__cause__ is None and first.__context__ is None:
                    first.__cause__ = rest[0]
            raise first

    def run_and_wait_end(self, timeout: float = None):
        self.run()
        self.wait(timeout=timeout)

    def cardinality(self) -> int:
        """Number of execution threads (multipipe.hpp:973)."""
        return len(self.nodes)

    def shed_counts(self) -> dict[str, int]:
        """Items shed per node (the node whose inbox dropped them), for
        graphs running a shedding OverloadPolicy; empty under the default
        blocking policy.  Stable once wait() returned."""
        out: dict[str, int] = {}
        for node in self.nodes:
            shed = getattr(self._inboxes[id(node)], "shed", 0)
            if shed:
                out[node.name] = out.get(node.name, 0) + shed
        return out
