"""Dataflow node contract — the runtime substrate's equivalent of FastFlow's
``ff_node_t`` (``svc_init/svc/svc_end/eosnotify``, see reference usage at
win_seq.hpp:256,268,433,477).

Differences from the reference, by design:

* the unit of exchange is a *batch* (structured numpy array), not a tuple
  pointer — tuple-at-a-time is the degenerate batch of one;
* nodes are wired by an :class:`~windflow_tpu_torch.runtime.engine.Dataflow` graph
  and run by worker threads; emission goes through :meth:`Node.emit` /
  :meth:`Node.emit_to` (the ``ff_send_out`` / ``ff_send_out_to`` analogs,
  standard.hpp:79);
* EOS is per-input-channel, counted by the runner; when every input channel
  has delivered EOS the node gets a final :meth:`eosnotify` to flush state,
  then EOS propagates downstream.
"""

from __future__ import annotations


def blocked_put_ns(outputs) -> int:
    """Nanoseconds spent inside puts into the inboxes of `outputs` (a
    node's ``(inbox, slot)`` list), which each inbox keeps per source slot
    only where the dataflow writes node logs; 0 elsewhere."""
    return sum(inbox._put_ns[slot] for inbox, slot in outputs
               if getattr(inbox, "_put_ns", None) is not None)


class SnapshotUnsupported(RuntimeError):
    """This node cannot produce a state snapshot in its current
    configuration (e.g. state held in native-library tables with no
    extraction API) — the recovery layer marks it non-restartable and a
    failure there tears the graph down exactly like the seed engine."""


class RuntimeContext:
    """Execution context handed to "rich" user functions
    (reference context.hpp:45-80): the replica's parallelism degree and
    index within its pattern.

    When the owning dataflow runs with a metrics registry
    (``metrics=`` / ``sample_period=``, docs/OBSERVABILITY.md), the
    engine stamps it on ``ctx.metrics`` before ``svc_init`` so rich
    functions can record custom metrics
    (``ctx.metrics.counter("late_rows").inc(n)``); ``None`` otherwise —
    the no-observability default costs user code one attribute check."""

    __slots__ = ("parallelism", "index", "name", "metrics")

    def __init__(self, parallelism: int = 1, index: int = 0, name: str = ""):
        self.parallelism = parallelism
        self.index = index
        self.name = name
        self.metrics = None

    def getParallelism(self) -> int:
        return self.parallelism

    def getReplicaIndex(self) -> int:
        return self.index


class Node:
    """Base dataflow node. Subclasses override `svc` (and optionally the
    lifecycle hooks). During execution `self._outputs` holds the output
    channels and `self.ctx` the RuntimeContext.

    Batch-ownership protocol (copy elision): batches are logically
    immutable once emitted — the race-safety model — but a node whose
    every emission is a freshly allocated array it never touches again
    declares ``yields_fresh = True``, transferring ownership downstream.
    A consumer whose ``input_fresh`` was set by the wiring layer (Comb
    fusion, or MultiPipe's ordering interposition) may then mutate the
    batch in place instead of taking a private copy — the reference's
    in-place Map flavour (map.hpp:141) generalised to every handed-off
    edge.  Both default to False: unknown producers are shared."""

    #: every batch this node emits is newly allocated and never reused
    yields_fresh = False
    #: the wiring layer proved this node's input batches are handed off
    input_fresh = False
    #: per-node poison-tuple allowance (runtime/overload.py): how many svc
    #: exceptions this node may quarantine to the dataflow's dead-letter
    #: queue before failing fast.  None = defer to the dataflow's
    #: OverloadPolicy.error_budget (itself 0 = fail fast, the default).
    #: Set via builders' withErrorBudget / a pattern's error_budget
    #: (propagated onto replicas by runtime/farm.py).
    error_budget = None
    #: framework shell nodes (emitters, collectors, ordering merges) set
    #: this True: an error there is a framework bug, never a poison
    #: tuple, so the dataflow-wide error_budget default must NOT
    #: quarantine it (an explicit node-level error_budget still wins)
    quarantine_exempt = False
    #: span-tracing hooks (obs/trace.py): the engine stamps ``_tracer``
    #: on every node of a traced dataflow (``trace=``, docs/
    #: OBSERVABILITY.md §tracing); ``_trace_origin`` marks source nodes,
    #: whose emissions make the sampling/wire-adoption decision;
    #: ``_trace_wrap`` is False only on fused inner stages
    #: (runtime/comb.py), whose synchronous edges carry the span via the
    #: thread-local instead of a Stamped wrapper; ``_hop_id`` is the
    #: canonical node id spans are recorded under.  All default to the
    #: disabled state, so an untraced graph pays one dead ``_tracer is
    #: not None`` branch per emitted batch — the standard opt-in
    #: contract.
    _tracer = None
    _trace_origin = False
    _trace_wrap = True
    _hop_id = None
    #: True on nodes whose inbox may LOAD-SHED under a shedding
    #: OverloadPolicy: farm heads (routing emitters — dropping there is
    #: dropping raw stream items, the classic shedding point) and
    #: stateless operator/sink workers.  False (default) on internal
    #: farm edges — a shed copy of a window-range multicast or of a
    #: dense-id result stream would silently corrupt windows, so those
    #: edges keep blocking and the backpressure propagates to the
    #: nearest shed-safe inbox upstream.
    shed_safe = False
    #: recovery layer (docs/ROBUSTNESS.md "Recovery"): True on node
    #: classes whose state the supervised-restart path can snapshot and
    #: restore (stateless operators trivially; window cores via their
    #: core's deep copy / device hooks).  False (default) means a crash
    #: here fails the graph exactly like the seed engine even when
    #: ``recovery=`` is on.
    recoverable = False
    #: instance attributes carrying mutable stream state — the default
    #: ``state_snapshot`` deep-copies exactly these (empty = stateless)
    state_attrs = ()
    #: per-node recovery record (recovery/epoch.NodeRecovery), installed
    #: by the Supervisor when the dataflow opts in; None (the class
    #: default) keeps emit()/emit_to() on the seed path — the single
    #: dead branch the recovery contract allows on the hot path
    _recov = None
    #: control-plane epoch hooks (control/rescale.py), installed by the
    #: Controller when ``control=`` is set.  ``_ctl_seal_hook`` runs
    #: just before a completed barrier's marker forwards (the farm
    #: emitter announces a pending rescale's seal epoch there);
    #: ``_ctl_epoch_hook`` runs after the barrier checkpoint committed —
    #: the point the rescale migration actually seals at.  Both are
    #: checked once per EPOCH (engine ``_checkpoint_node`` /
    #: ``_complete_barriers``), never on the per-item path.
    _ctl_seal_hook = None
    _ctl_epoch_hook = None

    def __init__(self, name: str = None):
        self.name = name or type(self).__name__
        self._outputs = []   # list of (inbox, src_index) set by the graph
        self.n_input_channels = 0  # set by the engine before svc_init
        self.ctx = RuntimeContext()
        # per-node service-time counters (the LOG_DIR equivalent; see
        # utils/tracing.py). Filled by the runner when tracing is enabled.
        self.stats = None

    # -- lifecycle ---------------------------------------------------------
    def svc_init(self):
        """Called once in the node's thread before any input."""

    def svc(self, batch, channel: int = 0):
        """Process one input batch from input `channel`."""
        raise NotImplementedError

    def on_channel_eos(self, channel: int):
        """Called when one input channel reaches EOS (eosnotify(id))."""

    def eosnotify(self):
        """Called once after ALL input channels reached EOS; flush here."""

    def svc_end(self):
        """Called after eosnotify, before the thread exits."""

    # -- recovery hooks ----------------------------------------------------
    def checkpoint_prepare(self):
        """Called at epoch-barrier alignment before ``state_snapshot``:
        drain any in-flight async work whose results are not yet part of
        this node's state (device launch queues) and return the output
        batches to emit — one per launch, in launch order, so replayed
        emission numbering stays deterministic (None/empty: nothing to
        drain)."""
        return None

    def state_snapshot(self):
        """Snapshot this node's mutable state (any deep-copied/immutable
        object; None for stateless).  Raise :class:`SnapshotUnsupported`
        when the current configuration cannot snapshot."""
        if not self.state_attrs:
            return None
        import copy
        return {a: copy.deepcopy(getattr(self, a))
                for a in self.state_attrs}

    def state_restore(self, snap):
        """Reset state to a ``state_snapshot`` value.  The snapshot must
        survive repeated restores, so mutable state is copied back in."""
        if snap:
            import copy
            for a, v in snap.items():
                setattr(self, a, copy.deepcopy(v))

    # -- emission ----------------------------------------------------------
    def emit(self, batch):
        """Send to every output channel (broadcast for 1 output; nodes with
        several outputs that need routing use emit_to)."""
        if batch is None:
            return
        if self.stats is not None:
            self.stats.record_departure()
        tr = self._tracer
        if tr is not None:
            # span tracing (obs/trace.py): sources decide sampling here;
            # traced batches cross inboxes as Stamped wrappers (the
            # recovery envelope, below, wraps OUTSIDE — the journal
            # replays exactly what was emitted)
            batch = tr.outgoing(batch, self)
        if self._recov is not None:
            # recovery layer on: sequence-tag the emission per edge (and
            # let sources trail epoch markers) — recovery/epoch.py
            self._recov.emit(self._outputs, batch)
            return
        for inbox, src in self._outputs:
            inbox.put(src, batch)

    def emit_to(self, out: int, batch):
        """Send to one specific output channel (ff_send_out_to)."""
        if batch is None:
            return
        if self.stats is not None:
            self.stats.record_departure()
        tr = self._tracer
        if tr is not None:
            batch = tr.outgoing(batch, self)
        if self._recov is not None:
            self._recov.emit_to(self._outputs, out, batch)
            return
        inbox, src = self._outputs[out]
        inbox.put(src, batch)

    @property
    def n_outputs(self) -> int:
        return len(self._outputs)

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


class SourceNode(Node):
    """A node with no inputs: `generate` drives emission."""

    def generate(self):
        """Produce the stream by calling emit(); return to signal EOS."""
        raise NotImplementedError

    def svc(self, batch, channel=0):  # pragma: no cover
        raise RuntimeError("source nodes receive no input")
