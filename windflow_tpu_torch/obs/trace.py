"""End-to-end tracing & latency attribution — sampled per-batch spans
across threads, the wire, and device launches (docs/OBSERVABILITY.md
§tracing).

The aggregate sensors (obs/sampler.py) say how *fast* each node runs;
nothing decomposes *latency*: the bench sinks measure only end-to-end
avg/p50/p95/p99, so "p95 tripled" cannot be attributed to a stage.  This
module stamps a sampled fraction of source batches with a trace context
and records, at every node the batch traverses, a **queue-wait span**
(enqueue → dequeue) and a **service span** (the ``svc`` call), each with
an explicit parent — the emitting hop's span — so a trace stitches
source → sink across threads, across farm fan-out, and (via a wire
frame, parallel/channel.py) across hosts.  The device ship phases the
profile timers already bracket (``device_put`` / ``dispatch`` /
``harvest_wait``, ops/resident.py, patterns/native_core.py) become
*child spans* of the service span that ran them, via the
``utils/profile.py`` recorder hook — the T(L) launch-weather relation
per launch instead of in aggregate.  Checkpoint and rescale seals appear
as control-plane spans (kind ``ctrl``).

Mechanics (all engine-driven, see runtime/engine.py):

* the source's ``emit`` asks :meth:`Tracer.outgoing` — every
  ``sample_every``-th batch gets a fresh :class:`SpanCtx` (trace id +
  ``perf_counter_ns`` ingest anchor) and a root span record; the others
  clear the thread-local so stale contexts never leak onto later
  batches.  A batch arriving off the wire with a decoded trace frame
  (``RowReceiver(decode_trace=True)``) is *adopted* instead: same trace
  id, anchor back-dated by the upstream elapsed time, parent pointing at
  the remote span — multihost graphs stitch one trace;
* a traced batch crosses real inboxes wrapped in :class:`Stamped`
  (batch + ctx + parent span + enqueue timestamp); the engine unwraps it
  at ``get``, measures the queue wait, sets the thread-local ctx/span
  for the duration of ``svc`` (so every emission of that call inherits
  the trace — including emissions from stages fused into one thread by
  ``runtime/comb.py``, whose synchronous inner edges need no wrapping),
  times ``svc``, and appends one hop record;
* spans land in ``<trace_dir>/trace.jsonl`` (read by
  ``scripts/wf_trace.py``, which exports Chrome trace-event JSON for
  Perfetto) and ALWAYS in a bounded in-memory ring (``recent``) — a
  graph traced without a trace dir keeps the live percentile sensors
  and the ring, writes nothing;
* when a metrics registry is attached, per-node
  ``trace_queue_wait_seconds{node=...}`` /
  ``trace_service_seconds{node=...}`` histograms
  (:data:`~windflow_tpu_torch.obs.registry.LATENCY_BUCKETS`) feed
  p50/p95/p99 into every sampler record, which is how a
  ``ControlPolicy`` rule thresholds on tail latency
  (``Rescale(up_q95_us=...)``, docs/CONTROL.md).

Contract (same as ``metrics=``/``control=``): ``trace=`` unset ⇒ this
module is **never imported**, no batch is ever wrapped, no file is
created, and the hot paths carry one dead ``is not None`` branch per
emitted batch; falsy ⇒ OFF.  The file is bounded (``max_spans``); spans
past the bound are *dropped and counted*, with a rate-limited
``trace_drop`` event, never allowed to grow the file without bound.
"""

from __future__ import annotations

import json
import os
import threading
import time
import weakref
from collections import deque
from time import perf_counter_ns as _pc_ns

from ..utils import profile as _profile
from .registry import LATENCY_BUCKETS, quantile_from_snapshot

#: spans buffered before a file write (spans are sampled, so a small
#: buffer amortises the write syscalls without risking much loss)
_FLUSH_EVERY = 128
#: rate limit for trace_drop events: first drop, then every this many
_DROP_EVENT_EVERY = 4096

#: process-wide thread-local carrying the ACTIVE span of the current
#: node thread (set by the engine around svc / by the sampling decision
#: at the source).  Module-level on purpose: helpers like ``current()``,
#: the wire-plane ``export()``, and the profile recorder work without a
#: Tracer handle in scope.
_TLS = threading.local()

#: process-wide id allocator shared by trace ids and span ids: ids must
#: stay unique across every Tracer of the process (repeated runs of
#: same-named dataflows APPEND to one trace.jsonl) and are salted with a
#: per-process random base so wire-adopted remote traces can never
#: collide with locally allocated ids.  The salt is 21 bits over a
#: 32-bit counter, keeping every id below 2**53: the Chrome trace-event
#: export writes ids into JSON consumed by JavaScript (Perfetto /
#: chrome://tracing), where larger ints lose low bits to double
#: rounding and distinct ids would silently merge.
_ID_MU = threading.Lock()
_NEXT_ID = (int.from_bytes(os.urandom(3), "big") >> 3) << 32


def _new_id() -> int:
    global _NEXT_ID
    with _ID_MU:
        _NEXT_ID += 1
        return _NEXT_ID


class TracePolicy:
    """The ``trace=`` knob bundle (``Dataflow``/``MultiPipe``).

    ``sample_rate`` is the sampled fraction of source batches in
    ``(0, 1]`` (internally 1-in-``sample_every``); ``max_spans`` bounds
    the per-Tracer trace.jsonl contribution (drops are counted and
    surface as ``trace_drop`` events); ``ring`` sizes the always-on
    in-memory span ring; ``launch``/``control`` gate the device-launch
    child spans and the checkpoint/rescale control-plane spans."""

    __slots__ = ("sample_rate", "sample_every", "max_spans", "ring",
                 "launch", "control")

    def __init__(self, sample_rate: float = 0.01, max_spans: int = 1 << 20,
                 ring: int = 4096, launch: bool = True,
                 control: bool = True):
        rate = float(sample_rate)
        if not 0.0 < rate <= 1.0:
            raise ValueError(f"sample_rate must be a fraction in (0, 1], "
                             f"got {sample_rate!r}")
        self.sample_rate = rate
        self.sample_every = max(1, round(1.0 / rate))
        if int(max_spans) < 1:
            raise ValueError(f"max_spans must be >= 1, got {max_spans}")
        self.max_spans = int(max_spans)
        if int(ring) < 1:
            raise ValueError(f"ring must be >= 1 span, got {ring}")
        self.ring = int(ring)
        self.launch = bool(launch)
        self.control = bool(control)

    def _key(self):
        return (self.sample_every, self.max_spans, self.ring,
                self.launch, self.control)

    def agrees_with(self, other: "TracePolicy") -> bool:
        """Structural equality — the union-merge conflict rule (one
        Dataflow runs one tracer, api/multipipe.py)."""
        return self._key() == other._key()

    def __repr__(self):
        return (f"TracePolicy(sample_rate={self.sample_rate}, "
                f"max_spans={self.max_spans}, ring={self.ring}, "
                f"launch={self.launch}, control={self.control})")


def as_policy(trace) -> TracePolicy:
    """Normalise a truthy ``trace=`` value: a :class:`TracePolicy` is
    used as-is, ``True`` means sample everything, any other number is
    the sample fraction."""
    if isinstance(trace, TracePolicy):
        return trace
    if trace is True:
        return TracePolicy(sample_rate=1.0)
    return TracePolicy(sample_rate=float(trace))


class SpanCtx:
    """One sampled batch's identity: trace id + ingest anchor + owning
    tracer.  Travels by reference (thread-local inside a thread,
    :class:`Stamped` across inboxes, :func:`export`/adoption across the
    wire)."""

    __slots__ = ("trace_id", "t0_ns", "tracer")

    def __init__(self, trace_id: int, t0_ns: int, tracer: "Tracer"):
        self.trace_id = trace_id
        self.t0_ns = t0_ns
        self.tracer = tracer


class Stamped:
    """A traced batch in flight between two node threads: the payload,
    its span context, the emitting hop's span id (the consumer's parent)
    and the enqueue timestamp the consumer subtracts to get the queue
    wait.  Only ever exists inside an engine inbox — the engine unwraps
    before ``svc`` sees the batch."""

    __slots__ = ("batch", "ctx", "parent", "t_enq_ns")

    def __init__(self, batch, ctx: SpanCtx, parent, t_enq_ns: int):
        self.batch = batch
        self.ctx = ctx
        self.parent = parent
        self.t_enq_ns = t_enq_ns

    def copy(self):
        """Copy with a private batch — the recovery journal's
        ``copy_inputs`` defense (recovery/epoch.py ``_journal_item``)
        duck-types on ``.copy()``: a node that mutates its input in
        place must not mutate the journaled replay copy through the
        wrapper's alias."""
        batch = self.batch
        return Stamped(batch.copy() if hasattr(batch, "copy") else batch,
                       self.ctx, self.parent, self.t_enq_ns)


def current() -> SpanCtx | None:
    """The span context of the batch the calling node thread is
    processing (None outside a traced ``svc`` call)."""
    return getattr(_TLS, "ctx", None)


def current_span() -> int | None:
    """The active hop's span id (None outside a traced ``svc``)."""
    return getattr(_TLS, "span", None)


def export() -> dict | None:
    """Portable form of the calling thread's active span, for handing a
    trace across the row plane (``RowSender.send(batch, trace=...)``).
    Carries the *elapsed* time since ingest instead of the raw anchor,
    so the adopting host needs no clock sync — only the (small, DCN
    round-trip sized) wire transit time is unattributed."""
    ctx = current()
    if ctx is None:
        return None
    return {"trace": ctx.trace_id, "span": current_span(),
            "elapsed_us": round((_pc_ns() - ctx.t0_ns) / 1e3, 1)}


def _profile_recorder(name: str, dt_ns: int):
    """utils/profile.py span-exit observer: when the calling thread is
    inside a traced ``svc``, the just-finished ship phase becomes a
    child span of the active hop.  Outside a traced batch it is two
    attribute reads and a return."""
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None:
        return
    tr = ctx.tracer
    if tr is None or tr._closed or not tr.policy.launch:
        return
    tr.record_launch(ctx, getattr(_TLS, "span", None),
                     getattr(_TLS, "node", None), name, dt_ns)


#: live-Tracer refcount for the profile recorder: while any tracer is
#: open every profile span stamps its clock (that is the price of the
#: launch bridge), but once the LAST tracer closes the recorder is
#: uninstalled so untraced runs return to the bare-global disabled
#: probe — the "one dead branch" contract outlives the traced graph.
_RECORDER_REFS = 0
_RECORDER_MU = threading.Lock()


def _install_recorder():
    global _RECORDER_REFS
    with _RECORDER_MU:
        _RECORDER_REFS += 1
        if _RECORDER_REFS == 1:
            _profile.set_recorder(_profile_recorder)


def _uninstall_recorder():
    global _RECORDER_REFS
    with _RECORDER_MU:
        _RECORDER_REFS -= 1
        if _RECORDER_REFS == 0:
            _profile.set_recorder(None)


class Tracer:
    """Per-Dataflow span sampler and sink (see module docstring).

    ``trace_dir`` gates the trace.jsonl file (opened lazily on the first
    flush, like the event log); ``metrics`` gates the per-node latency
    histograms; ``events`` receives rate-limited ``trace_drop`` events.
    Any of the three sinks may be None — the bounded ``recent`` ring is
    always maintained."""

    def __init__(self, dataflow_name: str, policy: TracePolicy,
                 trace_dir: str = None, metrics=None, events=None):
        self.dataflow = dataflow_name
        self.policy = policy
        self.path = (os.path.join(trace_dir, "trace.jsonl")
                     if trace_dir else None)
        self.metrics = metrics
        self.events = events
        #: bounded in-memory span ring — the no-trace_dir sink, and what
        #: tests/stitching assertions read without touching the fs
        self.recent = deque(maxlen=policy.ring)
        #: spans recorded (ring) / file records written / dropped over
        #: the file bound (stable after close)
        self.spans = 0
        self.written = 0
        self.dropped = 0
        self._buf: list[dict] = []
        self._f = None
        self._closed = False
        self._mu = threading.Lock()
        self._hists: dict[str, tuple] = {}
        self._launch_hists: dict[str, object] = {}
        if metrics is not None:
            self._c_spans = metrics.counter("trace_spans_total")
            self._c_dropped = metrics.counter("trace_spans_dropped")
        else:
            self._c_spans = self._c_dropped = None
        # the ship-phase bridge costs nothing until a thread holds a
        # traced ctx, so it is installed process-wide exactly once
        _install_recorder()
        # a tracer that is never close()d — a built-but-never-run
        # preview graph, or run() raising before wait() — must still
        # release the process-wide recorder, or every later untraced
        # run keeps stamping clocks per profile span: a GC finalizer
        # backstops close() (the release box, not self, is captured —
        # the finalizer must not keep the tracer alive)
        released = [False]

        def _do_release(box=released):
            if not box[0]:
                box[0] = True
                _uninstall_recorder()

        self._release = _do_release
        weakref.finalize(self, _do_release)

    # ------------------------------------------------------------- sampling

    def _start(self, node, batch) -> SpanCtx | None:
        """Origin-side decision for the batch being emitted: adopt a
        wire-carried trace if the batch brought one, else sample
        1-in-``sample_every`` (counter is thread-local: no lock per
        batch; the id allocation — rare — takes one).  Sets the
        thread-local either way so a non-sampled batch can never inherit
        the previous batch's span."""
        parent = None
        ctx = None
        wf = getattr(batch, "wf_trace", None)
        if wf is not None:
            try:
                ctx = SpanCtx(int(wf["trace"]),
                              _pc_ns() - int(float(wf.get("elapsed_us", 0))
                                             * 1e3), self)
                parent = wf.get("span")
            except (KeyError, TypeError, ValueError):
                ctx = None      # malformed peer frame: sample locally
        if ctx is None:
            n = getattr(_TLS, "n", 0)
            _TLS.n = n + 1
            if n % self.policy.sample_every:
                self.set_current(None)
                return None
            ctx = SpanCtx(_new_id(), _pc_ns(), self)
        root = _new_id()
        self.set_current(ctx, root, getattr(node, "_hop_id", node.name))
        # the root hop record: zero queue/service, so wf_trace and the
        # parentage walk always find the source end of the chain (for an
        # adopted trace its end_us offset is the upstream elapsed time)
        self.record_hop(ctx, getattr(node, "_hop_id", node.name), root,
                        parent, 0, 0,
                        len(batch) if batch is not None else 0)
        return ctx

    # engine hooks: the thread-local IS the ctx of the running svc call
    @staticmethod
    def set_current(ctx: SpanCtx | None, span: int = None,
                    node_id: str = None):
        _TLS.ctx = ctx
        _TLS.span = span
        _TLS.node = node_id

    @staticmethod
    def incoming(item: "Stamped"):
        """Engine-side unwrap at inbox dequeue: returns ``(batch, ctx,
        parent, span, q_ns)`` — a fresh span id for this hop and the
        queue wait measured from the producer's enqueue stamp."""
        return (item.batch, item.ctx, item.parent, _new_id(),
                _pc_ns() - item.t_enq_ns)

    def outgoing(self, batch, node):
        """Called by ``Node.emit``/``emit_to`` when tracing is on: make
        the sampling/adoption decision at an origin (source) node, then
        wrap the batch iff this node's outputs are real inboxes
        (``_trace_wrap``; fused inner edges deliver synchronously
        in-thread, where the thread-local already carries the ctx)."""
        if node._trace_origin:
            ctx = self._start(node, batch)
        else:
            ctx = getattr(_TLS, "ctx", None)
        if ctx is None or not node._trace_wrap:
            return batch
        return Stamped(batch, ctx, getattr(_TLS, "span", None), _pc_ns())

    # ------------------------------------------------------------ recording

    def _hist_pair(self, node_id: str):
        pair = self._hists.get(node_id)
        if pair is None:
            with self._mu:
                pair = self._hists.get(node_id)
                if pair is None:
                    m = self.metrics
                    pair = (
                        m.histogram(
                            f'trace_queue_wait_seconds{{node="{node_id}"}}',
                            LATENCY_BUCKETS),
                        m.histogram(
                            f'trace_service_seconds{{node="{node_id}"}}',
                            LATENCY_BUCKETS))
                    self._hists[node_id] = pair
        return pair

    def record_hop(self, ctx: SpanCtx, node_id: str, span: int, parent,
                   q_ns: int, svc_ns: int, rows: int):
        """One traversed node for one traced batch: queue-wait span +
        service span (one record carrying both), parented on the
        emitting hop, plus the hop-completion offset from ingest
        (``end_us`` — the monotone coordinate wf_trace reconstructs
        end-to-end latency from)."""
        if self.metrics is not None:
            if q_ns or svc_ns:      # root records would bias the
                qh, sh = self._hist_pair(node_id)   # percentiles to 0
                qh.observe(q_ns / 1e9)
                sh.observe(svc_ns / 1e9)
            self._c_spans.inc()
        self._append({"t": time.time(), "kind": "hop",
                      "trace": ctx.trace_id, "span": span,
                      "parent": parent, "dataflow": self.dataflow,
                      "node": node_id, "q_us": round(q_ns / 1e3, 1),
                      "svc_us": round(svc_ns / 1e3, 1),
                      "end_us": round((_pc_ns() - ctx.t0_ns) / 1e3, 1),
                      "rows": int(rows)})

    def record_launch(self, ctx: SpanCtx, parent, node_id, phase: str,
                      dt_ns: int):
        """One device ship phase (profile span) that ran inside a traced
        ``svc`` call: a child span of that hop.  Attribution note: async
        cores dispatch/harvest launches while servicing LATER batches,
        so a launch child quantifies the launch weather the traced batch
        *experienced*, not necessarily its own rows' launch."""
        if self.metrics is not None:
            h = self._launch_hists.get(phase)
            if h is None:
                with self._mu:
                    h = self._launch_hists.get(phase)
                    if h is None:
                        h = self.metrics.histogram(
                            f'trace_launch_seconds{{phase="{phase}"}}',
                            LATENCY_BUCKETS)
                        self._launch_hists[phase] = h
            h.observe(dt_ns / 1e9)
            self._c_spans.inc()
        self._append({"t": time.time(), "kind": "launch",
                      "trace": ctx.trace_id, "span": _new_id(),
                      "parent": parent, "dataflow": self.dataflow,
                      "node": node_id, "phase": phase,
                      "dur_us": round(dt_ns / 1e3, 1),
                      "end_us": round((_pc_ns() - ctx.t0_ns) / 1e3, 1)})

    def record_ctrl(self, node_id: str, name: str, epoch: int,
                    dur_s: float, **extra):
        """A control-plane moment — a checkpoint commit or a rescale
        seal — as a span record (kind ``ctrl``), so wf_trace can place
        epoch/checkpoint/rescale instants on the Perfetto timeline next
        to the batches they stalled."""
        if not self.policy.control:
            return
        if self._c_spans is not None:
            self._c_spans.inc()
        self._append({"t": time.time(), "kind": "ctrl", "trace": None,
                      "span": _new_id(), "parent": None,
                      "dataflow": self.dataflow, "node": node_id,
                      "name": name, "epoch": int(epoch),
                      "dur_us": round(dur_s * 1e6, 1), **extra})

    # ------------------------------------------------------------ sinks

    def _append(self, rec: dict):
        with self._mu:
            self.recent.append(rec)
            self.spans += 1
            if self.path is None:
                return
            if self.written >= self.policy.max_spans:
                self._drop_locked()
                return
            self.written += 1
            self._buf.append(rec)
            if len(self._buf) >= _FLUSH_EVERY:
                self._flush_locked()

    def _drop_locked(self):
        self.dropped += 1
        if self._c_dropped is not None:
            self._c_dropped.inc()
        if self.events is not None and (
                self.dropped == 1
                or self.dropped % _DROP_EVENT_EVERY == 0):
            # rate-limited: under sustained overflow one event per 4096
            # drops, never per span (events are rare by construction)
            self.events.emit("trace_drop", dataflow=self.dataflow,
                             dropped=self.dropped,
                             max_spans=self.policy.max_spans)

    def _flush_locked(self):
        if self._closed:
            self._buf.clear()
            return
        if self._f is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._f = open(self.path, "a")
        for rec in self._buf:
            json.dump(rec, self._f)
            self._f.write("\n")
        self._f.flush()
        self._buf.clear()

    def latency_snapshot(self, node_id: str) -> dict | None:
        """p50/p95/p99 (µs) of this node's queue-wait/service histograms
        — the per-node fields the sampler merges into every
        metrics.jsonl node entry (None before the node saw a traced
        batch, so pre-trace consumers never see the keys)."""
        pair = self._hists.get(node_id)
        if pair is None:
            return None
        out = {}
        for h, prefix in zip(pair, ("q", "svc")):
            snap = h.snapshot()
            if not snap["count"]:
                continue
            for q, tag in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                v = quantile_from_snapshot(snap, q)
                out[f"{prefix}_{tag}_us"] = round(v * 1e6, 1)
        return out or None

    def close(self):
        """Flush buffered spans and close the file (engine ``wait()``);
        the ring and counters stay readable.  Idempotent — the profile
        recorder refcount must drop exactly once per tracer."""
        with self._mu:
            if self._closed:
                return
            if self._buf:
                self._flush_locked()
            self._closed = True
            if self._f is not None:
                self._f.close()
                self._f = None
        self._release()
