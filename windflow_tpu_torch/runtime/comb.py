"""Node fusion — the runtime's equivalent of FastFlow's ``ff_comb``
(``ff/combine.hpp``, used by the reference for chaining at
multipipe.hpp:244-271 and for LEVEL1/2 optimisation at pane_farm.hpp:435-464):
several nodes execute in ONE thread, with the upstream node's emissions
delivered synchronously into the downstream node's ``svc`` instead of
through a queue.

Fusion preserves every lifecycle guarantee of the engine contract: inner
``svc_init``/``svc_end`` run in the (single) combined thread, and EOS
flushing cascades stage by stage — stage i's ``eosnotify`` may still emit,
and those emissions are seen by stage i+1 *before* its own ``eosnotify``.
"""

from __future__ import annotations

from time import perf_counter_ns as _pc_ns

from .node import Node, SourceNode, blocked_put_ns
from ..utils.profile import timeline_record as _tl_record
from ..utils.profile import timeline_stamp as _tl_stamp


class _SyncOut:
    """Output channel that delivers synchronously into the next fused stage
    (replaces the inter-thread Inbox; same ``put`` shape)."""

    __slots__ = ("dst", "channel")

    def __init__(self, dst: Node, channel: int = 0):
        self.dst = dst
        self.channel = channel

    def put(self, src, batch):
        self.dst.svc(batch, self.channel)

    def put_eos(self, src):  # EOS is driven by Comb's lifecycle, not queues
        pass


class _TimedSyncOut(_SyncOut):
    """The synchronous edge into stage `i` of a Comb whose node keeps
    operator states: the call goes through the Comb's stage clock."""

    __slots__ = ("clock", "i")

    def __init__(self, dst: Node, clock, i: int):
        super().__init__(dst)
        self.clock = clock
        self.i = i

    def put(self, src, batch):
        self.clock.call(self.i, batch, self.channel)


class _StageClock:
    """Each fused stage's exclusive service time: a stage's ``svc`` less
    the next stage's ``svc`` that it runs (through its synchronous edge)
    and, for the last stage, less its puts into real inboxes.  The stages'
    exclusive times plus those puts are the Comb's service time.  Kept
    only when the node keeps operator states (``NodeStats.states``); one
    thread calls it."""

    __slots__ = ("stages", "outputs", "incl", "excl", "tuples", "batches",
                 "_inner")

    def __init__(self, stages: list[Node], outputs):
        n = len(stages)
        self.stages = stages
        self.outputs = outputs          # the Comb's real output channels
        self.incl = [0] * n
        self.excl = [0] * n
        self.tuples = [0] * n
        self.batches = [0] * n
        self._inner = 0                 # ns of timed calls made inside

    def call(self, i: int, batch, channel: int):
        stage = self.stages[i]
        last = i == len(self.stages) - 1
        outer, self._inner = self._inner, 0
        put0 = blocked_put_ns(self.outputs) if last else 0
        stamp = _tl_stamp()
        t0 = _pc_ns()
        try:
            stage.svc(batch, channel)
        finally:
            dt = _pc_ns() - t0
            if stamp is not None:
                _tl_record("svc:" + stage.name, stamp)
            inner = self._inner + (
                blocked_put_ns(self.outputs) - put0 if last else 0)
            self.incl[i] += dt
            self.excl[i] += dt - inner
            self.tuples[i] += len(batch)
            self.batches[i] += 1
            self._inner = outer + dt

    def stage_times(self, push_ns=None) -> dict:
        """{stage name: [exclusive ns, tuples, batches]}; a fused source's
        stage is its push time less the next stage's service."""
        out = {}
        for i, s in enumerate(self.stages):
            excl = self.excl[i]
            if i == 0 and push_ns is not None:
                excl = push_ns - (self.incl[1] if len(self.stages) > 1
                                  else blocked_put_ns(self.outputs))
            out[s.name] = [excl, self.tuples[i], self.batches[i]]
        return out


class Comb(Node):
    """Run `stages` fused in one thread: stage i's emit() calls stage i+1's
    svc() directly; the last stage's emissions leave through the Comb's own
    output channels."""

    #: the stages' clock, while the node keeps operator states (svc_init)
    _clock = None

    def __init__(self, stages: list[Node], name: str = None):
        if not stages:
            raise ValueError("Comb needs at least one stage")
        super().__init__(name or "+".join(s.name for s in stages))
        self.stages = list(stages)
        for a, b in zip(self.stages, self.stages[1:]):
            a._outputs = [(_SyncOut(b), 0)]
            # fused edges are direct handoffs: a stage whose producer
            # yields fresh batches may mutate them in place (node.py
            # ownership protocol) — this is where the per-edge proof
            # happens, since inside a Comb the producer is known
            b.input_fresh = bool(a.yields_fresh)
        #: the Comb hands downstream whatever its last stage emits
        self.yields_fresh = bool(self.stages[-1].yields_fresh)
        #: the Comb's inbox feeds its FIRST stage, so the overload
        #: contract of that stage governs the fused node (shed only if
        #: the head may shed, runtime/overload.py)
        self.shed_safe = bool(getattr(self.stages[0], "shed_safe", False))
        #: if ANY fused stage is a framework shell or stateful window
        #: core, an error mid-chain cannot be attributed to a cleanly
        #: un-processed batch — the fused node inherits fail-fast
        self.quarantine_exempt = any(
            getattr(s, "quarantine_exempt", False) for s in self.stages)
        #: an explicitly configured member budget still governs the chain
        #: (tightest wins; one svc error parks the chain's input batch)
        budgets = [s.error_budget for s in self.stages
                   if getattr(s, "error_budget", None) is not None]
        if budgets:
            self.error_budget = min(budgets)
        #: recovery: the fused node restores stage by stage, so every
        #: member must support snapshots — and no NON-TAIL stage may be
        #: an async device core: its wall-clock poll() harvest cadence
        #: shapes how many emissions leave the tail per input, so replay
        #: could not regenerate the original seq numbering (the
        #: per-launch discipline of _AsyncLaunchRecovery only governs a
        #: stage the engine drives directly).  Instance attr overrides
        #: the class default.
        self.recoverable = (
            all(getattr(s, "recoverable", False) for s in self.stages)
            and not any(
                hasattr(getattr(s, "core", None), "process_batches")
                for s in self.stages[:-1]))

    # -- recovery ----------------------------------------------------------

    def checkpoint_prepare(self):
        """Drain fused device stages in order: a mid-chain stage's
        drained results flow synchronously through the later stages
        (whose own drains then run after absorbing them); the last
        stage's residue is returned for the runner to emit."""
        tail = []
        for i, s in enumerate(self.stages):
            for out in (s.checkpoint_prepare() or ()):
                if out is None or not len(out):
                    continue
                if i + 1 < len(self.stages):
                    self.stages[i + 1].svc(out, 0)
                else:
                    tail.append(out)
        return tail

    def state_snapshot(self):
        return [s.state_snapshot() for s in self.stages]

    def state_restore(self, snap):
        for s, part in zip(self.stages, snap):
            s.state_restore(part)

    # -- lifecycle ---------------------------------------------------------

    def svc_init(self):
        # the engine wired the graph's edges onto the Comb itself; the last
        # stage emits through them
        self.stages[-1]._outputs = self._outputs
        self.stages[0].n_input_channels = self.n_input_channels
        if self._tracer is not None:
            # span sampling survives fusion (obs/trace.py): only the LAST
            # stage crosses a real inbox, so only it wraps traced batches;
            # a fused SOURCE makes its sampling decision at the FIRST
            # stage's emit (the ingest anchor), which flows to the tail
            # through the shared thread-local — inner synchronous edges
            # need no wrapping and the middle stages stay hook-free
            last = self.stages[-1]
            last._tracer = self._tracer
            # inherit the Comb's own wrap flag: a nested Comb that is
            # itself an inner (synchronous-edge) stage must not let its
            # tail wrap either
            last._trace_wrap = self._trace_wrap
            last._hop_id = self._hop_id
            first = self.stages[0]
            if self._trace_origin:
                first._trace_origin = True
                first._hop_id = self._hop_id
                if first is not last:
                    first._tracer = self._tracer
                    first._trace_wrap = False
        for s in self.stages[1:]:
            s.n_input_channels = 1
        self._clock = None
        if self.stats is not None and self.stats.states:
            self._clock = _StageClock(self.stages, self._outputs)
            for i, (a, b) in enumerate(zip(self.stages, self.stages[1:])):
                a._outputs = [(_TimedSyncOut(b, self._clock, i + 1), 0)]
        for s in self.stages:
            s.stats = self.stats
            # the engine stamps the observability registry on the Comb's
            # context; fused stages keep their own ctx (their replica
            # index differs), so the handle is forwarded explicitly
            s.ctx.metrics = self.ctx.metrics
            s.svc_init()

    def svc(self, batch, channel: int = 0):
        if self._clock is None:
            self.stages[0].svc(batch, channel)
        else:
            self._clock.call(0, batch, channel)

    def on_channel_eos(self, channel: int):
        self.stages[0].on_channel_eos(channel)

    def eosnotify(self):
        # cascade: flushing stage i may emit into stage i+1 (synchronously),
        # which then flushes its own state on top
        for i, s in enumerate(self.stages):
            s.eosnotify()
            if i + 1 < len(self.stages):
                self.stages[i + 1].on_channel_eos(0)

    def svc_end(self):
        for s in self.stages:
            s.svc_end()
        if self._clock is not None:
            self.stats.stages = self._clock.stage_times(
                self.stats.push_ns_total)


class SourceComb(Comb, SourceNode):
    """Comb whose first stage is a source: the engine drives ``generate``
    (sources are dispatched by type, engine.py) and the generated batches
    flow synchronously through the fused downstream stages."""

    def generate(self):
        self.stages[0].generate()


def make_comb(stages: list[Node], name: str = None) -> Comb:
    """Fuse `stages` into one schedulable node, source-aware."""
    cls = SourceComb if isinstance(stages[0], SourceNode) else Comb
    return cls(stages, name)
