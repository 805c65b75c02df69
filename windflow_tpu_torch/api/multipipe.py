"""MultiPipe — the linear pipeline composer (reference multipipe.hpp:
``add_source / add / chain / add_sink / chain_sink / unionMultiPipes /
run / run_and_wait_end``).  A copy of ``windflow_tpu/api/multipipe.py``.

The reference builds nested ff_a2a "matrioskas" and splices emitters onto
producer pipelines at add time (multipipe.hpp:174-240).  Here composition is
*deferred*: ``add``/``chain`` record stages, and the graph is materialised
once at ``run()``:

* ``add(p)`` wires p as its own farm (emitter -> replicas -> collector)
  fed by the current tail — the Case-2 "shuffle" of add_operator.
* ``chain(p)`` fuses p's workers into the previous stage's worker threads
  (one :class:`~windflow_tpu_torch.runtime.comb.Comb` per replica — the
  chain_operator / ff_comb path, multipipe.hpp:244-271).  Chaining requires
  a non-keyed pattern of equal width; otherwise it degrades to ``add``
  exactly like the reference's width checks force a shuffle.
* ``union`` merges several MultiPipes into one (multipipe.hpp:909-940);
  an OrderingNode is interposed before order-sensitive consumers (windowed
  or keyed patterns), with TS_RENUMBERING for count-windows — the mode table
  of MultiPipe::add (multipipe.hpp:494-537).
"""

from __future__ import annotations

from ..core.windows import WinType
from ..runtime.comb import make_comb
from ..runtime.engine import Dataflow
from ..runtime.farm import add_farm
from ..runtime.ordering import OrderingMode, OrderingNode


def _window_spec(pattern):
    return getattr(pattern, "spec", None)


def _is_keyed(pattern):
    return getattr(pattern, "routing", None) is not None


def _is_composite(pattern):
    return hasattr(pattern, "instantiate")


def _chainable(pattern, group):
    """chain_operator preconditions (multipipe.hpp:244-271): same width,
    non-keyed, and a simple (non-composite) pattern on both sides."""
    if _is_composite(pattern) or _is_keyed(pattern):
        return False
    head = group[0]
    if _is_composite(head):
        return False
    return pattern.parallelism == head.parallelism


class _FusedPattern:
    """A chain group presented as one pattern: replica i is the Comb of
    every member's replica i; the shell comes from the ends."""

    def __init__(self, group):
        self.group = group
        self.parallelism = group[0].parallelism
        self.name = "+".join(p.name for p in group)
        # a fused chain runs every member in ONE thread, so one svc error
        # quarantines the chain's whole input batch: honor the tightest
        # member budget rather than silently dropping withErrorBudget
        budgets = [p.error_budget for p in group
                   if getattr(p, "error_budget", None) is not None]
        if budgets:
            self.error_budget = min(budgets)

    def replicas(self):
        per = [p.replicas() for p in self.group]
        return [make_comb([per[s][i] for s in range(len(per))])
                for i in range(self.parallelism)]

    def emitter(self):
        return self.group[0].emitter()

    def collector(self):
        return self.group[-1].collector()


class MultiPipe:
    """Deferred-construction pipeline of patterns.  Instances are also the
    operands of :func:`union_multipipes`."""

    def __init__(self, name: str = "pipe", trace_dir: str = None,
                 capacity: int = 16, overload=None, metrics=None,
                 sample_period: float = None, recovery=None,
                 check: str = None, control=None, trace=None,
                 federate=None):
        self.name = name
        self.trace_dir = trace_dir  # None -> WF_LOG_DIR env (tracing.py)
        #: per-queue chunk capacity (engine Inbox bound): the
        #: latency/throughput knob — buffered tuples ~= stages x capacity
        #: x chunk, so end-to-end latency ~= that over the throughput
        self.capacity = capacity
        #: runtime/overload.OverloadPolicy — shedding / put deadlines /
        #: poison quarantine for the materialised graph; None (default)
        #: keeps seed-identical behavior (docs/ROBUSTNESS.md)
        self.overload = overload
        #: observability knobs (docs/OBSERVABILITY.md): `metrics` is an
        #: obs.MetricsRegistry (or truthy for a fresh one) exposed live
        #: via `.metrics`; `sample_period` (seconds; WF_SAMPLE_PERIOD
        #: env) runs the background sampler writing
        #: <trace_dir>/metrics.jsonl + events.jsonl.  Both unset =>
        #: no thread, no files, seed-identical hot paths.
        self._metrics_arg = metrics
        self.sample_period = sample_period
        #: recovery/policy.RecoveryPolicy — epoch checkpoints + supervised
        #: node restart for the materialised graph; None (default) keeps
        #: seed-identical behavior (docs/ROBUSTNESS.md "Recovery")
        self.recovery = recovery
        #: pre-flight static analysis (docs/CHECKS.md): 'off'/None = seed
        #: behavior (check/ never imported), 'warn' = report diagnostics
        #: as CheckWarnings at run(), 'error' = raise CheckError before
        #: any thread starts.  Validated eagerly — the deferred build
        #: would otherwise surface a typo'd mode only at run() (or as a
        #: bare KeyError from the union strictness merge).
        if check not in Dataflow.CHECK_MODES:
            raise ValueError(f"check= wants one of {Dataflow.CHECK_MODES}, "
                             f"got {check!r}")
        self.check = check
        #: control/policy.ControlPolicy — the closed-loop control plane
        #: (docs/CONTROL.md): elastic rescale at epoch barriers, adaptive
        #: shedding, source admission.  None (default) keeps seed-
        #: identical behavior and never imports windflow_tpu_torch.control.
        self.control = control
        #: obs/trace.TracePolicy (or a sample-rate fraction) — end-to-end
        #: span tracing (docs/OBSERVABILITY.md §tracing): sampled source
        #: batches leave per-hop queue-wait/service spans (+ device
        #: launch child spans) in <trace_dir>/trace.jsonl.  Falsy
        #: (default) keeps seed-identical behavior and never imports
        #: windflow_tpu_torch.obs.trace.
        self.trace = trace
        #: obs/federation.FederationPolicy (or True) — the plane-wide
        #: telemetry tier (docs/OBSERVABILITY.md "Federation & SLOs"):
        #: snapshot shipping over the row plane, local SLO burn rates,
        #: and the crash black-box.  Falsy (default) keeps seed-
        #: identical behavior and never imports
        #: windflow_tpu_torch.obs.federation / .slo.
        self.federate = federate
        self._stages: list[tuple[str, object]] = []  # (kind, pattern)
        self._branches: list[MultiPipe] = []
        self._has_source = False
        self._has_sink = False
        self._df: Dataflow | None = None
        #: seal listeners registered before the deferred build; handed
        #: to the Dataflow at _build() (and registered directly once
        #: built) — see on_epoch_sealed
        self._seal_listeners: list = []

    # ------------------------------------------------------------- builders

    def _check_open(self):
        if self._has_sink:
            raise ValueError(f"MultiPipe {self.name!r} already has a sink")
        if self._df is not None:
            raise ValueError(f"MultiPipe {self.name!r} is already running")

    def add_source(self, source) -> "MultiPipe":
        self._check_open()
        if self._has_source or self._branches:
            raise ValueError("MultiPipe already has a source")
        self._has_source = True
        self._stages.append(("add", source))
        return self

    def add(self, pattern) -> "MultiPipe":
        self._check_open()
        self._require_input()
        self._stages.append(("add", pattern))
        return self

    def chain(self, pattern) -> "MultiPipe":
        self._check_open()
        self._require_input()
        self._stages.append(("chain", pattern))
        return self

    def add_sink(self, sink) -> "MultiPipe":
        self._check_open()
        self._require_input()
        self._stages.append(("add", sink))
        self._has_sink = True
        return self

    def chain_sink(self, sink) -> "MultiPipe":
        self._check_open()
        self._require_input()
        self._stages.append(("chain", sink))
        self._has_sink = True
        return self

    def _require_input(self):
        if not (self._has_source or self._branches):
            raise ValueError("add a source first (or union MultiPipes)")

    # ---------------------------------------------------------------- build

    def _group_stages(self):
        groups = []
        for kind, p in self._stages:
            if kind == "chain" and groups and _chainable(p, groups[-1]):
                groups[-1].append(p)
            else:
                groups.append([p])
        return groups

    def _maybe_order(self, df, tails, group, ordered, dense):
        """Interpose the right merge in front of an order-sensitive consumer
        — the OrderingNode mode table of MultiPipe::add
        (multipipe.hpp:377-537): count-windows over a stream whose per-key
        ids are no longer pristine (filtered/flat-mapped/unioned/unordered)
        get a TS_RENUMBERING front-end, so CB means "count of arriving
        tuples per key" exactly like the reference's broadcast+renumber CB
        path (:494-537); time-windows and keyed state get a TS merge when
        the stream is unordered or multi-tailed.

        Deliberate reference-faithful asymmetry: a Key_Farm exposes no
        window spec here and is added with its plain key-routing emitter
        (:547-589 — no broadcast, no renumbering), so ITS count windows
        run over RAW tuple ids, gaps and all.  Downstream of a Filter a
        KeyFarm and a WinFarm therefore legitimately disagree on CB
        window content — in the reference exactly as here (the KeyFarm
        raw-id half is pinned by tests/test_fuzz_differential.py's pipe
        fuzz; the WinFarm renumbered half by tests/test_multipipe.py's
        Filter->WinFarm CB case)."""
        specs = [s for s in (_window_spec(p) for p in group) if s is not None]
        cb = any(s.win_type is WinType.CB for s in specs)
        sensitive = bool(specs) or any(_is_keyed(p) for p in group)
        disordered = not ordered or len(tails) > 1
        if cb and (disordered or not dense):
            mode = OrderingMode.TS_RENUMBERING
        elif sensitive and disordered:
            mode = OrderingMode.TS
        elif len(tails) > 1 and not self._keeps_channels(group):
            # a non-sensitive consumer would still merge the channels
            # blindly at its (multi-in) emitter/replica inbox, destroying
            # the per-channel order for everything downstream — merge here
            # (the reference interposes OrderingNode at every Case-2
            # shuffle, multipipe.hpp:218-224)
            mode = OrderingMode.TS
        else:
            return tails, ordered, dense
        onode = OrderingNode(max(len(tails), 1), mode,
                             name=f"{self.name}.order_merge",
                             ordered_input=(ordered and len(tails) == 1),
                             # every producer hands its batches off =>
                             # the renumbering fast path may write ids in
                             # place (node.py ownership protocol)
                             owned_input=all(t.yields_fresh for t in tails))
        df.add(onode)
        for t in tails:
            df.connect(t, onode)
        return [onode], True, (dense or mode is OrderingMode.TS_RENUMBERING)

    @staticmethod
    def _stream_effect(group, ordered, dense):
        """How a wired group changes the stream's (ordered, dense-ids)
        invariants for what flows downstream of it."""
        for p in group:
            if _window_spec(p) is not None:
                # windowed results carry fresh per-key window ids; ordered
                # collectors (default) restore emission order
                ordered = getattr(p, "ordered", True)
                dense = True
                continue
            cls = type(p).__name__
            if cls in ("Filter", "FlatMap"):
                dense = False  # rows dropped / multiplied
            if cls == "Accumulator":
                # accumulator snapshots carry the triggering row's header,
                # but the fold makes ids non-window-meaningful downstream
                dense = False
        return ordered, dense

    @staticmethod
    def _keeps_channels(group):
        """True when the group's replica outputs must stay as separate
        tails instead of being funnelled through a blind Collector: each
        worker's output IS per-key ordered, but an interleaving collector
        would destroy that invariant for good.  Downstream consumers either
        don't care (stateless ops), or get a real k-way OrderingNode merge
        over the per-replica channels — the reference's fused
        OrderingNode∘worker combs (multipipe.hpp:218-224).

        Applies to non-keyed parallel stateless groups and to explicitly
        unordered window farms (whose plain Collector would interleave the
        per-worker result streams)."""
        if any(_is_composite(p) or _is_keyed(p) for p in group):
            return False
        if group[0].parallelism <= 1:
            return False
        if all(_window_spec(p) is None for p in group):
            return True
        # single unordered window farm: drop its interleaving Collector
        return (len(group) == 1
                and _window_spec(group[0]) is not None
                and not getattr(group[0], "ordered", True))

    def _build_into(self, df: Dataflow):
        tails = []
        ordered, dense = True, True
        for b in self._branches:
            tails.extend(b._build_into(df))
        if len(self._branches) > 1:
            ordered, dense = False, False  # cross-branch interleave, id clash
        for group in self._group_stages():
            pattern = group[0] if len(group) == 1 else _FusedPattern(group)
            tails, ordered, dense = self._maybe_order(
                df, tails, group, ordered, dense)
            if self._keeps_channels(group):
                tails = add_farm(df, pattern, tails, collector=None)
            else:
                tails = add_farm(df, pattern, tails)
            ordered, dense = self._stream_effect(group, ordered, dense)
        return tails

    def _build(self) -> Dataflow:
        if self._df is None:
            df = Dataflow(self.name, capacity=self.capacity,
                      trace_dir=self.trace_dir, overload=self.overload,
                      metrics=self._metrics_arg,
                      sample_period=self.sample_period,
                      recovery=self.recovery, check=self.check,
                      control=self.control, trace=self.trace,
                      federate=self.federate)
            #: the validator (check/graph.py) anchors window-geometry
            #: diagnostics at pattern construction sites via the
            #: declared stage list — only reachable through this stamp
            df._check_pipe = self
            self._build_into(df)
            for fn in self._seal_listeners:
                df.on_epoch_sealed(fn)
            self._df = df
        return self._df

    def on_epoch_sealed(self, fn) -> "MultiPipe":
        """Register ``fn(epoch)`` to fire when the recovery supervisor
        seals a checkpoint epoch — the sealed-ack hook for resumable
        wire planes: ``pipe.on_epoch_sealed(receiver.ack_epoch)`` lets
        remote RowSender journals trim at exactly the epochs this
        pipe's checkpoints made durable (docs/ROBUSTNESS.md "Wire
        resume").  Needs ``recovery=`` with a checkpoint_dir to ever
        fire.  Safe before or after run()."""
        self._seal_listeners.append(fn)
        if self._df is not None:
            self._df.on_epoch_sealed(fn)
        return self

    # ------------------------------------------------------------------ run

    def run(self) -> "MultiPipe":
        self._build().run()
        return self

    def wait(self, timeout: float = None):
        """Join the materialised graph; ``timeout`` (seconds) bounds a
        hung graph with a TimeoutError instead of waiting forever
        (engine.Dataflow.wait)."""
        if self._df is None:
            raise RuntimeError("run() first")
        self._df.wait(timeout=timeout)

    def run_and_wait_end(self, timeout: float = None):
        df = self._build()
        if df._threads:          # already started via run(): just wait
            df.wait(timeout=timeout)
        else:
            df.run_and_wait_end(timeout=timeout)

    @property
    def dead_letters(self):
        """Quarantined poison batches (engine DeadLetter records) — only
        populated when an error budget is set; inspect after wait()."""
        return self._df.dead_letters if self._df is not None else []

    def shed_counts(self) -> dict:
        """Per-node shed counters of the materialised graph (empty before
        run() and under the default blocking policy)."""
        return self._df.shed_counts() if self._df is not None else {}

    @property
    def metrics(self):
        """The materialised graph's live obs.MetricsRegistry (None before
        run() unless one was passed in, and always None when neither
        `metrics` nor `sample_period` was configured)."""
        if self._df is not None:
            return self._df.metrics
        from ..obs import MetricsRegistry
        return (self._metrics_arg
                if isinstance(self._metrics_arg, MetricsRegistry) else None)

    @property
    def events(self):
        """The materialised graph's obs.EventLog (None before run() or
        when observability is off); `.recent` holds the in-memory tail."""
        return self._df.events if self._df is not None else None

    @property
    def controller(self):
        """The materialised graph's control-plane Controller (None
        before run() or when ``control=`` is unset/blind) — the handle
        for scripted ``request_rescale`` calls (docs/CONTROL.md)."""
        return self._df._controller if self._df is not None else None

    def request_drain(self, timeout: float = None) -> bool:
        """Gate every source and wait for in-flight work to settle —
        the quiesce leg of a rolling restart (docs/ROBUSTNESS.md
        "Cross-host recovery").  Needs a running pipe whose ``control=``
        policy declares a :class:`~windflow_tpu_torch.control.Drain` rule."""
        if self._df is None:
            raise RuntimeError("request_drain() needs a running pipe — "
                               "call after run()")
        return self._df.request_drain(timeout)

    def release_drain(self):
        """Reopen the source gate closed by :meth:`request_drain`."""
        if self._df is None:
            raise RuntimeError("release_drain() needs a running pipe — "
                               "call after run()")
        self._df.release_drain()

    def getNumThreads(self) -> int:
        """Thread count of the materialised graph (multipipe.hpp:973).
        Before run() this builds a throwaway preview graph, so the pipe
        stays open for further add()/chain() calls."""
        if self._df is not None:
            return self._df.cardinality()
        import warnings
        with warnings.catch_warnings():
            # a control= preview would re-fire the construction-time
            # WF209/WF207 warnings the real build already owns
            warnings.simplefilter("ignore")
            # control changes the materialised cardinality (farms
            # pre-provision to a Rescale rule's max_workers, but only
            # when the graph is observed — blind control provisions
            # nothing), so the preview graph must carry the control,
            # recovery AND observability knobs to match the real build
            df = Dataflow(self.name, capacity=self.capacity,
                          trace_dir=self.trace_dir,
                          metrics=self._metrics_arg,
                          sample_period=self.sample_period,
                          recovery=self.recovery, control=self.control)
        self._build_into(df)
        return df.cardinality()

    # ---------------------------------------------------------------- union

    @staticmethod
    def union(*pipes: "MultiPipe", name: str = "union") -> "MultiPipe":
        return union_multipipes(*pipes, name=name)


def union_multipipes(*pipes: MultiPipe, name: str = "union") -> MultiPipe:
    """Merge several source-bearing MultiPipes into one downstream pipe
    (multipipe.hpp:909-940).  The operands must not have sinks; the merged
    pipe continues with add/chain/add_sink."""
    if len(pipes) < 2:
        raise ValueError("union needs at least two MultiPipes")
    for p in pipes:
        if p._has_sink:
            raise ValueError(f"cannot union {p.name!r}: it has a sink")
        if not (p._has_source or p._branches):
            raise ValueError(f"cannot union {p.name!r}: it has no source")
        if p._df is not None:
            raise ValueError(f"cannot union {p.name!r}: already running")
    # the merged pipe builds ONE Dataflow for the whole graph, so the
    # tightest operand capacity wins (a per-branch latency tuning must not
    # be silently widened back to the default).  Overload policies have no
    # such merge rule: distinct configured policies would silently drop
    # one author's knobs, so they must agree (or all but one be unset)
    policies = [p.overload for p in pipes if p.overload is not None]
    overload = policies[0] if policies else None
    for pol in policies[1:]:
        if (pol.shed, pol.put_deadline, pol.error_budget,
                pol.soft_limit) != (
                overload.shed, overload.put_deadline,
                overload.error_budget, overload.soft_limit):
            raise ValueError(
                f"cannot union MultiPipes with conflicting overload "
                f"policies ({overload!r} vs {pol!r}): one Dataflow runs "
                f"one policy — configure it on the merged pipe")
    # one Dataflow runs one controller: configured control policies must
    # agree (or all but one be unset), like overload/recovery policies
    ctl_pols = [p.control for p in pipes if p.control is not None]
    control = ctl_pols[0] if ctl_pols else None
    for pol in ctl_pols[1:]:
        if not control.agrees_with(pol):
            raise ValueError(
                f"cannot union MultiPipes with conflicting control "
                f"policies ({control!r} vs {pol!r}): one Dataflow runs "
                f"one controller — configure it on the merged pipe")
    # one Dataflow runs one recovery policy: configured policies must
    # agree (or all but one be unset), like overload policies
    rec_pols = [p.recovery for p in pipes if p.recovery is not None]
    recovery = rec_pols[0] if rec_pols else None
    for pol in rec_pols[1:]:
        if not recovery.agrees_with(pol):
            raise ValueError(
                f"cannot union MultiPipes with conflicting recovery "
                f"policies ({recovery!r} vs {pol!r}): one Dataflow runs "
                f"one policy — configure it on the merged pipe")
    # one Dataflow runs one span tracer: configured trace policies must
    # agree (or all but one be unset) — normalised lazily, so a union of
    # untraced pipes still never imports obs.trace
    tr_pols = [p.trace for p in pipes if p.trace]
    trace = tr_pols[0] if tr_pols else None
    if len(tr_pols) > 1:
        from ..obs.trace import as_policy
        first = as_policy(trace)
        for pol in tr_pols[1:]:
            if not first.agrees_with(as_policy(pol)):
                raise ValueError(
                    f"cannot union MultiPipes with conflicting trace "
                    f"policies ({trace!r} vs {pol!r}): one Dataflow "
                    f"runs one tracer — configure it on the merged pipe")
    # one process runs one federation shipper: configured federate
    # policies must agree (or all but one be unset) — normalised
    # lazily, so a union of unfederated pipes never imports
    # obs.federation
    fed_pols = [p.federate for p in pipes if p.federate]
    federate = fed_pols[0] if fed_pols else None
    if len(fed_pols) > 1:
        from ..obs.federation import as_policy as _fed_as_policy
        first = _fed_as_policy(federate)
        for pol in fed_pols[1:]:
            if not first.agrees_with(_fed_as_policy(pol)):
                raise ValueError(
                    f"cannot union MultiPipes with conflicting federate "
                    f"policies ({federate!r} vs {pol!r}): one process "
                    f"runs one shipper — configure it on the merged "
                    f"pipe")
    # observability merges like capacity: the merged graph samples at the
    # finest requested cadence, and the first configured registry and
    # trace_dir win (these are additive sinks, not behavior — no conflict
    # rule needed the way overload policies need one)
    periods = [p.sample_period for p in pipes if p.sample_period is not None]
    registries = [p._metrics_arg for p in pipes if p._metrics_arg]
    trace_dirs = [p.trace_dir for p in pipes if p.trace_dir is not None]
    # static analysis merges by strictness: any operand asking for
    # 'error' makes the merged graph raise, any 'warn' at least warns —
    # loosening one author's check mode would silently drop their gate
    strictness = {"off": 0, "warn": 1, "error": 2}
    modes = [p.check for p in pipes if p.check is not None]
    check = max(modes, key=strictness.__getitem__) if modes else None
    merged = MultiPipe(name, capacity=min(p.capacity for p in pipes),
                       trace_dir=trace_dirs[0] if trace_dirs else None,
                       overload=overload,
                       metrics=registries[0] if registries else None,
                       sample_period=min(periods) if periods else None,
                       recovery=recovery, check=check, control=control,
                       trace=trace, federate=federate)
    merged._branches = list(pipes)
    # seal listeners are additive sinks like metrics registries: every
    # operand's hooks fire on the one merged supervisor
    for p in pipes:
        merged._seal_listeners.extend(p._seal_listeners)
    return merged
