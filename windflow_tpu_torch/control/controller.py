"""The per-Dataflow controller: sensors -> rules -> actuators.

Created by ``Dataflow.run()`` when ``control=`` is set (and the graph is
observed — the controller's only sensor is the observability sampler).
It owns **no thread**: rule evaluation runs on the sampler's cadence via
the ``Sampler.subscribe`` hook (one in-process callback per snapshot, no
file I/O), and the heavyweight actuation — the live rescale — runs on
the farm's own node threads at the next epoch barrier
(control/rescale.py).  The two cheap actuators apply immediately:

* **adaptive shedding** moves the running OverloadPolicy's
  ``soft_limit`` (a GIL-atomic attribute store the inbox shed paths read
  per put);
* **admission control** adjusts the token-bucket rate cap wrapped around
  source emission.

Every decision is observable: a ``control`` event per actuation, a
``rescale`` event per completed migration, and ``ctl_*``
counters/gauges in the metrics registry (rendered by
``scripts/wf_top.py``; docs/CONTROL.md lists the full table).
"""

from __future__ import annotations

import threading
from time import monotonic as _monotonic
from time import sleep as _sleep

from .policy import Admission, AdaptiveShed, ControlPolicy, Drain, Rescale


class TokenBucket:
    """Continuous-refill token bucket: ``rate`` tokens/second up to a
    ``burst`` ceiling.  ``throttle(n)`` blocks (in failure-polling
    slices) until ``n`` tokens are available; batches larger than the
    burst run the bucket into debt instead of deadlocking, so huge
    chunks are still rate-bound on average.  ``rate`` is read each
    refill — the controller retunes it with one attribute store."""

    def __init__(self, rate: float, burst: float = None):
        self.rate = float(rate)
        self.burst = float(burst) if burst is not None else max(self.rate,
                                                                1.0)
        self._tokens = self.burst
        self._t = _monotonic()
        self._mu = threading.Lock()

    def throttle(self, n: int, failed: threading.Event = None):
        while True:
            with self._mu:
                now = _monotonic()
                rate = self.rate
                self._tokens = min(self.burst,
                                   self._tokens + (now - self._t) * rate)
                self._t = now
                need = min(float(n), self.burst)
                if self._tokens >= need:
                    self._tokens -= n      # may go negative: debt
                    return
                wait = min((need - self._tokens) / rate, 0.05)
            if failed is not None and failed.is_set():
                from ..runtime.engine import _Cancelled
                raise _Cancelled()
            _sleep(wait)


class _AdmissionState:
    """One Admission rule bound to its bucket and wrapped sources."""

    __slots__ = ("rule", "bucket", "gauge", "sources")

    def __init__(self, rule: Admission, bucket: TokenBucket, gauge,
                 sources):
        self.rule = rule
        self.bucket = bucket
        self.gauge = gauge
        self.sources = sources


class Controller:
    """See module docstring.  Wiring happens in :meth:`attach` (before
    any node thread starts); evaluation in :meth:`on_sample` (sampler
    thread)."""

    def __init__(self, df, policy: ControlPolicy):
        self.df = df
        self.policy = policy
        self.farms = []               # FarmController per Rescale target
        self._farm_ids = {}           # FarmController -> (worker ids, em id)
        self.shed_rule: AdaptiveShed | None = None
        self._shed_step = 1
        self._orig_soft_limit = None
        self.admissions: list[_AdmissionState] = []
        self._prev_shed: dict[str, tuple[float, int]] = {}
        self.drain_rule: Drain | None = None
        #: set = sources flow; cleared = sources gate at emit
        self._drain_gate = threading.Event()
        self._drain_gate.set()

    # ------------------------------------------------------------ wiring

    def attach(self):
        from ..runtime.node import SourceNode
        from ..utils.tracing import node_stats_name
        from .rescale import FarmController
        df = self.df

        def _sid(node):
            return node_stats_name(df.name, df.nodes.index(node),
                                   node.name)

        for rule in self.policy.rules:
            # a policy object reused for a second run must not inherit
            # the first run's cooldown clocks / hysteresis streaks
            rule.reset()
        matched = set()
        wrapped: dict[int, str] = {}   # source node -> owning rule target
        for handle in df._farms:
            fc = FarmController(df, handle)
            fc.validate()
            fc.install_hooks()
            self.farms.append(fc)
            self._farm_ids[id(fc)] = ([_sid(w) for w in fc.workers],
                                      _sid(fc.emitter))
            matched.add(fc.rule.pattern)
            df.metrics.gauge(f"ctl_width_{fc.pattern.name}").set(fc.width)
        for rule in self.policy.rules:
            if isinstance(rule, Rescale) and rule.pattern not in matched:
                raise ValueError(
                    f"Rescale rule targets {rule.pattern!r}, but no "
                    f"key-partitioned farm of that name was wired into "
                    f"Dataflow {df.name!r}")
            if (isinstance(rule, Rescale) and rule.up_q95_us is not None
                    and getattr(df, "tracer", None) is None):
                # the tail-latency signal is fed by the span tracer's
                # per-node histograms; without trace= it reads 0 forever
                # — the WF209 shape of silent inertness, for one signal
                import warnings
                warnings.warn(
                    f"Rescale({rule.pattern!r}): up_q95_us is set but "
                    f"the dataflow runs without trace= — the queue-wait "
                    f"p95 signal never populates, so this trigger is "
                    f"inert (docs/OBSERVABILITY.md §tracing)",
                    stacklevel=2)
            if (isinstance(rule, Rescale)
                    and rule.up_slo_burn is not None
                    and (getattr(df, "federate", None) is None
                         or df.federate.slo is None)):
                # the burn signal is the slo_burn_max gauge the local
                # SloEvaluator publishes; without federate=(slo=...) it
                # never populates — same inert-signal shape as up_q95_us
                import warnings
                warnings.warn(
                    f"Rescale({rule.pattern!r}): up_slo_burn is set but "
                    f"the dataflow runs without federate= (or its "
                    f"FederationPolicy has no slo=) — the slo_burn_max "
                    f"signal never populates, so this trigger is inert "
                    f"(docs/OBSERVABILITY.md §Federation & SLOs)",
                    stacklevel=2)
            if isinstance(rule, AdaptiveShed):
                pol = df.overload
                if pol is None or pol.shed == "block":
                    raise ValueError(
                        "AdaptiveShed needs the dataflow to run a "
                        "shedding OverloadPolicy (shed_oldest/"
                        "shed_newest) — there is no shed threshold to "
                        "move under 'block'")
                self.shed_rule = rule
                self._shed_step = (rule.step if rule.step is not None
                                   else max(1, df.capacity // 4))
                #: restored at close(): the tightened limit must not
                #: leak into later runs / other graphs sharing the
                #: user's OverloadPolicy object
                self._orig_soft_limit = pol.soft_limit
                df.metrics.gauge("ctl_soft_limit").set(
                    pol.soft_limit or 0)
            elif isinstance(rule, Admission):
                sources = [n for n in df.nodes
                           if isinstance(n, SourceNode)
                           and (rule.pattern is None
                                or n.name == rule.pattern
                                or n.name.rsplit(".", 1)[0]
                                == rule.pattern)]
                if not sources:
                    raise ValueError(
                        f"Admission rule targets "
                        f"{rule.pattern or '<all sources>'!r}, but no "
                        f"source node matches in Dataflow {df.name!r}")
                bucket = TokenBucket(rule.max_rate, rule.burst)
                name = ("ctl_admission_rate" if rule.pattern is None
                        else f"ctl_admission_rate_{rule.pattern}")
                gauge = df.metrics.gauge(name)
                gauge.set(bucket.rate)
                for s in sources:
                    other = wrapped.get(id(s))
                    if other is not None:
                        # the policy-level overlap refusal cannot see
                        # replica names ('src' vs 'src.0' both match
                        # node src.0): refuse the double wrap here
                        raise ValueError(
                            f"overlapping Admission rules: source "
                            f"{s.name!r} matches both {other!r} and "
                            f"{rule.pattern!r} — two buckets would "
                            f"double-throttle it")
                    wrapped[id(s)] = rule.pattern
                    self._wrap_source(s, bucket)
                self.admissions.append(
                    _AdmissionState(rule, bucket, gauge, sources))
            elif isinstance(rule, Drain):
                self.drain_rule = rule
        if self.drain_rule is not None:
            # gate OUTERMOST (after any Admission wrap): a drained
            # source parks before it spends bucket tokens, and resumes
            # rate-capped exactly as it left
            for n in df.nodes:
                if isinstance(n, SourceNode):
                    self._gate_source(n)
            df.metrics.gauge("ctl_draining").set(0)

    def _gate_source(self, node):
        inner = node.emit           # possibly the Admission wrapper
        gate = self._drain_gate
        failed = self.df._failed

        def emit(batch):
            while not gate.wait(0.05):
                if failed.is_set():
                    from ..runtime.engine import _Cancelled
                    raise _Cancelled()
            inner(batch)

        node.emit = emit            # Shipper captures this at generate()

    def _wrap_source(self, node, bucket: TokenBucket):
        inner = node.emit           # the bound class method
        failed = self.df._failed

        def emit(batch):
            if batch is not None and len(batch):
                bucket.throttle(len(batch), failed)
            inner(batch)

        node.emit = emit            # Shipper captures this at generate()

    # -------------------------------------------------------- evaluation

    def on_sample(self, rec: dict):
        """Sampler subscription callback — one rule evaluation per
        snapshot.  Cheap by construction: a handful of dict reads and at
        most one attribute store per actuator."""
        now = _monotonic()
        nodes = {n["id"]: n for n in rec.get("nodes", ())}
        # SLO burn signal (obs/slo.py): the local evaluator publishes
        # slo_burn_max into the registry, and the sampler embeds the
        # registry snapshot — so the controller reads it one sample
        # late, which is exactly the cadence lag the burn windows
        # already smooth over.  0.0 (inert) without federate=(slo=).
        slo_burn = float(rec.get("gauges", {}).get("slo_burn_max", 0.0))
        for fc in self.farms:
            if fc.busy:
                continue            # a rescale is already in flight
            ids, em_id = self._farm_ids[id(fc)]
            depth = max((nodes[i]["depth"] for i in ids[:fc.width]
                         if i in nodes), default=0)
            shed_rate = self._shed_rate(em_id, nodes, rec.get("t", now))
            # tail-latency signal (obs/trace.py): max sampled queue-wait
            # p95 across the active workers — 0.0 (inert) until the span
            # tracer populates the field
            q95_us = max((nodes[i].get("q_p95_us", 0.0)
                          for i in ids[:fc.width] if i in nodes),
                         default=0.0)
            d = fc.rule.observe((depth, shed_rate, q95_us, slo_burn),
                                now)
            if d:
                rule = fc.rule
                width = fc.width
                target = (min(width + rule.step, rule.max_workers)
                          if d > 0
                          else max(width - rule.step, rule.min_workers))
                if target != width and fc.request(target):
                    self._note("rescale_request", fc.pattern.name,
                               target, depth=depth,
                               shed_rate=round(shed_rate, 3),
                               q95_us=q95_us,
                               slo_burn=round(slo_burn, 3))
        if self.shed_rule is not None:
            self._drive_shed(self._max_depth(nodes), now)
        for adm in self.admissions:
            self._drive_admission(adm, self._max_depth(nodes), now)

    @staticmethod
    def _max_depth(nodes: dict) -> int:
        return max((n["depth"] for n in nodes.values()), default=0)

    def _shed_rate(self, node_id: str, nodes: dict, t: float) -> float:
        entry = nodes.get(node_id)
        if entry is None:
            return 0.0
        shed = int(entry.get("shed", 0))
        prev = self._prev_shed.get(node_id)
        self._prev_shed[node_id] = (t, shed)
        if prev is None or t <= prev[0]:
            return 0.0
        return (shed - prev[1]) / (t - prev[0])

    def _drive_shed(self, depth: int, now: float):
        rule = self.shed_rule
        d = rule.observe(depth, now)
        if not d:
            return
        pol = self.df.overload
        cap = self.df.capacity
        cur = pol.soft_limit if pol.soft_limit is not None else cap
        new = (max(rule.min_limit, cur - self._shed_step) if d > 0
               else min(cap, cur + self._shed_step))
        if new == cur:
            return
        pol.soft_limit = None if new >= cap else new
        self.df.metrics.gauge("ctl_soft_limit").set(pol.soft_limit or 0)
        self.df.metrics.counter("ctl_shed_tighten" if d > 0
                                else "ctl_shed_relax").inc()
        self._note("shed_tighten" if d > 0 else "shed_relax",
                   "overload", pol.soft_limit or 0, depth=depth)

    def _drive_admission(self, adm: _AdmissionState, depth: int,
                         now: float):
        rule = adm.rule
        d = rule.observe(depth, now)
        if not d:
            return
        cur = adm.bucket.rate
        new = (max(rule.min_rate, cur * rule.down) if d > 0
               else min(rule.max_rate, cur * rule.up))
        if new == cur:
            return
        adm.bucket.rate = new
        adm.gauge.set(new)
        self.df.metrics.counter("ctl_admission_down" if d > 0
                                else "ctl_admission_up").inc()
        self._note("admission_down" if d > 0 else "admission_up",
                   rule.pattern or "<sources>", round(new, 3),
                   depth=depth)

    # ------------------------------------------------------------- drain

    @property
    def draining(self) -> bool:
        return not self._drain_gate.is_set()

    def request_drain(self, timeout: float = None) -> bool:
        """Close the source gate and wait for the in-flight work to
        settle: returns True once every node inbox has stayed empty for
        two consecutive polls, False when ``timeout`` (default: the
        rule's ``deadline``) elapsed first — the graph is still gated
        either way, the caller decides whether a partial quiesce is
        good enough to seal on.  Idempotent while already draining."""
        rule = self.drain_rule
        if rule is None:
            raise RuntimeError(
                "request_drain() needs a Drain rule in the "
                "ControlPolicy — the source gate is only wired when "
                "the policy declares it (docs/CONTROL.md)")
        df = self.df
        deadline = rule.deadline if timeout is None else float(timeout)
        if self._drain_gate.is_set():
            self._drain_gate.clear()
            df.metrics.gauge("ctl_draining").set(1)
            df.metrics.counter("ctl_drains").inc()
            self._drain_note("requested", deadline=deadline)
        t0 = _monotonic()
        settled = 0
        while _monotonic() - t0 < deadline:
            if df._failed.is_set():
                self._drain_note("failed", reason="dataflow failed")
                return False
            depth = sum(ib.depth() for ib in df._inboxes.values())
            # two consecutive empty polls: one poll can race a batch
            # in flight between an inbox pop and the next node's put
            settled = settled + 1 if depth == 0 else 0
            if settled >= 2:
                self._drain_note("quiesced",
                                 ms=round((_monotonic() - t0) * 1e3, 1))
                return True
            _sleep(rule.poll)
        self._drain_note("timeout", deadline=deadline,
                         depth=sum(ib.depth()
                                   for ib in df._inboxes.values()))
        return False

    def release_drain(self):
        """Reopen the source gate (no-op when not draining): sources
        resume mid-iteration exactly where they parked."""
        if not self._drain_gate.is_set():
            self._drain_gate.set()
            self.df.metrics.gauge("ctl_draining").set(0)
            self._drain_note("released")

    def _drain_note(self, phase: str, **fields):
        df = self.df
        if df.events is not None:
            df.events.emit("drain", dataflow=df.name, phase=phase,
                           **fields)

    # --------------------------------------------------------- lifecycle

    def close(self):
        """Called from ``Dataflow.wait()``: undo runtime mutations of
        user-owned objects — the adaptively tightened ``soft_limit``
        belongs to this run, not to the OverloadPolicy instance the user
        may reuse elsewhere.  Also reopens the drain gate so a gated
        source thread cannot outlive the run parked.  Idempotent."""
        if self.shed_rule is not None and self.df.overload is not None:
            self.df.overload.soft_limit = self._orig_soft_limit
        self._drain_gate.set()

    # ------------------------------------------------------------ manual

    def request_rescale(self, pattern_name: str, width: int) -> bool:
        """Scripted/external rescale request (soaks, an external
        autoscaler): same barrier protocol as rule-driven decisions."""
        for fc in self.farms:
            if fc.pattern.name == pattern_name:
                if fc.request(width):
                    self._note("rescale_request", pattern_name, width,
                               manual=True)
                    return True
                return False
        raise KeyError(f"no rescalable farm named {pattern_name!r}")

    def width_of(self, pattern_name: str) -> int:
        for fc in self.farms:
            if fc.pattern.name == pattern_name:
                return fc.width
        raise KeyError(f"no rescalable farm named {pattern_name!r}")

    # ----------------------------------------------------- observability

    def _note(self, action: str, target: str, value, **fields):
        df = self.df
        df.metrics.counter("ctl_decisions").inc()
        if df.events is not None:
            df.events.emit("control", dataflow=df.name, action=action,
                           target=target, value=value, **fields)
