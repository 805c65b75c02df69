"""ControlPolicy — the declarative rule set of the closed-loop control
plane (docs/CONTROL.md).

Passing a policy to ``Dataflow``/``MultiPipe`` (``control=``) opts the
graph in; ``None`` (the default everywhere) keeps every code path
seed-identical and the ``windflow_tpu_torch.control`` package unimported — the
same contract as ``overload=``/``metrics=``/``recovery=``/``check=``.

A policy is a list of rules, each closing one loop between the sensors
of obs/sampler.py (sampler snapshots: inbox depth, shed counters) and an
actuator:

* :class:`Rescale` — grow/shrink a key-partitioned farm's active worker
  set at the next epoch barrier (recovery/'s consistent cut), migrating
  per-key window state between workers (control/rescale.py);
* :class:`AdaptiveShed` — tighten/relax the running
  :class:`~windflow_tpu_torch.runtime.overload.OverloadPolicy`'s ``soft_limit``
  under sustained backpressure, so shedding starts *before* inboxes are
  full;
* :class:`Admission` — a token-bucket rate cap on source emission the
  controller moves between ``min_rate`` and ``max_rate``.

Every rule shares one trigger shape: a high and a low threshold over a
sampled signal, ``hysteresis`` consecutive samples required on the same
side before acting, and a ``cooldown`` (seconds) after every action —
the classic anti-flap pair.  ``observe()`` is a pure state machine over
``(value, now)`` pairs, unit-testable without a running graph
(tests/test_control.py).
"""

from __future__ import annotations

_NEG_INF = float("-inf")


class _ThresholdRule:
    """Shared high/low trigger with hysteresis + cooldown (see module
    docstring).  Subclasses define what "high" actuates."""

    def __init__(self, high, low, hysteresis: int = 2,
                 cooldown: float = 2.0):
        if high is not None and low is not None and low >= high:
            raise ValueError(
                f"{type(self).__name__}: low threshold ({low}) must be < "
                f"high threshold ({high}) — equal or inverted thresholds "
                f"oscillate on every sample")
        if int(hysteresis) < 1:
            raise ValueError("hysteresis must be >= 1 sample")
        if float(cooldown) < 0:
            raise ValueError("cooldown must be >= 0 seconds")
        self.high = high
        self.low = low
        self.hysteresis = int(hysteresis)
        self.cooldown = float(cooldown)
        self._high_n = 0
        self._low_n = 0
        self._last_t = _NEG_INF

    def _classify(self, value) -> int:
        """+1 when the signal is at/above ``high``, -1 when at/below
        ``low``, else 0 — subclasses with several signals override."""
        if self.high is not None and value >= self.high:
            return 1
        if self.low is not None and value <= self.low:
            return -1
        return 0

    def observe(self, value, now: float) -> int:
        """Feed one sample; returns +1 (high side persisted), -1 (low
        side persisted) or 0.  Streaks reset on every side change and on
        every action; during the cooldown window samples still feed the
        streaks but no action fires."""
        side = self._classify(value)
        self._high_n = self._high_n + 1 if side > 0 else 0
        self._low_n = self._low_n + 1 if side < 0 else 0
        if now - self._last_t < self.cooldown:
            return 0
        if self._high_n >= self.hysteresis:
            self._fired(now)
            return 1
        if self._low_n >= self.hysteresis:
            self._fired(now)
            return -1
        return 0

    def _fired(self, now: float):
        self._last_t = now
        self._high_n = self._low_n = 0

    def reset(self):
        """Clear the trigger state (streaks + cooldown clock) — the
        Controller calls this at attach so a policy object reused for a
        second run does not inherit the first run's cooldowns.  (Do not
        share one live policy between two CONCURRENTLY running graphs:
        two sampler threads would drive one unsynchronized state
        machine.)"""
        self._high_n = self._low_n = 0
        self._last_t = _NEG_INF


class Rescale(_ThresholdRule):
    """Elastic width for one key-partitioned farm (Key_Farm, keyed
    Accumulator/stateless farms): the farm is built with
    ``max_workers`` replicas, ``pattern.parallelism`` of them initially
    active, and the controller moves the active width by ``step`` at the
    next epoch barrier when the rule fires.

    Signals (per sample): the **max inbox depth across active workers**
    against ``up_depth``/``down_depth``, the farm head's **shed rate**
    (items/s since the previous sample) against ``up_shed`` — sustained
    shedding at the emitter means the whole farm is saturated regardless
    of how the backlog distributes — and the **max sampled queue-wait
    p95 across active workers** (µs, the ``q_p95_us`` field the span
    tracer feeds into every sampler record, docs/OBSERVABILITY.md
    §tracing) against ``up_q95_us``: the tail-latency trigger — a farm
    can hold a shallow average depth yet still bind a latency SLO, and
    depth thresholds cannot see that.  ``up_q95_us`` needs the dataflow
    to run ``trace=`` (the controller warns once and the signal stays 0
    otherwise).

    ``up_slo_burn`` closes the loop from the SLO layer (obs/slo.py):
    the sampler record's ``slo_burn_max`` gauge — the max over
    objectives of min(fast burn, slow burn), published by the local
    :class:`~windflow_tpu_torch.obs.slo.SloEvaluator` the federation shipper
    drives — triggers a grow when it stays at/above the threshold
    (``1.0`` = burning exactly at budget).  Needs the dataflow to run
    ``federate=`` with an ``slo=`` policy (the controller warns once
    and the signal stays 0 otherwise).

    Requires ``recovery=`` on the dataflow (epoch barriers are the
    consistent cut the migration seals at — the Dataflow constructor
    refuses the combination otherwise, WF211) and workers whose cores
    can export/import per-key state (host window cores; device and
    native cores decline, docs/CONTROL.md).
    """

    def __init__(self, pattern: str, max_workers: int,
                 min_workers: int = 1, up_depth=None, down_depth=None,
                 up_shed=None, up_q95_us=None, up_slo_burn=None,
                 step: int = 1, hysteresis: int = 2,
                 cooldown: float = 5.0):
        super().__init__(up_depth, down_depth, hysteresis, cooldown)
        if not pattern:
            raise ValueError("Rescale needs the target pattern's name")
        if int(min_workers) < 1:
            raise ValueError("min_workers must be >= 1")
        if int(max_workers) <= int(min_workers):
            raise ValueError(
                f"max_workers ({max_workers}) must be > min_workers "
                f"({min_workers}): an equal pair leaves nothing to "
                f"rescale")
        if int(step) < 1:
            raise ValueError("step must be >= 1 worker")
        if up_shed is not None and float(up_shed) <= 0:
            raise ValueError("up_shed must be a positive items/s rate")
        if up_q95_us is not None and float(up_q95_us) <= 0:
            raise ValueError("up_q95_us must be a positive queue-wait "
                             "p95 in microseconds")
        if up_slo_burn is not None and float(up_slo_burn) <= 0:
            raise ValueError("up_slo_burn must be a positive burn-rate "
                             "multiple (1.0 = burning exactly at "
                             "budget)")
        self.pattern = str(pattern)
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.up_shed = None if up_shed is None else float(up_shed)
        self.up_q95_us = None if up_q95_us is None else float(up_q95_us)
        self.up_slo_burn = (None if up_slo_burn is None
                            else float(up_slo_burn))
        self.step = int(step)

    # the rescale signal is (max worker depth, head shed rate[, max
    # worker queue-wait p95 µs[, slo_burn_max]]); the shorter tuple
    # forms stay accepted so pre-trace / pre-SLO callers of the pure
    # observe() path are unchanged
    def _classify(self, value) -> int:
        depth, shed_rate, *rest = value
        q95_us = rest[0] if rest else 0.0
        slo_burn = rest[1] if len(rest) > 1 else 0.0
        if self.high is not None and depth >= self.high:
            return 1
        if self.up_shed is not None and shed_rate >= self.up_shed:
            return 1
        if self.up_q95_us is not None and q95_us >= self.up_q95_us:
            return 1
        if self.up_slo_burn is not None and slo_burn >= self.up_slo_burn:
            return 1
        if self.low is not None and depth <= self.low:
            return -1
        return 0

    def _key(self):
        return ("rescale", self.pattern, self.min_workers,
                self.max_workers, self.high, self.low, self.up_shed,
                self.up_q95_us, self.up_slo_burn, self.step,
                self.hysteresis, self.cooldown)

    def __repr__(self):
        return (f"Rescale({self.pattern!r}, {self.min_workers}.."
                f"{self.max_workers}, up_depth={self.high}, "
                f"down_depth={self.low}, up_shed={self.up_shed}, "
                f"up_q95_us={self.up_q95_us}, "
                f"up_slo_burn={self.up_slo_burn}, step={self.step})")


class AdaptiveShed(_ThresholdRule):
    """Move the running OverloadPolicy's ``soft_limit`` (the depth at
    which shed disciplines start dropping, runtime/overload.py) between
    ``min_limit`` and the inbox capacity: tighten by ``step`` while the
    max inbox depth stays at/above ``high_depth``, relax while it stays
    at/below ``low_depth`` (``soft_limit`` returns to ``None`` — shed
    only when full — once it reaches capacity again).

    Requires the dataflow to run a shedding ``OverloadPolicy``
    (``shed_oldest``/``shed_newest``); the controller refuses to attach
    otherwise — there is no shed threshold to move under ``block``.
    """

    def __init__(self, high_depth, low_depth, min_limit: int = 1,
                 step: int = None, hysteresis: int = 2,
                 cooldown: float = 2.0):
        super().__init__(high_depth, low_depth, hysteresis, cooldown)
        if self.high is None or self.low is None:
            raise ValueError("AdaptiveShed needs both high_depth and "
                             "low_depth")
        if int(min_limit) < 1:
            raise ValueError("min_limit must be >= 1 item")
        if step is not None and int(step) < 1:
            raise ValueError("step must be >= 1 item (None = capacity/4)")
        self.min_limit = int(min_limit)
        self.step = None if step is None else int(step)

    def _key(self):
        return ("shed", self.high, self.low, self.min_limit, self.step,
                self.hysteresis, self.cooldown)

    def __repr__(self):
        return (f"AdaptiveShed(high_depth={self.high}, "
                f"low_depth={self.low}, min_limit={self.min_limit}, "
                f"step={self.step})")


class Admission(_ThresholdRule):
    """Source admission control: a token bucket caps source emission at
    ``rate`` tuples/second (burst of ``burst`` tuples, default one
    second's worth).  The controller multiplies the rate by ``down``
    while the max inbox depth stays at/above ``high_depth`` and by
    ``up`` while it stays at/below ``low_depth``, clamped to
    ``[min_rate, max_rate]`` — multiplicative-decrease keeps the source
    from oscillating around the knee.

    ``pattern`` names one source pattern; ``None`` caps every source in
    the graph.  The cap starts at ``max_rate`` (uncontended sources run
    at full speed until backpressure shows).
    """

    def __init__(self, max_rate, min_rate, high_depth, low_depth,
                 pattern: str = None, down: float = 0.5, up: float = 1.25,
                 burst=None, hysteresis: int = 2, cooldown: float = 2.0):
        super().__init__(high_depth, low_depth, hysteresis, cooldown)
        if self.high is None or self.low is None:
            raise ValueError("Admission needs both high_depth and "
                             "low_depth")
        if float(min_rate) <= 0 or float(max_rate) < float(min_rate):
            raise ValueError(
                f"need 0 < min_rate <= max_rate, got {min_rate}.."
                f"{max_rate}")
        if not (0 < float(down) < 1):
            raise ValueError("down must be in (0, 1) — a multiplicative "
                             "decrease")
        if float(up) <= 1:
            raise ValueError("up must be > 1 — a multiplicative increase")
        if burst is not None and float(burst) <= 0:
            raise ValueError("burst must be positive tuples (None = one "
                             "second at max_rate)")
        self.pattern = None if pattern is None else str(pattern)
        self.min_rate = float(min_rate)
        self.max_rate = float(max_rate)
        self.down = float(down)
        self.up = float(up)
        self.burst = None if burst is None else float(burst)

    def _key(self):
        return ("admission", self.pattern, self.min_rate, self.max_rate,
                self.high, self.low, self.down, self.up, self.burst,
                self.hysteresis, self.cooldown)

    def __repr__(self):
        return (f"Admission({self.pattern!r}, {self.min_rate}.."
                f"{self.max_rate}/s, high_depth={self.high}, "
                f"low_depth={self.low})")


class Drain:
    """Manual quiesce actuator: registering a ``Drain`` rule arms
    ``Dataflow.request_drain()`` / ``release_drain()`` — the first leg
    of the rolling-restart sequence (docs/ROBUSTNESS.md "Cross-host
    recovery", scripts/wf_roll.py).

    Draining closes a gate in front of EVERY source's emission (the
    same wrap point as :class:`Admission`'s token bucket, so already
    -emitted batches keep flowing downstream), then waits for the
    in-flight work to settle: ``request_drain`` returns once every node
    inbox has stayed empty, or ``deadline`` seconds elapsed — the
    caller seals a checkpoint on the quiesced graph and hands off.
    ``release_drain`` reopens the gate; sources resume exactly where
    they blocked, no record dropped.

    Unlike the threshold rules this one never fires from samples — it
    is driven by the operator (a roll sequencer, a scripted failover).
    At most one per policy: there is one gate.
    """

    __slots__ = ("deadline", "poll")

    def __init__(self, deadline: float = 30.0, poll: float = 0.05):
        if float(deadline) <= 0:
            raise ValueError("deadline must be positive seconds")
        if float(poll) <= 0:
            raise ValueError("poll must be positive seconds")
        self.deadline = float(deadline)
        self.poll = float(poll)

    def reset(self):
        """No trigger state to clear (manual actuator) — present so the
        Controller's uniform ``rule.reset()`` at attach stays simple."""

    def observe(self, value, now: float) -> int:
        return 0    # never fires from samples

    def _key(self):
        return ("drain", self.deadline, self.poll)

    def __repr__(self):
        return f"Drain(deadline={self.deadline}, poll={self.poll})"


class ControlPolicy:
    """Per-dataflow control-plane knobs: the rules plus the evaluation
    cadence.

    Parameters
    ----------
    rules:
        Non-empty list of :class:`Rescale` / :class:`AdaptiveShed` /
        :class:`Admission` / :class:`Drain` rules.  At most one
        ``Rescale`` per pattern name, at most one ``AdaptiveShed`` (it
        moves one dataflow-wide knob) and at most one ``Drain`` (one
        gate).
    period:
        Controller evaluation cadence in seconds.  The controller is fed
        by the observability sampler (``Sampler.subscribe``): when
        ``sample_period=`` is set it rides that cadence; otherwise — with
        ``metrics=`` on — the engine starts the sampler at this period.
        With *neither* ``metrics=`` nor ``sample_period=`` the controller
        never receives a snapshot and the whole policy is inert (the
        engine warns once at construction; check/ reports it as WF209).
    """

    __slots__ = ("rules", "period")

    def __init__(self, rules, period: float = 0.5):
        rules = list(rules)
        if not rules:
            raise ValueError("ControlPolicy needs at least one rule")
        for r in rules:
            if not isinstance(r, (Rescale, AdaptiveShed, Admission,
                                  Drain)):
                raise TypeError(
                    f"unknown rule type {type(r).__name__} (want "
                    f"Rescale / AdaptiveShed / Admission / Drain)")
        seen = set()
        for r in rules:
            if isinstance(r, Rescale):
                if r.pattern in seen:
                    raise ValueError(
                        f"duplicate Rescale rule for pattern "
                        f"{r.pattern!r} — one rule owns one farm's width")
                seen.add(r.pattern)
        if sum(isinstance(r, AdaptiveShed) for r in rules) > 1:
            raise ValueError("at most one AdaptiveShed rule: it moves "
                             "the single dataflow-wide soft_limit")
        if sum(isinstance(r, Drain) for r in rules) > 1:
            raise ValueError("at most one Drain rule: it owns the "
                             "single dataflow-wide source gate")
        adm = [r for r in rules if isinstance(r, Admission)]
        adm_pats = [r.pattern for r in adm]
        if len(adm) > 1 and (None in adm_pats
                             or len(set(adm_pats)) != len(adm_pats)):
            raise ValueError(
                "overlapping Admission rules: at most one per source "
                "pattern, and a pattern=None rule (all sources) must be "
                "the only one — overlapping buckets would double-"
                "throttle the same source")
        if float(period) <= 0:
            raise ValueError("period must be positive seconds")
        self.rules = rules
        self.period = float(period)

    @property
    def has_rescale(self) -> bool:
        return any(isinstance(r, Rescale) for r in self.rules)

    def rescale_for(self, pattern_name) -> Rescale | None:
        """The Rescale rule targeting ``pattern_name``, if any — the
        wiring layer (runtime/farm.py) calls this to pre-provision the
        farm's worker set to ``max_workers``."""
        if pattern_name is None:
            return None
        for r in self.rules:
            if isinstance(r, Rescale) and r.pattern == pattern_name:
                return r
        return None

    def agrees_with(self, other: "ControlPolicy") -> bool:
        """Structural equality — the union-merge conflict rule (one
        Dataflow runs one control policy, api/multipipe.py)."""
        if self.period != other.period or len(self.rules) != len(other.rules):
            return False
        return all(a._key() == b._key()
                   for a, b in zip(self.rules, other.rules))

    def __repr__(self):
        return (f"ControlPolicy(period={self.period}, rules="
                f"{self.rules!r})")
