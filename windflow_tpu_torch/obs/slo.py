"""SLO objectives with multi-window burn-rate alerting over local and
federated telemetry (docs/OBSERVABILITY.md "Federation & SLOs").

An :class:`SloObjective` names a *signal* (a key of the view dict the
caller assembles from sampler records or the federated plane view), a
*bad* condition on it (``bad_above=`` / ``bad_below=``), and an error
*budget* — the fraction of observations allowed to be bad.  The
:class:`SloEvaluator` keeps one observation ring per objective and
computes the classic SRE pair of burn rates,

    burn(window) = bad_fraction(window) / budget

over a FAST window (catches a cliff within seconds) and a SLOW window
(filters blips: a single bad sample in a quiet hour must not page).
The objective *burns* only while BOTH windows exceed
``burn_threshold`` — the standard multi-window guard against flapping.

On every observation the evaluator writes ``slo_burn_fast{objective=}``
/ ``slo_burn_slow{objective=}`` gauges plus the scalar
``slo_burn_max`` (the control plane's rule signal,
``Rescale(up_slo_burn=)``, docs/CONTROL.md) into the attached registry,
and emits one ``slo_burn`` event per state *transition* (``state:
"burn"`` / ``"ok"``) — never per observation, the same
transitions-only discipline the sampler's shed events follow.

Knob contract: this module is only ever imported by
``obs/federation.py`` under a set ``federate=`` knob — unset, it is
never imported.
"""

from __future__ import annotations

import threading
import time
from collections import deque


class SloObjective:
    """One objective over one signal (see module docstring).  Exactly
    one of ``bad_above`` / ``bad_below`` defines the bad condition
    (latency-style signals burn high, availability-style signals burn
    low)."""

    __slots__ = ("name", "signal", "bad_above", "bad_below", "budget",
                 "fast_window", "slow_window", "burn_threshold")

    def __init__(self, name: str, signal: str, bad_above: float = None,
                 bad_below: float = None, budget: float = 0.05,
                 fast_window: float = 30.0, slow_window: float = 300.0,
                 burn_threshold: float = 1.0):
        if not name or not str(name).strip():
            raise ValueError("SloObjective needs a non-empty name")
        if (bad_above is None) == (bad_below is None):
            raise ValueError(
                f"SloObjective {name!r}: set exactly one of bad_above= / "
                f"bad_below= (the bad condition must have one direction)")
        if not 0.0 < float(budget) < 1.0:
            raise ValueError(
                f"SloObjective {name!r}: budget must be a fraction in "
                f"(0, 1), got {budget}")
        if float(fast_window) <= 0:
            raise ValueError(
                f"SloObjective {name!r}: fast_window must be positive")
        if float(slow_window) <= float(fast_window):
            raise ValueError(
                f"SloObjective {name!r}: slow_window must exceed "
                f"fast_window (multi-window burn needs two scales)")
        if float(burn_threshold) <= 0:
            raise ValueError(
                f"SloObjective {name!r}: burn_threshold must be positive")
        self.name = str(name)
        self.signal = str(signal)
        self.bad_above = None if bad_above is None else float(bad_above)
        self.bad_below = None if bad_below is None else float(bad_below)
        self.budget = float(budget)
        self.fast_window = float(fast_window)
        self.slow_window = float(slow_window)
        self.burn_threshold = float(burn_threshold)

    def bad(self, value: float) -> bool:
        if self.bad_above is not None:
            return float(value) > self.bad_above
        return float(value) < self.bad_below

    def __repr__(self):
        cond = (f"> {self.bad_above}" if self.bad_above is not None
                else f"< {self.bad_below}")
        return (f"SloObjective({self.name!r}, {self.signal!r} {cond}, "
                f"budget={self.budget}, windows={self.fast_window}/"
                f"{self.slow_window}s)")


class SloPolicy:
    """The set of objectives one plane (or one process) promises."""

    __slots__ = ("objectives",)

    def __init__(self, objectives):
        objectives = list(objectives)
        if not objectives:
            raise ValueError("SloPolicy needs at least one objective")
        names = set()
        for o in objectives:
            if not isinstance(o, SloObjective):
                raise TypeError(f"SloPolicy objectives must be "
                                f"SloObjective, got {o!r}")
            if o.name in names:
                raise ValueError(f"duplicate SloObjective name {o.name!r}")
            names.add(o.name)
        self.objectives = objectives

    def __repr__(self):
        return f"SloPolicy({[o.name for o in self.objectives]})"


class _Ring:
    """Per-objective observation ring: (t, bad) pairs pruned to the slow
    window; burn rates are bad-fractions over each window divided by the
    budget."""

    __slots__ = ("obj", "obs")

    def __init__(self, obj: SloObjective):
        self.obj = obj
        self.obs = deque()

    def observe(self, now: float, bad: bool):
        self.obs.append((now, bool(bad)))
        horizon = now - self.obj.slow_window
        while self.obs and self.obs[0][0] < horizon:
            self.obs.popleft()
        return (self._burn(now, self.obj.fast_window),
                self._burn(now, self.obj.slow_window))

    def _burn(self, now: float, window: float) -> float:
        lo = now - window
        total = n_bad = 0
        for t, bad in reversed(self.obs):
            if t < lo:
                break
            total += 1
            n_bad += bad
        if total == 0:
            return 0.0
        return (n_bad / total) / self.obj.budget


class SloEvaluator:
    """Feed views in, get burning objectives out (see module
    docstring).  ``observe()`` is called from a single driver thread
    (the sampler's subscriber fan-out, or the aggregator's poll
    thread); ``burning()`` may be read from anywhere."""

    def __init__(self, policy: SloPolicy, metrics=None, events=None,
                 scope: str = "local"):
        if not isinstance(policy, SloPolicy):
            raise TypeError(f"SloEvaluator needs an SloPolicy, "
                            f"got {policy!r}")
        self.policy = policy
        self.scope = str(scope)
        self._metrics = metrics
        self._events = events
        self._rings = {o.name: _Ring(o) for o in policy.objectives}
        self._burning: set[str] = set()
        self._mu = threading.Lock()

    def burning(self) -> list:
        """Names of currently-burning objectives, sorted."""
        with self._mu:
            return sorted(self._burning)

    def observe(self, view: dict, now: float = None) -> list:
        """One evaluation pass over ``view`` (signal name -> value).
        Objectives whose signal is absent from the view are skipped —
        a local evaluator simply never sees plane-scope signals like
        ``availability``.  Returns the burning objective names."""
        if now is None:
            now = time.monotonic()
        burn_max = 0.0
        for obj in self.policy.objectives:
            value = view.get(obj.signal)
            if value is None:
                continue
            fast, slow = self._rings[obj.name].observe(now, obj.bad(value))
            burn_max = max(burn_max, min(fast, slow))
            self._gauge(f'slo_burn_fast{{objective="{obj.name}"}}', fast)
            self._gauge(f'slo_burn_slow{{objective="{obj.name}"}}', slow)
            burns = (fast >= obj.burn_threshold
                     and slow >= obj.burn_threshold)
            with self._mu:
                was = obj.name in self._burning
                if burns:
                    self._burning.add(obj.name)
                else:
                    self._burning.discard(obj.name)
            if burns and not was:
                self._event("slo_burn", objective=obj.name,
                            state="burn", signal=obj.signal,
                            value=round(float(value), 6),
                            burn_fast=round(fast, 3),
                            burn_slow=round(slow, 3),
                            threshold=obj.burn_threshold)
            elif was and not burns:
                self._event("slo_burn", objective=obj.name, state="ok",
                            signal=obj.signal,
                            value=round(float(value), 6),
                            burn_fast=round(fast, 3),
                            burn_slow=round(slow, 3))
        self._gauge("slo_burn_max", burn_max)
        return self.burning()

    # -------------------------------------------------------------- plumbing

    def _gauge(self, name: str, v: float):
        if self._metrics is not None:
            self._metrics.gauge(name).set(round(float(v), 6))

    def _event(self, kind: str, **fields):
        if self._events is not None:
            self._events.emit(kind, scope=self.scope, **fields)


def local_view(rec: dict, prev: dict = None) -> dict:
    """Assemble the local-process signal view from one sampler record
    (and optionally the previous one, for rate signals):

    * ``q95_us`` — worst per-node queue-wait p95 (µs; needs ``trace=``)
    * ``svc95_us`` — worst per-node service p95 (µs; needs ``trace=``)
    * ``depth`` — deepest inbox
    * ``shed_rate`` / ``quarantine_rate`` — items per second since the
      previous record (0.0 on the first)
    * ``dead_letters`` — current dead-letter count
    """
    nodes = rec.get("nodes", [])
    view = {
        "q95_us": max((n.get("q_p95_us", 0.0) for n in nodes),
                      default=0.0),
        "svc95_us": max((n.get("svc_p95_us", 0.0) for n in nodes),
                        default=0.0),
        "depth": max((n.get("depth", 0) for n in nodes), default=0),
        "shed_rate": 0.0,
        "quarantine_rate": 0.0,
        "dead_letters": rec.get("dead_letters", 0),
    }
    if prev is not None:
        dt = rec.get("t", 0.0) - prev.get("t", 0.0)
        if dt > 0:
            for key, field in (("shed_rate", "shed"),
                               ("quarantine_rate", "quarantined")):
                cur = sum(n.get(field, 0) for n in nodes)
                old = sum(n.get(field, 0)
                          for n in prev.get("nodes", []))
                view[key] = max(0.0, (cur - old) / dt)
    return view
