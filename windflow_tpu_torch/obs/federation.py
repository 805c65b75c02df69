"""Telemetry federation over the row plane, and the crash black-box
(docs/OBSERVABILITY.md "Federation & SLOs").

The row plane spans processes; without federation the obs layer
sees only one.  This module closes that gap with three
pieces riding infrastructure that already exists:

* :class:`FederationShipper` — subscribes to the process's
  :class:`~windflow_tpu_torch.obs.sampler.Sampler` (the same sensor bus the
  control plane rides) and periodically ships a compact snapshot —
  sampler sample, cumulative registry counters/gauges, event-ring tail
  — over the plane's existing :class:`~windflow_tpu_torch.parallel.channel.
  RowSender` links as ``-8`` TELEMETRY control frames.  Not journaled:
  the next snapshot supersedes a lost one.
* :class:`TelemetryAggregator` — the receiving side
  (``RowReceiver(telemetry_sink=...)``): merges per-host snapshot
  rings into host-labelled metric families
  (``obs/expo.py`` renders them: ``wf_fed_*{host="w1"}``), marks a
  peer *stale* when its snapshots stop arriving, spools a stale/dead
  peer's last snapshots to disk (the black box survives the host),
  and optionally evaluates plane-scope SLOs
  (:mod:`~windflow_tpu_torch.obs.slo`) over the federated view.
* :class:`BlackBox` — the flight recorder: on node_error, recovery
  give-up, or plane death declaration, dumps the bounded in-memory
  rings (event ring, ``tracer.recent`` spans, the shipper's last K
  samples) to ``<trace_dir>/blackbox-<node>-<ts>.json`` —
  ``scripts/wf_blackbox.py`` renders the post-mortem timeline.

Knob contract (the same as ``trace=``/``control=``): the
``federate=`` knob unset ⇒ this module (and :mod:`obs.slo`) is never
imported, no ``-8`` frame is ever sent, and the wire stays
byte-identical to the seed.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from .slo import SloEvaluator, SloPolicy, local_view

#: snapshot schema version (the ``"v"`` field); an aggregator refuses
#: snapshots from a version-skewed peer loudly, like the portable spool
SNAP_VERSION = 1


def _safe_host(host) -> str:
    """Filesystem- and label-safe host id (the spool filename and the
    ``host=`` label value)."""
    s = str(host)
    return "".join(c if c.isalnum() or c in "-_." else "_"
                   for c in s) or "_"


class FederationPolicy:
    """Knobs of the federation tier (the ``federate=`` value).

    ``host`` labels this process's series in the federated view
    (default: the owning dataflow's name).  ``period`` is the ship
    cadence in seconds — snapshots also ride the sampler, so the
    effective cadence is ``max(period, sample_period)``.  ``keep``
    bounds the in-memory sample ring (the black box's K), and
    ``event_tail`` how many recent events each snapshot carries.
    ``stale_after`` (default ``3 * period``) is the aggregator's
    staleness deadline; ``slo`` an optional :class:`~windflow_tpu_torch.obs.
    slo.SloPolicy` evaluated locally by the shipper and plane-wide by
    the aggregator.  ``blackbox`` enables the crash flight recorder
    (on by default — it costs nothing until a dump trigger fires)."""

    __slots__ = ("host", "period", "keep", "event_tail", "stale_after",
                 "slo", "blackbox")

    def __init__(self, host: str = None, period: float = 1.0,
                 keep: int = 8, event_tail: int = 64,
                 stale_after: float = None, slo=None,
                 blackbox: bool = True):
        if float(period) <= 0:
            raise ValueError("FederationPolicy: period must be positive "
                             "seconds")
        if int(keep) < 1:
            raise ValueError("FederationPolicy: keep must retain at "
                             "least 1 snapshot")
        if int(event_tail) < 0:
            raise ValueError("FederationPolicy: event_tail must be >= 0")
        if slo is not None and not isinstance(slo, SloPolicy):
            raise TypeError(f"FederationPolicy: slo= must be an "
                            f"SloPolicy, got {slo!r}")
        self.host = None if host is None else str(host)
        self.period = float(period)
        self.keep = int(keep)
        self.event_tail = int(event_tail)
        self.stale_after = (3.0 * self.period if stale_after is None
                            else float(stale_after))
        if self.stale_after <= 0:
            raise ValueError("FederationPolicy: stale_after must be "
                             "positive seconds")
        self.slo = slo
        self.blackbox = bool(blackbox)

    def agrees_with(self, other: "FederationPolicy") -> bool:
        """Knob-level equality, for ``union_multipipes`` conflict
        detection (one process runs one shipper)."""
        return (self.host == other.host
                and self.period == other.period
                and self.keep == other.keep
                and self.event_tail == other.event_tail
                and self.stale_after == other.stale_after
                and self.blackbox == other.blackbox
                and self.slo is other.slo)

    def __repr__(self):
        return (f"FederationPolicy(host={self.host!r}, "
                f"period={self.period}, keep={self.keep}, "
                f"slo={self.slo!r})")


def as_policy(value) -> FederationPolicy:
    """Normalise the ``federate=`` knob: ``True`` = defaults, an
    instance passes through.  (Falsy never reaches here — the engine's
    lazy import is the off switch.)"""
    if value is True:
        return FederationPolicy()
    if isinstance(value, FederationPolicy):
        return value
    raise TypeError(f"federate= must be True or a FederationPolicy, "
                    f"got {value!r}")


class FederationShipper:
    """Per-process sender side (see module docstring).  Created by the
    engine under ``federate=``; the application binds the plane's
    senders with :meth:`bind` once the row plane is open — unbound, the
    shipper still feeds the local sample ring (the black box's source)
    and the local SLO evaluator, it just ships nothing."""

    def __init__(self, policy: FederationPolicy, host: str,
                 dataflow_name: str = "", metrics=None, events=None):
        self.policy = policy
        self.host = _safe_host(host)
        self.dataflow_name = str(dataflow_name)
        self._metrics = metrics
        self._events = events
        #: bounded ring of the last K raw sampler records — the black
        #: box's "last K sampler snapshots"
        self.recent = deque(maxlen=policy.keep)
        self._senders: dict = {}
        self._last_ship = 0.0
        self._prev_rec = None
        self.slo = (SloEvaluator(policy.slo, metrics=metrics,
                                 events=events, scope=self.host)
                    if policy.slo is not None else None)

    def bind(self, senders: dict) -> "FederationShipper":
        """Point the shipper at the plane: ``senders`` maps peer pid ->
        :class:`~windflow_tpu_torch.parallel.channel.RowSender` (the dict
        ``open_row_plane`` returns).  May be re-bound after a plane
        reopen."""
        self._senders = dict(senders)
        return self

    # ------------------------------------------------------------- sampling

    def on_sample(self, rec: dict):
        """Sampler subscriber (``Sampler.subscribe``): ring the sample,
        evaluate local SLOs, ship when the period elapsed.  Runs on the
        sampler thread; per-peer wire failures are swallowed (the next
        period re-ships), exactly like ``PlaneSupervisor.replicate``."""
        self.recent.append(rec)
        if self.slo is not None:
            self.slo.observe(local_view(rec, self._prev_rec))
        self._prev_rec = rec
        now = time.monotonic()
        if self._senders and now - self._last_ship >= self.policy.period:
            self._last_ship = now
            self.ship(rec)

    def snapshot(self, rec: dict = None) -> dict:
        """The compact wire snapshot (docs/OBSERVABILITY.md schema)."""
        if rec is None:
            rec = self.recent[-1] if self.recent else {}
        nodes = [{k: n[k] for k in ("node", "depth", "shed",
                                    "quarantined", "rcv_tuples",
                                    "q_p95_us", "svc_p95_us") if k in n}
                 for n in rec.get("nodes", [])]
        snap = {
            "v": SNAP_VERSION,
            "host": self.host,
            "t": rec.get("t", time.time()),
            "seq": rec.get("seq", 0),
            "dataflow": rec.get("dataflow", self.dataflow_name),
            "nodes": nodes,
            "dead_letters": rec.get("dead_letters", 0),
            # cumulative, not deltas: idempotent under snapshot loss
            # (the aggregator rates them against its own arrival clock)
            "counters": dict(rec.get("counters", {})),
            "gauges": dict(rec.get("gauges", {})),
        }
        if self._events is not None and self.policy.event_tail:
            snap["events"] = list(self._events.recent)[
                -self.policy.event_tail:]
        return snap

    def ship(self, rec: dict = None) -> int:
        """Ship one snapshot to every bound peer; returns how many
        peers took it."""
        snap = self.snapshot(rec)
        shipped = 0
        for pid in sorted(self._senders):
            snd = self._senders[pid]
            if (getattr(snd, "_link_down", False)
                    or getattr(snd, "_hb_error", None) is not None):
                # a down link must not stall the sampler thread for a
                # resume cycle: skip now, the next period re-ships
                continue
            try:
                snd.send_telemetry(snap)
                shipped += 1
            except (OSError, ValueError):
                continue
        if self._metrics is not None and shipped:
            self._metrics.counter("fed_snapshots_shipped").inc(shipped)
        return shipped


class BlackBox:
    """Crash flight recorder (see module docstring).  ``dump()`` writes
    everything the bounded in-memory rings know — cheap enough to call
    from failure paths, bounded by ``max_dumps`` so a crash-looping
    node cannot fill the disk."""

    def __init__(self, trace_dir: str, node: str, events=None,
                 tracer=None, shipper: FederationShipper = None,
                 max_dumps: int = 8):
        self.trace_dir = trace_dir
        self.node = _safe_host(node)
        self._events = events
        self._tracer = tracer
        self._shipper = shipper
        self._max_dumps = int(max_dumps)
        self._dumps = 0
        self._mu = threading.Lock()

    def dump(self, reason: str, **fields):
        """Write one black-box file; returns its path (None without a
        ``trace_dir`` or past the dump budget).  Never raises — a
        flight recorder that crashes the crash path is worse than
        none."""
        if not self.trace_dir:
            return None
        with self._mu:
            if self._dumps >= self._max_dumps:
                return None
            self._dumps += 1
        try:
            doc = {
                "v": SNAP_VERSION,
                "node": self.node,
                "t": time.time(),
                "reason": str(reason),
                **fields,
                "events": (list(self._events.recent)
                           if self._events is not None else []),
                "spans": (list(self._tracer.recent)
                          if self._tracer is not None else []),
                "samples": (list(self._shipper.recent)
                            if self._shipper is not None else []),
            }
            os.makedirs(self.trace_dir, exist_ok=True)
            ts = int(time.time() * 1000)
            path = os.path.join(self.trace_dir,
                                f"blackbox-{self.node}-{ts}.json")
            while os.path.exists(path):   # two dumps in the same ms
                ts += 1
                path = os.path.join(self.trace_dir,
                                    f"blackbox-{self.node}-{ts}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
            if self._events is not None:
                self._events.emit("blackbox", node=self.node,
                                  reason=str(reason), path=path)
            return path
        except Exception:  # noqa: BLE001 — see docstring
            return None


class TelemetryAggregator:
    """Receiving side of the federation (see module docstring).  Pass
    it as ``telemetry_sink=`` to the plane's receiver; ``accept()``
    runs inline on the wire read threads and is thread-safe.  Staleness
    marking and plane-scope SLO evaluation run on :meth:`poll` — call
    it from your own loop, or :meth:`start` the built-in one."""

    def __init__(self, policy: FederationPolicy = None, metrics=None,
                 events=None, spool_dir: str = None,
                 state_path: str = None):
        self.policy = policy if policy is not None else FederationPolicy()
        self._metrics = metrics
        self._events = events
        self.spool_dir = spool_dir
        #: when set, every poll() atomically rewrites this JSON file
        #: with the cluster state — the out-of-process surface
        #: ``scripts/wf_top.py --plane`` renders
        self.state_path = state_path
        self._mu = threading.Lock()
        self._rings: dict[str, deque] = {}
        self._arrival: dict[str, float] = {}
        self._stale: set[str] = set()
        self._spooled: set[str] = set()
        self.slo = (SloEvaluator(self.policy.slo, metrics=metrics,
                                 events=events, scope="plane")
                    if self.policy.slo is not None else None)
        self._stop = threading.Event()
        self._thread = None

    # --------------------------------------------------------------- ingest

    def accept(self, snap: dict):
        """The ``telemetry_sink`` contract (wire ``-8`` family).  A
        version-skewed or malformed snapshot is REFUSED loudly (the
        read loop surfaces it like a torn frame), mirroring the
        portable spool's skew refusal."""
        if not isinstance(snap, dict) or snap.get("v") != SNAP_VERSION:
            raise ValueError(
                f"refusing telemetry snapshot with version "
                f"{snap.get('v') if isinstance(snap, dict) else snap!r} "
                f"(this aggregator speaks v{SNAP_VERSION})")
        host = _safe_host(snap.get("host", ""))
        if not snap.get("host"):
            raise ValueError("telemetry snapshot carries no host label")
        now = time.monotonic()
        with self._mu:
            ring = self._rings.get(host)
            if ring is None:
                ring = self._rings[host] = deque(maxlen=self.policy.keep)
            ring.append(snap)
            self._arrival[host] = now
            was_stale = host in self._stale
            self._stale.discard(host)
            if was_stale:
                self._spooled.discard(host)
            n_hosts = len(self._rings)
        if self._metrics is not None:
            self._metrics.counter("fed_snapshots").inc()
            self._metrics.gauge("fed_hosts").set(n_hosts)
        if was_stale:
            self._event("fed_peer", host=host, state="fresh")

    # ------------------------------------------------------------ staleness

    def poll(self, now: float = None):
        """One staleness + SLO pass; returns currently-stale hosts."""
        if now is None:
            now = time.monotonic()
        newly_stale = []
        with self._mu:
            for host, seen in self._arrival.items():
                if (now - seen > self.policy.stale_after
                        and host not in self._stale):
                    self._stale.add(host)
                    newly_stale.append((host, now - seen))
        for host, age in newly_stale:
            self._event("fed_peer", host=host, state="stale",
                        age=round(age, 3))
            # the dead peer's last snapshots must survive it: spool
            # them beside our own black boxes
            self.spool_host(host, reason="stale")
        if self.slo is not None:
            self.slo.observe(self.view(now=now), now=now)
        if self.state_path:
            self.write_state(now=now)
        with self._mu:
            return sorted(self._stale)

    def start(self, period: float = None) -> "TelemetryAggregator":
        """Run :meth:`poll` on a daemon thread every ``period`` seconds
        (default: the policy's ship period)."""
        period = self.policy.period if period is None else float(period)

        def _loop():
            while not self._stop.wait(period):
                self.poll()

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="wf-fed-aggregator")
        self._thread.start()
        return self

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -------------------------------------------------------------- reading

    def hosts(self, now: float = None) -> dict:
        """Per-host freshness: host -> {"fresh", "age", "seq", "t"}."""
        if now is None:
            now = time.monotonic()
        out = {}
        with self._mu:
            for host, ring in self._rings.items():
                last = ring[-1]
                out[host] = {
                    "fresh": host not in self._stale,
                    "age": round(now - self._arrival[host], 3),
                    "seq": last.get("seq", 0),
                    "t": last.get("t", 0.0),
                    "dataflow": last.get("dataflow", ""),
                }
        return out

    def latest(self, host) -> dict:
        """Newest snapshot of ``host`` (None if never seen)."""
        with self._mu:
            ring = self._rings.get(_safe_host(host))
            return ring[-1] if ring else None

    def snapshots(self, host) -> list:
        """The retained snapshot ring of ``host``, oldest first."""
        with self._mu:
            return list(self._rings.get(_safe_host(host), ()))

    def view(self, now: float = None) -> dict:
        """The plane-scope SLO signal view over the federated state:

        * ``availability`` — fraction of known hosts still fresh
        * ``q95_us`` — worst queue-wait p95 across all fresh hosts
        * ``shed_rate`` — summed per-host shed deltas per second
        * ``stale_seconds`` — age of the stalest host's last snapshot
        """
        if now is None:
            now = time.monotonic()
        with self._mu:
            hosts = list(self._rings)
            fresh = [h for h in hosts if h not in self._stale]
            rings = {h: list(self._rings[h]) for h in hosts}
            ages = [now - self._arrival[h] for h in hosts]
        view = {
            "availability": (len(fresh) / len(hosts)) if hosts else 1.0,
            "q95_us": 0.0,
            "shed_rate": 0.0,
            "stale_seconds": max(ages, default=0.0),
        }
        for h in fresh:
            ring = rings[h]
            last = ring[-1]
            view["q95_us"] = max(
                view["q95_us"],
                max((n.get("q_p95_us", 0.0) for n in last.get("nodes", [])),
                    default=0.0))
            if len(ring) >= 2:
                prev = ring[-2]
                dt = last.get("t", 0.0) - prev.get("t", 0.0)
                if dt > 0:
                    cur = sum(n.get("shed", 0)
                              for n in last.get("nodes", []))
                    old = sum(n.get("shed", 0)
                              for n in prev.get("nodes", []))
                    view["shed_rate"] += max(0.0, (cur - old) / dt)
        return view

    def federated(self, now: float = None) -> dict:
        """The merged host-labelled registry snapshot — feed it to
        ``obs.expo.render_registry`` (each embedded-label name renders
        as one series of its family; ``fed_fresh{host=}`` marks
        staleness, 1 fresh / 0 stale)."""
        if now is None:
            now = time.monotonic()
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._mu:
            items = [(h, self._rings[h][-1], h not in self._stale,
                      now - self._arrival[h])
                     for h in sorted(self._rings)]
        for host, snap, fresh, age in items:
            lab = f'host="{host}"'
            out["gauges"][f"fed_fresh{{{lab}}}"] = 1 if fresh else 0
            out["gauges"][f"fed_age_seconds{{{lab}}}"] = round(age, 3)
            out["gauges"][f"fed_dead_letters{{{lab}}}"] = snap.get(
                "dead_letters", 0)
            for name, v in snap.get("counters", {}).items():
                out["counters"][self._label(name, lab)] = v
            for name, v in snap.get("gauges", {}).items():
                out["gauges"][self._label(name, lab)] = v
            for n in snap.get("nodes", []):
                nlab = f'{lab},node="{n.get("node", "")}"'
                for key, metric in (("depth", "fed_node_depth"),
                                    ("q_p95_us", "fed_node_q_p95_us"),
                                    ("svc_p95_us", "fed_node_svc_p95_us")):
                    if key in n:
                        out["gauges"][f"{metric}{{{nlab}}}"] = n[key]
        return out

    @staticmethod
    def _label(name: str, lab: str) -> str:
        """Append the host label to a registry name that may already
        embed labels (``a{x="1"}`` -> ``a{x="1",host="w1"}``)."""
        if name.endswith("}") and "{" in name:
            return f"{name[:-1]},{lab}}}"
        return f"{name}{{{lab}}}"

    def render(self) -> str:
        """Federated Prometheus text exposition."""
        from . import expo
        return expo.render_registry(self.federated())

    def state(self, now: float = None) -> dict:
        """The cluster-state document ``wf_top --plane`` renders: per-
        host freshness + latest snapshot, the SLO signal view, and which
        objectives are burning."""
        if now is None:
            now = time.monotonic()
        doc = {
            "v": SNAP_VERSION,
            "t": time.time(),
            "hosts": self.hosts(now=now),
            "latest": {h: self.latest(h) for h in self.hosts(now=now)},
            "view": self.view(now=now),
            "slo_burning": (self.slo.burning()
                            if self.slo is not None else []),
        }
        if self._metrics is not None:
            doc["slo_gauges"] = {
                k: v for k, v in
                self._metrics.snapshot().get("gauges", {}).items()
                if k.startswith("slo_")}
        return doc

    def write_state(self, now: float = None):
        """Atomically rewrite :attr:`state_path` (never raises — a
        status file must not fail a poll)."""
        if not self.state_path:
            return None
        try:
            doc = self.state(now=now)
            tmp = self.state_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, self.state_path)
            return self.state_path
        except Exception:  # noqa: BLE001 — like spool_host
            return None

    # ------------------------------------------------------------ black box

    def spool_host(self, host, reason: str):
        """Write ``host``'s retained snapshots to
        ``<spool_dir>/blackbox-<host>-<ts>.json`` — the surviving half
        of the dead peer's black box.  Idempotent per staleness episode;
        returns the path (None without a spool_dir or unknown host)."""
        host = _safe_host(host)
        if self.spool_dir is None:
            return None
        with self._mu:
            ring = list(self._rings.get(host, ()))
            if not ring or host in self._spooled:
                return None
            self._spooled.add(host)
        try:
            doc = {"v": SNAP_VERSION, "host": host, "t": time.time(),
                   "reason": str(reason), "samples": ring,
                   "events": ring[-1].get("events", [])}
            os.makedirs(self.spool_dir, exist_ok=True)
            ts = int(time.time() * 1000)
            path = os.path.join(self.spool_dir,
                                f"blackbox-{host}-{ts}.json")
            while os.path.exists(path):   # two spools in the same ms
                ts += 1
                path = os.path.join(self.spool_dir,
                                    f"blackbox-{host}-{ts}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
            if self._metrics is not None:
                self._metrics.counter("fed_spooled").inc()
            self._event("blackbox", node=host, reason=str(reason),
                        path=path)
            return path
        except Exception:  # noqa: BLE001 — like BlackBox.dump
            return None

    def on_death(self, pid, down_for: float = None):
        """Adapter for ``PlaneSupervisor(on_death=...)``: spool every
        host whose snapshots already stopped, plus any host label that
        matches the dead pid by convention (``"<pid>"``)."""
        self.spool_host(str(pid), reason="plane_death")
        for host in self.poll():
            self.spool_host(host, reason="plane_death")

    # -------------------------------------------------------------- plumbing

    def _event(self, kind: str, **fields):
        if self._events is not None:
            self._events.emit(kind, **fields)
