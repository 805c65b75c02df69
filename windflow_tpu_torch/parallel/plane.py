"""Plane supervisor — per-process membership, death detection, and
successor handoff for a multihost row plane (docs/ROBUSTNESS.md
"Cross-host recovery").

Single *edges* of the row plane are resumable (sender journals + seq
dedup) and sealed state is portable (flat native blobs).  This layer
covers the remaining gap: ``kill -9`` of a WHOLE process.  Each process runs one
:class:`PlaneSupervisor` over its half of the plane
(:func:`~windflow_tpu_torch.parallel.multihost.open_row_plane` handles):

* **membership** — the supervisor polls the health of every outbound
  sender (the resume ack-reader marks ``_link_down`` on EOF/RST, the
  heartbeat thread records ``_hb_error``), so a dead peer is observed
  passively within a beat interval, no extra probe traffic;
* **death** — a peer continuously down past ``down_deadline`` is
  declared dead (``membership`` event, state ``dead``); every survivor
  computes the same deterministic successor (ring order over the live
  candidate pids), so election needs no coordination round;
* **handoff** — the successor pulls the dead peer's newest *portable
  checkpoint* from its local :class:`~windflow_tpu_torch.recovery.portable.
  PortableSpool` (replicated there at every seal via
  :meth:`replicate`), restores those nodes with the ordinary
  ``latest_complete()/load()`` recipe, and rebinds the dead peer's
  address with :meth:`takeover_receiver` — a resumable receiver opened
  with ``resume_epoch=K``, so every journaling sender that was feeding
  the dead process reconnects, replays its tail since the epoch-``K``
  barrier, and the receivers dedup the replayed prefix.  No gap, no
  duplicate.

The layer is strictly opt-in: constructing no supervisor (and passing
no ``ckpt_sink=``) keeps the plane byte-identical to the seed and this
module un-imported — the same contract every hardening knob holds.
"""

from __future__ import annotations

import threading
import time
from time import monotonic as _monotonic


class PlanePolicy:
    """Static description of a supervised plane — the membership knobs
    plus the :class:`~windflow_tpu_torch.parallel.channel.WireConfig` its
    edges run.  Separated from the live :class:`PlaneSupervisor` so
    pre-flight validation (``check/``, WF216) can judge the pairing
    without opening a socket: a plane that promises handoff over a
    non-resumable wire silently loses every in-flight frame at the
    handoff point.

    ``down_deadline`` (seconds) is how long a peer must stay
    continuously unreachable before it is declared dead — size it ABOVE
    the wire's resume deadline, or a peer that was about to resume gets
    its nodes adopted out from under it (a split brain on the key
    space).  ``period`` is the membership poll cadence; ``candidates``
    optionally restricts which pids may adopt (e.g. exclude a
    feeder-only process that holds no state plane)."""

    __slots__ = ("down_deadline", "period", "candidates", "wire")

    def __init__(self, down_deadline: float = 10.0, period: float = 0.5,
                 candidates=None, wire=None):
        if float(down_deadline) <= 0:
            raise ValueError("down_deadline must be positive seconds")
        if float(period) <= 0:
            raise ValueError("period must be positive seconds")
        self.down_deadline = float(down_deadline)
        self.period = float(period)
        self.candidates = (None if candidates is None
                           else frozenset(int(p) for p in candidates))
        self.wire = wire

    def validate(self):
        """Raise on a statically-refusable pairing (the WF216 conflict
        is a warning in ``check/`` but loud here at runtime wiring)."""
        if self.wire is not None:
            self.wire.validate()
        return self

    def __repr__(self):
        return (f"PlanePolicy(down_deadline={self.down_deadline}, "
                f"period={self.period}, candidates="
                f"{sorted(self.candidates) if self.candidates else None})")


class PlaneSupervisor:
    """See module docstring.  One per process; owns a daemon poll
    thread between :meth:`start` and :meth:`close`.

    ``on_adopt(dead_pid, epoch, store)`` is the application's restore
    hook, called on the supervisor thread when THIS process is elected
    successor: ``epoch``/``store`` point at the dead peer's newest
    verified spooled checkpoint (``None``/``None`` when the peer never
    replicated one — the successor owns the keys but starts them
    fresh).  The hook typically loads the blobs, then calls
    :meth:`takeover_receiver` and consumes the replayed tail."""

    def __init__(self, my_pid: int, addresses: dict, senders: dict,
                 policy: PlanePolicy = None, store=None, spool=None,
                 metrics=None, events=None, on_adopt=None,
                 on_death=None):
        self.policy = (policy or PlanePolicy()).validate()
        self.my_pid = int(my_pid)
        self.addresses = dict(addresses)
        self.senders = senders
        self.store = store
        self.spool = spool
        self.on_adopt = on_adopt
        #: observability hook, called as ``on_death(pid, down_for)`` on
        #: EVERY death declaration (not just when this process adopts) —
        #: the federation layer's black-box trigger
        #: (docs/OBSERVABILITY.md "Federation & SLOs"); failures are
        #: swallowed so a telemetry bug cannot block the handoff path
        self.on_death = on_death
        self._metrics = metrics
        self._events = events
        self._down_since: dict[int, float] = {}
        self._dead: set[int] = set()
        self._adopted: set[int] = set()
        self._stop = threading.Event()
        self._thread = None
        self._mu = threading.Lock()
        wire = self.policy.wire
        if wire is not None and not getattr(wire, "resume", None):
            # the stand-alone runtime twin of the WF216 pre-flight
            # diagnostic (same pattern as the engine's WF207 warning)
            import warnings
            from ..check.diagnostics import CheckWarning
            warnings.warn(
                "[WF216] plane supervisor over a wire without resume=: "
                "at handoff the in-flight frames of the dead process "
                "have no journal to replay from and are silently lost "
                "(set WireConfig(resume=True, recovery=True); "
                "docs/ROBUSTNESS.md \"Cross-host recovery\")",
                CheckWarning, stacklevel=2)
        self._set_gauge("plane_members", len(self.addresses))
        self._set_gauge("plane_down", 0)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "PlaneSupervisor":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="wf-plane-supervisor")
        self._thread.start()
        return self

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    # ----------------------------------------------------------- membership

    def _peer_down(self, pid: int) -> bool:
        snd = self.senders.get(pid)
        if snd is None:
            return False
        return (getattr(snd, "_link_down", False)
                or getattr(snd, "_hb_error", None) is not None)

    def live(self) -> list:
        """Pids not declared dead (this process included), ascending."""
        with self._mu:
            return sorted(p for p in self.addresses
                          if p not in self._dead)

    def dead(self) -> list:
        with self._mu:
            return sorted(self._dead)

    def successor_for(self, dead_pid: int) -> int:
        """Deterministic, coordination-free election: the first live
        candidate after ``dead_pid`` in pid ring order.  Every survivor
        evaluates the same function over the same membership view, so
        all agree without a vote; returns None when no candidate
        survives."""
        cand = self.policy.candidates
        with self._mu:
            ring = sorted(p for p in self.addresses
                          if p not in self._dead
                          and (cand is None or p in cand))
        if not ring:
            return None
        for p in ring:
            if p > dead_pid:
                return p
        return ring[0]

    def _loop(self):
        period = self.policy.period
        deadline = self.policy.down_deadline
        while not self._stop.wait(period):
            now = _monotonic()
            for pid in self.addresses:
                if pid == self.my_pid:
                    continue
                with self._mu:
                    is_dead = pid in self._dead
                down = self._peer_down(pid)
                if is_dead:
                    if not down:
                        # a restarted/taken-over peer answered a resumed
                        # send: back in the membership
                        with self._mu:
                            self._dead.discard(pid)
                            self._down_since.pop(pid, None)
                        self._event("membership", peer=pid, state="up",
                                    rejoined=True)
                    continue
                if not down:
                    if self._down_since.pop(pid, None) is not None:
                        self._event("membership", peer=pid, state="up")
                    continue
                t0 = self._down_since.setdefault(pid, now)
                if t0 == now:
                    self._event("membership", peer=pid, state="down",
                                deadline=deadline)
                elif now - t0 >= deadline:
                    self._declare_dead(pid, now - t0)
            with self._mu:
                members = len(self.addresses) - len(self._dead)
                n_down = len(self._down_since)
            self._set_gauge("plane_members", members)
            self._set_gauge("plane_down", n_down)

    def _declare_dead(self, pid: int, down_for: float):
        with self._mu:
            self._dead.add(pid)
            self._down_since.pop(pid, None)
        successor = self.successor_for(pid)
        self._event("membership", peer=pid, state="dead",
                    down_for=round(down_for, 3), successor=successor)
        if self.on_death is not None:
            try:
                self.on_death(pid, down_for)
            except Exception:  # noqa: BLE001 — telemetry must not
                pass           # block the handoff path
        if successor == self.my_pid:
            self._adopt(pid)

    # -------------------------------------------------------------- handoff

    def _adopt(self, dead_pid: int):
        """This process won the election for ``dead_pid``'s nodes: look
        up its newest spooled portable checkpoint and hand both to the
        application's restore hook."""
        with self._mu:
            if dead_pid in self._adopted:
                return
            self._adopted.add(dead_pid)
        self._event("handoff", dead=dead_pid, successor=self.my_pid,
                    phase="elected")
        epoch, store = None, None
        if self.spool is not None:
            found = self.spool.latest(dead_pid)
            if found is not None:
                epoch = found[0]
                store = self.spool.store_for(dead_pid)
        self._count("plane_handoffs")
        try:
            if self.on_adopt is not None:
                self.on_adopt(dead_pid, epoch, store)
        except Exception as e:  # noqa: BLE001 — the hook is user code
            self._event("handoff", dead=dead_pid, successor=self.my_pid,
                        phase="failed", epoch=epoch,
                        error=type(e).__name__, message=str(e))
            raise
        self._event("handoff", dead=dead_pid, successor=self.my_pid,
                    phase="adopted", epoch=epoch)

    def takeover_receiver(self, dead_pid: int, epoch, n_senders: int,
                          capacity: int = 64, ckpt_sink=None):
        """Rebind a dead peer's plane address as a resumable receiver
        resuming from its last sealed epoch: every journaling sender
        that fed the dead process reconnects here (same host:port),
        gets ``WELCOME {"epoch": K}``, and replays its tail since that
        barrier — which is exactly the wire the restored state needs
        next.  The caller consumes it like any plane receiver."""
        from .channel import RowReceiver, WireConfig
        wire = self.policy.wire or WireConfig.hardened()
        host, port = self.addresses[dead_pid]
        return RowReceiver(
            n_senders=n_senders, host=host, port=port, capacity=capacity,
            metrics=self._metrics, events=self._events,
            resume=wire.resume or True,
            resume_epoch=None if epoch is None else int(epoch),
            ckpt_sink=ckpt_sink, wire=wire)

    # ---------------------------------------------------------- replication

    def replicate(self, epoch: int) -> int:
        """Ship this process's sealed epoch to every live peer (the
        portable ``-7`` family) so a successor can restore it after our
        death; returns total bytes shipped.  Per-peer failures are
        swallowed (the peer may itself be mid-restart — the next seal
        re-ships), so the hook is safe on the seal path."""
        if self.store is None:
            raise RuntimeError("replicate() needs a PlaneSupervisor "
                               "built with store= (this process's "
                               "CheckpointStore)")
        from ..recovery.portable import ship_checkpoint
        total = 0
        for pid in self.live():
            snd = self.senders.get(pid)
            if snd is None:
                continue
            if (getattr(snd, "_link_down", False)
                    or getattr(snd, "_hb_error", None) is not None):
                # a down link must not block the seal path for a whole
                # reconnect cycle: skip now, the next seal re-ships
                continue
            try:
                total += ship_checkpoint(snd, self.store, epoch,
                                         origin=self.my_pid)
            except (OSError, ValueError):
                continue
        return total

    def attach(self, dataflow) -> "PlaneSupervisor":
        """Wire :meth:`replicate` onto a recovering Dataflow's seal
        boundary (``Dataflow.on_epoch_sealed``): every sealed epoch is
        replicated to the plane the moment it becomes durable — the
        cadence that keeps a successor at most one epoch behind."""
        dataflow.on_epoch_sealed(self.replicate)
        return self

    # -------------------------------------------------------------- plumbing

    def _event(self, kind: str, **fields):
        if self._events is not None:
            self._events.emit(kind, plane=self.my_pid, **fields)

    def _count(self, name: str, n: int = 1):
        if self._metrics is not None:
            self._metrics.counter(name).inc(n)

    def _set_gauge(self, name: str, v):
        if self._metrics is not None:
            self._metrics.gauge(name).set(v)


def open_supervised_plane(my_pid: int, addresses: dict,
                          policy: PlanePolicy = None, spool_dir=None,
                          store=None, capacity: int = 64, metrics=None,
                          events=None, on_adopt=None,
                          resume_epoch: int = None, telemetry_sink=None,
                          on_death=None):
    """One-call supervised plane: ``open_row_plane`` with a hardened
    RESUMABLE wire (the supervisor's handoff promise needs journals —
    WF216), a :class:`~windflow_tpu_torch.recovery.portable.PortableSpool`
    at ``spool_dir`` as the receiver's ``ckpt_sink``, and a started
    :class:`PlaneSupervisor`.  Returns ``(receiver, senders,
    supervisor)``."""
    from .channel import WireConfig
    from .multihost import open_row_plane
    from ..recovery.portable import PortableSpool
    policy = policy or PlanePolicy()
    if policy.wire is None:
        policy.wire = WireConfig(connect_deadline=60.0, heartbeat=2.0,
                                 stall_timeout=10.0, resume=True,
                                 recovery=True)
    spool = (PortableSpool(spool_dir, metrics=metrics, events=events)
             if spool_dir is not None else None)
    receiver, senders = open_row_plane(
        my_pid, addresses, capacity=capacity, wire=policy.wire,
        metrics=metrics, events=events, resume_epoch=resume_epoch,
        ckpt_sink=spool, telemetry_sink=telemetry_sink)
    sup = PlaneSupervisor(my_pid, addresses, senders, policy=policy,
                          store=store, spool=spool, metrics=metrics,
                          events=events, on_adopt=on_adopt,
                          on_death=on_death).start()
    return receiver, senders, sup
