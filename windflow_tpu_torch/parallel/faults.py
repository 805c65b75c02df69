"""Deterministic wire fault injection — the chaos harness of the
resumable row plane (docs/ROBUSTNESS.md "Wire resume").

A :class:`FaultPlan` is a *schedule*, not a probability: it names the
exact logical records (1-based, counted per :class:`~windflow_tpu_torch.
parallel.channel.RowSender` across original sends AND replays) at which
the sender's transmit path misbehaves.  Threaded in under
``WireConfig(faults=...)``, which is the only coupling — ``channel.py``
never imports this module, so a plan-less wire stays byte-identical to
the seed and this file is never even loaded (the standing knob
contract; verified in tests/test_channel_faults.py).

Four fault kinds, mirroring how TCP edges die in practice:

* ``kill``  — the connection drops between frames (peer crash, RST);
* ``torn``  — the connection drops *mid-frame* (power loss while the
  kernel had half a write buffered): the receiver sees a truncated
  frame, the framing resyncs only on a fresh connection;
* ``dup``   — the record is delivered twice (the replay race every
  at-least-once transport has): the receiver must dedup by seq;
* ``stall`` — the link goes silent for ``stall_for`` seconds and then
  drops: long enough past a receiver ``stall_timeout`` to surface as
  :class:`~windflow_tpu_torch.parallel.channel.PeerStall`.

``FaultPlan.seeded(seed)`` derives a reproducible schedule from one
integer — the soak driver's (scripts/soak_wire.py) repro contract: a
failing seed is the whole bug report.
"""

from __future__ import annotations

import random

KINDS = ("kill", "torn", "dup", "stall")


class FaultPlan:
    """Explicit schedule: each ``*_at`` is an iterable of 1-based record
    counts at which that fault fires (a record is one data batch or one
    epoch frame leaving a RowSender, replays included).  Counts must be
    disjoint across kinds — one record dies at most one way."""

    __slots__ = ("kill_at", "torn_at", "dup_at", "stall_at", "stall_for",
                 "seed")

    def __init__(self, kill_at=(), torn_at=(), dup_at=(), stall_at=(),
                 stall_for: float = 0.5, seed=None):
        self.kill_at = frozenset(int(n) for n in kill_at)
        self.torn_at = frozenset(int(n) for n in torn_at)
        self.dup_at = frozenset(int(n) for n in dup_at)
        self.stall_at = frozenset(int(n) for n in stall_at)
        self.stall_for = float(stall_for)
        self.seed = seed
        sets = (self.kill_at, self.torn_at, self.dup_at, self.stall_at)
        total = self.kill_at | self.torn_at | self.dup_at | self.stall_at
        if len(total) != sum(len(s) for s in sets):
            raise ValueError("FaultPlan schedules overlap: a record can "
                             "suffer at most one fault kind")
        if any(n < 1 for n in total):
            raise ValueError("FaultPlan record counts are 1-based")

    @classmethod
    def seeded(cls, seed: int, horizon: int = 48, n_faults: int = 3,
               kinds=KINDS, stall_for: float = 0.5) -> "FaultPlan":
        """A reproducible plan: ``n_faults`` fault points drawn without
        replacement from records ``[2, horizon]`` (never the first
        record, so every schedule exercises an *established* link), each
        assigned a kind from ``kinds`` — all driven by one stdlib
        ``random.Random(seed)``, so the same seed is the same chaos on
        every host and every rerun."""
        bad = [k for k in kinds if k not in KINDS]
        if bad:
            raise ValueError(f"unknown fault kind(s) {bad}; "
                             f"choose from {KINDS}")
        rng = random.Random(seed)
        lo, hi = 2, max(2, int(horizon))
        points = rng.sample(range(lo, hi + 1),
                            min(int(n_faults), hi - lo + 1))
        sched = {k: [] for k in KINDS}
        for p in sorted(points):
            sched[rng.choice(list(kinds))].append(p)
        return cls(kill_at=sched["kill"], torn_at=sched["torn"],
                   dup_at=sched["dup"], stall_at=sched["stall"],
                   stall_for=stall_for, seed=seed)

    def action_for(self, n: int):
        """The fault to inject at record count ``n`` (or None): the one
        hook the sender's transmit path calls."""
        if n in self.kill_at:
            return "kill"
        if n in self.torn_at:
            return "torn"
        if n in self.dup_at:
            return "dup"
        if n in self.stall_at:
            return "stall"
        return None

    def __repr__(self):
        parts = [f"{k}_at={sorted(getattr(self, k + '_at'))}"
                 for k in KINDS if getattr(self, k + "_at")]
        if self.seed is not None:
            parts.append(f"seed={self.seed}")
        return f"FaultPlan({', '.join(parts)})"

class HandoffChaos:
    """Plane-level chaos schedule — the handoff analogue of
    :class:`FaultPlan` (scripts/soak_handoff.py): at which SEALED epoch
    a plane worker dies (``kill``: its successor adopts via the
    replicated portable checkpoint, docs/ROBUSTNESS.md "Cross-host
    recovery") or rolls (``roll``: the same member restarts against its
    own store with ``resume_epoch=``).  Explicit and seeded like every
    plan here: a failing seed is the whole bug report."""

    __slots__ = ("kill", "roll", "seed")

    def __init__(self, kill=(), roll=(), seed=None):
        #: pid -> sealed epoch at which the event fires
        self.kill = {int(p): int(e) for p, e in kill}
        self.roll = {int(p): int(e) for p, e in roll}
        self.seed = seed
        if set(self.kill) & set(self.roll):
            raise ValueError("HandoffChaos schedules overlap: a worker "
                             "cannot both die and roll")
        if any(e < 1 for e in (*self.kill.values(), *self.roll.values())):
            raise ValueError("HandoffChaos epochs are 1-based")

    @classmethod
    def seeded(cls, seed: int, pids, last_epoch: int,
               kinds=("kill", "roll")) -> "HandoffChaos":
        """One reproducible plane event: a pid from ``pids`` suffers a
        kind from ``kinds`` at a sealed epoch in ``[1, last_epoch - 1]``
        (never the final epoch, so every schedule leaves a tail for the
        successor/restart to consume)."""
        bad = [k for k in kinds if k not in ("kill", "roll")]
        if bad:
            raise ValueError(f"unknown handoff kind(s) {bad}; "
                             f"choose from ('kill', 'roll')")
        rng = random.Random(seed)
        pid = rng.choice(sorted(pids))
        epoch = rng.randint(1, max(1, int(last_epoch) - 1))
        kind = rng.choice(sorted(kinds))
        return cls(seed=seed, **{kind: [(pid, epoch)]})

    def event_at(self, pid: int, epoch: int):
        """``"kill"``/``"roll"``/None for worker ``pid`` at the moment
        epoch ``epoch`` seals — the one hook the soak's worker loop
        calls."""
        if self.kill.get(int(pid)) == int(epoch):
            return "kill"
        if self.roll.get(int(pid)) == int(epoch):
            return "roll"
        return None

    def __repr__(self):
        parts = []
        if self.kill:
            parts.append(f"kill={sorted(self.kill.items())}")
        if self.roll:
            parts.append(f"roll={sorted(self.roll.items())}")
        if self.seed is not None:
            parts.append(f"seed={self.seed}")
        return f"HandoffChaos({', '.join(parts)})"
