"""Structured runtime event log — what *happened* to the graph, not how
fast it ran: node start/stop, per-channel EOS, shed and quarantine,
wire reconnect attempts, heartbeat failures, peer stalls/aborts
(docs/OBSERVABILITY.md lists the full vocabulary).

Events are rare by construction (lifecycle transitions and failures, at
most one shed event per sampler period — never per item), so the log can
afford a JSON line per event.  When a file path is configured the log
appends to ``<trace_dir>/events.jsonl``; it always keeps a bounded
in-memory ring (``recent``) so in-process supervisors and tests can read
the tail without touching the filesystem.  The file is opened lazily on
the first emit — constructing an EventLog (e.g. for a preview graph that
never runs) creates nothing on disk.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

#: the event vocabulary (docs/OBSERVABILITY.md); emitters must use these
EVENT_KINDS = frozenset({
    # engine lifecycle
    "dataflow_start", "dataflow_stop", "node_start", "node_stop",
    "node_error", "eos",
    # overload / robustness (runtime/overload.py)
    "shed", "quarantine",
    # wire (parallel/channel.py)
    "reconnect_attempt", "heartbeat_miss", "peer_stall", "peer_abort",
    # wire resume (docs/ROBUSTNESS.md "Wire resume"): an established
    # edge went down / was re-established with its journal tail replayed
    "wire_down", "wire_resume",
    # recovery (windflow_tpu/recovery/, docs/ROBUSTNESS.md "Recovery")
    "epoch", "checkpoint", "checkpoint_commit", "checkpoint_skip",
    "restore", "node_restart", "recovery_giveup",
    # cross-host recovery (parallel/plane.py, recovery/portable.py,
    # docs/ROBUSTNESS.md "Cross-host recovery"): membership transitions
    # of a supervised plane, successor handoff phases, the drain
    # actuator's quiesce phases, and a checkpoint store skipping a
    # torn/corrupt epoch at latest_complete()
    "membership", "handoff", "drain", "checkpoint_fallback",
    # static analysis (windflow_tpu/check/, docs/CHECKS.md): one event
    # per pre-flight diagnostic when the check= knob runs on an
    # observed graph
    "check",
    # control plane (windflow_tpu/control/, docs/CONTROL.md): one
    # `control` event per controller decision (rescale request, shed
    # tighten/relax, admission rate move), one `rescale` event per
    # completed epoch-barrier migration
    "control", "rescale",
    # span tracing (obs/trace.py): spans discarded past the trace.jsonl
    # max_spans bound — rate-limited, carries the running drop total
    "trace_drop",
    # federation & SLOs (obs/federation.py, obs/slo.py,
    # docs/OBSERVABILITY.md "Federation & SLOs"): burn-rate state
    # transitions (state burn/ok), a peer's federated snapshots going
    # stale/fresh at the aggregator, and black-box dumps (the local
    # flight recorder AND the aggregator's spool of a dead peer)
    "slo_burn", "fed_peer", "blackbox",
})


class EventLog:
    """Thread-safe append-only event sink: bounded memory ring + optional
    JSONL file (one ``{"t": ..., "event": ..., ...}`` object per line,
    flushed per event — events are rare, and a crash must not lose the
    events explaining it)."""

    def __init__(self, path: str = None, keep: int = 512,
                 max_bytes: int = None):
        self.path = path
        self.recent = deque(maxlen=keep)
        #: optional size bound on the file: past it the file
        #: rolls to ``<path>.1`` (one rotated generation) and a fresh
        #: file opens.  None (default) = unbounded, the seed behavior.
        #: Rotation happens BETWEEN events, so the per-event flush
        #: contract holds: every emitted event is durable in either the
        #: live file or the rolled one before emit() returns.
        self.max_bytes = None if max_bytes is None else int(max_bytes)
        if self.max_bytes is not None and self.max_bytes < 1:
            raise ValueError("EventLog max_bytes must be positive")
        self._mu = threading.Lock()
        self._f = None
        self._written = 0
        self._closed = False

    def emit(self, event: str, **fields):
        if event not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {event!r} "
                             f"(add it to obs.events.EVENT_KINDS)")
        rec = {"t": time.time(), "event": event, **fields}
        with self._mu:
            self.recent.append(rec)
            # after close() the log drops to ring-only: a straggling wire
            # thread emitting during teardown must not reopen the file
            # (nothing would close it again) or write past dataflow_stop
            if self.path is not None and not self._closed:
                if self._f is None:
                    os.makedirs(os.path.dirname(self.path) or ".",
                                exist_ok=True)
                    self._f = open(self.path, "a")
                    self._written = os.path.getsize(self.path)
                line = json.dumps(rec) + "\n"
                if (self.max_bytes is not None and self._written
                        and self._written + len(line) > self.max_bytes):
                    # roll between events, never mid-line: a reader of
                    # .1 + live always sees whole JSON records
                    self._f.close()
                    os.replace(self.path, self.path + ".1")
                    self._f = open(self.path, "a")
                    self._written = 0
                self._f.write(line)
                self._f.flush()
                self._written += len(line)
        return rec

    def close(self):
        with self._mu:
            self._closed = True
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
