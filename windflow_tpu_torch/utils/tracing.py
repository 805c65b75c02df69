"""Per-node tracing — the runtime-enabled equivalent of the reference's
compile-time ``-DLOG_DIR`` instrumentation (map.hpp:85-91,116-176,
win_seq.hpp:128-138,479-501, win_seq_gpu.hpp:175-185,598-611): every node
keeps received-batch/tuple counters, a running and EWMA service time, the
inter-departure time, and (window nodes) the triggering vs non-triggering
split; at ``svc_end`` the counters are written to
``<dir>/<node_name>.log`` as one JSON object.

Enabled at runtime (no recompilation): pass ``trace_dir=`` to
:class:`~windflow_tpu_torch.runtime.engine.Dataflow` / ``MultiPipe``, or set the
``WF_LOG_DIR`` environment variable (the spiritual ``-DLOG_DIR``).

These counters also feed the *live* observability layer: when the
dataflow runs with ``metrics=`` / ``sample_period=`` the engine creates a
``NodeStats`` per node even without a trace dir, and the background
sampler (obs/sampler.py) reads ``snapshot()``-equivalent fields racily
while the graph runs — end-of-run files stay gated on ``trace_dir``
alone, so the seed tracing behavior is unchanged.
"""

from __future__ import annotations

import json
import os
import time

#: EWMA smoothing for service/inter-departure times (the reference keeps a
#: plain running average; we record both)
ALPHA = 0.1


def node_stats_name(dataflow_name: str, idx: int, node_name: str) -> str:
    """Canonical per-node id: the NodeStats name, the ``<trace_dir>/*.log``
    filename stem, and the ``id`` field of every metrics.jsonl node entry
    — one definition so the three can never drift apart."""
    return f"{dataflow_name}_{idx:02d}_{node_name}"


class NodeStats:
    """Counter block attached to a node when tracing is enabled."""

    __slots__ = ("name", "rcv_batches", "rcv_tuples", "svc_time_ns_total",
                 "avg_ts_us", "ewma_ts_us", "departures", "last_dep_ns",
                 "avg_td_us", "counters", "started_ns", "wait_in_ns_total",
                 "put_wait_ns_total", "generate_ns_total", "push_ns_total",
                 "stages", "states")

    def __init__(self, name: str, states: bool = False):
        self.name = name
        self.rcv_batches = 0
        self.rcv_tuples = 0
        self.svc_time_ns_total = 0
        self.avg_ts_us = 0.0      # running mean service time per batch
        self.ewma_ts_us = 0.0     # EWMA service time per batch
        self.departures = 0
        self.last_dep_ns = None
        self.avg_td_us = 0.0      # running mean inter-departure time
        self.counters = {}        # node-specific extras (windows_fired, ...)
        self.started_ns = time.perf_counter_ns()
        # operator states (engine.py), kept only where `states` (the node
        # logs, their one reader, are written): idle waiting for input,
        # blocked on the next operator's full inbox (its inbox puts, summed
        # when the node ends)
        self.states = states
        self.wait_in_ns_total = 0
        self.put_wait_ns_total = 0
        # sources: the wall time of generate(), and the part of it spent
        # pushing batches into the stages fused after the source (None
        # where the source has no pushing shell, patterns/basic.py)
        self.generate_ns_total = None
        self.push_ns_total = None
        # fused nodes (comb.py): {stage name: [exclusive ns, tuples,
        # batches]}
        self.stages = None

    # -- recording (hot path: branch-free beyond attribute math) -----------

    def record_svc(self, n_rows: int, dt_ns: int):
        self.rcv_batches += 1
        self.rcv_tuples += n_rows
        self.svc_time_ns_total += dt_ns
        us = dt_ns / 1e3
        n = self.rcv_batches
        self.avg_ts_us += (us - self.avg_ts_us) / n
        self.ewma_ts_us = (us if n == 1
                           else self.ewma_ts_us + ALPHA * (us - self.ewma_ts_us))

    def record_departure(self):
        now = time.perf_counter_ns()
        if self.last_dep_ns is not None:
            td_us = (now - self.last_dep_ns) / 1e3
            self.departures += 1
            self.avg_td_us += (td_us - self.avg_td_us) / self.departures
        self.last_dep_ns = now

    def bump(self, counter: str, n: int = 1):
        self.counters[counter] = self.counters.get(counter, 0) + n

    def record_shed(self, n: int = 1):
        """Items dropped from this node's inbox by a shedding
        OverloadPolicy (runtime/overload.py) — folded in once at node
        end by the engine, so the hot path stays counter-free."""
        self.bump("shed", n)

    def record_quarantined(self, n: int = 1):
        """Poison batches parked in the dead-letter queue instead of
        tearing the graph down (error-budget quarantine)."""
        self.bump("quarantined", n)

    # -- reporting ----------------------------------------------------------

    def snapshot(self) -> dict:
        alive_s = (time.perf_counter_ns() - self.started_ns) / 1e9
        snap = {
            "node": self.name,
            "rcv_batches": self.rcv_batches,
            "rcv_tuples": self.rcv_tuples,
            "svc_time_ms_total": round(self.svc_time_ns_total / 1e6, 3),
            "avg_service_us_per_batch": round(self.avg_ts_us, 3),
            "ewma_service_us_per_batch": round(self.ewma_ts_us, 3),
            "avg_interdeparture_us": round(self.avg_td_us, 3),
            "alive_sec": round(alive_s, 3),
            **self.counters,
        }
        if not self.states:
            return snap
        snap["wait_in_ms_total"] = round(self.wait_in_ns_total / 1e6, 3)
        snap["put_wait_ms_total"] = round(self.put_wait_ns_total / 1e6, 3)
        snap.update(self._source_fields())
        if self.stages is not None:
            snap["stages"] = {
                k: {"svc_ms_total": round(ns / 1e6, 3), "rcv_tuples": n,
                    "rcv_batches": b}
                for k, (ns, n, b) in self.stages.items()}
        return snap

    def _source_fields(self) -> dict:
        if self.generate_ns_total is None:
            return {}
        out = {"generate_ms_total": round(self.generate_ns_total / 1e6, 3)}
        if self.push_ns_total is not None:
            # the generator's own time (making or pulling its batches)
            out["push_ms_total"] = round(self.push_ns_total / 1e6, 3)
            out["pull_ms_total"] = round(
                (self.generate_ns_total - self.push_ns_total) / 1e6, 3)
        return out

    def write(self, trace_dir: str):
        os.makedirs(trace_dir, exist_ok=True)
        safe = self.name.replace("/", "_")
        path = os.path.join(trace_dir, f"{safe}.log")
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
            f.write("\n")


def default_trace_dir() -> str | None:
    """The WF_LOG_DIR environment hook (the -DLOG_DIR analog)."""
    return os.environ.get("WF_LOG_DIR") or None


def default_sample_period() -> float | None:
    """The WF_SAMPLE_PERIOD environment hook: seconds between live
    metrics samples (obs/sampler.py).  Lets any existing program — the
    benchmarks, scripts/soak_overload.py — opt into in-flight telemetry
    with no code change, exactly like WF_LOG_DIR enables end-of-run
    tracing.  Unset/empty = no sampler thread (docs/OBSERVABILITY.md)."""
    raw = os.environ.get("WF_SAMPLE_PERIOD")
    if not raw:
        return None
    period = float(raw)
    if period <= 0:
        raise ValueError(
            f"WF_SAMPLE_PERIOD must be positive seconds, got {raw!r}")
    return period
