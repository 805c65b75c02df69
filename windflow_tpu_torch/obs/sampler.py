"""Background metrics sampler — the thread that makes a *running* graph
visible: every ``period`` seconds it snapshots per-node inbox depth /
high-water mark, shed and quarantine counters, the live
``tracing.NodeStats`` counters, the dead-letter count, and the attached
:class:`~windflow_tpu_torch.obs.registry.MetricsRegistry` (wire counters, user
metrics) into one JSON line of ``<trace_dir>/metrics.jsonl``.

The sampler is owned by the :class:`~windflow_tpu_torch.runtime.engine.Dataflow`
that configured ``sample_period=``: started in ``run()``, stopped (with a
final flush sample) in ``wait()``.  Without ``sample_period`` no thread
exists at all, and node hot paths carry only the inbox high-water-mark
branch (docs/OBSERVABILITY.md §overhead).

Everything here reads engine state *racily on purpose*: the sampled
values are ints/floats written under the GIL by the node threads, so a
sample is internally slightly torn but each field is a real observed
value — the standard monitoring trade.  A node mid-mutation (counter
dict resize) is skipped for that one sample rather than crashing the
sampler.
"""

from __future__ import annotations

import json
import os
import threading
import time

from ..utils.tracing import node_stats_name


class Sampler:
    """Periodic snapshotter for one Dataflow (see module docstring)."""

    def __init__(self, dataflow, period: float,
                 max_bytes: int = 64 << 20, keep: int = 2):
        self.df = dataflow
        self.period = float(period)
        if self.period <= 0:
            raise ValueError(f"sample_period must be positive, "
                             f"got {period}")
        #: size bound on metrics.jsonl: past it the file
        #: rolls to ``metrics.jsonl.1`` (older generations shift up,
        #: ``keep`` of them retained) — long soaks must not grow the
        #: file without limit.  ``max_bytes=None`` = unbounded.
        #: Rotation happens between whole lines, so tailing readers
        #: (``wf_top.read_samples``) detect the roll by file shrink and
        #: never see a torn record.
        self.max_bytes = None if max_bytes is None else int(max_bytes)
        if self.max_bytes is not None and self.max_bytes < 1:
            raise ValueError("Sampler max_bytes must be positive")
        self.keep = int(keep)
        if self.keep < 1:
            raise ValueError("Sampler keep must retain at least one "
                             "rotated file")
        self._written = 0
        self._path = None
        self._stop = threading.Event()
        self._last_shed: dict[str, int] = {}
        self._subs: list = []
        #: last exception a subscriber raised (diagnostics; the sampler
        #: itself never dies on a bad subscriber)
        self.sub_error = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"{dataflow.name}/sampler")
        #: samples taken (monotone; the "seq" field of the next line)
        self.seq = 0

    # ------------------------------------------------------------ lifecycle

    def subscribe(self, fn):
        """Register an in-process snapshot consumer: ``fn(rec)`` is
        called on the sampler thread with every sample dict (the
        pre-serialisation ``metrics.jsonl`` record) — the control
        plane's sensor bus (docs/CONTROL.md), and the way any in-process
        supervisor reads live telemetry without tailing files.

        Contract: treat ``rec`` as read-only (the same dict is
        serialised to disk afterwards), return fast (the callback runs
        between samples), and raise nothing you care about — a
        subscriber exception is recorded on ``sub_error`` and swallowed
        so one bad consumer cannot kill everyone's telemetry.
        ``sample()`` itself stays a pure read; only the thread-owned
        ``_write_sample`` fans out to subscribers."""
        self._subs.append(fn)

    def start(self):
        self._thread.start()

    def stop(self, timeout: float = 5.0):
        """Request shutdown and wait for the final flush sample."""
        self._stop.set()
        self._thread.join(timeout=timeout)

    def _run(self):
        f = None
        if self.df.trace_dir:
            os.makedirs(self.df.trace_dir, exist_ok=True)
            self._path = os.path.join(self.df.trace_dir, "metrics.jsonl")
            f = open(self._path, "a")
            self._written = os.path.getsize(self._path)
        try:
            while True:
                f = self._write_sample(f)
                if self._stop.wait(self.period):
                    break
            f = self._write_sample(f)   # final: the end-state snapshot
        finally:
            if f is not None:
                f.close()

    def _rotate(self, f):
        """Roll metrics.jsonl -> .1 (older generations shift up, keep-N
        bounded) and return a fresh handle.  Runs on the sampler thread
        between whole lines."""
        f.close()
        last = f"{self._path}.{self.keep}"
        if os.path.exists(last):
            os.remove(last)
        for i in range(self.keep - 1, 0, -1):
            src = f"{self._path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self._path}.{i + 1}")
        os.replace(self._path, f"{self._path}.1")
        self._written = 0
        return open(self._path, "a")

    # ------------------------------------------------------------- sampling

    def _node_entry(self, idx: int, node) -> dict:
        inbox = self.df._inboxes.get(id(node))
        node_id = node_stats_name(self.df.name, idx, node.name)
        entry = {
            "node": node.name,
            "id": node_id,
            "depth": int(inbox.depth()) if inbox is not None else 0,
            "hwm": int(getattr(inbox, "hwm", 0)),
            "shed": int(getattr(inbox, "shed", 0)),
            "quarantined": 0,
        }
        stats = node.stats
        if stats is not None:
            entry["quarantined"] = int(stats.counters.get("quarantined", 0))
            entry["rcv_batches"] = stats.rcv_batches
            entry["rcv_tuples"] = stats.rcv_tuples
            entry["ewma_service_us_per_batch"] = round(stats.ewma_ts_us, 3)
            entry["avg_service_us_per_batch"] = round(stats.avg_ts_us, 3)
        tracer = getattr(self.df, "tracer", None)
        if tracer is not None:
            # span-tracing latency sensors (obs/trace.py): per-node
            # queue-wait/service p50/p95/p99 (µs) read off the tracer's
            # fixed-bucket histograms — the fields ControlPolicy rules
            # threshold on (Rescale(up_q95_us=), docs/CONTROL.md).
            # Absent until the node saw a traced batch, so consumers of
            # pre-trace metrics.jsonl lines see no new keys.
            lat = tracer.latency_snapshot(node_id)
            if lat:
                entry.update(lat)
        return entry

    def sample(self) -> dict:
        """One observation of the whole graph (the metrics.jsonl line,
        pre-serialisation) — a pure read, safe to call synchronously
        (wf_top --expo, tests) while the background thread runs; only
        the thread-owned ``_write_sample`` advances seq and emits shed
        events."""
        df = self.df
        nodes = []
        for idx, node in enumerate(df.nodes):
            try:
                nodes.append(self._node_entry(idx, node))
            except Exception:   # noqa: BLE001 — torn read during a node's
                continue        # dict resize: skip it for this sample
        rec = {
            "t": time.time(),
            "seq": self.seq,
            "dataflow": df.name,
            "nodes": nodes,
            "dead_letters": len(df.dead_letters),
        }
        if df.metrics is not None:
            rec.update(df.metrics.snapshot())
        return rec

    def _emit_shed_events(self, nodes):
        """Transition-based shed events: one per node per period at most
        (per-item events would melt the log under sustained overload),
        carrying the delta since the last sample."""
        ev = self.df.events
        if ev is None:
            return
        for n in nodes:
            prev = self._last_shed.get(n["id"], 0)
            if n["shed"] > prev:
                ev.emit("shed", dataflow=self.df.name, node=n["node"],
                        n=n["shed"] - prev, total=n["shed"])
            self._last_shed[n["id"]] = n["shed"]

    def _write_sample(self, f):
        rec = self.sample()
        self.seq += 1
        self._emit_shed_events(rec["nodes"])
        for fn in self._subs:
            try:
                fn(rec)
            except Exception as e:  # noqa: BLE001 — see subscribe()
                first = self.sub_error is None
                self.sub_error = e
                # a silently-dead subscriber (e.g. the control plane's
                # controller) must still be observable: count every
                # failure, warn once on the first
                m = self.df.metrics
                if m is not None:
                    m.counter("sampler_subscriber_errors").inc()
                if first:
                    import warnings
                    warnings.warn(
                        f"sampler subscriber {getattr(fn, '__qualname__', fn)!r} "
                        f"raised {type(e).__name__}: {e} (further "
                        f"failures only count sampler_subscriber_errors)",
                        stacklevel=2)
        if f is not None:
            line = json.dumps(rec) + "\n"
            if (self.max_bytes is not None and self._written
                    and self._written + len(line) > self.max_bytes):
                f = self._rotate(f)
            f.write(line)
            f.flush()
            self._written += len(line)
        return f
