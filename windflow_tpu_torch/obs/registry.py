"""Live metrics registry — counters, gauges, and fixed-bucket histograms
shared by the engine, the wire channels, and user code.

The reference has no runtime metrics at all: its only instrumentation is
the compile-time ``-DLOG_DIR`` counter dump at ``svc_end``
(map.hpp:85-176), reproduced by ``utils/tracing.py``.  This registry is
the *live* half of the observability layer (docs/OBSERVABILITY.md): a
process-wide or per-dataflow bag of named metrics that the background
sampler (obs/sampler.py) snapshots into ``metrics.jsonl`` and the text
exposition (obs/expo.py) renders Prometheus-style.

Contract (same as ``OverloadPolicy``): **knobs unset ⇒ seed-identical
behavior**.  Nothing in the runtime holds a registry unless one was
configured (``metrics=`` / ``sample_period=``), and every hot-path hook
is a single ``is not None`` branch on the consumer side.  The metric
objects themselves are cheap: one lock-guarded add per update (these are
per-batch / per-frame events, not per-row).
"""

from __future__ import annotations

import threading
from bisect import bisect_left

#: default histogram bucket upper bounds, in seconds — spanning the
#: sub-millisecond inbox hops to multi-second stalls the runtime sees
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: bucket bounds for the span tracer's queue-wait/service histograms
#: (obs/trace.py): finer at the bottom — inbox hops are routinely tens
#: of microseconds, and a p95 read off DEFAULT_BUCKETS would round every
#: healthy hop up to 0.5 ms
LATENCY_BUCKETS = (0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025,
                   0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)


class Counter:
    """Monotonically increasing count (events, bytes, frames)."""

    __slots__ = ("name", "_v", "_mu")

    def __init__(self, name: str):
        self.name = name
        self._v = 0
        self._mu = threading.Lock()

    def inc(self, n: int = 1):
        with self._mu:
            self._v += n

    @property
    def value(self):
        return self._v


class Gauge:
    """Last-write-wins instantaneous value (queue depth, connections)."""

    __slots__ = ("name", "_v", "_mu")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._mu = threading.Lock()

    def set(self, v: float):
        self._v = v  # single store: atomic under the GIL

    def inc(self, n: float = 1.0):
        with self._mu:
            self._v += n

    def dec(self, n: float = 1.0):
        with self._mu:
            self._v -= n

    @property
    def value(self):
        return self._v


class Histogram:
    """Fixed-bucket latency/size histogram: cumulative bucket counts in
    the Prometheus style (each bucket counts observations ``<= bound``,
    with an implicit ``+Inf`` bucket equal to ``count``)."""

    __slots__ = ("name", "bounds", "_counts", "_sum", "_count", "_mu")

    def __init__(self, name: str, buckets=DEFAULT_BUCKETS):
        self.name = name
        self.bounds = tuple(sorted(float(b) for b in buckets))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * len(self.bounds)
        self._sum = 0.0
        self._count = 0
        self._mu = threading.Lock()

    def observe(self, v: float):
        i = bisect_left(self.bounds, v)
        with self._mu:
            if i < len(self._counts):
                self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> dict:
        with self._mu:
            per_bucket = list(self._counts)
            total, s = self._count, self._sum
        cum = 0
        buckets = {}
        for bound, n in zip(self.bounds, per_bucket):
            cum += n
            buckets[repr(bound)] = cum
        return {"buckets": buckets, "sum": round(s, 9), "count": total}

    @property
    def count(self):
        return self._count

    def quantile(self, q: float):
        """Estimate the q-quantile (0..1) — see
        :func:`quantile_from_snapshot`; None on an empty histogram."""
        return quantile_from_snapshot(self.snapshot(), q)


def quantile_from_snapshot(h: dict, q: float):
    """Estimate the q-quantile (0..1) from a Histogram ``snapshot()``
    dict ({"buckets": {bound: cumulative}, "count": n}) by linear
    interpolation inside the containing bucket — the standard Prometheus
    ``histogram_quantile`` estimate, shared by the sampler's per-node
    latency fields, wf_top's columns, and wf_trace.  Returns None on an
    empty histogram; a quantile landing in the implicit +Inf bucket
    clamps to the top finite bound (the honest answer a bounded
    histogram can give)."""
    total = h.get("count", 0)
    if not total:
        return None
    rank = q * total
    prev_bound, prev_cum = 0.0, 0
    for bound, cum in h["buckets"].items():
        b = float(bound)
        if cum >= rank:
            if cum == prev_cum:
                return b
            frac = (rank - prev_cum) / (cum - prev_cum)
            return prev_bound + frac * (b - prev_bound)
        prev_bound, prev_cum = b, cum
    return prev_bound  # +Inf bucket: clamp to the top finite bound


class MetricsRegistry:
    """Get-or-create registry of named metrics.  Names are flat strings
    (``wire_bytes_sent``); creation is locked, updates lock only the one
    metric touched.  ``snapshot()`` returns plain JSON-ready dicts — the
    unit the sampler embeds in every ``metrics.jsonl`` line."""

    def __init__(self):
        self._mu = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            with self._mu:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name, *args)
                    self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, Histogram, buckets)

    def snapshot(self) -> dict:
        """{"counters": {name: int}, "gauges": {name: float},
        "histograms": {name: {"buckets", "sum", "count"}}} — stable JSON
        shape (docs/OBSERVABILITY.md schema)."""
        with self._mu:
            items = list(self._metrics.items())
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in sorted(items):
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.snapshot()
        return out
