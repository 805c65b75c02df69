"""Observability layer (docs/OBSERVABILITY.md): live metrics registry,
structured runtime event log, background sampler, and Prometheus-style
text exposition.

The reference's only instrumentation is the compile-time ``-DLOG_DIR``
end-of-run counter dump (reproduced by ``utils/tracing.py``); this
package adds the *in-flight* view — per-node occupancy, shed/quarantine
and wire counters sampled while the graph runs — under the same opt-in
contract as ``runtime/overload.py``: knobs unset ⇒ no threads, no
files, seed-identical behavior.
"""

from .events import EVENT_KINDS, EventLog
from .registry import (DEFAULT_BUCKETS, Counter, Gauge, Histogram,
                       MetricsRegistry)
from .sampler import Sampler

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "DEFAULT_BUCKETS",
    "EventLog", "EVENT_KINDS", "Sampler",
]
