"""Shared per-result latency accounting for the benchmark sinks.

Every benchmark (pipe, ysb, spatial) reports the reference's headline
metric pair — throughput AND per-result latency (ysb_nodes.hpp:231-246)
— so the accumulate-then-percentile step lives here once: collect
per-batch latency arrays, summarize as avg/p50/p95/p99 + n.  Callers pick their
own field names/units at the edge (µs for ysb's reference-parity stdout,
ms elsewhere)."""

from __future__ import annotations

import numpy as np


def summarize(lat_arrays, scale: float = 1.0, ndigits: int = 2) -> dict:
    """avg/p50/p95/p99 plus ``n`` (result count) over the concatenation
    of ``lat_arrays`` (each a 1-d array of per-result latencies),
    multiplied by ``scale`` (e.g. 1e-3 for µs -> ms).  The median makes
    tail-vs-typical splits readable (a p95 triple the p50 is a tail
    problem; both high is a throughput problem) and ``n`` sizes the
    sample the percentiles stand on.  Empty input -> empty dict, so
    callers can splat the result without guarding."""
    arrays = [np.asarray(a, dtype=np.float64) for a in lat_arrays
              if a is not None and len(a)]
    if not arrays:
        return {}
    lat = np.concatenate(arrays) * scale
    p50, p95, p99 = np.percentile(lat, (50, 95, 99))
    return {"avg": round(float(lat.mean()), ndigits),
            "p50": round(float(p50), ndigits),
            "p95": round(float(p95), ndigits),
            "p99": round(float(p99), ndigits),
            "n": int(lat.size)}
