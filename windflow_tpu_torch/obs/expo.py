"""Prometheus-style text exposition of the live metrics.

Two sources render to the same format (text/plain; version=0.0.4):

* :func:`render_registry` — a :class:`~windflow_tpu_torch.obs.registry.
  MetricsRegistry` (or its ``snapshot()`` dict), prefixed ``wf_``.
  Registry names may embed labels in the Prometheus form
  (``trace_service_seconds{node="pipe_03_sink.0"}``, the convention the
  span tracer uses, obs/trace.py): all series of one base name render
  as ONE metric family — a single ``# HELP``/``# TYPE`` pair, each
  series keeping its labels, histogram ``_bucket`` lines merging the
  series labels with ``le`` — which is what the exposition spec
  requires (a family re-declared per series is a scrape error);
* :func:`render_sample` — one ``metrics.jsonl`` line (the sampler's
  per-node view): per-node gauges labelled ``{dataflow=...,node=...}``
  plus the embedded registry snapshot.

No HTTP server is shipped on purpose: serving one string is trivial in
any deployment (``python -m http.server`` wrappers, a sidecar, or
``scripts/wf_top.py --expo`` for ad-hoc scrapes), while binding ports
from inside the engine would be policy the runtime has no business
setting.
"""

from __future__ import annotations

_PREFIX = "wf"

#: per-node sample fields exposed as labelled gauges: sample key ->
#: (metric suffix, TYPE, HELP)
_NODE_FIELDS = {
    "depth": ("inbox_depth", "gauge", "current inbox occupancy (items)"),
    "hwm": ("inbox_hwm", "gauge", "inbox occupancy high-water mark"),
    "shed": ("shed_total", "counter", "items shed from this inbox"),
    "quarantined": ("quarantined_total", "counter",
                    "poison batches quarantined by this node"),
    "rcv_batches": ("rcv_batches_total", "counter", "batches processed"),
    "rcv_tuples": ("rcv_tuples_total", "counter", "tuples processed"),
    "ewma_service_us_per_batch": ("service_ewma_us", "gauge",
                                  "EWMA service time per batch (us)"),
    # span-tracing latency fields (obs/trace.py; present only on traced,
    # observed graphs — absent keys render nothing, so pre-trace samples
    # expose exactly the historical series)
    "q_p50_us": ("queue_wait_p50_us", "gauge",
                 "sampled inbox queue wait p50 (us)"),
    "q_p95_us": ("queue_wait_p95_us", "gauge",
                 "sampled inbox queue wait p95 (us)"),
    "q_p99_us": ("queue_wait_p99_us", "gauge",
                 "sampled inbox queue wait p99 (us)"),
    "svc_p50_us": ("service_p50_us", "gauge",
                   "sampled service time p50 (us)"),
    "svc_p95_us": ("service_p95_us", "gauge",
                   "sampled service time p95 (us)"),
    "svc_p99_us": ("service_p99_us", "gauge",
                   "sampled service time p99 (us)"),
}


def _esc(v) -> str:
    # the three escapes of the Prometheus text format's label values:
    # backslash, double-quote, and line feed (a raw newline would tear
    # the series line in two and fail the scrape)
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _line(name, labels, value):
    if labels:
        lab = ",".join(f'{k}="{_esc(v)}"' for k, v in labels.items())
        return f"{name}{{{lab}}} {value}"
    return f"{name} {value}"


def _header(name, mtype, help_text):
    return [f"# HELP {name} {help_text}", f"# TYPE {name} {mtype}"]


def _family(name: str, prefix: str):
    """Split a registry name into its (prefixed) family name and the
    raw label string: ``a_b{x="1"}`` -> (``wf_a_b``, ``x="1"``).  Names
    already starting with the prefix are kept verbatim (so a metric can
    pin its exposition name exactly)."""
    labels = None
    if name.endswith("}") and "{" in name:
        name, _, labels = name.partition("{")
        labels = labels[:-1]
    if not name.startswith(f"{prefix}_"):
        name = f"{prefix}_{name}"
    return name, labels


def _series(name: str, labels, value, extra: str = None):
    lab = ",".join(p for p in (labels, extra) if p)
    return f"{name}{{{lab}}} {value}" if lab else f"{name} {value}"


def render_registry(registry, prefix: str = _PREFIX) -> str:
    """Expose a MetricsRegistry (or its snapshot dict)."""
    snap = registry if isinstance(registry, dict) else registry.snapshot()
    out = []
    declared = set()

    def head(mn, mtype):
        # one HELP/TYPE per family, however many labelled series it has
        if mn not in declared:
            declared.add(mn)
            out.extend(_header(mn, mtype,
                               f"{mtype} {mn[len(prefix) + 1:]}"))

    for name, v in snap.get("counters", {}).items():
        mn, labels = _family(name, prefix)
        head(mn, "counter")
        out.append(_series(mn, labels, v))
    for name, v in snap.get("gauges", {}).items():
        mn, labels = _family(name, prefix)
        head(mn, "gauge")
        out.append(_series(mn, labels, v))
    for name, h in snap.get("histograms", {}).items():
        mn, labels = _family(name, prefix)
        head(mn, "histogram")
        for bound, cum in h["buckets"].items():
            out.append(_series(f"{mn}_bucket", labels, cum,
                               extra=f'le="{_esc(bound)}"'))
        out.append(_series(f"{mn}_bucket", labels, h["count"],
                           extra='le="+Inf"'))
        out.append(_series(f"{mn}_sum", labels, h["sum"]))
        out.append(_series(f"{mn}_count", labels, h["count"]))
    return "\n".join(out) + ("\n" if out else "")


def render_sample(sample: dict, prefix: str = _PREFIX) -> str:
    """Expose one sampler line (per-node gauges + embedded registry)."""
    out = []
    df = sample.get("dataflow", "")
    for key, (suffix, mtype, help_text) in _NODE_FIELDS.items():
        mn = f"{prefix}_node_{suffix}"
        lines = []
        for n in sample.get("nodes", []):
            if key in n:
                lines.append(_line(mn, {"dataflow": df, "node": n["node"]},
                                   n[key]))
        if lines:
            out += _header(mn, mtype, help_text)
            out += lines
    mn = f"{prefix}_dead_letters"
    out += _header(mn, "gauge", "quarantined batches in the dead-letter "
                                "queue")
    out.append(_line(mn, {"dataflow": df}, sample.get("dead_letters", 0)))
    reg = {k: sample[k] for k in ("counters", "gauges", "histograms")
           if k in sample}
    if reg:
        txt = render_registry(reg, prefix=prefix)
        if txt:
            out.append(txt.rstrip("\n"))
    return "\n".join(out) + "\n"
