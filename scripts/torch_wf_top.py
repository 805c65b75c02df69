"""Twin of scripts/wf_top.py over the PyTorch/CUDA port (windflow_tpu_torch):
the same CLI, seeds, cases and output lines, with every import taken from
the port.

wf_top — live terminal view of a running dataflow's telemetry.

Tails the ``metrics.jsonl`` the background sampler writes
(``Dataflow(sample_period=...)`` / ``WF_SAMPLE_PERIOD``, see
docs/OBSERVABILITY.md) and renders per-node throughput, inbox occupancy
and shed/quarantine counters, plus the tail of ``events.jsonl`` — the
`top(1)` of a WindFlow graph.  Rates are derived from consecutive
samples, so the view needs two samples to warm up.

    WF_LOG_DIR=/tmp/wf WF_SAMPLE_PERIOD=0.5 python my_job.py &
    python scripts/torch_wf_top.py /tmp/wf              # follow, 1 s refresh
    python scripts/torch_wf_top.py /tmp/wf --once       # one frame (CI/tests)
    python scripts/torch_wf_top.py /tmp/wf --expo       # Prometheus text dump
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_COLS = ("NODE", "DEPTH", "HWM", "BATCH/S", "TUPLES/S", "EWMA_US",
         "Q95_US", "S95_US", "SHED", "QUAR")
_W = (22, 6, 6, 10, 12, 9, 9, 9, 8, 6)


def _parse_lines(f):
    samples = []
    offset = f.tell()
    while True:
        line = f.readline()
        if not line:
            break
        if not line.endswith("\n"):
            break   # torn tail: re-read next refresh
        offset = f.tell()
        try:
            samples.append(json.loads(line))
        except json.JSONDecodeError:
            continue
    return samples, offset


def read_samples(path, offset=0):
    """Parse sample lines appended since ``offset``; returns
    (new_samples, new_offset).  A torn final line (writer mid-append) is
    left for the next read.  A file SHORTER than ``offset`` means the
    sampler rotated it (obs/sampler.py size bound): the unread tail now
    lives in ``<path>.1`` — drain that from the old offset first, then
    restart at the new file's head, so following survives the roll."""
    samples = []
    try:
        if os.path.getsize(path) < offset:
            try:
                with open(path + ".1") as f:
                    f.seek(offset)
                    samples.extend(_parse_lines(f)[0])
            except OSError:
                pass    # double-rolled between polls: tail is lost
            offset = 0
    except OSError:
        return samples, offset
    with open(path) as f:
        f.seek(offset)
        new, offset = _parse_lines(f)
        samples.extend(new)
    return samples, offset


def _rates(cur, prev):
    """Per-node {(node id): (batches/s, tuples/s)} between two samples."""
    out = {}
    if prev is None:
        return out
    dt = cur["t"] - prev["t"]
    if dt <= 0:
        return out
    before = {n["id"]: n for n in prev["nodes"]}
    for n in cur["nodes"]:
        p = before.get(n["id"])
        if p is None or "rcv_batches" not in n or "rcv_batches" not in p:
            continue
        out[n["id"]] = ((n["rcv_batches"] - p["rcv_batches"]) / dt,
                        (n["rcv_tuples"] - p["rcv_tuples"]) / dt)
    return out


def _control_line(cur):
    """Controller state from the ctl_* metrics (docs/CONTROL.md): active
    farm widths, admission rate cap, adaptive soft limit, and the
    decision counters — empty string when no control plane runs."""
    gauges = cur.get("gauges", {})
    counters = cur.get("counters", {})
    parts = []
    for k in sorted(gauges):
        if k.startswith("ctl_width_"):
            parts.append(f"width[{k[len('ctl_width_'):]}]="
                         f"{int(gauges[k])}")
    for k in sorted(gauges):
        if k.startswith("ctl_admission_rate"):
            tgt = k[len("ctl_admission_rate"):].lstrip("_") or "*"
            parts.append(f"admit[{tgt}]={gauges[k]:.0f}/s")
    if gauges.get("ctl_soft_limit"):
        parts.append(f"soft_limit={int(gauges['ctl_soft_limit'])}")
    ctl_counts = {k[4:]: v for k, v in counters.items()
                  if k.startswith("ctl_") and v}
    if ctl_counts:
        parts.append("  ".join(f"{k}={v}"
                               for k, v in sorted(ctl_counts.items())))
    return "control: " + "  ".join(parts) if parts else ""


#: plane/portable-checkpoint counters folded onto the plane line, not
#: the generic counters line (docs/ROBUSTNESS.md "Cross-host recovery")
_PLANE_COUNTERS = ("plane_handoffs", "ckpt_shipped_bytes",
                   "ckpt_fetched_bytes", "ckpt_spooled", "ckpt_fallbacks")


def _plane_line(cur):
    """Plane supervisor state (docs/ROBUSTNESS.md "Cross-host
    recovery"): membership and down counts from the plane_* gauges plus
    the handoff / portable-checkpoint counters — empty string when no
    supervised plane runs."""
    gauges = cur.get("gauges", {})
    counters = cur.get("counters", {})
    parts = []
    if "plane_members" in gauges:
        parts.append(f"members={int(gauges['plane_members'])}")
        parts.append(f"down={int(gauges.get('plane_down', 0))}")
    for k in _PLANE_COUNTERS:
        if counters.get(k):
            parts.append(f"{k}={int(counters[k])}")
    return "plane: " + "  ".join(parts) if parts else ""


def render(cur, prev, events=(), clock=time.localtime):
    """One frame of the view as a string (pure: testable without a tty)."""
    rates = _rates(cur, prev)
    head = (f"wf_top  dataflow={cur['dataflow']}  seq={cur['seq']}  "
            f"t={time.strftime('%H:%M:%S', clock(cur['t']))}  "
            f"dead_letters={cur.get('dead_letters', 0)}")
    lines = [head, ""]
    lines.append("  ".join(c.ljust(w) if i == 0 else c.rjust(w)
                           for i, (c, w) in enumerate(zip(_COLS, _W))))
    for n in cur["nodes"]:
        br, tr = rates.get(n["id"], (None, None))
        row = (n["node"],
               str(n["depth"]), str(n["hwm"]),
               f"{br:.1f}" if br is not None else "-",
               f"{tr:.0f}" if tr is not None else "-",
               f"{n['ewma_service_us_per_batch']:.1f}"
               if "ewma_service_us_per_batch" in n else "-",
               # span-tracer latency fields (docs/OBSERVABILITY.md
               # §tracing); absent on untraced graphs and on pre-trace
               # metrics.jsonl lines — render "-" either way
               f"{n['q_p95_us']:.1f}" if "q_p95_us" in n else "-",
               f"{n['svc_p95_us']:.1f}" if "svc_p95_us" in n else "-",
               str(n["shed"]), str(n["quarantined"]))
        lines.append("  ".join(c.ljust(w) if i == 0 else c.rjust(w)
                               for i, (c, w) in enumerate(zip(row, _W))))
    ctl = _control_line(cur)
    if ctl:
        lines.append("")
        lines.append(ctl)
    plane = _plane_line(cur)
    if plane:
        lines.append("")
        lines.append(plane)
    counters = {k: v for k, v in cur.get("counters", {}).items()
                if v and not k.startswith("ctl_")
                and k not in _PLANE_COUNTERS}
    # wire resume telemetry (docs/ROBUSTNESS.md "Wire resume"): the
    # journal depth is a gauge, not a counter — fold it (and any other
    # wire_ gauges) onto the same line so one glance shows resumes,
    # replayed frames, and how much tail is still journaled
    counters.update({k: int(v) for k, v in cur.get("gauges", {}).items()
                     if k.startswith("wire_") and v})
    if counters:
        lines.append("")
        lines.append("counters: " + "  ".join(
            f"{k}={v}" for k, v in sorted(counters.items())))
    if events:
        lines.append("")
        lines.append("recent events:")
        for e in events:
            extra = " ".join(f"{k}={v}" for k, v in e.items()
                             if k not in ("t", "event"))
            lines.append(
                f"  {time.strftime('%H:%M:%S', clock(e['t']))} "
                f"{e['event']:<18} {extra}")
    return "\n".join(lines)


_PLANE_COLS = ("HOST", "STATE", "AGE_S", "SEQ", "DATAFLOW", "DEPTH",
               "TUPLES", "SHED", "Q95_US")
_PLANE_W = (14, 6, 7, 6, 14, 6, 10, 8, 9)


def render_plane(state, clock=time.localtime):
    """One frame of the cluster view (``--plane``) from the aggregator's
    state file (obs/federation.py ``TelemetryAggregator.write_state``):
    one row per federated host, the plane-scope SLO signal view, and
    which objectives are burning.  Pure: testable without a tty."""
    hosts = state.get("hosts", {})
    view = state.get("view", {})
    fresh = sum(1 for h in hosts.values() if h.get("fresh"))
    head = (f"wf_top --plane  hosts={len(hosts)} fresh={fresh}  "
            f"t={time.strftime('%H:%M:%S', clock(state.get('t', 0)))}")
    lines = [head, ""]
    lines.append("  ".join(c.ljust(w) if i == 0 else c.rjust(w)
                           for i, (c, w) in enumerate(zip(_PLANE_COLS,
                                                          _PLANE_W))))
    for host in sorted(hosts):
        meta = hosts[host]
        snap = (state.get("latest") or {}).get(host) or {}
        nodes = snap.get("nodes", [])
        row = (host,
               "ok" if meta.get("fresh") else "STALE",
               f"{meta.get('age', 0.0):.1f}",
               str(meta.get("seq", 0)),
               meta.get("dataflow", ""),
               str(max((n.get("depth", 0) for n in nodes), default=0)),
               str(sum(n.get("rcv_tuples", 0) for n in nodes)),
               str(sum(n.get("shed", 0) for n in nodes)),
               f"{max((n.get('q_p95_us', 0.0) for n in nodes), default=0.0):.1f}")
        lines.append("  ".join(c.ljust(w) if i == 0 else c.rjust(w)
                               for i, (c, w) in enumerate(zip(row,
                                                              _PLANE_W))))
    parts = [f"availability={view.get('availability', 1.0):.2f}"]
    if view.get("q95_us"):
        parts.append(f"q95_us={view['q95_us']:.1f}")
    if view.get("shed_rate"):
        parts.append(f"shed_rate={view['shed_rate']:.1f}/s")
    if view.get("stale_seconds"):
        parts.append(f"stale_s={view['stale_seconds']:.1f}")
    burning = state.get("slo_burning", [])
    parts.append("slo=BURN[" + ",".join(burning) + "]" if burning
                 else "slo=ok")
    lines.append("")
    lines.append("plane: " + "  ".join(parts))
    return "\n".join(lines)


def tail_events(path, n=6):
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            if line.endswith("\n"):
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    return out[-n:]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("path", help="trace dir (WF_LOG_DIR) or a "
                                 "metrics.jsonl file")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="refresh period in follow mode (seconds)")
    ap.add_argument("--once", action="store_true",
                    help="render the latest frame and exit")
    ap.add_argument("--expo", action="store_true",
                    help="print the latest sample as Prometheus text "
                         "exposition and exit")
    ap.add_argument("--events", type=int, default=6,
                    help="event-log tail length (0 disables)")
    ap.add_argument("--plane", action="store_true",
                    help="cluster view: render the federation "
                         "aggregator's state file (federation.json in "
                         "the given dir) instead of one process's "
                         "metrics")
    a = ap.parse_args(argv)

    if a.plane:
        path = a.path
        if os.path.isdir(path):
            path = os.path.join(path, "federation.json")
        if not os.path.exists(path):
            print(f"wf_top: no federation state at {path} (is a "
                  f"TelemetryAggregator running with state_path= "
                  f"set?)", file=sys.stderr)
            return 2
        while True:
            with open(path) as f:
                try:
                    state = json.load(f)
                except json.JSONDecodeError:
                    state = None    # mid-replace race: retry next tick
            if state is not None:
                frame = render_plane(state)
                if a.once:
                    print(frame)
                    return 0
                sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
                sys.stdout.flush()
            elif a.once:
                print("wf_top: federation state file is unreadable",
                      file=sys.stderr)
                return 2
            time.sleep(a.interval)

    path = a.path
    if os.path.isdir(path):
        ev_path = os.path.join(path, "events.jsonl")
        path = os.path.join(path, "metrics.jsonl")
    else:
        ev_path = os.path.join(os.path.dirname(path), "events.jsonl")
    if not os.path.exists(path):
        print(f"wf_top: no metrics at {path} (is the job running with "
              f"sample_period / WF_SAMPLE_PERIOD set?)", file=sys.stderr)
        return 2

    if a.expo:
        from windflow_tpu_torch.obs import expo
        samples, _ = read_samples(path)
        if not samples:
            print("wf_top: metrics file has no complete samples yet",
                  file=sys.stderr)
            return 2
        sys.stdout.write(expo.render_sample(samples[-1]))
        return 0

    offset = 0
    prev = cur = None
    while True:
        new, offset = read_samples(path, offset)
        for s in new:
            prev, cur = cur, s
        if cur is not None:
            events = tail_events(ev_path, a.events) if a.events else []
            frame = render(cur, prev, events)
            if a.once:
                print(frame)
                return 0
            sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            sys.stdout.flush()
        elif a.once:
            print("wf_top: metrics file has no complete samples yet",
                  file=sys.stderr)
            return 2
        time.sleep(a.interval)


if __name__ == "__main__":
    sys.exit(main())
