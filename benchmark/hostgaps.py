"""The device's idle gaps in a traced run, labelled by what the host was
doing, from the program's host timeline (``utils/profile.py``
``timeline_start``/``timeline_stop``, laid onto the trace's clock by
``profile.anchor``).

For each gap, the runtime call that issued the device op ending it
(``cudaLaunchKernel``, ``cudaMemcpyAsync``, ``cudaMemsetAsync``, matched
by the trace's correlation id) names the issuing thread: by its id in the
trace, which is the thread's pthread id in some runs, and otherwise by
whose ``device_put`` and ``dispatch`` spans hold that id's calls.  The gap is
labelled ``<thread role>: <span>``: the role is the thread's name without
its trailing indices, the span is the timeline entry of that thread that
covers most of the host's part of the gap (from the gap's start to the
call's start), or ``no span``.  Without a timeline the labels are
``devtrace.breakdown``'s.

The harness's traced run keeps only the device ops, and takes no timeline
yet: ``devtrace.DeviceWindow``, once it takes the anchors and the timeline
around its profiled sub-window and keeps the runtime calls with their
correlation ids, is to call ``read_trace`` and ``host_gaps``.
"""

from __future__ import annotations

import re

from benchmark import devtrace

#: runtime calls that put work on the device
ISSUING = ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")
#: the labels of the anchors a traced run takes
ANCHORS = ("wf_anchor_start", "wf_anchor_mid", "wf_anchor_end")
#: the ship threads' spans that issue their launches
SHIP_SPANS = ("device_put", "dispatch")


def role(thread_name: str) -> str:
    """A thread's name without its trailing indices (``wf-ship.0`` ->
    ``wf-ship``)."""
    return re.sub(r"(?:[._\-]?\d+)+$", "", thread_name) or thread_name


def read_trace(events):
    """From chrome-trace events: the device ops as (name, start_us, dur_us,
    correlation), the issuing runtime calls by correlation id as (name,
    start_us, tid), and the anchors' midpoints by label."""
    ops, calls, mids = [], {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat"), e.get("args") or {}
        if cat in devtrace.DEVICE_CATS:
            ops.append((e["name"], float(e["ts"]), float(e.get("dur", 0)),
                        args.get("correlation")))
        elif e.get("name") in ISSUING and "correlation" in args:
            calls[args["correlation"]] = (e["name"], float(e["ts"]),
                                          e.get("tid"))
        elif e.get("name") in ANCHORS:
            mids[e["name"]] = float(e["ts"]) + float(e.get("dur", 0)) / 2
    return ops, calls, mids


def line_fit(anchors, mids):
    """The map host ns -> trace us through the start and end anchors, and
    the middle anchor's distance from it in us (None without one)."""
    from windflow_tpu_torch.utils import profile
    to_us = profile.to_trace_us(
        [anchors[0], anchors[-1]], [mids[ANCHORS[0]], mids[ANCHORS[-1]]])
    off = None
    if len(anchors) == 3 and ANCHORS[1] in mids:
        a, b = anchors[1]
        off = abs(to_us((a + b) / 2) - mids[ANCHORS[1]])
    return to_us, off


class _Threads:
    """The timeline's entries by native thread id, on the trace's clock.
    A runtime call's ``tid`` in the trace is the thread's native id or its
    pthread id (``threading.get_ident()``), whole or in its low 32 bits,
    unsigned or signed: `idents` maps native ids to pthread ids."""

    def __init__(self, entries, to_us, idents=None):
        import numpy as np
        by = {}
        for name, tid, thread, t0, t1, _cpu in entries:
            by.setdefault(tid, (thread, []))[1].append((name, t0, t1))
        self.names = {tid: thread for tid, (thread, _) in by.items()}
        self._native = {}
        for tid, ident in (idents or {}).items():
            low = ident & 0xFFFFFFFF
            for key in (ident, low, low - (1 << 32)):   # unsigned, signed
                self._native[key] = tid
        self.spans = {}
        for tid, (_, rows) in by.items():
            self.spans[tid] = (
                [r[0] for r in rows],
                np.array([to_us(r[1]) for r in rows]),
                np.array([to_us(r[2]) for r in rows]))

    def native(self, tid):
        """The native id of a trace's thread id."""
        return tid if tid in self.names else self._native.get(tid, tid)

    def learn(self, calls, spans=SHIP_SPANS) -> int:
        """Map each trace thread id that names no timeline thread (a CUDA
        profiler does not always report the pthread id) to the timeline
        thread whose `spans` hold most of its calls; returns how many
        were mapped so."""
        import numpy as np
        held = {}
        for tid, (names, s, e) in self.spans.items():
            keep = np.array([n in spans for n in names], dtype=bool)
            if keep.any():
                held[tid] = (s[keep], e[keep])
        votes = {}
        for _, t, tid in calls.values():
            if self.native(tid) in self.names:
                continue
            for nt, (s, e) in held.items():
                if np.any((s <= t) & (t <= e)):
                    v = votes.setdefault(tid, {})
                    v[nt] = v.get(nt, 0) + 1
        for tid, v in votes.items():
            self._native[tid] = max(v, key=v.get)
        return len(votes)

    def covering(self, tid, lo, hi):
        """The span of thread `tid` that covers most of [lo, hi] us (the
        innermost of equals), or None."""
        import numpy as np
        if tid not in self.spans or hi <= lo:
            return None
        names, s, e = self.spans[tid]
        over = np.minimum(e, hi) - np.maximum(s, lo)
        if not len(over) or over.max() <= 0:
            return None
        best = np.flatnonzero(over == over.max())
        return names[min(best, key=lambda i: e[i] - s[i])]

    def inside(self, tid, t, names):
        """Whether `t` us falls in a span of thread `tid` named in
        `names`."""
        if tid not in self.spans:
            return False
        n, s, e = self.spans[tid]
        return any(n[i] in names and s[i] <= t <= e[i]
                   for i in range(len(n)))


def label_gaps(ops, calls, threads: _Threads | None, n=10):
    """``idle_gaps`` as ``devtrace.breakdown`` gives them ([label (n
    gaps), seconds], the n largest), labelled by the host (module
    docstring) where `threads` is given, and the seconds over all gaps."""
    gaps = {}
    total = 0.0
    end = None
    for name, s, d, corr in sorted(ops, key=lambda o: o[1]):
        if end is not None and s > end:
            call = calls.get(corr)
            if threads is None:
                k = f"before {devtrace.short_name(name)}"
            elif call is None:
                k = f"no call: before {devtrace.short_name(name)}"
            else:
                _, t_call, tid = call
                tid = threads.native(tid)
                thread = threads.names.get(tid, f"thread {tid}")
                span = threads.covering(tid, end, t_call)
                k = f"{role(thread)}: {span or 'no span'}"
            t, c = gaps.get(k, (0.0, 0))
            gaps[k] = (t + (s - end) / 1e6, c + 1)
            total += (s - end) / 1e6
        end = s + d if end is None else max(end, s + d)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1][0])[:n]
    return ([[f"{k} ({c} gaps)", t] for k, (t, c) in idle], total,
            sum(c for _, c in gaps.values()))


def launches_inside(calls, threads: _Threads, spans=SHIP_SPANS,
                    thread_role="wf-ship"):
    """(inside, of): the ``cudaLaunchKernel`` calls issued by threads of
    `thread_role` that fall inside one of that thread's `spans`."""
    inside = of = 0
    for name, t, tid in calls.values():
        tid = threads.native(tid)
        if name != "cudaLaunchKernel" \
                or role(threads.names.get(tid, "")) != thread_role:
            continue
        of += 1
        inside += threads.inside(tid, t, spans)
    return inside, of


def source_cover(entries):
    """The source thread's ``pull`` and ``push`` entries: their seconds,
    and the share of the time from the first to the last of them that
    they cover (the generator and the push alternate, so near 1)."""
    rows = [e for e in entries if e[0] in ("pull", "push")]
    if not rows:
        return None
    out = {k: sum(e[4] - e[3] for e in rows if e[0] == k) / 1e9
           for k in ("pull", "push")}
    span = max(e[4] for e in rows) - min(e[3] for e in rows)
    out["cover"] = (out["pull"] + out["push"]) * 1e9 / span
    return out


def host_gaps(ops, calls, mids, anchors, timeline):
    """The labelled gaps of a traced run: `ops`, `calls`, `mids` as
    ``read_trace`` gives them, `anchors` the ``anchor()`` pairs by
    ``ANCHORS``' order, `timeline` what ``timeline_stop()`` returned.
    Without a timeline or the two outer anchors, ``idle_gaps`` keeps the
    device-op labels."""
    plain, total, count = label_gaps(ops, calls, None)
    out = {"device_op_labels": plain, "idle_s": total, "gaps": count}
    if not timeline or not anchors or any(a not in mids for a in
                                          (ANCHORS[0], ANCHORS[-1])):
        out["idle_gaps"] = plain
        return out
    to_us, off = line_fit(anchors, mids)
    threads = _Threads(timeline["entries"], to_us, timeline.get("threads"))
    threads.learn(calls)
    labelled, host_total, _ = label_gaps(ops, calls, threads)
    out.update(idle_gaps=labelled, host_idle_s=host_total,
               mid_anchor_off_us=off,
               ship_launches_inside=list(launches_inside(calls, threads)),
               source_cover=source_cover(timeline["entries"]),
               timeline_dropped=timeline["dropped"])
    return out
