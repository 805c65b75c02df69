"""What a traced run (``--trace 1``) records besides the program's own
spans and counters: the device's activity over a steady sub-window of the
run (``torch.profiler``), and the shapes of the ring kernel's launches in
that sub-window (a recording wrapper around the port's kernel entries,
which passes every call on unchanged)."""

from __future__ import annotations

import json
import os
import re
import threading
import time

#: the ring kernels whose launches are recorded: the wrapper's name in
#: ``windflow_tpu_torch.ops.resident`` (which calls it by that name)
RING_KERNELS = ("ring_append_eval",)
#: profiler categories of device activity
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class LaunchRecorder:
    """Records each ring kernel call made while ``active``: the ring's and
    the rectangle's shapes and element sizes, and references to the
    descriptor tensors (read after the run, so nothing waits for the
    device inside it)."""

    def __init__(self):
        self.active = False
        self.calls = []
        self._saved = {}

    def install(self):
        from windflow_tpu_torch.ops import resident
        for name in RING_KERNELS:
            orig = getattr(resident, name)
            self._saved[name] = orig
            setattr(resident, name, self._wrap(name, orig))

    def uninstall(self):
        from windflow_tpu_torch.ops import resident
        for name, orig in self._saved.items():
            setattr(resident, name, orig)
        self._saved = {}

    def _wrap(self, name, orig):
        def recording(ring, blk, offs, *args, **kw):
            if self.active:
                self.calls.append((name, tuple(ring.shape),
                                   ring.element_size(), tuple(blk.shape),
                                   blk.element_size(), offs, args))
            return orig(ring, blk, offs, *args, **kw)
        return recording

    def costs(self):
        """[(kernel entry, bytes, operations)] of the recorded calls."""
        from benchmark import bounds
        out = []
        for name, (KP, cap), rs, (_, Rb), bs, offs, args in self.calls:
            host = [a.cpu().numpy() if hasattr(a, "cpu") else a
                    for a in args]
            ops, rows, starts, lens, pad = host[:5]
            cost = bounds.append_eval(KP, cap, rs, Rb, bs,
                                      offs.cpu().numpy(), list(ops), rows,
                                      starts, lens, int(pad))
            out.append((name, *cost))
        return out


def short_name(name: str) -> str:
    """A device activity's name without its return type, namespace,
    template and parameters, demangled or not (``void
    wf::append_eval_kernel<int>(...)`` and ``..._38217append_eval_kernelIai``
    are ``append_eval_kernel``); copies by direction."""
    low = name.lower()
    for kind, short in (("htod", "copy HtoD"), ("dtoh", "copy DtoH"),
                        ("dtod", "copy DtoD"), ("memset", "memset")):
        if kind in low:
            return short
    m = re.search(r"[a-z][a-z0-9]*(?:_[a-z0-9]+)*_kernel", name)
    if m:
        return re.sub(r"^.*_\d+", "", m.group(0))
    base = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return base.split(" ")[-1].split("::")[-1] or name


class DeviceWindow:
    """Profiles the device from `start` to `stop` seconds after the run's
    window opens (`t0()` returns the opening on the host clock once it is
    known), on a thread of its own.  After ``join()``: ``ops``, the
    device activities as (name, start_us, dur_us), and ``window_s``, the
    profiled time on the host clock."""

    def __init__(self, t0, start: float, stop: float, out_dir: str,
                 recorder: LaunchRecorder | None = None,
                 clock=time.perf_counter):
        self.t0, self.start, self.stop = t0, start, stop
        self.out_dir, self.recorder, self.clock = out_dir, recorder, clock
        self.ops, self.window_s, self.error = [], None, None
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, name="devtrace",
                                        daemon=True)

    @staticmethod
    def warm():
        """Start and stop the profiler once (set-up: its first start loads
        and initialises the tracing library)."""
        import torch
        with torch.profiler.profile(activities=_activities()):
            torch.cuda.synchronize()

    def begin(self):
        self._thread.start()

    def finish(self):
        """Stop early if the run ended first, then wait for the thread."""
        self._done.set()
        self._thread.join()
        if self.error is not None:
            raise self.error

    def _sleep_until(self, t):
        while not self._done.is_set():
            t0 = self.t0()
            if t0 is not None:
                wait = t0 + t - self.clock()
                if wait <= 0:
                    return True
                self._done.wait(min(wait, 0.05))
            else:
                self._done.wait(0.01)
        return False

    def _run(self):
        import torch
        try:
            if not self._sleep_until(self.start):
                return
            prof = torch.profiler.profile(activities=_activities())
            prof.start()
            a = self.clock()
            if self.recorder is not None:
                self.recorder.active = True
            self._sleep_until(self.stop)
            if self.recorder is not None:
                self.recorder.active = False
            prof.stop()
            self.window_s = self.clock() - a
            path = os.path.join(self.out_dir, "device_trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
            os.remove(path)
            self.ops = [(e["name"], float(e["ts"]), float(e.get("dur", 0)))
                        for e in events
                        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        except Exception as e:  # noqa: BLE001 - re-raised by finish()
            self.error = e


def _activities():
    from torch.profiler import ProfilerActivity
    return [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def busy_intervals(ops):
    """The union of the activities' [start, end) in microseconds, merged,
    in order."""
    spans = sorted((s, s + d) for _, s, d in ops)
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def breakdown(ops, n=10):
    """``device_ops``: device seconds by activity; ``idle_gaps``: the idle
    seconds between activities, by the activity the device waited for
    (the host was preparing it), with the number of gaps; n of each, the
    largest first."""
    by_op = {}
    for name, _, d in ops:
        k = short_name(name)
        by_op[k] = by_op.get(k, 0.0) + d / 1e6
    gaps = {}
    ordered = sorted(ops, key=lambda o: o[1])
    end = None
    for name, s, d in ordered:
        if end is not None and s > end:
            k = short_name(name)
            t, c = gaps.get(k, (0.0, 0))
            gaps[k] = (t + (s - end) / 1e6, c + 1)
        end = s + d if end is None else max(end, s + d)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:n]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1][0])[:n]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[f"before {k} ({c} gaps)", t]
                          for k, (t, c) in idle]}


def idle_pct(run):
    """The device's idle share of the profiled sub-window, in percent."""
    if not run.device_ops or not run.device_window_s:
        return None
    busy = sum(e - s for s, e in busy_intervals(run.device_ops)) / 1e6
    return 100.0 * (1.0 - busy / run.device_window_s)
