"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

The run: set-up (from after the interpreter's import of torch: the
port's import, its library builds on a checkout's first run, the seeded inputs, a warm-up pipeline over the cell's own
shapes), then a fresh pipeline fed by the cell's traffic for ``--seconds``
(the window: from the first chunk until every result of the chunks sent
is delivered), then the check of every delivered result against the plain
reference, and the metrics.  ``--trace 1`` also turns on the program's
phase spans and node counters and profiles the device over the middle of
the window; its line carries the per-layer metrics instead of the
end-to-end ones.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
#: modules that must not be loaded in the process that prints the result,
#: compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "windflow_tpu")
#: the profiled sub-window of a traced run, as shares of the window
TRACE_FROM, TRACE_TO = 0.3, 0.7


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import the file `path` as module `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> list:
    """The FORBIDDEN top-level names present in `modules` (sys.modules)."""
    tops = {m.split(".")[0] for m in (sys.modules if modules is None
                                      else modules)}
    return sorted(tops.intersection(FORBIDDEN))


class Cell:
    """A cell of BENCHMARK.json with its configuration, traffic mix and
    the metrics it reports, found by name."""

    def __init__(self, name: str, bench: dict, here: str = HERE,
                 mix: dict | None = None):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                             f"(have {sorted(cells)})")
        self.name, self.spec = name, cells[name]
        self.chips = int(self.spec["chips"])
        self.config = load_json(here, "configs",
                                f"{self.spec['config']}.json")
        self.mix = mix or load_json(here, "traffic",
                                    f"{self.spec['traffic']}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.here = here

    def system(self, seed: int, device: str):
        path = os.path.join(self.here, "systems",
                            f"{self.config['system']}.py")
        mod = load_module(path, f"benchmark_system_{self.config['system']}")
        return mod.System(self.config, self.mix, seed, device)

    def reader(self, metric: str):
        path = os.path.join(self.here, "metrics", f"{metric}.py")
        return load_module(path, "benchmark_metric_"
                           + metric.replace(".", "_")).read


class Collector:
    """The sink's callback: each result batch, copied."""

    def __init__(self):
        self.batches = []

    def __call__(self, rows):
        if rows is not None and len(rows):
            self.batches.append(rows.copy())


class Run:
    """What the metric readers read (``metrics/<name>.py``: ``read(run)``
    returns a number, or None where the run has nothing to read)."""

    def __init__(self, **kw):
        self.setup_s = self.window_s = self.records = self.paced = None
        self.nodes = self.spans = self.stats = None
        self.farm = self.source_busy_s = self.put_s = None
        self.device_ops = self.device_window_s = self.launch_costs = None
        self.__dict__.update(kw)


def _warm_up(system):
    """The cell's own shapes through a pipeline of their own."""
    pipe = system.pipeline(iter(system.warm_chunks()), lambda rows: None)
    pipe.run_and_wait_end()


def _node_logs(trace_dir):
    out = {}
    for fn in os.listdir(trace_dir):
        if fn.endswith(".log"):
            snap = load_json(trace_dir, fn)
            out[snap["node"]] = snap
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, scratch: str):
    """One run; returns (Run, readings of the check, device peak bytes)."""
    import torch
    from benchmark import pacing
    from benchmark.reference import compare
    from windflow_tpu_torch.ops import resident
    from windflow_tpu_torch.utils import profile
    on_card = device.startswith("cuda")
    system = cell.system(seed, device)
    _warm_up(system)
    recorder = window = puts = None
    trace_dir = os.path.join(scratch, "nodes")
    if trace:
        from benchmark import hostspans
        os.environ["WF_LOG_DIR"] = trace_dir
        profile.enable()
        puts = hostspans.PutTimer()
        puts.install()
        if on_card:
            from benchmark import devtrace
            devtrace.DeviceWindow.warm()
            recorder = devtrace.LaunchRecorder()
            recorder.install()
    if on_card:
        torch.cuda.synchronize()
    profile.reset()
    resident.stats_snapshot(reset=True)
    collector = Collector()
    paced = pacing.Paced(cell.mix, system.make_chunk, seconds)
    pipe = system.pipeline(iter(paced), collector)
    try:
        if trace and on_card:
            window = devtrace.DeviceWindow(
                lambda: paced.t0, TRACE_FROM * seconds, TRACE_TO * seconds,
                scratch, recorder)
            window.begin()
        pipe.run_and_wait_end()
        if on_card:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        if window is not None:
            window.finish()
        for patch in (recorder, puts):
            if patch is not None:
                patch.uninstall()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    with resident._STATS_MU:
        stats = dict(resident._STATS)
    run = Run(setup_s=paced.t0 - t_start, window_s=t1 - paced.t0,
              records=paced.records, paced=paced, farm=system.farm,
              stats=stats)
    if trace:
        profile.disable()
        os.environ.pop("WF_LOG_DIR", None)
        run.nodes = _node_logs(trace_dir)
        run.put_s = dict(puts.seconds)
        run.source_busy_s = (paced.make_s + paced.outside_s
                             - run.put_s.get(paced.thread, 0.0))
        run.spans = profile.report()
        if window is not None:
            run.device_ops = window.ops
            run.device_window_s = window.window_s
            run.launch_costs = recorder.costs()
    del pipe
    # the check, once the window has closed and the peak is read
    rows = [system.columns(b) for b in collector.batches]
    key = np.concatenate([r[0] for r in rows]) if rows else np.zeros(0)
    wid = np.concatenate([r[1] for r in rows]) if rows else np.zeros(0)
    vals = (np.concatenate([r[2] for r in rows]) if rows
            else np.zeros((0, 1)))
    index, want = system.expected(paced)
    readings = compare.compare(key, wid, vals, index, want)
    return run, readings, peak


def result_line(cell: Cell, run: Run, readings: dict, peak: int,
                trace: bool, device_name: str) -> dict:
    from benchmark.reference import compare
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_name, "count": cell.chips,
              "memory_peak_bytes": int(peak)}
    line = {"correct": compare.passed(readings),
            "attempted": readings["expected"],
            "failed": sum(readings[k] for k in compare.LIMITS),
            "metrics": metrics, "device": device}
    if trace and run.device_ops is not None:
        from benchmark import devtrace
        busy = sum(e - s for s, e in devtrace.busy_intervals(run.device_ops))
        device["busy_s"] = busy / 1e6
        device["window_s"] = run.device_window_s
        line["breakdown"] = devtrace.breakdown(run.device_ops)
    line["checks"] = {k: {"value": readings[k], "limit": lim}
                      for k, lim in compare.LIMITS.items()}
    return line


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_start=None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    a = parse(argv)
    bench = load_json(os.getcwd(), "BENCHMARK.json")
    cell = Cell(a.workload, bench)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
              f"this host has {have}", file=sys.stderr)
        return 2
    # the port's library builds stay in the checkout; what else a run
    # writes goes under TMPDIR and is removed
    scratch = tempfile.mkdtemp(prefix="wfbench-")
    try:
        run, readings, peak = run_cell(cell, a.seed, a.seconds,
                                       bool(a.trace), "cuda:0", t_start,
                                       scratch)
        line = result_line(cell, run, readings, peak, bool(a.trace),
                           torch.cuda.get_device_name(0))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}", file=sys.stderr)
        return 3
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
