"""pipe_test_gpu (apps/pipe.py) and the micro pipeline (apps/micro.py)
through the port against the JAX package's apps: pipe_test at ~256k
tuples with device="cpu" (the fused ring kernel's plain version), its
total and window count against the app's own oracle ``expected()`` and
its windows, per key in order, against the JAX pipe run; micro's counters
against JAX's under one fake clock; the pipe app span-traced against its
untraced run; and no device visible without device="cpu" raising."""

import json
import threading
import types

import pytest

from windflow_tpu.apps import micro as jmicro
from windflow_tpu.apps import pipe as jpipe
from windflow_tpu_torch.apps import micro, pipe

N_TUPLES = 1 << 18
CHUNK = 1 << 16
FLUSH_ROWS = 1 << 14
DEPTH = 4


class Recorded:
    """Stands in for an app module's ``Sink``: the app's own consumer still
    runs, and every window result is kept per key in arrival order."""

    def __init__(self, sink_cls):
        self.sink_cls = sink_cls
        self.by_key = {}
        self._lock = threading.Lock()

    def __call__(self, fn, **kw):
        def both(rows):
            fn(rows)
            if rows is None:
                return
            with self._lock:
                for k, i, v in zip(rows["key"].tolist(), rows["id"].tolist(),
                                   rows["value"].tolist()):
                    self.by_key.setdefault(k, []).append((i, v))
        return self.sink_cls(both, **kw)


def run_pipe(mod, monkeypatch, **kw):
    rec = Recorded(mod.Sink)
    monkeypatch.setattr(mod, "Sink", rec)
    chunks = mod.make_values(N_TUPLES, CHUNK)
    _dt, state, diag = mod.run_once(chunks, 2, FLUSH_ROWS, DEPTH, 4, **kw)
    return chunks, state, diag, rec.by_key


def test_pipe_matches_expected_and_jax(monkeypatch):
    chunks, state, diag, rows = run_pipe(pipe, monkeypatch, device="cpu")
    want_total, want_windows = pipe.expected(chunks)
    assert (state["total"], state["rcv"]) == (want_total, want_windows)
    assert want_windows > 1000 and diag["dispatches"] > 0
    assert sum(len(v) for v in rows.values()) == want_windows
    jchunks, jstate, _, jrows = run_pipe(jpipe, monkeypatch)
    assert all((a == b).all() for a, b in zip(chunks, jchunks))
    assert (jstate["total"], jstate["rcv"]) == (want_total, want_windows)
    assert rows == jrows


def test_pipe_run_checks_and_reports(monkeypatch):
    """run(): the warm-up, then one timed run held against expected()."""
    out = pipe.run(n_tuples=N_TUPLES // 4, chunk=CHUNK, flush_rows=FLUSH_ROWS,
                   depth=DEPTH, runs=1, device="cpu")
    _, want_windows = pipe.expected(pipe.make_values(N_TUPLES // 4, CHUNK))
    assert out["unit"] == "tuples/sec" and out["value"] > 0
    assert out["n_window_results"] == want_windows
    assert "WinFarmGPU" in out["metric"]


def test_pipe_trace_refused(monkeypatch, tmp_path):
    """The pipe app span-traced (trace=, trace_dir=): the same windows per
    key as the untraced run, and trace.jsonl holds hops of the fused
    source stage, the farm's emitter and both workers, and the workers'
    ship phases as launch spans under their hops."""
    _, state, _, rows = run_pipe(pipe, monkeypatch, device="cpu")
    monkeypatch.undo()      # the second run records through a fresh Sink
    _, tstate, _, trows = run_pipe(pipe, monkeypatch, device="cpu",
                                   trace=1.0, trace_dir=str(tmp_path))
    assert (tstate["total"], tstate["rcv"]) == (state["total"], state["rcv"])
    assert trows == rows
    recs = [json.loads(line)
            for line in (tmp_path / "trace.jsonl").read_text().splitlines()]
    def stage(node):                    # "pipe_test_gpu_02_x" -> "x"
        return node.split("_", 4)[4]
    hops = {stage(r["node"]) for r in recs if r["kind"] == "hop"}
    assert {"src.0+map.0+filter.0", "win_farm_gpu.emitter",
            "win_farm_gpu.0", "win_farm_gpu.1"} <= hops, hops
    spans = {r["span"]: r for r in recs}
    launches = [r for r in recs if r["kind"] == "launch"]
    assert {r["phase"] for r in launches} >= {"native_bookkeeping"}
    assert {stage(spans[r["parent"]]["node"]) for r in launches} == {"win_farm_gpu.0", "win_farm_gpu.1"}


@pytest.mark.filterwarnings("ignore:resident device path accumulates")
def test_device_apps_raise_without_a_card(monkeypatch):
    """device=None means the card: with none visible the apps raise, they
    never fall back to the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipe.run_once(pipe.make_values(4096, 4096), 2, FLUSH_ROWS, DEPTH, 4)
    from windflow_tpu_torch.apps import ysb
    p, _, _ = ysb.build_pipeline("kf-gpu", 0, 1, 4, batches=[])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p.run_and_wait_end()


def fake_time():
    """A clock for the micro app: monotonic() steps one second a call in
    each thread, so every source replica pushes a fixed number of chunks;
    time() stands still."""
    local = threading.local()

    def monotonic():
        local.t = getattr(local, "t", -1.0) + 1.0
        return local.t
    return types.SimpleNamespace(monotonic=monotonic, time=lambda: 1000.0,
                                 perf_counter=__import__("time").perf_counter)


@pytest.mark.parametrize("pardegree", [1, 2])
def test_micro_counters_match_jax(monkeypatch, pardegree):
    out = {}
    for name, mod in (("port", micro), ("jax", jmicro)):
        monkeypatch.setattr(mod, "time", fake_time())
        out[name] = mod.run(duration_sec=5.0, chunk=4096,
                            pardegree=pardegree)
    keys = ("sent", "received", "avg_latency_us", "dispatches")
    assert {k: out["port"][k] for k in keys} == \
        {k: out["jax"][k] for k in keys}
    # Map x3 keeps parity, the Filter keeps the even values: half of a
    # chunk of consecutive integers
    assert out["port"]["sent"] > 0
    assert out["port"]["received"] * 2 == out["port"]["sent"]
