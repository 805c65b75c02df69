"""Operator states inside the port's engine (``NodeStats``: waiting for
input, blocked on output, each fused stage's exclusive service, a source's
pull and push), on-CPU time of the phase spans, the host timeline and its
anchors into a ``torch.profiler`` trace; and that none of it reads a clock
when nothing asks for it."""

import json
import os
import threading
import time
import warnings

import numpy as np
import pytest

from windflow_tpu_torch.api import MultiPipe
from windflow_tpu_torch.core.tuples import Schema
from windflow_tpu_torch.patterns import basic
from windflow_tpu_torch.patterns.basic import Filter, Map, Sink, Source
from windflow_tpu_torch.runtime import comb, engine
from windflow_tpu_torch.runtime.comb import make_comb
from windflow_tpu_torch.runtime.engine import Dataflow
from windflow_tpu_torch.runtime.node import Node, SourceNode
from windflow_tpu_torch.utils import profile

SCHEMA = Schema(value=np.int64)
SLEEP = 0.02


def batch(n=8):
    return np.zeros(n, dtype=SCHEMA.dtype())


class Slept:
    """Sleeps `sleep` seconds a call, and adds up the ms it really slept
    (a loaded host oversleeps)."""

    def __init__(self, sleep):
        self.sleep, self.ms = sleep, 0.0

    def __call__(self):
        if self.sleep:
            t = time.perf_counter()
            time.sleep(self.sleep)
            self.ms += (time.perf_counter() - t) * 1e3


class Emit(SourceNode):
    def __init__(self, n, sleep=0.0, name="src"):
        super().__init__(name)
        self.n, self.slept = n, Slept(sleep)

    def generate(self):
        for _ in range(self.n):
            self.slept()
            self.emit(batch())


class Sleepy(Node):
    """Passes each batch on after sleeping `sleep` seconds."""

    def __init__(self, sleep, name):
        super().__init__(name)
        self.slept = Slept(sleep)

    def svc(self, b, channel=0):
        self.slept()
        self.emit(b)


def logs(trace_dir):
    out = {}
    for fn in os.listdir(trace_dir):
        if fn.endswith(".log"):
            with open(os.path.join(trace_dir, fn)) as f:
                snap = json.load(f)
            out[snap["node"].split("_", 2)[-1]] = snap
    return out


def run_chain(tmp_path, nodes, capacity):
    df = Dataflow("t", capacity=capacity, trace_dir=str(tmp_path))
    for n in nodes:
        df.add(n)
    for a, b in zip(nodes, nodes[1:]):
        df.connect(a, b)
    df.run_and_wait_end(timeout=60)
    return logs(str(tmp_path))


@pytest.fixture
def profile_state():
    """Leave the module's switches as the test found them."""
    forced = profile._FORCED
    yield
    profile.timeline_stop()
    profile.reset()
    if forced is None:
        profile.auto()
    elif forced:
        profile.enable()
    else:
        profile.disable()


def test_put_wait_is_the_time_blocked_on_a_slow_consumer(tmp_path):
    n = 20
    slow = Sleepy(SLEEP, "slow")
    got = run_chain(tmp_path, [Emit(n), slow], capacity=1)
    slept_ms = slow.slept.ms
    assert slept_ms >= n * SLEEP * 1e3
    assert got["src"]["put_wait_ms_total"] == pytest.approx(slept_ms,
                                                            rel=0.2)
    # the consumer never waited long for input, the producer was never idle
    assert got["slow"]["wait_in_ms_total"] < 0.2 * slept_ms
    assert got["slow"]["put_wait_ms_total"] == 0


def test_wait_in_is_the_time_idle_for_input(tmp_path):
    n = 15
    src = Emit(n, sleep=SLEEP)
    got = run_chain(tmp_path, [src, Sleepy(0, "fast")], capacity=4)
    slept_ms = src.slept.ms
    assert got["fast"]["wait_in_ms_total"] == pytest.approx(slept_ms,
                                                            rel=0.2)
    assert got["src"]["put_wait_ms_total"] < 0.2 * slept_ms
    # a source without a pushing shell reports no push/pull split
    assert got["src"]["generate_ms_total"] >= 0.9 * slept_ms
    assert "push_ms_total" not in got["src"]


def test_comb_stages_have_exclusive_times_that_sum_to_its_service(tmp_path):
    n = 25
    stages = [Sleepy(0.001 * k, f"s{k}") for k in (1, 2, 3)]
    fused = make_comb(stages, name="fused")
    got = run_chain(tmp_path, [Emit(n), fused, Sleepy(0, "sink")],
                    capacity=64)
    node = got["fused"]
    times = [node["stages"][f"s{k}"]["svc_ms_total"] for k in (1, 2, 3)]
    # in the ratio of what the stages slept (a loaded host oversleeps the
    # 1, 2 and 3 ms)
    slept = [s.slept.ms for s in stages]
    assert times == pytest.approx(slept, rel=0.1)
    total = sum(times)
    assert [t / total for t in times] == pytest.approx(
        [s / sum(slept) for s in slept], abs=0.03)
    assert total + node["put_wait_ms_total"] == pytest.approx(
        node["svc_time_ms_total"], rel=0.02)
    assert [node["stages"][f"s{k}"]["rcv_tuples"] for k in (1, 2, 3)] \
        == [n * 8] * 3
    assert [node["stages"][f"s{k}"]["rcv_batches"] for k in (1, 2, 3)] \
        == [n] * 3


def test_comb_stage_times_leave_out_blocked_puts(tmp_path):
    n = 12
    stages = [Sleepy(0.001, "a"), Sleepy(0.001, "b")]
    got = run_chain(tmp_path, [Emit(n), make_comb(stages, name="ab"),
                               Sleepy(SLEEP, "slow")], capacity=1)
    node = got["ab"]
    excl = sum(s["svc_ms_total"] for s in node["stages"].values())
    assert node["put_wait_ms_total"] > 0.5 * n * SLEEP * 1e3
    assert excl < 0.5 * node["put_wait_ms_total"]
    assert excl + node["put_wait_ms_total"] == pytest.approx(
        node["svc_time_ms_total"], rel=0.02)


def test_source_pull_is_the_generators_time(tmp_path, monkeypatch,
                                            profile_state):
    monkeypatch.setenv("WF_LOG_DIR", str(tmp_path))
    profile.disable()
    profile.timeline_start()
    n = 10
    seen = []
    slept = Slept(SLEEP)

    def gen(shipper):
        for _ in range(n):
            slept()
            shipper.push_batch(batch(16))

    def work(b):
        time.sleep(0.002)
        return b["value"] >= 0

    (MultiPipe("pull").add_source(Source(gen, SCHEMA, name="src"))
     .chain(Filter(work, vectorized=True, name="flt"))
     .chain_sink(Sink(lambda b: b is None or seen.append(len(b)),
                      vectorized=True, name="snk"))
     .run_and_wait_end())
    tl = profile.timeline_stop()
    assert sum(seen) == 16 * n
    (node,) = [v for v in logs(str(tmp_path)).values()
               if "generate_ms_total" in v]
    assert node["pull_ms_total"] == pytest.approx(slept.ms, rel=0.2)
    # on the timeline, the source thread's pull and push entries take
    # turns and cover its generate time (the engine's own clock) but for
    # the shell's bookkeeping around them
    rows = sorted((e[3], e[4], e[0]) for e in tl["entries"]
                  if e[0] in ("pull", "push"))
    assert [r[2] for r in rows] == ["pull", "push"] * n
    assert all(a[1] <= b[0] for a, b in zip(rows, rows[1:]))
    covered_ms = sum(t1 - t0 for t0, t1, _ in rows) / 1e6
    assert covered_ms == pytest.approx(node["generate_ms_total"], rel=0.02)
    stages = node["stages"]
    assert stages["flt.0"]["svc_ms_total"] >= n * 2.0
    assert stages["flt.0"]["rcv_tuples"] == 16 * n
    # the push is the fused chain: the shell, the Filter and the Sink
    assert sum(s["svc_ms_total"] for s in stages.values()) \
        == pytest.approx(node["push_ms_total"], abs=0.05)


def test_span_cpu_time_sleep_against_busy_loop(profile_state):
    profile.enable()
    profile.reset()
    with profile.span("sleeping"):
        time.sleep(0.1)
    with profile.span("spinning"):
        # 50 ms on the CPU: a loaded host may preempt the loop, so its
        # wall time can be longer
        c_end = time.thread_time() + 0.05
        while time.thread_time() < c_end:
            pass
    wall, cpu = profile.report(), profile.cpu_report()
    assert wall["sleeping"][1] == wall["spinning"][1] == 1
    assert wall["sleeping"][0] >= 0.099
    assert cpu["sleeping"] < 0.2 * wall["sleeping"][0]
    assert 0.05 <= cpu["spinning"] <= wall["spinning"][0] + 1e-3
    profile.reset()
    assert profile.cpu_report() == {}


def test_timeline_drops_and_counts_past_its_bound(profile_state):
    profile.disable()
    profile.timeline_start(cap=4)
    for i in range(10):
        with profile.span(f"s{i}"):
            pass
    tl = profile.timeline_stop()
    assert [e[0] for e in tl["entries"]] == ["s0", "s1", "s2", "s3"]
    assert tl["dropped"] == 6
    name, tid, thread, t0, t1, cpu = tl["entries"][0]
    assert tid == threading.get_native_id()
    assert t1 >= t0 and cpu >= 0 and thread
    assert tl["threads"] == {tid: threading.get_ident()}
    # nothing is recorded once stopped, and disabled spans accumulate nothing
    with profile.span("after"):
        pass
    assert profile.timeline_stop() == {"entries": [], "dropped": 0,
                                      "threads": {}}
    assert profile.report() == {}
    with pytest.raises(ValueError):
        profile.timeline_start(cap=profile.TIMELINE_MAX + 1)


def test_timeline_records_operator_states(tmp_path, profile_state):
    profile.disable()
    profile.timeline_start()
    stages = [Sleepy(0, "a"), Sleepy(0, "b")]
    run_chain(tmp_path, [Emit(3), make_comb(stages, name="ab"),
                         Sleepy(0, "z")], capacity=4)
    tl = profile.timeline_stop()
    names = {e[0] for e in tl["entries"]}
    assert {"wait_in", "put_wait", "svc:a", "svc:b", "svc:ab",
            "svc:z"} <= names
    assert tl["dropped"] == 0


def test_anchor_maps_a_span_into_the_trace(tmp_path, profile_state):
    torch = pytest.importorskip("torch")
    from torch.profiler import ProfilerActivity, record_function
    profile.disable()
    prof = torch.profiler.profile(activities=[ProfilerActivity.CPU])
    prof.start()
    profile.anchor("warm")
    profile.timeline_start()
    a0 = profile.anchor("a0")
    time.sleep(0.1)
    with profile.span("marked"):
        with record_function("inside"):
            time.sleep(0.05)
    time.sleep(0.1)
    a1 = profile.anchor("a1")
    tl = profile.timeline_stop()
    prof.stop()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    mid = {e["name"]: e["ts"] + e.get("dur", 0) / 2 for e in events}
    inside = next(e for e in events if e["name"] == "inside")
    to_us = profile.to_trace_us([a0, a1], [mid["a0"], mid["a1"]])
    (_, _, _, t0, t1, _), = [e for e in tl["entries"] if e[0] == "marked"]
    assert abs(to_us(t0) - inside["ts"]) < 1000
    assert abs(to_us(t1) - (inside["ts"] + inside["dur"])) < 1000


def test_no_clock_is_read_when_nothing_asks(monkeypatch, profile_state):
    """No WF_LOG_DIR, metrics, trace or timeline: a pipeline's run reads
    no clock of the engine, the Comb, the source shell or the profile
    module, and records no timeline entry."""
    monkeypatch.delenv("WF_LOG_DIR", raising=False)
    monkeypatch.delenv("WF_PROFILE", raising=False)
    monkeypatch.delenv("WF_SAMPLE_PERIOD", raising=False)
    profile.auto()
    calls = []

    def counting(name):
        def clock():
            calls.append(name)
            return 0
        return clock

    for mod in (engine, comb, basic):
        monkeypatch.setattr(mod, "_pc_ns", counting(mod.__name__))
    monkeypatch.setattr(profile, "_pc_ns", counting("profile"))
    monkeypatch.setattr(profile, "_cpu_ns", counting("profile.cpu"))
    monkeypatch.setattr(profile._Timeline, "add",
                        lambda *a: calls.append("timeline"))
    seen = []

    def gen(shipper):
        for _ in range(6):
            shipper.push_batch(batch(32))

    (MultiPipe("off").add_source(Source(gen, SCHEMA, name="src"))
     .chain(Filter(lambda b: b["value"] >= 0, vectorized=True))
     .add(Map(lambda b: None, vectorized=True, parallelism=2))
     .add_sink(Sink(lambda b: b is None or seen.append(len(b)),
                   vectorized=True))
     .run_and_wait_end())
    assert sum(seen) == 6 * 32
    assert calls == []


def test_live_metrics_alone_keep_no_operator_states(monkeypatch):
    """metrics= without a trace_dir keeps NodeStats for the live
    registry, but the operator states are read only from node logs: no
    put, get, stage or push clock runs, and the snapshot has no such
    fields."""
    monkeypatch.delenv("WF_LOG_DIR", raising=False)
    calls = []
    for mod in (comb, basic):
        monkeypatch.setattr(mod, "_pc_ns",
                            lambda m=mod.__name__: calls.append(m) or 0)
    monkeypatch.setattr(engine.Dataflow, "_timed_get",
                        lambda *a: calls.append("get"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # WF207: no trace_dir to write
        df = Dataflow("m", capacity=2, metrics=True)
    nodes = [Emit(5), make_comb([Sleepy(0, "a"), Sleepy(0, "b")],
                                name="ab"), Sleepy(0, "z")]
    for n in nodes:
        df.add(n)
    for a, b in zip(nodes, nodes[1:]):
        df.connect(a, b)
    df.run_and_wait_end(timeout=60)
    assert calls == []
    assert all(inbox._put_ns is None for inbox in df._inboxes.values())
    for n in nodes:
        snap = n.stats.snapshot()
        assert snap["rcv_batches"] == (0 if n is nodes[0] else 5)
        assert not {"wait_in_ms_total", "put_wait_ms_total", "stages",
                    "generate_ms_total"} & set(snap)


def ysb_chunks(n=5, chunk=3000):
    """`n` YSB chunks, event time 2 s apart (the warm-up's fake clock)."""
    from windflow_tpu_torch.apps import ysb
    tick = iter(range(10 ** 6))
    return list(ysb.event_batches(2.0 * n + 1.0, chunk,
                                  ysb.CampaignGenerator(),
                                  time_fn=lambda: 2.0 * next(tick)))


@pytest.mark.filterwarnings(
    "ignore:resident device path accumulates:UserWarning")
@pytest.mark.parametrize("variant", ["kf", "kf-gpu"])
def test_ysb_node_log_counts_every_row_move_by_bytes(tmp_path, monkeypatch,
                                                     variant):
    """With node logs, the source's fused node counts each Filter and
    Join batch as moved by bytes (patterns/basic.py's row moves)."""
    from windflow_tpu_torch.apps import ysb
    monkeypatch.setenv("WF_LOG_DIR", str(tmp_path))
    chunks = ysb_chunks()
    pipe, _sink, sent = ysb.build_pipeline(variant, 0, 1, 4, batches=chunks,
                                           device="cpu")
    pipe.run_and_wait_end()
    assert sent[0] == 5 * 3000
    (node,) = [v for v in logs(str(tmp_path)).values()
               if "batches_by_bytes" in v]
    stages = ("ysb_filter.0", "ysb_join.0")
    assert node["batches_by_bytes"] == dict.fromkeys(stages, len(chunks))
    assert node["batches_by_fields"] == dict.fromkeys(stages, 0)
    assert [node["stages"][s]["rcv_batches"] for s in stages] \
        == [len(chunks)] * 2


@pytest.mark.parametrize("knob", ["metrics", "none"])
def test_no_row_move_counter_without_node_logs(monkeypatch, knob):
    """Live metrics alone, or no knob: the Filter and the out-schema Map
    keep no counter and the snapshot has none."""
    monkeypatch.delenv("WF_LOG_DIR", raising=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # WF207: no trace_dir to write
        df = Dataflow("m", capacity=2, metrics=(knob == "metrics") or None)
    (flt,) = Filter(lambda b: b["value"] >= 0, vectorized=True).replicas()
    (mp,) = Map(lambda b, o: None, vectorized=True,
                output_schema=Schema(other=np.int32)).replicas()
    nodes = [Emit(4), flt, mp, Sleepy(0, "z")]
    for n in nodes:
        df.add(n)
    for a, b in zip(nodes, nodes[1:]):
        df.connect(a, b)
    df.run_and_wait_end(timeout=60)
    assert flt._moves is None and mp._moves is None
    if knob == "none":
        assert flt.stats is None and mp.stats is None
        return
    for n in (flt, mp):
        assert n.stats.rcv_batches == 4
        assert n.stats.moves is None
        assert not {"batches_by_bytes", "batches_by_fields"} \
            & set(n.stats.snapshot())
