"""The readers of the program's operator states, on synthetic runs; the
idle gaps labelled by the host timeline, on a synthetic trace."""

import os

import pytest

from benchmark import devtrace, harness, hostgaps

BENCH = harness.load_json(os.path.dirname(harness.HERE), "BENCHMARK.json")
CELL = harness.Cell("ysb_kf.full", BENCH)


def read(metric, run):
    return CELL.reader(metric)(run)


def node(**kw):
    base = {"rcv_batches": 0, "svc_time_ms_total": 0.0,
            "wait_in_ms_total": 0.0, "put_wait_ms_total": 0.0}
    return {**base, **kw}


def ysb_nodes():
    """The YSB pipeline's nodes: the source fused with the Filter and Join,
    the key farm's emitter, two replicas, the collector fused with the
    sink."""
    return {
        "p_00_ysb_source.0+ysb_filter.0+ysb_join.0": node(
            generate_ms_total=9000.0, push_ms_total=6000.0,
            pull_ms_total=3000.0, put_wait_ms_total=500.0),
        "p_01_ysb_kf_gpu.emitter": node(
            rcv_batches=100, svc_time_ms_total=2500.0,
            put_wait_ms_total=300.0, wait_in_ms_total=7000.0),
        "p_02_ysb_kf_gpu.0": node(rcv_batches=50, svc_time_ms_total=9900.0),
        "p_03_ysb_kf_gpu.1": node(rcv_batches=50, svc_time_ms_total=9900.0),
        "p_04_ysb_kf_gpu.collector": node(rcv_batches=9,
                                          svc_time_ms_total=9950.0),
    }


def run_of(**kw):
    base = dict(nodes=ysb_nodes(), records=10 ** 8, window_s=10.0,
                farm="ysb_kf_gpu")
    return harness.Run(**{**base, **kw})


def test_source_chain_is_push_less_blocked_puts_a_record():
    assert read("source_chain_ns_per_event", run_of()) == pytest.approx(
        1e6 * (6000.0 - 500.0) / 1e8)


def test_pace_thread_is_the_busiest_before_the_replicas():
    # the source: 9000 - 500 ms of 10 s; the emitter 2200; the replicas
    # and the collector are left out
    assert read("pace_thread_busy_pct", run_of()) == pytest.approx(85.0)
    nodes = ysb_nodes()
    nodes["p_01_ysb_kf_gpu.emitter"]["svc_time_ms_total"] = 9800.0
    assert read("pace_thread_busy_pct", run_of(nodes=nodes)) \
        == pytest.approx(95.0)


def test_readers_read_nothing_from_a_program_without_the_counters():
    nodes = {k: {f: v for f, v in n.items()
                 if f in ("rcv_batches", "svc_time_ms_total")}
             for k, n in ysb_nodes().items()}
    old = run_of(nodes=nodes, spans={"dispatch": (1.0, 3)})
    for m in ("source_chain_ns_per_event", "pace_thread_busy_pct"):
        assert read(m, old) is None
        assert read(m, harness.Run()) is None


#: the threads' pthread ids: the ship thread's runtime calls carry the low
#: 32 bits, the emitter's the low 32 bits as a signed number
SHIP_IDENT = 0x7F0014000940
EMITTER_IDENT = 0x7F00D5C5DB80


def trace():
    """A synthetic trace: device ops with correlation ids, the runtime
    calls of the ship thread and the emitter (by their pthread ids), and
    the anchors."""
    events = []

    def x(name, ts, dur, cat, tid=0, **args):
        events.append({"ph": "X", "name": name, "ts": ts, "dur": dur,
                       "cat": cat, "tid": tid, "args": args})

    # ops: copy at 5100, kernel at 5300 (launched by tid 7), copy at 6000
    # issued by tid 9, a memset at 6500 whose call precedes the gap
    x("Memcpy HtoD (Pinned -> Device)", 5100, 20, "gpu_memcpy",
      correlation=1)
    ship = SHIP_IDENT & 0xFFFFFFFF
    emitter = (EMITTER_IDENT & 0xFFFFFFFF) - (1 << 32)
    x("cudaMemcpyAsync", 5090, 5, "cuda_runtime", tid=ship, correlation=1)
    x("void wf::append_eval_kernel<int>(Args)", 5300, 10, "kernel",
      correlation=2)
    # a launch under an id that names no thread: its call lies in the ship
    # thread's dispatch span
    x("cudaLaunchKernel", 5290, 5, "cuda_runtime", tid=0x5555,
      correlation=2)
    x("Memcpy HtoD (Pinned -> Device)", 6000, 20, "gpu_memcpy",
      correlation=3)
    x("cudaMemcpyAsync", 5990, 5, "cuda_runtime", tid=emitter,
      correlation=3)
    x("Memset (Device)", 6500, 5, "gpu_memset", correlation=4)
    x("cudaMemsetAsync", 5995, 2, "cuda_runtime", tid=9, correlation=4)
    x("cudaLaunchKernel", 6200, 2, "cuda_runtime", tid=12345,
      correlation=5)
    for label, ts in zip(hostgaps.ANCHORS, (5000, 6000, 7000)):
        x(label, ts - 1, 2, "user_annotation")
    return events


# host ns on the timeline: trace us = ns / 1000 + 5000
ANCHOR_PAIRS = [(-1000, 1000), (999_000, 1_001_000), (1_999_000,
                                                      2_001_000)]
ENTRIES = [
    # name, native tid, thread name, t0_ns, t1_ns, cpu_ns
    ("ship_wait", 7, "wf-ship.0", 0, 280_000, 1000),
    ("dispatch", 7, "wf-ship.0", 280_000, 300_000, 15_000),
    ("device_put", 7, "wf-ship.0", 80_000, 95_000, 10_000),
    ("svc:ysb_kf_gpu.emitter", 9, "p/ysb_kf_gpu.emitter", 300_000,
     500_000, 150_000),
    ("put_wait", 9, "p/ysb_kf_gpu.emitter", 500_000, 990_000, 500),
]


def test_gaps_labelled_by_the_host_sum_as_the_device_op_labels():
    ops, calls, mids = hostgaps.read_trace(trace())
    plain = devtrace.breakdown([(n, s, d) for n, s, d, _ in ops])
    out = hostgaps.host_gaps(ops, calls, mids, ANCHOR_PAIRS,
                             {"entries": ENTRIES, "dropped": 0,
                              "threads": {7: SHIP_IDENT,
                                          9: EMITTER_IDENT}})
    assert out["device_op_labels"] == plain["idle_gaps"]
    assert out["host_idle_s"] == pytest.approx(out["idle_s"])
    assert out["idle_s"] == pytest.approx(
        sum(t for _, t in plain["idle_gaps"]))
    got = dict(out["idle_gaps"])
    # gap 5120..5300: the ship thread waited for work until 5280, then
    # dispatched; gap 5310..6000: the emitter served until 5500, then
    # blocked in a put; gap 6020..6500: the memset's call came before it
    assert got == pytest.approx({
        "wf-ship: ship_wait (1 gaps)": 180e-6,
        "p/ysb_kf_gpu.emitter: put_wait (1 gaps)": 690e-6,
        "p/ysb_kf_gpu.emitter: no span (1 gaps)": 480e-6})
    assert out["mid_anchor_off_us"] == pytest.approx(0.0, abs=1e-6)
    assert out["ship_launches_inside"] == [1, 1]
    assert out["timeline_dropped"] == 0
    assert out["source_cover"] is None


def test_source_cover_of_pull_and_push():
    entries = [("pull", 3, "src", 0, 600, 0), ("push", 3, "src", 600, 900, 0),
               ("pull", 3, "src", 950, 1000, 0)]
    got = hostgaps.source_cover(entries)
    assert got == pytest.approx({"pull": 650e-9, "push": 300e-9,
                                 "cover": 0.95})


def test_gaps_keep_the_device_op_labels_without_a_timeline():
    ops, calls, mids = hostgaps.read_trace(trace())
    plain = devtrace.breakdown([(n, s, d) for n, s, d, _ in ops])
    for timeline, anchors in ((None, []), ({"entries": [], "dropped": 0},
                                           [])):
        out = hostgaps.host_gaps(ops, calls, mids, anchors, timeline)
        assert out["idle_gaps"] == plain["idle_gaps"]
        assert "host_idle_s" not in out


def test_thread_role_drops_trailing_indices():
    assert hostgaps.role("wf-ship.0") == "wf-ship"
    assert hostgaps.role("p/ysb_kf_gpu.3") == "p/ysb_kf_gpu"
    assert hostgaps.role("devtrace") == "devtrace"
