"""YSB through Win_MapReduce (``apps.ysb.build_pipeline("wmr-gpu")`` on
``device="cpu"``) against the benchmark's plain-torch reference of the MAP
partials and the REDUCE merge (``benchmark/reference/wmr_torch.py``) and the
NumPy campaign windows; the open loop's fixed work; the WinMap emitter's,
the reorder collector's and the REDUCE stage's node-log counters, which
read no clock without node logs; and the cell ``ysb_wmr.open_40m`` with its
three readers."""

import os
import re
import tempfile
import time

import numpy as np
import pytest

from benchmark import harness, pacing
from benchmark.reference import compare, wmr_torch, ysb_windows
from benchmark.systems import ysb_wmr
from windflow_tpu_torch.apps import ysb
from windflow_tpu_torch.patterns import win_mapreduce, win_farm, win_seq
from windflow_tpu_torch.patterns.win_farm import WFCollectorNode
from windflow_tpu_torch.runtime.node import Node

pytestmark = pytest.mark.filterwarnings(
    "ignore:resident device path accumulates:UserWarning")

CELL = "ysb_wmr.open_40m"
BENCH = harness.load_json(os.path.dirname(harness.HERE), "BENCHMARK.json")
FIELDS = ("key", "id", "count", "lastUpdate", "revenue")
N_CAMPAIGNS, ADS, MAP_DEGREE = 100, 10, 4
WIN_US = 1_000_000


def system(seed, chunk):
    cell = harness.Cell(CELL, BENCH)
    return ysb_wmr.System(cell.config, {**cell.mix, "chunk": chunk}, seed,
                          "cpu")


def stamps(rng, n, step_s):
    """`n` non-decreasing chunk times (s) from 0, gaps up to 2 x step."""
    return np.concatenate(([0.0], np.cumsum(rng.uniform(0, 2 * step_s,
                                                        n - 1))))


def us(t):
    """Chunk times in seconds as the stamps the chunks carry (us), as the
    benchmark's ``expected`` makes them from the due times."""
    return (np.asarray(t) * 1e6).astype(np.int64)


def run_port(sysm, ts, monkeypatch, on_result=None):
    """The port's wmr-gpu pipeline over the chunks made at times `ts`
    (s); returns the MAP partials the MAP collector released, ordered by
    key and id."""
    taps = []

    def tapped(self, batch):
        if batch is not None and self.name.endswith("_map.collector"):
            taps.append(batch.copy())
        Node.emit(self, batch)
    monkeypatch.setattr(WFCollectorNode, "emit", tapped)
    chunks = [sysm.make_chunk(c, t) for c, t in enumerate(ts)]
    pipe, _sink, sent = ysb.build_pipeline(
        "wmr-gpu", 0, 1, MAP_DEGREE, WIN_US / 1e6, sysm.C, batches=chunks,
        on_result=on_result, device="cpu")
    pipe.run_and_wait_end()
    assert sent[0] == len(ts) * sysm.C
    t = np.concatenate(taps)
    return t[np.lexsort((t["id"], t["key"]))]


CASES = [(2 ** 31 + 5, 300, 0.37), (7, 3000, 0.21), (2 ** 40 + 3, 1000, 0.5),
         (123456789, 2048, 0.9)]


@pytest.mark.parametrize("seed,chunk,step", CASES)
def test_reference_merge_equals_the_campaign_windows(seed, chunk, step):
    rng = np.random.default_rng(seed % 2 ** 32)
    v0 = int(rng.integers(0, 2 ** 40))
    ts = us(stamps(rng, 14, step))
    got = wmr_torch.campaign_windows(v0, chunk, ts, N_CAMPAIGNS, ADS, WIN_US,
                                     MAP_DEGREE)
    want = ysb_windows.campaign_windows(v0, chunk, ts, N_CAMPAIGNS, ADS,
                                        WIN_US)
    assert got == want and len(want) > N_CAMPAIGNS


def test_reference_partials_by_brute_force():
    """Each partial against a per-event loop over the same events."""
    v0, chunk, n = 99_991, 500, 3
    ts = np.array([0, 400_000, 900_000, 1_300_000, 2_700_000])
    p = wmr_torch.map_partials(v0, chunk, ts, N_CAMPAIGNS, ADS, WIN_US, n)
    seen, acc = {}, {}
    last_w = {}
    for c, t in enumerate(ts):
        for v in range(v0 + c * chunk, v0 + (c + 1) * chunk):
            vm = v % ysb_windows.PERIOD
            if vm % 3:
                continue
            k = (vm % (N_CAMPAIGNS * ADS)) // ADS
            j = seen.get(k, 0)
            seen[k] = j + 1
            i, w = (k % n + j) % n, int(t) // WIN_US
            a = acc.setdefault((k, i + w * n), [0, wmr_torch.EMPTY_MAX, 0])
            a[0] += 1
            a[1] = max(a[1], int(t))
            a[2] += vm % 97 + 1
            last_w[k] = max(last_w.get(k, -1), w)
    want = [(k, d, *acc.get((k, d), (0, wmr_torch.EMPTY_MAX, 0)))
            for k in sorted(last_w) for d in range((last_w[k] + 1) * n)]
    got = list(zip(*(p[f].tolist() for f in FIELDS)))
    assert got == want


@pytest.mark.parametrize("seed,chunk,step", CASES[:3])
def test_port_gives_the_reference_partials_and_windows(seed, chunk, step,
                                                       monkeypatch):
    sysm = system(seed, chunk)
    rng = np.random.default_rng(seed % 2 ** 32)
    ts = stamps(rng, 12, step)
    out = []
    partials = run_port(sysm, ts, monkeypatch,
                        on_result=lambda r: out.append(r.copy()))
    ref = wmr_torch.map_partials(sysm.v0, chunk, us(ts), N_CAMPAIGNS, ADS,
                                 WIN_US, MAP_DEGREE)
    for f in FIELDS:
        np.testing.assert_array_equal(partials[f], ref[f].numpy(), f)
    rows = np.concatenate(out)
    got = {(int(r["key"]), int(r["id"])):
           (int(r["count"]), int(r["lastUpdate"]), int(r["revenue"]))
           for r in rows}
    assert len(got) == len(rows)
    assert got == wmr_torch.reduce_windows(ref, MAP_DEGREE)


def test_open_mix_above_the_rate_is_fixed_work():
    """Behind schedule all through, an open loop sends the same chunks with
    the same stamps on every run of a seed, and never sleeps."""
    mix = {**harness.Cell(CELL, BENCH).mix, "chunk": 4096}

    def one_run():
        sysm = system(2 ** 31 + 77, mix["chunk"])
        t = [0.0]

        def clock():          # a pipeline far slower than the rate
            t[0] += 1.0
            return t[0]
        slept = []
        paced = pacing.Paced(mix, sysm.make_chunk, 0.01, clock=clock,
                             sleep=slept.append)
        return list(paced), paced.due, slept
    a, due_a, slept_a = one_run()
    b, due_b, slept_b = one_run()
    assert slept_a == slept_b == []
    assert len(a) == pacing.n_open_chunks(mix, 0.01) == len(b) > 1
    period = mix["chunk"] / mix["rate"]
    assert due_a == due_b == [c * period for c in range(len(a))]
    for x, y in zip(a, b):
        assert x.tobytes() == y.tobytes()


def test_the_cells_schedule():
    cell = harness.Cell(CELL, BENCH)
    assert cell.mix == {"loop": "open", "chunk": 262144, "rate": 40000000}
    n = pacing.n_open_chunks(cell.mix, BENCH["run_seconds"])
    assert n == 4578 and n * cell.mix["chunk"] == 1_200_095_232


def logs(trace_dir):
    """{node name: its log}; a log's node is ``<dataflow>_<nn>_<name>``."""
    out = {}
    for fn in os.listdir(trace_dir):
        if fn.endswith(".log"):
            snap = harness.load_json(trace_dir, fn)
            out[re.match(r".*?_\d{2}_(.*)$", snap["node"]).group(1)] = snap
    return out


def test_counters_in_the_node_logs(tmp_path, monkeypatch):
    monkeypatch.setenv("WF_LOG_DIR", str(tmp_path))
    sysm = system(2 ** 33 + 9, 3000)
    ts = stamps(np.random.default_rng(3), 10, 0.4)
    out = []
    partials = run_port(sysm, ts, monkeypatch,
                        on_result=lambda r: out.append(r.copy()))
    got = logs(str(tmp_path))
    em = got[sysm.emitter]
    assert em["wm_assign_ms_total"] > 0 and em["wm_scatter_ms_total"] > 0
    assert (em["wm_assign_ms_total"] + em["wm_scatter_ms_total"]
            <= em["svc_time_ms_total"])
    coll = got[sysm.collector]
    assert coll["reorder_released"] == len(partials) == coll["rcv_tuples"]
    assert 0 < coll["reorder_held_max"] <= len(partials)
    red = got[sysm.reduce]
    delivered = sum(len(r) for r in out)
    assert red["reduce_windows"] == delivered == red["windows_fired"]
    # the last window of every campaign fires only at the end of the stream
    assert red["reduce_eos_windows"] == N_CAMPAIGNS
    # no other node keeps these counters
    keys = {"wm_assign_ms_total", "wm_scatter_ms_total", "reorder_released",
            "reorder_held_max", "reduce_windows", "reduce_eos_windows"}
    for name, snap in got.items():
        if name not in (sysm.emitter, sysm.collector, sysm.reduce):
            assert not keys & set(snap), name


def _counting_clock(monkeypatch):
    calls = []

    def clock():
        calls.append(1)
        return 0
    monkeypatch.setattr(win_mapreduce, "_pc_ns", clock)
    return calls


def _instances(monkeypatch, *classes):
    made = []
    for cls in classes:
        init = cls.svc_init

        def svc_init(self, init=init):
            made.append(self)
            init(self)
        monkeypatch.setattr(cls, "svc_init", svc_init)
    return made


@pytest.mark.parametrize("knob", ["none", "metrics"])
@pytest.mark.parametrize("variant", ["wmr-gpu", "kf-gpu"])
def test_no_counter_without_node_logs(monkeypatch, variant, knob):
    """No node logs (no knob, or live metrics alone): the emitter reads no
    clock and no node keeps a counter; the key farm's run alike."""
    import warnings
    monkeypatch.delenv("WF_LOG_DIR", raising=False)
    calls = _counting_clock(monkeypatch)
    made = _instances(monkeypatch, win_mapreduce.WinMapEmitterNode,
                      WFCollectorNode, win_seq.WinSeqNode)
    sysm = system(2 ** 31 + 1, 2000)
    chunks = [sysm.make_chunk(c, 0.3 * c) for c in range(8)]
    pipe, _sink, _sent = ysb.build_pipeline(variant, 0, 1, MAP_DEGREE, 1.0,
                                            sysm.C, batches=chunks,
                                            device="cpu")
    if knob == "metrics":
        pipe._metrics_arg = True
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # WF207: no trace_dir to write
        pipe.run_and_wait_end()
    assert calls == []
    assert made
    for node in made:
        assert getattr(node, "_ns", None) is None
        assert getattr(node, "_counts", None) is None
        assert node._reduce_counts is None if isinstance(
            node, win_seq.WinSeqNode) else True
        if node.stats is not None:
            snap = node.stats.snapshot()
            assert not {"wm_assign_ms_total", "reorder_released",
                        "reduce_windows"} & set(snap)
    if variant == "wmr-gpu":
        assert {type(n) for n in made} >= {win_mapreduce.WinMapEmitterNode,
                                           WFCollectorNode}


def test_ordered_win_farm_collector_counts_only_with_node_logs(
        tmp_path, monkeypatch):
    """The ordered WinFarm's collector is the same class: with node logs
    it counts every row it releases; its REDUCE-role workers count their
    windows."""
    from windflow_tpu_torch.api import MultiPipe
    from windflow_tpu_torch.core.tuples import Schema, batch_from_columns
    from windflow_tpu_torch.core.windows import Role
    from windflow_tpu_torch.patterns.basic import Sink, Source
    monkeypatch.setenv("WF_LOG_DIR", str(tmp_path))
    schema = Schema(value=np.int64)
    n = 4000

    def gen(shipper):
        for s in range(0, n, 500):
            idx = np.arange(s, s + 500)
            shipper.push_batch(batch_from_columns(
                schema, key=idx % 7, id=idx // 7, ts=idx, value=idx))
    got = []
    (MultiPipe("wf").add_source(Source(gen, schema, name="src"))
     .add(win_farm.WinFarm(lambda key, gwid, rows: int(rows["value"].sum()),
                           8, 8, pardegree=3, name="farm", incremental=False,
                           result_fields={"value": np.int64},
                           role=Role.REDUCE))
     .add_sink(Sink(lambda b: b is None or got.append(len(b)),
                    vectorized=True, name="sink"))
     .run_and_wait_end())
    snaps = logs(str(tmp_path))
    coll = snaps["farm.collector"]
    assert coll["reorder_released"] == sum(got) == coll["rcv_tuples"]
    workers = [v for k, v in snaps.items() if re.match(r"farm\.\d+$", k)]
    assert len(workers) == 3
    assert sum(w["reduce_windows"] for w in workers) == sum(got)


def hand_run(**kw):
    """A run whose node logs were written by hand."""
    farm = ysb_wmr.MAP
    nodes = {
        f"p_01_{farm}.0": {"svc_time_ms_total": 300.0},
        f"p_02_{farm}.1": {"svc_time_ms_total": 500.0},
        f"p_03_{farm}.emitter": {
            "svc_time_ms_total": 900.0, "put_wait_ms_total": 100.0,
            "rcv_tuples": 4_000_000, "wm_assign_ms_total": 350.0,
            "wm_scatter_ms_total": 400.0},
        f"p_04_{farm}.collector": {"svc_time_ms_total": 6.0,
                                   "reorder_released": 1200},
        f"p_05_{ysb_wmr.REDUCE}.0": {"svc_time_ms_total": 3.0,
                                     "reduce_windows": 300,
                                     "reduce_eos_windows": 100},
        "p_06_ysb_sink.0": {"svc_time_ms_total": 1.0},
    }
    return harness.Run(**{"nodes": nodes, "farm": farm, "window_s": 2.0,
                          "records": 12_000_000, **kw})


def test_cell_loads_its_files_and_readers_read_a_hand_built_run():
    cell = harness.Cell(CELL, BENCH)
    assert cell.config["name"] == "ysb_wmr" and cell.chips == 1
    assert cell.config["variant"] == "wmr-gpu"
    assert cell.config["reduced"] == []
    sysm = cell.system(5, "cpu")
    assert sysm.farm == ysb_wmr.MAP
    assert (sysm.emitter, sysm.collector, sysm.reduce) == (
        "ysb_wmr_gpu_map.emitter", "ysb_wmr_gpu_map.collector",
        "ysb_wmr_gpu_reduce.0")
    new = {m["name"] for m in cell.per_layer}
    assert new == {"wm_emitter_ns_per_tuple", "map_stage_busy_pct",
                   "reduce_us_per_window"}
    assert {m["name"] for m in cell.end_to_end} == {"tuples_per_s",
                                                    "setup_s"}
    run = hand_run()
    want = {"wm_emitter_ns_per_tuple": 1e6 * 800.0 / 4_000_000,
            "map_stage_busy_pct": 100.0 * 0.8 / (2 * 2.0),
            "reduce_us_per_window": 1e3 * 9.0 / 300}
    for name, value in want.items():
        assert cell.reader(name)(run) == pytest.approx(value, rel=1e-12)


def test_readers_read_nothing_new_from_a_program_without_the_counters():
    """The parent's node logs have no WinMap emitter or REDUCE counters:
    those readers return None, and the MAP stage's busy share still
    reads; with no node logs at all every reader returns None."""
    cell = harness.Cell(CELL, BENCH)
    run = hand_run()
    for n in run.nodes.values():
        for k in ("wm_assign_ms_total", "wm_scatter_ms_total",
                  "reorder_released", "reduce_windows",
                  "reduce_eos_windows"):
            n.pop(k, None)
    assert cell.reader("wm_emitter_ns_per_tuple")(run) is None
    assert cell.reader("reduce_us_per_window")(run) is None
    assert cell.reader("map_stage_busy_pct")(run) == pytest.approx(20.0)
    empty = harness.Run(farm=ysb_wmr.MAP, window_s=2.0)
    for m in cell.per_layer:
        assert cell.reader(m["name"])(empty) is None


SMALL_MIX = {"chunk": 16384, "rate": 8_000_000}
SMALL_CFG = {"warm_chunks": 3, "warm_event_s": 0.25, "win_sec": 0.4}


def small_run(monkeypatch, trace, seed=2 ** 31 + 5):
    """The cell on the CPU at a small size: 0.4 s windows, a 1 s schedule,
    the MAP replicas shipping 4,096 rows a flush so that a window spans
    several launches."""
    from windflow_tpu_torch.patterns import win_seq_gpu
    cell = harness.Cell(CELL, BENCH)
    cell.mix.update(SMALL_MIX)
    cell.config.update(SMALL_CFG)
    init = win_seq_gpu.WinMapReduceGPU.__init__
    monkeypatch.setattr(
        win_seq_gpu.WinMapReduceGPU, "__init__",
        lambda self, *a, **k: init(self, *a, **{"flush_rows": 1 << 12, **k}))
    with tempfile.TemporaryDirectory() as scratch:
        run, readings, _ = harness.run_cell(cell, seed, 1.0, trace, "cpu",
                                            time.perf_counter(), scratch)
    return cell, run, readings


def test_sound_run_of_the_cell_is_correct(monkeypatch):
    cell, run, readings = small_run(monkeypatch, True)
    assert compare.passed(readings), readings
    assert readings["results"] == readings["expected"] == 3 * N_CAMPAIGNS
    line = harness.result_line(cell, run, readings, 0, True, "cpu")
    assert line["correct"]
    assert set(line["metrics"]) == {m["name"] for m in cell.per_layer}
    red = [n for n in run.nodes.values() if "reduce_windows" in n]
    assert [n["reduce_windows"] for n in red] == [readings["results"]]


def _state_unchanged(monkeypatch):
    from windflow_tpu_torch.ops import resident
    orig = resident.ring_append_eval
    monkeypatch.setattr(resident, "ring_append_eval",
                        lambda ring, *a, **k: orig(ring.clone(), *a, **k))


def _half_batch(monkeypatch):
    from windflow_tpu_torch.patterns.native_core import NativeResidentCore
    orig = NativeResidentCore._process_rows
    monkeypatch.setattr(NativeResidentCore, "_process_rows",
                        lambda self, b: orig(self, b[: len(b) // 2]))


def _answer_altered(monkeypatch):
    from windflow_tpu_torch.patterns.native_core import NativeResidentCore
    orig = NativeResidentCore._harvest

    def altered(self, harvested):
        out = orig(self, harvested)
        if len(out):
            out["revenue"][0] += 1
        return out
    monkeypatch.setattr(NativeResidentCore, "_harvest", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_map_path_is_not_correct(fault, monkeypatch):
    """A fault in the MAP replicas' device path shows in the check: the
    ring left unchanged by the kernel, half of each batch dropped, one
    partial's answer altered."""
    FAULTS[fault](monkeypatch)
    _, _, readings = small_run(monkeypatch, False)
    assert not compare.passed(readings), readings
