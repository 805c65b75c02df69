"""Twins of tests/test_federation.py over the port's federation tier
(windflow_tpu_torch/obs/{federation,slo}.py and the engine's
``federate=``), the same tests with the package name changed.  The
scripts they drive (wf_top, wf_blackbox) are the JAX package's: they
render the port's state files and black boxes, so the formats are held
to the reference's.  The port builds the shipper and the black box
before the node threads start (test_node_error_blackbox_built_before
_threads); the reference builds them after, a race.

Plane-wide observability (docs/OBSERVABILITY.md "Federation & SLOs"):

* the ``federate=`` knob contract: unset never imports
  ``obs.federation`` / ``obs.slo`` and keeps the wire byte-identical;
* the ``-8`` TELEMETRY frame family (ship, sink, refusal, size cap);
* SLO objectives and multi-window burn rates (transitions-only events);
* the aggregator: ingest, staleness, spooling, the federated
  host-labelled exposition, and the ``wf_top --plane`` state file;
* the crash black-box (flight recorder + wf_blackbox renderer);
* size-based rotation of ``metrics.jsonl`` / ``events.jsonl`` and
  ``wf_top``'s read-across-the-roll;
* ``Rescale(up_slo_burn=)``, the control-plane bridge;
* the 3-process demo: two shipping workers, one killed -9 — the
  availability objective burns, the victim's black box survives at the
  aggregator, the survivor stays fresh.
"""

import glob
import importlib.util
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from windflow_tpu_torch.core.tuples import Schema, batch_from_columns
from windflow_tpu_torch.obs import EventLog, MetricsRegistry
from windflow_tpu_torch.obs.expo import _esc, render_registry, render_sample
from windflow_tpu_torch.obs.federation import (SNAP_VERSION, BlackBox,
                                         FederationPolicy,
                                         FederationShipper,
                                         TelemetryAggregator, as_policy)
from windflow_tpu_torch.obs.sampler import Sampler
from windflow_tpu_torch.obs.slo import (SloEvaluator, SloObjective, SloPolicy,
                                  local_view)
from windflow_tpu_torch.parallel.channel import (_LEN, ChannelError, RowReceiver,
                                           RowSender)
from windflow_tpu_torch.runtime.engine import Dataflow
from windflow_tpu_torch.runtime.node import Node, SourceNode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEMA = Schema(value=np.int64)


@pytest.fixture(autouse=True)
def _no_ambient_obs_env(monkeypatch):
    monkeypatch.delenv("WF_LOG_DIR", raising=False)
    monkeypatch.delenv("WF_SAMPLE_PERIOD", raising=False)


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mk_batch(n=8, lo=0):
    ids = np.arange(lo, lo + n)
    return batch_from_columns(SCHEMA, key=np.zeros(n), id=ids, ts=ids,
                              value=ids)


def mk_snap(host="w1", seq=0, t=None, **over):
    snap = {"v": SNAP_VERSION, "host": host,
            "t": time.time() if t is None else t, "seq": seq,
            "dataflow": "df", "nodes": [], "dead_letters": 0,
            "counters": {}, "gauges": {}}
    snap.update(over)
    return snap


# ----------------------------------------------------------- knob contract

def test_federation_policy_validation():
    with pytest.raises(ValueError):
        FederationPolicy(period=0)
    with pytest.raises(ValueError):
        FederationPolicy(keep=0)
    with pytest.raises(ValueError):
        FederationPolicy(event_tail=-1)
    with pytest.raises(ValueError):
        FederationPolicy(stale_after=0)
    with pytest.raises(TypeError):
        FederationPolicy(slo=object())
    assert FederationPolicy(period=2.0).stale_after == 6.0
    assert as_policy(True).period == 1.0
    pol = FederationPolicy(host="h")
    assert as_policy(pol) is pol
    with pytest.raises(TypeError):
        as_policy(1.5)


def test_federation_policy_agrees_with():
    slo = SloPolicy([SloObjective("a", "depth", bad_above=10)])
    a = FederationPolicy(host="h", period=0.5, slo=slo)
    assert a.agrees_with(FederationPolicy(host="h", period=0.5, slo=slo))
    assert not a.agrees_with(FederationPolicy(host="h", period=0.25,
                                              slo=slo))
    # slo compares by identity: one process runs one evaluator
    twin = SloPolicy([SloObjective("a", "depth", bad_above=10)])
    assert not a.agrees_with(FederationPolicy(host="h", period=0.5,
                                              slo=twin))


def test_federate_unset_never_imports_package():
    """Seed contract: federate= unset => windflow_tpu_torch.obs.federation and
    obs.slo are never imported (subprocess keeps sys.modules clean)."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from windflow_tpu_torch.api import MultiPipe\n"
        "from windflow_tpu_torch.core.tuples import Schema\n"
        "from windflow_tpu_torch.patterns.basic import Sink, Source\n"
        "S = Schema(value=np.int64)\n"
        "def gen(sh):\n"
        "    sh.push(key=0, id=0, ts=0, value=1)\n"
        "got = []\n"
        "p = (MultiPipe('seed', metrics=True)\n"
        "     .add_source(Source(gen, S))\n"
        "     .chain_sink(Sink(lambda b: got.append(b),"
        " vectorized=True)))\n"
        "p.run_and_wait_end()\n"
        "assert any(b is not None and len(b) for b in got)\n"
        "for mod in ('windflow_tpu_torch.obs.federation',"
        " 'windflow_tpu_torch.obs.slo'):\n"
        "    assert mod not in sys.modules, \\\n"
        "        mod + ' imported on the seed path'\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("WF_LOG_DIR", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_federate_unset_wire_is_byte_identical_to_seed():
    """federate= unset: the wire carries ONLY the seed grammar (dtype
    frame, data frames, -4 epochs, -1 EOS) — no -8 telemetry frames.
    Captured off a raw socket so nothing in the channel implementation
    can vouch for itself."""
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]

    def feed():
        s = RowSender("127.0.0.1", port)
        s.send(mk_batch(4))
        s.send_epoch(1)
        s.send(mk_batch(4, lo=50))
        s.close()
        assert not hasattr(s, "_journal"), "journal built without resume="

    t = threading.Thread(target=feed)
    t.start()
    conn, _ = srv.accept()
    raw = bytearray()
    while True:
        chunk = conn.recv(65536)
        if not chunk:
            break
        raw.extend(chunk)
    t.join()
    conn.close()
    srv.close()
    lens, off = [], 0
    while off < len(raw):
        (n,) = _LEN.unpack(bytes(raw[off:off + 8]))
        off += 8
        lens.append(n)
        if n > 0:
            off += n
        elif n == -4:
            off += 8
        else:
            assert n == -1, f"non-seed control frame {n} on the wire"
    assert off == len(raw)
    assert [n for n in lens if n < 0] == [-4, -1]
    assert sum(1 for n in lens if n > 0) == 3   # dtype + 2 payloads


def test_engine_federate_falsy_means_off():
    for falsy in (None, 0, 0.0, False):
        df = Dataflow("off", federate=falsy)
        assert df.federate is None and df.federation is None


def test_wf217_federate_without_metrics_warns():
    with pytest.warns(UserWarning, match="WF217"):
        Dataflow("blind", federate=True)
    import warnings
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        Dataflow("fed", metrics=True, federate=True)
    assert not [w for w in rec if "WF217" in str(w.message)]


def test_union_federate_policies_must_agree():
    from windflow_tpu_torch.api import MultiPipe, union_multipipes
    from windflow_tpu_torch.patterns.basic import Source

    def _leg(name, fed):
        p = MultiPipe(name, federate=fed)
        p.add_source(Source(lambda sh: None, SCHEMA))
        return p

    pol = FederationPolicy(host="h", period=0.5)
    merged = union_multipipes(_leg("a", pol), _leg("b", None), name="u")
    assert merged.federate is pol
    with pytest.raises(ValueError, match="conflicting federate"):
        union_multipipes(_leg("c", pol),
                         _leg("d", FederationPolicy(host="h", period=2.0)),
                         name="u2")


# ------------------------------------------------------------- SLO layer

def test_slo_objective_validation():
    with pytest.raises(ValueError):
        SloObjective("", "sig", bad_above=1)
    with pytest.raises(ValueError):
        SloObjective("x", "sig")                       # no direction
    with pytest.raises(ValueError):
        SloObjective("x", "sig", bad_above=1, bad_below=0)
    with pytest.raises(ValueError):
        SloObjective("x", "sig", bad_above=1, budget=0.0)
    with pytest.raises(ValueError):
        SloObjective("x", "sig", bad_above=1, budget=1.0)
    with pytest.raises(ValueError):
        SloObjective("x", "sig", bad_above=1, fast_window=0)
    with pytest.raises(ValueError):
        SloObjective("x", "sig", bad_above=1, fast_window=30,
                     slow_window=30)
    with pytest.raises(ValueError):
        SloObjective("x", "sig", bad_above=1, burn_threshold=0)
    hi = SloObjective("lat", "q95_us", bad_above=100.0)
    assert hi.bad(101) and not hi.bad(100)
    lo = SloObjective("avail", "availability", bad_below=0.9)
    assert lo.bad(0.5) and not lo.bad(0.9)


def test_slo_policy_validation():
    with pytest.raises(ValueError):
        SloPolicy([])
    with pytest.raises(TypeError):
        SloPolicy([object()])
    o = SloObjective("a", "sig", bad_above=1)
    with pytest.raises(ValueError):
        SloPolicy([o, SloObjective("a", "sig", bad_below=0)])
    with pytest.raises(TypeError):
        SloEvaluator(o)   # needs the policy, not a bare objective


def test_slo_multi_window_burn_and_transition_events():
    """burn = bad_fraction/budget over BOTH windows; one event per state
    transition, never per observation."""
    obj = SloObjective("lat", "q95_us", bad_above=100.0, budget=0.5,
                       fast_window=10.0, slow_window=100.0,
                       burn_threshold=1.0)
    m, ev = MetricsRegistry(), EventLog()
    sl = SloEvaluator(SloPolicy([obj]), metrics=m, events=ev, scope="t")
    for now in range(0, 5):                       # 5 good samples
        sl.observe({"q95_us": 50.0}, now=float(now))
    assert sl.burning() == []
    for now in range(5, 10):                      # then 5 bad
        sl.observe({"q95_us": 200.0}, now=float(now))
    # at now=9 both windows hold 5/10 bad = burn 1.0 >= threshold
    assert sl.burning() == ["lat"]
    for now in range(10, 26):                     # recovery
        sl.observe({"q95_us": 50.0}, now=float(now))
    assert sl.burning() == []
    burns = [e for e in ev.recent if e["event"] == "slo_burn"]
    assert [e["state"] for e in burns] == ["burn", "ok"]
    assert burns[0]["objective"] == "lat"
    assert burns[0]["scope"] == "t"
    assert burns[0]["threshold"] == 1.0
    g = m.snapshot()["gauges"]
    assert 'slo_burn_fast{objective="lat"}' in g
    assert 'slo_burn_slow{objective="lat"}' in g
    assert g["slo_burn_max"] < 1.0                # recovered


def test_slo_absent_signal_is_skipped():
    sl = SloEvaluator(SloPolicy([SloObjective(
        "avail", "availability", bad_below=0.9)]), metrics=MetricsRegistry())
    assert sl.observe({"q95_us": 1.0}, now=1.0) == []
    g = sl._metrics.snapshot()["gauges"]
    assert 'slo_burn_fast{objective="avail"}' not in g


def test_slo_local_view_signals_and_rates():
    prev = {"t": 10.0, "nodes": [{"shed": 4, "quarantined": 0}],
            "dead_letters": 0}
    rec = {"t": 12.0, "dead_letters": 3,
           "nodes": [{"q_p95_us": 5.0, "svc_p95_us": 7.0, "depth": 3,
                      "shed": 10, "quarantined": 2}]}
    v = local_view(rec, prev)
    assert v["q95_us"] == 5.0 and v["svc95_us"] == 7.0
    assert v["depth"] == 3 and v["dead_letters"] == 3
    assert v["shed_rate"] == 3.0 and v["quarantine_rate"] == 1.0
    first = local_view(rec)                       # no prev: rates 0
    assert first["shed_rate"] == 0.0


# -------------------------------------------------------------- shipper

def test_shipper_snapshot_schema_and_ring():
    ev = EventLog()
    for i in range(4):
        ev.emit("epoch", n=i)
    pol = FederationPolicy(host="h1", keep=3, event_tail=2)
    sh = FederationShipper(pol, host="h1", dataflow_name="df0", events=ev)
    for seq in range(5):
        sh.on_sample({"t": 100.0 + seq, "seq": seq, "dataflow": "df0",
                      "nodes": [{"node": "n", "id": "x", "depth": seq,
                                 "hwm": 9, "shed": 0, "quarantined": 0,
                                 "rcv_tuples": 10 * seq,
                                 "q_p95_us": 1.5}],
                      "dead_letters": 1, "counters": {"c": seq},
                      "gauges": {"g": 2.0}})
    assert len(sh.recent) == 3                    # keep-bounded ring
    snap = sh.snapshot()
    assert snap["v"] == SNAP_VERSION and snap["host"] == "h1"
    assert snap["seq"] == 4 and snap["dataflow"] == "df0"
    assert snap["counters"] == {"c": 4} and snap["gauges"] == {"g": 2.0}
    (n,) = snap["nodes"]
    # compact node projection: no id/hwm, keeps the plane-view fields
    assert n == {"node": "n", "depth": 4, "shed": 0, "quarantined": 0,
                 "rcv_tuples": 40, "q_p95_us": 1.5}
    assert [e["n"] for e in snap["events"]] == [2, 3]   # event_tail=2
    assert json.loads(json.dumps(snap)) == snap   # wire-encodable


def test_shipper_host_label_sanitised():
    sh = FederationShipper(FederationPolicy(), host='bad host/"x"')
    assert sh.host == "bad_host__x_"


# ------------------------------------------------------- the -8 family

def test_telemetry_frame_roundtrip_over_the_wire():
    ms, mr = MetricsRegistry(), MetricsRegistry()
    agg = TelemetryAggregator(FederationPolicy())
    recv = RowReceiver(n_senders=1, metrics=mr, telemetry_sink=agg)

    def feed():
        s = RowSender("127.0.0.1", recv.port, metrics=ms)
        s.send(mk_batch(4))
        s.send_telemetry(mk_snap(host="w1", seq=7,
                                 counters={"sealed": 3}))
        s.close()

    t = threading.Thread(target=feed)
    t.start()
    got = list(recv.batches())
    t.join()
    assert len(got) == 1
    last = agg.latest("w1")
    assert last["seq"] == 7 and last["counters"] == {"sealed": 3}
    assert ms.snapshot()["counters"]["fed_shipped_bytes"] > 0
    assert mr.snapshot()["counters"]["fed_fetched_bytes"] > 0


def test_telemetry_frame_without_sink_refused_loudly():
    recv = RowReceiver(n_senders=1)

    def feed():
        s = RowSender("127.0.0.1", recv.port)
        try:
            s.send_telemetry(mk_snap())
            s.close()
        except OSError:
            pass    # receiver died on the refusal first

    t = threading.Thread(target=feed)
    t.start()
    with pytest.raises(ChannelError, match="telemetry_sink"):
        list(recv.batches())
    t.join()


def test_telemetry_frame_size_cap():
    recv = RowReceiver(n_senders=1,
                       telemetry_sink=TelemetryAggregator())

    def feed():
        s = RowSender("127.0.0.1", recv.port)
        try:
            # a hand-rolled oversized -8 frame straight onto the socket
            s._sock.sendall(_LEN.pack(-8) + _LEN.pack(5 << 20))
        except OSError:
            pass

    t = threading.Thread(target=feed)
    t.start()
    with pytest.raises(ChannelError, match="telemetry-frame"):
        list(recv.batches())
    t.join()


# ------------------------------------------------------------ aggregator

def test_aggregator_refuses_bad_snapshots():
    agg = TelemetryAggregator()
    with pytest.raises(ValueError, match="version"):
        agg.accept(mk_snap(v=SNAP_VERSION + 1))
    with pytest.raises(ValueError):
        agg.accept("not a dict")
    snap = mk_snap()
    del snap["host"]
    with pytest.raises(ValueError, match="host"):
        agg.accept(snap)


def test_aggregator_staleness_spool_and_refresh(tmp_path):
    pol = FederationPolicy(period=1.0, stale_after=5.0, keep=4)
    m, ev = MetricsRegistry(), EventLog()
    agg = TelemetryAggregator(pol, metrics=m, events=ev,
                              spool_dir=str(tmp_path))
    agg.accept(mk_snap("w1", seq=1))
    agg.accept(mk_snap("w1", seq=2))
    agg.accept(mk_snap("w2", seq=9))
    assert agg.poll() == []                       # everyone fresh
    assert [s["seq"] for s in agg.snapshots("w1")] == [1, 2]
    assert m.snapshot()["gauges"]["fed_hosts"] == 2

    late = time.monotonic() + 100.0
    assert agg.poll(now=late) == ["w1", "w2"]
    stale_ev = [e for e in ev.recent if e["event"] == "fed_peer"
                and e["state"] == "stale"]
    assert {e["host"] for e in stale_ev} == {"w1", "w2"}
    # the dead peers' last snapshots were spooled, once per episode
    files = sorted(glob.glob(os.path.join(str(tmp_path),
                                          "blackbox-*.json")))
    assert len(files) == 2
    agg.poll(now=late + 1)                        # idempotent re-poll
    assert len(glob.glob(os.path.join(str(tmp_path),
                                      "blackbox-*.json"))) == 2
    with open([f for f in files if "-w1-" in f][0]) as f:
        box = json.load(f)
    assert box["reason"] == "stale" and box["host"] == "w1"
    assert [s["seq"] for s in box["samples"]] == [1, 2]

    # a returning peer flips back to fresh and re-arms the spool
    agg.accept(mk_snap("w1", seq=3))
    fresh_ev = [e for e in ev.recent if e["event"] == "fed_peer"
                and e["state"] == "fresh"]
    assert [e["host"] for e in fresh_ev] == ["w1"]
    assert agg.hosts()["w1"]["fresh"]
    assert not agg.hosts(now=late)["w2"]["fresh"]
    assert agg.poll(now=time.monotonic() + 300)   # re-stales w1
    assert len(glob.glob(os.path.join(str(tmp_path),
                                      "blackbox-w1-*.json"))) == 2
    assert m.snapshot()["counters"]["fed_spooled"] == 3


def test_aggregator_on_death_spools_by_pid(tmp_path):
    agg = TelemetryAggregator(FederationPolicy(stale_after=60.0),
                              spool_dir=str(tmp_path))
    agg.accept(mk_snap("7", seq=4))
    agg.on_death(7)     # plane supervisor adapter: host label "<pid>"
    files = glob.glob(os.path.join(str(tmp_path), "blackbox-7-*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        assert json.load(f)["reason"] == "plane_death"


def test_aggregator_view_availability_and_rates():
    pol = FederationPolicy(period=0.05, stale_after=0.2)
    agg = TelemetryAggregator(pol)
    agg.accept(mk_snap("w2", seq=1))
    time.sleep(0.3)                               # w2 goes stale
    agg.accept(mk_snap("w1", seq=1, t=100.0,
                       nodes=[{"node": "n", "shed": 0, "q_p95_us": 4.0}]))
    agg.accept(mk_snap("w1", seq=2, t=101.0,
                       nodes=[{"node": "n", "shed": 5, "q_p95_us": 9.0}]))
    agg.poll()
    v = agg.view()
    assert v["availability"] == 0.5               # 1 fresh of 2
    assert v["q95_us"] == 9.0                     # fresh hosts only
    assert v["shed_rate"] == 5.0                  # 5 sheds over 1 s
    assert v["stale_seconds"] > 0.2


def test_aggregator_federated_exposition():
    agg = TelemetryAggregator(FederationPolicy())
    agg.accept(mk_snap("w1", seq=3, dead_letters=2,
                       counters={"sealed": 4, 'edge{peer="2"}': 7},
                       gauges={"depth": 1.5},
                       nodes=[{"node": "map", "depth": 2,
                               "q_p95_us": 8.0}]))
    fed = agg.federated()
    assert fed["counters"]['sealed{host="w1"}'] == 4
    # a name with embedded labels gets host appended, not nested
    assert fed["counters"]['edge{peer="2",host="w1"}'] == 7
    assert fed["gauges"]['fed_fresh{host="w1"}'] == 1
    assert fed["gauges"]['fed_dead_letters{host="w1"}'] == 2
    assert fed["gauges"]['fed_node_depth{host="w1",node="map"}'] == 2
    text = agg.render()
    assert 'wf_sealed{host="w1"} 4' in text
    assert 'wf_fed_node_q_p95_us{host="w1",node="map"} 8.0' in text
    # one HELP/TYPE per family, however many hosts
    agg.accept(mk_snap("w2", counters={"sealed": 1}))
    text = agg.render()
    assert text.count("# HELP wf_sealed") == 1
    assert 'wf_sealed{host="w2"} 1' in text


def test_aggregator_state_file_and_wf_top_plane(tmp_path):
    state_path = os.path.join(str(tmp_path), "federation.json")
    pol = FederationPolicy(period=1.0, stale_after=5.0)
    agg = TelemetryAggregator(pol, state_path=state_path)
    agg.accept(mk_snap("w1", seq=6, dataflow="demo",
                       nodes=[{"node": "n", "depth": 2, "rcv_tuples": 40,
                               "shed": 1, "q_p95_us": 3.0}]))
    agg.accept(mk_snap("w2", seq=2, dataflow="demo"))
    agg.poll()
    with open(state_path) as f:
        state = json.load(f)
    assert set(state) >= {"hosts", "latest", "view", "slo_burning"}
    assert state["hosts"]["w1"]["seq"] == 6

    wf_top = _load_script("wf_top")
    text = wf_top.render_plane(state)
    assert "hosts=2 fresh=2" in text
    assert "w1" in text and "demo" in text
    assert "availability=1.00" in text and "slo=ok" in text

    # stale + burning renders STALE / BURN markers
    agg.poll(now=time.monotonic() + 100)
    with open(state_path) as f:
        state = json.load(f)
    text = wf_top.render_plane(state)
    assert "STALE" in text and "fresh=0" in text


# ---------------------------------------------------- label escaping (_esc)

def _parse_series(text):
    """Tiny Prometheus text-format parser: {family: [(labels, value)]},
    undoing the three _esc escapes — the round-trip oracle."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#") or "{" not in line:
            continue
        name, rest = line.split("{", 1)
        labstr, val = rest.rsplit("} ", 1)
        labels, i = {}, 0
        while i < len(labstr):
            j = labstr.index("=", i)
            key = labstr[i:j]
            assert labstr[j + 1] == '"'
            i, buf = j + 2, []
            while True:
                c = labstr[i]
                if c == "\\":
                    buf.append({"\\": "\\", '"': '"', "n": "\n"}[labstr[i + 1]])
                    i += 2
                elif c == '"':
                    i += 1
                    break
                else:
                    buf.append(c)
                    i += 1
            labels[key] = "".join(buf)
            if i < len(labstr) and labstr[i] == ",":
                i += 1
        out.setdefault(name, []).append((labels, val))
    return out


WEIRD = 'a\\b"c\nd'


def test_esc_escapes_all_three():
    assert _esc(WEIRD) == 'a\\\\b\\"c\\nd'
    assert "\n" not in _esc(WEIRD)


def test_esc_roundtrip_through_sample_exposition():
    """A node name with backslash/quote/newline survives render + parse
    — no torn lines, no doubled escapes."""
    sample = {"dataflow": "df", "nodes": [
        {"node": WEIRD, "id": "x", "depth": 3, "hwm": 4, "shed": 0,
         "quarantined": 0}]}
    text = render_sample(sample)
    assert all(ln.startswith(("#", "wf_")) for ln in
               text.splitlines() if ln)          # nothing torn mid-line
    series = _parse_series(text)
    labels, val = series["wf_node_inbox_depth"][0]
    assert labels["node"] == WEIRD and val == "3"


def test_esc_roundtrip_through_federated_exposition():
    """An embedded-label registry name built with _esc survives the
    aggregator's host-label append and the federated render."""
    name = f'odd{{path="{_esc(WEIRD)}"}}'
    agg = TelemetryAggregator(FederationPolicy())
    agg.accept(mk_snap("w1", counters={name: 5}))
    series = _parse_series(agg.render())
    matches = [lv for lv in series.get("wf_odd", ()) ]
    assert len(matches) == 1
    labels, val = matches[0]
    assert labels == {"path": WEIRD, "host": "w1"} and val == "5"


# ------------------------------------------------------------- black box

def test_blackbox_dump_contents_and_budget(tmp_path):
    ev = EventLog()
    ev.emit("epoch", n=1)
    sh = FederationShipper(FederationPolicy(keep=2), host="w1")
    sh.on_sample({"t": 1.0, "seq": 0, "nodes": []})
    sh.on_sample({"t": 2.0, "seq": 1, "nodes": []})
    bb = BlackBox(str(tmp_path), "w1", events=ev, shipper=sh, max_dumps=2)
    path = bb.dump("node_error", failed_node="map", error="RuntimeError")
    assert path and os.path.exists(path)
    with open(path) as f:
        doc = json.load(f)
    assert doc["v"] == SNAP_VERSION and doc["node"] == "w1"
    assert doc["reason"] == "node_error"
    assert doc["failed_node"] == "map" and doc["error"] == "RuntimeError"
    assert [e["event"] for e in doc["events"]][0] == "epoch"
    assert [s["seq"] for s in doc["samples"]] == [0, 1]
    assert any(e["event"] == "blackbox" and e["path"] == path
               for e in ev.recent)
    assert bb.dump("again") is not None           # budget: 2 dumps
    assert bb.dump("past budget") is None
    assert len(glob.glob(os.path.join(str(tmp_path),
                                      "blackbox-w1-*.json"))) == 2
    # no trace_dir: silently declined, never raises
    assert BlackBox(None, "x").dump("whatever") is None


def test_wf_blackbox_renderer(tmp_path):
    wb = _load_script("wf_blackbox")
    doc = {"v": 1, "node": "w1", "t": 100.0, "reason": "node_error",
           "failed_node": "map",
           "events": [{"t": 90.0, "event": "epoch", "n": 3}],
           "spans": [{"t": 95.0, "node": "map", "q_us": 10.0,
                      "svc_us": 20.0}],
           "samples": [{"t": 99.0, "seq": 7,
                        "nodes": [{"depth": 5, "shed": 2}],
                        "dead_letters": 1}]}
    rows = wb.timeline(doc)
    assert [k for _, k, _ in rows] == ["event", "span", "sample"]
    assert [t for t, _, _ in rows] == sorted(t for t, _, _ in rows)
    text = wb.render(doc)
    assert "reason=node_error" in text and "failed_node=map" in text
    assert "seq=7" in text and "max_depth=5" in text
    assert "(empty rings" in wb.render({"node": "x", "reason": "r"})

    p = os.path.join(str(tmp_path), "blackbox-w1-1.json")
    with open(p, "w") as f:
        json.dump(doc, f)
    assert wb.find_dumps(str(tmp_path)) == [p]
    assert wb.find_dumps(p) == [p]
    assert wb.main([p]) == 0
    assert wb.main([str(tmp_path), "--list"]) == 0
    assert wb.main([os.path.join(str(tmp_path), "empty")]) == 2


# ----------------------------------------------------- engine integration

class _Src(SourceNode):
    def __init__(self, n=6, name="src"):
        super().__init__(name)
        self.n = n

    def generate(self):
        for i in range(self.n):
            self.emit(np.arange(4, dtype=np.int64) + i)


class _Snk(Node):
    def __init__(self, name="snk", boom=False):
        super().__init__(name)
        self.boom = boom
        self.got = []

    def svc(self, batch, channel=0):
        if self.boom:
            raise RuntimeError("injected sink fault")
        self.got.append(batch.copy())


def _fed_linear(tmp, boom=False, **fed_kw):
    df = Dataflow("fedgraph", trace_dir=str(tmp), metrics=True,
                  sample_period=0.02,
                  federate=FederationPolicy(host="h1", period=0.02,
                                            **fed_kw))
    s = df.add(_Src())
    k = df.add(_Snk(boom=boom))
    df.connect(s, k)
    return df, k


def test_engine_builds_shipper_and_blackbox(tmp_path):
    df, k = _fed_linear(tmp_path)
    df.run_and_wait_end()
    assert df.federation is not None and df.federation.host == "h1"
    assert len(df.federation.recent) >= 1         # rode the sampler
    assert df._blackbox is not None
    assert len(k.got) == 6
    # no plane bound: nothing shipped, nothing dumped
    assert not glob.glob(os.path.join(str(tmp_path), "blackbox-*"))


def test_engine_blackbox_off_by_policy(tmp_path):
    df, _ = _fed_linear(tmp_path, blackbox=False)
    df.run_and_wait_end()
    assert df.federation is not None and df._blackbox is None


def test_node_error_dumps_blackbox(tmp_path):
    df, _ = _fed_linear(tmp_path, boom=True)
    df.run()
    with pytest.raises(RuntimeError, match="injected sink fault"):
        df.wait(timeout=120)
    files = glob.glob(os.path.join(str(tmp_path), "blackbox-*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        doc = json.load(f)
    assert doc["reason"] == "node_error"
    assert doc["failed_node"] == "snk"
    assert doc["error"] == "RuntimeError"
    assert any(e["event"] == "node_error" for e in doc["events"])
    assert any(e["event"] == "blackbox" for e in df.events.recent)


def test_node_error_blackbox_built_before_threads(tmp_path):
    """The port builds the shipper and the black box BEFORE the node
    threads start (the reference builds them after, so a node failing on
    its first batch can find no black box and dump nothing): twenty runs
    whose sink fails on its first batch each dump exactly one black box."""
    for i in range(20):
        run_dir = tmp_path / f"run{i}"
        run_dir.mkdir()
        df, _ = _fed_linear(run_dir, boom=True)
        df.run()
        with pytest.raises(RuntimeError, match="injected sink fault"):
            df.wait(timeout=120)
        files = glob.glob(os.path.join(str(run_dir), "blackbox-*.json"))
        assert len(files) == 1, f"run {i}: {files}"


def test_local_slo_evaluates_on_the_sampler(tmp_path):
    slo = SloPolicy([SloObjective("dl", "dead_letters", bad_above=1e9)])
    df, _ = _fed_linear(tmp_path, slo=slo)
    df.run_and_wait_end()
    g = df.metrics.snapshot()["gauges"]
    assert 'slo_burn_fast{objective="dl"}' in g   # evaluator ran
    assert g["slo_burn_max"] == 0.0


# -------------------------------------------------- control-plane bridge

def test_rescale_up_slo_burn_rule():
    from windflow_tpu_torch.control import Rescale
    with pytest.raises(ValueError, match="up_slo_burn"):
        Rescale("kf", max_workers=4, up_slo_burn=0)
    r = Rescale("kf", max_workers=4, up_slo_burn=1.0, hysteresis=1,
                cooldown=0.0)
    assert r.observe((0, 0.0, 0.0, 2.0), now=1.0) == 1
    assert r.observe((0, 0.0, 0.0, 0.5), now=2.0) == 0
    assert r.observe((0, 0.0), now=3.0) == 0      # pre-SLO tuple form
    assert r.observe((0, 0.0, 0.0), now=4.0) == 0  # pre-burn tuple form
    assert 1.0 in r._key() and "up_slo_burn=1.0" in repr(r)
    twin = Rescale("kf", max_workers=4, up_slo_burn=1.0, hysteresis=1,
                   cooldown=0.0)
    assert r._key() == twin._key()
    assert r._key() != Rescale("kf", max_workers=4, up_slo_burn=2.0,
                               hysteresis=1, cooldown=0.0)._key()


# --------------------------------------------------------- file rotation

class _StubDF:
    def __init__(self, trace_dir):
        self.trace_dir = trace_dir
        self.name = "stub"
        self.nodes = []
        self.metrics = None
        self.events = None
        self.dead_letters = []
        self._inboxes = {}


def test_sampler_rotation_keeps_n_and_loses_no_line(tmp_path):
    with pytest.raises(ValueError):
        Sampler(_StubDF(None), 0.01, max_bytes=0)
    with pytest.raises(ValueError):
        Sampler(_StubDF(None), 0.01, keep=0)
    s = Sampler(_StubDF(str(tmp_path)), 0.01, max_bytes=256, keep=2)
    path = os.path.join(str(tmp_path), "metrics.jsonl")
    s._path = path
    f = open(path, "a")
    for _ in range(60):
        f = s._write_sample(f)
    f.close()
    assert os.path.exists(path + ".1") and os.path.exists(path + ".2")
    assert not os.path.exists(path + ".3")        # keep=2 bound
    assert os.path.getsize(path) <= 256
    seqs = []
    for p in (path + ".2", path + ".1", path):
        with open(p) as fh:
            for line in fh:
                seqs.append(json.loads(line)["seq"])
    # rotation is between whole lines: the kept tail is contiguous
    assert seqs == list(range(seqs[0], 60))


def test_wf_top_read_samples_follows_the_roll(tmp_path):
    wf_top = _load_script("wf_top")
    path = os.path.join(str(tmp_path), "metrics.jsonl")

    def put(seqs, p=path):
        with open(p, "a") as f:
            for s in seqs:
                f.write(json.dumps({"t": float(s), "seq": s}) + "\n")

    put(range(5))
    samples, off = wf_top.read_samples(path, 0)
    assert [s["seq"] for s in samples] == [0, 1, 2, 3, 4]
    put([5, 6])                                   # appended after read
    os.replace(path, path + ".1")                 # ...then the roll
    put([7, 8])
    samples, off2 = wf_top.read_samples(path, off)
    # the unread tail of the rolled file, then the fresh file's head
    assert [s["seq"] for s in samples] == [5, 6, 7, 8]
    assert wf_top.read_samples(path, off2)[0] == []


def test_eventlog_rotation_preserves_every_event(tmp_path):
    with pytest.raises(ValueError):
        EventLog(max_bytes=0)
    path = os.path.join(str(tmp_path), "events.jsonl")
    log = EventLog(path, max_bytes=200)
    for i in range(12):
        log.emit("epoch", n=i)
    log.close()
    assert os.path.exists(path + ".1")
    assert os.path.getsize(path) <= 200
    ns = []
    for p in (path + ".1", path):
        with open(p) as f:
            for line in f:
                rec = json.loads(line)            # whole records only
                ns.append(rec["n"])
    # .1 holds one rolled generation; live + .1 cover a contiguous tail
    # through the newest event, and the ring still holds everything
    assert ns == list(range(ns[0], 12))
    assert [e["n"] for e in log.recent] == list(range(12))
    log.emit("epoch", n=99)                       # post-close: ring only
    assert log.recent[-1]["n"] == 99
    assert 99 not in [json.loads(l)["n"] for l in open(path)]


# -------------------------------------------------- the 3-process demo

_WORKER = """\
import sys, time
from windflow_tpu_torch.parallel.channel import RowSender
port, label = int(sys.argv[1]), sys.argv[2]
s = RowSender("127.0.0.1", port, connect_deadline=30)
seq = 0
end = time.time() + 60
while time.time() < end:
    s.send_telemetry({"v": 1, "host": label, "t": time.time(),
                      "seq": seq, "dataflow": "demo",
                      "nodes": [{"node": "n0", "depth": seq, "shed": 0}],
                      "dead_letters": 0, "counters": {"beats": seq},
                      "gauges": {}})
    seq += 1
    time.sleep(0.05)
"""


def test_plane_demo_kill_one_worker_burns_availability(tmp_path):
    """The acceptance demo: two worker processes ship
    snapshots over real row-plane links into one aggregator; kill -9
    one worker => the availability objective burns, the aggregator
    holds the victim's black box, the survivor stays fresh."""
    slo = SloPolicy([SloObjective("availability", "availability",
                                  bad_below=0.9, budget=0.2,
                                  fast_window=0.5, slow_window=3.0)])
    pol = FederationPolicy(period=0.05, stale_after=0.4, slo=slo)
    spool = os.path.join(str(tmp_path), "spool")
    m, ev = MetricsRegistry(), EventLog()
    agg = TelemetryAggregator(pol, metrics=m, events=ev, spool_dir=spool)

    recvs = [RowReceiver(n_senders=1, telemetry_sink=agg)
             for _ in range(2)]
    threads = []
    for r in recvs:
        def drain(r=r):
            try:
                for _ in r.batches():
                    pass
            except Exception:   # noqa: BLE001 — a killed peer tears its
                pass            # own link; the demo asserts via the agg
        t = threading.Thread(target=drain, daemon=True)
        t.start()
        threads.append(t)

    script = os.path.join(str(tmp_path), "worker.py")
    with open(script, "w") as f:
        f.write(_WORKER)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("WF_LOG_DIR", None)
    procs = [subprocess.Popen(
        [sys.executable, script, str(r.port), label], cwd=REPO, env=env)
        for r, label in zip(recvs, ("w1", "w2"))]
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            agg.poll()
            h = agg.hosts()
            if {"w1", "w2"} <= set(h) and all(
                    v["fresh"] and v["seq"] >= 2 for v in h.values()):
                break
            time.sleep(0.05)
        else:
            pytest.fail(f"workers never federated: {agg.hosts()}")

        procs[0].kill()                           # SIGKILL w1
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            agg.poll()
            if "availability" in (agg.slo.burning()):
                break
            time.sleep(0.05)
        else:
            pytest.fail(f"availability never burned: view={agg.view()} "
                        f"hosts={agg.hosts()}")

        h = agg.hosts()
        assert not h["w1"]["fresh"], "victim still fresh"
        assert h["w2"]["fresh"], "survivor went stale"
        burns = [e for e in ev.recent if e["event"] == "slo_burn"]
        assert burns and burns[0]["objective"] == "availability"
        assert burns[0]["state"] == "burn" and burns[0]["scope"] == "plane"
        # the victim's last snapshots survived it at the aggregator
        boxes = glob.glob(os.path.join(spool, "blackbox-w1-*.json"))
        assert len(boxes) == 1
        with open(boxes[0]) as f:
            box = json.load(f)
        assert box["reason"] == "stale"
        assert box["samples"] and all(s["host"] == "w1"
                                      for s in box["samples"])
        seqs = [s["seq"] for s in box["samples"]]
        assert seqs == sorted(seqs) and seqs[-1] >= 1
        assert not glob.glob(os.path.join(spool, "blackbox-w2-*"))

        wf_top = _load_script("wf_top")
        text = wf_top.render_plane(agg.state())
        assert "STALE" in text and "slo=BURN[availability]" in text
        assert m.snapshot()["gauges"]["slo_burn_max"] >= 1.0
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
        for r in recvs:
            r.close()
        for t in threads:
            t.join(timeout=10)
