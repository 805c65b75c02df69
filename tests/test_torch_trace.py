"""Span tracing (windflow_tpu_torch/obs/trace.py) and the text exposition
(obs/expo.py) against the JAX package's: the same linear graph through
both packages leaves spans of the same kinds with the same field names
and the same hop chains; device launches of a KeyFarmGPU under recovery=
become child spans of its workers' hops; ``scripts/wf_trace.py`` reads the
port's trace directory; ``expo`` renders the same text as JAX's for the
same registry and sample; and ``federate=`` still refused."""

import importlib
import json
import os
import subprocess
import sys
import types
import warnings

import numpy as np
import pytest

from obs_schema import validate_sample, validate_span

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_ambient_obs_env(monkeypatch):
    """An ambient WF_LOG_DIR would turn ring-only graphs into writers."""
    monkeypatch.delenv("WF_LOG_DIR", raising=False)
    monkeypatch.delenv("WF_SAMPLE_PERIOD", raising=False)


def package(name):
    def mod(m):
        return importlib.import_module(f"{name}.{m}")
    tr, node = mod("obs.trace"), mod("runtime.node")
    return types.SimpleNamespace(
        name=name, trace=tr, Tracer=tr.Tracer, TracePolicy=tr.TracePolicy,
        Stamped=tr.Stamped, SpanCtx=tr.SpanCtx, as_policy=tr.as_policy,
        Dataflow=mod("runtime.engine").Dataflow, Node=node.Node,
        SourceNode=node.SourceNode, profile=mod("utils.profile"),
        expo=mod("obs.expo"), registry=mod("obs.registry"),
        EventLog=mod("obs").EventLog, Sampler=mod("obs.sampler").Sampler,
        MultiPipe=mod("api").MultiPipe,
        union_multipipes=mod("api").union_multipipes,
        Schema=mod("core.tuples").Schema, Map=mod("patterns.basic").Map,
        Sink=mod("patterns.basic").Sink, Source=mod("patterns.basic").Source,
        RecoveryPolicy=mod("recovery.policy").RecoveryPolicy)


JX = package("windflow_tpu")
PT = package("windflow_tpu_torch")


def _linear_graph(W, n):
    """Source -> a host stage that brackets a profile span, as the device
    ship phases do -> sink, built from package ``W``'s node classes."""
    class Src(W.SourceNode):
        def generate(self):
            for i in range(n):
                self.emit(np.arange(4, dtype=np.int64) + i)

    class Mid(W.Node):
        def svc(self, batch, channel=0):
            with W.profile.span("dispatch"):
                pass
            self.emit(batch * 2)

    class Snk(W.Node):
        def __init__(self, name="snk"):
            super().__init__(name)
            self.got = []

        def svc(self, batch, channel=0):
            self.got.append(batch.copy())

    return Src("src"), Mid("mid"), Snk()


def _run_linear(W, trace=None, trace_dir=None, metrics=None, n=6):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # ring-only runs warn WF213
        df = W.Dataflow("tr", trace_dir=trace_dir, metrics=metrics,
                        trace=trace)
    s, m, k = (df.add(x) for x in _linear_graph(W, n))
    df.connect(s, m)
    df.connect(m, k)
    df.run_and_wait_end()
    return df, k


def _by_span(records):
    return {r["span"]: r for r in records}


def _shape(records):
    """What must agree between the packages: each record's kind and field
    names, and each trace's hop chain in completion order."""
    fields = sorted({(r["kind"], tuple(sorted(r))) for r in records})
    chains = {}
    for r in records:
        if r["kind"] == "hop":
            chains.setdefault(r["trace"], []).append(r)
    hops = sorted(tuple(r["node"] for r in sorted(c, key=lambda r:
                                                  r["end_us"]))
                  for c in chains.values())
    launches = sorted((r["phase"], _by_span(records)[r["parent"]]["node"])
                      for r in records if r["kind"] == "launch")
    return fields, hops, launches


# ---------------------------------------------------------- knob contract

def test_trace_policy_matches_jax():
    for bad in (dict(sample_rate=0.0), dict(sample_rate=1.5),
                dict(max_spans=0), dict(ring=0)):
        with pytest.raises(ValueError):
            PT.TracePolicy(**bad)
    for arg in (True, 0.5, 0.01, 1.0):
        mine, ref = PT.as_policy(arg), JX.as_policy(arg)
        assert ([getattr(mine, s) for s in mine.__slots__]
                == [getattr(ref, s) for s in ref.__slots__])
    pol = PT.TracePolicy(sample_rate=0.5)
    assert PT.as_policy(pol) is pol
    assert PT.TracePolicy(sample_rate=0.01).sample_every == 100


def test_trace_falsy_means_off():
    for falsy in (None, 0, 0.0, False):
        df = PT.Dataflow("off", trace=falsy)
        assert df.tracer is None and df.trace is None


def test_ring_only_warns_wf213():
    with pytest.warns(UserWarning, match=r"WF213.*trace_dir"):
        df = PT.Dataflow("ringy", trace=0.5)
    df.tracer.close()


@pytest.mark.parametrize("owner", ["MultiPipe", "Dataflow"])
def test_federate_still_refused(owner):
    """``federate=`` is no longer refused (the name is kept from when it
    was): since the port carries the federation tier, a traced graph under
    federate= builds the shipper and the black box and gives JAX's
    output."""
    outs = []
    for W in (JX, PT):
        fed = importlib.import_module(
            f"{W.name}.obs.federation").FederationPolicy(host="h",
                                                         period=0.02)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # ring-only runs warn WF213
            if owner == "MultiPipe":
                bfc = importlib.import_module(
                    f"{W.name}.core.tuples").batch_from_columns
                schema = W.Schema(value=np.int64)
                ids = np.arange(12)
                got = []
                pipe = (W.MultiPipe("fed", federate=fed, metrics=True,
                                    trace=0.5)
                        .add_source(W.Source(batches=iter([bfc(
                            schema, key=ids % 3, id=ids, ts=ids,
                            value=ids)]), schema=schema))
                        .add_sink(W.Sink(lambda r: got.append(r.copy())
                                         if r is not None and len(r)
                                         else None, vectorized=True)))
                pipe.run_and_wait_end()
                df, out = pipe._df, np.concatenate(got).tobytes()
            else:
                df = W.Dataflow("fed", federate=fed, metrics=True,
                                trace=0.5)
                s, m, k = (df.add(x) for x in _linear_graph(W, 6))
                df.connect(s, m)
                df.connect(m, k)
                df.run_and_wait_end()
                out = np.concatenate(k.got).tobytes()
        assert df.federation is not None and df.federation.host == "h"
        assert df._blackbox is not None
        outs.append(out)
    assert outs[0] == outs[1]


def test_trace_off_results_byte_identical():
    _df0, k0 = _run_linear(PT, trace=None)
    _df1, k1 = _run_linear(PT, trace=PT.TracePolicy(sample_rate=1.0))
    assert (np.concatenate(k0.got).tobytes()
            == np.concatenate(k1.got).tobytes())


# -------------------------------------------------------------- stitching

def test_linear_graph_spans_match_jax():
    """The same graph through both packages: the same span kinds with the
    same field names, the same per-trace hop chains and launch children."""
    shapes = []
    for W in (JX, PT):
        df, k = _run_linear(W, trace=W.TracePolicy(sample_rate=1.0), n=5)
        shapes.append(_shape(list(df.tracer.recent)))
        assert sum(len(b) for b in k.got) == 20
    assert shapes[1] == shapes[0]
    fields, hops, launches = shapes[1]
    assert {kind for kind, _ in fields} == {"hop", "launch"}
    assert hops == [("tr_00_src", "tr_01_mid", "tr_02_snk")] * 5
    assert launches == [("dispatch", "tr_01_mid")] * 5


def test_span_parents_stitch_source_to_sink():
    df, _k = _run_linear(PT, trace=PT.TracePolicy(sample_rate=1.0), n=5)
    recs = list(df.tracer.recent)
    spans = _by_span(recs)
    traces = {}
    for r in recs:
        if r["kind"] == "hop":
            traces.setdefault(r["trace"], []).append(r)
    assert len(traces) == 5
    for recs_t in traces.values():
        chain = sorted(recs_t, key=lambda r: r["end_us"])
        assert chain[0]["parent"] is None
        for up, down in zip(chain, chain[1:]):
            assert down["parent"] == up["span"]
    for lr in (r for r in recs if r["kind"] == "launch"):
        assert spans[lr["parent"]]["trace"] == lr["trace"]


def test_sampling_fraction_respected():
    df, _k = _run_linear(PT, trace=PT.TracePolicy(sample_rate=0.5), n=8)
    assert len({r["trace"] for r in df.tracer.recent
                if r["kind"] == "hop"}) == 4


def test_comb_fusion_propagates_context(tmp_path):
    got = []

    def gen(sh):
        for i in range(4):
            sh.push(key=0, id=i, ts=i, value=i)

    p = (PT.MultiPipe("fuse", trace=PT.TracePolicy(sample_rate=1.0),
                      trace_dir=str(tmp_path))
         .add_source(PT.Source(gen, PT.Schema(value=np.int64), name="src"))
         .chain(PT.Map(lambda b: None, vectorized=True))
         .add_sink(PT.Sink(lambda b: got.append(b), vectorized=True)))
    p.run_and_wait_end()
    hops = [r for r in p._df.tracer.recent if r["kind"] == "hop"]
    spans = _by_span(hops)
    assert [r for r in hops if r["parent"] is None]
    non_roots = [r for r in hops if r["parent"] is not None]
    assert non_roots
    for r in non_roots:
        assert spans[r["parent"]]["trace"] == r["trace"]


def test_supervised_loop_records_spans(tmp_path):
    """recovery= + trace=: hops through the supervised receive loop and
    the checkpoint commits as ctrl spans."""
    got = []

    def gen(sh):
        for i in range(8):
            sh.push(key=i % 2, id=i, ts=i, value=i)
            sh.flush()

    p = (PT.MultiPipe("sup", trace=PT.TracePolicy(sample_rate=1.0),
                      trace_dir=str(tmp_path), metrics=True,
                      recovery=PT.RecoveryPolicy(
                          epoch_batches=2, checkpoint_dir=str(tmp_path)))
         .add_source(PT.Source(gen, PT.Schema(value=np.int64), name="src"))
         .add(PT.Map(lambda b: None, vectorized=True))
         .add_sink(PT.Sink(lambda b: got.append(b), vectorized=True)))
    p.run_and_wait_end()
    recs = list(p._df.tracer.recent)
    hops = [r for r in recs if r["kind"] == "hop"]
    assert any(r["parent"] is not None for r in hops)
    assert any(r["kind"] == "ctrl" and r["name"] == "checkpoint"
               for r in recs)
    assert sum(len(b) for b in got if b is not None) == 8


def _keyed_batches(n_batches=24, rows=64, n_keys=8, seed=3):
    rng = np.random.default_rng(seed)
    dt = PT.Schema(value=np.int64).dtype()
    ctr = np.zeros(n_keys, dtype=np.int64)
    for _ in range(n_batches):
        b = np.zeros(rows, dtype=dt)
        keys = rng.integers(0, n_keys, rows)
        b["key"] = keys
        b["value"] = rng.integers(0, 100, rows)
        for i, k in enumerate(keys.tolist()):
            b["id"][i] = ctr[k]
            ctr[k] += 1
        b["ts"] = b["id"]
        yield b


def _device_run(W, tmp_path):
    """KeyFarm{TPU,GPU} under recovery= with every batch traced."""
    if W is PT:
        from windflow_tpu_torch import KeyFarmGPU, Reducer
        farm = KeyFarmGPU(Reducer("sum", "value"), 8, 4, pardegree=2,
                          batch_len=8, name="kf", device="cpu")
    else:
        from windflow_tpu.ops.functions import Reducer
        from windflow_tpu.patterns.win_seq_tpu import KeyFarmTPU
        farm = KeyFarmTPU(Reducer("sum", "value"), 8, 4, pardegree=2,
                          batch_len=8, name="kf")
    out = []

    def sink(r):
        if r is not None:
            out.append((int(r["key"]), int(r["id"]), int(r["value"])))
    sink_pat = W.Sink(sink, name="sink")
    sink_pat.recoverable = True
    p = W.MultiPipe("dev", trace=W.TracePolicy(sample_rate=1.0),
                    trace_dir=str(tmp_path), metrics=True,
                    recovery=W.RecoveryPolicy(epoch_batches=4))
    p.add_source(W.Source(batches=lambda i: _keyed_batches(), name="src"))
    p.add(farm)
    p.add_sink(sink_pat)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # int32-accumulation advisory
        p.run_and_wait_end(timeout=300)
    return p._df.tracer, out


def test_device_launches_are_children_of_worker_hops(tmp_path):
    """Under recovery= the native core ships in its worker's svc thread,
    so each launch phase (device_put, dispatch, harvest_wait) becomes a
    child span of a kf worker's hop, as in JAX's KeyFarmTPU run."""
    phases = {}
    for W in (JX, PT):
        tracer, out = _device_run(W, tmp_path / W.name)
        recs = list(tracer.recent)
        spans = _by_span(recs)
        kinds = {r["kind"] for r in recs}
        assert {"hop", "launch", "ctrl"} <= kinds, (W.name, kinds)
        nodes = {r["node"] for r in recs if r["kind"] == "hop"}
        assert any("src" in n for n in nodes)
        assert any("sink" in n for n in nodes)
        assert sum(".kf." in n or "_kf." in n for n in nodes) >= 2, nodes
        launch = [r for r in recs if r["kind"] == "launch"]
        for lr in launch:
            parent = spans.get(lr["parent"])
            assert parent is not None and parent["kind"] == "hop"
            assert lr["trace"] == parent["trace"]
        phases[W.name] = {(lr["phase"], spans[lr["parent"]]["node"]
                           .split("_", 2)[2].split(".")[0])
                          for lr in launch}
        phases[W.name, "out"] = out
    assert ("dispatch", "kf") in phases["windflow_tpu_torch"]
    port_phases = {p for p, _ in phases["windflow_tpu_torch"]}
    assert {"device_put", "dispatch", "harvest_wait"} <= port_phases
    assert (sorted(phases["windflow_tpu_torch", "out"])
            == sorted(phases["windflow_tpu", "out"]))


# ------------------------------------------------- sampler / file sinks

def test_sampler_carries_latency_percentiles():
    reg = PT.registry.MetricsRegistry()
    df, _k = _run_linear(PT, trace=PT.TracePolicy(sample_rate=1.0),
                         metrics=reg)
    sample = PT.Sampler(df, 1.0).sample()
    validate_sample(sample, "sample")
    mid = {n["node"]: n for n in sample["nodes"]}["mid"]
    for field in ("q_p50_us", "q_p95_us", "q_p99_us", "svc_p50_us",
                  "svc_p95_us", "svc_p99_us"):
        assert mid[field] >= 0
    untraced, _ = _run_linear(PT, metrics=PT.registry.MetricsRegistry())
    for n in PT.Sampler(untraced, 1.0).sample()["nodes"]:
        assert "q_p95_us" not in n and "svc_p95_us" not in n


def test_trace_jsonl_schema_and_bound(tmp_path):
    df, _k = _run_linear(PT, trace=PT.TracePolicy(sample_rate=1.0),
                         trace_dir=str(tmp_path), n=6)
    n = 0
    with open(tmp_path / "trace.jsonl") as f:
        for i, line in enumerate(f, 1):
            validate_span(json.loads(line), f"trace.jsonl:{i}")
            n += 1
    assert n == df.tracer.written and n > 0


def test_max_spans_drops_and_counts(tmp_path):
    from time import perf_counter_ns
    ev = PT.EventLog()
    reg = PT.registry.MetricsRegistry()
    tracer = PT.Tracer("cap", PT.TracePolicy(sample_rate=1.0, max_spans=2),
                       trace_dir=str(tmp_path), metrics=reg, events=ev)
    ctx = PT.SpanCtx(1, perf_counter_ns(), tracer)
    for i in range(5):
        tracer.record_hop(ctx, "n", 100 + i, None, 1000, 1000, 1)
    tracer.close()
    assert (tracer.written, tracer.dropped, tracer.spans) == (2, 3, 5)
    assert [e["event"] for e in ev.recent].count("trace_drop") == 1
    assert reg.counter("trace_spans_dropped").value == 3


def test_union_trace_policies_must_agree(tmp_path):
    def leg(name, trace):
        p = PT.MultiPipe(name, trace=trace, trace_dir=str(tmp_path))
        p.add_source(PT.Source(lambda sh: None, PT.Schema(value=np.int64)))
        return p
    pol = PT.TracePolicy(sample_rate=0.5)
    assert PT.union_multipipes(leg("a", pol), leg("b", None),
                               name="u").trace is pol
    with pytest.raises(ValueError, match="conflicting trace"):
        PT.union_multipipes(leg("c", pol),
                            leg("d", PT.TracePolicy(sample_rate=0.25)),
                            name="u2")


# -------------------------------------------------------------- wf_trace

def _wf_trace_json(trace_dir):
    r = subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                     "wf_trace.py"),
                        str(trace_dir), "--json"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout)


def test_wf_trace_reads_the_port_trace_dir(tmp_path):
    """The unchanged scripts/wf_trace.py summarises the port's
    trace.jsonl exactly as it does JAX's for the same graph."""
    reps = []
    for W in (JX, PT):
        d = tmp_path / W.name
        _run_linear(W, trace=W.TracePolicy(sample_rate=1.0),
                    trace_dir=str(d), n=6)
        reps.append(_wf_trace_json(d))
    for rep in reps:
        assert rep["n_traces"] == 6
        assert [s["node"] for s in rep["stages"]] == \
            ["tr_00_src", "tr_01_mid", "tr_02_snk"]
        assert "dispatch" in rep["launch_phases"]
    assert ({k: v for k, v in reps[1].items() if k in ("n_spans", "n_hops",
                                                       "n_traces")}
            == {k: v for k, v in reps[0].items() if k in ("n_spans",
                                                         "n_hops",
                                                         "n_traces")})


# ------------------------------------------------------------------ expo

def _registry(W):
    reg = W.registry.MetricsRegistry()
    for node in ("a", "b"):
        h = reg.histogram(f'trace_service_seconds{{node="{node}"}}',
                          (0.1, 1.0))
        h.observe(0.05)
        h.observe(0.5 if node == "a" else 2.0)
    reg.counter("wire_bytes_sent").inc(5)
    reg.gauge("ctl_width_kf").set(4)
    return reg


def test_expo_render_registry_equals_jax():
    txt = PT.expo.render_registry(_registry(PT))
    assert txt == JX.expo.render_registry(_registry(JX))
    assert txt.count("# TYPE wf_trace_service_seconds histogram") == 1
    assert 'wf_trace_service_seconds_bucket{node="a",le="0.1"} 1' in txt
    assert "wf_wire_bytes_sent 5" in txt
    snap = _registry(PT).snapshot()
    assert (PT.expo.render_registry(snap)
            == JX.expo.render_registry(_registry(JX).snapshot()))


def test_expo_render_sample_equals_jax():
    sample = {"dataflow": "d", "dead_letters": 2,
              "nodes": [{"node": "m", "id": "d_01_m", "depth": 3,
                         "hwm": 5, "shed": 1, "quarantined": 0,
                         "q_p95_us": 120.5, "svc_p95_us": 30.0}],
              "counters": {"c": 1}, "gauges": {"g": 2.5},
              "histograms": {}}
    txt = PT.expo.render_sample(sample)
    assert txt == JX.expo.render_sample(sample)
    assert 'wf_node_queue_wait_p95_us{dataflow="d",node="m"} 120.5' in txt


# ------------------------------------------------------- tracer hygiene

def test_stamped_copy_detaches_batch():
    from time import perf_counter_ns
    batch = np.arange(4, dtype=np.int64)
    st = PT.Stamped(batch, PT.SpanCtx(1, perf_counter_ns(), None), None,
                    perf_counter_ns())
    dup = st.copy()
    batch[:] = -1
    np.testing.assert_array_equal(dup.batch, np.arange(4))


def test_span_ids_stay_js_safe():
    for _ in range(64):
        assert 0 < PT.trace._new_id() < 2 ** 53


def test_recorder_uninstalls_with_last_tracer():
    tm, profile = PT.trace, PT.profile
    base = tm._RECORDER_REFS
    t1 = PT.Tracer("a", PT.TracePolicy(sample_rate=1.0))
    t2 = PT.Tracer("b", PT.TracePolicy(sample_rate=1.0))
    assert tm._RECORDER_REFS == base + 2 and profile._RECORDER is not None
    t1.close()
    t1.close()
    assert tm._RECORDER_REFS == base + 1
    t2.close()
    assert tm._RECORDER_REFS == base
    if base == 0:
        assert profile._RECORDER is None


def test_unclosed_tracer_releases_recorder_on_gc():
    import gc
    base = PT.trace._RECORDER_REFS
    t = PT.Tracer("leaky", PT.TracePolicy(sample_rate=1.0))
    assert PT.trace._RECORDER_REFS == base + 1
    del t
    gc.collect()
    assert PT.trace._RECORDER_REFS == base
