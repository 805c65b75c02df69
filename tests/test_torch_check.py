"""The static checker (windflow_tpu_torch/check/) against the JAX package's
(windflow_tpu/check/): the same misconfiguration corpus as
tests/test_check.py, built once through each package, must report the same
set of WF### codes in both, and every minimally fixed twin must report none.
Then the device cases on the port's own patterns (WF202, WF203, WF210 with
the native state ABI present and absent, WF215), the ``check=`` knob (warn,
error before any thread starts, union strictness, event mirroring), the
effect analyzer's results against JAX's, and the four apps' lint hooks.

The corpus covers the whole catalog: the wire, plane and federation codes
(WF205, 206, 214, 216, 217, 220-224) build the port's ``WireConfig``,
``PlanePolicy``, ``PlaneSpec`` and ``federate=`` as JAX's corpus builds
its own.

WF303-WF305 (the effect analyzer) are compared for equality with JAX only:
on Python 3.12 the reference's call walker finds no call in ``time.time()``
and the like, so neither package reports them there (a fault of the
reference, ROADMAP.md Queue 3); the port keeps the reference's results.
"""

import importlib
import importlib.util
import os
import textwrap
import threading
import time
import types
import warnings

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the effect analyzer's codes: equality with JAX only (module docstring)
EFFECTS = ("WF303", "WF304", "WF305")


@pytest.fixture(autouse=True)
def _no_ambient_obs_env(monkeypatch):
    """The corpus pins exact diagnostic sets: an ambient WF_LOG_DIR would
    silence WF207, an ambient WF_SAMPLE_PERIOD would plant it everywhere."""
    monkeypatch.delenv("WF_LOG_DIR", raising=False)
    monkeypatch.delenv("WF_SAMPLE_PERIOD", raising=False)


def package(name):
    """The names the corpus builds with, taken from one package."""
    def mod(m):
        return importlib.import_module(f"{name}.{m}")
    api, check, control = mod("api"), mod("check"), mod("control")
    basic = mod("patterns.basic")
    return types.SimpleNamespace(
        name=name, MultiPipe=api.MultiPipe,
        union_multipipes=api.union_multipipes, validate=check.validate,
        CheckError=check.CheckError, CheckWarning=check.CheckWarning,
        CATALOG=mod("check.diagnostics").CATALOG,
        Admission=control.Admission, ControlPolicy=control.ControlPolicy,
        Rescale=control.Rescale, Reducer=mod("ops.functions").Reducer,
        KeyFarm=mod("patterns.key_farm").KeyFarm,
        Schema=mod("core.tuples").Schema,
        WindowSpec=mod("core.windows").WindowSpec,
        WinType=mod("core.windows").WinType, Map=basic.Map,
        Sink=basic.Sink, Source=basic.Source,
        AccumulatorNode=basic._AccumulatorNode, MapNode=basic._MapNode,
        PaneFarm=mod("patterns.pane_farm").PaneFarm,
        WinSeq=mod("patterns.win_seq").WinSeq,
        WinSeqNode=mod("patterns.win_seq").WinSeqNode,
        RecoveryPolicy=mod("recovery.policy").RecoveryPolicy,
        StandardEmitter=mod("runtime.emitters").StandardEmitter,
        default_routing=mod("runtime.emitters").default_routing,
        Dataflow=mod("runtime.engine").Dataflow,
        OverloadPolicy=mod("runtime.overload").OverloadPolicy,
        make_comb=mod("runtime.comb").make_comb,
        TracePolicy=mod("obs.trace").TracePolicy,
        node_stats_name=mod("utils.tracing").node_stats_name,
        WireConfig=mod("parallel.channel").WireConfig,
        PlanePolicy=mod("parallel.plane").PlanePolicy,
        FederationPolicy=mod("obs.federation").FederationPolicy,
        HostSpec=mod("check.plane").HostSpec,
        PlaneSpec=mod("check.plane").PlaneSpec)


JX = package("windflow_tpu")
PT = package("windflow_tpu_torch")


def _src(shipper):
    return None


def _red(key, gwid, rows):
    return {"value": rows["value"].sum()}


def _win_fields():
    return {"value": np.int64}


def _schema(W):
    return W.Schema(value=np.int64)


def _sink(W):
    return W.Sink(lambda b: None, vectorized=True)


def _pipe(W, *patterns, **kw):
    p = W.MultiPipe(kw.pop("name", "chk"), **kw)
    p.add_source(W.Source(_src, _schema(W)))
    for pat in patterns:
        p.add(pat)
    p.add_sink(_sink(W))
    return p


# ------------------------------------------------------- stub cores

class NativeResidentCore:
    """Stub matching the WF215 duck-type probe (class name + missing
    has_state_abi); without ``abi`` it models a library before the ABI."""

    def __init__(self, W, abi=False):
        self.spec = W.WindowSpec(4, 2, W.WinType.CB)
        if abi:
            self.has_state_abi = True


class _StubAsyncCore:
    """Async device core shape: process_batches + max_delay_s."""
    max_delay_s = None

    def __init__(self, W):
        self.spec = W.WindowSpec(4, 2, W.WinType.CB)

    def process_batches(self, batch):
        return []


def _acc_node(W, name):
    return W.AccumulatorNode(lambda row, acc: None, None, _schema(W), name,
                             rich=False)


def _routing_df(W, routing):
    df = W.Dataflow("route")
    em = df.add(W.StandardEmitter(2, routing, name="em"))
    a = df.add(_acc_node(W, "acc.0"))
    b = df.add(_acc_node(W, "acc.1"))
    df.connect(em, a)
    df.connect(em, b)
    return df


def _native_df(W, abi=False):
    df = W.Dataflow("nat", recovery=W.RecoveryPolicy())
    df.add(W.WinSeqNode(NativeResidentCore(W, abi=abi), name="agg.0"))
    return df


def _async_df(W, max_delay):
    core = _StubAsyncCore(W)
    core.max_delay_s = max_delay
    df = W.Dataflow("dev", recovery=W.RecoveryPolicy())
    df.add(W.WinSeqNode(core, name="agg.0"))
    return df


def _comb_df(W, async_first):
    win = W.WinSeqNode(_StubAsyncCore(W), name="agg.0")
    mp = W.MapNode(lambda b: None, "map.0", False, True, None)
    stages = [win, mp] if async_first else [mp, win]
    df = W.Dataflow("comb", recovery=W.RecoveryPolicy())
    df.add(W.make_comb(stages, name="chain.0"))
    return df


def _recovery_sink_pipe(W, opt_in):
    s = _sink(W)
    if opt_in:
        s.recoverable = True
    p = W.MultiPipe("recsink", recovery=W.RecoveryPolicy())
    p.add_source(W.Source(_src, _schema(W)))
    p.add_sink(s)
    return p


def _race_pipe(W, guarded):
    counts = [0]
    lock = threading.Lock()

    if guarded:
        def bump(batch):
            with lock:
                counts[0] += len(batch)
    else:
        def bump(batch):
            counts[0] += len(batch)

    return _pipe(W, W.Map(bump, parallelism=2, vectorized=True))


def _ctl_pipe(W, t, *, rescale=True, recovery=True, obs=True,
              recoverable=None, target="kf", farm=None):
    """Control-plane corpus factory (WF209-212): a keyed farm under a
    ControlPolicy; the sink opts into restart so recovery= twins stay
    WF204-clean.  ``farm`` replaces the host KeyFarm."""
    if rescale:
        rules = [W.Rescale(target, max_workers=4)]
    else:
        rules = [W.Admission(max_rate=1e6, min_rate=1e3, high_depth=8,
                             low_depth=2)]
    kf = farm if farm is not None else W.KeyFarm(
        W.Reducer("sum", "value"), win_len=8, slide_len=4, pardegree=2,
        name="kf")
    if recoverable is not None:
        kf.recoverable = recoverable
    s = _sink(W)
    s.recoverable = True
    p = W.MultiPipe("ctl", control=W.ControlPolicy(rules),
                    recovery=W.RecoveryPolicy() if recovery else None,
                    metrics=True if obs else None,
                    trace_dir=str(t) if obs else None)
    p.add_source(W.Source(_src, _schema(W)))
    p.add(kf)
    p.add_sink(s)
    return p


def _trace_pipe(W, trace_dir):
    return _pipe(W, name="tr", trace=W.TracePolicy(sample_rate=0.5),
                 trace_dir=trace_dir)


_G = 0


def _global_pipe(W, bad):
    if bad:
        def fn(batch):
            global _G
            _G += 1
    else:
        def fn(batch):
            return None
    return _pipe(W, W.Map(fn, parallelism=2, vectorized=True))


def _replay_pipe(W, kind):
    """WF303/WF304 corpus: a recoverable Map under recovery= whose fn
    commits (or avoids) the flagged effect."""
    if kind == "time":
        def fn(b):
            if b is not None:
                b["ts"][:] = int(time.time())
            return b
    elif kind == "rng":
        rng = np.random.default_rng(7)

        def fn(b):
            if b is not None:
                b["value"][:] = rng.integers(0, 10, len(b))
            return b
    elif kind == "file":
        def fn(b):
            open(os.devnull, "a").close()
            return b
    else:
        def fn(b):
            return b
    s = _sink(W)
    s.recoverable = True
    p = W.MultiPipe("eff", recovery=W.RecoveryPolicy())
    p.add_source(W.Source(_src, _schema(W)))
    p.add(W.Map(fn, vectorized=True))
    p.add_sink(s)
    return p


def _latency_pipe(W, t, blocking, latency=True):
    """WF305 corpus: a keyed farm whose window fn does (or does not)
    block, under a Rescale rule that is (or is not) latency-triggered."""
    if blocking:
        def wfn(key, gwid, rows):
            time.sleep(0.001)
            return {"value": rows["value"].sum()}
    else:
        def wfn(key, gwid, rows):
            return {"value": rows["value"].sum()}
    rule = (W.Rescale("kf", max_workers=4, up_q95_us=5000.0) if latency
            else W.Rescale("kf", max_workers=4))
    kf = W.KeyFarm(wfn, win_len=8, slide_len=4, pardegree=2, name="kf",
                   result_fields=_win_fields())
    s = _sink(W)
    s.recoverable = True
    p = W.MultiPipe("lat", control=W.ControlPolicy([rule]),
                    recovery=W.RecoveryPolicy(), metrics=True,
                    trace_dir=str(t))
    p.add_source(W.Source(_src, _schema(W)))
    p.add(kf)
    p.add_sink(s)
    return p


def _winseq(W, win, slide):
    return W.WinSeq(_red, win, slide, W.WinType.CB,
                    result_fields=_win_fields())


def _panefarm(W, win, slide):
    return W.PaneFarm(_red, _red, win, slide, W.WinType.CB,
                      plq_result_fields=_win_fields(),
                      wlq_result_fields=_win_fields())


def _fed_pipe(W, t, obs=False):
    """WF217 corpus: federation with (or without) a sampler to feed the
    shipper."""
    kw = dict(metrics=True, trace_dir=str(t)) if obs else {}
    return _pipe(W, name="fed", federate=W.FederationPolicy(host="chk"), **kw)


def _plane(W, flaw=None):
    """WF22x corpus: a declared 2-host plane (check/plane.py), clean by
    construction; ``flaw`` plants exactly one defect."""
    wire = W.WireConfig(connect_deadline=30.0, heartbeat=2.0,
                        stall_timeout=10.0, resume=True, recovery=True)
    addresses = {0: ("10.0.0.1", 9000), 1: ("10.0.0.2", 9000)}
    if flaw == "orphan":
        addresses[2] = ("10.0.0.3", 9000)
    h0 = W.HostSpec(0, sends="<i8", resume=True,
                    plane=W.PlanePolicy(wire=wire), federate=True)
    h1 = W.HostSpec(1, sends="<i8",
                    expects="<f8" if flaw == "dtype" else None,
                    resume=None if flaw == "resume" else True,
                    ckpt_sink=None if flaw == "nosink" else True,
                    aggregator=flaw != "noagg")
    return W.PlaneSpec(addresses, [h0, h1], name="pl", wire=wire)


#: WF### -> (bad_factory, good_factory); factories take (package, tmp_path)
CORPUS = {
    "WF101": (lambda W, t: _routing_df(W, None),
              lambda W, t: _routing_df(W, W.default_routing)),
    "WF102": (lambda W, t: _pipe(W, _winseq(W, 4, 8)),
              lambda W, t: _pipe(W, _winseq(W, 8, 4))),
    "WF103": (lambda W, t: _pipe(W, _panefarm(W, 10, 3)),
              lambda W, t: _pipe(W, _panefarm(W, 10, 5))),
    "WF202": (lambda W, t: _async_df(W, 0.005),
              lambda W, t: _async_df(W, None)),
    "WF203": (lambda W, t: _comb_df(W, async_first=True),
              lambda W, t: _comb_df(W, async_first=False)),
    "WF204": (lambda W, t: _recovery_sink_pipe(W, False),
              lambda W, t: _recovery_sink_pipe(W, True)),
    "WF207": (lambda W, t: _pipe(W, name="obs", metrics=True),
              lambda W, t: _pipe(W, name="obs", metrics=True,
                                 trace_dir=str(t))),
    "WF208": (lambda W, t: _pipe(W, name="ovl", capacity=0,
                                 overload=W.OverloadPolicy(
                                     shed="shed_newest")),
              lambda W, t: _pipe(W, name="ovl", capacity=16,
                                 overload=W.OverloadPolicy(
                                     shed="shed_newest"))),
    "WF209": (lambda W, t: _ctl_pipe(W, t, rescale=False, recovery=False,
                                     obs=False),
              lambda W, t: _ctl_pipe(W, t, rescale=False, recovery=False)),
    "WF210": (lambda W, t: _ctl_pipe(W, t, recoverable=False),
              lambda W, t: _ctl_pipe(W, t)),
    "WF211": (lambda W, t: _ctl_pipe(W, t, recovery=False),
              lambda W, t: _ctl_pipe(W, t)),
    "WF212": (lambda W, t: _ctl_pipe(W, t, target="kfarm"),
              lambda W, t: _ctl_pipe(W, t)),
    "WF213": (lambda W, t: _trace_pipe(W, None),
              lambda W, t: _trace_pipe(W, str(t))),
    "WF205": (lambda W, t: W.WireConfig(heartbeat=5.0, stall_timeout=2.0),
              lambda W, t: W.WireConfig.hardened()),
    "WF206": (lambda W, t: W.WireConfig(heartbeat=2.0),
              lambda W, t: W.WireConfig(heartbeat=2.0, stall_timeout=10.0)),
    "WF214": (lambda W, t: W.WireConfig(resume=True),
              lambda W, t: W.WireConfig(resume=True, recovery=True)),
    "WF215": (lambda W, t: _native_df(W), lambda W, t: _native_df(W, True)),
    "WF216": (lambda W, t: W.PlanePolicy(wire=W.WireConfig.hardened()),
              lambda W, t: W.PlanePolicy(wire=W.WireConfig(
                  connect_deadline=60.0, heartbeat=2.0,
                  stall_timeout=10.0, resume=True, recovery=True))),
    "WF217": (lambda W, t: _fed_pipe(W, t),
              lambda W, t: _fed_pipe(W, t, obs=True)),
    "WF220": (lambda W, t: _plane(W, "orphan"), lambda W, t: _plane(W)),
    "WF221": (lambda W, t: _plane(W, "dtype"), lambda W, t: _plane(W)),
    "WF222": (lambda W, t: _plane(W, "resume"), lambda W, t: _plane(W)),
    "WF223": (lambda W, t: _plane(W, "nosink"), lambda W, t: _plane(W)),
    "WF224": (lambda W, t: _plane(W, "noagg"), lambda W, t: _plane(W)),
    "WF301": (lambda W, t: _race_pipe(W, guarded=False),
              lambda W, t: _race_pipe(W, guarded=True)),
    "WF302": (lambda W, t: _global_pipe(W, True),
              lambda W, t: _global_pipe(W, False)),
    "WF303": (lambda W, t: _replay_pipe(W, "time"),
              lambda W, t: _replay_pipe(W, "rng")),
    "WF304": (lambda W, t: _replay_pipe(W, "file"),
              lambda W, t: _replay_pipe(W, "pure")),
    "WF305": (lambda W, t: _latency_pipe(W, t, blocking=True),
              lambda W, t: _latency_pipe(W, t, blocking=False)),
}


def reports(factory, tmp_path):
    """The validate() report of ``factory``'s graph in JAX and the port."""
    out = []
    for W in (JX, PT):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # construction-time WF2xx
            out.append(W.validate(factory(W, tmp_path)))
    return out


def test_catalog_equal_and_corpus_covers_it():
    assert PT.CATALOG == JX.CATALOG
    assert set(CORPUS) == set(PT.CATALOG)


@pytest.mark.parametrize("code", sorted(CORPUS))
def test_minimal_failing_graph_matches_jax(code, tmp_path):
    jax_rep, port_rep = reports(CORPUS[code][0], tmp_path)
    assert port_rep.codes() == jax_rep.codes(), port_rep.render()
    assert ([d.severity for d in port_rep]
            == [d.severity for d in jax_rep])
    if code not in EFFECTS:
        assert code in port_rep.codes(), port_rep.render()
        for d in port_rep:
            if d.code == code:
                assert d.severity == PT.CATALOG[code][0]


@pytest.mark.parametrize("code", sorted(CORPUS))
def test_minimally_fixed_twin_clean(code, tmp_path):
    jax_rep, port_rep = reports(CORPUS[code][1], tmp_path)
    assert len(port_rep) == 0, port_rep.render()
    assert len(jax_rep) == 0


# ------------------------------------------- the port's own device patterns

def _kf_gpu(**kw):
    from windflow_tpu_torch import KeyFarmGPU
    return KeyFarmGPU(PT.Reducer("sum", "value"), 8, 4, pardegree=2,
                      batch_len=16, name="kf", device="cpu", **kw)


def _kf_tpu(**kw):
    from windflow_tpu.patterns.win_seq_tpu import KeyFarmTPU
    return KeyFarmTPU(JX.Reducer("sum", "value"), 8, 4, pardegree=2,
                      batch_len=16, name="kf", **kw)


def _device_pair(make):
    """``make(W, farm)`` through JAX with KeyFarmTPU and through the port
    with KeyFarmGPU on the CPU, validated."""
    out = []
    for W, farm in ((JX, _kf_tpu), (PT, _kf_gpu)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out.append(W.validate(make(W, farm)))
    return out


@pytest.mark.parametrize("abi", [False, True])
def test_wf210_device_farm_follows_state_abi(abi, tmp_path, monkeypatch):
    """A Rescale rule on a device farm: WF210 unless the native library
    exports the state ABI (then the migratable C++ core serves it).  The
    port keys the device farm on its class name ending in "GPU"."""
    import windflow_tpu.check.config as jcfg
    import windflow_tpu_torch.check.config as pcfg
    monkeypatch.setattr(jcfg, "_native_state_abi", lambda: abi)
    monkeypatch.setattr(pcfg, "_native_state_abi", lambda: abi)
    if abi:
        from windflow_tpu_torch.native import enabled
        if enabled() is None:
            pytest.fail("the native library did not build")
    jax_rep, port_rep = _device_pair(
        lambda W, farm: _ctl_pipe(W, tmp_path, farm=farm()))
    assert port_rep.codes() == jax_rep.codes(), port_rep.render()
    assert ("WF210" in port_rep.codes()) is (not abi)


def test_wf202_on_a_max_delay_device_farm(tmp_path):
    """recovery= over a KeyFarmGPU with max_delay_ms: its native cores
    flush on the wall clock and decline snapshots (WF202, an error)."""
    def make(W, farm):
        s = _sink(W)
        s.recoverable = True
        p = W.MultiPipe("devmd", recovery=W.RecoveryPolicy())
        p.add_source(W.Source(_src, _schema(W)))
        p.add(farm(max_delay_ms=5.0))
        p.add_sink(s)
        return p
    jax_rep, port_rep = _device_pair(make)
    assert port_rep.codes() == jax_rep.codes() == {"WF202"}
    assert port_rep.has_errors


def test_wf203_on_a_chained_device_stage():
    """A device WinSeqGPU fused as the non-tail stage of a chain under
    recovery= (WF203): its harvest timing shapes the tail's emission."""
    from windflow_tpu.patterns.win_seq_tpu import WinSeqTPU
    from windflow_tpu_torch import WinSeqGPU

    def make(W, seq):
        s = _sink(W)
        s.recoverable = True
        p = W.MultiPipe("devchain", recovery=W.RecoveryPolicy())
        p.add_source(W.Source(_src, _schema(W)))
        p.add(seq)
        p.chain(W.Map(lambda b: None, vectorized=True))
        p.add_sink(s)
        return p

    reps = []
    for W, seq in ((JX, WinSeqTPU(JX.Reducer("sum", "value"), 8, 4,
                                  batch_len=16)),
                   (PT, WinSeqGPU(PT.Reducer("sum", "value"), 8, 4,
                                  batch_len=16, device="cpu"))):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            reps.append(W.validate(make(W, seq)))
    assert reps[1].codes() == reps[0].codes()
    assert "WF203" in reps[1].codes(), reps[1].render()


def test_wf215_on_the_native_core_without_the_state_abi():
    """The port's NativeResidentCore answers the WF215 probe: the same
    warning as JAX's when its library lacks the state ABI, none with it."""
    found = {}
    for W, farm in ((JX, _kf_tpu), (PT, _kf_gpu)):
        s = _sink(W)
        s.recoverable = True
        p = W.MultiPipe("nat", recovery=W.RecoveryPolicy())
        p.add_source(W.Source(_src, _schema(W)))
        p.add(farm())
        p.add_sink(s)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            df = p._build()
        cores = [n.core for n in df.nodes
                 if type(getattr(n, "core", None)).__name__
                 == "NativeResidentCore"]
        assert len(cores) == 2, W.name
        found[W.name, True] = W.validate(df).codes()
        for c in cores:
            c.has_state_abi = False
        found[W.name, False] = W.validate(df).codes()
    for abi in (True, False):
        assert found["windflow_tpu_torch", abi] == found["windflow_tpu", abi]
    assert found["windflow_tpu_torch", True] == set()
    assert found["windflow_tpu_torch", False] == {"WF215"}


# ---------------------------------------------------------- knob tests

def test_check_error_raises_before_threads():
    """An error diagnostic under check='error' raises CheckError before
    any thread starts, naming the WF id and the node's stats name."""
    df = _async_df(PT, 0.005)
    df.check = "error"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(PT.CheckError) as ei:
            df.run()
    msg = str(ei.value)
    assert "WF202" in msg
    assert PT.node_stats_name("dev", 0, "agg.0") in msg
    assert df._threads == []
    assert ei.value.report.has_errors


def test_check_error_on_a_device_farm_starts_nothing():
    """The same through MultiPipe over a real KeyFarmGPU (max_delay_ms
    under recovery=): run() raises and no node thread, sampler or
    supervisor exists."""
    s = _sink(PT)
    s.recoverable = True
    p = PT.MultiPipe("devmd", recovery=PT.RecoveryPolicy(), check="error")
    p.add_source(PT.Source(_src, _schema(PT)))
    p.add(_kf_gpu(max_delay_ms=5.0))
    p.add_sink(s)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(PT.CheckError, match="WF202"):
            p.run()
    assert p._df._threads == [] and p._df._sampler is None
    assert p._df._supervisor is None


def test_check_warn_reports_and_still_runs():
    pipe = _pipe(PT, _winseq(PT, 4, 8), name="warnrun", check="warn")
    with pytest.warns(PT.CheckWarning, match="WF102"):
        pipe.run_and_wait_end()


def test_check_mode_validated():
    with pytest.raises(ValueError, match="check="):
        PT.Dataflow("bad", check="loud")
    with pytest.raises(ValueError, match="check="):
        PT.MultiPipe("typo", check="eror")


def test_check_events_mirrored(tmp_path):
    pipe = _pipe(PT, _winseq(PT, 4, 8), name="evt", check="warn",
                 metrics=True, trace_dir=str(tmp_path))
    with pytest.warns(PT.CheckWarning):
        pipe.run_and_wait_end()
    kinds = [e for e in pipe.events.recent if e["event"] == "check"]
    assert kinds and kinds[0]["code"] == "WF102"
    assert kinds[0]["severity"] == "warning"


def test_union_takes_strictest_check_mode():
    def mk(name, check):
        p = PT.MultiPipe(name, check=check)
        p.add_source(PT.Source(_src, _schema(PT)))
        return p
    assert PT.union_multipipes(mk("a", "warn"), mk("b", "error")).check \
        == "error"
    assert PT.union_multipipes(mk("c", "off"), mk("d", None)).check == "off"
    assert PT.union_multipipes(mk("e", None), mk("f", None)).check is None


def test_union_branch_trace_dir_no_false_wf207(tmp_path):
    a = PT.MultiPipe("a", metrics=True)
    a.add_source(PT.Source(_src, _schema(PT)))
    b = PT.MultiPipe("b", trace_dir=str(tmp_path))
    b.add_source(PT.Source(_src, _schema(PT)))
    u = PT.union_multipipes(a, b)
    u.add_sink(_sink(PT))
    assert "WF207" not in PT.validate(u).codes()


def test_wf207_one_shot_engine_warning():
    with pytest.warns(UserWarning, match=r"WF207.*trace_dir"):
        PT.Dataflow("noop", metrics=True)


_SUPPRESSED_SRC = """
import numpy as np
from {pkg}.api import MultiPipe
from {pkg}.core.tuples import Schema
from {pkg}.core.windows import WinType
from {pkg}.patterns.basic import Map, Sink, Source
from {pkg}.patterns.win_seq import WinSeq

S = Schema(value=np.int64)
RF = {{"value": np.int64}}


def red(k, g, r):
    return {{"value": r["value"].sum()}}


def build():
    counts = [0]

    def bump(b):
        counts[0] += len(b){mark301}

    win = WinSeq(red, 4, 8, WinType.CB, result_fields=RF){mark102}
    return (MultiPipe("sup")
            .add_source(Source(lambda sh: None, S))
            .add(Map(bump, parallelism=2, vectorized=True))
            .add(win)
            .chain_sink(Sink(lambda b: None, vectorized=True)))
"""


def _validate_tmp_module(tmp_path, body, name, W):
    mod = tmp_path / f"{name}.py"
    mod.write_text(body)
    spec = importlib.util.spec_from_file_location(name, str(mod))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return W.validate(m.build())


@pytest.mark.parametrize("marked", [False, True])
def test_suppression_directives_match_jax(tmp_path, marked):
    marks = (dict(mark301="   # wf-lint: disable=WF301",
                  mark102="   # wf-lint: disable=WF102") if marked
             else dict(mark301="", mark102=""))
    got = []
    for W in (JX, PT):
        rep = _validate_tmp_module(
            tmp_path, _SUPPRESSED_SRC.format(pkg=W.name, **marks),
            f"wfmod_{W.name}_{marked}", W)
        got.append((rep.codes(), {d.code for d in rep.suppressed}))
    assert got[1] == got[0]
    if marked:
        assert got[1][0] == set() and "WF102" in got[1][1]
    else:
        assert {"WF301", "WF102"} <= got[1][0]


def test_directive_parser_matches_jax():
    from windflow_tpu.check.directives import parse_directive as jparse
    from windflow_tpu_torch.check.directives import parse_directive
    for line in ("x = 1  # wf-lint: disable=WF102",
                 "# wf-lint: disable=wf102, WF301", "# wf-lint: disable",
                 "# wf-lint:disable=WF102", "plain line",
                 "# wf-lint: disable=nonsense", "# wf-lint: disable=WF30l"):
        assert parse_directive(line) == jparse(line)
    assert parse_directive("# wf-lint: disable=nonsense") == set()


# ------------------------------------------------- effect analyzer (WF30x)

def _stamp_helper():
    return time.time()


_LOCK = threading.Lock()


def _fx_shuffle(b):
    np.random.shuffle(b)


def _fx_seeded(b, _rng=np.random.default_rng(7)):
    np.random.shuffle(b)


def _fx_helper(b):
    return _stamp_helper()


def _fx_acquire(b):
    _LOCK.acquire()
    _LOCK.release()


def _fx_timed_acquire(b):
    if _LOCK.acquire(timeout=0.1):
        _LOCK.release()


def _fx_time(b):
    return time.time()


@pytest.mark.parametrize("fn,codes", [
    (_fx_shuffle, {"WF303"}), (_fx_seeded, {"WF303"}),
    (_fx_helper, {"WF303"}), (_fx_time, {"WF303"}),
    (_fx_acquire, {"WF305"}), (_fx_timed_acquire, {"WF305"}),
], ids=lambda v: getattr(v, "__name__", "codes"))
def test_effects_analyzer_matches_jax(fn, codes):
    """analyze_effects gives the reference's diagnostics for the same
    function (the same codes, messages and anchors)."""
    from windflow_tpu.check.effects import analyze_effects as janalyze
    from windflow_tpu_torch.check.effects import analyze_effects
    mine = [(d.code, d.message, d.anchor)
            for d in analyze_effects(fn, codes, "svc")]
    assert mine == [(d.code, d.message, d.anchor)
                    for d in janalyze(fn, codes, "svc")]


def test_effects_analyzer_flags_shuffle_and_acquire():
    """What the walker does find on this interpreter: a module-level
    np.random call (seeded generators exempt) and an untimed acquire."""
    from windflow_tpu_torch.check.effects import analyze_effects
    assert [d.code for d in analyze_effects(_fx_shuffle, {"WF303"}, "kf")] \
        == ["WF303"]
    assert analyze_effects(_fx_seeded, {"WF303"}, "kf") == []
    assert [d.code for d in analyze_effects(_fx_acquire, {"WF305"}, "s")] \
        == ["WF305"]
    assert analyze_effects(_fx_timed_acquire, {"WF305"}, "s") == []


def test_effects_gating_by_contract(tmp_path):
    """A blocking fn under a depth-triggered Rescale does not arm WF305."""
    jax_rep, port_rep = reports(
        lambda W, t: _latency_pipe(W, t, blocking=True, latency=False),
        tmp_path)
    assert "WF305" not in port_rep.codes()
    assert port_rep.codes() == jax_rep.codes()


def test_effects_suppression_directive_matches_jax(tmp_path):
    mod = tmp_path / "eff_sup_torch.py"
    mod.write_text(textwrap.dedent("""
        import time

        def noisy(b):
            return time.time()

        def quiet(b):
            return time.time()   # wf-lint: disable=WF303
    """))
    spec = importlib.util.spec_from_file_location("eff_sup_torch",
                                                  str(mod))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    from windflow_tpu.check.effects import analyze_effects as janalyze
    from windflow_tpu_torch.check.effects import analyze_effects
    for fn in (m.noisy, m.quiet):
        assert ([d.code for d in analyze_effects(fn, {"WF303"}, "n")]
                == [d.code for d in janalyze(fn, {"WF303"}, "n")])
    assert analyze_effects(m.quiet, {"WF303"}, "n") == []


# ------------------------------------------------------------- self-lint

@pytest.mark.parametrize("app", ["micro", "pipe", "spatial", "ysb"])
def test_app_lint_hooks_match_jax(app):
    """Each port app's wf_check_pipelines() validates to the same codes as
    the JAX app's hook (both clean); pipe's farm is built on the CPU."""
    jmod = importlib.import_module(f"windflow_tpu.apps.{app}")
    pmod = importlib.import_module(f"windflow_tpu_torch.apps.{app}")
    kw = {"device": "cpu"} if app == "pipe" else {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = [JX.validate(p).codes() for p in jmod.wf_check_pipelines()]
        got = [PT.validate(p).codes() for p in pmod.wf_check_pipelines(**kw)]
    assert got == want
    assert all(c == set() for c in got)
