"""The control plane (windflow_tpu_torch/control/) against the JAX package's
(windflow_tpu/control/): a Key_Farm rescaled N -> N+k and back mid-stream
gives, per key in order, the JAX package's output and the fixed-width
oracle's, for every host core flavour, the accumulator farm and a
KeyFarmGPU whose workers run the native resident core on the CPU (manual
2 -> 4 -> 2 and the threshold rule), where the per-key C++ state moves
through the state ABI at the epoch barrier.  Then the Python resident
core's refusal, drain, admission, adaptive shedding, policy validation,
WF209/WF211 and the wiring refusals.  Each comparison is exact: the
(key, id, value) sequence of every key."""

import time
import warnings

import numpy as np
import pytest

import windflow_tpu as jx
import windflow_tpu_torch as wt
from windflow_tpu import control as jctl
from windflow_tpu_torch.control import (Admission, AdaptiveShed,
                                        ControlPolicy, Drain, Rescale,
                                        RescaleError, TokenBucket)
from windflow_tpu_torch.runtime.engine import Dataflow

SCHEMA = wt.Schema(value=np.int64)


@pytest.fixture(autouse=True)
def _no_ambient_obs_env(monkeypatch):
    monkeypatch.delenv("WF_LOG_DIR", raising=False)
    monkeypatch.delenv("WF_SAMPLE_PERIOD", raising=False)


def keyed_batches(n_batches=60, rows=50, n_keys=13, seed=7):
    """Per-key dense ids / monotone ts — the pristine-source contract."""
    rng = np.random.default_rng(seed)
    ctr = {}
    for _ in range(n_batches):
        b = np.zeros(rows, dtype=SCHEMA.dtype())
        keys = rng.integers(0, n_keys, rows)
        b["key"] = keys
        b["value"] = rng.integers(0, 100, rows)
        for i, k in enumerate(keys.tolist()):
            b["id"][i] = ctr.get(k, 0)
            ctr[k] = ctr.get(k, 0) + 1
        b["ts"] = b["id"]
        yield b


def _quiet(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # WF207/WF209, int32 advisory
        return fn()


def per_key(rows):
    """(key, id, value) rows grouped by key, arrival order kept."""
    d = {}
    for k, i, v in rows:
        d.setdefault(k, []).append((i, v))
    return d


def _manual_rule(W=None, max_workers=4):
    """A Rescale rule that never fires on its own: scripted requests."""
    R = (W.control.Rescale if W is not None else Rescale)
    return R("kf", max_workers=max_workers, min_workers=1,
             up_depth=10 ** 9, down_depth=-1, cooldown=10 ** 9)


def _build_pipe(W, out, pattern, control=None, recovery=None, metrics=None,
                sink_sleep=0.0, capacity=8, n_batches=60):
    pipe = W.MultiPipe("job", capacity=capacity, recovery=recovery,
                       metrics=metrics, control=control)
    pipe.add_source(W.Source(batches=lambda i: keyed_batches(n_batches),
                             name="src"))
    pipe.add(pattern)

    def sink(r):
        if r is not None:
            if sink_sleep:
                time.sleep(sink_sleep)
            out.append((int(r["key"]), int(r["id"]), int(r["value"])))
    pipe.add_sink(W.Sink(sink, name="sink"))
    return pipe


def _fixed(W, pattern, **kw):
    out = []
    _quiet(lambda: _build_pipe(W, out, pattern, **kw)
           .run_and_wait_end(timeout=300))
    return per_key(out)


def _await_width(ctl, width, timeout=120.0):
    t0 = time.monotonic()
    while ctl.width_of("kf") != width:
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"rescale to {width} did not land in "
                                 f"{timeout}s (width {ctl.width_of('kf')})")
        time.sleep(0.01)


def _rescaled(W, pattern, widths, epoch_batches=5, prepare=None, **kw):
    """Run ``pattern`` under a manual rule, requesting each width of
    ``widths`` once the previous one landed; returns the per-key rows and
    the rescale history.  ``prepare`` gets the pipe before it runs."""
    got = []
    pipe = _build_pipe(
        W, got, pattern,
        control=W.control.ControlPolicy([_manual_rule(W)], period=0.02),
        recovery=W.RecoveryPolicy(epoch_batches=epoch_batches,
                                  restart_backoff=0.01),
        metrics=True, **kw)
    if prepare is not None:
        prepare(pipe)
    _quiet(pipe.run)
    ctl = pipe.controller
    for i, w in enumerate(widths):
        assert ctl.request_rescale("kf", w)
        if i + 1 < len(widths):
            _await_width(ctl, w)
    pipe.wait(timeout=300)
    return per_key(got), [h[:2] for fc in ctl.farms for h in fc.history]


def _kf_pattern(W, flavour):
    if flavour == "tumbling":
        return W.KeyFarm(W.Reducer("sum", "value"), win_len=4, slide_len=4,
                         pardegree=2, name="kf")
    if flavour in ("sliding", "sliding_vec"):
        return W.KeyFarm(W.Reducer("sum", "value"), win_len=8, slide_len=4,
                         pardegree=2, name="kf")
    if flavour == "nic":
        return W.KeyFarm(lambda key, gwid, rows: (int(rows["value"].sum()),),
                         win_len=8, slide_len=4, pardegree=2, name="kf",
                         result_fields={"value": np.int64})
    raise AssertionError(flavour)


# --------------------------------------------------------------- policy

def test_policy_validation():
    with pytest.raises(ValueError, match="at least one rule"):
        ControlPolicy([])
    with pytest.raises(TypeError, match="unknown rule"):
        ControlPolicy([object()])
    with pytest.raises(ValueError, match="period"):
        ControlPolicy([_manual_rule()], period=0)
    with pytest.raises(ValueError, match="duplicate Rescale"):
        ControlPolicy([_manual_rule(), _manual_rule()])
    with pytest.raises(ValueError, match="AdaptiveShed"):
        ControlPolicy([AdaptiveShed(8, 2), AdaptiveShed(9, 3)])
    with pytest.raises(ValueError, match="max_workers"):
        Rescale("kf", max_workers=2, min_workers=2)
    with pytest.raises(ValueError, match="low threshold"):
        Rescale("kf", max_workers=4, up_depth=2, down_depth=5)
    with pytest.raises(ValueError, match="min_rate"):
        Admission(max_rate=10, min_rate=20, high_depth=8, low_depth=2)
    with pytest.raises(ValueError, match="overlapping Admission"):
        ControlPolicy([
            Admission(max_rate=10, min_rate=1, high_depth=8, low_depth=2),
            Admission(max_rate=5, min_rate=1, high_depth=8, low_depth=2)])
    with pytest.raises(ValueError, match="one Drain"):
        ControlPolicy([Drain(), Drain()])
    with pytest.raises(TypeError, match="ControlPolicy"):
        Dataflow("x", control=object())
    with pytest.raises(TypeError, match="ControlPolicy"):
        Dataflow("x", control=jctl.ControlPolicy([_manual_rule(jx)]))


def test_rule_state_machines_match_jax():
    """The same observation sequences drive the port's and JAX's rules to
    the same decisions (hysteresis, cooldown, the shed and q95 signals)."""
    def seqs(C):
        return [
            (C.AdaptiveShed(high_depth=10, low_depth=2, hysteresis=3,
                            cooldown=0.0),
             [12, 12, 12, 12, 1, 12, 12, 12]),
            (C.AdaptiveShed(high_depth=10, low_depth=2, hysteresis=1,
                            cooldown=5.0), [12, 12, 12, 12, 1]),
            (C.Rescale("kf", max_workers=4, up_depth=100, down_depth=0,
                       up_shed=50.0, hysteresis=1, cooldown=0.0),
             [(0, 80.0), (0, 0.0), (5, 0.0)]),
            (C.Rescale("kf", max_workers=4, up_q95_us=50_000.0,
                       hysteresis=2, cooldown=0.0),
             [(0, 0.0, 10_000.0), (0, 0.0, 60_000.0), (0, 0.0, 75_000.0)]),
        ]
    times = [0.0, 1.0, 2.0, 3.0, 4.0, 4.9, 5.0, 10.1]
    for (mine, obs), (ref, _) in zip(seqs(wt.control), seqs(jctl)):
        assert ([mine.observe(o, t) for o, t in zip(obs, times)]
                == [ref.observe(o, t) for o, t in zip(obs, times)])


def test_token_bucket_rates_and_debt():
    b = TokenBucket(rate=1000.0, burst=100.0)
    t0 = time.monotonic()
    b.throttle(100)
    b.throttle(500)
    b.throttle(1)
    assert time.monotonic() - t0 >= 0.4


def test_rescale_without_recovery_refused():
    with pytest.raises(ValueError, match="WF211"):
        Dataflow("x", control=ControlPolicy([_manual_rule()]))
    _quiet(lambda: Dataflow("x", control=ControlPolicy(
        [Admission(max_rate=10, min_rate=1, high_depth=8, low_depth=2)])))


def test_blind_control_warns_wf209():
    with pytest.warns(UserWarning, match=r"WF209.*blind"):
        Dataflow("x", metrics=None, recovery=wt.RecoveryPolicy(),
                 control=ControlPolicy([_manual_rule()]))


def test_policy_agreement():
    def mk():
        return ControlPolicy([_manual_rule(), AdaptiveShed(8, 2)],
                             period=0.5)
    assert mk().agrees_with(mk())
    assert not mk().agrees_with(ControlPolicy([_manual_rule()], period=0.5))


# ------------------------------------------- live-rescale differential

@pytest.mark.parametrize("flavour", ["tumbling", "sliding", "sliding_vec",
                                     "nic"])
def test_keyfarm_rescale_up_and_back_matches_jax_and_oracle(flavour):
    oracle = _fixed(wt, _kf_pattern(wt, flavour))
    assert oracle == _fixed(jx, _kf_pattern(jx, flavour))

    def prepare(pipe):
        # pin the lazy cores' crossover so the first chunk escalates to
        # the lane-vectorised sliding core on every worker
        for n in _quiet(pipe._build).nodes:
            core = getattr(n, "core", None)
            if core is not None and hasattr(core, "_threshold"):
                core._threshold = 1
    got, history = _rescaled(wt, _kf_pattern(wt, flavour), (4, 2),
                             prepare=(prepare if flavour == "sliding_vec"
                                      else None))
    assert history and history[0] == (2, 4), history
    assert got == oracle


def test_keyfarm_scale_down_matches_jax_and_oracle():
    def kf(W):
        return W.KeyFarm(W.Reducer("sum", "value"), 8, 4, pardegree=3,
                         name="kf")
    oracle = _fixed(wt, kf(wt))
    assert oracle == _fixed(jx, kf(jx))
    got, history = _rescaled(wt, kf(wt), (1,), epoch_batches=4)
    assert history == [(3, 1)]
    assert got == oracle


def test_accumulator_farm_rescale_matches_jax_and_oracle():
    def acc(W):
        return W.Accumulator(lambda row, a_: a_.__setitem__(
            "value", a_["value"] + row["value"]), W.Schema(value=np.int64),
            parallelism=2, name="kf")
    oracle = _fixed(wt, acc(wt))
    assert oracle == _fixed(jx, acc(jx))
    got, history = _rescaled(wt, acc(wt), (4, 2))
    assert history[0] == (2, 4)
    assert got == oracle


def _threshold_control(W):
    return W.control.ControlPolicy(
        [W.control.Rescale("kf", max_workers=4, min_workers=1, up_depth=1,
                           down_depth=-1, hysteresis=1, cooldown=0.0)],
        period=0.02)


def test_threshold_driven_rescale_matches_jax_and_oracle():
    def kf(W):
        return W.KeyFarm(W.Reducer("sum", "value"), 4, 4, pardegree=2,
                         name="kf")
    oracle = _fixed(wt, kf(wt), capacity=4, sink_sleep=0.0002)
    assert oracle == _fixed(jx, kf(jx), capacity=4, sink_sleep=0.0002)
    got = []
    pipe = _build_pipe(wt, got, kf(wt), control=_threshold_control(wt),
                       recovery=wt.RecoveryPolicy(epoch_batches=4,
                                                  restart_backoff=0.01),
                       metrics=True, capacity=4, sink_sleep=0.0002)
    _quiet(lambda: pipe.run_and_wait_end(timeout=300))
    hist = [h for fc in pipe.controller.farms for h in fc.history]
    assert hist, "threshold rule never fired"
    snap = pipe.metrics.snapshot()
    assert snap["counters"]["ctl_rescale_up"] >= 1
    assert snap["gauges"]["ctl_width_kf"] == hist[-1][1]
    assert per_key(got) == oracle


# ------------------------------------- KeyFarmGPU over the native core

def _require_state_abi():
    from windflow_tpu_torch.native import enabled
    lib = enabled()
    assert lib is not None, "the native library did not build"
    assert getattr(lib, "wf_has_state_abi", False), \
        "the native library lacks the state ABI"


def _kf_device(W, batch_len=64):
    if W is wt:
        return wt.KeyFarmGPU(wt.Reducer("sum", "value"), 8, 4, pardegree=2,
                             batch_len=batch_len, name="kf", device="cpu")
    from windflow_tpu.patterns.win_seq_tpu import KeyFarmTPU
    return KeyFarmTPU(jx.Reducer("sum", "value"), 8, 4, pardegree=2,
                      batch_len=batch_len, name="kf")


def _native_workers(pipe):
    df = _quiet(pipe._build)
    return [n for n in df.nodes if n.name.startswith("kf.")
            and "emitter" not in n.name and "collector" not in n.name]


def test_keyfarm_gpu_native_manual_rescale_matches_jax_and_oracle():
    """2 -> 4 -> 2 on KeyFarmGPU: the four pre-provisioned workers are
    native cores on the farm's device with the state ABI, and each key's
    results equal the fixed-width port run and JAX's KeyFarmTPU run under
    the same rescale."""
    _require_state_abi()
    oracle = _fixed(wt, _kf_device(wt))
    want, jhist = _rescaled(jx, _kf_device(jx), (4, 2), epoch_batches=4)
    assert want == oracle and jhist[:2] == [(2, 4), (4, 2)]
    got = []
    pipe = _build_pipe(
        wt, got, _kf_device(wt),
        control=ControlPolicy([_manual_rule()], period=0.02),
        recovery=wt.RecoveryPolicy(epoch_batches=4, restart_backoff=0.01),
        metrics=True)
    workers = _native_workers(pipe)
    assert len(workers) == 4
    for w in workers:
        assert isinstance(w.core, wt.NativeResidentCore)
        assert w.core.has_state_abi and w.core.keyed_migratable
        assert {str(ex.device) for ex in w.core.executors} == {"cpu"}
    _quiet(pipe.run)
    ctl = pipe.controller
    assert ctl.request_rescale("kf", 4)
    _await_width(ctl, 4)
    assert ctl.request_rescale("kf", 2)
    pipe.wait(timeout=300)
    history = [h[:2] for fc in ctl.farms for h in fc.history]
    assert history == [(2, 4), (4, 2)]
    assert pipe.metrics.snapshot()["gauges"]["ctl_width_kf"] == 2
    assert per_key(got) == oracle


def test_keyfarm_gpu_native_threshold_rescale_matches_jax_and_oracle():
    """The threshold rule (a slow sink's inbox depth) on KeyFarmGPU of
    native cores: per key equal to the oracle and to JAX's KeyFarmTPU run
    under the same rule."""
    _require_state_abi()
    kw = dict(capacity=4, sink_sleep=0.0002)
    oracle = _fixed(wt, _kf_device(wt), **kw)
    assert oracle == _fixed(jx, _kf_device(jx), **kw)
    for W in (jx, wt):
        got = []
        pipe = _build_pipe(W, got, _kf_device(W),
                           control=_threshold_control(W),
                           recovery=W.RecoveryPolicy(epoch_batches=4,
                                                     restart_backoff=0.01),
                           metrics=True, **kw)
        _quiet(lambda: pipe.run_and_wait_end(timeout=300))
        hist = [h for fc in pipe.controller.farms for h in fc.history]
        assert hist, f"{W.__name__}: threshold rule never fired"
        assert per_key(got) == oracle, W.__name__


def test_rescale_refused_on_the_python_resident_core(monkeypatch):
    """WF_NO_NATIVE_CORE=1 pins the Python resident core, whose per-key
    rows live in a device ring the host hooks cannot move: attach refuses,
    as JAX's does for KeyFarmTPU."""
    monkeypatch.setenv("WF_NO_NATIVE_CORE", "1")
    for W in (jx, wt):
        pipe = W.MultiPipe(
            "dev", metrics=True, recovery=W.RecoveryPolicy(epoch_batches=3),
            control=W.control.ControlPolicy([_manual_rule(W)], period=0.05))
        pipe.add_source(W.Source(batches=lambda i: keyed_batches(2),
                                 name="src"))
        pipe.add(_kf_device(W, batch_len=8))
        pipe.add_sink(W.Sink(lambda r: None, name="sink"))
        if W is wt:
            assert all(type(w.core).__name__ == "ResidentWinSeqCore"
                       for w in _native_workers(pipe))
        with pytest.raises(ValueError, match="keyed-state migration"):
            _quiet(pipe.run)


# ------------------------------------------------------- wiring refusals

def test_migration_failure_fails_graph_without_restart():
    pipe = _build_pipe(
        wt, [], wt.KeyFarm(wt.Reducer("sum", "value"), 4, 4, pardegree=2,
                           name="kf"),
        control=ControlPolicy([_manual_rule()], period=0.02),
        recovery=wt.RecoveryPolicy(epoch_batches=4, restart_backoff=0.01,
                                   max_restarts=5),
        metrics=True)
    df = _quiet(pipe._build)
    for n in df.nodes:
        core = getattr(n, "core", None)
        if core is not None and hasattr(core, "keyed_state_import"):
            def bad_import(frag):
                raise RuntimeError("injected migration fault")
            core.keyed_state_import = bad_import
    _quiet(pipe.run)
    assert pipe.controller.request_rescale("kf", 4)
    with pytest.raises(RescaleError):
        pipe.wait(timeout=120)
    ev = [e for e in pipe.events.recent if e["event"] == "node_error"]
    assert any("migration" in e.get("message", "") for e in ev)


@pytest.mark.parametrize("case", ["winfarm", "unknown", "outside"])
def test_rescale_rule_wiring_refused(case):
    """A WinFarm target (WF210), a rule naming no wired farm, and a
    declared width outside the rule's range are refused at run(), with
    the JAX package's messages."""
    msgs = []
    for W in (jx, wt):
        if case == "winfarm":
            pat = W.WinFarm(W.Reducer("sum", "value"), 8, 4, pardegree=2,
                            name="kf")
        else:
            pat = W.KeyFarm(W.Reducer("sum", "value"), 8, 4,
                            pardegree=6 if case == "outside" else 2,
                            name="other" if case == "unknown" else "kf")
        pipe = _build_pipe(
            W, [], pat,
            control=W.control.ControlPolicy([_manual_rule(W)], period=0.05),
            recovery=W.RecoveryPolicy(epoch_batches=5), metrics=True)
        with pytest.raises(ValueError) as ei:
            _quiet(pipe.run)
        msgs.append(str(ei.value))
    assert msgs[1] == msgs[0]
    assert {"winfarm": "WF210", "unknown": "no key-partitioned farm",
            "outside": "outside"}[case] in msgs[1]


def test_preview_build_keeps_initial_width():
    def kf(W):
        return W.KeyFarm(W.Reducer("sum", "value"), 4, 4, pardegree=2,
                         name="kf")
    oracle = _fixed(wt, kf(wt))
    got = []
    pipe = _build_pipe(
        wt, got, kf(wt),
        control=ControlPolicy([_manual_rule()], period=0.05),
        recovery=wt.RecoveryPolicy(epoch_batches=5, restart_backoff=0.01),
        metrics=True)
    n = pipe.getNumThreads()
    _quiet(lambda: pipe.run_and_wait_end(timeout=120))
    assert pipe.getNumThreads() == n
    assert pipe.controller.width_of("kf") == 2
    assert per_key(got) == oracle


def test_blind_control_runs_without_controller():
    got = []
    pipe = _build_pipe(
        wt, got, wt.KeyFarm(wt.Reducer("sum", "value"), 4, 4, pardegree=2,
                            name="kf"),
        control=ControlPolicy([_manual_rule()], period=0.05),
        recovery=wt.RecoveryPolicy(epoch_batches=10))
    with pytest.warns(UserWarning, match="WF209"):
        pipe.run_and_wait_end(timeout=120)
    assert pipe.controller is None
    assert got


def test_union_control_policies_must_agree():
    def gen(sh):
        sh.push(key=0, id=0, ts=0, value=1)

    def mk(name, pol):
        p = wt.MultiPipe(name, metrics=True, control=pol)
        p.add_source(wt.Source(gen, SCHEMA))
        return p

    adm = [Admission(max_rate=10, min_rate=1, high_depth=8, low_depth=2)]
    assert wt.union_multipipes(mk("a", ControlPolicy(adm)),
                               mk("b", None)).control is not None
    with pytest.raises(ValueError, match="conflicting control"):
        wt.union_multipipes(mk("c", ControlPolicy(adm)),
                            mk("d", ControlPolicy(adm, period=9.0)))


# ------------------------------------------- adaptive shed / admission

def _slow_sink_pipe(W, out, control, n_batches, sleep, overload=None,
                    metrics=True):
    pipe = W.MultiPipe("ovl", capacity=4, metrics=metrics, control=control,
                       overload=overload)
    pipe.add_source(W.Source(batches=lambda i: keyed_batches(n_batches),
                             name="src"))

    def sink(r):
        if r is not None:
            time.sleep(sleep)
            out.append((int(r["key"]), int(r["id"]), int(r["value"])))
    pipe.add_sink(W.Sink(sink, name="sink"))
    return pipe


def test_adaptive_shed_moves_soft_limit():
    got = []
    pipe = _slow_sink_pipe(
        wt, got, ControlPolicy([AdaptiveShed(
            high_depth=3, low_depth=0, min_limit=1, step=1, hysteresis=1,
            cooldown=0.0)], period=0.02), 80, 0.001,
        overload=wt.OverloadPolicy(shed="shed_oldest"))
    _quiet(lambda: pipe.run_and_wait_end(timeout=180))
    assert pipe.metrics.snapshot()["counters"].get("ctl_shed_tighten", 0) >= 1
    lim = pipe._df.overload.soft_limit
    assert lim is None or lim >= 1
    assert got


def test_adaptive_shed_requires_shedding_policy():
    pipe = wt.MultiPipe("ovl", capacity=4, metrics=True,
                        control=ControlPolicy([AdaptiveShed(3, 0)],
                                              period=0.05))
    pipe.add_source(wt.Source(batches=lambda i: keyed_batches(2),
                              name="src"))
    pipe.add_sink(wt.Sink(lambda r: None, name="sink"))
    with pytest.raises(ValueError, match="AdaptiveShed"):
        _quiet(pipe.run)


def test_admission_rate_clamped_and_content_preserved():
    oracle = []
    _quiet(lambda: _slow_sink_pipe(wt, oracle, None, 30, 0.0005,
                                   metrics=None).run_and_wait_end(
                                       timeout=120))
    got = []
    min_rate = 2e4
    pipe = _slow_sink_pipe(wt, got, ControlPolicy(
        [Admission(max_rate=1e6, min_rate=min_rate, high_depth=2,
                   low_depth=0, hysteresis=1, cooldown=0.0)],
        period=0.02), 30, 0.0005)
    _quiet(lambda: pipe.run_and_wait_end(timeout=180))
    snap = pipe.metrics.snapshot()
    assert snap["counters"].get("ctl_admission_down", 0) >= 1
    assert snap["gauges"]["ctl_admission_rate"] >= min_rate
    assert per_key(got) == per_key(oracle)


@pytest.mark.parametrize("case", ["overlap", "unknown"])
def test_admission_wiring_refused(case):
    rules = ([Admission(max_rate=10, min_rate=1, high_depth=8, low_depth=2,
                        pattern="src"),
              Admission(max_rate=5, min_rate=1, high_depth=8, low_depth=2,
                        pattern="src.0")] if case == "overlap" else
             [Admission(max_rate=10, min_rate=1, high_depth=8, low_depth=2,
                        pattern="nosuch")])
    pipe = wt.MultiPipe("adm", metrics=True,
                        control=ControlPolicy(rules, period=0.05))
    pipe.add_source(wt.Source(batches=lambda i: keyed_batches(2),
                              name="src"))
    pipe.add_sink(wt.Sink(lambda r: None, name="sink"))
    with pytest.raises(ValueError, match=("double-throttle"
                                          if case == "overlap"
                                          else "Admission")):
        _quiet(pipe.run)


# ----------------------------------------------------------------- drain

def test_drain_quiesces_then_resumes_content_preserved():
    oracle = []
    _quiet(lambda: _slow_sink_pipe(wt, oracle, None, 40, 0.0005,
                                   metrics=None).run_and_wait_end(
                                       timeout=120))
    got = []
    pipe = _slow_sink_pipe(wt, got, ControlPolicy(
        [Drain(deadline=30.0, poll=0.01)], period=0.05), 40, 0.0005)
    _quiet(pipe.run)
    time.sleep(0.05)
    assert pipe.request_drain() is True
    assert pipe.controller.draining
    time.sleep(0.3)
    n_at_drain = len(got)
    time.sleep(0.3)
    assert len(got) == n_at_drain
    assert pipe.request_drain(timeout=5.0) is True
    pipe.release_drain()
    assert not pipe.controller.draining
    pipe.wait(timeout=120)
    assert per_key(got) == per_key(oracle)
    snap = pipe.metrics.snapshot()
    assert snap["counters"].get("ctl_drains", 0) == 1
    assert snap["gauges"]["ctl_draining"] == 0
    phases = [e.get("phase") for e in pipe.events.recent
              if e["event"] == "drain"]
    assert phases[:2] == ["requested", "quiesced"]
    assert "released" in phases


def test_drain_without_rule_or_run_refused():
    pipe = wt.MultiPipe("drn2", capacity=4, metrics=True,
                        control=ControlPolicy([AdaptiveShed(3, 0)],
                                              period=0.05))
    with pytest.raises(RuntimeError, match="running"):
        pipe.request_drain()
    pipe2 = wt.MultiPipe(
        "drn3", capacity=4, metrics=True,
        overload=wt.OverloadPolicy(shed="shed_oldest"),
        control=ControlPolicy([AdaptiveShed(3, 0)], period=0.05))
    pipe2.add_source(wt.Source(batches=lambda i: keyed_batches(2),
                               name="src"))
    pipe2.add_sink(wt.Sink(lambda r: None, name="sink"))
    _quiet(pipe2.run)
    try:
        with pytest.raises(RuntimeError, match="Drain"):
            pipe2.request_drain()
    finally:
        pipe2.wait(timeout=60)


def test_control_events_in_the_event_log(tmp_path):
    """A rescale leaves 'control' and 'rescale' events, in the recent ring
    and in events.jsonl."""
    pipe = _build_pipe(
        wt, [], wt.KeyFarm(wt.Reducer("sum", "value"), 4, 4, pardegree=2,
                           name="kf"),
        control=ControlPolicy([_manual_rule()], period=0.02),
        recovery=wt.RecoveryPolicy(epoch_batches=4, restart_backoff=0.01),
        metrics=True)
    pipe.trace_dir = str(tmp_path)
    pipe.run()
    assert pipe.controller.request_rescale("kf", 3)
    pipe.wait(timeout=120)
    kinds = {e["event"] for e in pipe.events.recent}
    assert {"control", "rescale"} <= kinds, kinds
    assert (tmp_path / "events.jsonl").stat().st_size > 0
