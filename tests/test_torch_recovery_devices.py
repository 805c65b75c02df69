"""Crash and restart of the port's device cores under the recovery
layer's Supervisor — twins of tests/test_recovery.py's device-core
differentials, tests/test_native.py's ship-failure cancellation and
tests/test_control.py's crash after a rescale.

Each twin runs the port's ``WinSeqGPU`` / ``KeyFarmGPU`` with
``device="cpu"`` (the kernels' plain versions): a kill point makes the
window node raise once mid-stream, the Supervisor restores the last epoch
and replays, and the crashed run's rows must equal the uncrashed run's row
for row, and the JAX package's rows for the same stream.  Then every
device core's resolved snapshot must pickle with no torch object inside,
so a checkpoint loads on a host without a card."""

import io
import pickle
import warnings

import numpy as np
import pytest
import torch

import windflow_tpu as jx
import windflow_tpu_torch as wt
from windflow_tpu_torch.control import ControlPolicy, Rescale
from windflow_tpu_torch.core.tuples import Schema, batch_from_columns
from windflow_tpu_torch.core.windows import WinType
from windflow_tpu_torch.recovery.store import resolve_state
from windflow_tpu_torch.runtime.engine import Dataflow
from windflow_tpu_torch.runtime.farm import build_pipeline

SCHEMA = Schema(value=np.int64)


@pytest.fixture(autouse=True)
def _no_ambient_obs_env(monkeypatch):
    monkeypatch.delenv("WF_LOG_DIR", raising=False)
    monkeypatch.delenv("WF_SAMPLE_PERIOD", raising=False)


def keyed_batches(n_batches=40, rows=50, n_keys=5, seed=7):
    """Per-key dense ids / monotone ts — the pristine-source contract CB
    windows want (tests/test_recovery.py's stream)."""
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


def install_kill_point(node, kill_at: int, exc=RuntimeError):
    """Monkey-wrap ``node.svc`` to raise once on its ``kill_at``-th call
    — the transient-fault model (OOM, device error, preemption): the
    same batch succeeds when replayed (a copy of tests/test_recovery.py's
    helper)."""
    orig = node.svc
    state = {"n": 0, "fired": False}

    def svc(batch, channel=0):
        state["n"] += 1
        if not state["fired"] and state["n"] == kill_at:
            state["fired"] = True
            raise exc(f"injected crash at svc #{kill_at}")
        return orig(batch, channel)

    node.svc = svc
    return state


def find_node(df, prefix):
    nodes = [n for n in df.nodes if n.name.startswith(prefix)]
    assert nodes, f"no node named {prefix}* in {[n.name for n in df.nodes]}"
    return nodes[0]


def _device_pipe(W, out, recovery=None, **kw):
    """Source -> device WinSeq (sum, CB 8/4, batch_len 16) -> Sink, through
    the package ``W``: the port's WinSeqGPU on the CPU, or JAX's
    WinSeqTPU."""
    if W is wt:
        pattern = wt.WinSeqGPU(wt.Reducer("sum", "value"), win_len=8,
                               slide_len=4, batch_len=16, name="wtpu",
                               device="cpu", **kw)
        df = Dataflow("dev", capacity=8, recovery=recovery)
        build = build_pipeline
    else:
        from windflow_tpu.patterns.win_seq_tpu import WinSeqTPU
        from windflow_tpu.runtime.engine import Dataflow as JDataflow
        from windflow_tpu.runtime.farm import build_pipeline as jbuild
        pattern = WinSeqTPU(jx.Reducer("sum", "value"), win_len=8,
                            slide_len=4, batch_len=16, name="wtpu", **kw)
        df = JDataflow("dev", capacity=8, recovery=recovery)
        build = jbuild
    build(df, [
        W.Source(batches=lambda i: keyed_batches(n_batches=20), name="src"),
        pattern,
        W.Sink(lambda r: out.append((int(r["key"]), int(r["id"]),
                                     int(r["value"])))
               if r is not None else None, name="sink"),
    ])
    return df


def restarts(df):
    """Restarts the Supervisor authorised over the whole graph."""
    return sum(n._recov.restarts_used for n in df.nodes
               if n._recov is not None)


def _crash_differential(core_cls, kill_at, policy_kw=None, **kw):
    """The uncrashed port run, the crashed-and-restored port run (its
    window node's core checked to be ``core_cls``) and JAX's uncrashed
    run: all three equal row for row."""
    oracle = []
    _device_pipe(wt, oracle, **kw).run_and_wait_end(timeout=300)
    want = []
    _device_pipe(jx, want, **kw).run_and_wait_end(timeout=300)
    assert oracle == want
    got = []
    df = _device_pipe(wt, got, recovery=wt.RecoveryPolicy(
        epoch_batches=4, restart_backoff=0.01, **(policy_kw or {})), **kw)
    node = find_node(df, "wtpu")
    assert type(node.core).__name__ == core_cls
    kill = install_kill_point(node, kill_at)
    df.run_and_wait_end(timeout=300)
    assert kill["fired"], "kill point never reached"
    assert restarts(df) == 1
    assert got == oracle
    return node


def test_resident_core_crash_differential(monkeypatch):
    """Resident-ring core (WF_NO_NATIVE_CORE=1 pins the Python core): the
    epoch snapshot drains the launch queue and copies the ring into a
    RingSnapshot; the crash restores ring + host bookkeeping and replays
    to the uncrashed rows."""
    monkeypatch.setenv("WF_NO_NATIVE_CORE", "1")
    _crash_differential("ResidentWinSeqCore", 9)


def test_resident_core_crash_without_ring_snapshot(monkeypatch):
    """snapshot_rings=False restores by rebasing the ring from the
    host-live archive rows instead of the device-to-host copy."""
    monkeypatch.setenv("WF_NO_NATIVE_CORE", "1")
    _crash_differential("ResidentWinSeqCore", 13,
                        policy_kw={"snapshot_rings": False})


def test_restaging_core_crash_differential():
    """Segment-restaging core: no cross-launch device state, so the
    snapshot is the host bookkeeping plus a pre-snapshot drain."""
    _crash_differential("DeviceWinSeqCore", 9, use_resident=False)


def _require_state_abi():
    from windflow_tpu_torch.native import enabled
    lib = enabled()
    assert lib is not None, "the native library did not build"
    assert getattr(lib, "wf_has_state_abi", False), \
        "the native library lacks the state ABI"


def test_native_core_crash_differential():
    """The C++ core: the crash restores the native state blob (the state
    ABI) and replays to the uncrashed rows."""
    _require_state_abi()
    node = _crash_differential("NativeResidentCore", 9)
    assert node.core.has_state_abi


def test_ship_thread_failure_cancels_dataflow(monkeypatch):
    """A device failure inside a windowed node cancels the whole graph (no
    deadlock), like any node exception (runtime/engine.py)."""
    from windflow_tpu_torch.ops.resident import ResidentWindowExecutor

    def boom(self, *a, **kw):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(ResidentWindowExecutor, "launch", boom)
    monkeypatch.setattr(ResidentWindowExecutor, "launch_regular", boom)
    rng = np.random.default_rng(0)
    batches = []
    for lo in range(0, 300, 40):
        m = min(40, 300 - lo)
        ids = np.repeat(np.arange(lo, lo + m), 2)
        batches.append(batch_from_columns(
            SCHEMA, key=np.tile(np.arange(2), m), id=ids, ts=ids,
            value=rng.integers(-50, 100, size=2 * m)))
    df = Dataflow()
    build_pipeline(df, [wt.Source(batches=iter(batches), schema=SCHEMA),
                        wt.WinSeqGPU(wt.Reducer("sum"), 8, 4, WinType.CB,
                                     batch_len=8, flush_rows=32,
                                     device="cpu"),
                        wt.Sink(lambda r: None, vectorized=True)])
    assert type(find_node(df, "win_seq_gpu").core).__name__ == \
        "NativeResidentCore"
    with pytest.raises(RuntimeError, match="injected"):
        df.run_and_wait_end(timeout=120)


def _kf_device(W):
    if W is wt:
        return wt.KeyFarmGPU(wt.Reducer("sum", "value"), 4, 4, pardegree=2,
                             batch_len=64, name="kf", device="cpu")
    from windflow_tpu.patterns.win_seq_tpu import KeyFarmTPU
    return KeyFarmTPU(jx.Reducer("sum", "value"), 4, 4, pardegree=2,
                      batch_len=64, name="kf")


def _kf_pipe(W, out, **kw):
    pipe = W.MultiPipe("job", capacity=8, **kw)
    pipe.add_source(W.Source(batches=lambda i: keyed_batches(60, 50, 13),
                             name="src"))
    pipe.add(_kf_device(W))
    pipe.add_sink(W.Sink(lambda r: out.append(
        (int(r["key"]), int(r["id"]), int(r["value"])))
        if r is not None else None, name="sink"))
    return pipe


def per_key(rows):
    """(key, id, value) rows grouped by key, arrival order kept."""
    d = {}
    for k, i, v in rows:
        d.setdefault(k, []).append((i, v))
    return d


def test_crash_after_rescale_restores_migrated_placement():
    """A KeyFarmGPU of native cores rescaled 2 -> 4, then a worker crash:
    the restore takes the POST-migration snapshot and the run still equals
    the fixed-width run per key, in order, and JAX's KeyFarmTPU run."""
    _require_state_abi()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # WF207/WF209, int32 advisory
        oracle, want = [], []
        _kf_pipe(wt, oracle).run_and_wait_end(timeout=300)
        _kf_pipe(jx, want).run_and_wait_end(timeout=300)
        assert per_key(oracle) == per_key(want)
        got = []
        rule = Rescale("kf", max_workers=4, min_workers=1,
                       up_depth=10 ** 9, down_depth=-1, cooldown=10 ** 9)
        pipe = _kf_pipe(
            wt, got, control=ControlPolicy([rule], period=0.02),
            recovery=wt.RecoveryPolicy(epoch_batches=4,
                                       restart_backoff=0.01),
            metrics=True)
        df = pipe._build()
        workers = [n for n in df.nodes if n.name.startswith("kf.")
                   and "emitter" not in n.name and "collector" not in n.name]
        assert len(workers) == 4          # pre-provisioned to max_workers
        for w in workers:
            assert type(w.core).__name__ == "NativeResidentCore"
            assert w.core.keyed_migratable
        state = {"n": 0, "fired": False}
        for w in workers:
            orig = w.svc

            def svc(batch, channel=0, _o=orig):
                state["n"] += 1
                if not state["fired"] and state["n"] == 30:
                    state["fired"] = True
                    raise RuntimeError("injected crash post-rescale")
                return _o(batch, channel)

            w.svc = svc
        pipe.run()
        ctl = pipe.controller
        assert ctl.request_rescale("kf", 4)
        pipe.wait(timeout=300)
    assert state["fired"], "kill point never reached"
    assert [h[:2] for fc in ctl.farms for h in fc.history] == [(2, 4)]
    assert per_key(got) == per_key(oracle)


# ------------------------------------- snapshots hold no torch object


class _NoTorch(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "torch" or module.startswith("torch."):
            raise AssertionError(f"snapshot pickles {module}.{name}")
        return super().find_class(module, name)


def _no_torch_inside(obj):
    if isinstance(obj, torch.Tensor):
        raise AssertionError("a torch.Tensor in the resolved snapshot")
    if isinstance(obj, dict):
        for v in obj.values():
            _no_torch_inside(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _no_torch_inside(v)


def _snapshot_after(core, n_batches=6):
    """Feed a core a few batches, drain it at a barrier as the Supervisor
    does, and return its resolved snapshot round-tripped through a pickle
    that refuses every torch global."""
    for b in keyed_batches(n_batches=n_batches):
        core.process(b)
    if hasattr(core, "checkpoint_prepare"):
        core.checkpoint_prepare()
    if hasattr(core, "checkpoint_drain_batches"):
        core.checkpoint_drain_batches()
    state = resolve_state(core.state_snapshot())
    _no_torch_inside(state)
    blob = pickle.dumps(state)
    back = _NoTorch(io.BytesIO(blob)).load()
    _no_torch_inside(back)
    return back


def _core(**kw):
    return wt.WinSeqGPU(wt.Reducer("sum", "value"), 8, 4, batch_len=16,
                        device="cpu", **kw).make_core()


@pytest.mark.parametrize("snapshot_rings", [True, False])
def test_ring_snapshot_pickles_without_torch(monkeypatch, snapshot_rings):
    """The Python resident core's RingSnapshot resolves to numpy rings."""
    monkeypatch.setenv("WF_NO_NATIVE_CORE", "1")
    core = _core()
    assert type(core).__name__ == "ResidentWinSeqCore"
    core.snapshot_rings = snapshot_rings
    snap = _snapshot_after(core)
    ring = snap["ring"] if "ring" in snap else None
    if snapshot_rings:
        assert ring is not None and all(
            isinstance(r, np.ndarray) for r in ring["rings"])


def test_native_blob_pickles_without_torch():
    """The native core's snapshot is bytes blobs and an ABI number."""
    _require_state_abi()
    core = _core()
    assert type(core).__name__ == "NativeResidentCore"
    snap = _snapshot_after(core)
    assert snap["kind"] == "native"
    assert all(isinstance(b, bytes) for b in snap["blobs"])


def test_restaging_snapshot_pickles_without_torch():
    """The restaging core's snapshot is its host bookkeeping alone."""
    core = _core(use_resident=False)
    assert type(core).__name__ == "DeviceWinSeqCore"
    _snapshot_after(core)
