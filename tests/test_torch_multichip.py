"""Multi-device wiring of the port's patterns against the JAX package's —
twins of tests/test_multichip.py (and of test_resident.py's
test_multi_stat_mesh_matches_host): farm workers own one device each, and
the mesh executors (ops/resident.py MeshResidentExecutor,
MeshMultiFieldResidentExecutor) serve every key group of a launch.

JAX runs on its 8 virtual CPU devices (conftest.py).  The port's
counterpart is a list of CPU devices: ``cpu:0`` ... ``cpu:7`` where the
test tells devices apart (a torch CPU device may carry an index; its
tensors live in host memory all the same), else ``cpu`` repeated.  Every
stream here is integer, so results must be equal per key in order, every
column included.  Also: a JAX mesh core's snapshot carried into the port's
mesh core, which continues the stream equal to JAX."""

import warnings

import numpy as np
import pytest

import jax

from windflow_tpu.core.tuples import Schema, batch_from_columns
from windflow_tpu.core.windows import WindowSpec as JWindowSpec
from windflow_tpu.core.windows import WinType as JWinType
from windflow_tpu.ops.functions import MultiReducer as JMultiReducer
from windflow_tpu.ops.functions import Reducer as JReducer
from windflow_tpu.parallel.mesh import make_mesh as jmake_mesh
from windflow_tpu.patterns import win_seq_tpu as jw
import windflow_tpu_torch as wt
from windflow_tpu_torch.core.windows import WindowSpec
from windflow_tpu_torch.core.winseq import WinSeqCore
from windflow_tpu_torch.interop import carry_resident_state
from windflow_tpu_torch.ops import resident
from windflow_tpu_torch.ops.resident import (MeshMultiFieldResidentExecutor,
                                             MeshResidentExecutor)
from windflow_tpu_torch.parallel import make_mesh
from windflow_tpu_torch.patterns import win_seq_gpu as pw

from test_farms import cb_stream_batches, run_windowed, tb_stream_batches

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

KEYS, N = 8, 120
WIN, SLIDE = 12, 4
CPUS = [f"cpu:{i}" for i in range(8)]


def stream(kind):
    return (cb_stream_batches(KEYS, N) if kind == "cb"
            else tb_stream_batches(KEYS, N))


def wtype(kind, pkg):
    return getattr(pkg.WinType if pkg is wt else JWinType, kind.upper())


def port_mesh(n_kf, distinct=False):
    return make_mesh(n_kf=n_kf, devices=CPUS if distinct else ["cpu"] * 8)


def run_port(pattern, batches):
    """Source -> pattern -> Sink through the port; per-key ordered
    (id, ts, value), the shape test_farms.run_windowed returns."""
    per_key = {}

    def snk(row):
        if row is not None:
            per_key.setdefault(int(row["key"]), []).append(
                (int(row["id"]), int(row["ts"]), int(row["value"])))

    df = wt.Dataflow()
    wt.build_pipeline(df, [wt.Source(batches=iter(batches),
                                     schema=wt.Schema(value=np.int64)),
                           pattern, wt.Sink(snk)])
    df.run_and_wait_end()
    return per_key


def run_core(core, batches):
    outs = [core.process(b) for b in batches]
    outs.append(core.flush())
    outs = [o for o in outs if len(o)]
    return np.sort(np.concatenate(outs), order=["key", "id"])


def assert_rows_equal(got, want, fields):
    assert len(got) == len(want) > 0
    for f in fields:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def worker_devices(farm):
    """Every device owning a ring/executor across the farm's replicas."""
    devs = set()
    for r in farm.replicas():
        core = r.core
        ex = getattr(core, "executor", None)
        if ex is not None:
            devs.add(ex.device)
        for sub in getattr(core, "executors", []):
            devs.add(sub.device)
    return devs


def jax_worker_devices(farm):
    from test_multichip import worker_devices as jdevs
    return jdevs(farm)


# ------------------------------------------------------------ farm spread

@pytest.mark.parametrize("farm", ["kf", "wf"])
def test_farm_workers_spread_over_devices(farm):
    """pardegree 8 over 8 devices: one device a worker, in both."""
    jcls, pcls = ((jw.KeyFarmTPU, wt.KeyFarmGPU) if farm == "kf"
                  else (jw.WinFarmTPU, wt.WinFarmGPU))
    assert len(jax.devices()) == 8
    jfarm = jcls(JReducer("sum"), WIN, SLIDE, JWinType.CB, pardegree=8,
                 batch_len=16)
    pfarm = pcls(wt.Reducer("sum"), WIN, SLIDE, wt.WinType.CB, pardegree=8,
                 batch_len=16, device=CPUS)
    assert len(jax_worker_devices(jfarm)) == 8
    assert len(worker_devices(pfarm)) == 8


def test_farm_device_list_pins_workers():
    """An explicit device list spreads over exactly those devices."""
    pick = jax.devices()[:2]
    jfarm = jw.KeyFarmTPU(JReducer("sum"), WIN, SLIDE, JWinType.CB,
                          pardegree=4, batch_len=16, device=pick)
    assert jax_worker_devices(jfarm) == set(pick)
    pfarm = wt.KeyFarmGPU(wt.Reducer("sum"), WIN, SLIDE, wt.WinType.CB,
                          pardegree=4, batch_len=16, device=CPUS[:2])
    assert {str(d) for d in worker_devices(pfarm)} == set(CPUS[:2])


def test_farm_single_device_pins_all_workers():
    d = jax.devices()[3]
    jfarm = jw.KeyFarmTPU(JReducer("sum"), WIN, SLIDE, JWinType.CB,
                          pardegree=4, batch_len=16, device=d)
    assert jax_worker_devices(jfarm) == {d}
    pfarm = wt.KeyFarmGPU(wt.Reducer("sum"), WIN, SLIDE, wt.WinType.CB,
                          pardegree=4, batch_len=16, device="cpu:3")
    assert {str(d) for d in worker_devices(pfarm)} == {"cpu:3"}


@pytest.mark.parametrize("kind", ["cb", "tb"])
@pytest.mark.parametrize("farm", ["kf", "wf"])
def test_spread_farm_matches_seq(farm, kind):
    """An 8-worker farm spread over 8 devices gives the host Win_Seq's
    results per key in order, and JAX's."""
    jcls, pcls = ((jw.KeyFarmTPU, wt.KeyFarmGPU) if farm == "kf"
                  else (jw.WinFarmTPU, wt.WinFarmGPU))
    batches = stream(kind)
    ref = run_port(wt.WinSeq(wt.Reducer("sum"), WIN, SLIDE,
                             wtype(kind, wt)), batches)
    got = run_port(pcls(wt.Reducer("sum"), WIN, SLIDE, wtype(kind, wt),
                        pardegree=8, batch_len=16, device=CPUS), batches)
    want = run_windowed(jcls(JReducer("sum"), WIN, SLIDE, wtype(kind, jw),
                             pardegree=8, batch_len=16), batches)
    assert got == ref == want and len(got) == KEYS


# ---------------------------------------------------------- mesh-resident

@pytest.mark.parametrize("kind", ["cb", "tb"])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_mesh_resident_matches_seq(kind, op):
    """One WinSeqGPU whose rings are sharded over a 4-device kf mesh:
    results equal the host core's and the JAX mesh run's."""
    batches = stream(kind)
    ref = run_port(wt.WinSeq(wt.Reducer(op), WIN, SLIDE, wtype(kind, wt)),
                   batches)
    got = run_port(wt.WinSeqGPU(wt.Reducer(op), WIN, SLIDE, wtype(kind, wt),
                                batch_len=16, mesh=port_mesh(4)), batches)
    want = run_windowed(jw.WinSeqTPU(JReducer(op), WIN, SLIDE,
                                     wtype(kind, jw), batch_len=16,
                                     mesh=jmake_mesh(n_kf=4)), batches)
    assert got == ref == want


def test_mesh_resident_uses_all_mesh_devices():
    """Every mesh device holds live archive rows: the stride mapping (row
    r -> shard r % S) balances 8 keys over 8 shards, one key each."""
    core = wt.WinSeqGPU(wt.Reducer("sum"), WIN, SLIDE, wt.WinType.CB,
                        batch_len=16, mesh=port_mesh(8, True)).make_core()
    outs = [core.process(b) for b in stream("cb")]
    outs.append(core.flush())
    assert sum(len(o) for o in outs) > 0
    ex = core.executor
    assert isinstance(ex, MeshResidentExecutor) and ex._shards is not None
    assert {str(d) for d in ex.shard_devices} == set(CPUS)
    occupancy = [bool(rings[0].any()) for rings in ex._shards]
    assert all(occupancy), f"idle shards: {occupancy}"
    # the JAX ring's shards, the same way
    jcore = jw.WinSeqTPU(JReducer("sum"), WIN, SLIDE, JWinType.CB,
                         batch_len=16, mesh=jmake_mesh(n_kf=8)).make_core()
    for b in stream("cb"):
        jcore.process(b)
    jcore.flush()
    shards = list(jcore.executor._ring.addressable_shards)
    assert len({s.device for s in shards}) == 8
    assert all(bool(np.asarray(s.data).any()) for s in shards)


def test_mesh_resident_rejects_non_monoid():
    with pytest.raises(ValueError, match="resident-path Reducer"):
        jw.WinSeqTPU(JReducer("count"), WIN, SLIDE, JWinType.CB,
                     mesh=jmake_mesh(n_kf=2)).make_core()
    with pytest.raises(ValueError, match="resident-path Reducer"):
        wt.WinSeqGPU(wt.Reducer("count"), WIN, SLIDE, wt.WinType.CB,
                     mesh=port_mesh(2)).make_core()
    with pytest.raises(ValueError, match="requires the resident path"):
        wt.WinSeqGPU(wt.Reducer("sum"), WIN, SLIDE, wt.WinType.CB,
                     use_reduce_kernel=True, mesh=port_mesh(2)).make_core()


def test_mesh_resident_many_keys_rebase():
    """Key cardinality beyond the first ring forces rebases across the
    sharded rings (37 keys, not a multiple of the shard count)."""
    keys, n = 37, 60
    batches = cb_stream_batches(keys, n)
    ref = run_port(wt.WinSeq(wt.Reducer("sum"), 8, 8, wt.WinType.CB),
                   batches)
    got = run_port(wt.WinSeqGPU(wt.Reducer("sum"), 8, 8, wt.WinType.CB,
                                batch_len=8, flush_rows=64,
                                mesh=port_mesh(4)), batches)
    want = run_windowed(jw.WinSeqTPU(JReducer("sum"), 8, 8, JWinType.CB,
                                     batch_len=8, flush_rows=64,
                                     mesh=jmake_mesh(n_kf=4)), batches)
    assert got == ref == want


def _native_or_skip():
    from windflow_tpu_torch import native
    if native.enabled() is None:
        pytest.skip("native library unavailable")


def test_mesh_routes_through_native_core():
    """mesh= rides the C++ bookkeeping when the native library loads."""
    _native_or_skip()
    from windflow_tpu_torch.patterns.native_core import NativeResidentCore
    core = wt.WinSeqGPU(wt.Reducer("sum"), WIN, SLIDE, wt.WinType.CB,
                        mesh=port_mesh(4)).make_core()
    assert isinstance(core, NativeResidentCore)
    assert isinstance(core.executors[0], MeshResidentExecutor)
    jcore = jw.WinSeqTPU(JReducer("sum"), WIN, SLIDE, JWinType.CB,
                         mesh=jmake_mesh(n_kf=4)).make_core()
    assert type(jcore).__name__ == type(core).__name__


def multi_rows(mk, batches, mesh_kw, **kw):
    """The same MultiReducer stream through the port's mesh core, the JAX
    mesh core and the port's host core."""
    spec = (WIN, SLIDE)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pcore = pw.make_core_for(WindowSpec(*spec, wt.WinType.CB),
                                 mk(wt), mesh=port_mesh(4), **kw)
        jcore = jw.make_core_for(JWindowSpec(*spec, JWinType.CB), mk(jw),
                                 mesh=jmake_mesh(n_kf=4), **kw)
    return (pcore, run_core(pcore, batches), run_core(jcore, batches),
            run_core(WinSeqCore(WindowSpec(*spec, wt.WinType.CB), mk(wt)),
                     batches))


def _multi(*parts):
    return lambda pkg: (pkg.MultiReducer if pkg is wt else JMultiReducer)(
        *parts)


def test_mesh_multistat_matches_host():
    """sum + max over one field, plus count, on the sharded ring: every
    stat in one mesh dispatch."""
    mk = _multi(("count", None, "cnt"), ("sum", "value", "sm"),
                ("max", "value", "mx"))
    _core, got, want, host = multi_rows(mk, cb_stream_batches(11, 90), None,
                                        batch_len=16)
    fields = ("key", "id", "ts", "cnt", "sm", "mx")
    assert_rows_equal(got, host, fields)
    assert_rows_equal(got, want, fields)


def test_mesh_regular_descriptors_engage_and_match():
    """The native mesh core compresses steady CB windows into per-key
    arithmetic descriptors, dispatched by MeshResidentExecutor.
    launch_regular — asserted to engage, results equal the host core's."""
    _native_or_skip()
    calls = []
    orig = MeshResidentExecutor.launch_regular

    def counting(self, *a, **kw):
        calls.append(1)
        return orig(self, *a, **kw)

    MeshResidentExecutor.launch_regular = counting
    try:
        batches = stream("cb")
        ref = run_port(wt.WinSeq(wt.Reducer("sum"), WIN, SLIDE,
                                 wt.WinType.CB), batches)
        got = run_port(wt.WinSeqGPU(wt.Reducer("sum"), WIN, SLIDE,
                                    wt.WinType.CB, batch_len=16,
                                    flush_rows=128, mesh=port_mesh(4)),
                       batches)
    finally:
        MeshResidentExecutor.launch_regular = orig
    assert got == ref
    assert calls, "regular-descriptor mesh dispatch never engaged"


def two_field_batches(rows, keys, chunk, seed):
    schema = Schema(a=np.int64, b=np.int64)
    rng = np.random.default_rng(seed)
    batches = []
    for lo in range(0, rows, chunk):
        m = min(chunk, rows - lo)
        ids = np.repeat(np.arange(lo, lo + m), keys)
        batches.append(batch_from_columns(
            schema, key=np.tile(np.arange(keys), m), id=ids, ts=ids,
            a=rng.integers(0, 100, m * keys), b=rng.integers(0, 60, m * keys)))
    return batches


def test_mesh_multifield_matches_host():
    """Stats over two payload fields on per-field mesh-sharded rings
    (MeshMultiFieldResidentExecutor; the native _multi branch when the
    library loads, as in JAX)."""
    mk = _multi(("count", None, "cnt"), ("sum", "a", "sa"),
                ("max", "b", "mb"), ("min", "a", "na"))
    core, got, want, host = multi_rows(mk, two_field_batches(96, 11, 23, 17),
                                       None, batch_len=16)
    assert isinstance(core.executor, MeshMultiFieldResidentExecutor)
    from windflow_tpu_torch import native
    if native.enabled() is not None:
        from windflow_tpu_torch.patterns.native_core import \
            NativeResidentCore
        assert isinstance(core, NativeResidentCore) and core._multi
    fields = ("key", "id", "ts", "cnt", "sa", "mb", "na")
    assert_rows_equal(got, host, fields)
    assert_rows_equal(got, want, fields)


def test_mesh_torch_fn_matches_host():
    """A batched TorchWindowFunction over two fields on the mesh-sharded
    per-field rings (window_gather + the fn on every shard), against the
    JAX mesh's JaxWindowFunction and the host core."""
    import jax.numpy as jnp
    import torch
    from windflow_tpu_torch.ops.functions import WindowFunction

    schema = Schema(a=np.int64, b=np.int64)
    batches = []
    for lo in range(0, 72, 24):
        ids = np.repeat(np.arange(lo, lo + 24), 5)
        batches.append(batch_from_columns(
            schema, key=np.tile(np.arange(5), 24), id=ids, ts=ids,
            a=ids % 13, b=(ids * 5) % 7))

    class HostDot(WindowFunction):
        result_fields = {"dot": np.int64}
        required_fields = ("a", "b")

        def apply(self, key, gwid, rows):
            return (int((rows["a"] * rows["b"]).sum()),)

    pf = pw.TorchWindowFunction(
        lambda keys, gwids, cols, mask: (torch.sum(torch.where(
            mask, cols["a"] * cols["b"], 0), dim=1),),
        fields=("a", "b"), result_fields={"dot": np.int64})
    jf = jw.JaxWindowFunction(
        lambda keys, gwids, cols, mask: (jnp.sum(jnp.where(
            mask, cols["a"] * cols["b"], 0), axis=1),),
        fields=("a", "b"), result_fields={"dot": np.int64})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pcore = pw.make_core_for(WindowSpec(WIN, SLIDE, wt.WinType.CB), pf,
                                 mesh=port_mesh(4), batch_len=16)
        jcore = jw.make_core_for(JWindowSpec(WIN, SLIDE, JWinType.CB), jf,
                                 mesh=jmake_mesh(n_kf=4), batch_len=16)
    assert isinstance(pcore.executor, MeshMultiFieldResidentExecutor)
    got, want = run_core(pcore, batches), run_core(jcore, batches)
    host = run_core(WinSeqCore(WindowSpec(WIN, SLIDE, wt.WinType.CB),
                               HostDot()), batches)
    fields = ("key", "id", "ts", "dot")
    assert_rows_equal(got, host, fields)
    assert_rows_equal(got, want, fields)


def test_mesh_with_host_shards_matches_host():
    """Host key shards compose with the mesh: each shard's C++
    bookkeeping feeds its own mesh executor."""
    _native_or_skip()
    batches = cb_stream_batches(13, 110)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        core = pw.make_core_for(WindowSpec(WIN, SLIDE, wt.WinType.CB),
                                wt.Reducer("sum"), mesh=port_mesh(4),
                                shards=2, batch_len=16)
        jcore = jw.make_core_for(JWindowSpec(WIN, SLIDE, JWinType.CB),
                                 JReducer("sum"), mesh=jmake_mesh(n_kf=4),
                                 shards=2, batch_len=16)
    assert len(core.executors) == 2
    assert all(isinstance(ex, MeshResidentExecutor) for ex in core.executors)
    assert core.executors[0] is not core.executors[1]
    got = run_core(core, batches)
    host = run_core(WinSeqCore(WindowSpec(WIN, SLIDE, wt.WinType.CB),
                               wt.Reducer("sum")), batches)
    fields = ("key", "id", "ts", "value")
    assert_rows_equal(got, host, fields)
    assert_rows_equal(got, run_core(jcore, batches), fields)


def test_mesh_multifield_scatter_dispatch_economics():
    """256 keys over a 4-device kf mesh, ~100k rows, two payload fields:
    ONE dispatch a flush (not one a shard or a field), results equal to
    the vectorised host core and to JAX."""
    from windflow_tpu_torch.core.vecinc import VecIncSlidingCore
    NK, ROWS, CHUNK = 256, 98_304, 1 << 14
    per = CHUNK // NK
    batches = two_field_batches(ROWS // NK, NK, per, 23)
    mk = _multi(("sum", "a", "sa"), ("max", "b", "mb"))
    spec = WindowSpec(64, 16, wt.WinType.CB)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        core = pw.make_core_for(spec, mk(wt), mesh=port_mesh(4),
                                batch_len=1 << 12, flush_rows=1 << 15)
        assert isinstance(core.executor, MeshMultiFieldResidentExecutor)
        resident.stats_snapshot(reset=True)
        got = run_core(core, batches)
        diag = resident.stats_snapshot(reset=True)
        jcore = jw.make_core_for(JWindowSpec(64, 16, JWinType.CB), mk(jw),
                                 mesh=jmake_mesh(n_kf=4), batch_len=1 << 12,
                                 flush_rows=1 << 15)
        want = run_core(jcore, batches)
    flushes = -(-ROWS // (1 << 15))
    assert 1 <= diag["dispatches"] <= flushes + 2, diag
    host = run_core(VecIncSlidingCore(spec, mk(wt)), batches)
    assert_rows_equal(got, host, ("key", "id", "sa", "mb"))
    assert_rows_equal(got, want, ("key", "id", "ts", "sa", "mb"))


def test_multi_stat_mesh_matches_host():
    """count + max windows over a mesh-sharded ring (the twin of
    test_resident.py's test_multi_stat_mesh_matches_host)."""
    from test_torch_resident import cb_stream
    mk = _multi(("count", None, "n"), ("max", "value", "hi"))
    batches = cb_stream(7, 120)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pcore = pw.make_core_for(WindowSpec(8, 8, wt.WinType.CB), mk(wt),
                                 batch_len=8, mesh=port_mesh(4))
        jcore = jw.make_core_for(JWindowSpec(8, 8, JWinType.CB), mk(jw),
                                 batch_len=8, mesh=jmake_mesh(n_kf=4))
    got = run_core(pcore, batches)
    host = run_core(WinSeqCore(WindowSpec(8, 8, wt.WinType.CB), mk(wt)),
                    batches)
    assert_rows_equal(got, host, ("key", "id", "ts", "n", "hi"))
    assert_rows_equal(got, run_core(jcore, batches),
                      ("key", "id", "ts", "n", "hi"))


# ------------------------------------------- JAX mesh snapshot -> the port

@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("rings", [True, False])
def test_jax_mesh_snapshot_continues_on_port_mesh(kind, rings, monkeypatch):
    """Half the stream through JAX's Python mesh core, a drained snapshot
    carried into the port's mesh core (carry_resident_state: the sharded
    rings as one physical (KP, cap) array each), the rest through the
    port: the same rows, in order, as the JAX core over the whole stream.
    With `rings` the rings cross byte for byte."""
    monkeypatch.setenv("WF_NO_NATIVE", "1")
    if kind == "single":
        batches = cb_stream_batches(6, 400, chunk=31)
        jfn, pfn = JReducer("sum"), wt.Reducer("sum")
    else:
        batches = two_field_batches(300, 6, 29, 5)
        parts = (("sum", "a", "sa"), ("max", "b", "mb"))
        jfn, pfn = JMultiReducer(*parts), wt.MultiReducer(*parts)
    half = len(batches) // 2
    kw = dict(batch_len=24, flush_rows=80)
    jspec, pspec = (JWindowSpec(16, 4, JWinType.CB),
                    WindowSpec(16, 4, wt.WinType.CB))

    ref = jw.ResidentWinSeqCore(jspec, jfn, mesh=jmake_mesh(n_kf=4), **kw)
    want = []
    for b in batches:
        want += ref.process_batches(b)
    want += ref.flush_batches()

    jcore = jw.ResidentWinSeqCore(jspec, jfn, mesh=jmake_mesh(n_kf=4), **kw)
    jcore.snapshot_rings = rings
    got = []
    for b in batches[:half]:
        got += jcore.process_batches(b)
    got += jcore.checkpoint_drain_batches()
    snap = jcore.state_snapshot()

    pcore = pw.ResidentWinSeqCore(pspec, pfn, mesh=port_mesh(4, True), **kw)
    assert type(pcore.executor).__name__ == type(jcore.executor).__name__
    pcore.state_restore(carry_resident_state(snap))
    if rings:
        port_rings = pcore.executor.ring_snapshot().resolve()["rings"]
        jax_rings = snap["ring"].resolve()["rings"]
        assert [r.tobytes() for r in port_rings] == [
            np.asarray(r).tobytes() for r in jax_rings]
    for b in batches[half:]:
        got += pcore.process_batches(b)
    got += pcore.flush_batches()
    # the drain at the cut may regroup launches: the rows, in order, match
    assert np.concatenate(got).tobytes() == np.concatenate(want).tobytes()
