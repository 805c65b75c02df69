"""Whole pipelines through both packages on the same streams: the JAX
package's WinSeqTPU(..., use_pallas=True) (the Pallas kernel in interpret
mode) against the port's WinSeqGPU(..., use_reduce_kernel=True,
device="cpu") (the kernel's plain version).  Integer streams: results must
be identical, per-key order included.  Also: routing, device resolution,
and carrying a JAX core's window state into the port mid-stream."""

import warnings

import numpy as np
import pytest

from windflow_tpu.core.windows import WindowSpec as JaxWindowSpec
from windflow_tpu.core.windows import WinType as JaxWinType
from windflow_tpu.ops.functions import Reducer as JaxReducer
from windflow_tpu.patterns.win_seq_tpu import KeyFarmTPU, WinFarmTPU, WinSeqTPU
from windflow_tpu.patterns.win_seq_tpu import make_core_for as jax_make_core
import windflow_tpu_torch as wt
from windflow_tpu_torch.core.windows import WindowSpec
from windflow_tpu_torch.interop import carry_core_state
from windflow_tpu_torch.patterns.win_seq_gpu import (DeviceWinSeqCore,
                                                     make_core_for)

from test_farms import cb_stream_batches, run_windowed, tb_stream_batches

pytestmark = [
    pytest.mark.filterwarnings(
        "ignore:device path downcasts int64:UserWarning"),
    pytest.mark.filterwarnings(
        "ignore:resident device path accumulates:UserWarning")]


def run_port(pattern, batches):
    """Source -> pattern -> Sink through the port; per-key ordered
    (id, ts, value) results, the shape test_farms.run_windowed returns."""
    per_key = {}

    def snk(row):
        if row is not None:
            per_key.setdefault(int(row["key"]), []).append(
                (int(row["id"]), int(row["ts"]), int(row["value"])))

    schema = wt.Schema(value=np.int64)
    df = wt.Dataflow()
    wt.build_pipeline(df, [wt.Source(batches=iter(batches), schema=schema),
                           pattern, wt.Sink(snk)])
    df.run_and_wait_end()
    return per_key


def both(op, win, slide, wt_name, batches, batch_len):
    jax_got = run_windowed(
        WinSeqTPU(JaxReducer(op), win, slide, getattr(JaxWinType, wt_name),
                  batch_len=batch_len, use_pallas=True), batches)
    port_got = run_port(
        wt.WinSeqGPU(wt.Reducer(op), win, slide, getattr(wt.WinType, wt_name),
                     batch_len=batch_len, use_reduce_kernel=True,
                     device="cpu"), batches)
    return port_got, jax_got


@pytest.mark.parametrize("win,slide", [(8, 3), (8, 8), (3, 8), (16, 7)])
@pytest.mark.parametrize("batch_len", [1, 7, 64, 100000])
def test_cb_matches_jax(win, slide, batch_len):
    port_got, jax_got = both("sum", win, slide, "CB",
                             cb_stream_batches(3, 150), batch_len)
    assert port_got == jax_got and len(port_got) == 3


@pytest.mark.parametrize("win,slide", [(40, 15), (30, 30), (15, 40)])
def test_tb_ragged_matches_jax(win, slide):
    port_got, jax_got = both("sum", win, slide, "TB",
                             tb_stream_batches(2, 160), 32)
    assert port_got == jax_got


@pytest.mark.parametrize("op", ["sum", "count", "min", "max", "prod"])
def test_builtin_ops_match_jax(op):
    batches = cb_stream_batches(2, 100)
    port_got, jax_got = both(op, 10, 4, "CB", batches, 16)
    assert port_got == jax_got
    if op != "prod":   # the device path's int32 products wrap; the host's
        host = run_port(wt.WinSeq(wt.Reducer(op), 10, 4, wt.WinType.CB),
                        batches)   # int64 ones do not
        assert port_got == host


def sum_test_stream(n_keys=8, per_key=600, chunk_rows=512, seed=7):
    """bench.py's make_stream shape at a small size: per-key ordered ids,
    values 0..99 from a seeded generator."""
    rng = np.random.default_rng(seed)
    step = chunk_rows // n_keys
    out = []
    for lo in range(0, per_key, step):
        m = min(step, per_key - lo)
        ids = np.repeat(np.arange(lo, lo + m), n_keys)
        keys = np.tile(np.arange(n_keys), m)
        vals = rng.integers(0, 100, size=m * n_keys).astype(np.int64)
        out.append(wt.batch_from_columns(wt.Schema(value=np.int64), key=keys,
                                         id=ids, ts=ids, value=vals))
    return out


def test_sum_test_shaped_stream_matches_jax():
    port_got, jax_got = both("sum", 16, 4, "CB", sum_test_stream(), 64)
    assert port_got == jax_got and len(port_got) == 8
    # every opened window fires: (600 - 1) // 4 + 1 per key
    assert all(len(v) == 150 for v in port_got.values())


def test_device_none_raises_without_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wt.WinSeqGPU(wt.Reducer("sum"), 4, 2, use_reduce_kernel=True
                     ).make_core()


def test_routing_keeps_jax_decisions():
    spec = WindowSpec(16, 4, wt.WinType.CB)
    # host-free count goes to the host core, as in the JAX package
    assert not isinstance(make_core_for(spec, wt.Reducer("count"),
                                        device="cpu"), DeviceWinSeqCore)
    # the kernel switch pins a Reducer to the restaging core
    assert isinstance(make_core_for(spec, wt.Reducer("sum"), device="cpu",
                                    use_reduce_kernel=True), DeviceWinSeqCore)
    # float sums stay on the restaging core without the switch
    assert isinstance(make_core_for(spec, wt.Reducer("sum", dtype=np.float64),
                                    device="cpu"), DeviceWinSeqCore)
    # a builtin sum takes the resident route by default, as in the JAX
    # package (the C++ core when the native library loads)
    assert isinstance(make_core_for(spec, wt.Reducer("sum"), device="cpu"),
                      (wt.NativeResidentCore, wt.ResidentWinSeqCore))
    # a mesh takes the resident route with its rings sharded over the kf
    # axis, the core class JAX's routing picks, and its results
    from windflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from windflow_tpu_torch.ops.resident import MeshResidentExecutor
    from windflow_tpu_torch.parallel import make_mesh
    mesh_core = make_core_for(spec, wt.Reducer("sum"), batch_len=16,
                              mesh=make_mesh(n_kf=2, devices=["cpu"] * 2))
    jax_core = jax_make_core(JaxWindowSpec(16, 4, JaxWinType.CB),
                             JaxReducer("sum"), batch_len=16,
                             mesh=jax_make_mesh(n_kf=2))
    assert isinstance(mesh_core.executors[0] if hasattr(
        mesh_core, "executors") else mesh_core.executor, MeshResidentExecutor)
    assert type(mesh_core).__name__ == type(jax_core).__name__
    batches = sum_test_stream(n_keys=5, per_key=120, chunk_rows=64)
    assert per_key([mesh_core.process(b) for b in batches]
                   + [mesh_core.flush()]) == per_key(
        [jax_core.process(b) for b in batches] + [jax_core.flush()])
    with pytest.raises(TypeError, match="cannot be staged"):
        make_core_for(spec, lambda k, g, rows: 0, device="cpu",
                      use_reduce_kernel=True)


def per_key(arrays):
    out = {}
    for a in arrays:
        for r in a:
            out.setdefault(int(r["key"]), []).append(
                (int(r["id"]), int(r["ts"]), int(r["value"])))
    return out


@pytest.mark.parametrize("op", ["sum", "max"])
def test_carry_core_state_continues_jax_run(op):
    """Half the stream through the JAX core, a post-drain snapshot carried
    into the port, the rest through the port: the same output as the JAX
    core over the whole stream."""
    batches = sum_test_stream(n_keys=4, per_key=400, chunk_rows=64)
    half = len(batches) // 2
    kw = dict(batch_len=32)
    jspec = JaxWindowSpec(16, 4, JaxWinType.CB)

    ref = jax_make_core(jspec, JaxReducer(op), use_pallas=True, **kw)
    want = [ref.process(b) for b in batches] + [ref.flush()]

    jcore = jax_make_core(jspec, JaxReducer(op), use_pallas=True, **kw)
    got = [jcore.process(b) for b in batches[:half]]
    got += jcore.checkpoint_drain_batches()
    snap = jcore.state_snapshot()

    pcore = make_core_for(WindowSpec(16, 4, wt.WinType.CB), wt.Reducer(op),
                          device="cpu", use_reduce_kernel=True, **kw)
    pcore.state_restore(carry_core_state(snap))
    assert type(next(iter(pcore._keys.values()))).__module__.startswith(
        "windflow_tpu_torch.")
    got += [pcore.process(b) for b in batches[half:]] + [pcore.flush()]
    assert per_key(got) == per_key(want)
    assert sum(len(v) for v in per_key(got).values()) == 4 * 100


@pytest.mark.parametrize("use_resident", [None, False])
@pytest.mark.parametrize("farm,pardegree", [("win", 2), ("win", 3),
                                            ("key", 2), ("key", 4)])
def test_device_farms_match_jax(farm, pardegree, use_resident):
    """WinFarmGPU/KeyFarmGPU (the host farms with a device core per
    worker) against WinFarmTPU/KeyFarmTPU: the default route (resident
    rings) and the restaging route (use_resident=False), per-key order
    included."""
    keys = 3 if farm == "win" else 5
    n = 140 if farm == "win" else 120
    batches = cb_stream_batches(keys, n)
    jcls, pcls = ((WinFarmTPU, wt.WinFarmGPU) if farm == "win"
                  else (KeyFarmTPU, wt.KeyFarmGPU))
    jax_got = run_windowed(jcls(JaxReducer("sum"), 10, 4, JaxWinType.CB,
                                pardegree=pardegree, batch_len=16,
                                use_resident=use_resident), batches)
    port_got = run_port(pcls(wt.Reducer("sum"), 10, 4, wt.WinType.CB,
                             pardegree=pardegree, batch_len=16,
                             use_resident=use_resident, device="cpu"),
                        batches)
    assert port_got == jax_got and len(port_got) == keys
    host = run_port(wt.WinSeq(wt.Reducer("sum"), 10, 4, wt.WinType.CB),
                    batches)
    assert port_got == host


def test_device_farm_workers_each_own_an_executor():
    """Every farm worker builds its own device core (and so its own
    executor and stream), placed by resolve_worker_device."""
    farm = wt.WinFarmGPU(wt.Reducer("sum"), 10, 4, wt.WinType.CB,
                         pardegree=3, use_resident=False,
                         device=["cpu", "cpu"])
    cores = [farm._make_core(w, i) for i, w in enumerate(farm._workers)]
    assert all(isinstance(c, DeviceWinSeqCore) for c in cores)
    assert len({id(c.executor) for c in cores}) == 3


def test_multipipe_matches_jax_and_refuses_unported_layers():
    """The carried MultiPipe composes Source -> WinFarmGPU -> Sink like the
    JAX package's, and takes every layer's knob as JAX's does (the name is
    kept from when federate=, whose layer the port then lacked, raised)."""
    from windflow_tpu.api import MultiPipe as JaxMultiPipe
    from windflow_tpu.core.tuples import Schema as JaxSchema
    from windflow_tpu.patterns.basic import Sink as JaxSink
    from windflow_tpu.patterns.basic import Source as JaxSource
    batches = cb_stream_batches(3, 120)
    outs = []
    for mp, src, farm, snk, schema, red, wtype, kw in (
            (wt.MultiPipe, wt.Source, wt.WinFarmGPU, wt.Sink,
             wt.Schema(value=np.int64), wt.Reducer, wt.WinType,
             dict(device="cpu")),
            (JaxMultiPipe, JaxSource, WinFarmTPU, JaxSink,
             JaxSchema(value=np.int64), JaxReducer, JaxWinType, {})):
        got = []
        pipe = (mp("p").add_source(src(batches=iter(batches), schema=schema))
                .add(farm(red("sum"), 10, 4, wtype.CB, pardegree=2,
                          batch_len=16, **kw))
                .chain_sink(snk(lambda r: got.append(r.copy())
                                if r is not None and len(r) else None,
                                vectorized=True)))
        pipe.run_and_wait_end()
        rows = np.concatenate(got)
        outs.append(np.sort(rows, order=["key", "id"]).tobytes())
    assert outs[0] == outs[1]
    assert (wt.MultiPipe("p", federate=True).federate
            == JaxMultiPipe("p", federate=True).federate is True)
    from windflow_tpu_torch.control import Admission, ControlPolicy
    ctl = ControlPolicy([Admission(max_rate=10, min_rate=1, high_depth=8,
                                   low_depth=2)])
    p = wt.MultiPipe("p", check="warn", control=ctl, trace=0.5)
    assert (p.check, p.control, p.trace) == ("warn", ctl, 0.5)
