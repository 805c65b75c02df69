"""The port's NativeResidentCore (the same C++ bookkeeping of
native/wf_native.cpp, feeding the torch ResidentWindowExecutor on
device="cpu": the ring kernels' plain versions) against the JAX package's
NativeResidentCore on the same streams — twins of tests/test_native.py's
single-stat cases, plus the sum_test pipeline through both packages' entry
points.  Results must be byte-identical, every column and per-key order
included (integer streams only: the native core ships int64 columns)."""

import numpy as np
import pytest

from windflow_tpu.core.tuples import Schema, batch_from_columns
from windflow_tpu.core.windows import PatternConfig as JPatternConfig
from windflow_tpu.core.windows import Role as JRole
from windflow_tpu.core.windows import WindowSpec as JWindowSpec
from windflow_tpu.core.windows import WinType as JWinType
from windflow_tpu.ops.functions import Reducer as JReducer
import windflow_tpu_torch as wt
from windflow_tpu_torch.core.windows import PatternConfig, Role, WindowSpec
from windflow_tpu_torch.core.winseq import WinSeqCore
from windflow_tpu_torch.ops import ring as rk
from windflow_tpu_torch.ops.resident import ResidentWindowExecutor
from windflow_tpu_torch.patterns import win_seq_gpu as pw

native = pytest.importorskip("windflow_tpu_torch.native")
if not native.available():
    pytest.skip("native library unavailable", allow_module_level=True)

from windflow_tpu.patterns import native_core as jn  # noqa: E402
from windflow_tpu.patterns import win_seq_tpu as jw  # noqa: E402
from windflow_tpu_torch.patterns.native_core import (  # noqa: E402
    NativeResidentCore)

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

SCHEMA = Schema(value=np.int64)


@pytest.fixture(autouse=True)
def native_routing(monkeypatch):
    monkeypatch.delenv("WF_NO_NATIVE", raising=False)
    monkeypatch.delenv("WF_NO_NATIVE_CORE", raising=False)


def run_core(core, batches):
    outs = [core.process(b) for b in batches] + [core.flush()]
    outs = [o for o in outs if len(o)]
    if not outs:
        return np.zeros(0, dtype=core._result_dtype)
    return np.sort(np.concatenate(outs), order=["key", "id"])


def cb_stream(n_keys, per_key, chunk=37, seed=0, lo_val=-50, hi_val=100):
    rng = np.random.default_rng(seed)
    batches = []
    for lo in range(0, per_key, chunk):
        m = min(chunk, per_key - lo)
        ids = np.repeat(np.arange(lo, lo + m), n_keys)
        keys = np.tile(np.arange(n_keys), m)
        vals = rng.integers(lo_val, hi_val, size=m * n_keys).astype(np.int64)
        batches.append(batch_from_columns(
            SCHEMA, key=keys, id=ids, ts=ids, value=vals))
    return batches


def specs(win, slide, kind="CB"):
    return (WindowSpec(win, slide, getattr(wt.WinType, kind)),
            JWindowSpec(win, slide, getattr(JWinType, kind)))


def pair(win, slide, op="sum", kind="CB", jkw=None, pkw=None, **kw):
    """(port core, JAX core): NativeResidentCore of each package."""
    pspec, jspec = specs(win, slide, kind)
    pcore = NativeResidentCore(pspec, wt.Reducer(op), device="cpu", **kw,
                               **(pkw or {}))
    jcore = jn.NativeResidentCore(jspec, JReducer(op), **kw, **(jkw or {}))
    return pcore, jcore


def assert_identical(got, want):
    assert got.dtype == want.dtype and len(got) == len(want)
    assert got.tobytes() == want.tobytes()


def assert_pair_matches(pcore, jcore, batches):
    got = run_core(pcore, batches)
    assert_identical(got, run_core(jcore, batches))
    return got


def test_native_is_default_selection(monkeypatch):
    """With the native library, the default route of a builtin sum is the
    C++ core; WF_NO_NATIVE=1 takes the Python resident core; the kernel
    switch keeps the restaging core."""
    pspec, _ = specs(16, 4)
    core = pw.make_core_for(pspec, wt.Reducer("sum"), device="cpu")
    assert isinstance(core, NativeResidentCore)
    assert isinstance(core.executor, ResidentWindowExecutor)
    assert isinstance(pw.make_core_for(pspec, wt.Reducer("sum"), device="cpu",
                                       use_reduce_kernel=True),
                      pw.DeviceWinSeqCore)
    monkeypatch.setenv("WF_NO_NATIVE", "1")
    assert isinstance(pw.make_core_for(pspec, wt.Reducer("sum"),
                                       device="cpu"),
                      pw.ResidentWinSeqCore)


@pytest.mark.parametrize("op", ["sum", "min", "max", "prod"])
@pytest.mark.parametrize("win,slide", [(16, 4), (8, 8), (4, 12)])
@pytest.mark.parametrize("n_keys", [1, 5])
def test_native_cb_matches_host(op, win, slide, n_keys):
    lo, hi = (1, 3) if op == "prod" else (-50, 100)
    batches = cb_stream(n_keys, 503, seed=win * 31 + slide, lo_val=lo,
                        hi_val=hi)
    got = assert_pair_matches(*pair(win, slide, op, batch_len=64,
                                    flush_rows=200), batches)
    if op != "prod":   # the device path's int32 products wrap
        pspec, _ = specs(win, slide)
        assert_identical(got, run_core(WinSeqCore(pspec, wt.Reducer(op)),
                                       batches))


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("win,slide", [(20, 5), (10, 10), (6, 16)])
def test_native_tb_matches_host(op, win, slide):
    rng = np.random.default_rng(win + slide)
    nk, per = 3, 400
    ts_all = np.sort(rng.integers(0, 900, size=per))
    batches = []
    for lo in range(0, per, 53):
        m = min(53, per - lo)
        batches.append(batch_from_columns(
            SCHEMA, key=np.tile(np.arange(nk), m),
            id=np.repeat(np.arange(lo, lo + m), nk),
            ts=np.repeat(ts_all[lo:lo + m], nk),
            value=rng.integers(0, 100, size=m * nk).astype(np.int64)))
    assert_pair_matches(*pair(win, slide, op, "TB", batch_len=32,
                              flush_rows=150), batches)


@pytest.mark.parametrize("role,cfg", [
    ("PLQ", (0, 1, 8, 1, 2, 8)),
    ("MAP", (0, 1, 8, 0, 1, 8)),
    ("WLQ", (1, 2, 8, 0, 1, 8)),
])
def test_native_role_renumbering(role, cfg):
    batches = cb_stream(3, 300, chunk=29, seed=7)
    pcore, jcore = pair(
        8, 8, batch_len=32, flush_rows=100, map_indexes=(1, 3),
        pkw=dict(config=PatternConfig(*cfg), role=getattr(Role, role)),
        jkw=dict(config=JPatternConfig(*cfg), role=getattr(JRole, role)))
    assert_pair_matches(pcore, jcore, batches)


def test_native_regular_descriptors_engage(monkeypatch):
    """Steady-state CB sliding windows take the regular-descriptor launch
    (the fused ring_append_regular_sum kernel's path) and still match."""
    calls = []
    orig = ResidentWindowExecutor.launch_regular

    def counting(self, *a, **kw):
        calls.append(1)
        return orig(self, *a, **kw)

    monkeypatch.setattr(ResidentWindowExecutor, "launch_regular", counting)
    before = (rk.ring_append.launches, rk.ring_append_regular_sum.launches)
    assert_pair_matches(*pair(16, 4, batch_len=64, flush_rows=250),
                        cb_stream(4, 800, chunk=100, seed=31))
    assert calls, "regular-descriptor path never engaged"
    # CPU tensors ran the plain versions: no kernel launch was counted
    assert (rk.ring_append.launches,
            rk.ring_append_regular_sum.launches) == before


def test_native_out_of_order_drops():
    rng = np.random.default_rng(13)
    ids = np.arange(200)
    ids[50] = 10       # a late row mid-stream
    ids[120] = 100
    b = batch_from_columns(SCHEMA, key=np.zeros(200), id=ids, ts=ids,
                           value=rng.integers(0, 50, size=200))
    assert_pair_matches(*pair(12, 4, batch_len=16, flush_rows=64), [b])


def test_native_markers_and_empty_flush():
    from windflow_tpu.core.tuples import MARKER_FIELD
    b = batch_from_columns(SCHEMA, key=np.zeros(20), id=np.arange(20),
                           ts=np.arange(20) * 10,
                           value=np.ones(20, dtype=np.int64))
    m = batch_from_columns(SCHEMA, key=np.zeros(1), id=[40], ts=[400],
                           value=[0])
    m[MARKER_FIELD] = True
    assert_pair_matches(*pair(8, 4, batch_len=8, flush_rows=32), [b, m])


def test_native_falls_back_on_float_payload():
    """A float payload switches to the Python resident core."""
    schema = Schema(value=np.float64)
    b = batch_from_columns(schema, key=np.zeros(10), id=np.arange(10),
                           ts=np.arange(10),
                           value=np.arange(10, dtype=np.float64))
    pcore, jcore = pair(4, 2, "max", batch_len=8, flush_rows=32)
    got = assert_pair_matches(pcore, jcore, [b])
    assert isinstance(pcore._delegate, pw.ResidentWinSeqCore)
    pspec, _ = specs(4, 2)
    want = run_core(WinSeqCore(pspec, wt.Reducer("max")), [b])
    np.testing.assert_array_equal(got["value"], want["value"])


def test_native_wide_values_use_int32_wire():
    batches = cb_stream(2, 256, seed=5, lo_val=-40000, hi_val=40000)
    pcore, jcore = pair(16, 4, batch_len=64, flush_rows=300)
    wires = []
    real = pcore.executor.launch_regular

    def spy(meta, blk, *a, **k):
        wires.append(blk.dtype)
        return real(meta, blk, *a, **k)

    pcore.executor.launch_regular = spy
    assert_pair_matches(pcore, jcore, batches)
    assert np.dtype(np.int32) in wires


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("shards", [1, 3])
def test_native_overlap_and_shards_match_host(overlap, shards):
    batches = cb_stream(5, 400, chunk=41, seed=29)
    assert_pair_matches(*pair(12, 4, batch_len=32, flush_rows=120,
                              shards=shards, overlap=overlap), batches)


def test_native_hopping_gaps():
    assert_pair_matches(*pair(4, 10, batch_len=16, flush_rows=100),
                        cb_stream(2, 300, chunk=41, seed=21))


def _count_merges(core, merges):
    real = core._lib

    class _Shim:
        def __getattr__(self, name):
            if name != "wf_launch_coalesce":
                return getattr(real, name)

            def counting(h, cells, mx, mult):
                n = real.wf_launch_coalesce(h, cells, mx, mult)
                merges.append(n)
                return n
            return counting

    core._lib = _Shim()


def test_native_launch_coalescing_matches_host():
    """Many small queued launches fuse into fewer dispatches on the port's
    executor too; results stay byte-identical."""
    pcore, jcore = pair(16, 4, batch_len=1 << 20, flush_rows=64,
                        overlap=False)
    merges = []
    _count_merges(pcore, merges)
    assert_pair_matches(pcore, jcore, cb_stream(5, 2000, chunk=997, seed=9))
    assert sum(merges) > 0, "wf_launch_coalesce never merged a pair"


def test_native_deep_coalescing_ladder():
    """With the launches reported slow (mean service >= 50 ms), the buddy
    ladder opens up to 16x and the dispatch count drops below the 4x cap's
    floor, with results still identical."""
    batches = cb_stream(4, 20000, chunk=2048, seed=5)
    pcore, jcore = pair(16, 4, batch_len=1 << 20, flush_rows=256,
                        overlap=False)
    dispatches = []
    for ex in pcore.executors:
        ex.mean_service_s = lambda: 1.0
        orig_r, orig_i = ex.launch_regular, ex.launch

        def count_r(*a, _f=orig_r, **kw):
            dispatches.append("r")
            return _f(*a, **kw)

        def count_i(*a, _f=orig_i, **kw):
            dispatches.append("i")
            return _f(*a, **kw)
        ex.launch_regular, ex.launch = count_r, count_i
    for ex in jcore.executors:
        ex.mean_service_s = lambda: 1.0
    assert_pair_matches(pcore, jcore, batches)
    assert len(dispatches) < (4 * 20000 // 256) // 4


def test_native_rebase_launches_never_merge():
    """A rebase launch is a dispatch barrier: queue exactly [rebase,
    regular] and coalesce — nothing merges, and the port drains the pair
    to the host core's results."""
    pspec, _ = specs(8, 4)
    nat = NativeResidentCore(pspec, wt.Reducer("sum"), device="cpu",
                             batch_len=1 << 20, flush_rows=4096,
                             overlap=False)
    lib, h = nat._lib, nat._hs[0]
    first = cb_stream(2, 64, chunk=64, seed=1)[0]
    second = batch_from_columns(SCHEMA, key=np.tile(np.arange(2), 64),
                                id=np.repeat(np.arange(64, 128), 2),
                                ts=np.repeat(np.arange(64, 128), 2),
                                value=np.ones(128, dtype=np.int64))
    itemsize, o_key, o_id, o_ts, o_mk, o_val = nat._field_offsets(first)
    for b in (first, second):
        bb = np.ascontiguousarray(b)
        lib.wf_cores_process_mt(nat._harr, 1, bb.ctypes.data, len(bb),
                                itemsize, o_key, o_id, o_ts, o_mk, o_val)
        lib.wf_core_force_flush(h)
    assert lib.wf_launch_pending(h) == 2
    assert lib.wf_launch_coalesce(h, 1 << 24, 16, 16) == 0
    assert lib.wf_launch_pending(h) == 2
    host = run_core(WinSeqCore(pspec, wt.Reducer("sum")), [first, second])
    assert_identical(run_core(nat, []), host)


def _dense_stream(n_batches=12, rows=40, n_keys=5, seed=3):
    """Per-key dense ids / monotone ts (the pristine-source contract)."""
    rng = np.random.default_rng(seed)
    ctr = {}
    out = []
    for _ in range(n_batches):
        b = np.zeros(rows, dtype=SCHEMA.dtype())
        keys = rng.integers(0, n_keys, rows)
        b["key"] = keys
        b["value"] = rng.integers(-50, 100, rows)
        for i, k in enumerate(keys.tolist()):
            b["id"][i] = ctr.get(k, 0)
            ctr[k] = ctr.get(k, 0) + 1
        b["ts"] = b["id"]
        out.append(b)
    return out


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_native_state_roundtrip_byte_identical(shards):
    """A JAX native core drains and snapshots at a barrier; a FRESH port
    core restores the blob (the same .so made it) and replays the tail.
    The emission stream equals the JAX core's uninterrupted one byte for
    byte, batch boundaries included."""
    batches = _dense_stream()
    cut = 6
    kw = dict(batch_len=32, flush_rows=64, shards=shards,
              overlap=(shards > 1))

    def run(core, bs):
        out = []
        for b in bs:
            out.extend(core.process_batches(b))
        return out

    a = pair(8, 4, **kw)[1]
    out_a = run(a, batches[:cut])
    out_a.extend(a.checkpoint_drain_batches())
    out_a.extend(run(a, batches[cut:]))
    out_a.extend(a.flush_batches())

    b = pair(8, 4, **kw)[1]
    out_b = run(b, batches[:cut])
    out_b.extend(b.checkpoint_drain_batches())
    snap = b.state_snapshot()
    r = pair(8, 4, **kw)[0]          # the restarted worker, in the port
    r.state_restore(snap.resolve())  # the stored form: bytes per shard
    out_b.extend(run(r, batches[cut:]))
    out_b.extend(r.flush_batches())

    assert [x.tobytes() for x in out_a] == [x.tobytes() for x in out_b]


def sum_test_stream(n_keys=64, per_key=1024, chunk_rows=1 << 14, seed=7):
    """bench.py's make_stream shape at 64 keys x 64K tuples."""
    rng = np.random.default_rng(seed)
    step = chunk_rows // n_keys
    out = []
    for lo in range(0, per_key, step):
        m = min(step, per_key - lo)
        ids = np.repeat(np.arange(lo, lo + m), n_keys)
        out.append(batch_from_columns(
            SCHEMA, key=np.tile(np.arange(n_keys), m), id=ids, ts=ids,
            value=rng.integers(0, 100, size=m * n_keys).astype(np.int64)))
    return out


def run_pipeline(pkg, pattern, batches):
    """Source -> pattern -> Sink in `pkg`; rows per key, as bytes."""
    kept = []

    def consume(rows):
        if rows is not None and len(rows):
            kept.append(rows.copy())

    df = pkg.Dataflow()
    pkg.build_pipeline(df, [pkg.Source(batches=iter(batches), schema=SCHEMA),
                            pattern, pkg.Sink(consume, vectorized=True)])
    df.run_and_wait_end()
    rows = np.concatenate(kept)
    return {int(k): rows[rows["key"] == k].tobytes()
            for k in np.unique(rows["key"])}


@pytest.mark.parametrize("flush_rows", [1 << 19, 1 << 12])
def test_sum_test_pipeline_matches_jax(flush_rows):
    """The headline pipeline through both packages' entry points with
    bench.py's settings (flush_rows 2**19: one launch at this size; 2**12:
    regular launches and rebases)."""
    from types import SimpleNamespace
    from windflow_tpu.patterns.basic import Sink, Source
    from windflow_tpu.runtime.engine import Dataflow
    from windflow_tpu.runtime.farm import build_pipeline
    japi = SimpleNamespace(Dataflow=Dataflow, build_pipeline=build_pipeline,
                           Source=Source, Sink=Sink)
    batches = sum_test_stream()
    kw = dict(batch_len=1 << 15, flush_rows=flush_rows, depth=48, shards=1)
    jstage = jw.WinSeqTPU(JReducer("sum", value_range=(0, 100)), 256, 64,
                          JWinType.CB, **kw)
    pstage = wt.WinSeqGPU(wt.Reducer("sum", value_range=(0, 100)), 256, 64,
                          wt.WinType.CB, device="cpu", **kw)
    assert isinstance(pstage.make_core(), NativeResidentCore)
    got = run_pipeline(wt, pstage, batches)
    want = run_pipeline(japi, jstage, batches)
    assert got == want and len(got) == 64
