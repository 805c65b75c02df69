"""The port's Python resident core (patterns/win_seq_gpu.py
ResidentWinSeqCore over the torch ResidentWindowExecutor, device="cpu":
the ring kernels' plain versions) against the JAX package's
ResidentWinSeqCore on the same streams — twins of tests/test_resident.py's
single-ring cases.  Integer results must be byte-identical, every column
and per-key order included; float32 sums (reachable only with
use_resident=True) are held within rtol=1e-5 of the sum of |x| over the
row's ring prefix, the rounding XLA's cumsum difference carries.

Both packages are pinned to their Python resident core here (WF_NO_NATIVE=1);
the C++ core has its own twins (test_torch_native_core.py)."""

import time

import numpy as np
import pytest

from windflow_tpu.core.tuples import Schema, batch_from_columns
from windflow_tpu.core.windows import PatternConfig as JPatternConfig
from windflow_tpu.core.windows import Role as JRole
from windflow_tpu.core.windows import WindowSpec as JWindowSpec
from windflow_tpu.core.windows import WinType as JWinType
from windflow_tpu.ops.functions import MultiReducer as JMultiReducer
from windflow_tpu.ops.functions import Reducer as JReducer
from windflow_tpu.patterns import win_seq_tpu as jw
import windflow_tpu_torch as wt
from windflow_tpu_torch.core.windows import PatternConfig, Role, WindowSpec
from windflow_tpu_torch.core.winseq import WinSeqCore
from windflow_tpu_torch.interop import carry_resident_state
from windflow_tpu_torch.ops.resident import ResidentWindowExecutor
from windflow_tpu_torch.patterns import win_seq_gpu as pw

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

SCHEMA = Schema(value=np.int64)


@pytest.fixture(autouse=True)
def no_native(monkeypatch):
    monkeypatch.setenv("WF_NO_NATIVE", "1")


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


def tb_stream(n_keys, per_key, seed=0):
    rng = np.random.default_rng(seed)
    ts_all = np.sort(rng.integers(0, per_key * 2, size=per_key))
    batches = []
    for lo in range(0, per_key, 53):
        m = min(53, per_key - lo)
        batches.append(batch_from_columns(
            SCHEMA, key=np.tile(np.arange(n_keys), m),
            id=np.repeat(np.arange(lo, lo + m), n_keys),
            ts=np.repeat(ts_all[lo:lo + m], n_keys),
            value=rng.integers(0, 100, size=m * n_keys).astype(np.int64)))
    return batches


def port_spec(win, slide, kind):
    return WindowSpec(win, slide, getattr(wt.WinType, kind))


def jax_spec(win, slide, kind):
    return JWindowSpec(win, slide, getattr(JWinType, kind))


def assert_identical(got, want):
    assert got.dtype == want.dtype and len(got) == len(want)
    assert got.tobytes() == want.tobytes()


def both_routed(win, slide, kind, op, batches, **kw):
    """The same stream through both packages' make_core_for (Python
    resident core); returns (port rows, JAX rows)."""
    jcore = jw.make_core_for(jax_spec(win, slide, kind), JReducer(op), **kw)
    pcore = pw.make_core_for(port_spec(win, slide, kind), wt.Reducer(op),
                             device="cpu", **kw)
    assert isinstance(jcore, jw.ResidentWinSeqCore)
    assert isinstance(pcore, pw.ResidentWinSeqCore)
    return run_core(pcore, batches), run_core(jcore, batches)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("win,slide", [(16, 4), (8, 8), (4, 12)])
@pytest.mark.parametrize("n_keys", [1, 5])
def test_resident_cb_matches_host(op, win, slide, n_keys):
    batches = cb_stream(n_keys, 503, seed=win * 31 + slide)
    got, want = both_routed(win, slide, "CB", op, batches, batch_len=64,
                            flush_rows=200)
    assert_identical(got, want)
    host = run_core(WinSeqCore(port_spec(win, slide, "CB"),
                               wt.Reducer(op)), batches)
    assert_identical(got, host)


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("win,slide", [(20, 5), (10, 10), (6, 16)])
def test_resident_tb_matches_host(op, win, slide):
    got, want = both_routed(win, slide, "TB", op,
                            tb_stream(3, 400, seed=win + slide),
                            batch_len=32, flush_rows=150)
    assert_identical(got, want)


def direct_cores(win, slide, op, jkw=None, pkw=None, **kw):
    """Both packages' ResidentWinSeqCore built directly."""
    jcore = jw.ResidentWinSeqCore(jax_spec(win, slide, "CB"), JReducer(op),
                                  **kw, **(jkw or {}))
    pcore = pw.ResidentWinSeqCore(port_spec(win, slide, "CB"),
                                  wt.Reducer(op), device="cpu", **kw,
                                  **(pkw or {}))
    return pcore, jcore


def test_resident_tiny_flush_forces_rebase():
    """Aggressive flush thresholds force many ring rebases."""
    batches = cb_stream(4, 1000, chunk=29, seed=9)
    pcore, jcore = direct_cores(32, 8, "sum", batch_len=16, flush_rows=64)
    assert_identical(run_core(pcore, batches), run_core(jcore, batches))


def test_resident_plq_renumbering():
    batches = cb_stream(3, 300, seed=4)
    pcore, jcore = direct_cores(
        8, 8, "sum", batch_len=32, flush_rows=100,
        jkw=dict(config=JPatternConfig(0, 1, 8, 1, 2, 8), role=JRole.PLQ),
        pkw=dict(config=PatternConfig(0, 1, 8, 1, 2, 8), role=Role.PLQ))
    assert_identical(run_core(pcore, batches), run_core(jcore, batches))


def test_resident_narrow_wire_dtypes():
    """Values outside int8/int16 ranges widen the wire dtype."""
    batches = cb_stream(2, 256, seed=5, lo_val=-40000, hi_val=40000)
    pcore, jcore = direct_cores(16, 4, "sum", batch_len=64, flush_rows=300)
    wires = []
    real = pcore.executor.launch

    def spy(meta, blk, *a, **k):
        wires.append(blk.dtype)
        return real(meta, blk, *a, **k)

    pcore.executor.launch = spy
    assert_identical(run_core(pcore, batches), run_core(jcore, batches))
    assert np.dtype(np.int32) in wires


def test_resident_prod_matches_host():
    batches = cb_stream(2, 120, chunk=17, seed=11, lo_val=1, hi_val=4)
    got, want = both_routed(6, 3, "CB", "prod", batches, batch_len=16,
                            flush_rows=60)
    assert_identical(got, want)


def test_resident_float_sum_keeps_restaging_path():
    """Float sums stay off the resident path unless the user opts in."""
    core = pw.make_core_for(port_spec(4, 2, "CB"),
                            wt.Reducer("sum", dtype=np.float32), device="cpu")
    assert isinstance(core, pw.DeviceWinSeqCore)
    jcore = jw.make_core_for(jax_spec(4, 2, "CB"),
                             JReducer("sum", dtype=np.float32))
    assert isinstance(jcore, jw.DeviceWinSeqCore)


def float_stream(n_keys=3, per_key=300, chunk=41, seed=2):
    rng = np.random.default_rng(seed)
    schema = Schema(value=np.float64)
    out = []
    for lo in range(0, per_key, chunk):
        m = min(chunk, per_key - lo)
        out.append(batch_from_columns(
            schema, key=np.tile(np.arange(n_keys), m),
            id=np.repeat(np.arange(lo, lo + m), n_keys),
            ts=np.repeat(np.arange(lo, lo + m), n_keys),
            value=rng.uniform(-10, 10, size=m * n_keys)))
    return out


def test_resident_float_sum_opt_in_within_tolerance():
    """use_resident=True puts a float sum on a float32 ring: sums within
    rtol=1e-5 of Σ|x| over the key's rows up to the window's end."""
    batches = float_stream()
    kw = dict(batch_len=32, flush_rows=90, use_resident=True)
    jcore = jw.make_core_for(jax_spec(12, 4, "CB"),
                             JReducer("sum", dtype=np.float64), **kw)
    pcore = pw.make_core_for(port_spec(12, 4, "CB"),
                             wt.Reducer("sum", dtype=np.float64),
                             device="cpu", **kw)
    assert isinstance(pcore, pw.ResidentWinSeqCore)
    assert pcore.executor.acc_dtype == np.float32
    got, want = run_core(pcore, batches), run_core(jcore, batches)
    for f in ("key", "id", "ts"):
        np.testing.assert_array_equal(got[f], want[f])
    rows = np.concatenate(batches)
    for k in np.unique(rows["key"]):
        vals = np.abs(rows["value"][rows["key"] == k].astype(np.float32))
        prefix = np.cumsum(vals.astype(np.float64))
        sel = got["key"] == k
        ends = np.minimum((got["id"][sel] * 4) + 12, len(vals))
        scale = prefix[ends - 1]
        err = np.abs(got["value"][sel] - want["value"][sel])
        assert np.all(err <= 1e-5 * scale)


def test_resident_64bit_compute_dtype():
    """A 64-bit compute_dtype runs on an int64 ring and gives the JAX
    package's results under x64, byte for byte, sums past 2**32 included
    (the JAX package without x64 still raises ValueError; a ring dtype the
    kernels lack, bfloat16, which JAX's core cannot run either, raises in
    the port)."""
    import jax
    if not jax.config.jax_enable_x64:
        with pytest.raises(ValueError, match="x64"):
            jw.ResidentWinSeqCore(jax_spec(4, 2, "CB"), JReducer("sum"),
                                  compute_dtype=np.int64)
    batches = cb_stream(3, 200, seed=5, lo_val=2 ** 33 - 50,
                        hi_val=2 ** 33 + 50)
    pcore = pw.ResidentWinSeqCore(port_spec(8, 4, "CB"), wt.Reducer("sum"),
                                  compute_dtype=np.int64, device="cpu",
                                  batch_len=32, flush_rows=100)
    assert pcore.executor.acc_dtype == np.int64
    got = run_core(pcore, batches)
    with jax.enable_x64(True):
        want = run_core(jw.ResidentWinSeqCore(
            jax_spec(8, 4, "CB"), JReducer("sum"), compute_dtype=np.int64,
            batch_len=32, flush_rows=100), batches)
    assert_identical(got, want)
    assert int(got["value"].max()) > 2 ** 35
    import ml_dtypes
    with pytest.raises(ValueError, match="bfloat16"):
        ResidentWindowExecutor("sum", device="cpu",
                               acc_dtype=ml_dtypes.bfloat16)


def test_resident_count_skips_device_entirely():
    """count, and max over the position field, route to the host core in
    both packages; max over a value column is real device work."""
    cases = [((4, 2, "CB"), ("count",)), ((10, 5, "TB"), ("max", "ts", "hi")),
             ((10, 5, "CB"), ("max", "id", "hi")),
             ((10, 5, "CB"), ("max", "value"))]
    for spec, args in cases:
        pcore = pw.make_core_for(port_spec(*spec), wt.Reducer(*args),
                                 device="cpu")
        jcore = jw.make_core_for(jax_spec(*spec), JReducer(*args))
        device = args == ("max", "value")
        assert isinstance(pcore, pw.ResidentWinSeqCore) == device
        assert isinstance(jcore, jw.ResidentWinSeqCore) == device
        assert not isinstance(pcore, pw.DeviceWinSeqCore)


def test_resident_rejects_incremental():
    pcore, _ = direct_cores(4, 2, "sum")
    with pytest.raises(TypeError):
        pcore.use_incremental()


def multi_agg(pkg):
    M = wt.MultiReducer if pkg == "port" else JMultiReducer
    return M(("count", None, "n"), ("max", "value", "hi"),
             ("sum", "value", "total"))


@pytest.mark.parametrize("kind", ["CB", "TB"])
def test_multi_stat_matches_host(kind):
    """count + max + sum over one field: one ring, two ops per dispatch."""
    stream = cb_stream(3, 150) if kind == "CB" else tb_stream(3, 150)
    jcore = jw.make_core_for(jax_spec(12, 4, kind), multi_agg("jax"),
                             batch_len=16)
    pcore = pw.make_core_for(port_spec(12, 4, kind), multi_agg("port"),
                             device="cpu", batch_len=16)
    assert isinstance(pcore, pw.ResidentWinSeqCore)
    assert pcore.executor.ops == ("max", "sum")
    got = run_core(pcore, stream)
    assert len(got) > 0
    assert_identical(got, run_core(jcore, stream))
    assert_identical(got, run_core(WinSeqCore(port_spec(12, 4, kind),
                                              multi_agg("port")),
                                   stream))


def test_multi_field_and_mesh_are_later_slices():
    """Stats over several fields take per-field rings (twins in
    test_torch_multifield.py), and mesh= builds the Python resident core
    over a MeshResidentExecutor, byte-identical to JAX's mesh core (mesh
    twins in test_torch_multichip.py)."""
    from windflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from windflow_tpu_torch.ops.resident import (MeshResidentExecutor,
                                                 MultiFieldResidentExecutor)
    from windflow_tpu_torch.parallel import make_mesh
    core = pw.make_core_for(port_spec(4, 2, "CB"), wt.MultiReducer(
        ("sum", "value", "s"), ("max", "ts", "m")), device="cpu")
    assert isinstance(core.executor, MultiFieldResidentExecutor)
    stream = cb_stream(5, 120, seed=4)
    pcore = pw.make_core_for(port_spec(8, 4, "CB"), wt.Reducer("sum"),
                             batch_len=16,
                             mesh=make_mesh(n_kf=4, devices=["cpu"] * 4))
    jcore = jw.make_core_for(jax_spec(8, 4, "CB"), JReducer("sum"),
                             batch_len=16, mesh=jax_make_mesh(n_kf=4))
    assert isinstance(pcore, pw.ResidentWinSeqCore)
    assert isinstance(pcore.executor, MeshResidentExecutor)
    got = run_core(pcore, stream)
    assert len(got) > 0
    assert_identical(got, run_core(jcore, stream))


def test_max_delay_flushes_partial_batches():
    """With max_delay_ms, pending windows ship on the next process() after
    the deadline even though neither batch_len nor flush_rows was hit."""
    core = pw.make_core_for(port_spec(4, 4, "CB"), wt.Reducer("sum"),
                            device="cpu", batch_len=1 << 20,
                            flush_rows=1 << 20, max_delay_ms=1,
                            use_resident=True)
    assert isinstance(core, pw.ResidentWinSeqCore)
    b1 = cb_stream(1, 8, chunk=8)[0]
    got = core.process(b1)
    time.sleep(0.01)
    got2 = core.process(cb_stream(1, 8, chunk=8, seed=1)[0])
    deadline = time.monotonic() + 5
    n = len(got) + len(got2)
    while n == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
        n += len(core.process(np.zeros(0, dtype=b1.dtype)))
    assert n > 0, "max_delay did not ship the pending windows"
    core.flush()


def test_pos_max_split_ships_single_column():
    """COUNT + MAX(ts) + SUM(revenue) over TB windows ships only revenue."""
    schema = Schema(revenue=np.int64)
    rng = np.random.default_rng(3)
    nk, per = 4, 300
    batches = []
    for lo in range(0, per, 60):
        m = min(60, per - lo)
        batches.append(batch_from_columns(
            schema, key=np.tile(np.arange(nk), m),
            id=np.repeat(np.arange(lo, lo + m), nk),
            ts=np.repeat(np.arange(lo, lo + m) * 7, nk),
            revenue=rng.integers(1, 98, m * nk)))
    stats = (("count", None, "n"), ("max", "ts", "hi"),
             ("sum", "revenue", "rev"))
    pcore = pw.make_core_for(port_spec(100, 100, "TB"),
                             wt.MultiReducer(*stats), device="cpu")
    jcore = jw.make_core_for(jax_spec(100, 100, "TB"), JMultiReducer(*stats))
    assert isinstance(pcore, pw.ResidentWinSeqCore)
    assert pcore._ship_fields == ("revenue",)
    assert [p.out_field for p in pcore._pos_max_parts] == ["hi"]
    assert_identical(run_core(pcore, batches), run_core(jcore, batches))


@pytest.mark.parametrize("rings", [True, False])
def test_snapshot_carried_from_jax_continues(rings):
    """Half the stream through the JAX core, a drained snapshot carried
    into the port (carry_resident_state), the rest through the port: the
    same per-launch output as the JAX core over the whole stream.  With
    `rings` the ring itself crosses (byte-identical to the JAX ring at the
    cut); without, the port rebases from the host archives."""
    batches = cb_stream(4, 400, chunk=31, seed=12)
    half = len(batches) // 2
    kw = dict(batch_len=24, flush_rows=80)

    ref = jw.ResidentWinSeqCore(jax_spec(16, 4, "CB"), JReducer("sum"), **kw)
    want = []
    for b in batches:
        want += ref.process_batches(b)
    want += ref.flush_batches()

    jcore = jw.ResidentWinSeqCore(jax_spec(16, 4, "CB"), JReducer("sum"),
                                  **kw)
    jcore.snapshot_rings = rings
    got = []
    for b in batches[:half]:
        got += jcore.process_batches(b)
    got += jcore.checkpoint_drain_batches()
    snap = jcore.state_snapshot()
    carried = carry_resident_state(snap)

    pcore = pw.ResidentWinSeqCore(port_spec(16, 4, "CB"), wt.Reducer("sum"),
                                  device="cpu", **kw)
    pcore.state_restore(carried)
    if rings:
        port_ring = pcore.executor.ring_snapshot().resolve()["rings"][0]
        jax_ring = snap["ring"].resolve()["rings"][0]
        assert port_ring.tobytes() == jax_ring.tobytes()
    for b in batches[half:]:
        got += pcore.process_batches(b)
    got += pcore.flush_batches()
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]


def test_port_snapshot_roundtrip_is_a_copy():
    """The port's ring is updated in place: a snapshot must be a copy that
    later appends do not change, and restoring it replays identically."""
    batches = cb_stream(3, 300, chunk=29, seed=8)
    cut = len(batches) // 2

    def fresh():
        return pw.ResidentWinSeqCore(port_spec(12, 4, "CB"),
                                     wt.Reducer("sum"), device="cpu",
                                     batch_len=16, flush_rows=60)

    a = fresh()
    for b in batches[:cut]:
        a.process_batches(b)
    a.checkpoint_drain_batches()
    snap = a.state_snapshot()
    before = snap["ring"].resolve()["rings"][0].copy()
    tail_a = []
    for b in batches[cut:]:
        tail_a += a.process_batches(b)
    tail_a += a.flush_batches()
    assert snap["ring"].resolve()["rings"][0].tobytes() == before.tobytes()

    r = fresh()
    r.state_restore(snap)
    tail_r = []
    for b in batches[cut:]:
        tail_r += r.process_batches(b)
    tail_r += r.flush_batches()
    assert [x.tobytes() for x in tail_r] == [x.tobytes() for x in tail_a]
