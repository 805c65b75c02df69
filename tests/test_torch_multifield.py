"""Per-field resident rings and user window functions: the port against the
JAX package on the same streams (numpy seeds), on device="cpu" (the
kernels' plain versions).

* Twins of tests/test_resident.py's multi-field cases: the Python
  ResidentWinSeqCore over MultiFieldResidentExecutor (several stats over
  several fields; a TorchWindowFunction on per-field rings), against the
  JAX ResidentWinSeqCore, the restaging route and the host core.
* Twins of tests/test_device.py's user-function cases (the restaging
  DeviceWinSeqCore with a TorchWindowFunction).
* Twins of tests/test_native.py's multi-field suite: the C++ core's
  ``_multi`` branch staging one column per field into per-field rings.
* A multi-field JAX core's snapshot carried into the port
  (interop.carry_resident_state).

Integer results must be byte-identical, every column and per-key order
included."""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from windflow_tpu.core.tuples import Schema, batch_from_columns
from windflow_tpu.core.windows import WindowSpec as JWindowSpec
from windflow_tpu.core.windows import WinType as JWinType
from windflow_tpu.ops.functions import FnWindowFunction as JFnWindowFunction
from windflow_tpu.ops.functions import MultiReducer as JMultiReducer
from windflow_tpu.ops.functions import Reducer as JReducer
from windflow_tpu.patterns import win_seq_tpu as jw
import windflow_tpu_torch as wt
from windflow_tpu_torch.core.windows import WindowSpec
from windflow_tpu_torch.core.winseq import WinSeqCore
from windflow_tpu_torch.interop import carry_resident_state
from windflow_tpu_torch.ops.functions import FnWindowFunction
from windflow_tpu_torch.ops.resident import MultiFieldResidentExecutor
from windflow_tpu_torch.patterns import win_seq_gpu as pw

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

SCHEMA2 = Schema(a=np.int64, b=np.int64)
MF_SCHEMA = Schema(rev=np.int64, amt=np.int64)


@pytest.fixture
def python_core(monkeypatch):
    """Pin both packages to their Python resident core."""
    monkeypatch.setenv("WF_NO_NATIVE", "1")


@pytest.fixture
def native_core(monkeypatch):
    monkeypatch.delenv("WF_NO_NATIVE", raising=False)
    monkeypatch.delenv("WF_NO_NATIVE_CORE", raising=False)
    from windflow_tpu_torch import native
    if native.load() is None:
        pytest.skip("native library unavailable")


def run_core(core, batches):
    outs = [core.process(b) for b in batches] + [core.flush()]
    outs = [o for o in outs if len(o)]
    if not outs:
        return np.zeros(0, dtype=core._result_dtype)
    return np.sort(np.concatenate(outs), order=["key", "id"])


def assert_identical(got, want):
    assert got.dtype == want.dtype and len(got) == len(want)
    assert got.tobytes() == want.tobytes()


def spec(win, slide, kind="CB"):
    return (WindowSpec(win, slide, getattr(wt.WinType, kind)),
            JWindowSpec(win, slide, getattr(JWinType, kind)))


def two_field_stream(n_keys=4, per_key=400, chunk=61, seed=3):
    rng = np.random.default_rng(seed)
    batches = []
    for lo in range(0, per_key, chunk):
        m = min(chunk, per_key - lo)
        ids = np.repeat(np.arange(lo, lo + m), n_keys)
        keys = np.tile(np.arange(n_keys), m)
        batches.append(batch_from_columns(
            SCHEMA2, key=keys, id=ids, ts=ids,
            a=rng.integers(-50, 100, m * n_keys),
            b=rng.integers(0, 2000, m * n_keys)))
    return batches


def mf_stream(n_keys, per_key, chunk=61, seed=0, amt_lo=-40000,
              amt_hi=40000):
    """Two int64 columns with different ranges (rev fits int8, amt needs
    int16/int32), so per-field wire narrowing is live."""
    rng = np.random.default_rng(seed)
    batches = []
    for lo in range(0, per_key, chunk):
        m = min(chunk, per_key - lo)
        ids = np.repeat(np.arange(lo, lo + m), n_keys)
        keys = np.tile(np.arange(n_keys), m)
        batches.append(batch_from_columns(
            MF_SCHEMA, key=keys, id=ids, ts=ids,
            rev=rng.integers(0, 50, size=m * n_keys).astype(np.int64),
            amt=rng.integers(amt_lo, amt_hi,
                             size=m * n_keys).astype(np.int64)))
    return batches


def multi(pkg, *stats):
    return (wt.MultiReducer if pkg == "port" else JMultiReducer)(*stats)


def both_cores(win, slide, stats, kind="CB", **kw):
    """The same MultiReducer through both packages' make_core_for."""
    pspec, jspec = spec(win, slide, kind)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pcore = pw.make_core_for(pspec, multi("port", *stats), device="cpu",
                                 **kw)
        jcore = jw.make_core_for(jspec, multi("jax", *stats), **kw)
    return pcore, jcore


# ------------------------------------------- Python core, per-field rings

@pytest.mark.usefixtures("python_core")
def test_multi_stat_two_fields_takes_multifield_rings():
    pcore, jcore = both_cores(4, 2, (("sum", "value", "s"),
                                     ("max", "ts", "m")))
    assert isinstance(pcore.executor, MultiFieldResidentExecutor)
    assert pcore.executor.fields == jcore.executor.fields == ("value", "ts")


@pytest.mark.usefixtures("python_core")
@pytest.mark.parametrize("win,slide,batch_len,flush_rows,seed", [
    (16, 4, 32, 100, 3),       # sum(a) + max(b) + count
    (12, 6, 8, 24, 9),         # tiny flushes: many ring rebases
])
def test_resident_multifield_matches_jax_and_host(win, slide, batch_len,
                                                  flush_rows, seed):
    stats = (("sum", "a", "sa"), ("max", "b", "mb"), ("count", None, "n"),
             ("min", "a", "mn"))
    batches = two_field_stream(n_keys=3 + seed % 2, per_key=300, chunk=23,
                               seed=seed)
    pcore, jcore = both_cores(win, slide, stats, batch_len=batch_len,
                              flush_rows=flush_rows)
    assert isinstance(pcore, pw.ResidentWinSeqCore)
    assert isinstance(pcore.executor, MultiFieldResidentExecutor)
    got = run_core(pcore, batches)
    assert_identical(got, run_core(jcore, batches))
    host = run_core(WinSeqCore(spec(win, slide)[0], multi("port", *stats)),
                    batches)
    assert_identical(got, host)


def port_prod_fn(keys, gwids, cols, mask):
    return torch.where(mask, cols["a"] * cols["b"], 0).sum(dim=1)


def jax_prod_fn(keys, gwids, cols, mask):
    return jnp.sum(jnp.where(mask, cols["a"] * cols["b"], 0), axis=1)


def prod_host(key, gwid, rows):
    return (int((rows["a"] * rows["b"]).sum()),)


@pytest.mark.usefixtures("python_core")
def test_resident_fn_matches_restaging_jax_and_host():
    """A torch window fn (sum of a*b per window) over per-field resident
    rings (use_resident=True) equals the restaging route, the JAX package's
    resident JaxWindowFunction and the host core."""
    pspec, jspec = spec(10, 5)
    batches = two_field_stream(n_keys=3, per_key=250, chunk=41, seed=5)
    host = run_core(WinSeqCore(pspec, FnWindowFunction(
        prod_host, {"value": np.int64})), batches)

    def pf():
        return wt.TorchWindowFunction(port_prod_fn, fields=("a", "b"),
                                      result_fields={"value": np.int64})

    resident = pw.make_core_for(pspec, pf(), batch_len=32, flush_rows=90,
                                use_resident=True, device="cpu")
    assert isinstance(resident.executor, MultiFieldResidentExecutor)
    restaged = pw.make_core_for(pspec, pf(), batch_len=32, device="cpu")
    assert isinstance(restaged, pw.DeviceWinSeqCore)
    jcore = jw.make_core_for(jspec, jw.JaxWindowFunction(
        jax_prod_fn, fields=("a", "b"), result_fields={"value": np.int64}),
        batch_len=32, flush_rows=90, use_resident=True)
    got = run_core(resident, batches)
    assert_identical(got, host)
    assert_identical(run_core(restaged, batches), host)
    assert_identical(got, run_core(jcore, batches))


@pytest.mark.usefixtures("python_core")
@pytest.mark.parametrize("use_resident", [True, None])
def test_fn_multi_output_and_header_columns(use_resident):
    """A fn returning several columns maps them to its result_fields in
    order; keys and gwids reach it as int32, as in the JAX package."""
    pspec, jspec = spec(8, 8)
    batches = two_field_stream(n_keys=2, per_key=200, chunk=33, seed=7)

    def port_fn(keys, gwids, cols, mask):
        assert keys.dtype == gwids.dtype == torch.int32
        a = torch.where(mask, cols["a"], 0)
        return (a.sum(dim=1),
                torch.where(mask, cols["a"], -1 << 30).amax(dim=1),
                gwids * 10 + keys)

    def jax_fn(keys, gwids, cols, mask):
        a = jnp.where(mask, cols["a"], 0)
        return (jnp.sum(a, axis=1),
                jnp.max(jnp.where(mask, cols["a"], -1 << 30), axis=1),
                gwids * 10 + keys)

    out = {"s": np.int64, "m": np.int64, "g": np.int64}
    kw = dict(batch_len=16, flush_rows=64, use_resident=use_resident)
    got = run_core(pw.make_core_for(pspec, wt.TorchWindowFunction(
        port_fn, fields=("a",), result_fields=out), device="cpu", **kw),
        batches)
    want = run_core(jw.make_core_for(jspec, jw.JaxWindowFunction(
        jax_fn, fields=("a",), result_fields=out), **kw), batches)
    assert_identical(got, want)
    np.testing.assert_array_equal(got["g"], got["id"] * 10 + got["key"])


def test_fn_rejects_64bit_ring():
    """A 64-bit field dtype builds an int64 ring and runs the window
    function over int64 tiles, equal to the JAX package's run under x64
    byte for byte, values past 2**32 included (the JAX package without
    x64 still raises ValueError)."""
    import jax
    pspec, jspec = spec(4, 2)
    pf = wt.TorchWindowFunction(lambda k, g, c, m: c["a"].sum(dim=1),
                                fields=("a",), result_fields={"v": np.int64},
                                field_dtypes={"a": np.int64})
    jf = jw.JaxWindowFunction(lambda k, g, c, m: c["a"].sum(axis=1),
                              fields=("a",), result_fields={"v": np.int64},
                              field_dtypes={"a": np.int64})
    if not jax.config.jax_enable_x64:
        with pytest.raises(ValueError, match="x64"):
            jw.make_core_for(jspec, jf, use_resident=True)
    batches = two_field_stream(n_keys=3, per_key=120)
    for b in batches:
        b["a"] += 2 ** 34
    kw = dict(use_resident=True, batch_len=16, flush_rows=48)
    pcore = pw.make_core_for(pspec, pf, device="cpu", **kw)
    assert pcore.executor.acc_dtypes["a"] == np.int64
    got = run_core(pcore, batches)
    with jax.enable_x64(True):
        want = run_core(jw.make_core_for(jspec, jf, **kw), batches)
    assert_identical(got, want)
    assert int(got["v"].min()) > 2 ** 35


def test_float_column_into_int_ring_rejected():
    """A float column headed into a default int32 ring raises instead of
    silently truncating (declare field_dtypes for float data)."""
    schema = Schema(x=np.float64)
    b = batch_from_columns(schema, key=np.zeros(8), id=np.arange(8),
                           ts=np.arange(8), x=np.full(8, 0.5))
    pf = wt.TorchWindowFunction(lambda k, g, c, m: c["x"].sum(dim=1),
                                fields=("x",), result_fields={"v": np.float64})
    core = pw.make_core_for(spec(4, 4)[0], pf, batch_len=4, flush_rows=4,
                            use_resident=True, device="cpu")
    with pytest.raises(ValueError, match="float column"):
        core.process(b)
        core.flush()


# --------------------------------------------- restaging user functions

def value_stream(keys=2, n=80, chunk=32):
    out = []
    for i in range(0, n, chunk):
        ids = np.repeat(np.arange(i, min(i + chunk, n)), keys)
        ks = np.tile(np.arange(keys), len(ids) // keys)
        out.append(batch_from_columns(Schema(value=np.int64), key=ks, id=ids,
                                      ts=ids * 7, value=ids))
    return out


def run_pattern(pattern, batches, schema):
    got = []

    def snk(rows):
        if rows is not None and len(rows):
            got.append(rows.copy())

    df = wt.Dataflow()
    wt.build_pipeline(df, [wt.Source(batches=batches, schema=schema),
                           pattern, wt.Sink(snk, vectorized=True)])
    df.run_and_wait_end()
    return np.sort(np.concatenate(got), order=["key", "id"])


def test_user_window_function_restaging():
    """A torch function over the restaging batch (sum of squares) equals
    the JAX package's and the host function's results."""
    def port_fn(keys, gwids, cols, mask):
        v = cols["value"]
        return torch.where(mask, v * v, 0).sum(dim=1)

    def jax_fn(keys, gwids, cols, mask):
        v = cols["value"]
        return jnp.sum(jnp.where(mask, v * v, 0), axis=1)

    def host(key, gwid, rows):
        return int(np.sum(rows["value"].astype(np.int64) ** 2))

    schema = Schema(value=np.int64)
    got = run_pattern(wt.WinSeqGPU(wt.TorchWindowFunction(
        port_fn, fields=("value",), result_fields={"value": np.int64}),
        6, 2, wt.WinType.CB, batch_len=32, device="cpu"),
        value_stream(), schema)
    want = run_pattern(jw.WinSeqTPU(jw.JaxWindowFunction(
        jax_fn, fields=("value",), result_fields={"value": np.int64}),
        6, 2, JWinType.CB, batch_len=32), value_stream(), schema)
    hosted = run_pattern(wt.WinSeq(FnWindowFunction(
        host, {"value": np.int64}), 6, 2, wt.WinType.CB), value_stream(),
        schema)
    assert_identical(got, want)
    assert_identical(got, hosted)


def test_restaging_fn_float_canonicalised():
    """float64 columns reach the fn as float32 tiles (jax.device_put
    without x64); its float32 output is cast to the float64 result."""
    schema = Schema(x=np.float64)
    rng = np.random.default_rng(2)
    batches = [batch_from_columns(schema, key=np.zeros(50), id=np.arange(50),
                                  ts=np.arange(50),
                                  x=np.round(rng.uniform(0, 10, 50) * 64) / 64)]

    def port_fn(keys, gwids, cols, mask):
        assert cols["x"].dtype == torch.float32
        return torch.where(mask, cols["x"], 0).sum(dim=1)

    def jax_fn(keys, gwids, cols, mask):
        return jnp.sum(jnp.where(mask, cols["x"], 0), axis=1)

    out = {"s": np.float64}
    got = run_pattern(wt.WinSeqGPU(wt.TorchWindowFunction(
        port_fn, fields=("x",), result_fields=out), 8, 3, wt.WinType.CB,
        batch_len=4, device="cpu"), batches, schema)
    want = run_pattern(jw.WinSeqTPU(jw.JaxWindowFunction(
        jax_fn, fields=("x",), result_fields=out), 8, 3, JWinType.CB,
        batch_len=4), batches, schema)
    assert_identical(got, want)


def test_host_python_fn_and_incremental_rejected_on_device():
    with pytest.raises(TypeError, match="cannot be staged"):
        wt.WinSeqGPU(lambda k, g, rows: 0, 4, 2, wt.WinType.CB,
                     device="cpu").make_core()
    core = wt.WinSeqGPU(wt.TorchWindowFunction(lambda k, g, c, m: m.sum(1)),
                        4, 2, wt.WinType.CB, device="cpu").make_core()
    with pytest.raises(TypeError, match="non-incremental"):
        core.use_incremental()


# -------------------------------------------- native core, _multi branch

def mf_agg(pkg="port"):
    return multi(pkg, ("count", None, "n"), ("max", "id", "hi"),
                 ("sum", "rev", "rsum"), ("min", "amt", "alo"),
                 ("max", "amt", "ahi"))


def tb_mf_stream(seed=5, nk=3, per=420):
    rng = np.random.default_rng(seed)
    batches = []
    for lo in range(0, per, 71):
        m = min(71, per - lo)
        batches.append(batch_from_columns(
            MF_SCHEMA, key=np.tile(np.arange(nk), m),
            id=np.repeat(np.arange(lo, lo + m), nk),
            ts=np.repeat(np.arange(lo, lo + m) * 7, nk),
            rev=rng.integers(0, 50, size=m * nk).astype(np.int64),
            amt=rng.integers(-9000, 9000, size=m * nk).astype(np.int64)))
    return batches


@pytest.mark.usefixtures("native_core")
@pytest.mark.parametrize("win,slide,kind", [
    (16, 4, "CB"), (24, 24, "CB"), (50, 25, "TB")])
def test_native_multifield_matches_jax_and_host(win, slide, kind):
    from windflow_tpu.patterns.native_core import NativeResidentCore as JN
    from windflow_tpu_torch.patterns.native_core import NativeResidentCore
    batches = (tb_mf_stream() if kind == "TB"
               else mf_stream(4, 700, seed=win + slide))
    pspec, jspec = spec(win, slide, kind)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pcore = pw.make_core_for(pspec, mf_agg(), batch_len=64,
                                 flush_rows=150, device="cpu")
        jcore = jw.make_core_for(jspec, mf_agg("jax"), batch_len=64,
                                 flush_rows=150)
    assert isinstance(pcore, NativeResidentCore) and isinstance(jcore, JN)
    # CB: max(id) is the position stat (host-free); TB: id ships too
    want_fields = ("rev", "amt") if kind == "CB" else ("id", "rev", "amt")
    assert pcore._multi and pcore._ship_fields == want_fields
    assert isinstance(pcore.executor, MultiFieldResidentExecutor)
    got = run_core(pcore, batches)
    assert_identical(got, run_core(jcore, batches))
    assert_identical(got, run_core(WinSeqCore(pspec, mf_agg()), batches))


@pytest.mark.usefixtures("native_core")
def test_native_single_field_multi_op():
    """Several stats over ONE field take the native multi path, as in the
    JAX package (one ring, two evaluations per dispatch)."""
    from windflow_tpu_torch.patterns.native_core import NativeResidentCore
    stats = (("sum", "value", "sm"), ("max", "value", "mx"))
    pcore, jcore = both_cores(16, 4, stats, batch_len=64, flush_rows=150)
    assert isinstance(pcore, NativeResidentCore)
    assert pcore._multi and pcore._ship_fields == ("value",)
    assert jcore._multi
    batches = value_stream(keys=5, n=600, chunk=37)
    got = run_core(pcore, batches)
    assert_identical(got, run_core(jcore, batches))
    assert_identical(got, run_core(WinSeqCore(spec(16, 4)[0],
                                              multi("port", *stats)),
                                   batches))


@pytest.mark.usefixtures("native_core")
def test_native_multistat_pos_max_split():
    """One device stat beside count and MAX(position): the single-stat
    native path (no per-field rings), as in the JAX package."""
    stats = (("count", None, "n"), ("max", "ts", "hi"),
             ("sum", "value", "sm"))
    rng = np.random.default_rng(17)
    batches = []
    for lo in range(0, 400, 61):
        m = min(61, 400 - lo)
        batches.append(batch_from_columns(
            Schema(value=np.int64), key=np.tile(np.arange(3), m),
            id=np.repeat(np.arange(lo, lo + m), 3),
            ts=np.repeat(np.arange(lo, lo + m) * 7, 3),
            value=rng.integers(-50, 100, size=m * 3).astype(np.int64)))
    pcore, jcore = both_cores(50, 50, stats, kind="TB", batch_len=32,
                              flush_rows=100)
    assert not pcore._multi and not jcore._multi
    assert [p.out_field for p in pcore._pos_max_parts] == ["hi"]
    assert_identical(run_core(pcore, batches), run_core(jcore, batches))


@pytest.mark.usefixtures("native_core")
def test_native_multifield_per_field_wire_narrowing():
    """The C++ flush narrows each staged column on its own: rev in [0, 50)
    ships int8, amt (|amt| >= 128) int16."""
    from windflow_tpu_torch.patterns.native_core import NativeResidentCore
    nat = NativeResidentCore(spec(8, 8)[0], mf_agg(), batch_len=64,
                             flush_rows=64, overlap=False, device="cpu")
    wires = []
    real = nat.executor.launch

    def spy(meta, blks, *a, **k):
        wires.append({f: b.dtype for f, b in blks.items()})
        return real(meta, blks, *a, **k)

    nat.executor.launch = spy
    b = batch_from_columns(MF_SCHEMA, key=np.zeros(128, dtype=np.int64),
                           id=np.arange(128), ts=np.arange(128),
                           rev=np.full(128, 7), amt=np.full(128, 30000))
    run_core(nat, [b])
    assert wires and wires[0] == {"rev": np.dtype(np.int8),
                                  "amt": np.dtype(np.int16)}


@pytest.mark.usefixtures("native_core")
def test_native_multifield_coalescing_matches_host():
    """Queued multi-field launches merge per field (each at its own widened
    wire dtype) and stay exact."""
    from windflow_tpu_torch.patterns.native_core import NativeResidentCore
    rng = np.random.default_rng(13)
    batches = []
    for c, (lo, hi) in enumerate([(-5, 5), (-30000, 30000)] * 3):
        m = 300
        ids = np.repeat(np.arange(c * m, (c + 1) * m), 3)
        batches.append(batch_from_columns(
            MF_SCHEMA, key=np.tile(np.arange(3), m), id=ids, ts=ids,
            rev=rng.integers(0, 40, size=m * 3).astype(np.int64),
            amt=rng.integers(lo, hi, size=m * 3).astype(np.int64)))
    pspec = spec(16, 4)[0]
    host = run_core(WinSeqCore(pspec, mf_agg()), batches)
    nat = NativeResidentCore(pspec, mf_agg(), batch_len=1 << 20,
                             flush_rows=96, overlap=False, device="cpu")
    assert nat._multi
    merges = []
    real = nat._lib

    class _Shim:
        def __getattr__(self, name):
            if name != "wf_launch_coalesce":
                return getattr(real, name)

            def counting(h, cells, mx, mult):
                n = real.wf_launch_coalesce(h, cells, mx, mult)
                merges.append(n)
                return n
            return counting

    nat._lib = _Shim()
    assert_identical(run_core(nat, batches), host)
    assert sum(merges) > 0, "multi-field launches never merged"


@pytest.mark.usefixtures("native_core")
def test_native_multifield_sharded_and_overlap():
    from windflow_tpu_torch.patterns.native_core import NativeResidentCore
    pspec = spec(12, 3)[0]
    batches = mf_stream(7, 500, chunk=83, seed=29)
    nat = NativeResidentCore(pspec, mf_agg(), batch_len=64, flush_rows=120,
                             shards=2, overlap=True, device="cpu")
    assert nat._multi and nat.shards == 2
    assert_identical(run_core(nat, batches),
                     run_core(WinSeqCore(pspec, mf_agg()), batches))


@pytest.mark.usefixtures("native_core")
def test_native_multifield_float_and_wide_route_python():
    """Float stats keep the Python resident core (the native ABI ships
    int64 columns); so do more than wf_max_fields() fields."""
    pspec = spec(16, 4)[0]
    agg = wt.MultiReducer(wt.Reducer("sum", "rev", "rs"),
                          wt.Reducer("min", "amt", "al", dtype=np.float32))
    core = pw.make_core_for(pspec, agg, batch_len=64, flush_rows=150,
                            device="cpu")
    assert type(core) is pw.ResidentWinSeqCore
    agg5 = wt.MultiReducer(*[("max", f"f{i}", f"o{i}") for i in range(5)])
    core5 = pw.make_core_for(pspec, agg5, batch_len=64, flush_rows=150,
                             device="cpu")
    assert type(core5) is pw.ResidentWinSeqCore


@pytest.mark.usefixtures("native_core")
def test_native_multifield_falls_back_on_nonint_column():
    """A non-int64 column (int32 here) falls back to the Python core
    transparently mid-stream, as in the JAX package."""
    from windflow_tpu_torch.patterns.native_core import NativeResidentCore
    schema = Schema(rev=np.int64, amt=np.int32)
    rng = np.random.default_rng(31)
    m, nk = 400, 3
    b = batch_from_columns(
        schema, key=np.tile(np.arange(nk), m),
        id=np.repeat(np.arange(m), nk), ts=np.repeat(np.arange(m), nk),
        rev=rng.integers(0, 50, size=m * nk).astype(np.int64),
        amt=rng.integers(-9000, 9000, size=m * nk).astype(np.int32))
    stats = (("sum", "rev", "rs"), ("max", "amt", "ah"))
    pspec = spec(16, 4)[0]
    nat = NativeResidentCore(pspec, wt.MultiReducer(*stats, dtype=np.int64),
                             batch_len=64, flush_rows=150, device="cpu")
    assert nat._multi
    got = run_core(nat, [b])
    assert nat._delegate is not None
    host = run_core(WinSeqCore(pspec, wt.MultiReducer(*stats,
                                                      dtype=np.int64)), [b])
    for f in ("key", "id", "rs", "ah"):
        np.testing.assert_array_equal(got[f], host[f])


# ------------------------------------------------- carried JAX snapshot

@pytest.mark.usefixtures("python_core")
@pytest.mark.parametrize("rings", [True, False])
def test_multifield_snapshot_carried_from_jax_continues(rings):
    """Half the stream through a JAX multi-field core, its drained snapshot
    carried into the port, the rest through the port: the same per-launch
    output as the JAX core over the whole stream, and (with `rings`) every
    field's ring byte-identical to the JAX ring at the cut."""
    stats = (("sum", "a", "sa"), ("max", "b", "mb"), ("count", None, "n"))
    batches = two_field_stream(n_keys=4, per_key=400, chunk=31, seed=12)
    half = len(batches) // 2
    kw = dict(batch_len=24, flush_rows=80)
    pspec, jspec = spec(16, 4)

    ref = jw.ResidentWinSeqCore(jspec, multi("jax", *stats), **kw)
    want = []
    for b in batches:
        want += ref.process_batches(b)
    want += ref.flush_batches()

    jcore = jw.ResidentWinSeqCore(jspec, multi("jax", *stats), **kw)
    jcore.snapshot_rings = rings
    got = []
    for b in batches[:half]:
        got += jcore.process_batches(b)
    got += jcore.checkpoint_drain_batches()
    snap = jcore.state_snapshot()

    pcore = pw.ResidentWinSeqCore(pspec, multi("port", *stats),
                                  device="cpu", **kw)
    assert isinstance(pcore.executor, MultiFieldResidentExecutor)
    pcore.state_restore(carry_resident_state(snap))
    if rings:
        port_rings = pcore.executor.ring_snapshot().resolve()["rings"]
        jax_rings = snap["ring"].resolve()["rings"]
        assert len(port_rings) == len(jax_rings) == 2
        for p, j in zip(port_rings, jax_rings):
            assert p.dtype == j.dtype and p.tobytes() == j.tobytes()
    for b in batches[half:]:
        got += pcore.process_batches(b)
    got += pcore.flush_batches()
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]
