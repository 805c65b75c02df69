"""Column dtypes on the restaging route and in the mesh reduction: the
port (device="cpu": the kernels' plain versions) against the JAX package
on the same seeded inputs.

The rule (ops/device.py): a column without a 64-bit ``compute_dtype``
follows JAX's default config on its XLA route (the default restaging
route, ``builtin_batch_fn``); an explicit int64, uint64 or float64
``compute_dtype`` follows JAX under x64, run here inside
``jax.enable_x64(True)`` (a pipeline in a child interpreter with
JAX_ENABLE_X64=1: node threads do not inherit the scoped flag).  JAX's
Pallas route stores narrow-int sums in the column dtype, so they wrap; the
port follows the XLA route (a recorded divergence, tested below).

Integers, counts, min and max must be equal bit for bit, and of JAX's
dtype; float16 results within one float16 ulp; float32 within 1e-5 and
float64 within 1e-12 of the window's sum of |x|.  The kernels' order twins
are held against the plain versions at every new dtype; the
``cuda``-marked cases hold the kernels to the twins bit for bit on a card
(they skip here)."""

import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from windflow_tpu_torch.ops import gather as g
from windflow_tpu_torch.ops import mesh_reduce as mr
from windflow_tpu_torch.ops import windowed_reduce as wr
from windflow_tpu_torch.ops.device import DeviceWindowExecutor, staged_dtypes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ("sum", "count", "min", "max", "prod")
RTOL32, RTOL64 = 1e-5, 1e-12
#: the kernels' new dtypes (restaging; the mesh takes all but float16)
NEW = (torch.uint32, torch.int64, torch.uint64, torch.float16,
       torch.float64)
MESH_NEW = (torch.uint32, torch.int64, torch.uint64, torch.float64)

pytestmark = pytest.mark.filterwarnings(
    "ignore:device path downcasts int64:UserWarning",
    "ignore:Explicitly requested dtype:UserWarning")


def name(d) -> str:
    return str(d).replace("torch.", "") if isinstance(d, torch.dtype) \
        else np.dtype(d).name


def x64(on: bool):
    import jax
    return jax.enable_x64(True) if on else contextlib.nullcontext()


def windows(rng, n, B, max_len):
    """(starts, lens) of B windows inside n rows, some empty."""
    lens = rng.integers(0, max_len + 1, B)
    lens[::7] = 0
    starts = rng.integers(0, max(n - max_len, 1), B)
    return starts.astype(np.int64), lens.astype(np.int64)


def column(rng, dtype, n):
    """Values near the range of `dtype` (floats: a spread that rounds)."""
    dt = np.dtype(dtype)
    if dt.kind == "b":
        return rng.random(n) < 0.6
    if dt.kind == "f":
        if dt.itemsize == 2:
            return (4000 + rng.uniform(0, 8, n)).astype(dt)
        return (rng.uniform(-1, 1, n) * 1e6).astype(dt)
    info = np.iinfo(dt)
    hi = rng.integers(info.max - 60, info.max, n, endpoint=True,
                      dtype=dt if dt.kind == "u" else np.int64)
    lo = rng.integers(info.min, info.min + 60, n, endpoint=True,
                      dtype=dt if dt.kind == "u" else np.int64)
    mid = rng.integers(-50, 50, n) + (info.max // 2 if dt.kind == "u" else 0)
    pick = rng.integers(0, 3, n)
    return np.choose(pick, [hi.astype(dt), lo.astype(dt),
                            mid.astype(dt)]).astype(dt)


def jax_run(op, cols, starts, lens, use_pallas=False, fn=None, **kw):
    """JAX's DeviceWindowExecutor over one launch; its result column."""
    from windflow_tpu.ops.device import DeviceWindowExecutor as J
    from windflow_tpu.ops.device import builtin_batch_fn
    fields = tuple(cols)
    ex = J(fn or builtin_batch_fn(op, "value"), fields=fields,
           use_pallas=use_pallas, op=op if fn is None else None, **kw)
    z = np.zeros(len(starts), np.int64)
    ex.launch(0, cols, starts, lens, z, z)
    return np.asarray(ex.drain()[0][1]["value"])


def port_run(op, cols, starts, lens, fn=None, **kw):
    ex = DeviceWindowExecutor(op, fields=tuple(cols), device="cpu", fn=fn,
                              **kw) if fn is None else DeviceWindowExecutor(
        fields=tuple(cols), device="cpu", fn=fn, **kw)
    ex.launch(0, cols, starts, lens)
    return ex.drain()[0][1]["value"]


def abs_sums(col, starts, lens):
    c = np.concatenate([[0], np.cumsum(np.abs(col.astype(np.float64)))])
    return c[starts + lens] - c[starts]


def assert_same(got, want, col, starts, lens, rtol=None, op="sum"):
    """JAX's dtype; ints (and min, max, count) equal; float16 within one
    ulp; other float sums within rtol of the window's sum of |x|, float
    products within 2 (n - 1) units of rounding of |x| (n cells; the fold
    orders differ)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if got.dtype.kind != "f" or rtol == 0:
        np.testing.assert_array_equal(got, want)
        return
    both_inf = np.isinf(want) & (got == want)
    if got.dtype == np.float16:
        with np.errstate(invalid="ignore"):
            tol = np.spacing(np.abs(want).astype(np.float16)).astype(
                np.float64)
    elif op == "prod":
        tol = 2 * np.maximum(lens - 1, 0) * np.finfo(got.dtype).eps / 2 \
            * np.abs(want.astype(np.float64))
    else:
        tol = rtol * abs_sums(col, starts, lens)
    with np.errstate(invalid="ignore"):
        err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert bool((both_inf | (err <= tol)).all()), err.max()


# ------------------------------------------------ (1) the Queue 3 fault

@pytest.mark.parametrize("dtype", [np.uint32, np.uint64], ids=name)
@pytest.mark.parametrize("op", OPS)
def test_unsigned_columns_match_jax_on_both_routes(dtype, op):
    """uint32 and uint64 values at 2**31 +- 50 (the fault the restaging
    route had: values >= 2**31 read as negative), every op, the port's
    executor against JAX's XLA and Pallas routes, bit for bit."""
    vals = (np.arange(100) + 2 ** 31 - 50).astype(dtype)
    starts, lens = np.array([0, 40, 90, 7]), np.array([16, 16, 10, 0])
    cols = {"value": vals} if op != "count" else {}
    kw = dict(out_dtypes={"value": np.int64})
    got = port_run(op, cols, starts, lens, **kw)
    for pallas in (False, True):
        want = jax_run(op, cols, starts, lens, use_pallas=pallas, **kw)
        np.testing.assert_array_equal(got, want)
    if op in ("max", "min", "sum"):
        want = {"max": [2147483613, 2147483653, 2147483697],
                "min": [2147483598, 2147483638, 2147483688],
                "sum": [4294966616, 4294967256, 445]}[op]
        assert got[:3].tolist() == want


# ------------------------------------ (2) every column dtype x op, no x64

DTYPES = (np.int8, np.int16, np.uint8, np.uint16, np.uint32, np.uint64,
          np.int64, np.float16, np.float32, np.float64, np.bool_)


@pytest.mark.parametrize("dtype", DTYPES, ids=name)
def test_column_dtypes_match_jax_xla_route(dtype):
    """Every column dtype and op against JAX's XLA route in its default
    config, at values near the dtype's range, with empty windows and no
    out_dtypes: the results and their dtypes (the staged dtype's, or the
    column's for a narrow int's min and max) equal JAX's."""
    rng = np.random.default_rng(np.dtype(dtype).itemsize * 7
                                + "iubf".index(np.dtype(dtype).kind))
    col = column(rng, dtype, 700)
    starts, lens = windows(rng, 700, 90, 40)
    ops = ("sum", "count", "prod") if dtype is np.bool_ else OPS
    for op in ops:
        cols = {"value": col} if op != "count" else {}
        got = port_run(op, cols, starts, lens)
        want = jax_run(op, cols, starts, lens)
        rtol = RTOL32 if op in ("sum", "prod") else 0
        assert_same(got, want, col, starts, lens, rtol, op)
    if dtype is np.bool_:
        with pytest.raises(TypeError, match="bool"):
            port_run("max", {"value": col}, starts, lens)


def test_staged_dtypes_rule():
    """The staged and result dtypes, as the module docstring states."""
    cases = {(np.int8, "sum", False): (np.int32, np.int32),
             (np.int8, "max", False): (np.int32, np.int8),
             (np.uint16, "prod", False): (np.uint32, np.uint32),
             (np.uint16, "min", False): (np.uint32, np.uint16),
             (np.uint64, "sum", False): (np.uint32, np.uint32),
             (np.int64, "max", False): (np.int32, np.int32),
             (np.float16, "sum", False): (np.float16, np.float16),
             (np.float64, "sum", False): (np.float32, np.float32),
             (np.bool_, "sum", False): (np.int32, np.int32),
             (np.int64, "sum", True): (np.int64, np.int64),
             (np.uint64, "min", True): (np.uint64, np.uint64),
             (np.float64, "prod", True): (np.float64, np.float64),
             (np.bool_, "sum", True): (np.int64, np.int64)}
    for (dt, op, wide), want in cases.items():
        got = staged_dtypes(dt, op, wide)
        assert got == tuple(np.dtype(d) for d in want), (dt, op, wide)


def test_float16_sum_accumulates_in_float32():
    """JAX's float16 sums accumulate in float32 and round once: 4096 ones
    sum to 4096 (a float16 accumulator stops at 2048), and ten values
    near 4004 give JAX's 40032 (the port once kept float32: 40040)."""
    for col, want in ((np.ones(4096, np.float16), 4096.0),
                      (np.full(10, 4004, np.float16), None)):
        s, n = np.array([0]), np.array([len(col)])
        got = port_run("sum", {"value": col}, s, n)
        jwant = jax_run("sum", {"value": col}, s, n)
        assert got.dtype == jwant.dtype == np.float16
        assert got.tolist() == jwant.tolist()
        if want is not None:
            assert float(got[0]) == want


# ----------------------------------- (3) 64-bit compute_dtype, under x64

@pytest.mark.parametrize("compute,src", [
    (np.int64, np.int64), (np.uint64, np.uint64), (np.float64, np.float64),
    (np.int64, np.int32), (np.float64, np.float32)], ids=name)
def test_64bit_compute_dtype_matches_jax_x64(compute, src):
    """An explicit int64, uint64 or float64 compute_dtype stages and
    reduces the column in 64 bits, as JAX under x64 does: ints bit for
    bit (sums past 2**32), float64 sums within 1e-12 of the sum of |x|."""
    rng = np.random.default_rng(5)
    if np.dtype(src).kind == "f":
        col = (1e9 + rng.uniform(0, 1, 600)).astype(src)
    elif np.dtype(src).itemsize == 8:
        col = column(rng, src, 600)
    else:
        col = rng.integers(2 ** 30, 2 ** 31 - 1, 600).astype(src)
    starts, lens = windows(rng, 600, 70, 50)
    for op in OPS:
        cols = {"value": col} if op != "count" else {}
        got = port_run(op, cols, starts, lens, compute_dtype=compute)
        with x64(True):
            want = jax_run(op, cols, starts, lens, compute_dtype=compute)
        if op == "count":   # the port's count stays int32 (jnp.sum of the
            want = want.astype(np.int32)   # mask: int64 under x64)
        assert_same(got, want, col, starts, lens,
                    RTOL64 if op in ("sum", "prod") else 0, op)
    if np.dtype(compute).kind == "f":
        narrow = port_run("sum", {"value": col}, starts, lens,
                          compute_dtype=np.float32)
        assert not np.array_equal(narrow.astype(np.float64), got)


# ------------------------------------------- (4) the Pallas divergence

def test_pallas_narrow_sum_wraps_port_follows_xla():
    """Recorded divergence: JAX's Pallas route stores an int16 window sum
    in int16, so it wraps; its XLA route (the default) and the port sum
    in int32."""
    col = np.full(64, 30000, dtype=np.int16)
    s, n = np.array([0, 10]), np.array([8, 3])
    pallas = jax_run("sum", {"value": col}, s, n, use_pallas=True)
    xla = jax_run("sum", {"value": col}, s, n)
    got = port_run("sum", {"value": col}, s, n)
    assert pallas.dtype == np.int16 and pallas.tolist() == [
        np.int16(np.int64(240000).astype(np.int16)),
        np.int16(np.int64(90000).astype(np.int16))]
    assert xla.dtype == got.dtype == np.int32
    assert got.tolist() == xla.tolist() == [240000, 90000]


# ------------------------------------------------------- (5) pipelines

N_KEYS, PER_KEY, WIN, SLIDE = 4, 400, 16, 4


def stream(schema, vals, chunk=256):
    import windflow_tpu_torch as wt
    n = len(vals)
    ids = np.repeat(np.arange(n // N_KEYS), N_KEYS)
    keys = np.tile(np.arange(N_KEYS), n // N_KEYS)
    return [wt.batch_from_columns(schema, key=keys[i:i + chunk],
                                  id=ids[i:i + chunk], ts=ids[i:i + chunk],
                                  value=vals[i:i + chunk])
            for i in range(0, n, chunk)]


def run_rows(pkg, schema, batches, stage):
    """Source -> stage -> Sink through `pkg` (either package); the rows
    sorted by key, then id."""
    if pkg.__name__ == "windflow_tpu":
        from windflow_tpu.runtime.engine import Dataflow
        from windflow_tpu.runtime.farm import build_pipeline
    else:
        Dataflow, build_pipeline = pkg.Dataflow, pkg.build_pipeline
    rows = []
    df = Dataflow()
    build_pipeline(df, [
        pkg.Source(batches=iter(batches), schema=schema), stage,
        pkg.Sink(lambda r: rows.append(r.copy()) if r is not None
                 and len(r) else None, vectorized=True)])
    df.run_and_wait_end()
    out = np.concatenate(rows)
    return out[np.lexsort((out["id"], out["key"]))]


def test_uint32_max_pipeline_matches_jax():
    """WinSeqGPU(Reducer("max", dtype=int64), use_reduce_kernel=True)
    over uint32 values around 2**31, and a PaneFarmGPU (both stages on
    the device) over uint32 sums, against JAX's WinSeqTPU (use_pallas)
    and PaneFarmTPU row for row."""
    import windflow_tpu as jf
    import windflow_tpu_torch as wt
    rng = np.random.default_rng(9)
    vals = rng.integers(2 ** 31 - 50, 2 ** 31 + 50,
                        N_KEYS * PER_KEY).astype(np.uint32)
    ws, js = wt.Schema(value=np.uint32), jf.Schema(value=np.uint32)
    port = run_rows(wt, ws, stream(ws, vals), wt.WinSeqGPU(
        wt.Reducer("max", dtype=np.int64), WIN, SLIDE, wt.WinType.CB,
        batch_len=64, use_reduce_kernel=True, device="cpu"))
    jax = run_rows(jf, js, stream(js, vals), jf.WinSeqTPU(
        jf.Reducer("max", dtype=np.int64), WIN, SLIDE, jf.WinType.CB,
        batch_len=64, use_pallas=True))
    assert port.tobytes() == jax.tobytes()
    assert int(port["value"].max()) > 2 ** 31
    port = run_rows(wt, ws, stream(ws, vals), wt.PaneFarmGPU(
        wt.Reducer("sum"), wt.Reducer("sum"), WIN, SLIDE, wt.WinType.CB,
        plq_degree=2, wlq_degree=1, batch_len=32, use_reduce_kernel=True,
        device="cpu"))
    jax = run_rows(jf, js, stream(js, vals), jf.PaneFarmTPU(
        jf.Reducer("sum"), jf.Reducer("sum"), WIN, SLIDE, jf.WinType.CB,
        plq_degree=2, wlq_degree=1, batch_len=32, use_pallas=True))
    assert port.tobytes() == jax.tobytes()


JAX_CHILD = r"""
import sys
import numpy as np
import windflow_tpu as jf
from windflow_tpu.runtime.engine import Dataflow
from windflow_tpu.runtime.farm import build_pipeline
d = np.load(sys.argv[1])
schema = jf.Schema(value=np.float64)
keys, ids, vals = d["key"], d["id"], d["value"]
batches = [jf.batch_from_columns(schema, key=keys[i:i + 256],
                                 id=ids[i:i + 256], ts=ids[i:i + 256],
                                 value=vals[i:i + 256])
           for i in range(0, len(vals), 256)]
rows = []
df = Dataflow()
build_pipeline(df, [
    jf.Source(batches=iter(batches), schema=schema),
    jf.WinSeqTPU(jf.Reducer("sum", dtype=np.float64), %d, %d, jf.WinType.CB,
                 batch_len=64, compute_dtype=np.float64),
    jf.Sink(lambda r: rows.append(r.copy()) if r is not None
            and len(r) else None, vectorized=True)])
df.run_and_wait_end()
out = np.concatenate(rows)
np.save(sys.argv[2], out[np.lexsort((out["id"], out["key"]))])
""" % (WIN, SLIDE)


def test_float64_sum_default_route_matches_jax_x64(tmp_path):
    """A float sum's default route (restaging) with compute_dtype=float64
    over values 1e9 + u: every window within 1e-12 of the sum of |x| of
    JAX's pipeline under x64 (a child interpreter with JAX_ENABLE_X64=1),
    ids and keys equal, and unlike a float32 staging of the stream."""
    import windflow_tpu_torch as wt
    rng = np.random.default_rng(10)
    vals = 1e9 + rng.uniform(0, 1, N_KEYS * PER_KEY)
    schema = wt.Schema(value=np.float64)
    batches = stream(schema, vals)
    got = run_rows(wt, schema, batches, wt.WinSeqGPU(
        wt.Reducer("sum", dtype=np.float64), WIN, SLIDE, wt.WinType.CB,
        batch_len=64, compute_dtype=np.float64, device="cpu"))
    narrow = run_rows(wt, schema, batches, wt.WinSeqGPU(
        wt.Reducer("sum", dtype=np.float64), WIN, SLIDE, wt.WinType.CB,
        batch_len=64, device="cpu"))
    inp, out = tmp_path / "s.npz", tmp_path / "j.npy"
    ids = np.concatenate([b["id"] for b in batches])
    keys = np.concatenate([b["key"] for b in batches])
    np.savez(inp, key=keys, id=ids, value=vals)
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run([sys.executable, "-c", JAX_CHILD, str(inp),
                           str(out)], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.load(out)
    assert got.dtype == want.dtype
    for f in ("key", "id", "ts"):
        np.testing.assert_array_equal(got[f], want[f])
    scale = 16 * (1e9 + 1)
    assert np.abs(got["value"] - want["value"]).max() <= RTOL64 * scale
    assert np.abs(narrow["value"] - got["value"]).max() > 1.0


# ------------------------------------------ (6) a user window function

def test_user_function_int64_compute_dtype_matches_jax_x64():
    """A TorchWindowFunction over an int64 compute_dtype column gets
    8-byte tiles (window_gather's 64-bit words), as a JAX window function
    under x64 does: sum and max of the tile, equal to JAX's."""
    import jax.numpy as jnp
    rng = np.random.default_rng(12)
    col = rng.integers(2 ** 40, 2 ** 41, 500)
    starts, lens = windows(rng, 500, 60, 33)
    seen = []

    def port_fn(keys, gwids, cols, mask):
        seen.append(cols["value"].dtype)
        return cols["value"].sum(dim=1) + cols["value"].amax(dim=1)

    def jax_fn(keys, gwids, cols, mask):
        return (jnp.sum(cols["value"], axis=1)
                + jnp.max(jnp.where(mask, cols["value"], jnp.iinfo(
                    jnp.int64).min), axis=1))

    got = port_run(None, {"value": col}, starts, lens, fn=port_fn,
                   compute_dtype=np.int64,
                   out_dtypes={"value": np.int64})
    with x64(True):
        want = jax_run(None, {"value": col}, starts, lens, fn=jax_fn,
                       compute_dtype=np.int64,
                       out_dtypes={"value": np.int64})
    assert seen == [torch.int64]
    full = lens > 0
    np.testing.assert_array_equal(got[full], want[full])
    assert int(got.max()) > 2 ** 41


# ----------------------------------------- (7) the mesh reduction

MESH_KF, MESH_N = 2, 12000


def mesh_inputs(dtype, seed):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, MESH_N - 300, (MESH_KF, 40))
    lens = rng.integers(1, 300, (MESH_KF, 40))
    # windows past SPLIT (2048) cells on a shard, across the sp boundary
    starts[:, :3] = [100, 2000, 2500]
    lens[:, :3] = [5000, 7000, 9000]
    if dtype is np.uint32:
        flat = rng.integers(2 ** 31 - 100, 2 ** 31 + 100,
                            (MESH_KF, MESH_N)).astype(np.uint32)
    elif dtype is np.int64:
        flat = rng.integers(-2 ** 40, 2 ** 40, (MESH_KF, MESH_N))
    elif dtype is np.uint64:
        flat = rng.integers(2 ** 63 - 1000, 2 ** 63 + 1000,
                            (MESH_KF, MESH_N), dtype=np.uint64)
    else:
        flat = rng.uniform(-1, 1, (MESH_KF, MESH_N))
    return flat, starts.astype(np.int32), lens.astype(np.int32)


@pytest.mark.parametrize("dtype", [np.uint32, np.int64, np.uint64,
                                   np.float64], ids=name)
@pytest.mark.parametrize("shape", [(2, 2, 2), (2, 4, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_mesh_reduce_matches_jax(dtype, shape):
    """MeshWindowedReduce at uint32 (JAX's default config) and at int64,
    uint64 and float64 (JAX under x64), on (kf, sp, wf) meshes, every
    op with psum and ring, windows past SPLIT: results and dtypes equal
    JAX's (float64 sums and means within 1e-12 of the sum of |x|; mean
    is float32 at uint32, float64 at 64 bits)."""
    from windflow_tpu.parallel.mesh import MeshWindowedReduce as J
    from windflow_tpu.parallel.mesh import make_mesh as jmake
    from windflow_tpu_torch.parallel import MeshWindowedReduce, make_mesh
    kf, sp, wf = shape
    flat, starts, lens = mesh_inputs(dtype, 3 + sp)
    wide = np.dtype(dtype).itemsize == 8
    scale = np.stack([abs_sums(flat[k], starts[k], lens[k])
                      for k in range(kf)])
    for op in OPS + ("mean",):
        for coll in ("psum", "ring"):
            port = MeshWindowedReduce(
                make_mesh(kf, sp, devices=["cpu"] * (kf * sp * wf),
                          n_wf=wf), op=op, dtype=dtype, collective=coll)
            got = port(flat, starts, lens)
            with x64(wide):
                want = J(jmake(kf, sp, n_wf=wf), op=op, dtype=dtype,
                         collective=coll)(flat, starts, lens)
            assert got.dtype == want.dtype, (op, got.dtype, want.dtype)
            if got.dtype.kind == "f" and op in ("sum", "mean", "prod"):
                tol = RTOL64 * (scale / np.maximum(lens, 1) if op == "mean"
                                else scale)
                if op == "prod":
                    tol = RTOL64 * np.abs(want) * lens
                assert bool((np.abs(got - want) <= tol).all()), (op, coll)
            else:
                np.testing.assert_array_equal(got, want, err_msg=op)
    if dtype is np.uint32:
        assert port.dtype == torch.uint32


def test_mesh_64bit_flat_narrowed_without_64bit_dtype():
    """An int64 flat reduced at uint32 goes through JAX's default
    canonicalisation (int64 -> int32 -> uint32); at int64 it stays."""
    from windflow_tpu.parallel.mesh import MeshWindowedReduce as J
    from windflow_tpu.parallel.mesh import make_mesh as jmake
    from windflow_tpu_torch.parallel import MeshWindowedReduce, make_mesh
    flat = np.array([[2 ** 33 + 5, -3, 2 ** 40, 7, 1, 2, 3, 4]])
    starts, lens = np.array([[0, 2]], np.int32), np.array([[4, 5]], np.int32)
    for dtype, wide in ((np.uint32, False), (np.int64, True)):
        got = MeshWindowedReduce(make_mesh(1, 2, devices=["cpu"] * 2),
                                 op="max", dtype=dtype)(flat, starts, lens)
        with x64(wide):
            want = J(jmake(1, 2), op="max", dtype=dtype)(flat, starts, lens)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ------------------------------------------ (8) twins against plain

def seeded(dt, n, rng):
    if dt == torch.uint32:
        a = rng.integers(2 ** 31 - 500, 2 ** 31 + 500, n).astype(np.uint32)
    elif dt == torch.uint64:
        a = rng.integers(2 ** 63 - 500, 2 ** 63 + 500, n, dtype=np.uint64)
    elif dt == torch.int64:
        a = rng.integers(-2 ** 40, 2 ** 40, n)
    elif dt == torch.float16:
        a = rng.uniform(-4, 4, n).astype(np.float16)
    else:
        a = rng.uniform(-1e3, 1e3, n)
    return torch.from_numpy(a)


def bits_equal(a, b):
    it = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(it), b.view(it))


def close(got, want, op, absval):
    """Bit for bit, but for float sums and products (the twin's order is
    the kernel's, the plain version's torch's)."""
    if not got.dtype.is_floating_point or op in ("count", "min", "max"):
        return bits_equal(got, want)
    g, w = got.double(), want.double()
    if got.dtype == torch.float16:
        with np.errstate(invalid="ignore"):
            tol = 2 * torch.from_numpy(np.spacing(np.abs(
                want.numpy()).astype(np.float16)).astype(np.float64))
    elif op == "prod":      # n - 1 roundings of at most 2**-53 |x| each
        tol = 1e-9 * w.abs()
    else:
        tol = RTOL64 * absval
    same = (g == w) | (torch.isnan(g) & torch.isnan(w))
    return bool((same | ((g - w).abs() <= tol)).all())


@pytest.mark.parametrize("dtype", NEW, ids=name)
def test_lane_order_twin_matches_plain(dtype):
    """windowed_reduce's order twin against its plain version at each
    new dtype: 2-D rows, windows that start at every offset mod 4, past
    the row's end, empty and clamped."""
    rng = np.random.default_rng(21)
    buf = seeded(dtype, 3 * 701, rng).reshape(3, 701)
    B = 120
    rows = torch.from_numpy(rng.integers(0, 3, B).astype(np.int32))
    starts = torch.from_numpy(rng.integers(-2, 701, B).astype(np.int32))
    lens = torch.from_numpy(rng.integers(0, 90, B).astype(np.int32))
    absval = wr.windowed_reduce_many_reference(
        [(buf.abs().double() if dtype.is_floating_point
          else buf.view(torch.int32 if dtype == torch.uint32
                        else torch.int64).double().abs(), "sum")],
        rows, starts, lens, 64)[0]
    for op in OPS:
        twin = wr.lane_order_twin([(buf, op)], rows, starts, lens, 64)[0]
        plain = wr.windowed_reduce_many([(buf, op)], rows, starts, lens,
                                        64)[0]
        assert twin.dtype == plain.dtype == dtype
        assert close(twin, plain, op, absval), op


@pytest.mark.parametrize("dtype", MESH_NEW, ids=name)
@pytest.mark.parametrize("split,chunk", [(mr.SPLIT, mr.CHUNK), (40, 32)])
def test_mesh_twins_match_plain(dtype, split, chunk):
    """partial_order_twin and merge_order_twin against the plain versions
    at each new mesh dtype, with a keep mask, windows past `split` cut
    into chunks, both merge orders and mean."""
    rng = np.random.default_rng(22)
    Ns, B = 6000, 60
    vals = seeded(dtype, Ns, rng)
    keep = torch.from_numpy(rng.random(Ns) < 0.7)
    starts = rng.integers(-50, Ns, B)
    lens = rng.integers(0, 300, B)
    lens[:4] = [2100, 2500, 4000, 5900]
    starts[:4] = [0, 7, 1000, 50]
    st = torch.from_numpy(starts.astype(np.int32))
    ln = torch.from_numpy(lens.astype(np.int32))
    absval = torch.from_numpy(np.array([
        np.abs(mr.Work(dtype).load(vals)[max(s - 9, 0):max(s + l - 9, 0)]
               .double().numpy()).sum() for s, l in zip(starts, lens)]))
    for op in OPS + ("mean",):
        twin = mr.partial_order_twin(vals, keep, st, ln, 9, op, split=split,
                                     chunk=chunk)
        plain = mr.sp_window_partial(vals, keep, st, ln, 9, op)
        assert close(twin[0], plain[0], op, absval), op
        assert (twin[1] is None) == (plain[1] is None)
        if twin[1] is not None:
            assert torch.equal(twin[1], plain[1])
        parts = torch.stack([plain[0], twin[0], plain[0]])
        cnts = (torch.stack([plain[1]] * 3) if plain[1] is not None
                else None)
        for ring in (False, True):
            mt = mr.merge_order_twin(parts, cnts, op, ring)
            mp = mr.sp_merge(parts, cnts, op, ring=ring)
            assert mt.dtype == mp.dtype == mr.merge_out(op, dtype)
            assert close(mt, mp, op, 3 * absval), (op, ring)


def test_new_dtypes_refused_where_not_taken():
    """bfloat16 is no mesh dtype (float16 and the 1- and 2-byte integers
    are, since the mesh took JAX's other dtypes), int16 no gather dtype:
    both raise."""
    t = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError, match="mesh reduction runs in"):
        mr.sp_window_partial(torch.zeros(8, dtype=torch.bfloat16), None, t,
                             t, 0, "sum")
    with pytest.raises(TypeError, match="window_gather takes"):
        g.window_gather(torch.zeros((1, 8), dtype=torch.int16), None, t, t,
                        4)


def test_gather_8_byte_and_mixed_widths_plain():
    """window_gather's plain version keeps each buffer's dtype and words
    (int64, uint64 past 2**63, float64 beside int32)."""
    rng = np.random.default_rng(23)
    bufs = [torch.from_numpy(rng.integers(-2 ** 40, 2 ** 40, (2, 50))),
            torch.from_numpy(rng.integers(2 ** 63, 2 ** 64 - 1, (2, 50),
                                          dtype=np.uint64)),
            torch.from_numpy(rng.uniform(-1, 1, (2, 50))),
            torch.from_numpy(rng.integers(-9, 9, (2, 50)).astype(np.int32))]
    rows = torch.tensor([0, 1, 1], dtype=torch.int32)
    starts = torch.tensor([3, 45, 0], dtype=torch.int32)
    lens = torch.tensor([5, 9, 0], dtype=torch.int32)
    tiles, mask = g.window_gather(bufs, rows, starts, lens, 8)
    for t, b in zip(tiles, bufs):
        assert t.dtype == b.dtype
        raw = wr.signed_view(b).numpy()
        want = np.zeros((3, 8), raw.dtype)
        want[0, :5] = raw[0, 3:8]
        want[1, :5] = raw[1, 45:50]
        want[1, 5:8] = raw[1, 49]          # past the row's end: clamped
        assert np.array_equal(wr.signed_view(t).numpy(), want)


# ------------------------------------------------------- (9) the card

def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", NEW, ids=name)
def test_windowed_reduce_kernel_equals_twin_on_card(dtype):
    """Every op at each new dtype: the kernel equals its order twin bit
    for bit (starts at every offset mod 4, clamped windows, 2-D rows), one
    launch a call, mixed with int32 in two launches."""
    dev = card()
    rng = np.random.default_rng(31)
    buf = seeded(dtype, 3 * 5003, rng).reshape(3, 5003)
    B = 900
    d = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
        rng.integers(0, 3, B), rng.integers(-3, 5003, B),
        rng.integers(0, 600, B))]
    for op in OPS:
        before = wr.windowed_reduce.launches
        got = wr.windowed_reduce_many([(buf.to(dev), op)], *d, 512)[0]
        torch.cuda.synchronize()
        assert wr.windowed_reduce.launches == before + 1
        twin = wr.lane_order_twin([(buf, op)], *[t.cpu() for t in d],
                                  512)[0]
        assert bits_equal(got.cpu(), twin), op
    i32 = torch.zeros(buf.shape, dtype=torch.int32, device=dev)
    before = wr.windowed_reduce.launches
    wr.windowed_reduce_many([(buf.to(dev), "max"), (i32, "sum")], *d, 512)
    assert wr.windowed_reduce.launches == before + 2


@pytest.mark.cuda
def test_window_gather_8_byte_on_card():
    dev = card()
    rng = np.random.default_rng(32)
    bufs = [torch.from_numpy(rng.integers(-2 ** 40, 2 ** 40, (3, 4001))),
            torch.from_numpy(rng.uniform(-1, 1, (3, 4001))),
            torch.from_numpy(rng.integers(-9, 9, (3, 4001)).astype(
                np.int32))]
    B = 300
    d = [torch.from_numpy(a.astype(np.int32)) for a in (
        rng.integers(0, 3, B), rng.integers(-2, 4001, B),
        rng.integers(0, 300, B))]
    for pad in (257, 300, 1024):
        before = g.window_gather.launches
        tiles, mask = g.window_gather([b.to(dev) for b in bufs],
                                      *[t.to(dev) for t in d], pad)
        torch.cuda.synchronize()
        assert g.window_gather.launches == before + 2
        want, wmask = g.window_gather_reference(bufs, *d, pad)
        assert torch.equal(mask.cpu(), wmask)
        assert all(bits_equal(t.cpu(), w) for t, w in zip(tiles, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", MESH_NEW, ids=name)
def test_mesh_kernels_equal_twins_on_card(dtype):
    """sp_window_partial (windows past SPLIT included) and sp_merge (2,
    3, 9 and 17 shards, both orders) at each new dtype equal their twins
    bit for bit, one launch a call."""
    dev = card()
    rng = np.random.default_rng(33)
    Ns, B = 20000, 300
    vals = seeded(dtype, Ns, rng)
    keep = torch.from_numpy(rng.random(Ns) < 0.7)
    starts = rng.integers(-100, Ns, B)
    lens = rng.integers(0, 700, B)
    lens[:5] = rng.integers(3000, 12000, 5)
    st = torch.from_numpy(starts.astype(np.int32))
    ln = torch.from_numpy(lens.astype(np.int32))
    for op in OPS + ("mean",):
        before = mr.sp_window_partial.launches
        got = mr.sp_window_partial(vals.to(dev), keep.to(dev), st.to(dev),
                                   ln.to(dev), 50, op)
        torch.cuda.synchronize()
        assert mr.sp_window_partial.launches == before + 1
        twin = mr.partial_order_twin(vals, keep, st, ln, 50, op)
        assert bits_equal(got[0].cpu(), twin[0]), op
        for n in (2, 3, 9, 17):
            parts = torch.stack([got[0]] * n)
            cnts = torch.stack([got[1]] * n) if got[1] is not None else None
            before = mr.sp_merge.launches
            m = mr.sp_merge(list(parts), None if cnts is None
                            else list(cnts), op, ring=n % 2 == 1)
            torch.cuda.synchronize()
            assert mr.sp_merge.launches == before + 1
            mt = mr.merge_order_twin(parts.cpu(), None if cnts is None
                                     else cnts.cpu(), op, ring=n % 2 == 1)
            assert bits_equal(m.cpu(), mt), (op, n)


@pytest.mark.cuda
def test_no_fallback_when_the_library_cannot_load(monkeypatch, tmp_path):
    """A CUDA tensor of a new dtype launches its kernel or raises: with
    the libraries unloadable each wrapper raises, and no plain version
    answers in its place."""
    dev = card()
    bogus = tmp_path / "missing.so"
    for mod in (wr, g, mr):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "build", lambda bogus=bogus: str(bogus))
    i32 = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(OSError):
        wr.windowed_reduce(torch.zeros(8, dtype=torch.uint32, device=dev),
                           i32, i32 + 4, 4, "max")
    with pytest.raises(OSError):
        g.window_gather(torch.zeros((1, 8), dtype=torch.int64, device=dev),
                        None, i32, i32 + 4, 4)
    with pytest.raises(OSError):
        mr.sp_window_partial(torch.zeros(8, dtype=torch.float64,
                                         device=dev), None, i32, i32 + 4, 0,
                             "sum")
