"""The port's mesh windowed reduction (windflow_tpu_torch/parallel/mesh.py
over the sp_window_partial and sp_merge kernels of ops/mesh_reduce.py)
against the JAX package's MeshWindowedReduce — twins of
tests/test_mesh.py, with the same parametrisation.

The JAX side runs on the 8 virtual CPU devices (conftest.py); the port on
a mesh whose device list repeats ``cpu`` (the kernels' plain versions).
Integers, count, min and max must be equal bit for bit; float32 sums and
means are held within rtol 1e-5 of the sum of |x| over the window (over
the window's count for a mean), since XLA's fold order is not specified.
The CPU twins of the kernels' combine order are held against the plain
versions here; the `cuda`-marked tests hold the kernels to the twins bit
for bit on a card.  JAX is imported inside the twins only: the `cuda`
tests run where there is no JAX."""

import numpy as np
import pytest
import torch

from windflow_tpu_torch.ops import mesh_reduce as mr
from windflow_tpu_torch.parallel import (MeshStreamStep, MeshWindowedReduce,
                                         make_mesh, partition_stream_by_key)

RTOL = 1e-5


def jax_mesh(n_kf, n_sp, n_wf=1):
    from windflow_tpu.parallel.mesh import make_mesh as jmake
    return jmake(n_kf, n_sp, n_wf=n_wf)


def jax_reduce(n_kf, n_sp, n_wf=1, **kw):
    import jax.numpy as jnp
    from windflow_tpu.parallel.mesh import MeshWindowedReduce as J
    if kw.get("dtype") == "float32":
        kw["dtype"] = jnp.float32
    return J(jax_mesh(n_kf, n_sp, n_wf), **kw)


def port_reduce(n_kf, n_sp, n_wf=1, **kw):
    if kw.get("dtype") == "float32":
        kw["dtype"] = torch.float32
    mesh = make_mesh(n_kf, n_sp, devices=["cpu"] * (n_kf * n_sp * n_wf),
                     n_wf=n_wf)
    return MeshWindowedReduce(mesh, **kw)


def _random_windows(rng, n_groups, n_rows, n_wins, max_len):
    flat = rng.integers(-50, 50, size=(n_groups, n_rows)).astype(np.int32)
    lens = rng.integers(1, max_len + 1, size=(n_groups, n_wins))
    starts = rng.integers(0, n_rows - max_len, size=(n_groups, n_wins))
    return flat, starts.astype(np.int32), lens.astype(np.int32)


def _oracle(flat, starts, lens, op):
    KF, B = starts.shape
    out = np.zeros((KF, B), dtype=np.int64)
    for k in range(KF):
        for i in range(B):
            w = flat[k, starts[k, i]:starts[k, i] + lens[k, i]]
            out[k, i] = {"sum": np.sum, "count": len, "min": np.min,
                         "max": np.max, "prod": np.prod}[op](w)
    return out


def window_abs(flat, starts, lens):
    """Sum of |x| over every window (the float tolerance's scale)."""
    return np.stack([[np.abs(flat[k, s:s + l].astype(np.float64)).sum()
                      for s, l in zip(starts[k], lens[k])]
                     for k in range(starts.shape[0])])


def assert_float_close(got, want, scale):
    assert got.dtype == np.float32 and got.shape == want.shape
    err = np.abs(got.astype(np.float64) - np.asarray(want, np.float64))
    assert (err <= RTOL * np.maximum(scale, 1e-30)).all(), err.max()


@pytest.mark.parametrize("n_kf,n_sp", [(8, 1), (4, 2), (2, 4), (1, 8)])
@pytest.mark.parametrize("op", ["sum", "count", "min", "max"])
def test_mesh_reduce_matches_oracle(n_kf, n_sp, op):
    rng = np.random.default_rng(42 + n_kf)
    flat, starts, lens = _random_windows(rng, n_kf, 300, 40, 64)
    got = port_reduce(n_kf, n_sp, op=op)(flat, starts, lens)
    np.testing.assert_array_equal(got, _oracle(flat, starts, lens, op))
    want = jax_reduce(n_kf, n_sp, op=op)(flat, starts, lens)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_mesh_mean():
    rng = np.random.default_rng(7)
    flat, starts, lens = _random_windows(rng, 2, 256, 16, 32)
    f32 = flat.astype(np.float32)
    got = port_reduce(2, 4, op="mean", dtype="float32")(f32, starts, lens)
    want = np.stack([
        [flat[k, s:s + l].mean() for s, l in zip(starts[k], lens[k])]
        for k in range(2)])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jwant = jax_reduce(2, 4, op="mean", dtype="float32")(f32, starts, lens)
    assert_float_close(got, np.asarray(jwant),
                       window_abs(flat, starts, lens) / lens)


def test_mesh_windows_spanning_shard_boundaries():
    # windows crossing sp-shard row boundaries must still reduce exactly
    n_rows = 8 * 16  # Ns = 16 per shard
    flat = np.arange(n_rows, dtype=np.int32)[None, :]
    starts = np.array([[0, 10, 60, 100]], dtype=np.int32)
    lens = np.array([[128, 50, 40, 28]], dtype=np.int32)
    got = port_reduce(1, 8, op="sum")(flat, starts, lens)
    np.testing.assert_array_equal(got, _oracle(flat, starts, lens, "sum"))
    want = jax_reduce(1, 8, op="sum")(flat, starts, lens)
    assert got.tobytes() == np.asarray(want).tobytes()


def test_mesh_stream_step_fused_map_filter():
    # full step: map(x -> 2x) then filter(x > 0) then windowed sum
    rng = np.random.default_rng(3)
    flat, starts, lens = _random_windows(rng, 4, 200, 24, 48)
    mesh = make_mesh(4, 2, devices=["cpu"] * 8)
    step = MeshStreamStep(mesh, op="sum", map_fn=lambda v: v * 2,
                          filter_fn=lambda v: v > 0)
    got = step(flat, starts, lens)
    mapped = flat * 2
    mapped = np.where(mapped > 0, mapped, 0)
    np.testing.assert_array_equal(got, _oracle(mapped, starts, lens, "sum"))
    want = jax_reduce(4, 2, op="sum", map_fn=lambda v: v * 2,
                      filter_fn=lambda v: v > 0)(flat, starts, lens)
    assert got.tobytes() == np.asarray(want).tobytes()


def test_partition_stream_by_key():
    from windflow_tpu.parallel.mesh import partition_stream_by_key as jpart
    keys = np.arange(100)
    assert (partition_stream_by_key(keys, 4) == keys % 4).all()
    odd = partition_stream_by_key(keys, 4, routing=lambda k, n: (k + 1) % n)
    assert (odd == (keys + 1) % 4).all()
    assert (odd == jpart(keys, 4, routing=lambda k, n: (k + 1) % n)).all()


def test_jit_cache_reused_across_calls():
    """One reducer, three calls of one shape bucket: every call equal to
    the oracle and to JAX's (whose three calls share one compile; the
    port compiles nothing per shape)."""
    red = port_reduce(2, 4, op="sum")
    jred = jax_reduce(2, 4, op="sum")
    rng = np.random.default_rng(0)
    for _ in range(3):
        flat, starts, lens = _random_windows(rng, 2, 300, 40, 64)
        got = red(flat, starts, lens)
        np.testing.assert_array_equal(got, _oracle(flat, starts, lens, "sum"))
        assert got.tobytes() == np.asarray(jred(flat, starts, lens)).tobytes()
    assert len(jred._jits) == 1


def test_mesh_filter_semantics_count_and_mean():
    """Filtered rows must leave count and the mean denominator."""
    flat = np.array([[1, 2, -3, 4, -5, 6, 7, -8]], dtype=np.int32)
    starts = np.array([[0, 4]], dtype=np.int32)
    lens = np.array([[4, 4]], dtype=np.int32)
    keep = lambda v: v > 0    # noqa: E731
    cnt = port_reduce(1, 2, op="count", filter_fn=keep)(flat, starts, lens)
    np.testing.assert_array_equal(cnt, [[3, 2]])
    assert cnt.tobytes() == np.asarray(jax_reduce(
        1, 2, op="count", filter_fn=keep)(flat, starts, lens)).tobytes()
    f32 = flat.astype(np.float32)
    mean = port_reduce(1, 2, op="mean", dtype="float32", filter_fn=keep)(
        f32, starts, lens)
    np.testing.assert_allclose(mean, [[(1 + 2 + 4) / 3, (6 + 7) / 2]])
    jmean = jax_reduce(1, 2, op="mean", dtype="float32", filter_fn=keep)(
        f32, starts, lens)
    np.testing.assert_allclose(mean, np.asarray(jmean), rtol=RTOL)


def test_mesh_3d_window_axis():
    """(kf=2, wf=2, sp=2): windows shard over wf, rows over sp."""
    rng = np.random.default_rng(11)
    flat = rng.integers(-20, 20, size=(2, 64)).astype(np.int32)
    starts = np.stack([np.arange(8) * 7 for _ in range(2)]).astype(np.int32)
    lens = np.full((2, 8), 9, dtype=np.int32)
    got = port_reduce(2, 2, n_wf=2, op="sum")(flat, starts, lens)
    want = np.stack([
        [flat[g, s:s + 9].sum() for s in starts[g]] for g in range(2)])
    np.testing.assert_array_equal(got, want)
    jwant = jax_reduce(2, 2, n_wf=2, op="sum")(flat, starts, lens)
    assert got.tobytes() == np.asarray(jwant).tobytes()


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_mesh_ring_collective_matches_psum(op):
    """The ring fold order gives the one-shot fold's result (and JAX's)."""
    rng = np.random.default_rng(13)
    flat = rng.integers(-30, 30, size=(2, 128)).astype(np.int32)
    starts = np.stack([np.sort(rng.integers(0, 100, size=6))
                       for _ in range(2)]).astype(np.int32)
    lens = rng.integers(1, 28, size=(2, 6)).astype(np.int32)
    a = port_reduce(2, 4, op=op)(flat, starts, lens)
    b = port_reduce(2, 4, op=op, collective="ring")(flat, starts, lens)
    np.testing.assert_array_equal(a, b)
    jb = jax_reduce(2, 4, op=op, collective="ring")(flat, starts, lens)
    assert b.tobytes() == np.asarray(jb).tobytes()


def test_mesh_ring_mean():
    rng = np.random.default_rng(17)
    flat = rng.integers(0, 50, size=(1, 64)).astype(np.int32)
    starts = np.array([[0, 10, 30]], dtype=np.int32)
    lens = np.array([[10, 16, 20]], dtype=np.int32)
    got = port_reduce(1, 8, op="mean", dtype="float32", collective="ring")(
        flat, starts, lens)
    want = np.array([[flat[0, s:s + l].mean() for s, l in
                      zip(starts[0], lens[0])]], dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    jgot = jax_reduce(1, 8, op="mean", dtype="float32", collective="ring")(
        flat, starts, lens)
    assert_float_close(got, np.asarray(jgot),
                       window_abs(flat, starts, lens) / lens)


# ------------------------------------------------- beyond test_mesh.py

@pytest.mark.parametrize("op", ["sum", "count", "min", "max", "prod", "mean"])
@pytest.mark.parametrize("collective", ["psum", "ring"])
def test_windows_past_n_read_padding(op, collective):
    """A window that runs past N reads the zero padding (mapped: 3*0+1 = 1,
    kept by the filter) and counts it, in both packages."""
    rng = np.random.default_rng(19)
    N = 100                          # Ns = 32, rows 100..127 are padding
    flat = rng.integers(-4, 5, size=(2, N)).astype(np.int32)
    starts = np.array([[90, 95, 99, 60], [0, 98, 40, 97]], dtype=np.int32)
    lens = np.array([[20, 33, 1, 45], [8, 30, 70, 2]], dtype=np.int32)
    kw = dict(op=op, collective=collective, map_fn=lambda v: 3 * v + 1,
              filter_fn=lambda v: v % 5 != 0)
    got = port_reduce(2, 4, **kw)(flat, starts, lens)
    want = np.asarray(jax_reduce(2, 4, **kw)(flat, starts, lens))
    padded = np.zeros((2, 128), dtype=np.int64)
    padded[:, :N] = flat
    mapped = 3 * padded + 1
    kept = mapped % 5 != 0
    n = np.array([[kept[g, s:s + l].sum() for s, l in zip(starts[g],
                                                          lens[g])]
                  for g in range(2)])
    if op == "count":
        np.testing.assert_array_equal(got, n)
    if op == "mean":
        assert_float_close(got, want, np.stack([
            [np.abs(np.where(kept, mapped, 0)[g, s:s + l]).sum()
             for s, l in zip(starts[g], lens[g])] for g in range(2)])
            / np.maximum(n, 1))
    else:
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("collective", ["psum", "ring"])
def test_int_mean_returns_float32(collective):
    """mean over an int32 dtype: the integer sum over max(count, 1) in
    float32, as JAX's true division of int32 gives."""
    rng = np.random.default_rng(23)
    flat = rng.integers(-100, 100, size=(2, 256)).astype(np.int32)
    starts = rng.integers(0, 200, size=(2, 12)).astype(np.int32)
    lens = rng.integers(0, 56, size=(2, 12)).astype(np.int32)
    got = port_reduce(2, 4, op="mean", collective=collective)(
        flat, starts, lens)
    want = np.asarray(jax_reduce(2, 4, op="mean", collective=collective)(
        flat, starts, lens))
    assert got.dtype == np.float32 == want.dtype
    # the integer sums are exact in both: the division too
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n_kf,n_sp,n_wf", [(2, 2, 2), (1, 4, 2), (1, 2, 4)])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("op", ["sum", "prod", "min", "max"])
def test_meshes_all_ops_match_jax(n_kf, n_sp, n_wf, dtype, op):
    """Every op over (kf, wf, sp) meshes, int32 and float32, with wf
    shards that hold padding only (3 windows over 4 wf shards)."""
    rng = np.random.default_rng(29 + n_wf)
    lo, hi = (1, 3) if op == "prod" else (-40, 40)
    flat = rng.integers(lo, hi, size=(n_kf, 96)).astype(dtype)
    starts = rng.integers(-10, 96, size=(n_kf, 3)).astype(np.int32)
    lens = rng.integers(0, 40, size=(n_kf, 3)).astype(np.int32)
    kw = dict(op=op, dtype=dtype if dtype == "float32" else np.int32)
    got = port_reduce(n_kf, n_sp, n_wf, **kw)(flat, starts, lens)
    want = np.asarray(jax_reduce(n_kf, n_sp, n_wf, **kw)(flat, starts, lens))
    if dtype == "float32" and op in ("sum", "prod"):
        scale = (window_abs(flat, np.maximum(starts, 0), lens)
                 if op == "sum" else np.abs(want))
        assert_float_close(got, want, scale)
    else:
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_make_mesh_devices():
    mesh = make_mesh(2, 2, devices=["cpu"] * 8, n_wf=2)
    assert mesh.shape == {"kf": 2, "wf": 2, "sp": 2}
    assert mesh.axis_names == ("kf", "wf", "sp")
    assert mesh.devices.shape == (2, 2, 2)
    assert mesh.devices.flat[0] == torch.device("cpu")
    with pytest.raises(ValueError, match=r"needs 8 devices, have 4"):
        make_mesh(4, 2, devices=["cpu"] * 4)
    from windflow_tpu.parallel.mesh import make_mesh as jmake
    with pytest.raises(ValueError, match=r"needs 16 devices, have 8"):
        jmake(4, 4)


def test_make_mesh_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)


# -------------------------------------------------- the kernels' order

def seeded_shard(seed, Ns, B, dtype, op, keep_share=0.7):
    """A shard's slice, keep mask and windows (some past either end, some
    of negative length); float products over values near 1, which stay
    finite."""
    g = np.random.default_rng(seed)
    if dtype == torch.float32 and op == "prod":
        vals = torch.from_numpy(g.uniform(0.98, 1.02, Ns).astype(np.float32))
    elif dtype == torch.float32:
        vals = torch.from_numpy(g.standard_normal(Ns).astype(np.float32) * 50)
        vals[g.integers(0, Ns, 3)] = -0.0
    else:
        vals = torch.from_numpy(g.integers(-(2 ** 31), 2 ** 31 - 1, Ns,
                                           dtype=np.int64).astype(np.int32))
    keep = torch.from_numpy(g.random(Ns) < keep_share)
    starts = torch.from_numpy(g.integers(-80, 2 * Ns, B).astype(np.int32))
    lens = torch.from_numpy(g.integers(-5, Ns + 70, B).astype(np.int32))
    return vals, keep, starts, lens


def long_shard(seed, Ns, dtype, op, keep_share=0.7):
    """A shard's slice and keep mask (as seeded_shard's; float products
    over 1, 2 and 0.5, which multiply exactly in any order) and windows
    around and above mr.SPLIT rows: lengths SPLIT - 1 .. SPLIT + 3 and up
    to 3 * SPLIT + 3 (most not multiples of 4), starts at every residue
    mod 4, windows clipped at the slice's start or end, past Ns, and
    entirely before or after the slice (in the coordinates of base 0)."""
    vals, keep, _, _ = seeded_shard(seed, Ns, 0, dtype, op, keep_share)
    g = np.random.default_rng(seed + 1)
    if dtype == torch.float32 and op == "prod":
        u = g.random(Ns)
        vals = torch.from_numpy(np.where(u < 0.01, 2.0, np.where(
            u < 0.02, 0.5, 1.0)).astype(np.float32))
    S = mr.SPLIT
    fixed = [(1, S), (2, S + 1), (3, S + 2), (0, S + 3), (5, S - 1),
             (Ns - S - 2, S + 2), (-7, 2 * S + 5), (-S, 3 * S + 3),
             (Ns - 100, S + 500), (Ns + 5, 2 * S), (-3 * S, S + 9),
             (-S - 1, Ns + 2 * S)]
    rand = [(int(st), int(ln)) for st, ln in zip(
        g.integers(-2 * S, Ns + S, 14), g.integers(S - 3, 3 * S + 4, 14))]
    starts, lens = zip(*(fixed + rand))
    return (vals, keep, torch.tensor(starts, dtype=torch.int32),
            torch.tensor(lens, dtype=torch.int32))


#: the twins' cases: "short" windows (at most a few hundred rows) over a
#: slice of 333 rows, "long" ones around and above mr.SPLIT over one of
#: 3 * SPLIT + 1000 rows; each with the bases it is held at
TWIN_SHAPES = {"short": (333, (0, 333, -40)),
               "long": (3 * mr.SPLIT + 1000,
                        (0, mr.SPLIT + 1001, -mr.SPLIT // 2 - 3))}
OPS6 = ["sum", "count", "min", "max", "prod", "mean"]
DTYPES = [torch.int32, torch.float32]


def shard_case(shape, seed, dtype, op, short_windows=70):
    Ns, bases = TWIN_SHAPES[shape]
    if shape == "short":
        return (*seeded_shard(seed, Ns, short_windows, dtype, op), bases)
    return (*long_shard(seed, Ns, dtype, op), bases)


def _twin_cases(*axes):
    """pytest params over `axes` (each a list of (value, id)), then the
    "long" shape: a "short" case keeps the id it had before the long
    windows came, a "long" one is prefixed "long-"."""
    import itertools
    cases = []
    for shape in TWIN_SHAPES:
        for combo in itertools.product(*axes):
            ident = "-".join(i for _, i in combo)
            cases.append(pytest.param(
                *(v for v, _ in combo), shape,
                id=ident if shape == "short" else f"{shape}-{ident}"))
    return cases


def _ids(values, prefix=None):
    return [(v, f"{prefix}{i}" if prefix else str(v))
            for i, v in enumerate(values)]


def assert_partial_close(p, t, vals, keep, starts, lens, base, op):
    """Ints, count, min and max equal; float sums within rtol 1e-5 of the
    sum of |x| over the window's kept rows, float products of |x|."""
    if vals.dtype == torch.int32 or op in ("count", "min", "max"):
        assert torch.equal(p.view(torch.int32), t.view(torch.int32))
        return
    Ns = vals.numel()
    lo, hi = mr._bounds(starts, lens, base, Ns)
    k = keep if keep is not None else torch.ones(Ns, dtype=bool)
    scale = torch.stack([
        vals[a:b][k[a:b]].abs().double().sum() if b > a else
        torch.zeros((), dtype=torch.float64)
        for a, b in zip(lo.tolist(), hi.tolist())])
    if op == "prod":
        scale = t.double().abs()
    err = (p.double() - t.double()).abs()
    assert bool((err <= RTOL * scale + 1e-30).all())


@pytest.mark.parametrize("filtered,op,dtype,shape", _twin_cases(
    _ids([False, True]), _ids(OPS6), _ids(DTYPES, "dtype")))
def test_partial_twin_matches_plain(dtype, op, filtered, shape):
    """The CPU twin of sp_window_partial's order against the plain
    version, short windows and windows around and above SPLIT (both
    paths): ints, count, min and max equal; float sums within rtol 1e-5 of
    the sum of |x|, float products within rtol 1e-5 of |x|."""
    vals, keep, starts, lens, bases = shard_case(shape, 3, dtype, op)
    keep = keep if filtered else None
    for base in bases:
        p, c = mr.sp_window_partial(vals, keep, starts, lens, base, op)
        t, tc = mr.partial_order_twin(vals, keep, starts, lens, base, op)
        assert p.dtype == t.dtype == dtype
        if mr.needs_count(op):
            assert torch.equal(c, tc)
        else:
            assert c is None and tc is None
        assert_partial_close(p, t, vals, keep, starts, lens, base, op)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", ["sum", "count", "min", "max", "mean"])
@pytest.mark.parametrize("chunk", [32, 96, mr.CHUNK, 4096])
def test_long_window_twin_matches_plain(dtype, op, chunk):
    """The long-window path of the twin (every window above `split`, cut
    into chunks of `chunk` cells: up to 600 chunks a window, windows of
    one chunk and of a chunk plus a cell) against the plain version with a
    keep mask: ints, counts, min and max exactly; float32 within rtol 1e-5
    of the sum of |x|."""
    split = 64
    Ns = 20_000
    vals, keep, _, _ = seeded_shard(41, Ns, 0, dtype, op)
    g = np.random.default_rng(43)
    starts = np.concatenate([[0, 1, 2, 3, -5, Ns - chunk - 1],
                             g.integers(-3000, Ns, 24)])
    lens = np.concatenate([[chunk, chunk + 1, split + 1, Ns + 9, 3 * chunk,
                            chunk + 3],
                           g.integers(split + 1, 18_000, 24)])
    starts = torch.tensor(starts, dtype=torch.int32)
    lens = torch.tensor(lens, dtype=torch.int32)
    for base in (0, 1234):
        lo, hi = mr._bounds(starts, lens, base, Ns)
        p, c = mr.sp_window_partial_reference(vals, keep, starts, lens,
                                              base, op)
        t, tc = mr.partial_order_twin(vals, keep, starts, lens, base, op,
                                      split=split, chunk=chunk)
        assert bool(((hi - lo) > split).sum() >= 24)
        if mr.needs_count(op):
            assert torch.equal(c, tc)
        assert_partial_close(p, t, vals, keep, starts, lens, base, op)


def test_find_long_windows():
    """The windows whose clipped length exceeds SPLIT, from numpy: SPLIT
    cells stays with its team, SPLIT + 1 does not, in either clip."""
    S, Ns, base = mr.SPLIT, 3 * mr.SPLIT, 100
    starts = np.array([100, 100, 99, 99, Ns + 100 - S, Ns + 99 - S, -S, 0])
    lens = np.array([S, S + 1, S + 1, S + 2, S + 7, S + 7, 2 * S + 100,
                     50])
    got = mr.find_long_windows(starts, lens, base, Ns)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, [1, 3, 5])
    lo, hi = mr._bounds(torch.from_numpy(starts), torch.from_numpy(lens),
                        base, Ns)
    np.testing.assert_array_equal(
        np.flatnonzero((hi - lo).numpy() > S), got)
    assert mr.find_long_windows(starts[:0], lens[:0], 0, Ns).size == 0


@pytest.mark.parametrize("n", [2, 3, 17])
def test_merge_tensor_equals_list(n):
    """An (n, B) tensor and the list of its rows give one result, past the
    16 inline shards too; both equal the plain version."""
    g = np.random.default_rng(47 + n)
    parts = torch.from_numpy(g.integers(-1000, 1000, (n, 1001))
                             .astype(np.int32))
    cnts = torch.from_numpy(g.integers(0, 9, (n, 1001)).astype(np.int32))
    for op in ("sum", "max", "mean"):
        a = mr.sp_merge(parts, cnts, op, ring=True)
        b = mr.sp_merge(list(parts), list(cnts), op, ring=True)
        assert torch.equal(a, b)
        assert torch.equal(a, mr.sp_merge_reference(parts, cnts, op))


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("op", ["sum", "count", "min", "max", "prod", "mean"])
@pytest.mark.parametrize("ring", [False, True])
def test_merge_twin_matches_plain(dtype, op, ring):
    """The CPU twin of sp_merge's fold order (fold_order) against the plain
    version, over 5 shards' partials with NaN-free floats."""
    g = np.random.default_rng(31)
    n, B = 5, 64
    if dtype == torch.float32:
        parts = torch.from_numpy(
            (g.standard_normal((n, B)) * 10).astype(np.float32))
    else:
        parts = torch.from_numpy(g.integers(-(2 ** 31), 2 ** 31 - 1, (n, B),
                                            dtype=np.int64).astype(np.int32))
    cnts = torch.from_numpy(g.integers(0, 40, (n, B)).astype(np.int32))
    got = mr.sp_merge(list(parts), list(cnts), op, ring=ring)
    twin = mr.merge_order_twin(parts, cnts, op, ring=ring)
    assert got.dtype == twin.dtype == (torch.float32 if op == "mean"
                                       else dtype)
    if dtype == torch.int32 and op != "mean" or op in ("min", "max"):
        assert torch.equal(got, twin)
    else:
        scale = (parts.double().abs().sum(dim=0) if op != "prod"
                 else twin.double().abs())
        if op == "mean":
            scale = scale / cnts.long().sum(dim=0).clamp(min=1)
        err = (got.double() - twin.double()).abs()
        assert bool((err <= RTOL * scale + 1e-30).all())


def test_fold_order():
    assert mr.fold_order(4, False) == [0, 1, 2, 3]
    assert mr.fold_order(4, True) == [0, 3, 2, 1]
    assert mr.fold_order(1, True) == [0]


def test_ring_fold_order_within_tolerance_of_jax():
    """The ring twin folds shard 0's value first, then the values JAX's
    ppermute hops bring to shard 0 (x_{n-1}, ..., x_1); the psum twin
    folds 0, 1, ..., n-1.  With float partials chosen so that the order
    matters the two differ; XLA's CPU result follows neither hop order bit
    for bit (it fuses the adds), so JAX and the port's plain version are
    held to the stated tolerance of the sum of |x|."""
    import jax.numpy as jnp
    # one window over 4 sp shards of 4 rows; each shard's partial is its
    # only nonzero value: 1e8, 1, 1, -1e8 in shard order
    vals = np.zeros((1, 16), dtype=np.float32)
    vals[0, [0, 4, 8, 12]] = [1e8, 1.0, 1.0, -1e8]
    starts = np.array([[0]], dtype=np.int32)
    lens = np.array([[16]], dtype=np.int32)
    parts = torch.tensor([[1e8], [1.0], [1.0], [-1e8]], dtype=torch.float32)
    ring = mr.merge_order_twin(parts, None, "sum", ring=True)
    flat = mr.merge_order_twin(parts, None, "sum", ring=False)
    assert float(ring[0]) == 2.0 and float(flat[0]) == 0.0
    jgot = np.asarray(jax_reduce(1, 4, op="sum", dtype=jnp.float32,
                                 collective="ring")(vals, starts, lens))
    got = port_reduce(1, 4, op="sum", dtype="float32", collective="ring")(
        vals, starts, lens)
    scale = window_abs(vals, starts, lens)
    assert_float_close(got, jgot, scale)
    assert_float_close(ring.numpy()[None, :], jgot, scale)


# ------------------------------------------------------------ on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("op,dtype,shape", _twin_cases(
    _ids(OPS6), _ids(DTYPES, "dtype")))
def test_kernels_equal_twins_on_card(dtype, op, shape):
    """Both kernels bit for bit against their twins: three shards (no
    mask, then the mask) of a short-window slice of 5,000 rows or of the
    long-window slice; the merge in both orders."""
    dev = _card()
    if shape == "short":
        Ns = 5000
        vals, keep, starts, lens = seeded_shard(5, Ns, 300, dtype, op)
    else:
        vals, keep, starts, lens, _ = shard_case(shape, 5, dtype, op)
        Ns = vals.numel()
    parts, cnts = [], []
    for s, k in enumerate((None, keep, keep)):
        args = [t.to(dev) for t in (vals, starts, lens)]
        kd = k.to(dev) if k is not None else None
        p, c = mr.sp_window_partial(args[0], kd, args[1], args[2], s * Ns,
                                    op)
        t, tc = mr.partial_order_twin(args[0], kd, args[1], args[2], s * Ns,
                                      op)
        torch.cuda.synchronize()
        assert torch.equal(p.view(torch.int32), t.view(torch.int32))
        if c is not None:
            assert torch.equal(c, tc)
        parts.append(p)
        cnts.append(c if c is not None else torch.zeros_like(starts).to(dev))
    for ring in (False, True):
        got = mr.sp_merge(parts, cnts, op, ring=ring)
        twin = mr.merge_order_twin(torch.stack(parts), torch.stack(cnts), op,
                                   ring=ring)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), twin.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3, 8, 16, 17])
@pytest.mark.parametrize("op", OPS6)
def test_merge_in_place_on_card(n, op):
    """sp_merge of a list of partials on the merging device and of an (n,
    B) tensor (its rows 16-byte aligned or not), B with and without a
    ragged end, past the 16 inline shards too: one launch a call, equal
    to merge_order_twin bit for bit in both orders."""
    dev = _card()
    g = np.random.default_rng(53 + n)
    for dtype in DTYPES:
        for B in (262_144, 1_001):
            if dtype == torch.float32:
                host = (g.standard_normal((n, B)) * 10).astype(np.float32)
                host[0, :7] = np.nan
            else:
                host = g.integers(-(2 ** 31), 2 ** 31 - 1, (n, B),
                                  dtype=np.int64).astype(np.int32)
            parts = torch.from_numpy(host).to(dev)
            cnts = torch.from_numpy(g.integers(0, 40, (n, B))
                                    .astype(np.int32)).to(dev)
            rows = [p.clone() for p in parts]
            crows = [c.clone() for c in cnts]
            for ring in (False, True):
                twin = mr.merge_order_twin(parts, cnts, op, ring=ring)
                for args in ((rows, crows), (parts, cnts)):
                    before = mr.sp_merge.launches
                    got = mr.sp_merge(*args, op, ring=ring)
                    torch.cuda.synchronize()
                    assert mr.sp_merge.launches == before + 1
                    assert torch.equal(got.view(torch.int32),
                                       twin.view(torch.int32))


@pytest.mark.cuda
def test_mesh_on_card_equals_cpu_mesh():
    dev = _card()
    rng = np.random.default_rng(37)
    flat, starts, lens = _random_windows(rng, 2, 4096, 300, 700)
    for op in ("sum", "count", "min", "max", "mean"):
        for collective in ("psum", "ring"):
            kw = dict(op=op, collective=collective, map_fn=lambda v: 3 * v + 1,
                      filter_fn=lambda v: v % 5 != 0)
            cpu = port_reduce(2, 2, 2, **kw)(flat, starts, lens)
            mesh = make_mesh(2, 2, devices=[dev] * 8, n_wf=2)
            card = MeshStreamStep(mesh, **kw)(flat, starts, lens)
            if op == "mean":
                np.testing.assert_allclose(card, cpu, rtol=1e-6)
            else:
                assert card.tobytes() == cpu.tobytes()


# ------------------------------ long windows against JAX

#: float32 prod: each order's rounding error is at most (n - 1) unit
#: roundoffs to first order, so two orders differ by at most 2 (n - 1) u
#: of |x| (u = 2^-24) — the bound the long-window prod twin states
PROD_U = 2.0 ** -24


def _long_windows(seed, KF, N, B):
    """Windows of 2k-10k rows over (KF, N): across the sp boundaries, a
    quarter of them running past N into the padding."""
    g = np.random.default_rng(seed)
    lens = g.integers(2000, 10001, size=(KF, B))
    starts = g.integers(0, N - 1000, size=(KF, B))
    past = g.random((KF, B)) < 0.25
    starts = np.where(past, N - lens // 2, starts)
    return starts.astype(np.int32), lens.astype(np.int32)


@pytest.mark.parametrize("collective", ["psum", "ring"])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("op", OPS6)
def test_long_windows_match_jax(op, dtype, collective):
    """Long windows (2k-10k rows, most of a shard above mr.SPLIT clipped
    rows, so the partial takes its block path) across sp boundaries and
    past N, every op, against JAX's MeshWindowedReduce: ints, counts, min
    and max bit for bit; float32 sum and mean within rtol 1e-5 of the
    window's sum of |x| (over its count for a mean); float32 prod within
    2 (n - 1) 2^-24 of |x| for a window of n rows."""
    KF, N, B, n_sp = 2, 24000, 24, 4
    rng = np.random.default_rng({"int32": 41, "float32": 43}[dtype]
                                + OPS6.index(op))
    if op == "prod" and dtype == "float32":
        flat = rng.uniform(0.999, 1.001, size=(KF, N)).astype(np.float32)
    elif op == "prod":
        flat = rng.integers(-3, 4, size=(KF, N)).astype(np.int32)
    elif dtype == "float32":
        flat = (rng.standard_normal((KF, N)) * 50).astype(np.float32)
    else:
        flat = rng.integers(-50, 50, size=(KF, N)).astype(np.int32)
    starts, lens = _long_windows(7 + OPS6.index(op), KF, N, B)
    kw = dict(op=op, collective=collective,
              dtype=dtype if dtype == "float32" else np.int32)
    got = port_reduce(KF, n_sp, **kw)(flat, starts, lens)
    want = np.asarray(jax_reduce(KF, n_sp, **kw)(flat, starts, lens))
    assert got.shape == want.shape == (KF, B)
    padded = np.zeros((KF, N + 10000), dtype=np.float64)
    padded[:, :N] = flat
    n = np.stack([[len(padded[k, s:s + l]) for s, l in zip(starts[k],
                                                            lens[k])]
                  for k in range(KF)])
    if dtype == "float32" and op in ("sum", "mean"):
        scale = np.stack([[np.abs(padded[k, s:s + l]).sum()
                           for s, l in zip(starts[k], lens[k])]
                          for k in range(KF)])
        assert_float_close(got, want, scale / n if op == "mean" else scale)
    elif dtype == "float32" and op == "prod":
        err = np.abs(got.astype(np.float64) - want.astype(np.float64))
        assert got.dtype == np.float32
        assert (err <= 2 * (n - 1) * PROD_U * np.abs(want)).all(), \
            (err / np.abs(want) / (n - 1)).max()
    else:
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
