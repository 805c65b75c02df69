"""The mesh reduction at float16, int8, int16, uint8 and uint16
(``MeshWindowedReduce`` / ``MeshStreamStep`` over ``sp_window_partial``
and ``sp_merge``) against the JAX package's ``MeshWindowedReduce`` in its
default config, on the same numpy inputs, on (kf, sp, wf) meshes of 2 and
4 CPU devices (JAX's virtual CPU devices beside them).

JAX's result dtypes: a sum or product of int8 or int16 is int32, of uint8
or uint16 uint32 (``jnp.sum``/``jnp.prod`` promote); min, max and count
keep the dtype (a count wraps: a window of 128 kept rows counts -128 in
int8); mean is float32, float16 for float16, and divides by
``jnp.maximum(c, 1).astype(dtype)`` — the count wrapped into the dtype, so
a uint8 window of 256 kept rows divides by 0 (inf) and an int8 one of 128
by -128.  The port follows all of it (no recorded divergence).  float16
partials are float16 (XLA reduces in float32 and rounds once); the psum
and the ring's hops combine float16 values, rounding at each step; prod's
all_gather fold rounds once.

Tolerances: integer results, counts, min and max bit for bit; float16
sums, means and products within one float16 ulp of JAX's value plus
2**-9 of the window's Σ|x| (over the count for mean; |P| for a product):
the port and XLA accumulate a partial in float32 in other orders and
round once, and the merge rounds as JAX's collective does.  The kernels'
order twins against the plain versions: integers bit for bit, float16
within two float16 ulps."""

import numpy as np
import pytest
import torch

from windflow_tpu_torch.ops import mesh_reduce as mr

NARROW = (torch.float16, torch.int8, torch.int16, torch.uint8, torch.uint16)
OPS = ("sum", "count", "min", "max", "prod", "mean")
#: (kf, sp, wf): meshes of 2 and 4 shards
SHAPES = ((1, 2, 1), (2, 2, 1), (1, 4, 1), (2, 1, 2))
N = 6000


def name(d) -> str:
    return str(d).replace("torch.", "")


def np_of(d):
    return torch.empty(0, dtype=d).numpy().dtype


def mesh_inputs(dtype, kf, seed):
    """(flat, starts, lens): integer rows spanning past the dtype's range
    (they wrap in the cast), floats in [-4, 4) (float16 past 65504 in no
    window); windows across the sp boundary, past the split, of 128 and
    256 rows (counts that wrap in int8 and uint8), empty ones, and ones
    that run past N."""
    rng = np.random.default_rng(seed)
    if dtype == torch.float16:
        flat = rng.uniform(-4, 4, (kf, N)).astype(np.float32)
    else:
        flat = rng.integers(-70000, 70000, (kf, N)).astype(np.int32)
    starts = rng.integers(0, N - 300, (kf, 44))
    lens = rng.integers(1, 300, (kf, 44))
    starts[:, :8] = [100, 2000, 2500, 2990, 0, 17, 5990, 4000]
    lens[:, :8] = [5000, 128, 256, 512, 0, 2600, 300, 1]
    return flat, starts.astype(np.int32), lens.astype(np.int32)


def window_abs(flat, starts, lens, rows, keep=None):
    """Σ|x| of each window's rows (zeros past N), and its kept count."""
    v = np.zeros((flat.shape[0], rows))
    v[:, :flat.shape[1]] = np.abs(flat.astype(np.float64))
    k = np.ones_like(v, dtype=bool) if keep is None else keep
    out, cnt = np.zeros(starts.shape), np.zeros(starts.shape)
    for g in range(flat.shape[0]):
        for i, (s, n) in enumerate(zip(starts[g], lens[g])):
            e = min(s + n, rows)
            out[g, i] = np.where(k[g, s:e], v[g, s:e], 0).sum()
            cnt[g, i] = k[g, s:e].sum()
    return out, cnt


def assert_f16_close(got, want, op, absval, cnt):
    """One float16 ulp of JAX's value plus 2**-9 of the window's Σ|x|
    (over the count for mean; of |P| for prod); NaN where JAX has NaN."""
    g, w = got.astype(np.float64), want.astype(np.float64)
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    with np.errstate(invalid="ignore"):
        ulp = np.spacing(np.abs(want)).astype(np.float64)
        scale = (np.abs(w) if op == "prod" else
                 absval / np.maximum(cnt, 1) if op == "mean" else absval)
        ok = np.abs(g - w) <= ulp + 2.0 ** -9 * scale
    assert bool((same | ok).all()), op


def port_and_jax(dtype, shape, op, coll, flat, starts, lens, chain):
    from windflow_tpu.parallel.mesh import MeshWindowedReduce as J
    from windflow_tpu.parallel.mesh import make_mesh as jmake

    from windflow_tpu_torch.parallel import MeshStreamStep, make_mesh
    kf, sp, wf = shape
    kw = dict(op=op, dtype=dtype, collective=coll)
    if chain:
        kw.update(map_fn=lambda v: 3 * v + 1,
                  filter_fn=lambda v: v % 5 != 0)
    got = MeshStreamStep(make_mesh(kf, sp, devices=["cpu"] * (kf * sp * wf),
                                   n_wf=wf), **kw)(flat, starts, lens)
    want = J(jmake(kf, sp, n_wf=wf), **{**kw, "dtype": np_of(dtype)})(
        flat, starts, lens)
    return got, want


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", NARROW, ids=name)
def test_mesh_reduce_matches_jax(dtype, shape):
    """Every op with psum and ring: JAX's result dtype, integers bit for
    bit (sums and products in int32/uint32, counts wrapping, means over
    the wrapped count), float16 by the stated rule."""
    flat, starts, lens = mesh_inputs(dtype, shape[0], 3 + shape[1])
    rows = mr_rows(shape)
    absval, cnt = window_abs(flat, starts, lens, rows)
    for op in OPS:
        for coll in ("psum", "ring"):
            got, want = port_and_jax(dtype, shape, op, coll, flat, starts,
                                     lens, chain=False)
            assert got.dtype == want.dtype, (op, got.dtype, want.dtype)
            assert got.dtype == np_of(mr.merge_out(op, dtype))
            if dtype == torch.float16 and op in ("sum", "mean", "prod"):
                assert_f16_close(got, want, op, absval, cnt)
            else:
                assert got.tobytes() == want.tobytes(), (op, coll)


def mr_rows(shape):
    """The padded rows of a group (JAX's and the port's layout)."""
    from windflow_tpu_torch.ops.device import _bucket
    sp = shape[1]
    return _bucket(max(-(-N // sp), 1)) * sp


@pytest.mark.parametrize("dtype", NARROW, ids=name)
def test_stream_step_chain_matches_jax(dtype):
    """MeshStreamStep at pipe_test's chain (map 3v+1, filter v % 5 != 0:
    filtered rows leave every op, count and mean included) on a (2, 2, 2)
    mesh, every op, psum and ring, against JAX."""
    shape = (2, 2, 2)
    flat, starts, lens = mesh_inputs(dtype, 2, 41)
    rows = mr_rows(shape)
    v = np.zeros((2, rows))
    v[:, :N] = flat
    mapped = 3 * v + 1
    keep = (mapped % 5 != 0) if dtype != torch.float16 else (
        np.fmod(mapped.astype(np.float32), 5) != 0)
    absval, cnt = window_abs(mapped, starts, lens, rows, keep)
    for op in OPS:
        for coll in ("psum", "ring"):
            got, want = port_and_jax(dtype, shape, op, coll, flat, starts,
                                     lens, chain=True)
            assert got.dtype == want.dtype, (op, got.dtype, want.dtype)
            if dtype == torch.float16 and op in ("sum", "mean", "prod"):
                assert_f16_close(got, want, op, absval, cnt)
            else:
                assert got.tobytes() == want.tobytes(), (op, coll)


def test_mean_divides_by_the_wrapped_count():
    """JAX's mean divides by max(count, 1) cast into the dtype, and so does
    the port's: a uint8 window of 256 rows divides by 0 (inf), an int8 one
    of 128 by -128 (the mean's sign flips), an int16 one of 256 by 256."""
    from windflow_tpu.parallel.mesh import MeshWindowedReduce as J
    from windflow_tpu.parallel.mesh import make_mesh as jmake

    from windflow_tpu_torch.parallel import MeshWindowedReduce, make_mesh
    flat = np.full((1, 1024), 3, dtype=np.int32)
    starts = np.array([[0, 0, 0]], np.int32)
    lens = np.array([[128, 256, 255]], np.int32)
    want_of = {torch.uint8: [3.0, np.inf, 3.0],
               torch.int8: [-3.0, np.inf, -765.0],
               torch.int16: [3.0, 3.0, 3.0]}
    for dtype, want in want_of.items():
        got = MeshWindowedReduce(make_mesh(1, 2, devices=["cpu"] * 2),
                                 op="mean", dtype=dtype)(flat, starts, lens)
        jax_got = J(jmake(1, 2), op="mean", dtype=np_of(dtype))(
            flat, starts, lens)
        assert got.dtype == jax_got.dtype == np.float32
        assert got.tobytes() == jax_got.tobytes(), dtype
        np.testing.assert_allclose(got[0], np.array(want, np.float32),
                                   rtol=1e-6)


def test_partial_and_merge_dtypes():
    """partial_dtype and merge_out follow JAX's dtypes; the identities the
    kernels start from are the narrow dtype's in its 4-byte holder."""
    for d, held in ((torch.int8, torch.int32), (torch.int16, torch.int32),
                    (torch.uint8, torch.uint32),
                    (torch.uint16, torch.uint32)):
        for op in ("sum", "prod", "mean"):
            assert mr.partial_dtype(op, d) == held
        for op in ("count", "min", "max"):
            assert mr.partial_dtype(op, d) == mr.merge_out(op, d) == d
        assert mr.merge_out("sum", d) == held
        assert mr.merge_out("mean", d) == torch.float32
    assert mr.merge_out("mean", torch.float16) == torch.float16
    assert mr.partial_dtype("sum", torch.float16) == torch.float16
    assert mr._ident_bits("min", torch.int8) == 127
    assert mr._ident_bits("max", torch.int8) == 2 ** 32 - 128
    assert mr._ident_bits("min", torch.uint16) == 65535
    assert mr._ident_bits("min", torch.float16) == int(
        np.array(np.inf, np.float32).view(np.uint32))
    with pytest.raises(TypeError, match="mesh reduction runs in"):
        mr._check_op("sum", torch.bfloat16)
    t = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="partials of sum over"):
        mr.sp_merge([torch.zeros(4, dtype=torch.int8)] * 2, None, "sum")
    with pytest.raises(TypeError, match="mesh reduction runs in"):
        mr.sp_window_partial(torch.zeros(4, dtype=torch.bfloat16), None, t,
                             t, 0, "sum")


def seeded(dtype, n, rng):
    if dtype == torch.float16:
        return torch.from_numpy(rng.uniform(-4, 4, n).astype(np.float16))
    info = np.iinfo(np_of(dtype))
    return torch.from_numpy(rng.integers(info.min, int(info.max) + 1, n)
                            .astype(np_of(dtype)))


def close(got, want, op):
    """Bit for bit, but float16 sums, means and products within two
    float16 ulps (the twin's order is the kernel's, the plain version's
    torch's)."""
    if got.dtype != torch.float16 or op in ("count", "min", "max"):
        return got.dtype == want.dtype and got.numpy().tobytes() == \
            want.numpy().tobytes()
    g, w = got.double().numpy(), want.double().numpy()
    with np.errstate(invalid="ignore"):
        tol = 2 * np.spacing(np.abs(want.numpy())).astype(np.float64)
        return bool((((g == w) | (np.isnan(g) & np.isnan(w)))
                     | (np.abs(g - w) <= tol)).all())


@pytest.mark.parametrize("split,chunk", [(mr.SPLIT, mr.CHUNK), (64, 32)],
                         ids=str)
@pytest.mark.parametrize("dtype", NARROW, ids=name)
def test_twins_match_plain(dtype, split, chunk):
    """partial_order_twin and merge_order_twin against the plain versions
    at each new dtype, with a keep mask, windows past `split` cut into
    chunks, both merge orders, 2-5 shards and mean (whose count wraps);
    the partials in partial_dtype."""
    rng = np.random.default_rng(22)
    Ns, B = 6000, 60
    vals = seeded(dtype, Ns, rng)
    keep = torch.from_numpy(rng.random(Ns) < 0.7)
    starts = rng.integers(-50, Ns, B)
    lens = rng.integers(0, 300, B)
    lens[:6] = [2100, 2500, 4000, 5900, 366, 183]
    starts[:6] = [0, 7, 1000, 50, 9, 9]
    st = torch.from_numpy(starts.astype(np.int32))
    ln = torch.from_numpy(lens.astype(np.int32))
    for op in OPS:
        twin = mr.partial_order_twin(vals, keep, st, ln, 9, op, split=split,
                                     chunk=chunk)
        plain = mr.sp_window_partial(vals, keep, st, ln, 9, op)
        assert twin[0].dtype == plain[0].dtype == mr.partial_dtype(op, dtype)
        assert close(twin[0], plain[0], op), op
        assert (twin[1] is None) == (plain[1] is None)
        if twin[1] is not None:
            assert torch.equal(twin[1], plain[1])
        for n in (2, 5):
            parts = torch.stack([plain[0], twin[0]] * 2 + [plain[0]])[:n]
            cnts = (torch.stack([plain[1]] * n) if plain[1] is not None
                    else None)
            for ring in (False, True):
                mt = mr.merge_order_twin(parts, cnts, op, ring, dtype)
                mp = mr.sp_merge(parts, cnts, op, ring=ring, dtype=dtype)
                assert mt.dtype == mp.dtype == mr.merge_out(op, dtype)
                assert close(mt, mp, op), (op, ring, n)


def test_float16_merge_rounds_as_jax_collectives():
    """float16 partials 2048 and three 1s: the psum (and the ring's hops)
    round at every add, 2048 + 1 + 1 + 1 = 2048 in shard order; ring
    order 0, 3, 2, 1 over 1, 2048, 1, 1 gives 2052; prod's gather fold
    rounds once.  The plain merge and the twin agree with JAX's mesh."""
    from windflow_tpu.parallel.mesh import MeshWindowedReduce as J
    from windflow_tpu.parallel.mesh import make_mesh as jmake

    from windflow_tpu_torch.parallel import MeshWindowedReduce, make_mesh
    Ns = 1024
    for first, want in (((2048.0, 1.0), {"psum": 2048.0, "ring": 2048.0}),
                        ((1.0, 2048.0), {"psum": 2048.0, "ring": 2052.0})):
        flat = np.zeros((1, 4 * Ns), np.float32)
        flat[0, ::Ns] = first + (1.0, 1.0)
        args = (flat, np.array([[0]], np.int32),
                np.array([[4 * Ns]], np.int32))
        for coll in ("psum", "ring"):
            got = MeshWindowedReduce(make_mesh(1, 4, devices=["cpu"] * 4),
                                     op="sum", dtype=torch.float16,
                                     collective=coll)(*args)
            jax_got = J(jmake(1, 4), op="sum", dtype=np.float16,
                        collective=coll)(*args)
            assert float(got[0, 0]) == float(jax_got[0, 0]) == want[coll]
    parts = torch.tensor([[2048.0], [1.0], [1.0], [1.0]],
                         dtype=torch.float16)
    assert float(mr.merge_order_twin(parts, None, "sum")) == 2048.0
    assert float(mr.sp_merge(parts, None, "sum")) == 2048.0
    assert float(mr.sp_merge(parts, None, "sum", ring=True)) == 2048.0


# ----------------------------------------------------------------- card

def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", NARROW, ids=name)
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
    for op in OPS:
        before = mr.sp_window_partial.launches
        got = mr.sp_window_partial(vals.to(dev), keep.to(dev), st.to(dev),
                                   ln.to(dev), 50, op)
        torch.cuda.synchronize()
        assert mr.sp_window_partial.launches == before + 1
        twin = mr.partial_order_twin(vals, keep, st, ln, 50, op)
        assert got[0].cpu().numpy().tobytes() == twin[0].numpy().tobytes()
        for n in (2, 3, 9, 17):
            parts = torch.stack([got[0]] * n)
            cnts = torch.stack([got[1]] * n) if got[1] is not None else None
            before = mr.sp_merge.launches
            m = mr.sp_merge(list(parts), None if cnts is None
                            else list(cnts), op, ring=n % 2 == 1,
                            dtype=dtype)
            torch.cuda.synchronize()
            assert mr.sp_merge.launches == before + 1
            mt = mr.merge_order_twin(parts.cpu(), None if cnts is None
                                     else cnts.cpu(), op, n % 2 == 1, dtype)
            assert m.cpu().numpy().tobytes() == mt.numpy().tobytes(), (op, n)
