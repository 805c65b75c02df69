"""The port's windowed-reduce plain version against the JAX package's
Pallas kernel (interpret mode on the CPU), on the same inputs made with
numpy from a seed; its 2-D (row, start, len) form against JAX's
``_ring_eval``, and its many-evaluation form, through the per-field
executor, against ``_make_multi_step``'s stats.

The kernel's lane-order CPU twin (``wr.lane_order_twin``: which lane
combines which cell, in which order, then the butterfly) is held against
the plain version for every op and dtype, over one flat row and over
rows, many evaluations, unsorted and cross-row windows, and windows that
end at the last row's end.  The CUDA kernel itself is held against the
plain version and, bit for bit, against the twin on the card: the
`cuda`-marked tests here, and chip_smoke.py.

Tolerances: integers must match exactly (including int32 wrap-around);
float32 min/max/count must match exactly (no rounding is involved); float32
sums and products are reduced in a different order by XLA and by torch, so
they are compared with rtol=1e-5 relative to the sum of |x| over the window
(sum) or to |result| (prod) — a few float32 ulps of a 256-term reduction.
"""

import zlib

import numpy as np
import pytest
import torch

from windflow_tpu_torch.ops import windowed_reduce as wr

OPS = ("sum", "count", "min", "max", "prod")
RTOL = 1e-5


def make_inputs(seed, B, pad, dtype, lo=0, hi=100):
    """Ragged windows (lengths 0..pad, zero included) over a flat buffer
    padded so every `pad`-slice from a start is in bounds (the Pallas
    kernel's contract)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, pad + 1, size=B).astype(np.int32)
    lens[::7] = 0
    lens[1::11] = pad
    starts = np.sort(rng.integers(0, 4 * B, size=B)).astype(np.int32)
    n = int(starts.max()) + pad
    if np.dtype(dtype).kind == "f":
        flat = rng.uniform(lo, hi, size=n).astype(dtype)
    else:
        flat = rng.integers(lo, hi, size=n).astype(dtype)
    return flat, starts, lens


def run_both(flat, starts, lens, pad, op):
    # imported here, not at the top: the `cuda` tests below run on a card
    # machine that has torch but no JAX
    from windflow_tpu.ops.pallas_kernels import windowed_reduce_pallas
    want = np.asarray(windowed_reduce_pallas(flat, starts, lens, pad, op,
                                             interpret=True))
    got = wr.windowed_reduce(torch.from_numpy(flat), torch.from_numpy(starts),
                             torch.from_numpy(lens), pad, op).numpy()
    return got, want


def assert_match(got, want, flat, starts, lens, op):
    assert got.dtype == want.dtype and got.shape == want.shape
    if flat.dtype.kind != "f" or op in ("count", "min", "max"):
        np.testing.assert_array_equal(got, want)
    elif op == "sum":
        scale = np.array([np.abs(flat[s:s + l]).sum()
                          for s, l in zip(starts, lens)], dtype=np.float64)
        assert np.all(np.abs(got.astype(np.float64) - want) <= RTOL * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("pad", [8, 32, 256])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("op", OPS)
def test_plain_matches_pallas(op, dtype, pad):
    # prod over many values leaves float32/int32 range: keep its values
    # near 1 so the float comparison is of finite numbers
    lo, hi = ((-2, 3) if op == "prod" and dtype == np.int32
              else (0.9, 1.1) if op == "prod" else (-50, 100))
    flat, starts, lens = make_inputs(pad * 31 + len(op), 64, pad, dtype,
                                     lo, hi)
    got, want = run_both(flat, starts, lens, pad, op)
    assert_match(got, want, flat, starts, lens, op)


@pytest.mark.parametrize("op", ["sum", "prod"])
def test_int32_wraps_like_xla(op):
    """XLA wraps int32 sums and products modulo 2**32: four values of 2**30
    sum to 0, and 2**16 * 2**16 multiplies to 0."""
    v = 2 ** 30 if op == "sum" else 2 ** 16
    flat = np.full(16, v, dtype=np.int32)
    starts = np.zeros(8, dtype=np.int32)
    lens = np.array([4, 3, 2, 1, 0, 4, 2, 1], dtype=np.int32)
    got, want = run_both(flat, starts, lens, 8, op)
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0


@pytest.mark.parametrize("op", ["min", "max", "sum"])
def test_float_nan_propagates(op):
    flat = np.arange(32, dtype=np.float32)
    flat[5] = np.nan
    starts = np.array([0, 4, 8, 2, 6, 0, 20, 5], dtype=np.int32)
    lens = np.array([8, 4, 4, 2, 2, 0, 8, 1], dtype=np.int32)
    got, want = run_both(flat, starts, lens, 8, op)
    np.testing.assert_array_equal(got, want)     # NaN == NaN positionwise
    assert np.isnan(got[[0, 1, 7]]).all() and not np.isnan(got[2])


def test_empty_windows_give_identity():
    flat = np.arange(16, dtype=np.int32)
    starts = np.zeros(8, dtype=np.int32)
    lens = np.zeros(8, dtype=np.int32)
    for op, ident in (("sum", 0), ("prod", 1), ("min", 2 ** 31 - 1),
                      ("max", -2 ** 31), ("count", 0)):
        got, want = run_both(flat, starts, lens, 8, op)
        np.testing.assert_array_equal(got, want)
        assert (got == ident).all()


def test_mean_and_bad_dtype_refused():
    t = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="mean"):
        wr.windowed_reduce(t, t, t, 8, "mean")
    with pytest.raises(TypeError, match="int32 or float32"):
        wr.windowed_reduce(t.double(), t, t, 8, "sum")


def test_cpu_tensor_runs_plain_version_without_counting():
    """A CPU tensor takes the plain version and never touches the kernel's
    launch count (that counts kernel launches only)."""
    before = wr.windowed_reduce.launches
    flat, starts, lens = make_inputs(3, 16, 8, np.int32)
    run_both(flat, starts, lens, 8, "sum")
    assert wr.windowed_reduce.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("op", OPS)
def test_kernel_matches_plain_on_card(op, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    np_dt = np.int32 if dtype == torch.int32 else np.float32
    flat, starts, lens = make_inputs(11, 1003, 256, np_dt)
    args = [torch.from_numpy(a).cuda() for a in (flat, starts, lens)]
    got = wr.windowed_reduce(*args, 256, op).cpu().numpy()
    want = wr.windowed_reduce_reference(*args, 256, op).cpu().numpy()
    assert_match(got, want, flat, starts, lens, op)


# ------------------------------------------- 2-D descriptors, many evaluations

def make_2d(seed, dtype, layout, R=6, ncols=700, B=150, pad=64, op="sum"):
    """An (R, ncols) buffer and B window descriptors (rows, starts, lens):

    * ``sliding``: windows of one row after another, slide 16, as a key's
      fired windows are;
    * ``unsorted``: random rows and starts;
    * ``mixed``: a sliding run, then unsorted windows, with B not a
      multiple of the kernel's 64 windows a block;
    * ``past_end``: starts whose start + len passes the row's end (the
      last cell is read again, as the JAX gathers clamp).

    Lengths run 0..pad, zero and pad included."""
    rng = np.random.default_rng(seed)
    if op == "prod":
        buf = (rng.uniform(0.9, 1.1, size=(R, ncols)) if dtype == np.float32
               else rng.integers(-2, 3, size=(R, ncols)))
    elif dtype == np.float32:
        buf = rng.uniform(-100, 100, size=(R, ncols))
    else:
        buf = rng.integers(-1000, 1000, size=(R, ncols))
    buf = buf.astype(dtype)
    lens = rng.integers(0, pad + 1, size=B)
    lens[::7] = 0
    lens[1::5] = pad
    if layout == "sliding":
        rows = np.repeat(np.arange(R), -(-B // R))[:B]
        starts = (np.arange(B) % -(-B // R)) * 16
    else:
        rows = rng.integers(0, R, size=B)
        starts = rng.integers(0, ncols - pad + 1, size=B)
    if layout == "mixed":
        rows[:80] = 2
        starts[:80] = 5 + np.arange(80) * 7
    if layout == "past_end":
        starts[::3] = ncols - rng.integers(1, pad, size=len(starts[::3]))
    starts = np.minimum(starts, ncols - 1)
    return (buf, rows.astype(np.int32), starts.astype(np.int32),
            lens.astype(np.int32))


def window_abs_sums(buf2d, rows, starts, lens, pad):
    """Σ|x| over each window's cells (the clamped columns), float64."""
    ncols = buf2d.shape[1]
    out = np.zeros(len(starts))
    for w, (r, s, n) in enumerate(zip(rows, starts, lens)):
        n = max(0, min(int(n), pad))
        col = np.minimum(np.maximum(int(s), 0) + np.arange(n), ncols - 1)
        out[w] = np.abs(buf2d[int(r), col].astype(np.float64)).sum()
    return out


def assert_match_2d(got, want, buf2d, rows, starts, lens, pad, op,
                    scale=None):
    """Integers and float min/max/count exactly; float sums within RTOL of
    Σ|x| over the window (or of `scale`); float prod within RTOL of
    |want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind != "f" or op in ("count", "min", "max"):
        np.testing.assert_array_equal(got, want)
    elif op == "sum":
        if scale is None:
            scale = window_abs_sums(buf2d, rows, starts, lens, pad)
        err = np.abs(got.astype(np.float64) - want.astype(np.float64))
        assert np.all(err <= RTOL * scale), float(err.max())
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


LAYOUTS = ("sliding", "unsorted", "mixed", "past_end")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("op", OPS)
def test_twin_matches_plain(op, dtype, layout):
    """The lane-order twin against the plain version over 2-D descriptors:
    integers and float min/max/count exact, float sums within RTOL of Σ|x|
    over the window, float products within RTOL."""
    buf, rows, starts, lens = make_2d(zlib.crc32(f"{op}{layout}".encode())
                                      + (dtype == np.float32), dtype, layout,
                                      op=op)
    args = [torch.from_numpy(a) for a in (buf, rows, starts, lens)]
    evals = [(args[0], op)]
    twin = wr.lane_order_twin(evals, *args[1:], 64)[0].numpy()
    plain = wr.windowed_reduce_many(evals, *args[1:], 64)[0].numpy()
    assert_match_2d(twin, plain, buf, rows, starts, lens, 64, op)


@pytest.mark.parametrize("pad", [1, 33, 256, 300])
def test_twin_many_evaluations_one_row(pad):
    """Every op of both dtypes over one flat row (the restaging form,
    rows=None) in one evaluation list, pads that leave lanes idle and that
    take several trips a lane."""
    rng = np.random.default_rng(pad)
    n = 4 * pad + 100
    flat_i = rng.integers(-3, 4, size=n).astype(np.int32)
    flat_f = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    B = 97
    starts = rng.integers(0, n - pad, size=B).astype(np.int32)
    lens = rng.integers(0, pad + 1, size=B).astype(np.int32)
    lens[:3] = (0, pad, pad + 5)       # a length past pad is clamped
    ti, tf, st, ln = (torch.from_numpy(a)
                      for a in (flat_i, flat_f, starts, lens))
    evals = [(t, op) for op in OPS for t in (ti, tf)]
    twin = wr.lane_order_twin(evals, None, st, ln, pad)
    plain = wr.windowed_reduce_many(evals, None, st, ln, pad)
    for (t, op), a, b in zip(evals, twin, plain):
        assert_match_2d(a.numpy(), b.numpy(), t.numpy()[None, :],
                        np.zeros(B, np.int32), starts, lens, pad, op)


def test_twin_many_evaluations_mixed_rings():
    """sum of an int32 ring, max of a float32 ring, count, min and prod
    over unsorted windows that span several rows, in one evaluation list
    (the native _multi run's stats and more): twin against plain."""
    ri, rows, starts, lens = make_2d(21, np.int32, "mixed")
    rf = np.random.default_rng(22).uniform(-5, 5, size=ri.shape).astype(
        np.float32)
    rp = np.random.default_rng(23).uniform(0.9, 1.1, size=ri.shape).astype(
        np.float32)
    ti, tf, tp = (torch.from_numpy(a) for a in (ri, rf, rp))
    d = [torch.from_numpy(a) for a in (rows, starts, lens)]
    evals = [(ti, "sum"), (tf, "max"), (ti, "count"), (tf, "min"),
             (tp, "prod"), (ti, "max"), (tf, "sum"), (ti, "prod"),
             (tf, "count")]
    twin = wr.lane_order_twin(evals, *d, 64)
    plain = wr.windowed_reduce_many(evals, *d, 64)
    assert len(plain) == len(evals) == 9
    for (t, op), a, b in zip(evals, twin, plain):
        assert a.dtype == t.dtype
        assert_match_2d(a.numpy(), b.numpy(), t.numpy(), rows, starts, lens,
                        64, op)


def test_twin_nan_and_wrap():
    """NaN propagates through min/max/sum in the twin's order as in the
    plain version; int32 sums and products wrap modulo 2**32."""
    buf = torch.arange(64, dtype=torch.float32).reshape(2, 32)
    buf[0, 5] = float("nan")
    buf[1, 31] = float("nan")
    rows = torch.tensor([0, 0, 1, 1, 0], dtype=torch.int32)
    starts = torch.tensor([0, 6, 0, 30, 5], dtype=torch.int32)
    lens = torch.tensor([8, 8, 31, 5, 1], dtype=torch.int32)
    for op in ("min", "max", "sum"):
        a = wr.lane_order_twin([(buf, op)], rows, starts, lens, 8)[0]
        b = wr.windowed_reduce_many([(buf, op)], rows, starts, lens, 8)[0]
        assert torch.isnan(a).tolist() == [True, False, False, True, True]
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(a[~torch.isnan(a)], b[~torch.isnan(b)])
    wrap = torch.full((1, 16), 2 ** 30, dtype=torch.int32)
    z = torch.zeros(2, dtype=torch.int32)
    for op, v in (("sum", 2 ** 30), ("prod", 2 ** 16)):
        wrap.fill_(v)
        got = wr.lane_order_twin([(wrap, op)], z, z,
                              torch.tensor([4, 3], dtype=torch.int32), 8)[0]
        want = wr.windowed_reduce_many([(wrap, op)], z, z,
                                       torch.tensor([4, 3],
                                                    dtype=torch.int32), 8)[0]
        assert torch.equal(got, want) and int(got[0]) == 0


#: (a + len) % 32 of the row-end windows: the last trip of 32 cells holds
#: one 16-byte group of the window (4) or seven (28)
ROW_END_TAILS = (4, 28)


def row_end_case(tail, dtype, R=8, ncols=1024, seed=5):
    """An (R, ncols) buffer (ncols a multiple of 4) and windows that end
    exactly at their row's end, every other one on the last row, whose
    alignment a = (row * ncols + start) % 4 and length give (a + len) % 32
    == tail; a few windows of other lengths end at the last row's end
    too."""
    rng = np.random.default_rng(seed + tail)
    buf = (rng.integers(-1000, 1000, size=(R, ncols)) if dtype == np.int32
           else rng.uniform(0.5, 1.5, size=(R, ncols))).astype(dtype)
    # len ≡ -a mod 4 when the window ends on a 16-byte edge
    lens = np.array([n for n in range(1, 300)
                     if ((-n) % 4 + n) % 32 == tail])
    rows = np.r_[np.arange(len(lens)) % R, np.full(4, R - 1)]
    rows[:len(lens):2] = R - 1
    lens = np.r_[lens, 300, 255, 33, 2]
    return (buf, rows.astype(np.int32), (ncols - lens).astype(np.int32),
            lens.astype(np.int32))


@pytest.mark.parametrize("tail", ROW_END_TAILS)
def test_twin_row_end_windows(tail):
    """Windows that end at their row's end, on the last row too, with the
    last trip of 32 cells holding one group of the window or seven: every
    op of both dtypes, twin against plain."""
    for dtype in (np.int32, np.float32):
        buf, rows, starts, lens = row_end_case(tail, dtype)
        tails = ((rows * buf.shape[1] + starts) % 4 + lens) % 32
        assert len(tails) > 8 and (tails[:-4] == tail).all()
        d = [torch.from_numpy(a) for a in (buf, rows, starts, lens)]
        evals = [(d[0], op) for op in OPS]
        twin = wr.lane_order_twin(evals, *d[1:], 300)
        plain = wr.windowed_reduce_many(evals, *d[1:], 300)
        for (_, op), a, b in zip(evals, twin, plain):
            assert_match_2d(a.numpy(), b.numpy(), buf, rows, starts, lens,
                            300, op)


@pytest.mark.parametrize("op", ["sum", "min", "max", "prod"])
@pytest.mark.parametrize("acc", [np.int32, np.float32])
def test_2d_matches_jax_ring_eval(op, acc):
    """windowed_reduce_many over (row, start, len) descriptors, and the
    twin, against JAX's _ring_eval on the same ring and windows (windows
    inside their row, as the executors guarantee).  float sums against
    XLA's cumsum difference within RTOL of Σ|x| over the row prefix."""
    from windflow_tpu.ops.resident import _ring_eval
    ring, rows, starts, lens = make_2d(zlib.crc32(op.encode()) + 7, acc,
                                       "unsorted", R=8, ncols=512, B=120,
                                       pad=32, op=op)
    starts = np.minimum(starts, 512 - lens).astype(np.int32)
    want = np.asarray(_ring_eval(op, 512, 32, np.dtype(acc), ring, rows,
                                 starts, lens))
    d = [torch.from_numpy(a) for a in (ring, rows, starts, lens)]
    got = wr.windowed_reduce_many([(d[0], op)], *d[1:], 32)[0].numpy()
    twin = wr.lane_order_twin([(d[0], op)], *d[1:], 32)[0].numpy()
    prefix = np.array([np.abs(ring[r, :s + n].astype(np.float64)).sum()
                       for r, s, n in zip(rows, starts, lens)])
    for a in (got, twin):
        assert_match_2d(a, want, ring, rows, starts, lens, 32, op,
                        scale=prefix)


def test_many_matches_jax_multi_step():
    """The per-field executor (one windowed-reduce evaluation list for
    every stat, on the CPU) against JAX's _make_multi_step on the same
    rings, rectangles and windows: int32 stats exactly, float32 min/max
    exactly, float32 sums within RTOL of Σ|x| over the row prefix."""
    from windflow_tpu.ops.resident import _make_multi_step
    from windflow_tpu_torch.ops.resident import MultiFieldResidentExecutor
    rng = np.random.default_rng(31)
    KP, cap, Rb, B, pad = 8, 256, 16, 90, 32
    fields = ("a", "b")
    accs = (np.dtype(np.int32), np.dtype(np.float32))
    stats = (("sum", "a"), ("max", "b"), ("min", "a"), ("sum", "b"),
             ("prod", "a"), ("max", "a"))
    rings = (rng.integers(-2, 3, size=(KP, cap)).astype(np.int32),
             rng.uniform(-50, 50, size=(KP, cap)).astype(np.float32))
    blks = {"a": rng.integers(-2, 3, size=(KP, Rb)).astype(np.int8),
            "b": rng.uniform(-50, 50, size=(KP, Rb)).astype(np.float32)}
    offs = rng.integers(0, cap - Rb + 1, size=KP).astype(np.int32)
    rows = rng.integers(0, KP, size=B).astype(np.int32)
    lens = rng.integers(0, pad + 1, size=B).astype(np.int32)
    starts = rng.integers(0, cap - lens + 1).astype(np.int32)
    key = (fields, stats, None, cap, Rb, B, KP, ("int8", "float32"),
           tuple(a.name for a in accs), pad)
    step = _make_multi_step(key, None)
    z = np.zeros(B, np.int32)
    want_rings, want = step(rings, (blks["a"], blks["b"]), offs, rows,
                            starts, lens, z, z)
    ex = MultiFieldResidentExecutor(fields, stats,
                                    acc_dtypes=dict(zip(fields, accs)),
                                    device="cpu")
    ex.reset(KP, cap)
    ex._rings = tuple(torch.from_numpy(r.copy()) for r in rings)
    ex.launch("m", blks, offs, rows, starts, lens)
    [(meta, got)] = ex.drain()
    assert meta == "m" and len(got) == len(stats)
    after = {f: np.asarray(r) for f, r in zip(fields, want_rings)}
    for f, r in zip(fields, ex._rings):
        assert r.numpy().tobytes() == after[f].tobytes()
    for (op, f), g, w in zip(stats, got, want):
        ring = after[f]
        prefix = np.array([np.abs(ring[r, :s + n].astype(np.float64)).sum()
                           for r, s, n in zip(rows, starts, lens)])
        assert_match_2d(g, np.asarray(w), ring, rows, starts, lens, pad, op,
                        scale=prefix)


def test_refuses_bad_evaluations():
    t = torch.zeros((2, 8), dtype=torch.int32)
    z = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="mean"):
        wr.windowed_reduce_many([(t, "mean")], z, z, z, 4)
    with pytest.raises(TypeError, match="one shape"):
        wr.windowed_reduce_many([(t, "sum"), (t[:1], "max")], z, z, z, 4)
    with pytest.raises(ValueError, match="rows=None"):
        wr.windowed_reduce_many([(t.view(-1), "sum")], z, z, z, 4)
    with pytest.raises(TypeError, match="rows"):
        wr.windowed_reduce_many([(t, "sum")], z.long(), z, z, 4)
    with pytest.raises(ValueError, match="at least one"):
        wr.windowed_reduce_many([], z, z, z, 4)


def test_resident_descriptors_past_2_31_cells(monkeypatch):
    """A ring of KP * cap >= 2**31 cells (16 x 2**28 int32): the launch
    stages each window as (row, start, len) in ring coordinates, with no
    flat product row * cap + start and no overflow, and evaluates every op
    in one evaluation list.  Only the host arithmetic runs: the ring is a
    meta tensor (no memory), the kernels are stand-ins that record what
    they get."""
    from windflow_tpu_torch.ops import resident
    KP, cap = 16, 2 ** 28
    seen = {}

    def append_eval(ring, blk, offs, evals, rows, starts, lens, pad,
                    long=None):
        seen.update(evals=[(ring, op) for op in evals], rows=rows.clone(),
                    starts=starts.clone(), lens=lens.clone(), pad=pad,
                    long=long)
        return [torch.zeros(len(starts), dtype=torch.int32) for _ in evals]

    monkeypatch.setattr(resident, "ring_append_eval", append_eval)
    ex = resident.ResidentWindowExecutor(("sum", "max"), device="cpu")
    ex.reset(KP - 3, cap)
    assert (ex.KP, ex.cap) == (KP, cap) and ex.KP * ex.cap >= 2 ** 31
    ex._ring = torch.empty((KP, cap), dtype=torch.int32, device="meta")
    assert not hasattr(ex, "_check_flat_view")
    wrows = np.array([KP - 1, KP - 1, 9, 0], dtype=np.int32)
    wstarts = np.array([cap - 256, cap - 300, cap - 1, 0], dtype=np.int32)
    wlens = np.array([256, 300, 1, 5], dtype=np.int32)
    blk = np.zeros((KP - 3, 4), dtype=np.int8)
    offs = np.full(KP - 3, cap - 8, dtype=np.int64)
    ex.launch("m", blk, offs, wrows, wstarts, wlens)
    assert [op for _, op in seen["evals"]] == ["sum", "max"]
    assert all(r is ex._ring for r, _ in seen["evals"])
    assert seen["rows"].tolist() == wrows.tolist()
    assert seen["starts"].tolist() == wstarts.tolist()
    assert seen["lens"].tolist() == wlens.tolist()
    assert seen["pad"] == 512
    assert seen["long"].n == 0 and seen["long"].dev.tolist() == [0]
    # the flat offsets of the last row's cells are past 2**31
    assert (KP - 1) * cap + int(wstarts[0]) > 2 ** 31
    vec = resident.launch_vec(KP, offs, 4, (wrows, wstarts, wlens))
    assert vec.dtype == np.int32
    assert vec[:KP - 3].tolist() == offs.tolist() and not vec[KP - 3:KP].any()
    assert vec[KP:].tolist() == [*wrows, *wstarts, *wlens]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def bits(t):
    return t.view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_kernel_equals_twin_bitwise_on_card(dtype, layout):
    """Every op over 2-D descriptors in one launch: the kernel equals the
    lane-order twin bit for bit, and two launches are bitwise equal."""
    need_card()
    for pad in (64, 256, 300):
        buf, rows, starts, lens = make_2d(pad + (dtype == np.float32),
                                          dtype, layout, ncols=2000, B=400,
                                          pad=pad)
        d = [torch.from_numpy(a).cuda() for a in (buf, rows, starts, lens)]
        evals = [(d[0], op) for op in OPS]
        got = [wr.windowed_reduce_many(evals, *d[1:], pad) for _ in range(2)]
        twin = wr.lane_order_twin(evals, *d[1:], pad)
        torch.cuda.synchronize()
        for a, b, t in zip(got[0], got[1], twin):
            assert torch.equal(bits(a), bits(b))
            assert torch.equal(bits(a), bits(t))


@pytest.mark.cuda
@pytest.mark.parametrize("tail", ROW_END_TAILS)
def test_row_end_windows_on_card(tail):
    """Windows that end at their row's end, the last row's included, on a
    16 MiB buffer of its own allocation: the kernel equals the twin bit for
    bit (its vector loads stop at the window's last 16-byte group, so
    none reaches past the buffer)."""
    need_card()
    for dtype in (np.int32, np.float32):
        buf, rows, starts, lens = row_end_case(tail, dtype, R=64,
                                               ncols=65536)
        d = [torch.from_numpy(a).cuda() for a in (buf, rows, starts, lens)]
        evals = [(d[0], op) for op in OPS]
        got = wr.windowed_reduce_many(evals, *d[1:], 300)
        twin = wr.lane_order_twin(evals, *d[1:], 300)
        torch.cuda.synchronize()
        for a, t in zip(got, twin):
            assert torch.equal(bits(a), bits(t))


@pytest.mark.cuda
def test_many_evaluations_on_card():
    """Nine evaluations over an int32 and a float32 ring (two launches of
    at most eight): the kernel equals the twin bit for bit and is held
    against the plain version."""
    need_card()
    ri, rows, starts, lens = make_2d(41, np.int32, "mixed", ncols=3000,
                                     B=700, pad=256)
    rf = np.random.default_rng(42).uniform(-5, 5, size=ri.shape).astype(
        np.float32)
    ti, tf = torch.from_numpy(ri).cuda(), torch.from_numpy(rf).cuda()
    d = [torch.from_numpy(a).cuda() for a in (rows, starts, lens)]
    evals = [(ti, "sum"), (tf, "max"), (ti, "count"), (tf, "min"),
             (tf, "prod"), (ti, "max"), (tf, "sum"), (ti, "prod"),
             (tf, "count")]
    before = wr.windowed_reduce.launches
    got = wr.windowed_reduce_many(evals, *d, 256)
    assert wr.windowed_reduce.launches - before == 2
    twin = wr.lane_order_twin(evals, *d, 256)
    plain = wr.windowed_reduce_many_reference(evals, *d, 256)
    torch.cuda.synchronize()
    for (t, op), a, b, p in zip(evals, got, twin, plain):
        assert torch.equal(bits(a), bits(b))
        assert_match_2d(a.cpu().numpy(), p.cpu().numpy(), t.cpu().numpy(),
                        rows, starts, lens, 256, op)
