"""The port's ring_append_eval (ops/ring.py: the append and every op of an
irregular resident dispatch in one kernel launch, csrc/resident.cu) on the
CPU, where it runs its plain version, against the JAX package's
``_append_eval`` (windflow_tpu/ops/resident.py, run eagerly on the CPU),
on the same inputs made with numpy from a seed; its executors,
``ResidentWindowExecutor`` and ``MeshResidentExecutor`` on CPU devices,
against the JAX executors that run ``_make_step`` and ``_make_mesh_step``;
and ``append_eval_order_twin`` (the kernel's combine order: 8-lane teams
for short windows, chunks folded in order for long ones) against the plain
version.

Window sets: short windows; long windows of 2k-40k cells (past the
kernel's split, so the card cuts them into chunks); windows that straddle
the appended span; windows into the rectangle's zero columns (Rb > R);
windows on rows >= K (zero rows of the rectangle); windows past the ring's
end; no window (B = 0, the append alone).

Tolerances: the rings must be byte-identical; integer results, counts,
min and max equal bit for bit (int32 sums and products wrap modulo 2^32 in
both packages).  float32 sums: XLA takes a cumsum difference whose
rounding is that of the row's running prefix, so against JAX they are
held within rtol 1e-5 of the sum of |x| over the row's prefix up to the
window's end, and against the plain version within rtol 1e-5 of the sum
of |x| over the window.  float32 products: within max(1e-5, 2 (n - 1)
2^-24) of |x| for a window of n cells (two product orders' first-order
bound).  A window past the ring's end reads the last column again for
each cell past it (the clamped gather of JAX's min, max and prod); JAX's
sum is a cumsum difference that stops at the end, so there the port's
sum is JAX's plus the repeated cells (test_past_the_end_sum).  The CUDA
kernel is held against the plain version and, bit for bit, against the
twin on the card (chip_smoke.py's append_eval phase and the `cuda`-marked
test here)."""

import zlib

import numpy as np
import pytest
import torch

from windflow_tpu_torch.ops import ring as rk

RTOL = 1e-5
WIRES = (np.int8, np.int16, np.int32)
ACCS = (np.int32, np.float32)
OPSETS = (("sum", "min", "max"), ("prod",))
WINDOWS = ("short", "long", "straddle", "zero_columns", "rows_ge_k",
           "past_the_end", "none")
KP, K, RB, R = 8, 6, 64, 40


def seed_of(*parts) -> int:
    return zlib.crc32(" ".join(str(np.dtype(p)) if isinstance(p, type)
                               else str(p) for p in parts).encode())


def values(rng, dtype, shape, prod):
    """int32/float32 ring values or wire values: products stay finite."""
    dtype = np.dtype(dtype)
    if prod:
        if dtype.kind == "f":
            return rng.uniform(0.999, 1.001, size=shape).astype(dtype)
        return rng.choice(np.array([-1, 1, 1, 2]), size=shape).astype(dtype)
    if dtype.kind == "f":
        return rng.uniform(-100, 100, size=shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -1000), min(info.max, 1000) + 1,
                        size=shape).astype(dtype)


def make_case(seed, wire, acc, ops, windows):
    """A ring, a (KP, Rb) rectangle with rows >= K and columns >= R zero,
    per-row offsets, and the window set's (rows, starts, lens)."""
    rng = np.random.default_rng(seed)
    prod = "prod" in ops
    cap = 49152 if windows == "long" else 1024
    ring = values(rng, acc, (KP, cap), prod)
    blk = np.zeros((KP, RB), dtype=wire)
    blk[:K, :R] = values(rng, wire, (K, R), prod)
    offs = rng.integers(0, cap - RB + 1, size=KP).astype(np.int32)
    offs[:4] = np.minimum(cap - RB, 4 * (offs[:4] // 4) + np.arange(4))
    B = 24
    rows = rng.integers(0, K, size=B)
    if windows == "short":
        lens = rng.integers(0, 65, size=B)
        starts = rng.integers(0, cap - lens + 1)
    elif windows == "long":
        B = 10
        rows = rng.integers(0, KP, size=B)
        lens = rng.integers(2000, 40001, size=B)
        lens[0] = 40000
        starts = rng.integers(0, cap - lens + 1)
        # two of them across the appended span
        starts[1:3] = np.clip(offs[rows[1:3]] - lens[1:3] // 2, 0,
                              cap - lens[1:3])
    elif windows == "straddle":
        before = rng.integers(0, 40, size=B)
        after = rng.integers(-RB, 40, size=B)
        starts = np.maximum(offs[rows] - before, 0)
        lens = np.maximum(offs[rows] + RB + after - starts, 0)
        lens = np.minimum(lens, cap - starts)
    elif windows == "zero_columns":
        starts = offs[rows] + rng.integers(R - 4, RB, size=B)
        lens = np.minimum(rng.integers(1, 40, size=B), cap - starts)
    elif windows == "rows_ge_k":
        rows = rng.integers(K, KP, size=B)
        starts = np.maximum(offs[rows] - rng.integers(0, 20, size=B), 0)
        lens = np.minimum(rng.integers(1, RB + 40, size=B), cap - starts)
    elif windows == "past_the_end":
        rows = rng.integers(0, KP, size=B)
        starts = rng.integers(cap - 40, cap, size=B)
        lens = cap - starts + rng.integers(1, 40, size=B)
        offs[rows[0]] = cap - RB        # the last columns appended too
    else:
        B = 0
        rows = starts = lens = np.zeros(0, dtype=np.int64)
    pad = int(max(1, int(lens.max(initial=1))))
    return dict(ring=ring, blk=blk, offs=offs.astype(np.int32),
                rows=rows.astype(np.int32), starts=starts.astype(np.int32),
                lens=lens.astype(np.int32), cap=cap, pad=pad)


def port(case, ops, fn=rk.ring_append_eval, **kw):
    ring = torch.from_numpy(case["ring"].copy())
    outs = fn(ring, torch.from_numpy(case["blk"]),
              torch.from_numpy(case["offs"]), list(ops),
              *(torch.from_numpy(case[k]) for k in ("rows", "starts",
                                                    "lens")),
              case["pad"], **kw)
    return ring.numpy(), [o.numpy() for o in outs]


def window_cells(ring, r, s, n):
    """The window's cells: columns min(s + j, cap - 1), j < n."""
    cap = ring.shape[1]
    return ring[r, np.minimum(s + np.arange(n), cap - 1)]


def prod_tol(want, n):
    return np.maximum(RTOL, 2 * np.maximum(n - 1, 0) * 2.0 ** -24) \
        * np.abs(want.astype(np.float64))


def assert_vs_jax(op, got, want, ring, case):
    """got (the port's) against JAX's want (the stated tolerances)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind != "f" or op in ("min", "max"):
        np.testing.assert_array_equal(got, want)
        return
    err = np.abs(got.astype(np.float64) - want)
    n = np.minimum(case["lens"], case["pad"]).astype(np.int64)
    if op == "sum":
        # XLA's cumsum difference: the rounding of the row prefix [0, s+n)
        scale = np.array([np.abs(ring[r, :s + k].astype(np.float64)).sum()
                          for r, s, k in zip(case["rows"], case["starts"],
                                             n)])
        assert np.all(err <= RTOL * scale)
    else:
        assert np.all(err <= prod_tol(want, n))


def assert_vs_plain(op, got, want, ring, case):
    """got (the twin's) against the plain version's want."""
    if got.dtype.kind != "f" or op in ("count", "min", "max"):
        assert got.tobytes() == want.tobytes()
        return
    n = np.clip(case["lens"], 0, case["pad"]).astype(np.int64)
    err = np.abs(got.astype(np.float64) - want)
    if op == "sum":
        scale = np.array([np.abs(window_cells(ring, r, s, k)
                                 .astype(np.float64)).sum()
                          for r, s, k in zip(case["rows"], case["starts"],
                                             n)])
        assert np.all(err <= RTOL * scale)
    else:
        assert np.all(err <= prod_tol(want, n))


def jax_append_eval(case, ops, acc):
    from windflow_tpu.ops.resident import _append_eval
    ring, outs = _append_eval(tuple(ops), case["cap"], case["pad"],
                              np.dtype(acc), case["ring"], case["blk"],
                              case["offs"], case["rows"], case["starts"],
                              case["lens"])
    return np.asarray(ring), [np.asarray(o) for o in outs]


@pytest.mark.parametrize("windows", WINDOWS)
@pytest.mark.parametrize("ops", OPSETS, ids="+".join)
@pytest.mark.parametrize("acc", ACCS, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("wire", WIRES, ids=lambda d: np.dtype(d).name)
def test_matches_jax_append_eval(wire, acc, ops, windows):
    """The plain version (what ring_append_eval runs on a CPU tensor)
    against JAX's _append_eval: the ring after the append and every op;
    count (a port op: JAX's resident step has none) gives the lengths."""
    case = make_case(seed_of("jax", wire, acc, "+".join(ops), windows),
                     wire, acc, ops, windows)
    want_ring, want = jax_append_eval(case, ops, acc)
    ring, got = port(case, (*ops, "count"))
    assert ring.tobytes() == want_ring.tobytes()
    assert got[-1].tobytes() == case["lens"].astype(acc).tobytes()
    for op, g, w in zip(ops, got, want):
        if op == "sum" and windows == "past_the_end":
            continue     # test_past_the_end_sum
        assert_vs_jax(op, g, w, ring, case)


@pytest.mark.parametrize("acc", ACCS, ids=lambda d: np.dtype(d).name)
def test_past_the_end_sum(acc):
    """A window past the ring's end: the port's sum reads the last column
    for every cell past it, as JAX's min, max and prod gathers do; JAX's
    sum (a cumsum difference at clamped indices) stops at the end.  The
    executors never launch such a window (the host core keeps windows
    inside the ring)."""
    case = make_case(seed_of("past", acc), np.int16, acc, ("sum",),
                     "past_the_end")
    want_ring, (want,) = jax_append_eval(case, ("sum",), acc)
    ring, (got,) = port(case, ("sum",))
    cap = case["cap"]
    extra = np.maximum(case["starts"].astype(np.int64) + case["lens"] - cap,
                       0)
    shifted = (want.astype(np.float64)
               + extra * ring[case["rows"], cap - 1].astype(np.float64))
    if acc == np.int32:
        shifted = ((shifted.astype(np.int64) + 2 ** 31) % 2 ** 32
                   - 2 ** 31).astype(np.int32)
        assert got.tobytes() == shifted.tobytes()
    else:
        scale = np.array([np.abs(ring[r, :].astype(np.float64)).sum()
                          + k * abs(float(ring[r, cap - 1]))
                          for r, k in zip(case["rows"], extra)])
        assert np.all(np.abs(got - shifted) <= RTOL * scale)
    assert extra.min() > 0 and ring.tobytes() == want_ring.tobytes()


SPLITS = ((rk.LONG_SPLIT, rk.LONG_CHUNK), (64, 32), (0, 32), (300, 128))


@pytest.mark.parametrize("split,chunk", SPLITS, ids=lambda v: str(v))
@pytest.mark.parametrize("windows", WINDOWS)
@pytest.mark.parametrize("acc", ACCS, ids=lambda d: np.dtype(d).name)
def test_twin_matches_plain(acc, windows, split, chunk):
    """The kernel's order twin against the plain version, with the
    default split and chunk and with small ones (so short windows take
    the chunked path here): every op and count, the rings identical."""
    for ops in OPSETS:
        case = make_case(seed_of("twin", acc, "+".join(ops), windows),
                         np.int8, acc, ops, windows)
        kw = dict(split=split, chunk=chunk)
        ring_t, twin = port(case, (*ops, "count"),
                            fn=rk.append_eval_order_twin, **kw)
        ring_p, plain = port(case, (*ops, "count"))
        assert ring_t.tobytes() == ring_p.tobytes()
        for op, t, p in zip((*ops, "count"), twin, plain):
            assert_vs_plain(op, t, p, ring_p, case)


def test_twin_long_window_chunk_order():
    """A long float32 window's twin value is the in-order fold of its
    chunks' team sums: recomputed here chunk by chunk with the short
    twin (each chunk a window of its own, aligned at a 16-byte group)."""
    rng = np.random.default_rng(3)
    cap, n, chunk = 8192, 5000, 512
    ring = torch.from_numpy(rng.uniform(-1, 1, size=(1, cap))
                            .astype(np.float32))
    none = torch.zeros((1, 0), dtype=torch.int8)
    z = torch.zeros(1, dtype=torch.int32)
    s = 8                              # a group boundary: a = 0
    args = (torch.tensor([s], dtype=torch.int32),
            torch.tensor([n], dtype=torch.int32), n)
    (got,) = rk.append_eval_order_twin(ring.clone(), none, z, ["sum"], z,
                                       *args, split=1024, chunk=chunk)
    acc = torch.tensor(0.0)
    for c0 in range(0, n, chunk):
        m = min(chunk, n - c0)
        (part,) = rk.append_eval_order_twin(
            ring.clone(), none, z, ["sum"], z,
            torch.tensor([s + c0], dtype=torch.int32),
            torch.tensor([m], dtype=torch.int32), m, split=cap, chunk=chunk)
        acc = acc + part[0]
    assert got.view(torch.int32).item() == acc.view(torch.int32).item()


def test_long_windows_plan():
    """The long-window list: windows past the split, their first chunks
    counted from the window's first 16-byte group of the ring."""
    rows = np.array([0, 1, 2, 1])
    starts = np.array([0, 5, 100, 3])
    lens = np.array([3000, 100, 5000, 2049])
    plan = rk.long_windows(rows, starts, lens, 8192, 10002)
    # window 2: flat (2 * 10002 + 100) % 4 = 0; window 3: (10002 + 3) % 4
    # = 1, so its 2049 cells span 513 groups, 5 chunks of 128
    assert plan.n == 3 and plan.vec.tolist() == [0, 2, 3, 0, 6, 16, 21]
    assert plan.chunks == 21
    # pad cuts the lengths first: 2100 cells, 525 or 526 groups
    assert rk.long_windows(rows, starts, lens, 2100, 10002).vec.tolist() \
        == [0, 2, 3, 0, 5, 10, 15]
    with pytest.raises(ValueError, match="multiple of 32"):
        rk.long_windows(rows, starts, lens, 8192, 10002, chunk=48)


def test_refuses_bad_inputs():
    ring = torch.zeros((4, 64), dtype=torch.int32)
    blk = torch.zeros((4, 8), dtype=torch.int8)
    offs = torch.zeros(4, dtype=torch.int32)
    v = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 8"):
        rk.ring_append_eval(ring, blk, offs, ["sum"] * 9, v, v, v, 4)
    with pytest.raises(ValueError, match="mean"):
        rk.ring_append_eval(ring, blk, offs, ["mean"], v, v, v, 4)
    with pytest.raises(TypeError, match="lens"):
        rk.ring_append_eval(ring, blk, offs, ["sum"], v, v, v.long(), 4)
    with pytest.raises(TypeError, match="blk"):
        rk.ring_append_eval(ring, blk[:3], offs, ["sum"], v, v, v, 4)


def test_cpu_tensors_do_not_count_launches():
    before = rk.ring_append_eval.launches
    case = make_case(1, np.int8, np.int32, ("sum",), "short")
    port(case, ("sum",))
    assert rk.ring_append_eval.launches == before


def test_card_path_raises_rather_than_falls_back(monkeypatch):
    """On the card path (forced here) the wrapper loads the kernel
    library, and a refused launch raises with the CUDA error: no plain
    version runs in its place."""
    calls = []

    class Lib:
        def wf_ring_append_eval(self, *args):
            calls.append(args)
            return 1

    monkeypatch.setattr(rk, "_on_card", lambda name, *tensors: True)
    monkeypatch.setattr(rk, "_load", lambda: Lib())
    monkeypatch.setattr(rk, "_stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    monkeypatch.setattr(rk.ring_append_eval_reference, "__code__",
                        (lambda *a, **k: pytest.fail("plain ran")).__code__)
    case = make_case(2, np.int8, np.int32, ("sum",), "short")
    before = rk.ring_append_eval.launches
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        port(case, ("sum",))
    assert len(calls) == 1 and rk.ring_append_eval.launches == before


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# ------------------------------------------------------------- executors

def launches(seed, K_, cap_, n=4, long=True):
    """A sequence of irregular dispatches: rectangles of R rows at each
    key's write offset, and windows (short, and some long ones) over what
    the ring holds after them."""
    rng = np.random.default_rng(seed)
    R_ = 700
    out, end = [], np.zeros(K_, dtype=np.int64)
    for i in range(n):
        blk = rng.integers(-100, 100, size=(K_, R_)).astype(np.int16)
        offs = end.copy()
        end += R_
        B = 30
        rows = rng.integers(0, K_, size=B)
        lens = rng.integers(0, 300, size=B)
        if long and i >= 2:
            lens[:3] = (2100, 2500, min(2800, int(end.min())))
        lens = np.minimum(lens, end[rows])
        starts = end[rows] - lens - rng.integers(0, 100, size=B)
        starts = np.maximum(starts, 0)
        out.append((blk, offs, rows.astype(np.int32),
                    starts.astype(np.int32), lens.astype(np.int32)))
    return out


def run_executor(ex, seq, K_, cap_):
    ex.reset(K_, cap_)
    for i, (blk, offs, rows, starts, lens) in enumerate(seq):
        ex.launch(i, blk, offs, rows, starts, lens)
    ready = ex.drain()
    snap = ex.ring_snapshot()
    data = snap.resolve() if hasattr(snap, "resolve") else snap
    return ready, np.asarray(data["rings"][0])


def assert_ready_equal(got, want, ops, acc):
    assert [m for m, _ in got] == [m for m, _ in want]
    for (_, g), (_, w) in zip(got, want):
        g = g if isinstance(g, tuple) else (g,)
        w = w if isinstance(w, tuple) else (w,)
        for op, a, b in zip(ops, g, w):
            a, b = np.asarray(a), np.asarray(b)
            if np.dtype(acc).kind != "f" or op in ("min", "max"):
                assert a.tobytes() == b.astype(a.dtype).tobytes(), op
            else:
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("ops", [("sum",), ("max",), ("sum", "min", "max")],
                         ids="+".join)
def test_executor_matches_jax_make_step(ops):
    """ResidentWindowExecutor (device="cpu": one ring_append_eval a
    dispatch, its plain version) against the JAX executor's _make_step
    over a sequence of dispatches with long windows: every result and
    the ring."""
    from windflow_tpu.ops.resident import ResidentWindowExecutor as JEx

    from windflow_tpu_torch.ops.resident import ResidentWindowExecutor
    K_, cap_ = 5, 4096
    seq = launches(seed_of("exec", "+".join(ops)), K_, cap_)
    op = ops[0] if len(ops) == 1 else ops
    got, ring = run_executor(ResidentWindowExecutor(op, device="cpu"), seq,
                             K_, cap_)
    want, jring = run_executor(JEx(op), seq, K_, cap_)
    assert ring.tobytes() == jring.tobytes()
    assert_ready_equal(got, want, ops, np.int32)


@pytest.mark.parametrize("n_kf", [2, 4])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_mesh_executor_matches_jax_mesh_step(op, n_kf):
    """MeshResidentExecutor on a mesh of CPU devices (one ring_append_eval
    a shard a dispatch) against the JAX mesh executor's _make_mesh_step on
    the virtual CPU devices: every result and the ring in the global
    layout."""
    from windflow_tpu.ops.resident import MeshResidentExecutor as JMesh
    from windflow_tpu.parallel.mesh import make_mesh as jmake

    from windflow_tpu_torch.ops.resident import MeshResidentExecutor
    from windflow_tpu_torch.parallel import make_mesh
    K_, cap_ = 7, 4096
    seq = launches(seed_of("mesh", op, n_kf), K_, cap_)
    mesh = make_mesh(n_kf, devices=["cpu"] * n_kf)
    got, ring = run_executor(MeshResidentExecutor(op, mesh), seq, K_, cap_)
    want, jring = run_executor(JMesh(op, jmake(n_kf)), seq, K_, cap_)
    assert ring.tobytes() == jring.tobytes()
    assert_ready_equal(got, want, (op,), np.int32)


def test_executor_launches_one_kernel_a_dispatch(monkeypatch):
    """Each dispatch of both executors calls ring_append_eval exactly once
    a ring (a mesh: once on every shard, with or without windows) and
    never ring_append or windowed_reduce_many; its inputs stay referenced
    until the harvest."""
    from windflow_tpu_torch.ops import resident
    from windflow_tpu_torch.ops import windowed_reduce as wr
    from windflow_tpu_torch.parallel import make_mesh
    calls = []
    orig = resident.ring_append_eval

    def counting(ring, *args, **kw):
        calls.append(kw["long"])
        return orig(ring, *args, **kw)

    monkeypatch.setattr(resident, "ring_append_eval", counting)
    for mod, name in ((rk, "ring_append"), (wr, "windowed_reduce_many")):
        monkeypatch.setattr(mod, name,
                            lambda *a, **k: pytest.fail("old pair called"))
    seq = launches(5, 5, 4096)
    run_executor(resident.ResidentWindowExecutor("sum", device="cpu"), seq,
                 5, 4096)
    assert len(calls) == len(seq)
    # the 3 long windows of each of the last 2 dispatches, listed
    assert sum(c.n for c in calls) == 6
    calls.clear()
    mesh = make_mesh(4, devices=["cpu"] * 4)
    run_executor(resident.MeshResidentExecutor("max", mesh), seq, 5, 4096)
    assert len(calls) == 4 * len(seq)


@pytest.mark.cuda
@pytest.mark.parametrize("split,chunk", SPLITS, ids=lambda v: str(v))
@pytest.mark.parametrize("acc", ACCS, ids=lambda d: np.dtype(d).name)
def test_kernel_equals_twin_bitwise_on_card(acc, split, chunk):
    """On the card: the kernel equals the twin bit for bit and the plain
    version within the stated tolerances, every window set; one launch a
    call; the counters left at zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    for windows in WINDOWS:
        for ops in OPSETS:
            case = make_case(seed_of("card", acc, "+".join(ops), windows),
                             np.int8, acc, ops, windows)
            d = {k: torch.from_numpy(np.ascontiguousarray(case[k])).cuda()
                 for k in ("ring", "blk", "offs", "rows", "starts", "lens")}
            long = rk.long_windows(case["rows"], case["starts"],
                                   case["lens"], case["pad"], case["cap"],
                                   split, chunk)
            counters = torch.zeros(long.n + 1, dtype=torch.int32,
                                   device="cuda")
            args = (d["blk"], d["offs"], [*ops, "count"], d["rows"],
                    d["starts"], d["lens"], case["pad"])
            before = rk.ring_append_eval.launches
            ring = d["ring"].clone()
            got = rk.ring_append_eval(ring, *args, long=long,
                                      counters=counters)
            assert rk.ring_append_eval.launches == before + 1
            ring_t = d["ring"].clone()
            twin = rk.append_eval_order_twin(ring_t, *args, split=split,
                                             chunk=chunk)
            torch.cuda.synchronize()
            assert torch.equal(ring, ring_t) and not bool(counters.any())
            for g, t in zip(got, twin):
                assert torch.equal(g.view(torch.int32), t.view(torch.int32))
