"""The port's ring_append_multi_eval (ops/ring.py: the per-field resident
step in one kernel launch, csrc/resident.cu) on the CPU, where it runs its
plain version: its executors, ``MultiFieldResidentExecutor`` and
``MeshMultiFieldResidentExecutor`` on CPU devices, against the JAX
executors that run ``_make_multi_step`` and ``_make_mesh_multi_step``
(windflow_tpu/ops/resident.py, JAX on its virtual CPU devices), on the
same dispatches made with numpy from a seed; and
``multi_append_eval_order_twin`` (the kernel's combine order) against the
plain version.

The dispatches mix wires (int8, int16, float32) and rings (int32,
float32), take 9 stats (two launches on the card: at most 8 a launch),
and hold windows longer than ``ring.LONG_SPLIT`` cells (on the card the
chunk path), with and without a window function (a masked sum of x*y
over two fields).

Tolerances: the rings must be byte-identical; integer results and
float32 min and max equal bit for bit (int32 sums and products wrap
modulo 2^32 in both packages).  float32 sums: XLA takes a cumsum
difference whose rounding is that of the row's running prefix, so they
are held within rtol 1e-5 of the sum of |x| over the row's prefix up to
the window's end (the tolerance of test_torch_windowed_reduce.py's
test_many_matches_jax_multi_step); the function's masked sum within rtol
1e-5 of the sum of |x*y| over the window; against the plain version,
float32 sums within rtol 1e-5 of the sum of |x| over the window.  Tiles
and masks are copies: equal bit for bit.  The CUDA kernel is held against
the plain version and, bit for bit, against the twin on the card
(chip_smoke.py's multi_append_eval phase and the `cuda`-marked test
here)."""

import zlib

import numpy as np
import pytest
import torch

from windflow_tpu_torch.ops import ring as rk

RTOL = 1e-5
#: fields of the executor tests: (wire, ring dtype)
FIELDS = {"a": (np.int8, np.int32), "b": (np.int16, np.int32),
          "x": (np.float32, np.float32), "y": (np.float32, np.float32)}
#: 9 stats: more than a launch takes
STATS = (("sum", "a"), ("max", "a"), ("prod", "b"), ("min", "b"),
         ("sum", "b"), ("sum", "x"), ("max", "x"), ("min", "y"),
         ("sum", "y"))
SPLITS = ((rk.LONG_SPLIT, rk.LONG_CHUNK), (64, 32), (0, 32), (300, 128))
#: 10 fields, x and y the ninth and tenth: more than a launch takes (8)
WIDE = {**{f: FIELDS[g] for f, g in zip("acdeghij", "abxyabxy")},
        "x": FIELDS["x"], "y": FIELDS["y"]}
#: 12 stats over both launches' fields
WIDE_STATS = (("sum", "a"), ("max", "c"), ("min", "d"), ("sum", "e"),
              ("prod", "g"), ("sum", "h"), ("max", "i"), ("sum", "j"),
              ("sum", "x"), ("min", "y"), ("max", "a"), ("sum", "c"))


def seed_of(*parts) -> int:
    return zlib.crc32(" ".join(str(p) for p in parts).encode())


def port_xy(keys, gwids, cols, mask):
    return torch.where(mask, cols["x"] * cols["y"], 0).sum(dim=1)


def jax_xy(keys, gwids, cols, mask):
    import jax.numpy as jnp
    return jnp.sum(jnp.where(mask, cols["x"] * cols["y"], 0), axis=1)


def window_fns(with_fn):
    if not with_fn:
        return None, None
    import windflow_tpu_torch as wt
    from windflow_tpu.patterns import win_seq_tpu as jw
    kw = dict(fields=("x", "y"), result_fields={"v": np.float32})
    return (wt.TorchWindowFunction(port_xy, **kw),
            jw.JaxWindowFunction(jax_xy, **kw))


def dispatches(seed, K, n=4, R=700, fields=FIELDS):
    """A sequence of per-field dispatches: each field's (K, R) rectangle
    in its wire dtype at every key's write offset, and windows (short,
    and long ones past the split from the third dispatch on) over what
    the rings hold after it."""
    rng = np.random.default_rng(seed)
    out, end = [], np.zeros(K, dtype=np.int64)
    for i in range(n):
        blks = {}
        for f, (wire, _acc) in fields.items():
            if np.dtype(wire).kind == "f":
                blks[f] = rng.uniform(-100, 100, size=(K, R)).astype(wire)
            elif wire == np.int16:      # product-friendly values
                blks[f] = rng.choice(np.array([-1, 1, 1, 2]),
                                     size=(K, R)).astype(wire)
            else:
                blks[f] = rng.integers(-100, 100, size=(K, R)).astype(wire)
        offs = end.copy()
        end += R
        B = 30
        rows = rng.integers(0, K, size=B)
        lens = rng.integers(0, 300, size=B)
        if i >= 2:
            lens[:3] = (2100, 1500, min(2600, int(end.min())))
        lens = np.minimum(lens, end[rows])
        starts = np.maximum(end[rows] - lens - rng.integers(0, 100, size=B),
                            0)
        keys = rng.integers(0, 1000, size=B)
        gwids = rng.integers(0, 1 << 20, size=B)
        out.append((blks, offs, rows, starts, lens, keys, gwids))
    return out


def run_executor(ex, seq, K, cap):
    ex.reset(K, cap)
    for i, (blks, offs, rows, starts, lens, keys, gwids) in enumerate(seq):
        ex.launch(i, blks, offs, rows, starts, lens, wkeys=keys,
                  wgwids=gwids)
    ready = ex.drain()
    snap = ex.ring_snapshot()
    data = snap.resolve() if hasattr(snap, "resolve") else snap
    return ready, [np.asarray(r) for r in data["rings"]]


def assert_matches_jax(got, want, rings, seq, with_fn, phys=None,
                       fields=FIELDS, stats=STATS):
    """Every dispatch's outputs: the stats (ints and float min/max
    exact; float sums within RTOL of the row prefix's sum of |x|), then
    the function's (within RTOL of the window's sum of |x*y|).  `phys`
    maps a dense ring row to its row in `rings` (a mesh snapshot's global
    layout)."""
    ring = dict(zip(fields, rings))
    assert [m for m, _ in got] == [m for m, _ in want]
    for (i, g), (_, w) in zip(got, want):
        _blks, _offs, rows, starts, lens, _k, _g = seq[i]
        rows = rows if phys is None else phys(rows)
        g = g if isinstance(g, tuple) else (g,)
        w = w if isinstance(w, tuple) else (w,)
        assert len(g) == len(w) == len(stats) + bool(with_fn)
        for (op, f), a, b in zip(stats, g, w):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype == fields[f][1], (op, f)
            if a.dtype.kind != "f" or op in ("min", "max"):
                assert a.tobytes() == b.tobytes(), (i, op, f)
                continue
            # the final ring's prefix: the windows read cells the later
            # dispatches do not overwrite
            scale = np.array([np.abs(ring[f][r, :s + n].astype(np.float64))
                              .sum() for r, s, n in zip(rows, starts, lens)])
            assert np.all(np.abs(a.astype(np.float64) - b) <= RTOL * scale)
        if with_fn:
            a, b = np.asarray(g[-1]), np.asarray(w[-1])
            scale = np.array([
                np.abs(ring["x"][r, s:s + n].astype(np.float64)
                       * ring["y"][r, s:s + n]).sum()
                for r, s, n in zip(rows, starts, lens)])
            assert np.all(np.abs(a.astype(np.float64) - b)
                          <= RTOL * np.maximum(scale, 1e-30))


def accs(fields=FIELDS):
    return {f: acc for f, (_w, acc) in fields.items()}


@pytest.mark.parametrize("with_fn", [False, True], ids=["stats", "stats+fn"])
def test_executor_matches_jax_multi_step(with_fn):
    """MultiFieldResidentExecutor (device="cpu": one ring_append_multi_eval
    a dispatch, its plain version) against the JAX executor's
    _make_multi_step over a sequence of dispatches with long windows:
    every result and every field's ring."""
    from windflow_tpu.ops.resident import MultiFieldResidentExecutor as JEx

    from windflow_tpu_torch.ops.resident import MultiFieldResidentExecutor
    K, cap = 5, 4096
    seq = dispatches(seed_of("exec", with_fn), K)
    pfn, jfn = window_fns(with_fn)
    got, rings = run_executor(MultiFieldResidentExecutor(
        tuple(FIELDS), STATS, fn=pfn, acc_dtypes=accs(), device="cpu"),
        seq, K, cap)
    want, jrings = run_executor(JEx(tuple(FIELDS), STATS, jax_fn=jfn,
                                    acc_dtypes=accs()), seq, K, cap)
    for r, j in zip(rings, jrings):
        assert r.dtype == j.dtype and r.tobytes() == j.tobytes()
    assert_matches_jax(got, want, rings, seq, with_fn)


@pytest.mark.parametrize("with_fn", [False, True], ids=["stats", "stats+fn"])
@pytest.mark.parametrize("n_kf", [0, 2])
def test_executor_of_10_fields_matches_jax(n_kf, with_fn):
    """10 fields and 12 stats, more than a launch takes (on the card a
    launch for each group of 8 fields, the function's x and y in the
    second): the executor (n_kf 0) and the mesh executor on CPU devices
    against the JAX executors' _make_multi_step and
    _make_mesh_multi_step, every result and every field's ring."""
    from windflow_tpu.ops import resident as jr
    from windflow_tpu.parallel.mesh import make_mesh as jmake

    from windflow_tpu_torch.ops import resident
    from windflow_tpu_torch.parallel import make_mesh
    K, cap = 5, 4096
    seq = dispatches(seed_of("wide", n_kf, with_fn), K, fields=WIDE)
    pfn, jfn = window_fns(with_fn)
    kw = dict(fn=pfn, acc_dtypes=accs(WIDE))
    jkw = dict(jax_fn=jfn, acc_dtypes=accs(WIDE))
    if n_kf:
        ex = resident.MeshMultiFieldResidentExecutor(
            tuple(WIDE), WIDE_STATS, mesh=make_mesh(
                n_kf, devices=["cpu"] * n_kf), **kw)
        jex = jr.MeshMultiFieldResidentExecutor(
            tuple(WIDE), WIDE_STATS, mesh=jmake(n_kf), **jkw)
    else:
        ex = resident.MultiFieldResidentExecutor(tuple(WIDE), WIDE_STATS,
                                                 device="cpu", **kw)
        jex = jr.MultiFieldResidentExecutor(tuple(WIDE), WIDE_STATS, **jkw)
    got, rings = run_executor(ex, seq, K, cap)
    want, jrings = run_executor(jex, seq, K, cap)
    for r, j in zip(rings, jrings):
        assert r.dtype == j.dtype and r.tobytes() == j.tobytes()
    assert_matches_jax(got, want, rings, seq, with_fn, fields=WIDE,
                       stats=WIDE_STATS,
                       phys=(lambda r: r % n_kf * ex.rps + r // n_kf)
                       if n_kf else None)


@pytest.mark.parametrize("with_fn", [False, True], ids=["stats", "stats+fn"])
@pytest.mark.parametrize("n_kf", [2, 4])
def test_mesh_executor_matches_jax_mesh_multi_step(n_kf, with_fn):
    """MeshMultiFieldResidentExecutor on a mesh of CPU devices (one
    ring_append_multi_eval a shard a dispatch) against the JAX mesh
    executor's _make_mesh_multi_step on the virtual CPU devices: every
    result and every field's ring in the global layout."""
    from windflow_tpu.ops.resident import (
        MeshMultiFieldResidentExecutor as JMesh)
    from windflow_tpu.parallel.mesh import make_mesh as jmake

    from windflow_tpu_torch.ops.resident import (
        MeshMultiFieldResidentExecutor)
    from windflow_tpu_torch.parallel import make_mesh
    K, cap = 7, 4096
    seq = dispatches(seed_of("mesh", n_kf, with_fn), K)
    pfn, jfn = window_fns(with_fn)
    ex = MeshMultiFieldResidentExecutor(
        tuple(FIELDS), STATS, fn=pfn, acc_dtypes=accs(),
        mesh=make_mesh(n_kf, devices=["cpu"] * n_kf))
    got, rings = run_executor(ex, seq, K, cap)
    want, jrings = run_executor(JMesh(tuple(FIELDS), STATS, jax_fn=jfn,
                                      acc_dtypes=accs(), mesh=jmake(n_kf)),
                                seq, K, cap)
    for r, j in zip(rings, jrings):
        assert r.dtype == j.dtype and r.tobytes() == j.tobytes()
    # dense row r lives on shard r % n_kf at local row r // n_kf
    assert_matches_jax(got, want, rings, seq, with_fn,
                       phys=lambda r: r % n_kf * ex.rps + r // n_kf)


# ------------------------------------------------------ twin vs plain

WIRES = (np.int8, np.int16, np.int32, np.float32)
ACCS = (np.int32, np.float32)


def values(rng, dtype, shape, prod):
    dtype = np.dtype(dtype)
    if prod:
        if dtype.kind == "f":
            return rng.uniform(0.999, 1.001, size=shape).astype(dtype)
        return rng.choice(np.array([-1, 1, 1, 2]), size=shape).astype(dtype)
    if dtype.kind == "f":
        return rng.uniform(-100, 100, size=shape).astype(dtype)
    return rng.integers(-100, 100, size=shape).astype(dtype)


def make_case(seed, nf=None):
    """1-5 fields (or `nf`) of mixed wire and ring dtypes, the last with
    neither stat nor tile; offsets at every residue mod 4; windows short,
    long, across the rectangle's edges, into its zero columns and rows,
    past the row's end, or none; 0-12 stats (a field of products takes
    prod and count only); tiles of some fields."""
    rng = np.random.default_rng(seed)
    nf = int(rng.integers(1, 6)) if nf is None else nf
    KP, K, Rb, R = 8, 6, 48, int(rng.integers(1, 49))
    cap = int(rng.choice([256, 1040, 6000]))
    live = max(nf - 1, 1)
    prods = rng.random(live) < 0.3
    evals = []
    for _ in range(int(rng.choice([0, 1, 3, 8, 9, 12]))):
        f = int(rng.integers(0, live))
        evals.append((f, str(rng.choice(
            ("prod", "count") if prods[f]
            else ("sum", "count", "min", "max")))))
    rings, blks = [], []
    for f in range(nf):
        wire, acc = WIRES[int(rng.integers(0, 4))], ACCS[int(rng.integers(0,
                                                                         2))]
        prod = f < live and bool(prods[f])
        rings.append(values(rng, acc, (KP, cap), prod))
        blk = np.zeros((KP, Rb), dtype=wire)
        blk[:K, :R] = values(rng, wire, (K, R), prod)
        blks.append(blk)
    tiles = [f for f in range(live) if rng.random() < 0.6]
    offs = rng.integers(0, cap - Rb + 1, size=KP)
    offs[:4] = np.minimum(cap - Rb, 4 * (offs[:4] // 4) + np.arange(4))
    B = int(rng.choice([0, 7, 40]))
    rows = rng.integers(0, KP, size=B)
    lens = rng.integers(0, min(cap, 3000), size=B)
    starts = rng.integers(0, cap - lens + 1)
    if B >= 5:
        starts[0], lens[0] = offs[rows[0]] + R, Rb - R + 2    # zero columns
        starts[1], lens[1] = max(0, offs[rows[1]] - 5), Rb + 10
        lens[2] = -3
        starts[3], lens[3] = cap - 1, 9                       # past the end
        rows[4] = 7                                           # a zero row
    pad = int(rng.choice([max(1, int(lens.max(initial=1))), 5, 37]))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return dict(rings=[t(r) for r in rings], blks=[t(b) for b in blks],
                offs=t(offs.astype(np.int32)), evals=evals,
                tile_fields=tiles, rows=t(rows.astype(np.int32)),
                starts=t(starts.astype(np.int32)),
                lens=t(lens.astype(np.int32)), pad=pad)


def run(case, fn, **kw):
    rings = [r.clone() for r in case["rings"]]
    outs, tiles, mask = fn(rings, case["blks"], case["offs"], case["evals"],
                           case["rows"], case["starts"], case["lens"],
                           case["pad"], case["tile_fields"], **kw)
    return rings, outs, tiles, mask


@pytest.mark.parametrize("split,chunk", SPLITS, ids=lambda v: str(v))
@pytest.mark.parametrize("i", range(6))
def test_twin_matches_plain(i, split, chunk):
    """The kernel's order twin against the plain version, with the
    default split and chunk and with small ones (so short windows take
    the chunked path here): every ring identical, every stat (count
    included), the tiles and the mask."""
    for j in range(4):
        case = make_case(seed_of("twin", i, j))
        rt, twin, tt, mt = run(case, rk.multi_append_eval_order_twin,
                               split=split, chunk=chunk)
        rp, plain, tp, mp = run(case, rk.ring_append_multi_eval)
        assert all(a.numpy().tobytes() == b.numpy().tobytes()
                   for a, b in zip(rt, rp))
        assert all(torch.equal(a, b) for a, b in zip(tt, tp))
        assert (mt is None) == (mp is None) == (not case["tile_fields"])
        assert mt is None or torch.equal(mt, mp)
        n = case["lens"].long().clamp(0, case["pad"]).numpy()
        for (f, op), a, b in zip(case["evals"], twin, plain):
            a, b = a.numpy(), b.numpy()
            assert a.dtype == b.dtype == case["rings"][f].numpy().dtype
            if a.dtype.kind != "f" or op in ("count", "min", "max"):
                assert a.tobytes() == b.tobytes(), (op, f)
                continue
            ring = rp[f].numpy()
            cells = [ring[r, np.minimum(s + np.arange(k), ring.shape[1] - 1)]
                     for r, s, k in zip(case["rows"].numpy(),
                                        case["starts"].numpy(), n)]
            err = np.abs(a.astype(np.float64) - b)
            if op == "sum":
                scale = np.array([np.abs(c.astype(np.float64)).sum()
                                  for c in cells])
                assert np.all(err <= RTOL * scale)
            else:
                tol = np.maximum(RTOL, 2 * np.maximum(n - 1, 0) * 2.0 ** -24)
                assert np.all(err <= tol * np.abs(b.astype(np.float64)))


def test_plain_equals_per_field_composition():
    """The plain version is the old composition: ring_append_reference a
    field, windowed_reduce_many_reference, window_gather_reference."""
    from windflow_tpu_torch.ops import gather
    from windflow_tpu_torch.ops import windowed_reduce as wr
    for j in range(6):
        case = make_case(seed_of("plain", j))
        rings, outs, tiles, mask = run(case, rk.ring_append_multi_eval)
        old = [r.clone() for r in case["rings"]]
        for r, b in zip(old, case["blks"]):
            rk.ring_append_reference(r, b, case["offs"])
        d = (case["rows"], case["starts"], case["lens"], case["pad"])
        want = wr.windowed_reduce_many_reference(
            [(old[f], op) for f, op in case["evals"]], *d)
        assert all(torch.equal(a, b) for a, b in zip(rings, old))
        assert all(torch.equal(a, b) for a, b in zip(outs, want))
        if case["tile_fields"]:
            wt, wm = gather.window_gather_reference(
                [old[f] for f in case["tile_fields"]], *d)
            assert all(torch.equal(a, b) for a, b in zip(tiles, wt))
            assert torch.equal(mask, wm)


# ---------------------------------------------------------- the wrapper

def small(nf=2, accs_=(torch.int32, torch.float32), wires=None):
    rings = [torch.zeros((4, 64), dtype=accs_[f % len(accs_)])
             for f in range(nf)]
    blks = [torch.zeros((4, 8), dtype=(wires or (torch.int8,))[f % len(
        wires or (torch.int8,))]) for f in range(nf)]
    v = torch.zeros(3, dtype=torch.int32)
    return rings, blks, torch.zeros(4, dtype=torch.int32), v


def test_refuses_bad_inputs():
    rings, blks, offs, v = small()
    f = rk.ring_append_multi_eval
    with pytest.raises(ValueError, match="at least one field"):
        f([], [], offs, [], v, v, v, 4)
    with pytest.raises(TypeError, match="the ring must be"):
        f([rings[0].bfloat16(), rings[1]], blks, offs, [], v, v, v, 4)
    with pytest.raises(TypeError, match="blk"):
        f(rings, [blks[0].double(), blks[1]], offs, [], v, v, v, 4)
    with pytest.raises(TypeError, match="one shape"):
        f([rings[0], rings[1][:, :32]], blks, offs, [], v, v, v, 4)
    with pytest.raises(TypeError, match="width"):
        f(rings, [blks[0], blks[1][:, :4]], offs, [], v, v, v, 4)
    with pytest.raises(ValueError, match="field 2"):
        f(rings, blks, offs, [(2, "sum")], v, v, v, 4)
    with pytest.raises(ValueError, match="field 5"):
        f(rings, blks, offs, [], v, v, v, 4, tile_fields=(5,))
    with pytest.raises(ValueError, match="mean"):
        f(rings, blks, offs, [(0, "mean")], v, v, v, 4)
    with pytest.raises(TypeError, match="lens"):
        f(rings, blks, offs, [(0, "sum")], v, v, v.long(), 4)
    with pytest.raises(ValueError, match="2 rings and 1"):
        f(rings, blks[:1], offs, [], v, v, v, 4)


def test_cpu_tensors_do_not_count_launches():
    before = rk.ring_append_multi_eval.launches
    run(make_case(seed_of("count")), rk.ring_append_multi_eval)
    assert rk.ring_append_multi_eval.launches == before


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def card_path(monkeypatch, rc=0):
    """Forces the wrapper's card path on CPU tensors with a library that
    records each launch's (Rb, n_evals, n_tiles, mask) and returns rc."""
    calls = []

    class Lib:
        def wf_ring_append_multi_eval(self, *args):
            calls.append(dict(nf=args[4], Rb=args[8], n_evals=args[14],
                              srcs=list(args[10][:args[14]]),
                              tile_src=list(args[15][:args[17]]),
                              n_tiles=args[17], mask=args[18],
                              long_win=args[24], long_first=args[25],
                              n_long=args[27], chunks=args[28]))
            return rc

    monkeypatch.setattr(rk, "_on_card", lambda name, *tensors: True)
    monkeypatch.setattr(rk, "_load", lambda: Lib())
    monkeypatch.setattr(rk, "_stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    monkeypatch.setattr(
        rk.ring_append_multi_eval_reference, "__code__",
        (lambda *a, **k: pytest.fail("plain ran")).__code__)
    return calls


def test_card_path_raises_rather_than_falls_back(monkeypatch):
    """On the card path (forced here) the wrapper loads the kernel
    library, and a refused launch raises with the CUDA error: no plain
    version runs in its place."""
    calls = card_path(monkeypatch, rc=1)
    case = make_case(seed_of("raise"))
    case["evals"] = [(0, "sum")]
    before = rk.ring_append_multi_eval.launches
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        run(case, rk.ring_append_multi_eval)
    assert len(calls) == 1 and rk.ring_append_multi_eval.launches == before


def test_more_than_8_stats_take_further_launches(monkeypatch):
    """12 stats: the first launch appends every field, evaluates 8 stats
    and writes the tiles and mask; a second one evaluates the other 4
    over the rings after it (Rb = 0, no tile).  A dispatch with no window
    appends only (one launch)."""
    calls = card_path(monkeypatch)
    rings, blks, offs, v = small(3)
    rows = torch.zeros(5, dtype=torch.int32)
    before = rk.ring_append_multi_eval.launches
    outs, tiles, mask = rk.ring_append_multi_eval(
        rings, blks, offs, [(i % 3, "sum") for i in range(12)], rows, rows,
        rows, 4, tile_fields=(0, 2))
    assert [(c["Rb"], c["n_evals"], c["n_tiles"], c["mask"] is not None)
            for c in calls] == [(8, 8, 2, True), (0, 4, 0, False)]
    assert rk.ring_append_multi_eval.launches == before + 2
    assert len(outs) == 12 and len(tiles) == 2 and mask.shape == (5, 4)
    assert [o.dtype for o in outs] == [r.dtype for r in rings] * 4
    calls.clear()
    outs, tiles, mask = rk.ring_append_multi_eval(
        rings, blks, offs, [(0, "sum")] * 12, v[:0], v[:0], v[:0], 4,
        tile_fields=(0, 1, 2))
    assert [(c["Rb"], c["n_evals"], c["n_tiles"], c["mask"])
            for c in calls] == [(8, 8, 0, None)]
    assert [t.shape for t in tiles] == [(0, 4)] * 3 and mask.shape == (0, 4)


def test_more_than_8_fields_take_a_launch_a_group(monkeypatch):
    """10 fields: the first 8 take a launch that appends them, evaluates
    the first 8 of their stats and writes their tiles and the mask, and a
    second for their other stats (Rb = 0); the last 2 take a launch of
    their own; each launch sees its group's fields by their place in the
    group."""
    calls = card_path(monkeypatch)
    rings, blks, offs, _v = small(10)
    rows = torch.zeros(5, dtype=torch.int32)
    before = rk.ring_append_multi_eval.launches
    outs, tiles, mask = rk.ring_append_multi_eval(
        rings, blks, offs, [(i % 10, "sum") for i in range(12)], rows, rows,
        rows, 4, tile_fields=(9, 1))
    assert [(c["nf"], c["Rb"], c["srcs"], c["tile_src"],
             c["mask"] is not None) for c in calls] == [
        (8, 8, [0, 1, 2, 3, 4, 5, 6, 7], [1], True),
        (8, 0, [0, 1], [], False),
        (2, 8, [0, 1], [1], True)]
    assert rk.ring_append_multi_eval.launches == before + 3
    assert len(outs) == 12 and len(tiles) == 2 and mask.shape == (5, 4)


def test_card_path_passes_the_long_window_list(monkeypatch):
    """The launch gets the long windows' list and their first chunks
    (the n indices, then n + 1 first chunks, int32), or no list at all
    when no window is long (the kernel then reads none)."""
    calls = card_path(monkeypatch)
    rings, blks, offs, _v = small(2)
    rows = torch.zeros(3, dtype=torch.int32)
    starts = torch.tensor([0, 4, 8], dtype=torch.int32)
    lens = torch.tensor([40, 3, 50], dtype=torch.int32)
    long = rk.long_windows(rows.numpy(), starts.numpy(), lens.numpy(), 64,
                           64, split=8, chunk=32)
    counters = torch.zeros(long.n, dtype=torch.int32)
    rk.ring_append_multi_eval(rings, blks, offs, [(0, "sum"), (1, "max")],
                              rows, starts, lens, 64, long=long,
                              counters=counters)
    rk.ring_append_multi_eval(rings, blks, offs, [(0, "sum")], rows, starts,
                              torch.full((3,), 5, dtype=torch.int32), 64)
    (c, d) = calls
    assert c["n_long"] == long.n == 2 and c["chunks"] == long.chunks
    assert c["long_win"] and c["long_first"] == c["long_win"] + 4 * long.n
    assert d["n_long"] == 0 and d["long_win"] is None \
        and d["long_first"] is None


def test_executor_launches_one_fused_kernel_a_dispatch(monkeypatch):
    """Each dispatch of both per-field executors calls
    ring_append_multi_eval exactly once (a mesh: once on every shard,
    with or without windows), never ring_append, windowed_reduce_many or
    window_gather; its staged inputs stay referenced until the harvest."""
    from windflow_tpu_torch.ops import gather, resident
    from windflow_tpu_torch.ops import windowed_reduce as wr
    from windflow_tpu_torch.parallel import make_mesh
    calls = []
    orig = resident.ring_append_multi_eval

    def counting(rings, *args, **kw):
        calls.append((len(rings), kw["long"], kw["tile_fields"]))
        return orig(rings, *args, **kw)

    monkeypatch.setattr(resident, "ring_append_multi_eval", counting)
    for mod, name in ((rk, "ring_append"), (wr, "windowed_reduce_many"),
                      (gather, "window_gather")):
        monkeypatch.setattr(mod, name,
                            lambda *a, **k: pytest.fail("old kernel called"))
    pfn, _ = window_fns(True)
    K, cap = 5, 4096
    seq = dispatches(5, K)
    ex = resident.MultiFieldResidentExecutor(
        tuple(FIELDS), STATS, fn=pfn, acc_dtypes=accs(), device="cpu")
    run_executor(ex, seq, K, cap)
    assert len(calls) == len(seq)
    assert all(n == 4 and t == [2, 3] for n, _l, t in calls)
    # the 3 long windows of each of the last 2 dispatches, listed
    assert sum(c[1].n for c in calls) == 6
    calls.clear()
    mesh = make_mesh(4, devices=["cpu"] * 4)
    run_executor(resident.MeshMultiFieldResidentExecutor(
        tuple(FIELDS), STATS, fn=pfn, acc_dtypes=accs(), mesh=mesh), seq, K,
        cap)
    assert len(calls) == 4 * len(seq)


def test_staging_one_buffer_aligned_segments():
    """A dispatch's staging buffer: each array in its own 16-byte-aligned
    segment, viewed back in its dtype and shape."""
    from windflow_tpu_torch.ops.resident import _stage
    arrays = [np.arange(15, dtype=np.int8).reshape(3, 5),
              np.arange(6, dtype=np.float32).reshape(2, 3),
              np.arange(7, dtype=np.int16), np.arange(4, dtype=np.int32)]
    views, (host, dev) = _stage(arrays, torch.device("cpu"), None)
    assert host.numel() == 16 + 32 + 16 + 16 and dev is host
    for a, v in zip(arrays, views):
        assert v.numpy().dtype == a.dtype and v.numpy().tobytes() \
            == a.tobytes() and v.shape == a.shape
        assert (v.data_ptr() - host.data_ptr()) % 16 == 0


@pytest.mark.cuda
@pytest.mark.parametrize("split,chunk", SPLITS, ids=lambda v: str(v))
def test_kernel_equals_twin_bitwise_on_card(split, chunk):
    """On the card: the kernel equals the twin bit for bit (stats, tiles,
    mask, rings); one launch a call for at most 8 stats, two past 8; the
    counters left at zero.  The last 3 cases have 9-11 fields: a launch
    a group of 8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    for j in range(15):
        case = make_case(seed_of("card", split, j),
                         nf=None if j < 12 else j - 3)
        d = {k: (v.cuda() if isinstance(v, torch.Tensor)
                 else [t.cuda() for t in v] if k in ("rings", "blks") else v)
             for k, v in case.items()}
        long = rk.long_windows(case["rows"].numpy(), case["starts"].numpy(),
                               case["lens"].numpy(), case["pad"],
                               case["rings"][0].shape[1], split, chunk)
        counters = torch.zeros(long.n + 1, dtype=torch.int32, device="cuda")
        before = rk.ring_append_multi_eval.launches
        rg, got, tg, mg = run(d, rk.ring_append_multi_eval, long=long,
                              counters=counters)
        launched = rk.ring_append_multi_eval.launches - before
        rt, twin, tt, mt = run(d, rk.multi_append_eval_order_twin,
                               split=split, chunk=chunk)
        torch.cuda.synchronize()
        groups = [[e for e in case["evals"] if e[0] // 8 == g]
                  for g in range(-(-len(case["rings"]) // 8))]
        assert launched == sum(2 if len(es) > 8 and case["lens"].numel()
                               else 1 for es in groups)
        assert not bool(counters.any())
        assert all(torch.equal(a, b) for a, b in zip(rg, rt))
        assert all(torch.equal(a, b) for a, b in zip(tg, tt))
        assert mg is None or torch.equal(mg, mt)
        for g, t in zip(got, twin):
            assert torch.equal(g.view(torch.int32), t.view(torch.int32))
