"""Rings of int8, int16, int64 and float64 cells through the port's three
fused ring kernels (ops/ring.py; on the CPU their plain versions) against
the JAX package, on the same inputs made with numpy from a seed.

The JAX package allocates a resident ring in any ``compute_dtype`` (and
per field in any ``field_dtypes``); an int64 or float64 ring needs x64.
The port has no x64 switch: a 64-bit ring follows JAX under x64 and every
other dtype JAX's default config.  So the 64-bit cases run JAX's side
inside ``jax.enable_x64(True)`` in the test thread (the pipeline twin in a
child interpreter with JAX_ENABLE_X64=1: node threads do not inherit the
scoped flag), the int8 and int16 ones under the default config.

Cases: the plain kernels against ``_append_eval`` and ``_regular_body``
(every wire of each ring, int32 wires wrapping into int8 rings, float
wires saturating into integer rings, windows past ``rk.LONG_SPLIT``); the
executors (``ResidentWindowExecutor`` irregular and regular launches,
``MultiFieldResidentExecutor`` with and without a window function, the
three mesh executors on 2 and 4 CPU devices) against JAX's; the routing
(``select_acc_dtype``, the narrowing ladders); a JAX x64 int64 snapshot
continued on the port; sum_test at 64 keys over an int64 ring against a
numpy int64 oracle and the JAX pipeline; the kernels' order twins against
the plain versions; and ``cuda``-marked kernel cases (skipped here).

Tolerances: rings byte for byte; integer results, counts, min and max bit
for bit (sums wrap in the ring dtype, a product of int8 or int16 cells is
int32, as ``jnp.prod`` promotes them without x64).  float64 sums: XLA
takes a cumsum difference, the port sums each window, so they are held
within rtol 1e-12 of the sum of |x| over the row's prefix up to the
window's end (against JAX) or over the window (against the plain
version); float64 products within max(1e-12, 2 (n - 1) 2^-53) of |x| for
n cells."""

import contextlib
import os
import subprocess
import sys
import textwrap
import warnings
import zlib

import numpy as np
import pytest
import torch

from windflow_tpu_torch.ops import ring as rk

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

RTOL = 1e-12
NEW_ACCS = (np.int8, np.int16, np.int64, np.float64)
WINDOWS = ("short", "long", "straddle")
OPSETS = (("sum", "min", "max"), ("prod",))
KP, K, RB, R = 8, 6, 64, 40
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seed_of(*parts) -> int:
    return zlib.crc32(" ".join(np.dtype(p).name if isinstance(p, type)
                               else str(p) for p in parts).encode())


def name(d) -> str:
    return np.dtype(d).name


def wide(*dtypes) -> bool:
    return any(np.dtype(d).itemsize == 8 for d in dtypes)


def jax_config(*dtypes):
    """JAX's config for rings of `dtypes`: x64 for an 8-byte one (scoped,
    this thread), the default otherwise."""
    import jax
    return (jax.enable_x64(True) if wide(*dtypes)
            else contextlib.nullcontext())


def wires_of(acc):
    """The wire dtypes a ring of `acc` takes (ring.wires_of in numpy)."""
    return tuple(torch.empty(0, dtype=t).numpy().dtype
                 for t in rk.wires_of(torch.from_numpy(
                     np.zeros(0, acc)).dtype))


def values(rng, dtype, shape, prod, acc=None):
    """Ring or wire values: products stay small; a wire's integers span
    its range (an int32 wire into an int8 ring wraps); int64 values pass
    2**32; a float wire into an integer ring carries NaN and values past
    the ring's range (the conversion saturates)."""
    dtype = np.dtype(dtype)
    if prod:
        if dtype.kind == "f":
            return rng.uniform(0.999, 1.001, size=shape).astype(dtype)
        return rng.choice(np.array([-1, 1, 1, 2]), size=shape).astype(dtype)
    if dtype.kind == "f":
        lim = 100.0
        if acc is not None and np.dtype(acc).kind == "i":
            lim = 4.0 * float(np.iinfo(acc).max)
        out = rng.uniform(-lim, lim, size=shape).astype(dtype)
        if acc is not None and np.dtype(acc).kind == "i":
            out.flat[::7] = np.nan
        return out
    if dtype.itemsize == 8:
        return rng.integers(-2 ** 40, 2 ** 40, size=shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, int(info.max) + 1,
                        size=shape).astype(dtype)


def make_case(seed, wire, acc, ops, windows):
    """A ring, a (KP, Rb) rectangle with rows >= K and columns >= R zero,
    per-row offsets at every residue mod 4, and the windows."""
    rng = np.random.default_rng(seed)
    prod = "prod" in ops
    cap = 8192 if windows == "long" else 1024
    ring = values(rng, acc, (KP, cap), prod)
    blk = np.zeros((KP, RB), dtype=wire)
    blk[:K, :R] = values(rng, wire, (K, R), prod, acc)
    offs = rng.integers(0, cap - RB + 1, size=KP).astype(np.int32)
    offs[:4] = np.minimum(cap - RB, 4 * (offs[:4] // 4) + np.arange(4))
    B = 24
    rows = rng.integers(0, K, size=B)
    if windows == "short":
        lens = rng.integers(0, 65, size=B)
        starts = rng.integers(0, cap - lens + 1)
    elif windows == "long":
        B = 8
        rows = rng.integers(0, KP, size=B)
        lens = rng.integers(rk.LONG_SPLIT + 1, 6001, size=B)
        starts = rng.integers(0, cap - lens + 1)
        starts[1:3] = np.clip(offs[rows[1:3]] - lens[1:3] // 2, 0,
                              cap - lens[1:3])
    else:
        before = rng.integers(0, 40, size=B)
        after = rng.integers(-RB, 40, size=B)
        starts = np.maximum(offs[rows] - before, 0)
        lens = np.maximum(offs[rows] + RB + after - starts, 0)
        lens = np.minimum(lens, cap - starts)
    # a pad of each window set's own (>= every length): JAX compiles a
    # shape once
    pad = {"short": 64, "long": 6000}.get(windows, RB + 80)
    return dict(ring=ring, blk=blk, offs=offs, rows=rows.astype(np.int32),
                starts=starts.astype(np.int32), lens=lens.astype(np.int32),
                cap=cap, pad=pad)


def on_jax(case, *keys):
    """The case's arrays as JAX arrays, as the JAX executors hand them to
    their steps (so the wire's astype is XLA's, not numpy's)."""
    import jax.numpy as jnp
    return [jnp.asarray(case[k]) for k in keys]


def port(case, ops, fn=rk.ring_append_eval, **kw):
    ring = torch.from_numpy(case["ring"].copy())
    outs = fn(ring, torch.from_numpy(case["blk"]),
              torch.from_numpy(case["offs"]), list(ops),
              *(torch.from_numpy(case[k]) for k in ("rows", "starts",
                                                    "lens")),
              case["pad"], **kw)
    return ring.numpy(), [o.numpy() for o in outs]


def prod_tol(want, n):
    return (np.maximum(RTOL, 2 * np.maximum(n - 1, 0) * 2.0 ** -53)
            * np.abs(want.astype(np.float64)))


def assert_close(op, got, want, scale, n):
    """Integer results, min and max bit for bit; float64 sums within RTOL
    of `scale`, products within prod_tol."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, op
    if got.dtype.kind != "f" or op in ("count", "min", "max"):
        assert got.tobytes() == want.tobytes(), op
        return
    err = np.abs(got.astype(np.float64) - want)
    if op == "sum":
        assert np.all(err <= RTOL * scale), op
    else:
        assert np.all(err <= prod_tol(want, n)), op


def prefix_scale(ring, rows, starts, n):
    """Σ|x| over each window's row prefix [0, start + n): the rounding of
    XLA's cumsum difference."""
    return np.array([np.abs(ring[r, :s + k].astype(np.float64)).sum()
                     for r, s, k in zip(rows, starts, n)])


def window_scale(ring, rows, starts, n):
    cap = ring.shape[1]
    return np.array([np.abs(ring[r, np.minimum(s + np.arange(k), cap - 1)]
                            .astype(np.float64)).sum()
                     for r, s, k in zip(rows, starts, n)])


# --------------------------------------------------------------- kernels

CASES = [(acc, wire) for acc in NEW_ACCS for wire in wires_of(acc)]


@pytest.mark.parametrize("windows", WINDOWS)
@pytest.mark.parametrize("ops", OPSETS, ids="+".join)
@pytest.mark.parametrize("acc,wire", CASES,
                         ids=[f"{name(w)}->{name(a)}" for a, w in CASES])
def test_plain_matches_jax_append_eval(acc, wire, ops, windows):
    """ring_append_eval's plain version (what it runs on a CPU tensor)
    against JAX's _append_eval: the ring after the append (a wider wire
    wrapped, a float one saturated) and every op; count gives the lengths
    in the ring dtype."""
    import jax

    from windflow_tpu.ops.resident import _append_eval
    case = make_case(seed_of("jax", wire, acc, *ops, windows), wire, acc,
                     ops, windows)
    with jax_config(acc):
        step = jax.jit(_append_eval, static_argnums=(0, 1, 2, 3))
        jring, want = step(
            tuple(ops), case["cap"], case["pad"], np.dtype(acc),
            *on_jax(case, "ring", "blk", "offs", "rows", "starts", "lens"))
        jring, want = np.asarray(jring), [np.asarray(w) for w in want]
    ring, got = port(case, (*ops, "count"))
    assert ring.dtype == jring.dtype and ring.tobytes() == jring.tobytes()
    assert got[-1].tobytes() == case["lens"].astype(acc).tobytes()
    n = np.minimum(case["lens"], case["pad"]).astype(np.int64)
    scale = prefix_scale(ring, case["rows"], case["starts"], n)
    for op, g, w in zip(ops, got, want):
        assert_close(op, g, w, scale, n)


@pytest.mark.parametrize("acc,wire", CASES,
                         ids=[f"{name(w)}->{name(a)}" for a, w in CASES])
def test_plain_matches_jax_regular_body(acc, wire):
    """ring_append_regular_sum's plain version against JAX's
    _regular_body: the ring and the (KP, C) regular window sums, windows
    clipped at both ends."""
    from windflow_tpu.ops.resident import _regular_body
    rng = np.random.default_rng(seed_of("regular", wire, acc))
    case = make_case(seed_of("regular", wire, acc), wire, acc, ("sum",),
                     "short")
    C, slide, rlen = 12, 24, 40
    rstart0 = (case["offs"] - rng.integers(-30, 200, size=KP)).astype(
        np.int32)
    rlens = np.full(KP, rlen, dtype=np.int32)
    rlens[1] = 0
    with jax_config(acc):
        jring, want = _regular_body(case["cap"], C, slide, np.dtype(acc),
                                    *on_jax(case, "ring", "blk", "offs"),
                                    rstart0, rlens)
        jring, want = np.asarray(jring), np.asarray(want)
    ring = torch.from_numpy(case["ring"].copy())
    got = rk.ring_append_regular_sum(
        ring, torch.from_numpy(case["blk"]), torch.from_numpy(case["offs"]),
        torch.from_numpy(rstart0), torch.from_numpy(rlens), C, slide).numpy()
    ring = ring.numpy()
    assert ring.tobytes() == jring.tobytes()
    cap = case["cap"]
    s = np.clip(rstart0[:, None].astype(np.int64)
                + slide * np.arange(C)[None, :], 0, cap)
    e = np.clip(s + rlens[:, None], 0, cap)
    scale = np.array([[np.abs(ring[r, :e[r, i]].astype(np.float64)).sum()
                       for i in range(C)] for r in range(KP)])
    assert_close("sum", got, want, scale, None)


def test_ring_dtypes_and_pairs():
    """The kernels' type set: eleven ring dtypes (these six, the unsigned
    ones and float16), 47 (wire, ring) pairs; any other ring dtype or pair
    raises on the CPU as on the card, and an op's output dtype follows
    _ring_eval."""
    assert len(rk.RING_DTYPES) == 11
    assert set(NEW_ACCS) | {np.int32, np.float32} <= {
        torch.empty(0, dtype=d).numpy().dtype.type for d in rk.RING_DTYPES}
    assert sum(len(rk.wires_of(d)) for d in rk.RING_DTYPES) == 47
    ring = torch.zeros((4, 32), dtype=torch.int64)
    offs = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="blk"):
        rk.ring_append(ring, torch.zeros((4, 8), dtype=torch.float32), offs)
    with pytest.raises(TypeError, match="blk"):
        rk.ring_append(ring.to(torch.int8),
                       torch.zeros((4, 8), dtype=torch.int64), offs)
    with pytest.raises(TypeError, match="the ring must be"):
        rk.ring_append(ring.to(torch.bfloat16),
                       torch.zeros((4, 8), dtype=torch.int8), offs)
    assert rk.out_dtype("prod", torch.int8) == torch.int32
    assert rk.out_dtype("prod", torch.int16) == torch.int32
    assert rk.out_dtype("prod", torch.int64) == torch.int64
    assert rk.out_dtype("sum", torch.int8) == torch.int8
    assert rk.out_dtype("max", torch.float64) == torch.float64


def test_identity_words():
    """The identities the kernels start from, as bits of the working
    type: int8 min from 127 in int32, int64 max from -2**63, a float64 min
    from +inf, integer sums and products in uint32 / uint64."""
    assert rk._ident_word("min", torch.int8) == 127
    assert rk._ident_word("max", torch.int8) == 2 ** 32 - 128
    assert rk._ident_word("max", torch.int64) == 2 ** 63
    assert rk._ident_word("prod", torch.int16) == 1
    assert rk._ident_word("min", torch.float64) == int(
        np.array(np.inf).view(np.uint64))
    assert rk._ident_word("max", torch.float32) == int(
        np.array(-np.inf, np.float32).view(np.uint32))


def test_library_builds_its_units_in_parallel(tmp_path, monkeypatch):
    """build() compiles the 24 units (the ring kernels once a ring dtype,
    the per-field evaluations once a ring dtype in 64 registers) as
    relocatable device code, one nvcc each, links them into one library,
    removes the objects and records each unit's seconds; a second build
    of the same sources runs nothing (a stand-in nvcc records the
    calls)."""
    from windflow_tpu_torch.ops import _nvcc
    log = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho \"$@\" >> " + str(log) + "\n"
                    "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && touch \"$2\"; "
                    "shift; done\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_nvcc, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_nvcc, "BUILD_DIR", str(tmp_path / "build"))
    so = _nvcc.build_units("resident", rk.UNITS, headers=("resident.cuh",),
                           out_dir=str(tmp_path / "build"))
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in c]
    assert len(compiles) == len(rk.UNITS) == 24 and len(calls) == 25
    assert all("-rdc=true" in c for c in calls)
    assert sum("-maxrregcount=64" in c for c in compiles) == 11
    assert sorted((c.split("-DWF_RING_ACC=")[1].split()[0] for c in compiles
                   if "resident_ring.cu" in c), key=int) == [
        str(k) for k in range(11)]
    link = calls[-1]
    assert "-shared" in link and link.count(".o") == 24
    assert os.path.exists(so) and os.listdir(tmp_path / "build") == [
        os.path.basename(so)]
    assert len(_nvcc.UNIT_SECONDS["resident"]) == 25
    assert _nvcc.build_units("resident", rk.UNITS,
                             headers=("resident.cuh",),
                             out_dir=str(tmp_path / "build")) == so
    assert len(log.read_text().splitlines()) == 25


# ----------------------------------------------------------- order twins

SPLITS = ((rk.LONG_SPLIT, rk.LONG_CHUNK), (64, 32), (0, 32))


@pytest.mark.parametrize("split,chunk", SPLITS, ids=lambda v: str(v))
@pytest.mark.parametrize("acc", NEW_ACCS, ids=name)
def test_twin_matches_plain(acc, split, chunk):
    """append_eval_order_twin (the kernel's combine order) against the
    plain version at the new ring dtypes, with the default split and chunk
    and with small ones: every op and count, the rings identical."""
    wire = wires_of(acc)[-1]
    for windows in WINDOWS:
        for ops in OPSETS:
            case = make_case(seed_of("twin", acc, *ops, windows), wire, acc,
                             ops, windows)
            ring_t, twin = port(case, (*ops, "count"),
                                fn=rk.append_eval_order_twin, split=split,
                                chunk=chunk)
            ring_p, plain = port(case, (*ops, "count"))
            assert ring_t.tobytes() == ring_p.tobytes()
            n = np.clip(case["lens"], 0, case["pad"]).astype(np.int64)
            scale = window_scale(ring_p, case["rows"], case["starts"], n)
            for op, t, p in zip((*ops, "count"), twin, plain):
                assert_close(op, t, p, scale, n)


MIXED = {"a": (np.int8, np.int8), "b": (np.int32, np.int16),
         "c": (np.int64, np.int64), "d": (np.float64, np.float64)}


def multi_case(seed):
    """Four fields of four ring dtypes (an int32 wire wrapping into an
    int16 ring), long windows, every op on each field."""
    case = make_case(seed, np.int8, np.int8, ("sum",), "long")
    rng = np.random.default_rng(seed)
    rings, blks = [], []
    for wire, acc in MIXED.values():
        # float products of thousands of cells stay finite near 1
        prod = np.dtype(acc).kind == "f"
        rings.append(values(rng, acc, case["ring"].shape, prod))
        blk = np.zeros_like(case["blk"], dtype=wire)
        blk[:K, :R] = values(rng, wire, (K, R), prod, acc)
        blks.append(blk)
    evals = [(f, op) for f in range(len(MIXED))
             for op in ("sum", "min", "max", "prod", "count")]
    return case, rings, blks, evals


def run_multi(case, rings, blks, evals, fn, tiles=(), **kw):
    rings = [torch.from_numpy(r.copy()) for r in rings]
    outs, tls, mask = fn(rings, [torch.from_numpy(b) for b in blks],
                         torch.from_numpy(case["offs"]), evals,
                         *(torch.from_numpy(case[k])
                           for k in ("rows", "starts", "lens")),
                         case["pad"], tile_fields=tiles, **kw)
    return ([r.numpy() for r in rings], [o.numpy() for o in outs],
            [t.numpy() for t in tls], mask)


@pytest.mark.parametrize("split,chunk", SPLITS, ids=lambda v: str(v))
def test_multi_twin_matches_plain(split, chunk):
    """multi_append_eval_order_twin against the plain version over rings
    of int8, int16, int64 and float64 in one call: every (field, op), the
    tiles in each field's dtype, the rings identical."""
    case, rings, blks, evals = multi_case(seed_of("multi twin"))
    got = run_multi(case, rings, blks, evals,
                    rk.multi_append_eval_order_twin, tiles=(0, 2, 3),
                    split=split, chunk=chunk)
    want = run_multi(case, rings, blks, evals,
                     rk.ring_append_multi_eval_reference, tiles=(0, 2, 3))
    for a, b in zip(got[0], want[0]):
        assert a.tobytes() == b.tobytes()
    n = np.clip(case["lens"], 0, case["pad"]).astype(np.int64)
    for (f, op), a, b in zip(evals, got[1], want[1]):
        scale = window_scale(want[0][f], case["rows"], case["starts"], n)
        assert_close(op, a, b, scale, n)
    for a, b, f in zip(got[2], want[2], (0, 2, 3)):
        assert a.dtype == np.dtype(MIXED["abcd"[f]][1])
        assert a.tobytes() == b.tobytes()
    assert got[1][3].dtype == np.int32 and got[1][0].dtype == np.int8


# ------------------------------------------------------------ executors

def dispatches(seed, K_, wire, acc, n=4, R_=700, prod=False):
    """Irregular dispatches: rectangles of R_ rows at each key's write
    offset, short windows and, from the third on, windows past
    rk.LONG_SPLIT over what the ring holds after them."""
    rng = np.random.default_rng(seed)
    out, end = [], np.zeros(K_, dtype=np.int64)
    for i in range(n):
        blk = values(rng, wire, (K_, R_), prod)
        offs = end.copy()
        end += R_
        B = 30
        rows = rng.integers(0, K_, size=B)
        lens = rng.integers(0, 300, size=B)
        if i >= 2:
            lens[:3] = (2100, 1500, min(2600, int(end.min())))
        lens = np.minimum(lens, end[rows])
        starts = np.maximum(end[rows] - lens - rng.integers(0, 100, size=B),
                            0)
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
    return ready, [np.asarray(r) for r in data["rings"]]


def assert_ready(got, want, ops, seq, ring, phys=lambda r: r):
    """Every dispatch's outputs against JAX's (assert_close; a float sum
    against the final ring's row prefix: the windows read cells the later
    dispatches do not overwrite)."""
    assert [m for m, _ in got] == [m for m, _ in want]
    for (i, g), (_, w) in zip(got, want):
        rows, starts, lens = seq[i][-3:]
        g = g if isinstance(g, tuple) else (g,)
        w = w if isinstance(w, tuple) else (w,)
        assert len(g) == len(w) == len(ops)
        n = lens.astype(np.int64)
        scale = prefix_scale(ring, phys(rows), starts, n)
        for op, a, b in zip(ops, g, w):
            assert_close(op, a, b, scale, n)


#: a ring's wire in the executor twins: the widest it takes (an int32
#: wire into an int8 or int16 ring wraps)
EXEC_WIRE = {np.int8: np.int32, np.int16: np.int32, np.int64: np.int64,
             np.float64: np.float64}


@pytest.mark.parametrize("ops", [("sum",), ("min", "max"), ("prod",)],
                         ids="+".join)
@pytest.mark.parametrize("acc", NEW_ACCS, ids=name)
def test_executor_matches_jax(acc, ops):
    """ResidentWindowExecutor (one ring_append_eval a dispatch) against
    the JAX executor over dispatches with long windows: every result and
    the ring."""
    from windflow_tpu.ops.resident import ResidentWindowExecutor as JEx

    from windflow_tpu_torch.ops.resident import ResidentWindowExecutor
    K_, cap_ = 5, 4096
    seq = dispatches(seed_of("exec", acc, *ops), K_, EXEC_WIRE[acc], acc,
                     prod="prod" in ops)
    op = ops[0] if len(ops) == 1 else ops
    got, (ring,) = run_executor(ResidentWindowExecutor(
        op, device="cpu", acc_dtype=acc), seq, K_, cap_)
    with jax_config(acc):
        want, (jring,) = run_executor(JEx(op, acc_dtype=acc), seq, K_, cap_)
    assert ring.dtype == jring.dtype and ring.tobytes() == jring.tobytes()
    assert_ready(got, want, ops, seq, ring)


def regular_dispatches(seed, K_, wire, n=3, R_=300, win=40, slide=24):
    """Regular dispatches: R_ rows a key a dispatch, then every key's
    windows of `win` cells every `slide` that end inside what it holds."""
    rng = np.random.default_rng(seed)
    out, end, nxt = [], np.zeros(K_, dtype=np.int64), np.zeros(K_, np.int64)
    for _ in range(n):
        blk = values(rng, wire, (K_, R_), False)
        offs = end.copy()
        end += R_
        rcount = np.maximum((end - win - nxt) // slide + 1, 0)
        rstart0 = nxt.copy()
        nxt += rcount * slide
        wrows = np.repeat(np.arange(K_), rcount).astype(np.int32)
        widx = np.concatenate([np.arange(c) for c in rcount]).astype(
            np.int32)
        out.append((blk, offs, rcount.astype(np.int32),
                    rstart0.astype(np.int32), np.full(K_, win, np.int32),
                    slide, wrows, widx))
    return out


def run_regular(ex, seq, K_, cap_):
    ex.reset(K_, cap_)
    for i, args in enumerate(seq):
        ex.launch_regular(i, *args)
    ready = ex.drain()
    data = ex.ring_snapshot().resolve()
    return ready, np.asarray(data["rings"][0])


def assert_regular(got, want, ring, seq, phys=lambda r: r):
    assert [m for m, _ in got] == [m for m, _ in want]
    for (i, g), (_, w) in zip(got, want):
        _blk, _offs, _c, rstart0, rlen, slide, wrows, widx = seq[i]
        s = rstart0[wrows].astype(np.int64) + slide * widx
        n = rlen[wrows].astype(np.int64)
        assert_close("sum", np.asarray(g), np.asarray(w),
                     prefix_scale(ring, phys(wrows), s, n), n)


@pytest.mark.parametrize("acc", NEW_ACCS, ids=name)
def test_regular_executor_matches_jax(acc):
    """ResidentWindowExecutor.launch_regular (one ring_append_regular_sum
    a flush) against the JAX executor's regular step."""
    from windflow_tpu.ops.resident import ResidentWindowExecutor as JEx

    from windflow_tpu_torch.ops.resident import ResidentWindowExecutor
    K_, cap_ = 5, 2048
    seq = regular_dispatches(seed_of("regular exec", acc), K_,
                             EXEC_WIRE[acc])
    got, ring = run_regular(ResidentWindowExecutor(
        "sum", device="cpu", acc_dtype=acc), seq, K_, cap_)
    with jax_config(acc):
        want, jring = run_regular(JEx("sum", acc_dtype=acc), seq, K_, cap_)
    assert ring.tobytes() == jring.tobytes()
    assert_regular(got, want, ring, seq)


@pytest.mark.parametrize("n_kf", [2, 4])
@pytest.mark.parametrize("acc", NEW_ACCS, ids=name)
def test_mesh_executors_match_jax(acc, n_kf):
    """MeshResidentExecutor on CPU devices against the JAX mesh executor
    on the virtual CPU devices: M1 (launch: one ring_append_eval a shard)
    with max and sum, and M2 (launch_regular: one ring_append_regular_sum
    a shard), every result and the ring in the global layout."""
    from windflow_tpu.ops.resident import MeshResidentExecutor as JMesh
    from windflow_tpu.parallel.mesh import make_mesh as jmake

    from windflow_tpu_torch.ops.resident import MeshResidentExecutor
    from windflow_tpu_torch.parallel import make_mesh
    K_ = 7
    mesh = make_mesh(n_kf, devices=["cpu"] * n_kf)
    seq = dispatches(seed_of("mesh", acc, n_kf), K_, EXEC_WIRE[acc], acc)
    rseq = regular_dispatches(seed_of("mesh regular", acc, n_kf), K_,
                              EXEC_WIRE[acc])
    for op in ("max", "sum"):
        ex = MeshResidentExecutor(op, mesh, acc_dtype=acc)
        got, (ring,) = run_executor(ex, seq, K_, 4096)
        with jax_config(acc):
            want, (jring,) = run_executor(
                JMesh(op, jmake(n_kf), acc_dtype=acc), seq, K_, 4096)
        assert ring.tobytes() == jring.tobytes()
        phys = lambda r: r % n_kf * ex.rps + r // n_kf  # noqa: E731
        assert_ready(got, want, (op,), seq, ring, phys)
    got, ring = run_regular(MeshResidentExecutor("sum", mesh, acc_dtype=acc),
                            rseq, K_, 2048)
    with jax_config(acc):
        want, jring = run_regular(JMesh("sum", jmake(n_kf), acc_dtype=acc),
                                  rseq, K_, 2048)
    assert ring.tobytes() == jring.tobytes()
    assert_regular(got, want, ring, rseq, phys)


#: per-field (wire, ring) of the two multi-field twins: narrow rings under
#: JAX's default config (an int32 wire wrapping into the int8 ring); an
#: int16, an int64 and a float64 ring in one launch under x64
MULTI = {
    "narrow": {"a": (np.int32, np.int8), "b": (np.int16, np.int16)},
    "wide": {"a": (np.int16, np.int16), "b": (np.int64, np.int64),
             "c": (np.float64, np.float64)},
}
#: their stats: every op over the narrow rings; over the wide ones no
#: product of the int16 ring (x64 promotes it to int64, the port keeps
#: JAX's default config there: int32)
MULTI_STATS = {
    "narrow": (("sum", "a"), ("min", "a"), ("max", "b"), ("prod", "b"),
               ("sum", "b")),
    "wide": (("sum", "a"), ("max", "a"), ("sum", "b"), ("min", "b"),
             ("prod", "b"), ("sum", "c"), ("max", "c"), ("prod", "c")),
}


def multi_dispatches(seed, K_, fields, n=4, R_=700):
    rng = np.random.default_rng(seed)
    base = dispatches(seed, K_, np.int8, np.int8, n, R_)
    out = []
    for blk, offs, rows, starts, lens in base:
        blks = {f: values(rng, wire, blk.shape, f == "c", acc)
                for f, (wire, acc) in fields.items()}
        keys = rng.integers(0, 1000, size=len(rows))
        gwids = rng.integers(0, 1 << 20, size=len(rows))
        out.append((blks, offs, rows, starts, lens, keys, gwids))
    return out


def run_multi_executor(ex, seq, K_, cap_):
    ex.reset(K_, cap_)
    for i, (blks, offs, rows, starts, lens, keys, gwids) in enumerate(seq):
        ex.launch(i, blks, offs, rows, starts, lens, wkeys=keys,
                  wgwids=gwids)
    ready = ex.drain()
    data = ex.ring_snapshot().resolve()
    return ready, [np.asarray(r) for r in data["rings"]]


def window_fns():
    """A window function over the tiles of field a: its masked sum and
    max (JAX and torch versions; results int64)."""
    import jax.numpy as jnp

    def jax_fn(keys, gwids, cols, mask):
        a = cols["a"].astype(jnp.int32)
        return (jnp.sum(jnp.where(mask, a, 0), axis=1),
                jnp.max(jnp.where(mask, a, -1 << 30), axis=1))

    def port_fn(keys, gwids, cols, mask):
        a = cols["a"].to(torch.int32)
        return (torch.where(mask, a, 0).sum(dim=1),
                torch.where(mask, a, -1 << 30).amax(dim=1))

    return port_fn, jax_fn


def multi_twin(kind, n_kf, with_fn):
    from windflow_tpu.ops import resident as jr
    from windflow_tpu.parallel.mesh import make_mesh as jmake
    from windflow_tpu.patterns import win_seq_tpu as jw

    import windflow_tpu_torch as wt
    from windflow_tpu_torch.ops import resident
    from windflow_tpu_torch.parallel import make_mesh
    fields, stats = MULTI[kind], MULTI_STATS[kind]
    accs_ = {f: acc for f, (_w, acc) in fields.items()}
    K_, cap_ = 7, 4096
    seq = multi_dispatches(seed_of("multi", kind, n_kf, with_fn), K_, fields)
    pfn = jfn = None
    if with_fn:
        port_fn, jax_fn = window_fns()
        out = {"s": np.int64, "m": np.int64}
        pfn = wt.TorchWindowFunction(port_fn, fields=("a",),
                                     result_fields=out)
        jfn = jw.JaxWindowFunction(jax_fn, fields=("a",), result_fields=out)
    if n_kf:
        ex = resident.MeshMultiFieldResidentExecutor(
            tuple(fields), stats, fn=pfn, acc_dtypes=accs_,
            mesh=make_mesh(n_kf, devices=["cpu"] * n_kf))
        phys = lambda r: r % n_kf * ex.rps + r // n_kf  # noqa: E731
    else:
        ex = resident.MultiFieldResidentExecutor(
            tuple(fields), stats, fn=pfn, acc_dtypes=accs_, device="cpu")
        phys = lambda r: r  # noqa: E731
    got, rings = run_multi_executor(ex, seq, K_, cap_)
    with jax_config(*accs_.values()):
        if n_kf:
            jex = jr.MeshMultiFieldResidentExecutor(
                tuple(fields), stats, jax_fn=jfn, acc_dtypes=accs_,
                mesh=jmake(n_kf))
        else:
            jex = jr.MultiFieldResidentExecutor(
                tuple(fields), stats, jax_fn=jfn, acc_dtypes=accs_)
        want, jrings = run_multi_executor(jex, seq, K_, cap_)
    for r, j in zip(rings, jrings):
        assert r.dtype == j.dtype and r.tobytes() == j.tobytes()
    ring = dict(zip(fields, rings))
    assert [m for m, _ in got] == [m for m, _ in want]
    for (i, g), (_, w) in zip(got, want):
        _b, _o, rows, starts, lens, _k, _g = seq[i]
        n = lens.astype(np.int64)
        assert len(g) == len(w) == len(stats) + 2 * bool(with_fn)
        for (op, f), a, b in zip(stats, g, w):
            assert_close(op, a, b,
                         prefix_scale(ring[f], phys(rows), starts, n), n)
        if with_fn:
            for a, b in zip(g[len(stats):], w[len(stats):]):
                assert (np.asarray(a).astype(np.int64).tobytes()
                        == np.asarray(b).astype(np.int64).tobytes())


@pytest.mark.parametrize("with_fn", [False, True], ids=["stats", "stats+fn"])
@pytest.mark.parametrize("kind", MULTI)
def test_multi_executor_matches_jax(kind, with_fn):
    """MultiFieldResidentExecutor (one ring_append_multi_eval a dispatch,
    rings of mixed dtypes, a window function over int8 or int16 tiles)
    against JAX's _make_multi_step: every result and every ring."""
    multi_twin(kind, 0, with_fn)


@pytest.mark.parametrize("with_fn", [False, True], ids=["stats", "stats+fn"])
@pytest.mark.parametrize("n_kf", [2, 4])
@pytest.mark.parametrize("kind", MULTI)
def test_mesh_multi_executor_matches_jax(kind, n_kf, with_fn):
    """MeshMultiFieldResidentExecutor (M3) on CPU devices against JAX's
    _make_mesh_multi_step on the virtual CPU devices."""
    multi_twin(kind, n_kf, with_fn)


# -------------------------------------------------------------- routing

@pytest.mark.parametrize("acc", (np.int8, np.int16, np.int32, np.int64,
                                 np.float32, np.float64), ids=name)
def test_narrow_follows_jax_ladder(acc):
    """Both executors' wire narrowing equals the JAX executors': the int
    ladder up to int32 (int64 into an 8-byte ring), floats in the ring's
    precision; a float column into an integer ring refused per field."""
    from windflow_tpu.ops import resident as jr

    from windflow_tpu_torch.ops import resident
    probes = [np.zeros(0, np.int64), np.array([-3, 100]),
              np.array([-300, 5]), np.array([0, 70000]),
              np.array([-2 ** 40, 1]), np.array([0.5, 2.0])]
    with jax_config(acc):
        jex = jr.ResidentWindowExecutor("sum", acc_dtype=acc)
        jmulti = jr.MultiFieldResidentExecutor(
            ("v",), (("sum", "v"),), acc_dtypes={"v": acc})
    pex = resident.ResidentWindowExecutor("sum", device="cpu", acc_dtype=acc)
    pmulti = resident.MultiFieldResidentExecutor(
        ("v",), (("sum", "v"),), acc_dtypes={"v": acc}, device="cpu")
    for v in probes:
        assert pex.narrow(v) == jex.narrow(v), v
        if v.dtype.kind == "f" and np.dtype(acc).kind != "f":
            for ex in (pmulti, jmulti):
                with pytest.raises(ValueError, match="float column"):
                    ex.narrow_for("v", v)
            continue
        assert pmulti.narrow_for("v", v) == jmulti.narrow_for("v", v), v


def test_select_acc_dtype_follows_jax(monkeypatch):
    """select_acc_dtype takes every ring dtype; the range warning fires
    exactly where JAX's does (a narrow ring under an int64 reducer), never
    for a 64-bit one; a float16 ring is taken as JAX takes it, and a
    bfloat16 one refused, as JAX's core refuses it."""
    from windflow_tpu.core.windows import WindowSpec as JWindowSpec
    from windflow_tpu.core.windows import WinType as JWinType
    from windflow_tpu.ops.functions import Reducer as JReducer
    from windflow_tpu.patterns import win_seq_tpu as jw

    import windflow_tpu_torch as wt
    from windflow_tpu_torch.core.windows import WindowSpec
    from windflow_tpu_torch.ops.resident import ResidentWindowExecutor
    from windflow_tpu_torch.patterns import win_seq_gpu as pw
    # both packages warn once a configuration a process: start afresh
    monkeypatch.setattr(jw, "_ACC_WARNED", set())
    monkeypatch.setattr(pw, "_ACC_WARNED", set())
    for i, acc in enumerate((np.int8, np.int16, np.int32, np.int64,
                             np.float32, np.float64)):
        op = ("sum", "min", "max", "prod", "sum", "max")[i]
        with jax_config(acc):
            with warnings.catch_warnings(record=True) as jwarn:
                warnings.simplefilter("always")
                jacc = jw.select_acc_dtype(
                    JReducer(op), acc, JWindowSpec(8, 4, JWinType.CB))
        with warnings.catch_warnings(record=True) as pwarn:
            warnings.simplefilter("always")
            pacc = pw.select_acc_dtype(wt.Reducer(op), acc,
                                       WindowSpec(8, 4, wt.WinType.CB))
        assert pacc == jacc == np.dtype(acc)
        assert len(pwarn) == len(jwarn), acc
    assert ResidentWindowExecutor("sum", device="cpu",
                                  acc_dtype=np.float16)._acc == torch.float16
    import ml_dtypes
    with pytest.raises(ValueError, match="bfloat16"):
        ResidentWindowExecutor("sum", device="cpu",
                               acc_dtype=ml_dtypes.bfloat16)


# --------------------------------------------------------------- cores

def cb_stream(n_keys, per_key, chunk=37, seed=0, lo=2 ** 33 - 100,
              hi=2 ** 33 + 100):
    from windflow_tpu_torch import Schema, batch_from_columns
    rng = np.random.default_rng(seed)
    schema = Schema(value=np.int64)
    out = []
    for at in range(0, per_key, chunk):
        m = min(chunk, per_key - at)
        ids = np.repeat(np.arange(at, at + m), n_keys)
        out.append(batch_from_columns(
            schema, key=np.tile(np.arange(n_keys), m), id=ids, ts=ids,
            value=rng.integers(lo, hi, size=m * n_keys)))
    return out


def run_core(core, batches):
    outs = [core.process(b) for b in batches] + [core.flush()]
    outs = [o for o in outs if len(o)]
    return np.sort(np.concatenate(outs), order=["key", "id"])


@pytest.mark.parametrize("rings", [True, False], ids=["rings", "rebase"])
def test_jax_x64_snapshot_continues_on_port(rings, monkeypatch):
    """Half the stream through the JAX Python resident core on an int64
    ring (x64), its drained snapshot carried into the port, the rest on
    the port's int64 ring: the same per-launch output as the JAX core over
    the whole stream, sums past 2**32.  With `rings` the int64 ring itself
    crosses, byte for byte."""
    from windflow_tpu.core.windows import WindowSpec as JWindowSpec
    from windflow_tpu.core.windows import WinType as JWinType
    from windflow_tpu.ops.functions import Reducer as JReducer
    from windflow_tpu.patterns import win_seq_tpu as jw

    import windflow_tpu_torch as wt
    from windflow_tpu_torch.core.windows import WindowSpec
    from windflow_tpu_torch.interop import carry_resident_state
    from windflow_tpu_torch.patterns import win_seq_gpu as pw
    monkeypatch.setenv("WF_NO_NATIVE", "1")
    batches = cb_stream(4, 400, chunk=31, seed=12)
    half = len(batches) // 2
    kw = dict(batch_len=24, flush_rows=80, compute_dtype=np.int64)
    jspec = JWindowSpec(16, 4, JWinType.CB)
    with jax_config(np.int64):
        ref = jw.ResidentWinSeqCore(jspec, JReducer("sum"), **kw)
        want = []
        for b in batches:
            want += ref.process_batches(b)
        want += ref.flush_batches()
        jcore = jw.ResidentWinSeqCore(jspec, JReducer("sum"), **kw)
        jcore.snapshot_rings = rings
        got = []
        for b in batches[:half]:
            got += jcore.process_batches(b)
        got += jcore.checkpoint_drain_batches()
        snap = jcore.state_snapshot()
        carried = carry_resident_state(snap)
        jax_ring = (snap["ring"].resolve()["rings"][0] if rings else None)
    pcore = pw.ResidentWinSeqCore(WindowSpec(16, 4, wt.WinType.CB),
                                  wt.Reducer("sum"), device="cpu", **kw)
    pcore.state_restore(carried)
    if rings:
        port_ring = pcore.executor.ring_snapshot().resolve()["rings"][0]
        assert port_ring.dtype == np.int64 == np.asarray(jax_ring).dtype
        assert port_ring.tobytes() == np.asarray(jax_ring).tobytes()
    for b in batches[half:]:
        got += pcore.process_batches(b)
    got += pcore.flush_batches()
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]
    assert max(int(w["value"].max()) for w in want if len(w)) > 2 ** 36


@pytest.mark.parametrize("reducer", ["sum", "max", "multi"])
@pytest.mark.parametrize("acc", (np.int16, np.int64), ids=name)
def test_native_core_matches_jax(acc, reducer, monkeypatch):
    """The port's NativeResidentCore (C++ bookkeeping; sum: regular
    launches, max: irregular ones, a MultiReducer: the per-field rings)
    over an int16 ring (values wrap in it) or an int64 ring against the
    JAX package's Python resident core in the same configuration, row for
    row."""
    from windflow_tpu.core.windows import WindowSpec as JWindowSpec
    from windflow_tpu.core.windows import WinType as JWinType
    from windflow_tpu.ops.functions import MultiReducer as JMultiReducer
    from windflow_tpu.ops.functions import Reducer as JReducer
    from windflow_tpu.patterns import win_seq_tpu as jw

    import windflow_tpu_torch as wt
    from windflow_tpu_torch import native
    from windflow_tpu_torch.core.windows import WindowSpec
    from windflow_tpu_torch.patterns import win_seq_gpu as pw
    from windflow_tpu_torch.patterns.native_core import NativeResidentCore
    if native.load() is None:
        pytest.skip("native library unavailable")
    batches = cb_stream(5, 500, seed=seed_of("native", acc, reducer))
    kw = dict(batch_len=48, flush_rows=150, compute_dtype=acc)

    def make(pkg):
        if reducer == "multi":
            cls = wt.MultiReducer if pkg is wt else JMultiReducer
            return cls(("sum", "value", "s"), ("max", "value", "m"))
        return (wt.Reducer if pkg is wt else JReducer)(reducer)

    pcore = pw.make_core_for(WindowSpec(24, 8, wt.WinType.CB), make(wt),
                             device="cpu", **kw)
    assert isinstance(pcore, NativeResidentCore)
    assert pcore._delegate is None
    got = run_core(pcore, batches)
    monkeypatch.setenv("WF_NO_NATIVE", "1")
    with jax_config(acc):
        jcore = jw.make_core_for(JWindowSpec(24, 8, JWinType.CB),
                                 make(None), **kw)
        assert isinstance(jcore, jw.ResidentWinSeqCore)
        want = run_core(jcore, batches)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


# ------------------------------------------------------------- pipeline

N_KEYS, PER_KEY, WIN, SLIDE = 64, 1024, 256, 64

JAX_CHILD = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    assert jax.config.jax_enable_x64
    import windflow_tpu as wf
    from windflow_tpu.runtime.engine import Dataflow
    from windflow_tpu.runtime.farm import build_pipeline
    data = np.load(sys.argv[1])
    keys, ids, vals = data["key"], data["id"], data["value"]
    schema = wf.Schema(value=np.int64)
    step = 16384
    batches = [wf.batch_from_columns(schema, key=keys[i:i + step],
                                     id=ids[i:i + step], ts=ids[i:i + step],
                                     value=vals[i:i + step])
               for i in range(0, len(keys), step)]
    rows = []
    df = Dataflow()
    build_pipeline(df, [
        wf.Source(batches=batches, schema=schema),
        wf.WinSeqTPU(wf.Reducer("sum"), %d, %d, wf.WinType.CB,
                     batch_len=4096, flush_rows=16384,
                     compute_dtype=np.int64),
        wf.Sink(lambda r: rows.append(r.copy()) if r is not None
                and len(r) else None, vectorized=True)])
    df.run_and_wait_end()
    np.save(sys.argv[2], np.concatenate(rows))
""" % (WIN, SLIDE))


def test_sum_test_int64_pipeline(tmp_path):
    """sum_test's shape (64 keys, CB 256/64) through WinSeqGPU's resident
    route with compute_dtype=int64 and values near 2**33: every window
    against a numpy int64 oracle and, per key in order, against the JAX
    pipeline run with JAX_ENABLE_X64=1 in a child interpreter."""
    import windflow_tpu_torch as wt
    rng = np.random.default_rng(33)
    schema = wt.Schema(value=np.int64)
    n = N_KEYS * PER_KEY
    ids = np.repeat(np.arange(PER_KEY), N_KEYS)
    keys = np.tile(np.arange(N_KEYS), PER_KEY)
    vals = rng.integers(2 ** 33 - 1000, 2 ** 33 + 1000, size=n)
    step = 16384
    batches = [wt.batch_from_columns(schema, key=keys[i:i + step],
                                     id=ids[i:i + step], ts=ids[i:i + step],
                                     value=vals[i:i + step])
               for i in range(0, n, step)]
    rows = []
    df = wt.Dataflow()
    wt.build_pipeline(df, [
        wt.Source(batches=batches, schema=schema),
        wt.WinSeqGPU(wt.Reducer("sum"), WIN, SLIDE, wt.WinType.CB,
                     batch_len=4096, flush_rows=16384,
                     compute_dtype=np.int64, device="cpu"),
        wt.Sink(lambda r: rows.append(r.copy()) if r is not None
                and len(r) else None, vectorized=True)])
    df.run_and_wait_end()
    got = np.concatenate(rows)
    # the oracle: window i of a key sums its rows [64 i, 64 i + 256)
    for k in range(N_KEYS):
        v = vals[keys == k]
        c = np.concatenate([[0], np.cumsum(v)])
        s = np.arange((len(v) - 1) // SLIDE + 1) * SLIDE
        want = c[np.minimum(s + WIN, len(v))] - c[s]
        mine = got[got["key"] == k]
        assert mine["id"].tolist() == list(range(len(s)))
        assert mine["value"].tolist() == want.tolist()
    assert int(got["value"].max()) > 2 ** 40
    # the JAX pipeline under x64, in a child interpreter
    inp, out = tmp_path / "stream.npz", tmp_path / "jax_rows.npy"
    np.savez(inp, key=keys, id=ids, value=vals)
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", JAX_CHILD, str(inp),
                           str(out)], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.load(out)
    for k in range(N_KEYS):
        a, b = got[got["key"] == k], want[want["key"] == k]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


# ----------------------------------------------------------------- card

@pytest.mark.cuda
@pytest.mark.parametrize("acc", NEW_ACCS, ids=name)
def test_kernels_equal_twins_on_card(acc):
    """On the card, every wire of the ring: ring_append and the fused
    ring_append_regular_sum equal their plain versions (ints bit for bit,
    float64 sums within RTOL of the window's Σ|x|); ring_append_eval and
    ring_append_multi_eval (over the four mixed rings) equal their order
    twins bit for bit, one launch a call, the counters left at zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    for wire in wires_of(acc):
        for windows in WINDOWS:
            for ops in OPSETS:
                case = make_case(seed_of("card", wire, acc, *ops, windows),
                                 wire, acc, ops, windows)
                d = {k: torch.from_numpy(np.ascontiguousarray(case[k])).to(
                    dev) for k in ("ring", "blk", "offs", "rows", "starts",
                                   "lens")}
                args = (d["blk"], d["offs"], [*ops, "count"], d["rows"],
                        d["starts"], d["lens"], case["pad"])
                before = rk.ring_append_eval.launches
                ring = d["ring"].clone()
                got = rk.ring_append_eval(ring, *args)
                ring_t = d["ring"].clone()
                twin = rk.append_eval_order_twin(ring_t, *args)
                torch.cuda.synchronize()
                assert rk.ring_append_eval.launches == before + 1
                assert torch.equal(ring, ring_t)
                for g, t in zip(got, twin):
                    assert g.dtype == t.dtype
                    assert g.cpu().numpy().tobytes() == \
                        t.cpu().numpy().tobytes()
        case = make_case(seed_of("card regular", wire, acc), wire, acc,
                         ("sum",), "short")
        ring = torch.from_numpy(case["ring"]).to(dev)
        blk = torch.from_numpy(case["blk"]).to(dev)
        offs = torch.from_numpy(case["offs"]).to(dev)
        rstart0 = (offs - 30).clamp(min=0)
        rlen = torch.full_like(offs, 40)
        rings = [ring.clone() for _ in range(3)]
        got = rk.ring_append_regular_sum(rings[0], blk, offs, rstart0, rlen,
                                         12, 24)
        want = rk.ring_append_regular_sum_reference(rings[1], blk, offs,
                                                    rstart0, rlen, 12, 24)
        rk.ring_append(rings[2], blk, offs)
        torch.cuda.synchronize()
        assert torch.equal(rings[0], rings[1])
        assert torch.equal(rings[2], rings[1])
        if acc == np.float64:
            cap = rings[1].shape[1]
            cs = torch.zeros((KP, cap + 1), dtype=torch.float64, device=dev)
            torch.cumsum(rings[1].abs(), dim=1, out=cs[:, 1:])
            st = (rstart0.long()[:, None]
                  + 24 * torch.arange(12, device=dev)[None, :]).clamp(0, cap)
            en = (st + rlen.long()[:, None]).clamp(0, cap)
            # the plain version's cumsum difference rounds at the row
            # prefix's magnitude
            scale = cs.gather(1, en)
            assert bool(((got - want).abs() <= RTOL * scale).all())
        else:
            assert torch.equal(got, want)
    case, rings_, blks, evals = multi_case(seed_of("card multi", acc))
    dev_case = {k: (torch.from_numpy(case[k]).to(dev)
                    if k in ("offs", "rows", "starts", "lens") else case[k])
                for k in case}
    got, twin = [], []
    for fn, into in ((rk.ring_append_multi_eval, got),
                     (rk.multi_append_eval_order_twin, twin)):
        rings = [torch.from_numpy(r.copy()).to(dev) for r in rings_]
        outs, tiles, mask = fn(rings, [torch.from_numpy(b).to(dev)
                                       for b in blks],
                               dev_case["offs"], evals[:8],
                               dev_case["rows"], dev_case["starts"],
                               dev_case["lens"], case["pad"],
                               tile_fields=(0, 3))
        torch.cuda.synchronize()
        into.append([r.cpu() for r in rings] + [o.cpu() for o in outs]
                    + [t.cpu() for t in tiles] + [mask.cpu()])
    for a, b in zip(got[0], twin[0]):
        assert a.dtype == b.dtype and a.numpy().tobytes() == \
            b.numpy().tobytes()
