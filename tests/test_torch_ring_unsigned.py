"""Rings of uint8, uint16, uint32, uint64 and float16 cells through the
port's four ring kernels (ops/ring.py; on the CPU their plain versions)
against the JAX package, on the same inputs made with numpy from a seed.

The JAX package allocates a resident ring in any ``compute_dtype`` (and
per field in any ``field_dtypes``); a uint64 ring needs x64.  The port has
no x64 switch: a uint64 ring follows JAX under x64 (run here inside
``jax.enable_x64(True)``, the pipeline twin in a child interpreter) and
every other dtype JAX's default config.

The wires are the JAX ladder's, signed at every ring dtype: an int32 wire
carries uint32 values from 2**31 (it wraps, the ring's convert wraps them
back), an int64 wire uint64 values from 2**63, negative and too large
wires wrap into uint8 and uint16 rings, float wires saturate into
unsigned rings (NaN to 0) and round into float16 rings (past 65504 to
inf).

Tolerances.  Rings byte for byte.  Integer results, counts, min and max
bit for bit: sums wrap in the ring dtype, a product of uint8 or uint16
cells is uint32, unsigned rings compare unsigned (a uint32 max over
values that straddle 2**31).  float16 min and max exact.  float16 sums:
the port adds a window's cells in float32 and rounds once; JAX takes the
difference of two float16 prefix sums of the ring row (``jnp.cumsum``,
whose prefixes lie within 4.5 * 2**-11 of the row's Σ|x| on this CPU:
XLA's scan rounds at each level).  So |port - JAX| <= 2**-8 * (A_s + A_e)
+ 2**-10 * |S|, with A_s, A_e the Σ|x| of the row up to the window's start
and end and S its sum; and the port is within one float16 ulp of the
float64 sum rounded to float16.  Where a prefix passes 65504 JAX gives inf
or nan and the port the window's sum (ROADMAP, recorded divergences).
float16 products: JAX's masked reduce accumulates in float32 (probed:
``jnp.prod`` of float16 equals the float32 product rounded once), as the
port does in another order: within (2**-10 + 2n * 2**-24) |P| for n
cells.  The order twins against the plain versions: integers bit for
bit, float16 sums within 2**-10 |S| + 2n * 2**-24 Σ|x|."""

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

NEW_ACCS = (np.uint8, np.uint16, np.uint32, np.uint64, np.float16)
KP, K, RB, R = 8, 6, 64, 40
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F16_EPS = 2.0 ** -10


def seed_of(*parts) -> int:
    return zlib.crc32(" ".join(np.dtype(p).name if isinstance(p, type)
                               else str(p) for p in parts).encode())


def name(d) -> str:
    return np.dtype(d).name


def jax_config(*dtypes):
    """JAX's config for rings of `dtypes`: x64 for an 8-byte one (scoped,
    this thread), the default otherwise."""
    import jax
    return (jax.enable_x64(True)
            if any(np.dtype(d).itemsize == 8 for d in dtypes)
            else contextlib.nullcontext())


def tdt(d) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, d)).dtype


def wires_of(acc):
    """The wire dtypes a ring of `acc` takes (ring.wires_of in numpy)."""
    return tuple(torch.empty(0, dtype=t).numpy().dtype
                 for t in rk.wires_of(tdt(acc)))


def values(rng, dtype, shape, prod, acc=None):
    """Ring or wire values.  Products stay small (float16 products near
    1).  A ring's integers span its range (uint32 and uint64 around 2**31
    and 2**63 too); a wire's integers span the wire's range, so negative
    ones wrap into an unsigned ring; a float wire into an unsigned ring
    carries NaN, negatives and values past the ring's max, into a float16
    ring NaN, ±inf and values past 65504 (one row, which the tests keep
    out of sums); float16 ring cells lie in [-1, 1)."""
    dtype = np.dtype(dtype)
    size = int(np.prod(shape))
    if prod:
        if dtype.kind == "f":
            return rng.choice(np.array([1 - 2 ** -10, 1.0, 1 + 2 ** -10,
                                        1 + 2 ** -9]),
                              size=shape).astype(dtype)
        if dtype.kind == "u":
            return rng.choice(np.array([1, 1, 2, 3]),
                              size=shape).astype(dtype)
        return rng.choice(np.array([-1, 1, 1, 2]), size=shape).astype(dtype)
    if dtype.kind == "f":
        acc = np.dtype(acc) if acc is not None else dtype
        if acc.kind == "u":
            lim = 4.0 * float(np.iinfo(acc).max)
            out = rng.uniform(-lim, lim, size=shape).astype(dtype)
            out.flat[::7] = np.nan
            return out
        return rng.uniform(-1, 1, size=shape).astype(dtype)
    info = np.iinfo(dtype)
    if acc is not None and np.dtype(acc) == np.float16:
        # an integer wire into a float16 ring: sums stay below 65504
        return rng.integers(-64, 65, size=shape).astype(dtype)
    if dtype.itemsize >= 4 and dtype.kind == "u":
        mid = 1 << (8 * dtype.itemsize - 1)
        out = rng.integers(mid - 1000, mid + 1000, size=shape,
                           dtype=np.uint64)
        out.flat[::5] = rng.integers(0, 200, size=len(out.flat[::5]))
        return out.astype(dtype)
    if dtype.itemsize == 8:
        out = rng.integers(-2 ** 40, 2 ** 40, size=size)
        out[::5] = rng.integers(-2 ** 63, 2 ** 63 - 1, size=len(out[::5]))
        return out.reshape(shape).astype(dtype)
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
    if (np.dtype(acc) == np.float16 and np.dtype(wire).kind == "f"
            and not prod):
        # NaN, ±inf and > 65504 in one row; the windows keep off it
        blk[K - 1, :4] = (np.nan, np.inf, -np.inf, 7e4)
    offs = rng.integers(0, cap - RB + 1, size=KP).astype(np.int32)
    offs[:4] = np.minimum(cap - RB, 4 * (offs[:4] // 4) + np.arange(4))
    B = 24
    rows = rng.integers(0, K - 1, size=B)
    if windows == "long":
        B = 8
        rows = rng.integers(0, K - 1, size=B)
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
    pad = {"long": 6000}.get(windows, RB + 80)
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


def prefix_abs(ring, rows, starts, n):
    """(A_s, A_e): Σ|x| of each window's row up to its start and end."""
    a = np.array([np.abs(ring[r, :s].astype(np.float64)).sum()
                  for r, s in zip(rows, starts)])
    e = np.array([np.abs(ring[r, :s + k].astype(np.float64)).sum()
                  for r, s, k in zip(rows, starts, n)])
    return a, e


def window_cells(ring, rows, starts, n):
    cap = ring.shape[1]
    return [ring[r, np.minimum(s + np.arange(k), cap - 1)].astype(
        np.float64) for r, s, k in zip(rows, starts, n)]


def assert_f16_sum_vs_jax(got, want, ring, rows, starts, n):
    """The stated rule: |port - JAX| <= 2^-8 (A_s + A_e) + 2^-10 |S|, and
    the port within one float16 ulp of the float64 sum."""
    a_s, a_e = prefix_abs(ring, rows, starts, n)
    exact = np.array([c.sum() for c in window_cells(ring, rows, starts, n)])
    got64 = got.astype(np.float64)
    assert np.all(np.abs(got64 - want.astype(np.float64))
                  <= 2.0 ** -8 * (a_s + a_e) + F16_EPS * np.abs(exact))
    assert_f16_ulp(got, exact)


def assert_f16_ulp(got, exact):
    """Each float16 result within one float16 ulp of the float64 sum
    rounded to float16 (the spacing at that value)."""
    rounded = exact.astype(np.float16)
    ulp = np.spacing(np.abs(rounded)).astype(np.float64)
    assert np.all(np.abs(got.astype(np.float64) - rounded.astype(np.float64))
                  <= ulp)


def assert_close(op, got, want, cells=None):
    """Integer results, counts, min and max bit for bit; float16 products
    within (2^-10 + 2n 2^-24) |P|, sums within 2^-10 |S| + 2n 2^-24 Σ|x|
    (`cells`: the windows' cells; the sums' JAX rule is
    assert_f16_sum_vs_jax)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, op
    if got.dtype.kind != "f" or op in ("count", "min", "max"):
        assert got.tobytes() == want.tobytes(), op
        return
    n = np.array([len(c) for c in cells], dtype=np.float64)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    if op == "prod":
        tol = (F16_EPS + 2 * n * 2.0 ** -24) * np.abs(want.astype(
            np.float64))
    else:
        tol = (F16_EPS * np.abs(want.astype(np.float64))
               + 2 * n * 2.0 ** -24 * np.array([np.abs(c).sum()
                                                 for c in cells]))
    assert np.all(err <= tol), op


# --------------------------------------------------------------- kernels

CASES = [(acc, wire) for acc in NEW_ACCS for wire in wires_of(acc)]
OPSETS = (("sum", "min", "max"), ("prod",))


def jax_append_eval(case, acc, ops):
    import jax

    from windflow_tpu.ops.resident import _append_eval
    with jax_config(acc):
        step = jax.jit(_append_eval, static_argnums=(0, 1, 2, 3))
        jring, want = step(
            tuple(ops), case["cap"], case["pad"], np.dtype(acc),
            *on_jax(case, "ring", "blk", "offs", "rows", "starts", "lens"))
        return np.asarray(jring), [np.asarray(w) for w in want]


def check_append_eval(case, acc, ops):
    jring, want = jax_append_eval(case, acc, ops)
    ring, got = port(case, (*ops, "count"))
    assert ring.dtype == jring.dtype and ring.tobytes() == jring.tobytes()
    assert got[-1].tobytes() == case["lens"].astype(acc).tobytes()
    n = np.minimum(case["lens"], case["pad"]).astype(np.int64)
    cells = window_cells(ring, case["rows"], case["starts"], n)
    for op, g, w in zip(ops, got, want):
        if op == "sum" and g.dtype == np.float16:
            assert_f16_sum_vs_jax(g, w, ring, case["rows"], case["starts"],
                                  n)
        else:
            assert_close(op, g, w, cells)
    return got


@pytest.mark.parametrize("ops", OPSETS, ids="+".join)
@pytest.mark.parametrize("acc,wire", CASES,
                         ids=[f"{name(w)}->{name(a)}" for a, w in CASES])
def test_plain_matches_jax_append_eval(acc, wire, ops):
    """ring_append_eval's plain version against JAX's _append_eval, windows
    across the rectangle's edges: the ring after the append (a signed wire
    wrapped into an unsigned ring, a float one saturated or rounded) and
    every op; count gives the lengths in the ring dtype; a product of
    uint8 or uint16 cells is uint32."""
    case = make_case(seed_of("jax", wire, acc, *ops), wire, acc, ops,
                     "straddle")
    got = check_append_eval(case, acc, ops)
    if ops == ("prod",) and np.dtype(acc).itemsize < 4 \
            and np.dtype(acc).kind == "u":
        assert got[0].dtype == np.uint32


@pytest.mark.parametrize("acc", NEW_ACCS, ids=name)
def test_plain_matches_jax_long_windows(acc):
    """The same over windows past rk.LONG_SPLIT cells (the kernel's
    chunked path), the widest wire of each ring, every op."""
    wire = wires_of(acc)[-2 if np.dtype(acc) == np.float16 else -1]
    for ops in OPSETS:
        case = make_case(seed_of("long", acc, *ops), wire, acc, ops, "long")
        check_append_eval(case, acc, ops)


def test_uint32_max_straddles_2_31():
    """A uint32 ring's max over values on both sides of 2**31 (a signed
    compare would pick the smaller), min too, fed by an int32 wire of
    negative values (from 2**31 once wrapped), against JAX."""
    cap = 256
    ring = np.full((2, cap), 2 ** 31 - 5, dtype=np.uint32)
    blk = np.array([[-3, -2**31, 7, 2**31 - 1] * 4,
                    [5, 6, 7, 8] * 4], dtype=np.int32)
    offs = np.array([10, 100], dtype=np.int32)
    case = dict(ring=ring, blk=blk, offs=offs,
                rows=np.array([0, 0, 1, 1], np.int32),
                starts=np.array([0, 5, 95, 120], np.int32),
                lens=np.array([30, 3, 20, 0], np.int32), cap=cap, pad=32)
    got = check_append_eval(case, np.uint32, ("sum", "min", "max"))
    assert got[2][0] == 2 ** 32 - 3 and got[1][0] == 7


@pytest.mark.parametrize("acc,wire", CASES,
                         ids=[f"{name(w)}->{name(a)}" for a, w in CASES])
def test_plain_matches_jax_regular_body(acc, wire):
    """ring_append_regular_sum's plain version against JAX's
    _regular_body: the ring and the (KP, C) regular window sums, windows
    clipped at both ends (float16 by the stated rule)."""
    from windflow_tpu.ops.resident import _regular_body
    rng = np.random.default_rng(seed_of("regular", wire, acc))
    case = make_case(seed_of("regular", wire, acc), wire, acc, ("sum",),
                     "short")
    C, slide, rlen = 12, 24, 40
    rstart0 = (case["offs"] - rng.integers(-30, 200, size=KP)).astype(
        np.int32)
    rlens = np.full(KP, rlen, dtype=np.int32)
    rlens[1] = 0
    if np.dtype(acc) == np.float16:
        # no NaN or inf: JAX's row-wide cumsum would spread it to every
        # later window of the row, empty ones included
        case["blk"][K - 1] = 0
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
    assert got.dtype == want.dtype
    if got.dtype != np.float16:
        assert got.tobytes() == want.tobytes()
        return
    cap = ring.shape[1]
    s = np.clip(rstart0[:, None].astype(np.int64)
                + slide * np.arange(C)[None, :], 0, cap)
    e = np.clip(s + rlens[:, None], 0, cap)
    rows = np.repeat(np.arange(KP), C)
    assert_f16_sum_vs_jax(got.ravel(), want.ravel(), ring, rows, s.ravel(),
                          (e - s).ravel())


def test_float16_prefix_past_65504_diverges():
    """The recorded divergence: a float16 ring row whose prefix sum passes
    65504.  JAX's cumsum difference gives inf or nan for a window past
    that point; the port sums the window's cells (finite, within one ulp
    of the float64 sum) — _regular_body and _append_eval alike."""
    import jax

    from windflow_tpu.ops.resident import _append_eval, _regular_body
    cap = 1024
    ring = np.full((1, cap), 100.0, dtype=np.float16)
    blk = np.zeros((1, 16), np.float32)
    offs = np.zeros(1, np.int32)
    rstart0 = np.array([800], np.int32)
    rlen = np.array([64], np.int32)
    jring, want = _regular_body(cap, 2, 64, np.dtype(np.float16),
                                ring, blk, offs, rstart0, rlen)
    want = np.asarray(want)
    assert not np.isfinite(want).any()
    got = rk.ring_append_regular_sum(
        torch.from_numpy(ring.copy()), torch.from_numpy(blk),
        torch.from_numpy(offs), torch.from_numpy(rstart0),
        torch.from_numpy(rlen), 2, 64).numpy()
    assert got.dtype == np.float16 and got.tolist() == [[6400.0, 6400.0]]
    rows, starts, lens = (np.zeros(2, np.int32), np.array([700, 900],
                                                          np.int32),
                          np.array([50, 100], np.int32))
    step = jax.jit(_append_eval, static_argnums=(0, 1, 2, 3))
    _r, (jsum,) = step(("sum",), cap, 128, np.dtype(np.float16), ring, blk,
                       offs, rows, starts, lens)
    assert not np.isfinite(np.asarray(jsum)).any()
    _ring, (psum,) = port(dict(ring=ring, blk=blk.astype(np.float32),
                               offs=offs, rows=rows, starts=starts,
                               lens=lens, pad=128), ("sum",))
    assert psum.tolist() == [5000.0, 10000.0]


def test_ring_dtypes_tables():
    """Eleven ring dtypes and 47 (wire, ring) pairs: the unsigned rings and
    float16 take the narrow wires, uint64 the wide ones; the identities'
    words (unsigned min from the dtype's max in uint32/uint64, float16 in
    float32); the output dtypes; bfloat16 still raises."""
    assert len(rk.RING_DTYPES) == 11
    assert sum(len(rk.wires_of(d)) for d in rk.RING_DTYPES) == 47
    for acc in (np.uint8, np.uint16, np.uint32, np.float16):
        assert wires_of(acc) == tuple(np.dtype(d) for d in (
            np.int8, np.int16, np.int32, np.float32))
    assert wires_of(np.uint64) == tuple(np.dtype(d) for d in (
        np.int8, np.int16, np.int32, np.int64, np.float64))
    assert rk._ident_word("min", torch.uint8) == 255
    assert rk._ident_word("max", torch.uint8) == 0
    assert rk._ident_word("min", torch.uint32) == 2 ** 32 - 1
    assert rk._ident_word("min", torch.uint64) == 2 ** 64 - 1
    assert rk._ident_word("prod", torch.uint16) == 1
    assert rk._ident_word("min", torch.float16) == int(
        np.array(np.inf, np.float32).view(np.uint32))
    assert rk._ident_word("max", torch.float16) == int(
        np.array(-np.inf, np.float32).view(np.uint32))
    assert rk.out_dtype("prod", torch.uint8) == torch.uint32
    assert rk.out_dtype("prod", torch.uint16) == torch.uint32
    assert rk.out_dtype("prod", torch.uint32) == torch.uint32
    assert rk.out_dtype("prod", torch.float16) == torch.float16
    assert rk.out_dtype("sum", torch.uint8) == torch.uint8
    ring = torch.zeros((4, 32), dtype=torch.uint64)
    offs = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="blk"):
        rk.ring_append(ring, torch.zeros((4, 8), dtype=torch.float32), offs)
    with pytest.raises(TypeError, match="blk"):
        rk.ring_append(ring.to(torch.float16),
                       torch.zeros((4, 8), dtype=torch.float64), offs)
    with pytest.raises(TypeError, match="blk"):
        rk.ring_append(ring.to(torch.uint8),
                       torch.zeros((4, 8), dtype=torch.uint8), offs)
    with pytest.raises(TypeError, match="the ring must be"):
        rk.ring_append(ring.to(torch.bfloat16),
                       torch.zeros((4, 8), dtype=torch.int8), offs)


@pytest.mark.parametrize("dtype", NEW_ACCS, ids=name)
def test_monoid_identities(dtype):
    """monoid.identity for the new dtypes, numpy and torch alike: min of
    an unsigned dtype from its max, max from 0; float16 ±inf; prod 1."""
    from windflow_tpu.ops.monoid import identity as jidentity

    from windflow_tpu_torch.ops.monoid import identity
    for op in ("sum", "count", "min", "max", "prod"):
        want = jidentity(op, np.dtype(dtype))
        for d in (np.dtype(dtype), tdt(dtype)):
            got = identity(op, d)
            assert got.dtype == np.dtype(dtype)
            assert np.array(got).tobytes() == np.array(
                want, dtype=dtype).tobytes(), (op, d)


@pytest.mark.parametrize("acc", NEW_ACCS, ids=name)
def test_widen_follows_xla(acc):
    """_widen (the plain append's conversion) equals XLA's astype for
    every wire of the ring at edge values: -1, the wire's extremes, 2**31
    and 2**63 wrapped, NaN, ±inf, -0.5, past the ring's max, 70000 into
    float16."""
    import jax.numpy as jnp
    edges = {np.dtype(np.int8): [-128, -1, 0, 127],
             np.dtype(np.int16): [-32768, -1, 300, 32767],
             np.dtype(np.int32): [-2 ** 31, -1, 70000, 65519, 65520,
                                  2 ** 31 - 1],
             np.dtype(np.int64): [-2 ** 63, -1, 2 ** 40 + 3, 2 ** 63 - 1],
             np.dtype(np.float32): [np.nan, np.inf, -np.inf, -1.5, -0.5,
                                    0.7, 255.9, 65535.5, 7e4, 3e9, 5e9],
             np.dtype(np.float64): [np.nan, np.inf, -1.5, 0.7, 2.0 ** 63,
                                    1.9e19, 2e19]}
    with jax_config(acc):
        for wire in wires_of(acc):
            x = np.array(edges[wire], dtype=wire)
            want = np.asarray(jnp.asarray(x).astype(acc))
            got = rk._widen(torch.from_numpy(x), tdt(acc)).numpy()
            assert got.dtype == want.dtype
            assert got.tobytes() == want.tobytes(), (wire, got, want)


# ----------------------------------------------------------- order twins

SPLITS = ((rk.LONG_SPLIT, rk.LONG_CHUNK), (64, 32), (0, 32))


def assert_twin(op, t, p, cells):
    if op == "sum" and t.dtype == np.float16:
        n = np.array([len(c) for c in cells], dtype=np.float64)
        exact = np.array([c.sum() for c in cells])
        tol = F16_EPS * np.abs(exact) + 2 * n * 2.0 ** -24 * np.array(
            [np.abs(c).sum() for c in cells])
        assert np.all(np.abs(t.astype(np.float64) - p.astype(np.float64))
                      <= 2 * tol)
        return
    assert_close(op, t, p, cells)


@pytest.mark.parametrize("split,chunk", SPLITS, ids=lambda v: str(v))
@pytest.mark.parametrize("acc", NEW_ACCS, ids=name)
def test_twin_matches_plain(acc, split, chunk):
    """append_eval_order_twin (the kernel's combine order) against the
    plain version at the new ring dtypes, the default split and chunk and
    small ones: every op and count, the rings identical."""
    wire = wires_of(acc)[2]
    for windows in ("straddle", "long"):
        for ops in OPSETS:
            case = make_case(seed_of("twin", acc, *ops, windows), wire, acc,
                             ops, windows)
            ring_t, twin = port(case, (*ops, "count"),
                                fn=rk.append_eval_order_twin, split=split,
                                chunk=chunk)
            ring_p, plain = port(case, (*ops, "count"))
            assert ring_t.tobytes() == ring_p.tobytes()
            n = np.clip(case["lens"], 0, case["pad"]).astype(np.int64)
            cells = window_cells(ring_p, case["rows"], case["starts"], n)
            for op, t, p in zip((*ops, "count"), twin, plain):
                assert_twin(op, t, p, cells)


def test_regular_twin_matches_plain():
    """regular_sum_order_twin (ring_append_regular_sum's order: lane l of
    a warp adds cells l, l + 32, ... in float32, a butterfly over 16..1,
    one rounding) against the plain version on float16 and float32 rings,
    and equal to it on integer rings."""
    for acc, wire in ((np.float16, np.float32), (np.float32, np.int16),
                      (np.uint32, np.int32), (np.uint8, np.int32)):
        case = make_case(seed_of("regular twin", acc), wire, acc, ("sum",),
                         "short")
        # no NaN row: the plain version's cumsum difference would spread it
        # to the row's later (empty) windows, the kernel's sums do not
        case["blk"][K - 1] = 0
        args = [torch.from_numpy(case[k]) for k in ("blk", "offs")]
        rstart0 = torch.from_numpy(np.maximum(case["offs"] - 30, 0))
        rlen = torch.full((KP,), 300, dtype=torch.int32)
        rlen[K - 1] = 0
        rings = [torch.from_numpy(case["ring"].copy()) for _ in range(2)]
        twin = rk.regular_sum_order_twin(rings[0], *args, rstart0, rlen,
                                         9, 40)
        plain = rk.ring_append_regular_sum(rings[1], *args, rstart0, rlen,
                                           9, 40)
        assert rings[0].numpy().tobytes() == rings[1].numpy().tobytes()
        if not twin.is_floating_point():
            assert torch.equal(twin, plain)
            continue
        ring = rings[1].numpy()
        cap = ring.shape[1]
        s = np.clip(rstart0.numpy()[:, None].astype(np.int64)
                    + 40 * np.arange(9)[None, :], 0, cap)
        e = np.clip(s + rlen.numpy()[:, None], 0, cap)
        cells = window_cells(ring, np.repeat(np.arange(KP), 9), s.ravel(),
                             (e - s).ravel())
        assert_twin("sum", twin.numpy().ravel(), plain.numpy().ravel(),
                    cells)


MIXED = {"a": (np.int32, np.uint8), "b": (np.int16, np.uint16),
         "c": (np.int32, np.uint32), "d": (np.int64, np.uint64),
         "e": (np.float32, np.float16)}


def multi_case(seed):
    """Five fields of the five new ring dtypes (signed wires wrapping into
    the unsigned rings), long windows, every op on each field."""
    case = make_case(seed, np.int8, np.int8, ("sum",), "long")
    rng = np.random.default_rng(seed)
    rings, blks = [], []
    for wire, acc in MIXED.values():
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
    of uint8, uint16, uint32, uint64 and float16 in one call: every
    (field, op), the tiles in each field's dtype, the rings identical."""
    case, rings, blks, evals = multi_case(seed_of("multi twin"))
    tiles = (0, 3, 4)
    got = run_multi(case, rings, blks, evals,
                    rk.multi_append_eval_order_twin, tiles=tiles,
                    split=split, chunk=chunk)
    want = run_multi(case, rings, blks, evals,
                     rk.ring_append_multi_eval_reference, tiles=tiles)
    for a, b in zip(got[0], want[0]):
        assert a.tobytes() == b.tobytes()
    n = np.clip(case["lens"], 0, case["pad"]).astype(np.int64)
    for (f, op), a, b in zip(evals, got[1], want[1]):
        cells = window_cells(want[0][f], case["rows"], case["starts"], n)
        assert_twin(op, a, b, cells)
    for a, b, f in zip(got[2], want[2], tiles):
        assert a.dtype == np.dtype(MIXED["abcde"[f]][1])
        assert a.tobytes() == b.tobytes()
    assert got[1][3].dtype == np.uint32 and got[1][0].dtype == np.uint8


# ------------------------------------------------------------ executors

def dispatches(seed, K_, wire, acc, n=4, R_=700, prod=False):
    """Irregular dispatches: rectangles of R_ rows at each key's write
    offset, short windows and, from the third on, windows past
    rk.LONG_SPLIT over what the ring holds after them."""
    rng = np.random.default_rng(seed)
    out, end = [], np.zeros(K_, dtype=np.int64)
    for i in range(n):
        blk = values(rng, wire, (K_, R_), prod, acc)
        if np.dtype(wire).kind == "f" and np.dtype(acc) == np.float16:
            blk = np.abs(blk)          # prefixes of a few thousand cells
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
    """Every dispatch's outputs against JAX's (a float16 sum by the stated
    rule over the final ring: the windows read cells the later dispatches
    do not overwrite)."""
    assert [m for m, _ in got] == [m for m, _ in want]
    for (i, g), (_, w) in zip(got, want):
        rows, starts, lens = seq[i][-3:]
        g = g if isinstance(g, tuple) else (g,)
        w = w if isinstance(w, tuple) else (w,)
        assert len(g) == len(w) == len(ops)
        n = lens.astype(np.int64)
        for op, a, b in zip(ops, g, w):
            a, b = np.asarray(a), np.asarray(b)
            if op == "sum" and a.dtype == np.float16:
                assert b.dtype == a.dtype
                assert_f16_sum_vs_jax(a, b, ring, phys(rows), starts, n)
            else:
                assert_close(op, a, b,
                             window_cells(ring, phys(rows), starts, n))


#: a ring's wire in the executor twins: the widest integer wire it takes
#: (an int32 wire wraps into uint8, uint16 and uint32 rings), float32 into
#: float16
EXEC_WIRE = {np.uint8: np.int32, np.uint16: np.int32, np.uint32: np.int32,
             np.uint64: np.int64, np.float16: np.float32}


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


def regular_dispatches(seed, K_, wire, acc, n=3, R_=300, win=40, slide=24):
    """Regular dispatches: R_ rows a key a dispatch, then every key's
    windows of `win` cells every `slide` that end inside what it holds."""
    rng = np.random.default_rng(seed)
    out, end, nxt = [], np.zeros(K_, dtype=np.int64), np.zeros(K_, np.int64)
    for _ in range(n):
        blk = values(rng, wire, (K_, R_), False, acc)
        if np.dtype(wire).kind == "f" and np.dtype(acc) == np.float16:
            blk = np.abs(blk)
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
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype
        if g.dtype != np.float16:
            assert g.tobytes() == w.tobytes()
            continue
        s = rstart0[wrows].astype(np.int64) + slide * widx
        assert_f16_sum_vs_jax(g, w, ring, phys(wrows), s,
                              rlen[wrows].astype(np.int64))


@pytest.mark.parametrize("acc", NEW_ACCS, ids=name)
def test_regular_executor_matches_jax(acc):
    """ResidentWindowExecutor.launch_regular (one ring_append_regular_sum
    a flush) against the JAX executor's regular step."""
    from windflow_tpu.ops.resident import ResidentWindowExecutor as JEx

    from windflow_tpu_torch.ops.resident import ResidentWindowExecutor
    K_, cap_ = 5, 2048
    seq = regular_dispatches(seed_of("regular exec", acc), K_,
                             EXEC_WIRE[acc], acc)
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
                              EXEC_WIRE[acc], acc)
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


#: per-field (wire, ring) of the multi-field twins: uint8, uint16, uint32
#: and float16 rings under JAX's default config; uint64 beside uint16 and
#: float16 under x64
MULTI = {
    "narrow": {"a": (np.int32, np.uint8), "b": (np.int16, np.uint16),
               "c": (np.int32, np.uint32), "e": (np.float32, np.float16)},
    "wide": {"a": (np.int16, np.uint16), "d": (np.int64, np.uint64),
             "e": (np.float32, np.float16)},
}
#: their stats: every op over the narrow rings (products of uint8 and
#: uint16 cells as uint32); over the wide ones no product of the uint16
#: ring (x64 promotes it to uint64, the port keeps JAX's default config
#: there: uint32)
MULTI_STATS = {
    "narrow": (("sum", "a"), ("min", "a"), ("prod", "a"), ("max", "b"),
               ("prod", "b"), ("sum", "c"), ("max", "c"), ("min", "c"),
               ("max", "e"), ("sum", "e")),
    "wide": (("sum", "a"), ("max", "a"), ("sum", "d"), ("min", "d"),
             ("max", "d"), ("prod", "d"), ("max", "e"), ("min", "e")),
}


def multi_dispatches(seed, K_, fields, n=4, R_=700):
    rng = np.random.default_rng(seed)
    base = dispatches(seed, K_, np.int8, np.int8, n, R_)
    out = []
    for blk, offs, rows, starts, lens in base:
        blks = {}
        for f, (wire, acc) in fields.items():
            v = values(rng, wire, blk.shape, f == "a", acc)
            blks[f] = np.abs(v) if np.dtype(acc) == np.float16 else v
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
    """A window function over the tiles of field a (uint8 or uint16): its
    masked sum and max (JAX and torch versions; results int64)."""
    import jax.numpy as jnp

    def jax_fn(keys, gwids, cols, mask):
        a = cols["a"].astype(jnp.int32)
        return (jnp.sum(jnp.where(mask, a, 0), axis=1),
                jnp.max(jnp.where(mask, a, -1), axis=1))

    def port_fn(keys, gwids, cols, mask):
        a = cols["a"].to(torch.int32)
        return (torch.where(mask, a, 0).sum(dim=1),
                torch.where(mask, a, -1).amax(dim=1))

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
            a, b = np.asarray(a), np.asarray(b)
            if op == "sum" and a.dtype == np.float16:
                assert_f16_sum_vs_jax(a, b, ring[f], phys(rows), starts, n)
            else:
                assert_close(op, a, b, window_cells(ring[f], phys(rows),
                                                    starts, n))
        if with_fn:
            for a, b in zip(g[len(stats):], w[len(stats):]):
                assert (np.asarray(a).astype(np.int64).tobytes()
                        == np.asarray(b).astype(np.int64).tobytes())


@pytest.mark.parametrize("with_fn", [False, True], ids=["stats", "stats+fn"])
@pytest.mark.parametrize("kind", MULTI)
def test_multi_executor_matches_jax(kind, with_fn):
    """MultiFieldResidentExecutor (one ring_append_multi_eval a dispatch,
    rings of mixed new dtypes, a window function over uint8 or uint16
    tiles) against JAX's _make_multi_step: every result and every ring."""
    multi_twin(kind, 0, with_fn)


@pytest.mark.parametrize("n_kf", [2, 4])
@pytest.mark.parametrize("kind", MULTI)
def test_mesh_multi_executor_matches_jax(kind, n_kf):
    """MeshMultiFieldResidentExecutor (M3) on CPU devices against JAX's
    _make_mesh_multi_step on the virtual CPU devices, with the window
    function."""
    multi_twin(kind, n_kf, True)


# -------------------------------------------------------------- routing

@pytest.mark.parametrize("acc", NEW_ACCS, ids=name)
def test_narrow_follows_jax_ladder(acc):
    """Both executors' wire narrowing equals the JAX executors': the signed
    ladder up to int32 (int64 into a uint64 ring) whatever the ring's
    sign, so uint32 values from 2**31 and uint64 ones from 2**63 ship in
    the widest wire; floats in float32 (float64 into uint64); a float
    column into an unsigned ring refused per field."""
    from windflow_tpu.ops import resident as jr

    from windflow_tpu_torch.ops import resident
    probes = [np.zeros(0, np.int64), np.array([3, 100]),
              np.array([0, 300]), np.array([0, 70000]),
              np.array([2 ** 31 - 50, 2 ** 31 + 50], np.uint32),
              np.array([2 ** 63 + 5, 1], np.uint64),
              np.array([-1, 2 ** 40]), np.array([0.5, 2.0], np.float32)]
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


@pytest.mark.parametrize("acc", NEW_ACCS, ids=name)
def test_select_acc_dtype_takes_new_rings(acc, monkeypatch):
    """select_acc_dtype gives the new compute_dtype as JAX does (uint64 as
    JAX under x64), warning where JAX warns; the executors take it."""
    from windflow_tpu.core.windows import WindowSpec as JWindowSpec
    from windflow_tpu.core.windows import WinType as JWinType
    from windflow_tpu.ops.functions import Reducer as JReducer
    from windflow_tpu.patterns import win_seq_tpu as jw

    import windflow_tpu_torch as wt
    from windflow_tpu_torch.core.windows import WindowSpec
    from windflow_tpu_torch.ops.resident import (MultiFieldResidentExecutor,
                                                 ResidentWindowExecutor)
    from windflow_tpu_torch.patterns import win_seq_gpu as pw
    monkeypatch.setattr(jw, "_ACC_WARNED", set())
    monkeypatch.setattr(pw, "_ACC_WARNED", set())
    for op in ("sum", "max"):
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
        assert len(pwarn) == len(jwarn), (acc, op)
    ResidentWindowExecutor("max", device="cpu", acc_dtype=acc)
    MultiFieldResidentExecutor(("v",), (("max", "v"),),
                               acc_dtypes={"v": acc}, device="cpu")


# ---------------------------------------------------------------- cores

def cb_stream(n_keys, per_key, lo, hi, chunk=37, seed=0, dtype=np.int64):
    from windflow_tpu_torch import Schema, batch_from_columns
    rng = np.random.default_rng(seed)
    schema = Schema(value=dtype)
    out = []
    for at in range(0, per_key, chunk):
        m = min(chunk, per_key - at)
        ids = np.repeat(np.arange(at, at + m), n_keys)
        vals = rng.integers(lo, hi, size=m * n_keys, dtype=np.uint64
                            if np.dtype(dtype) == np.uint64 else np.int64)
        out.append(batch_from_columns(
            schema, key=np.tile(np.arange(n_keys), m), id=ids, ts=ids,
            value=vals.astype(dtype)))
    return out


def run_core(core, batches):
    outs = [core.process(b) for b in batches] + [core.flush()]
    outs = [o for o in outs if len(o)]
    return np.sort(np.concatenate(outs), order=["key", "id"])


#: (ring, column dtype, value range) of the core twins: an int64 column
#: of values around 2**31 into a uint32 ring (the native core's int32
#: wire wraps them), a uint64 column around 2**63 into a uint64 ring
CORE_CASES = {"uint32": (np.uint32, np.int64, 2 ** 31 - 300, 2 ** 31 + 300),
              "uint64": (np.uint64, np.uint64, 2 ** 63 - 300, 2 ** 63 + 300)}


@pytest.mark.parametrize("reducer", ["sum", "max", "multi"])
@pytest.mark.parametrize("case", CORE_CASES)
def test_cores_match_jax(case, reducer, monkeypatch):
    """The port's make_core_for resident core (NativeResidentCore, which
    hands a non-int64 column to the Python core as JAX's does; sum:
    regular launches, max: irregular ones, a MultiReducer: the per-field
    rings) and the Python ResidentWinSeqCore (WF_NO_NATIVE=1) against the
    JAX package's Python resident core in the same configuration, row for
    row: uint32 sums wrap modulo 2**32, maxima past 2**31 and 2**63."""
    from windflow_tpu.core.windows import WindowSpec as JWindowSpec
    from windflow_tpu.core.windows import WinType as JWinType
    from windflow_tpu.ops.functions import MultiReducer as JMultiReducer
    from windflow_tpu.ops.functions import Reducer as JReducer
    from windflow_tpu.patterns import win_seq_tpu as jw

    import windflow_tpu_torch as wt
    from windflow_tpu_torch.core.windows import WindowSpec
    from windflow_tpu_torch.patterns import win_seq_gpu as pw
    acc, col, lo, hi = CORE_CASES[case]
    batches = cb_stream(5, 400, lo, hi, seed=seed_of("core", case, reducer),
                        dtype=col)
    kw = dict(batch_len=48, flush_rows=150, compute_dtype=acc)

    def make(pkg):
        dt = np.dtype(col)
        if reducer == "multi":
            cls = wt.MultiReducer if pkg is wt else JMultiReducer
            return cls(("sum", "value", "s"), ("max", "value", "m"),
                       dtype=dt)
        return (wt.Reducer if pkg is wt else JReducer)(reducer, dtype=dt)

    got = []
    for env in ("", "1"):
        if env:
            monkeypatch.setenv("WF_NO_NATIVE", env)
        pcore = pw.make_core_for(WindowSpec(24, 8, wt.WinType.CB), make(wt),
                                 device="cpu", **kw)
        got.append(run_core(pcore, batches))
    monkeypatch.setenv("WF_NO_NATIVE", "1")
    with jax_config(acc):
        jcore = jw.make_core_for(JWindowSpec(24, 8, JWinType.CB),
                                 make(None), **kw)
        assert isinstance(jcore, jw.ResidentWinSeqCore)
        want = run_core(jcore, batches)
    for g in got:
        assert g.dtype == want.dtype and g.tobytes() == want.tobytes()
    field = "m" if reducer == "multi" else "value"
    if reducer != "sum":
        assert int(want[field].max()) > (2 ** 31 if case == "uint32"
                                         else 2 ** 63)


def test_float16_resident_sum_core_matches_jax():
    """A float sum on a float16 ring, opted onto the resident route
    (use_resident=True, as JAX's routing asks), on the port's and JAX's
    Python resident cores: the windows by the stated rule, the max
    exactly."""
    from windflow_tpu.core.windows import WindowSpec as JWindowSpec
    from windflow_tpu.core.windows import WinType as JWinType
    from windflow_tpu.ops.functions import Reducer as JReducer
    from windflow_tpu.patterns import win_seq_tpu as jw

    import windflow_tpu_torch as wt
    from windflow_tpu_torch import Schema, batch_from_columns
    from windflow_tpu_torch.core.windows import WindowSpec
    from windflow_tpu_torch.patterns import win_seq_gpu as pw
    rng = np.random.default_rng(61)
    schema = Schema(value=np.float32)
    n_keys, per_key = 3, 600
    ids = np.repeat(np.arange(per_key), n_keys)
    vals = rng.uniform(0, 4, size=per_key * n_keys).astype(np.float32)
    batches = [batch_from_columns(schema, key=np.tile(np.arange(n_keys),
                                                      per_key)[i:i + 120],
                                  id=ids[i:i + 120], ts=ids[i:i + 120],
                                  value=vals[i:i + 120])
               for i in range(0, len(ids), 120)]
    kw = dict(batch_len=40, flush_rows=120, compute_dtype=np.float16,
              use_resident=True)
    for op in ("sum", "max"):
        got = run_core(pw.make_core_for(
            WindowSpec(32, 8, wt.WinType.CB),
            wt.Reducer(op, dtype=np.float32), device="cpu", **kw), batches)
        want = run_core(jw.make_core_for(
            JWindowSpec(32, 8, JWinType.CB),
            JReducer(op, dtype=np.float32), **kw), batches)
        assert got.dtype == want.dtype and len(got) == len(want)
        assert np.array_equal(got[["key", "id"]], want[["key", "id"]])
        if op == "max":
            assert got.tobytes() == want.tobytes()
            continue
        # the windows' cells as the float16 ring holds them
        h = vals.astype(np.float16).astype(np.float64)
        keys = np.tile(np.arange(n_keys), per_key)
        for k in range(n_keys):
            v = h[keys == k]
            m = got[got["key"] == k]
            s = m["id"].astype(np.int64) * 8
            e = np.minimum(s + 32, len(v))
            exact = np.array([v[a:b].sum() for a, b in zip(s, e)])
            pre = np.concatenate([[0], np.cumsum(np.abs(v))])
            jm = want[want["key"] == k]["value"].astype(np.float64)
            g = m["value"].astype(np.float64)
            # the results are float32 casts of float16 sums
            assert np.all(np.abs(g - jm) <= 2.0 ** -8 * (pre[s] + pre[e])
                          + F16_EPS * np.abs(exact))
            assert_f16_ulp(m["value"].astype(np.float16), exact)


@pytest.mark.parametrize("acc", [np.uint32, np.float16, np.uint64],
                         ids=name)
def test_jax_snapshot_continues_on_port(acc, monkeypatch):
    """Half the stream through the JAX Python resident core on a uint32,
    float16 or uint64 ring (uint64 under x64), its drained snapshot
    carried into the port (interop.carry_resident_state, the ring byte for
    byte), the rest on the port: the same per-launch output as the JAX
    core over the whole stream (float16 sums by the stated rule)."""
    from windflow_tpu.core.windows import WindowSpec as JWindowSpec
    from windflow_tpu.core.windows import WinType as JWinType
    from windflow_tpu.ops.functions import Reducer as JReducer
    from windflow_tpu.patterns import win_seq_tpu as jw

    import windflow_tpu_torch as wt
    from windflow_tpu_torch.core.windows import WindowSpec
    from windflow_tpu_torch.interop import carry_resident_state
    from windflow_tpu_torch.patterns import win_seq_gpu as pw
    monkeypatch.setenv("WF_NO_NATIVE", "1")
    if np.dtype(acc) == np.float16:
        from windflow_tpu_torch import Schema, batch_from_columns
        rng = np.random.default_rng(3)
        schema = Schema(value=np.float32)
        batches = []
        for at in range(0, 400, 31):
            m = min(31, 400 - at)
            ids = np.repeat(np.arange(at, at + m), 4)
            batches.append(batch_from_columns(
                schema, key=np.tile(np.arange(4), m), id=ids, ts=ids,
                value=rng.uniform(0, 2, 4 * m).astype(np.float32)))
        op, dt = "sum", np.float32
    else:
        mid = 1 << (8 * np.dtype(acc).itemsize - 1)
        batches = cb_stream(4, 400, mid - 500, mid + 500, chunk=31, seed=12,
                            dtype=np.uint64 if acc == np.uint64
                            else np.int64)
        op, dt = "max", batches[0]["value"].dtype
    half = len(batches) // 2
    kw = dict(batch_len=24, flush_rows=80, compute_dtype=acc,
              use_resident=True)
    jspec = JWindowSpec(16, 4, JWinType.CB)
    with jax_config(acc):
        ref = jw.ResidentWinSeqCore(jspec, JReducer(op, dtype=dt),
                                    **{k: v for k, v in kw.items()
                                       if k != "use_resident"})
        want = []
        for b in batches:
            want += ref.process_batches(b)
        want += ref.flush_batches()
        jcore = jw.ResidentWinSeqCore(jspec, JReducer(op, dtype=dt),
                                      **{k: v for k, v in kw.items()
                                         if k != "use_resident"})
        jcore.snapshot_rings = True
        got = []
        for b in batches[:half]:
            got += jcore.process_batches(b)
        got += jcore.checkpoint_drain_batches()
        snap = jcore.state_snapshot()
        carried = carry_resident_state(snap)
        jax_ring = np.asarray(snap["ring"].resolve()["rings"][0])
    pcore = pw.ResidentWinSeqCore(WindowSpec(16, 4, wt.WinType.CB),
                                  wt.Reducer(op, dtype=dt), device="cpu",
                                  **{k: v for k, v in kw.items()
                                     if k != "use_resident"})
    pcore.state_restore(carried)
    port_ring = pcore.executor.ring_snapshot().resolve()["rings"][0]
    assert port_ring.dtype == np.dtype(acc) == jax_ring.dtype
    assert port_ring.tobytes() == jax_ring.tobytes()
    for b in batches[half:]:
        got += pcore.process_batches(b)
    got += pcore.flush_batches()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if op == "max":
            assert g.tobytes() == w.tobytes()
        else:
            assert np.array_equal(g[["key", "id"]], w[["key", "id"]])
            assert np.all(np.abs(g["value"].astype(np.float64)
                                 - w["value"]) <= 2.0 ** -6
                          * np.maximum(np.abs(w["value"]), 1))


# ------------------------------------------------------------- pipeline

N_KEYS, PER_KEY, WIN, SLIDE = 64, 1024, 256, 64

JAX_CHILD = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    import windflow_tpu as wf
    from windflow_tpu.runtime.engine import Dataflow
    from windflow_tpu.runtime.farm import build_pipeline
    data = np.load(sys.argv[1])
    acc, op = np.dtype(sys.argv[3]), sys.argv[4]
    if acc.itemsize == 8:
        assert jax.config.jax_enable_x64
    keys, ids, vals = data["key"], data["id"], data["value"]
    schema = wf.Schema(value=vals.dtype)
    step = 16384
    batches = [wf.batch_from_columns(schema, key=keys[i:i + step],
                                     id=ids[i:i + step], ts=ids[i:i + step],
                                     value=vals[i:i + step])
               for i in range(0, len(keys), step)]
    rows = []
    df = Dataflow()
    build_pipeline(df, [
        wf.Source(batches=batches, schema=schema),
        wf.WinSeqTPU(wf.Reducer(op, dtype=vals.dtype), %d, %d,
                     wf.WinType.CB, batch_len=4096, flush_rows=16384,
                     compute_dtype=acc),
        wf.Sink(lambda r: rows.append(r.copy()) if r is not None
                and len(r) else None, vectorized=True)])
    df.run_and_wait_end()
    np.save(sys.argv[2], np.concatenate(rows))
""" % (WIN, SLIDE))


@pytest.mark.parametrize("acc,op", [(np.uint32, "sum"), (np.uint64, "max")],
                         ids=["uint32-sum", "uint64-max"])
def test_pipeline_matches_jax(acc, op, tmp_path):
    """sum_test's shape (64 keys, CB 256/64) through WinSeqGPU's resident
    route with compute_dtype=uint32 (int64 values around 2**31: the sums
    wrap modulo 2**32) or uint64 (uint64 values around 2**63: the max):
    every window against a numpy oracle and, per key in order, against the
    JAX pipeline run in a child interpreter (JAX_ENABLE_X64=1 for
    uint64)."""
    import windflow_tpu_torch as wt
    rng = np.random.default_rng(34)
    mid = 1 << (8 * np.dtype(acc).itemsize - 1)
    col = np.uint64 if acc == np.uint64 else np.int64
    schema = wt.Schema(value=col)
    n = N_KEYS * PER_KEY
    ids = np.repeat(np.arange(PER_KEY), N_KEYS)
    keys = np.tile(np.arange(N_KEYS), PER_KEY)
    vals = rng.integers(mid - 1000, mid + 1000, size=n,
                        dtype=np.uint64).astype(col)
    step = 16384
    batches = [wt.batch_from_columns(schema, key=keys[i:i + step],
                                     id=ids[i:i + step], ts=ids[i:i + step],
                                     value=vals[i:i + step])
               for i in range(0, n, step)]
    rows = []
    df = wt.Dataflow()
    wt.build_pipeline(df, [
        wt.Source(batches=batches, schema=schema),
        wt.WinSeqGPU(wt.Reducer(op, dtype=col), WIN, SLIDE, wt.WinType.CB,
                     batch_len=4096, flush_rows=16384, compute_dtype=acc,
                     device="cpu"),
        wt.Sink(lambda r: rows.append(r.copy()) if r is not None
                and len(r) else None, vectorized=True)])
    df.run_and_wait_end()
    got = np.concatenate(rows)
    for k in range(N_KEYS):
        v = vals[keys == k].astype(acc)
        s = np.arange((len(v) - 1) // SLIDE + 1) * SLIDE
        e = np.minimum(s + WIN, len(v))
        if op == "sum":
            c = np.concatenate([np.zeros(1, np.uint64),
                                np.cumsum(v.astype(np.uint64))])
            want = (c[e] - c[s]).astype(np.uint32).astype(col)
        else:
            want = np.array([v[a:b].max() for a, b in zip(s, e)]).astype(col)
        mine = got[got["key"] == k]
        assert mine["id"].tolist() == list(range(len(s)))
        assert mine["value"].tobytes() == want.tobytes()
    inp, out = tmp_path / "stream.npz", tmp_path / "jax_rows.npy"
    np.savez(inp, key=keys, id=ids, value=vals)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    if np.dtype(acc).itemsize == 8:
        env["JAX_ENABLE_X64"] = "1"
    proc = subprocess.run([sys.executable, "-c", JAX_CHILD, str(inp),
                           str(out), np.dtype(acc).name, op], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.load(out)
    for k in range(N_KEYS):
        a, b = got[got["key"] == k], want[want["key"] == k]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


# ----------------------------------------------------------------- card

def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("acc", NEW_ACCS, ids=name)
def test_kernels_equal_twins_on_card(acc):
    """On the card, every wire of the ring: ring_append equals its plain
    version, ring_append_regular_sum its order twin (integers: the plain
    version) bit for bit; ring_append_eval and ring_append_multi_eval
    (over the five mixed rings) equal their order twins bit for bit, one
    launch a call."""
    dev = card()
    for wire in wires_of(acc):
        for windows in ("straddle", "long"):
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
                assert ring.cpu().numpy().tobytes() == \
                    ring_t.cpu().numpy().tobytes()
                for g, t in zip(got, twin):
                    assert g.dtype == t.dtype
                    assert g.cpu().numpy().tobytes() == \
                        t.cpu().numpy().tobytes()
        case = make_case(seed_of("card regular", wire, acc), wire, acc,
                         ("sum",), "straddle")
        ring = torch.from_numpy(case["ring"]).to(dev)
        blk = torch.from_numpy(case["blk"]).to(dev)
        offs = torch.from_numpy(case["offs"]).to(dev)
        rstart0 = (offs - 30).clamp(min=0)
        rlen = torch.full_like(offs, 40)
        rlen[K - 1] = 0
        rings = [ring.clone() for _ in range(3)]
        got = rk.ring_append_regular_sum(rings[0], blk, offs, rstart0, rlen,
                                         12, 24)
        want = rk.regular_sum_order_twin(rings[1], blk, offs, rstart0, rlen,
                                         12, 24)
        rk.ring_append(rings[2], blk, offs)
        torch.cuda.synchronize()
        for r in (rings[0], rings[2]):
            assert r.cpu().numpy().tobytes() == rings[1].cpu().numpy(
            ).tobytes()
        assert got.cpu().numpy().tobytes() == want.cpu().numpy().tobytes()
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
                               tile_fields=(0, 4))
        torch.cuda.synchronize()
        into.append([r.cpu() for r in rings] + [o.cpu() for o in outs]
                    + [t.cpu() for t in tiles] + [mask.cpu()])
    for a, b in zip(got[0], twin[0]):
        assert a.dtype == b.dtype and a.numpy().tobytes() == \
            b.numpy().tobytes()
