"""The port's ring kernels (plain versions, on the CPU) against the JAX
package's resident device bodies, on the same inputs made with numpy from a
seed:

* ``ring_append`` + ``regular_window_sum`` against ``_regular_body`` — the
  ring after the append and the full (KP, C) window sums;
* ``ring_append`` + the windowed-reduce kernel on the ring's flat view
  against ``_append_eval`` — each op and op tuple over explicit
  (row, start, len) descriptors; ``ring_eval_reference`` (the plain
  transcription of ``_ring_eval``) against it too.

Every wire x accumulate dtype pair ``narrow()`` can produce is covered, with
the edge cases: keys fewer than ring rows, rows with no windows, zero-length
windows, window starts clipped at 0 and at ``cap``, offsets at ``cap - Rb``,
int32 wrap-around.

Tolerances: integer rings and results must be byte-identical.  float32
rings must be identical too (the append only converts).  float32 window
sums round differently in the two packages: XLA takes a float32 cumsum
difference, whose rounding is that of the running prefix, while the port
sums the window.  So against JAX they are held within rtol=1e-5 of the sum
of |x| over the row's prefix up to the window's end, ``ring[r, :e]``; the
port's kernel against its plain version (a float64 prefix sum) within
rtol=1e-5 of the sum of |x| over the window itself.  float32 min/max must
be exact.  The CUDA kernels themselves
are held against the plain versions on the card (the ``cuda``-marked test
and chip_smoke.py).
"""

import zlib

import numpy as np
import pytest
import torch

from windflow_tpu_torch.ops import ring as rk
from windflow_tpu_torch.ops.windowed_reduce import windowed_reduce

RTOL = 1e-5
WIRES = (np.int8, np.int16, np.int32, np.float32)
ACCS = (np.int32, np.float32)
EDGES = ("plain", "keys_lt_rows", "rows_without_windows", "clip_low",
         "clip_high", "offs_at_end", "int32_wrap")


def seed_of(*parts) -> int:
    """A fixed seed per test case (Python's str hash varies per process)."""
    return zlib.crc32(" ".join(str(np.dtype(p)) if isinstance(p, type)
                               else str(p) for p in parts).encode())


def wire_values(rng, dtype, shape, wrap=False):
    if wrap:
        return np.full(shape, 2 ** 30, dtype=dtype)
    if np.dtype(dtype).kind == "f":
        return rng.uniform(-100, 100, size=shape).astype(dtype)
    info = np.iinfo(dtype)
    lo, hi = max(info.min, -1000), min(info.max, 1000)
    return rng.integers(lo, hi + 1, size=shape).astype(dtype)


def make_regular(seed, wire, acc, edge, KP=8, cap=256, Rb=32, C=16,
                 slide=5):
    """A (KP, cap) ring with earlier contents, a (KP, Rb) rectangle whose
    rows >= K and columns past each key's row count are zero (as the
    executor stages it), and per-row regular window descriptors."""
    rng = np.random.default_rng(seed)
    K = 5 if edge == "keys_lt_rows" else KP
    ring = wire_values(rng, acc, (KP, cap)).astype(acc)
    blk = np.zeros((KP, Rb), dtype=wire)
    counts = rng.integers(0, Rb + 1, size=K)
    for r in range(K):
        blk[r, :counts[r]] = wire_values(rng, wire, counts[r],
                                         wrap=edge == "int32_wrap"
                                         and wire == np.int32)
    offs = np.zeros(KP, dtype=np.int32)
    offs[:K] = rng.integers(0, cap - Rb + 1, size=K)
    if edge == "offs_at_end":
        offs[:K] = cap - Rb
    rstart0 = np.zeros(KP, dtype=np.int32)
    rlen = np.zeros(KP, dtype=np.int32)
    rstart0[:K] = rng.integers(0, cap // 2, size=K)
    rlen[:K] = rng.integers(1, 24, size=K)
    if edge == "rows_without_windows":
        rlen[1:K:2] = 0
    if edge == "clip_low":
        rstart0[:K] = rng.integers(-60, 0, size=K)
    if edge == "clip_high":
        rstart0[:K] = rng.integers(cap - 40, cap + 10, size=K)
    if edge == "int32_wrap" and acc == np.int32:
        ring[:] = 2 ** 30
        rlen[:K] = 12
    return dict(ring=ring, blk=blk, offs=offs, rstart0=rstart0, rlen=rlen,
                C=C, slide=slide, cap=cap)


def port_regular(case):
    ring = torch.from_numpy(case["ring"].copy())
    rk.ring_append(ring, torch.from_numpy(case["blk"]),
                   torch.from_numpy(case["offs"]))
    out = rk.regular_window_sum(ring, torch.from_numpy(case["rstart0"]),
                                torch.from_numpy(case["rlen"]), case["C"],
                                case["slide"])
    return ring.numpy(), out.numpy()


def jax_regular(case):
    # imported here, not at the top: the `cuda` test below runs on a card
    # machine that has torch but no JAX
    from windflow_tpu.ops.resident import _regular_body
    ring, out = _regular_body(case["cap"], case["C"], case["slide"],
                              case["ring"].dtype, case["ring"], case["blk"],
                              case["offs"], case["rstart0"], case["rlen"])
    return np.asarray(ring), np.asarray(out)


def window_sums(ring, rstart0, rlen, C, slide, prefix=False):
    """Sums over each clipped regular window ``ring[r, s:e]``, in ring's
    dtype — or over the row's prefix ``ring[r, :e]`` with `prefix`."""
    KP, cap = ring.shape
    out = np.zeros((KP, C), dtype=ring.dtype)
    for r in range(KP):
        for i in range(C):
            s = min(max(int(rstart0[r]) + i * slide, 0), cap)
            e = min(max(s + int(rlen[r]), 0), cap)
            out[r, i] = ring[r, 0 if prefix else s:e].sum()
    return out


def window_abs_sums(ring, rstart0, rlen, C, slide, prefix=False):
    """Σ|x| over each regular window (or its row prefix), in float64."""
    return window_sums(np.abs(ring.astype(np.float64)), rstart0, rlen, C,
                       slide, prefix)


def assert_sums_match(got, want, scale):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind != "f":
        np.testing.assert_array_equal(got, want)
    else:
        err = np.abs(got.astype(np.float64) - want.astype(np.float64))
        assert np.all(err <= RTOL * scale), float(err.max())


@pytest.mark.parametrize("edge", EDGES)
@pytest.mark.parametrize("acc", ACCS, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("wire", WIRES, ids=lambda d: np.dtype(d).name)
def test_regular_matches_jax(wire, acc, edge):
    case = make_regular(seed_of("reg", edge, wire, acc), wire, acc, edge)
    ring, out = port_regular(case)
    want_ring, want_out = jax_regular(case)
    assert ring.dtype == want_ring.dtype
    assert ring.tobytes() == want_ring.tobytes()
    assert_sums_match(out, want_out, window_abs_sums(
        ring, case["rstart0"], case["rlen"], case["C"], case["slide"],
        prefix=True))
    if edge == "int32_wrap" and acc == np.int32:
        # the exact sums leave int32; both packages keep them modulo 2**32
        exact = window_sums(ring.astype(np.int64), case["rstart0"],
                            case["rlen"], case["C"], case["slide"])
        assert (exact != out).any()
        np.testing.assert_array_equal(out, exact.astype(np.int32))


def test_regular_edge_values():
    """Clipped windows at both ends and zero lengths, checked by hand."""
    ring = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    rstart0 = torch.tensor([-3, 6], dtype=torch.int32)
    rlen = torch.tensor([4, 0], dtype=torch.int32)
    out = rk.regular_window_sum(ring, rstart0, rlen, 4, 3)
    # row 0: windows [0,4) [0,4) [3,7) [6,8) -> 6, 6, 18, 13 (the start
    # clips before the length is added)
    # row 1: length 0 everywhere -> 0
    assert out.tolist() == [[6, 6, 18, 13], [0, 0, 0, 0]]


IRREG_OPS = [("sum",), ("min",), ("max",), ("prod",), ("sum", "max"),
             ("min", "max", "prod")]


def make_irregular(seed, wire, acc, ops, KP=8, cap=128, Rb=16, B=40,
                   pad=32):
    rng = np.random.default_rng(seed)
    K = 6
    prod = "prod" in ops
    if prod:
        ring = (rng.uniform(0.95, 1.05, size=(KP, cap)) if acc == np.float32
                else rng.integers(-2, 3, size=(KP, cap))).astype(acc)
    else:
        ring = wire_values(rng, acc, (KP, cap)).astype(acc)
    blk = np.zeros((KP, Rb), dtype=wire)
    if prod and np.dtype(wire).kind == "f":
        blk[:K] = rng.uniform(0.95, 1.05, size=(K, Rb))
    elif prod:
        blk[:K] = rng.integers(-2, 3, size=(K, Rb))
    else:
        blk[:K] = wire_values(rng, wire, (K, Rb))
    offs = np.zeros(KP, dtype=np.int32)
    offs[:K] = rng.integers(0, cap - Rb + 1, size=K)
    rows = rng.integers(0, K, size=B).astype(np.int32)
    lens = rng.integers(0, pad + 1, size=B).astype(np.int32)
    lens[::9] = 0
    starts = rng.integers(0, cap - lens + 1).astype(np.int32)
    starts[1] = cap - lens[1]      # a window that ends at the row's end
    return dict(ring=ring, blk=blk, offs=offs, rows=rows, starts=starts,
                lens=lens, cap=cap, pad=pad)


def assert_irregular_match(op, got, want, ring, rows, starts, lens):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind != "f" or op in ("min", "max"):
        np.testing.assert_array_equal(got, want)
    elif op == "sum":
        # XLA's cumsum difference: rounding of the row prefix [0, s+n)
        scale = np.array([np.abs(ring[r, :s + n].astype(np.float64)).sum()
                          for r, s, n in zip(rows, starts, lens)])
        assert np.all(np.abs(got.astype(np.float64) - want) <= RTOL * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("ops", IRREG_OPS, ids="+".join)
@pytest.mark.parametrize("acc", ACCS, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("wire", WIRES, ids=lambda d: np.dtype(d).name)
def test_irregular_matches_jax(wire, acc, ops):
    from windflow_tpu.ops.resident import _append_eval
    case = make_irregular(seed_of("irr", "+".join(ops), wire, acc), wire,
                          acc, ops)
    cap, pad = case["cap"], case["pad"]
    want_ring, want = _append_eval(ops, cap, pad, np.dtype(acc),
                                   case["ring"], case["blk"], case["offs"],
                                   case["rows"], case["starts"],
                                   case["lens"])
    ring = torch.from_numpy(case["ring"].copy())
    rk.ring_append(ring, torch.from_numpy(case["blk"]),
                   torch.from_numpy(case["offs"]))
    assert ring.numpy().tobytes() == np.asarray(want_ring).tobytes()
    flat_starts = torch.from_numpy(
        (case["rows"].astype(np.int64) * cap + case["starts"])
        .astype(np.int32))
    lens = torch.from_numpy(case["lens"])
    rows_t = torch.from_numpy(case["rows"])
    starts_t = torch.from_numpy(case["starts"])
    for op, w in zip(ops, want):
        w = np.asarray(w)
        got = windowed_reduce(ring.view(-1), flat_starts, lens, pad,
                              op).numpy()
        twin = rk.ring_eval_reference(op, ring, rows_t, starts_t, lens,
                                      pad).numpy()
        args = (ring.numpy(), case["rows"], case["starts"], case["lens"])
        assert_irregular_match(op, got, w, *args)
        assert_irregular_match(op, twin, w, *args)


def test_wrappers_refuse_bad_inputs():
    ring = torch.zeros((4, 32), dtype=torch.int32)
    offs = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32 or float32"):
        rk.ring_append(ring.long(), torch.zeros((4, 8), dtype=torch.int8),
                       offs)
    with pytest.raises(TypeError, match="blk"):
        rk.ring_append(ring, torch.zeros((3, 8), dtype=torch.int8), offs)
    with pytest.raises(TypeError, match="blk"):
        rk.ring_append(ring, torch.zeros((4, 8), dtype=torch.int64), offs)
    with pytest.raises(TypeError, match="offs"):
        rk.ring_append(ring, torch.zeros((4, 8), dtype=torch.int8),
                       offs.long())
    with pytest.raises(TypeError, match="rlen"):
        rk.regular_window_sum(ring, offs, offs[:3], 4, 2)
    # the plain append refuses a column past the ring (the kernel drops it)
    with pytest.raises(RuntimeError):
        rk.ring_append(ring, torch.zeros((4, 8), dtype=torch.int8),
                       torch.full((4,), 30, dtype=torch.int32))


def test_cpu_tensors_do_not_count_launches():
    before = (rk.ring_append.launches, rk.regular_window_sum.launches)
    port_regular(make_regular(1, np.int8, np.int32, "plain"))
    assert (rk.ring_append.launches,
            rk.regular_window_sum.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("acc", ACCS, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("wire", WIRES, ids=lambda d: np.dtype(d).name)
def test_kernels_match_plain_on_card(wire, acc):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    for edge in EDGES:
        case = make_regular(7, wire, acc, edge)
        dev = {k: torch.from_numpy(v).cuda()
               for k, v in case.items() if isinstance(v, np.ndarray)}
        ring_k = dev["ring"].clone()
        rk.ring_append(ring_k, dev["blk"], dev["offs"])
        out_k = rk.regular_window_sum(ring_k, dev["rstart0"], dev["rlen"],
                                      case["C"], case["slide"])
        ring_p = dev["ring"].clone()
        rk.ring_append_reference(ring_p, dev["blk"], dev["offs"])
        out_p = rk.regular_window_sum_reference(
            ring_p, dev["rstart0"], dev["rlen"], case["C"], case["slide"])
        torch.cuda.synchronize()
        assert torch.equal(ring_k, ring_p)
        ring = ring_k.cpu().numpy()
        assert_sums_match(out_k.cpu().numpy(), out_p.cpu().numpy(),
                          window_abs_sums(ring, case["rstart0"],
                                          case["rlen"], case["C"],
                                          case["slide"]))
