"""The port's ring kernels (plain versions, on the CPU) against the JAX
package's resident device bodies, on the same inputs made with numpy from a
seed:

* ``ring_append`` + the window sums alone (the fused kernel with an
  empty ``(KP, 0)`` rectangle), and the fused ``ring_append_regular_sum``
  (one launch a flush), against ``_regular_body`` — the ring after the
  append and the full (KP, C) window sums;
* ``ring_append`` + the windowed-reduce kernel over (row, start, len)
  descriptors against ``_append_eval`` — each op and op tuple, all ops of a
  tuple in one evaluation list; ``ring_eval_reference`` (the plain
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
are held against the plain versions on the card (the ``cuda``-marked tests
and chip_smoke.py).

A CPU twin of the kernels' index arithmetic (``twin_append``,
``twin_append_regular_sum``: which warp and lane write which cells, the
4-cell head and tail peels, which warp sums which windows, which cells
come from blk and which from the ring, and the float32 summation order)
is held against the plain version here; on the card the kernels must
equal it bit for bit.
"""

import zlib

import numpy as np
import pytest
import torch

from windflow_tpu_torch.ops import ring as rk
from windflow_tpu_torch.ops.windowed_reduce import windowed_reduce_many

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


def sums_alone(ring, rstart0, rlen, C, slide):
    """The regular window sums alone: the fused kernel with an empty
    (KP, 0) rectangle."""
    KP = ring.shape[0]
    return rk.ring_append_regular_sum(
        ring, torch.zeros((KP, 0), dtype=torch.int8, device=ring.device),
        torch.zeros(KP, dtype=torch.int32, device=ring.device), rstart0, rlen,
        C, slide)


def port_regular(case):
    ring = torch.from_numpy(case["ring"].copy())
    rk.ring_append(ring, torch.from_numpy(case["blk"]),
                   torch.from_numpy(case["offs"]))
    out = sums_alone(ring, torch.from_numpy(case["rstart0"]),
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
    out = sums_alone(ring, rstart0, rlen, 4, 3)
    # row 0: windows [0,4) [0,4) [3,7) [6,8) -> 6, 6, 18, 13 (the start
    # clips before the length is added)
    # row 1: length 0 everywhere -> 0
    assert out.tolist() == [[6, 6, 18, 13], [0, 0, 0, 0]]


def port_fused(case):
    ring = torch.from_numpy(case["ring"].copy())
    out = rk.ring_append_regular_sum(
        ring, torch.from_numpy(case["blk"]), torch.from_numpy(case["offs"]),
        torch.from_numpy(case["rstart0"]), torch.from_numpy(case["rlen"]),
        case["C"], case["slide"])
    return ring.numpy(), out.numpy()


@pytest.mark.parametrize("edge", EDGES)
@pytest.mark.parametrize("acc", ACCS, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("wire", WIRES, ids=lambda d: np.dtype(d).name)
def test_fused_matches_jax(wire, acc, edge):
    """The fused wrapper's plain form against ``_regular_body``: the ring
    byte for byte, int32 sums exactly, float32 sums within RTOL of Σ|x|
    over the row prefix."""
    case = make_regular(seed_of("fused", edge, wire, acc), wire, acc, edge)
    ring, out = port_fused(case)
    want_ring, want_out = jax_regular(case)
    assert ring.dtype == want_ring.dtype
    assert ring.tobytes() == want_ring.tobytes()
    assert_sums_match(out, want_out, window_abs_sums(
        ring, case["rstart0"], case["rlen"], case["C"], case["slide"],
        prefix=True))


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
    lens = torch.from_numpy(case["lens"])
    rows_t = torch.from_numpy(case["rows"])
    starts_t = torch.from_numpy(case["starts"])
    outs = windowed_reduce_many([(ring, op) for op in ops], rows_t, starts_t,
                                lens, pad)
    for op, w, got in zip(ops, want, outs):
        w = np.asarray(w)
        got = got.numpy()
        twin = rk.ring_eval_reference(op, ring, rows_t, starts_t, lens,
                                      pad).numpy()
        args = (ring.numpy(), case["rows"], case["starts"], case["lens"])
        assert_irregular_match(op, got, w, *args)
        assert_irregular_match(op, twin, w, *args)


def test_wrappers_refuse_bad_inputs():
    ring = torch.zeros((4, 32), dtype=torch.int32)
    offs = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="the ring must be"):
        rk.ring_append(ring.bfloat16(), torch.zeros((4, 8),
                                                    dtype=torch.int8), offs)
    with pytest.raises(TypeError, match="blk"):
        rk.ring_append(ring, torch.zeros((3, 8), dtype=torch.int8), offs)
    with pytest.raises(TypeError, match="blk"):
        rk.ring_append(ring, torch.zeros((4, 8), dtype=torch.int64), offs)
    with pytest.raises(TypeError, match="offs"):
        rk.ring_append(ring, torch.zeros((4, 8), dtype=torch.int8),
                       offs.long())
    with pytest.raises(TypeError, match="rlen"):
        sums_alone(ring, offs, offs[:3], 4, 2)
    with pytest.raises(TypeError, match="rstart0"):
        rk.ring_append_regular_sum(ring, torch.zeros((4, 8), dtype=torch.int8),
                                   offs, offs.long(), offs, 4, 2)
    with pytest.raises(TypeError, match="blk"):
        rk.ring_append_regular_sum(ring, torch.zeros((4, 8), dtype=torch.int64),
                                   offs, offs, offs, 4, 2)
    # the plain append refuses a column past the ring (the kernel drops it)
    with pytest.raises(RuntimeError):
        rk.ring_append(ring, torch.zeros((4, 8), dtype=torch.int8),
                       torch.full((4,), 30, dtype=torch.int32))


def test_cpu_tensors_do_not_count_launches():
    counters = (rk.ring_append, rk.ring_append_regular_sum)
    before = [c.launches for c in counters]
    case = make_regular(1, np.int8, np.int32, "plain")
    port_regular(case)
    port_fused(case)
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("form", ["standalone_C0", "fused_KP0",
                                  "append_Rb0"])
def test_empty_work_launches_nothing(monkeypatch, form):
    """A wrapper on the card path with no cell to write returns before the
    kernel library is loaded, and counts no launch (this runs anywhere:
    loading the library here would fail without nvcc)."""
    monkeypatch.setattr(rk, "_on_card", lambda name, *tensors: True)
    monkeypatch.setattr(rk, "_load", lambda: pytest.fail("loaded"))
    counters = (rk.ring_append, rk.ring_append_regular_sum)
    before = [c.launches for c in counters]
    KP = 0 if form == "fused_KP0" else 4
    ring = torch.zeros((KP, 64), dtype=torch.int32)
    vec = torch.zeros(KP, dtype=torch.int32)
    if form == "standalone_C0":
        out = sums_alone(ring, vec, vec, 0, 8)
        assert out.shape == (KP, 0)
    elif form == "fused_KP0":
        out = rk.ring_append_regular_sum(
            ring, torch.zeros((KP, 16), dtype=torch.int8), vec, vec, vec, 5,
            8)
        assert out.shape == (0, 5)
    else:
        rk.ring_append(ring, torch.zeros((KP, 0), dtype=torch.int8), vec)
    assert [c.launches for c in counters] == before


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
        out_k = sums_alone(ring_k, dev["rstart0"], dev["rlen"], case["C"],
                           case["slide"])
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


# ----------------------------------------------- CPU twin of the kernels

def kernel_order_sum(vals, acc):
    """A window's sum in the kernels' order: lane l adds cells l, l+32, ...
    in turn (int32 in uint32), then a butterfly over 16, 8, 4, 2, 1."""
    work = np.uint32 if np.dtype(acc) == np.int32 else np.float32
    v = np.asarray(vals).astype(acc).view(work)
    lanes = np.zeros(32, dtype=work)
    padded = np.zeros(-(-len(v) // 32) * 32, dtype=work)
    padded[:len(v)] = v
    for chunk in padded.reshape(-1, 32):
        lanes = lanes + chunk
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[np.arange(32) ^ off]
    return lanes[:1].view(np.dtype(acc))[0]


def widen(x, acc):
    return np.asarray(x).astype(acc)


def twin_append(ring, blk, offs, vec):
    """Twin of WarpAppend over every (row, warp chunk, lane) of a (KP, Rb)
    rectangle: a warp loads row cells [512*wc, 512*wc + 512) (and, with a
    head, the next chunk's 16 cells) into its buffer; lane l stores groups
    32q + l (16-byte aligned in the flat ring) from it, the first warp's
    lanes the head, the last warp's lanes the tail; without `vec`, lane l
    moves cells l, l+32, ...  Returns (ring, how many times each rectangle
    cell was written, per-row counts {head, groups, tail, cells})."""
    ring = ring.copy()
    KP, cap = ring.shape
    Rb = blk.shape[1]
    acc = ring.dtype
    warp_cells = 32 * rk.CHUNK
    written = np.zeros((KP, Rb), dtype=np.int64)
    peel = []

    def put(r, j, value):
        written[r, j] += 1
        c = int(offs[r]) + j
        if 0 <= c < cap:
            ring[r, c] = value

    for r in range(KP):
        o = int(offs[r])
        counts = dict(head=0, groups=0, tail=0, cells=0)
        h = (4 - ((r * cap + o) & 3)) & 3
        nb = (Rb - h) >> 2
        for wc in range(-(-Rb // warp_cells)):
            j0 = wc * warp_cells
            if not vec:
                for lane in range(32):
                    for k in range(rk.CHUNK):
                        j = j0 + lane + 32 * k
                        if j < Rb:
                            put(r, j, widen(blk[r, j], acc))
                            counts["cells"] += 1
                continue
            end = min(j0 + warp_cells + (rk.CHUNK if h else 0), Rb)
            buf = list(widen(blk[r, j0:end], acc))
            for lane in range(32):
                for q in range(4):
                    g = wc * warp_cells // 4 + 32 * q + lane
                    if g >= nb:
                        continue
                    c = o + h + 4 * g
                    assert (r * cap + c) % 4 == 0     # a 16-byte store
                    b = 128 * q + 4 * lane + h
                    assert j0 + b == h + 4 * g
                    for k in range(4):
                        # buf[b + k] raises IndexError past what was loaded
                        put(r, h + 4 * g + k, buf[b + k])
                    counts["groups"] += 1
                if wc == 0 and lane < h:
                    put(r, lane, buf[lane])
                    counts["head"] += 1
                t0 = h + 4 * nb
                if (Rb - 1) // warp_cells == wc and t0 + lane < Rb:
                    put(r, t0 + lane, buf[t0 + lane - j0])
                    counts["tail"] += 1
        peel.append(counts)
    return ring, written, peel


def twin_append_regular_sum(ring, blk, offs, rstart0, rlen, C, slide):
    """Twin of append_sum_kernel: the append blocks (twin_append), then the
    window warps, WIN_PER_WARP consecutive windows of one row each, every
    cell of a window read in the kernel's order, from blk inside the
    rectangle and outside it from the ring as it was BEFORE the append
    (the kernel never reads a ring cell that the launch writes).  Returns
    (ring, sums, per-row sets of ring columns read, per-row sets of blk
    columns read)."""
    KP, cap = ring.shape
    Rb = blk.shape[1]
    acc = ring.dtype
    vec = Rb > 0 and Rb % rk.CHUNK == 0
    after = (twin_append(ring, blk, offs, vec)[0] if Rb else ring.copy())
    groups = -(-C // rk.WIN_PER_WARP)
    owned = sorted((gw // groups, (gw % groups) * rk.WIN_PER_WARP + j)
                   for gw in range(KP * groups)
                   for j in range(rk.WIN_PER_WARP)
                   if (gw % groups) * rk.WIN_PER_WARP + j < C)
    assert owned == [(r, i) for r in range(KP) for i in range(C)]
    out = np.zeros((KP, C), dtype=acc)
    ring_reads = [set() for _ in range(KP)]
    blk_reads = [set() for _ in range(KP)]
    for r in range(KP):
        o = int(offs[r]) if Rb else 0
        for i in range(C):
            s = min(max(int(rstart0[r]) + i * slide, 0), cap)
            e = min(max(s + int(rlen[r]), 0), cap)
            col = np.arange(s, max(e, s))
            inside = (col >= o) & (col < o + Rb)
            vals = ring[r, col].copy()
            vals[inside] = widen(blk[r, col[inside] - o], acc)
            ring_reads[r].update(col[~inside].tolist())
            blk_reads[r].update(col[inside].tolist())
            out[r, i] = kernel_order_sum(vals, acc)
    return after, out, ring_reads, blk_reads


def twin_case(seed, wire, acc, KP=4, cap=512, Rb=64, C=16, slide=8,
              rlen=24, offs_mod=None, edge="plain"):
    """Inputs in the executor's layout (rstart0 = offs - (rlen - slide),
    so most window cells are new ones) at a small shape."""
    rng = np.random.default_rng(seed)
    ring = wire_values(rng, acc, (KP, cap)).astype(acc)
    blk = wire_values(rng, wire, (KP, Rb))
    offs = rng.integers(0, cap - Rb + 1, size=KP).astype(np.int32)
    if offs_mod is not None:       # row r's flat start ≡ offs_mod (mod 4)
        for r in range(KP):
            want = (offs_mod - r * cap) % 4
            offs[r] -= (int(offs[r]) - want) % 4
            if offs[r] < 0:
                offs[r] += 4
    rstart0 = (offs - (rlen - slide)).astype(np.int32)
    rlens = np.full(KP, rlen, dtype=np.int32)
    if edge == "clip_low":
        rstart0[:] = -rng.integers(1, 4 * slide + 2, size=KP)
    if edge == "clip_high":
        rstart0[:] = cap - rng.integers(-slide, 2 * slide + 2, size=KP)
    if edge == "zero_length":
        rlens[1::2] = 0
    return dict(ring=ring, blk=blk, offs=offs, rstart0=rstart0, rlen=rlens,
                C=C, slide=slide, cap=cap)


#: (name, twin_case kwargs): C not a multiple of a warp's windows, Rb not a
#: multiple of 16 (the per-cell path), windows far apart, windows of 5,000
#: cells across several append chunks, clipped bounds
TWIN_CASES = {
    "plain": {},
    "c_not_warp_multiple": dict(C=37, cap=1024, Rb=320),
    "rb_not_multiple_of_16": dict(Rb=40),
    "rb_8": dict(Rb=8, rlen=12, slide=4),
    "wide_slide": dict(KP=2, cap=16384, Rb=2048, C=20, slide=600, rlen=1000),
    "long_window": dict(KP=2, cap=16384, Rb=4096, C=5, slide=2000,
                        rlen=5000),
    "clip_low": dict(edge="clip_low"),
    "clip_high": dict(edge="clip_high"),
    "zero_length": dict(edge="zero_length"),
}


def twin_run(case):
    return twin_append_regular_sum(case["ring"], case["blk"], case["offs"],
                                   case["rstart0"], case["rlen"], case["C"],
                                   case["slide"])


@pytest.mark.parametrize("offs_mod", [0, 1, 2, 3])
@pytest.mark.parametrize("Rb", [16, 48, 64, 40, 8, 1040])
def test_twin_append_peels(Rb, offs_mod):
    """The append's cut of a row at the ring's 4-cell boundaries: every
    rectangle cell written once; the head is h = (-(r*cap + offs)) mod 4
    cells, the tail (Rb - h) mod 4, the rest 16-byte groups; a rectangle
    whose Rb is not a multiple of 16 goes cell by cell."""
    case = twin_case(seed_of("peel", Rb, offs_mod), np.int8, np.int32,
                     cap=2048, Rb=Rb, offs_mod=offs_mod)
    vec = Rb % rk.CHUNK == 0
    ring, written, peel = twin_append(case["ring"], case["blk"],
                                      case["offs"], vec)
    want = rk.ring_append_reference(torch.from_numpy(case["ring"].copy()),
                                    torch.from_numpy(case["blk"]),
                                    torch.from_numpy(case["offs"])).numpy()
    assert ring.tobytes() == want.tobytes()
    assert (written == 1).all()
    h = (4 - offs_mod) % 4
    for counts in peel:
        if vec:
            assert counts == dict(head=h, groups=(Rb - h) // 4,
                                  tail=(Rb - h) % 4, cells=0)
        else:
            assert counts == dict(head=0, groups=0, tail=0, cells=Rb)


@pytest.mark.parametrize("case_name", list(TWIN_CASES))
@pytest.mark.parametrize("acc", ACCS, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("wire", WIRES, ids=lambda d: np.dtype(d).name)
def test_twin_matches_plain(wire, acc, case_name):
    """The twin of the fused kernel against its plain version: rings
    identical, int32 sums exact, float32 sums within RTOL of Σ|x| over the
    window; it reads the covered cells inside the rectangle from blk and
    the others from the ring."""
    case = twin_case(seed_of("twin", case_name, wire, acc), wire, acc,
                     **TWIN_CASES[case_name])
    ring, out, ring_reads, blk_reads = twin_run(case)
    want_ring, want_out = port_fused(case)
    assert ring.tobytes() == want_ring.tobytes()
    assert_sums_match(out, want_out, window_abs_sums(
        ring, case["rstart0"], case["rlen"], case["C"], case["slide"]))
    cap, Rb = case["cap"], case["blk"].shape[1]
    for r in range(len(ring_reads)):
        o = int(case["offs"][r])
        covered = set()
        for i in range(case["C"]):
            s = min(max(int(case["rstart0"][r]) + i * case["slide"], 0), cap)
            e = min(max(s + int(case["rlen"][r]), 0), cap)
            covered.update(range(s, e))
        rect = set(range(o, o + Rb))
        assert ring_reads[r] == covered - rect
        assert blk_reads[r] == covered & rect


def test_twin_main_shape_ring_reads():
    """At sum_test's layout (windows of 256, slide 64, starting 192 cells
    before each row's offset), every row reads 192 cells from the ring and
    the rest, all of the rectangle, from blk."""
    case = twin_case(5, np.int8, np.int32, KP=2, cap=4096, Rb=1024, C=16,
                     slide=64, rlen=256)
    _, _, ring_reads, blk_reads = twin_run(case)
    for r in range(2):
        o = int(case["offs"][r])
        assert ring_reads[r] == set(range(max(o - 192, 0), o))
        assert blk_reads[r] == set(range(o, o + 1024))


def test_standalone_sum_is_the_empty_rectangle():
    """The window sums alone are the fused kernel with Rb = 0: the twin
    with an empty rectangle equals the plain window sums."""
    case = twin_case(9, np.int16, np.float32, edge="clip_low")
    empty = np.zeros((case["ring"].shape[0], 0), dtype=np.int8)
    ring, out, _, _ = twin_append_regular_sum(
        case["ring"], empty, case["offs"], case["rstart0"], case["rlen"],
        case["C"], case["slide"])
    want = sums_alone(
        torch.from_numpy(case["ring"]), torch.from_numpy(case["rstart0"]),
        torch.from_numpy(case["rlen"]), case["C"], case["slide"]).numpy()
    assert ring.tobytes() == case["ring"].tobytes()
    assert_sums_match(out, want, window_abs_sums(
        ring, case["rstart0"], case["rlen"], case["C"], case["slide"]))


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


def on_card(case):
    return {k: torch.from_numpy(v).cuda()
            for k, v in case.items() if isinstance(v, np.ndarray)}


@pytest.mark.cuda
@pytest.mark.parametrize("acc", ACCS, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("wire", WIRES, ids=lambda d: np.dtype(d).name)
def test_fused_kernel_matches_plain_on_card(wire, acc):
    """The fused kernel against its plain version at sum_test's main shape
    (64 x 262144 ring, Rb 8192, 128 windows of 256, slide 64) and at the
    edges; two launches bitwise equal."""
    need_card()
    shapes = [dict(KP=64, cap=262144, Rb=8192, C=128, slide=64, rlen=256)]
    shapes += [dict(TWIN_CASES[name]) for name in TWIN_CASES]
    for kw in shapes:
        case = twin_case(seed_of("card", wire, acc, kw), wire, acc, **kw)
        dev = on_card(case)
        rings, outs = [], []
        for _ in range(2):
            ring = dev["ring"].clone()
            outs.append(rk.ring_append_regular_sum(
                ring, dev["blk"], dev["offs"], dev["rstart0"], dev["rlen"],
                case["C"], case["slide"]))
            rings.append(ring)
        ring_p = dev["ring"].clone()
        out_p = rk.ring_append_regular_sum_reference(
            ring_p, dev["blk"], dev["offs"], dev["rstart0"], dev["rlen"],
            case["C"], case["slide"])
        torch.cuda.synchronize()
        assert torch.equal(rings[0], ring_p) and torch.equal(rings[1], ring_p)
        bits = [o.view(torch.int32) for o in outs]
        assert torch.equal(bits[0], bits[1])
        ring = ring_p.cpu().numpy()
        assert_sums_match(outs[0].cpu().numpy(), out_p.cpu().numpy(),
                          window_abs_sums(ring, case["rstart0"],
                                          case["rlen"], case["C"],
                                          case["slide"]))


@pytest.mark.cuda
@pytest.mark.parametrize("case_name", list(TWIN_CASES))
@pytest.mark.parametrize("acc", ACCS, ids=lambda d: np.dtype(d).name)
def test_kernels_equal_twin_bitwise_on_card(acc, case_name):
    """The fused kernel, ring_append and the window sums alone equal
    the twin bit for bit (float32 sums included), for offsets ≡ 0..3."""
    need_card()
    for offs_mod in range(4):
        case = twin_case(seed_of("bits", case_name, acc, offs_mod), np.int8,
                         acc, offs_mod=offs_mod, **TWIN_CASES[case_name])
        want_ring, want_out, _, _ = twin_run(case)
        dev = on_card(case)
        ring = dev["ring"].clone()
        out = rk.ring_append_regular_sum(ring, dev["blk"], dev["offs"],
                                         dev["rstart0"], dev["rlen"],
                                         case["C"], case["slide"])
        appended = rk.ring_append(dev["ring"].clone(), dev["blk"],
                                  dev["offs"])
        alone = sums_alone(appended, dev["rstart0"], dev["rlen"], case["C"],
                           case["slide"])
        torch.cuda.synchronize()
        assert ring.cpu().numpy().tobytes() == want_ring.tobytes()
        assert appended.cpu().numpy().tobytes() == want_ring.tobytes()
        assert out.cpu().numpy().tobytes() == want_out.tobytes()
        assert alone.cpu().numpy().tobytes() == want_out.tobytes()
