"""The port's skyline window function (apps/spatial.device_skyline().fn:
ops/skyline.skyline_windows, on CPU tensors its plain version) against the
JAX package's device_skyline().fn (the masked (B, pad, pad) float32
dominance test, run by XLA on the CPU) and the host numpy skyline, on the
same (B, pad) tiles made from numpy seeds.  On the 1/256 grid every
result is exact; with unquantised coordinates sizes must be exact and
checksums within rtol 1e-5 (float32 sums in another order).

``twin`` is the kernel's algorithm (csrc/skyline.cu) in plain torch and
numpy: per group of 8 threads the real lane of least x + y among the
lanes those threads stage, the candidates no other candidate dominates as
the filter, the exact filter, the worklist verified against itself, and
the kernel's fixed-order float32 reduction.  On the CPU it is held against the plain version and the JAX
fn; on the card the kernel must equal it bit for bit, unquantised inputs
included.  The ``cuda``-marked cases hold the kernel against the plain
version and the twin (JAX and the JAX package are imported inside the CPU
twins' helpers only, so the card's machine, which has no JAX, collects
this file too)."""

import numpy as np
import pytest
import torch

from windflow_tpu_torch.apps.spatial import device_skyline
from windflow_tpu_torch.ops import skyline as sk

RTOL = 1e-5
# the kernel's constants (csrc/skyline.cu)
THREADS, GROUP = 512, 8
INF = float("inf")


def tiles(seed, B, pad, lens=None, grid=True, holes=False, dup=False,
          ties=False):
    rng = np.random.default_rng(seed)
    lens = (rng.integers(0, pad + 1, size=B) if lens is None
            else np.asarray(lens))
    mask = np.arange(pad)[None, :] < lens[:, None]
    if holes:
        mask &= rng.random((B, pad)) < 0.7
    x = rng.uniform(0, 100, size=(B, pad))
    y = rng.uniform(0, 100, size=(B, pad))
    if grid:
        x, y = np.round(x * 256) / 256, np.round(y * 256) / 256
    if dup:
        x[:, 1::2], y[:, 1::2] = x[:, 0::2], y[:, 0::2]
    if ties:
        x = np.floor(x / 20) * 20
    x = np.where(mask, x, 0).astype(np.float32)
    y = np.where(mask, y, 0).astype(np.float32)
    return x, y, mask


def dominated_by(xj, yj, xi, yi):
    """(len(xi), len(xj)) bool: point j dominates point i."""
    xj, yj, xi, yi = xj[None, :], yj[None, :], xi[:, None], yi[:, None]
    return (xj <= xi) & (yj <= yi) & ((xj < xi) | (yj < yi))


def twin_filter(x, y, real):
    """The kernel's stages 1-3 for one window (1-D tensors): (candidate
    lanes, the filter's lanes, the lanes that pass the filter, hi).  The
    staging pass gives thread t the quads q = t mod THREADS (16-byte loads)
    when pad % 4 == 0, else the lanes l = t mod THREADS."""
    pad = len(real)
    lanes = torch.arange(pad)
    owner = (lanes // 4 if pad % 4 == 0 else lanes) % THREADS
    s = (x + y).numpy()
    ok = real.numpy() & (s < INF)             # a NaN sum never wins
    cand = []
    for g in range(THREADS // GROUP):
        mine = np.flatnonzero(ok & (owner.numpy() // GROUP == g))
        if len(mine):                         # else a NaN placeholder
            cand.append(int(mine[np.lexsort((mine, s[mine]))[0]]))
    cand = torch.tensor(cand, dtype=torch.long)
    xs = torch.where(real, x, INF)            # a masked lane: (inf, inf)
    ys = torch.where(real, y, INF)
    cx, cy = xs[cand], ys[cand]
    filt = cand[~dominated_by(cx, cy, cx, cy).any(dim=1)]
    passed = real & ~dominated_by(xs[filt], ys[filt], xs, ys).any(dim=1)
    return cand, filt, passed, xs, ys


def twin_window(x, y, real):
    """The kernel's survivor flags for one window (1-D tensors)."""
    alive = torch.zeros_like(real)
    if not bool(real.any()):
        return alive
    _, _, passed, xs, ys = twin_filter(x, y, real)
    work = torch.nonzero(passed).flatten()
    wx, wy = xs[work], ys[work]
    alive[work[~dominated_by(wx, wy, wx, wy).any(dim=1)]] = True
    return alive


def twin_reduce(x, y, alive):
    """The kernel's fixed-order (size, checksum) of one window: each of
    THREADS threads adds its lanes in order, a shuffle-down tree per warp
    of 32, the warps' sums in order (float32 throughout)."""
    n = len(alive)
    rows = -(-n // THREADS)
    v = np.zeros(rows * THREADS, np.float32)
    a = alive.numpy()
    with np.errstate(invalid="ignore"):       # inf - inf, as the card
        v[:n] = np.where(a, x.numpy() + y.numpy(), np.float32(0))
    acc = np.zeros(THREADS, np.float32)
    for r in range(rows):
        live = np.zeros(THREADS, bool)
        live[:max(0, min(THREADS, n - r * THREADS))] = \
            a[r * THREADS:(r + 1) * THREADS]
        acc = np.where(live, acc + v[r * THREADS:(r + 1) * THREADS], acc)
    w = acc.reshape(-1, 32)
    for off in (16, 8, 4, 2, 1):
        w = np.concatenate([w[:, :32 - off] + w[:, off:], w[:, 32 - off:]],
                           axis=1)
    total = np.float32(0)
    for k in range(len(w)):
        total = np.float32(total + w[k, 0])
    return int(a.sum()), total


def twin(x, y, mask):
    """(size int32, checksum float32) of every window by the kernel's
    algorithm, from numpy (B, pad) tiles."""
    xt, yt, mt = (torch.from_numpy(np.ascontiguousarray(a))
                  for a in (x, y, mask))
    out = [twin_reduce(xt[b], yt[b], twin_window(xt[b], yt[b], mt[b]))
           for b in range(len(x))]
    return (np.array([o[0] for o in out], np.int32),
            np.array([o[1] for o in out], np.float32))


def port_fn(x, y, mask):
    keys = torch.zeros(len(x), dtype=torch.int32)
    size, cs = device_skyline().fn(keys, keys, {"x": torch.from_numpy(x),
                                                "y": torch.from_numpy(y)},
                                   torch.from_numpy(mask))
    assert size.dtype == torch.int32 and cs.dtype == torch.float32
    return size.numpy(), cs.numpy()


def jax_fn(x, y, mask):
    import jax.numpy as jnp
    from windflow_tpu.apps.spatial import device_skyline as jax_device_skyline
    keys = jnp.zeros(len(x), dtype=jnp.int32)
    size, cs = jax_device_skyline().fn(keys, keys, {"x": jnp.asarray(x),
                                                    "y": jnp.asarray(y)},
                                       jnp.asarray(mask))
    return np.asarray(size), np.asarray(cs)


def host(x, y, mask):
    from windflow_tpu.apps.spatial import skyline as np_skyline
    out = [np_skyline(np.stack([x[b][mask[b]], y[b][mask[b]]], axis=1)
                      .astype(np.float64)) for b in range(len(x))]
    return (np.array([len(s) for s in out]),
            np.array([s.sum() for s in out]))


CASES = {
    "prefix": dict(B=12, pad=64),
    "holes": dict(B=10, pad=64, holes=True),
    "all_masked": dict(B=3, pad=32, lens=[0, 0, 0]),
    "n1": dict(B=4, pad=32, lens=[1, 1, 0, 32]),
    "duplicates": dict(B=6, pad=64, dup=True),
    "ties_one_axis": dict(B=6, pad=64, ties=True),
    "wide": dict(B=2, pad=1500, lens=[1500, 1100]),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_grid_exact_against_jax_and_host(case, seed):
    x, y, mask = tiles(seed, **CASES[case])
    size, cs = port_fn(x, y, mask)
    jsize, jcs = jax_fn(x, y, mask)
    hsize, hcs = host(x, y, mask)
    np.testing.assert_array_equal(size, jsize)
    np.testing.assert_array_equal(size, hsize)
    np.testing.assert_array_equal(cs, jcs)
    np.testing.assert_array_equal(cs.astype(np.float64), hcs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unquantised_sizes_exact_checksums_close(seed):
    x, y, mask = tiles(seed, B=8, pad=128, grid=False, dup=(seed == 2))
    size, cs = port_fn(x, y, mask)
    jsize, jcs = jax_fn(x, y, mask)
    np.testing.assert_array_equal(size, jsize)
    np.testing.assert_allclose(cs, jcs, rtol=RTOL)
    hsize, hcs = host(x, y, mask)
    np.testing.assert_array_equal(size, hsize)
    np.testing.assert_allclose(cs, hcs, rtol=RTOL)


def special_tiles(seed, B=6, pad=256):
    """Grid tiles with NaN and +-inf coordinates in real lanes, a window
    of (inf, inf) points only, a chunk whose sums are all NaN, a column of
    -inf x."""
    x, y, mask = tiles(seed, B, pad, lens=[pad, 200, pad, 64, pad, 3])
    rng = np.random.default_rng(seed + 100)
    for t in (x, y):
        pick = (rng.random((B, pad)) < 0.05) & mask
        t[pick] = np.array([np.nan, INF, -INF], np.float32)[
            rng.integers(0, 3, size=(B, pad))][pick]
    x[2], y[2] = INF, INF
    x[3, :32], y[3, :32] = np.nan, 1.0
    x[4, ::2] = -INF
    return x, y, mask


def dominated_candidate_tiles(seed):
    """Chunk 0's least-sum point (10, 10) is dominated by chunk 1's
    (5, 5), so the filter drops it; chunk 2's anti-diagonal points are all
    candidates of their own."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.uniform(50, 100, size=(1, 128)) * 256) / 256
    y = np.round(rng.uniform(50, 100, size=(1, 128)) * 256) / 256
    x[0, 7], y[0, 7] = 10, 10
    x[0, 40], y[0, 40] = 5, 5
    x[0, 64:96] = np.arange(32) + 1
    y[0, 64:96] = 40 - np.arange(32)
    return (x.astype(np.float32), y.astype(np.float32),
            np.ones((1, 128), bool))


def anti_diagonal_tiles(seed, B=2, pad=4500):
    """Every point on x + y = 100: the whole window is its skyline and
    every candidate survives the candidates' own test; pad > 4096 gives a
    thread more than one pass of staging."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.uniform(0, 100, size=(B, pad)) * 256) / 256
    mask = np.arange(pad)[None, :] < np.array([pad, 3000])[:B, None]
    x = np.where(mask, x, 0)
    y = np.where(mask, 100 - x, 0)
    return x.astype(np.float32), y.astype(np.float32), mask


TWIN_CASES = {
    **{name: (lambda seed, kw=kw: tiles(seed, **kw))
       for name, kw in CASES.items() if name != "wide"},
    "nan_inf": special_tiles,
    "dominated_candidate": dominated_candidate_tiles,
    "anti_diagonal_wide": anti_diagonal_tiles,
}


def assert_same(got, want):
    """Sizes equal; checksums equal, NaN where the other has NaN."""
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("case", list(TWIN_CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_twin_matches_plain_and_jax(case, seed):
    """The kernel's algorithm gives the fn's answer: sizes and (on the
    grid) checksums exact, against the plain version and the JAX fn."""
    x, y, mask = TWIN_CASES[case](seed)
    got = twin(x, y, mask)
    assert_same(got, port_fn(x, y, mask))
    if case != "anti_diagonal_wide":        # (B, 4500, 4500) in XLA: slow
        assert_same(got, jax_fn(x, y, mask))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_twin_unquantised_sizes_exact_checksums_close(seed):
    x, y, mask = tiles(seed, B=8, pad=1100, grid=False, holes=(seed == 1))
    size, cs = twin(x, y, mask)
    jsize, jcs = jax_fn(x, y, mask)
    np.testing.assert_array_equal(size, jsize)
    np.testing.assert_allclose(cs, jcs, rtol=RTOL)


def test_twin_filter_keeps_few_lanes_on_uniform_data():
    """The design's premise: on uniform points 64 candidates make a filter
    of a handful of points that leaves a small worklist (the kernel's
    verify pass is then cheap)."""
    x, y, mask = tiles(7, B=4, pad=4096, lens=[4000] * 4)
    for b in range(4):
        cand, filt, passed, _, _ = twin_filter(
            *(torch.from_numpy(a[b]) for a in (x, y, mask)))
        assert len(cand) == THREADS // GROUP
        assert 1 <= len(filt) <= 16
        assert int(passed.sum()) < 100


def test_plain_version_chunks_the_pair_tensor(monkeypatch):
    """The plain version cuts (B, pad, pad) into chunks of windows and of
    points i; any cut gives the same answer."""
    x, y, mask = tiles(4, B=7, pad=96)
    want = port_fn(x, y, mask)
    monkeypatch.setattr(sk, "PLAIN_CHUNK_CELLS", 96 * 5)
    got = port_fn(x, y, mask)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_wrapper_refuses_bad_inputs():
    x = torch.zeros((2, 8))
    m = torch.ones((2, 8), dtype=torch.bool)
    with pytest.raises(TypeError):
        sk.skyline_windows(x.double(), x, m)
    with pytest.raises(TypeError):
        sk.skyline_windows(x, x, m.int())
    with pytest.raises(TypeError):
        sk.skyline_windows(x, x[:, :4], m)


def test_cpu_tensors_do_not_count_launches():
    before = sk.skyline_windows.launches
    port_fn(*tiles(0, B=2, pad=16))
    assert sk.skyline_windows.launches == before


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    need_card()
    for case in CASES.values():
        for grid in (True, False):
            x, y, mask = tiles(3, grid=grid, **case)
            args = [torch.from_numpy(a).cuda() for a in (x, y, mask)]
            before = sk.skyline_windows.launches
            size, cs = sk.skyline_windows(*args)
            want_size, want_cs = sk.skyline_windows_reference(*args)
            torch.cuda.synchronize()
            assert sk.skyline_windows.launches == before + 1
            assert torch.equal(size, want_size)
            if grid:
                assert torch.equal(cs, want_cs)
            else:
                torch.testing.assert_close(cs, want_cs, rtol=RTOL, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TWIN_CASES))
def test_kernel_equals_twin_bitwise_on_card(case):
    """The kernel is the twin's algorithm with its reduction order, so
    sizes and checksums agree bit for bit (NaN where the twin has NaN),
    and two launches agree with each other."""
    need_card()
    x, y, mask = TWIN_CASES[case](3)
    args = [torch.from_numpy(a).cuda() for a in (x, y, mask)]
    got = [sk.skyline_windows(*args) for _ in range(2)]
    torch.cuda.synchronize()
    want = twin(x, y, mask)
    for size, cs in got:
        assert_same((size.cpu().numpy(), cs.cpu().numpy()), want)
    assert torch.equal(got[0][1].view(torch.int32), got[1][1].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_equals_twin_unquantised_on_card(seed):
    need_card()
    x, y, mask = tiles(seed, B=6, pad=4096, lens=[4000, 4096, 3000, 17, 1,
                                                  0], grid=False)
    size, cs = sk.skyline_windows(*(torch.from_numpy(a).cuda()
                                    for a in (x, y, mask)))
    assert_same((size.cpu().numpy(), cs.cpu().numpy()), twin(x, y, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [1023, 16384, 32768])
def test_kernel_wide_and_odd_pads_on_card(pad):
    """An odd pad (scalar staging), a window filling a block's shared
    memory, and one above its budget (the kernel over device memory, with
    the wrapper's scratch): equal to the plain version."""
    need_card()
    x, y, mask = tiles(5, B=3, pad=pad, lens=[pad, pad // 2 + 1, 0],
                       holes=True)
    args = [torch.from_numpy(a).cuda() for a in (x, y, mask)]
    before = sk.skyline_windows.launches
    size, cs = sk.skyline_windows(*args)
    want_size, want_cs = sk.skyline_windows_reference(*args)
    torch.cuda.synchronize()
    assert sk.skyline_windows.launches == before + 1
    assert torch.equal(size, want_size) and torch.equal(cs, want_cs)
