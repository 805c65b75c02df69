"""The port's windowed-reduce plain version against the JAX package's
Pallas kernel (interpret mode on the CPU), on the same inputs made with
numpy from a seed.  The CUDA kernel itself is held against the plain
version on the card: the `cuda`-marked test here, and chip_smoke.py.

Tolerances: integers must match exactly (including int32 wrap-around);
float32 min/max/count must match exactly (no rounding is involved); float32
sums and products are reduced in a different order by XLA and by torch, so
they are compared with rtol=1e-5 relative to the sum of |x| over the window
(sum) or to |result| (prod) — a few float32 ulps of a 256-term reduction.
"""

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
