"""The port's skyline window function (apps/spatial.device_skyline().fn:
ops/skyline.skyline_windows, on CPU tensors its plain version) against the
JAX package's device_skyline().fn (the masked (B, pad, pad) float32
dominance test, run by XLA on the CPU) and the host numpy skyline, on the
same (B, pad) tiles made from numpy seeds.  On the 1/256 grid every
result is exact; with unquantised coordinates sizes must be exact and
checksums within rtol 1e-5 (float32 sums in another order).  The
``cuda``-marked case holds the kernel against the plain version (JAX and
the JAX package are imported inside the CPU twins' helpers only, so the
card's machine, which has no JAX, collects this file too)."""

import numpy as np
import pytest
import torch

from windflow_tpu_torch.apps.spatial import device_skyline
from windflow_tpu_torch.ops import skyline as sk

RTOL = 1e-5


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


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
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
