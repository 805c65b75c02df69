"""The port's window_gather (ops/gather.py; on CPU tensors its plain
version) against the gather of the JAX package's device bodies, written
here with jnp as they are: ops/device.py:156-161 (the restaging flat
buffer, index clamped to N - 1, masked lanes zero) and
ops/resident.py:618-625 (a (KP, cap) ring, index clamped to cap - 1).
Inputs come from numpy seeds; tiles and masks must be identical, for one
field or many (the kernel writes up to 8 per launch, int32 and float32
mixed) and for pads that are not a multiple of 4 (the kernel's 16-byte
stores straddle rows there).  The ``cuda``-marked cases hold the kernel
against the plain version on the card (this file imports JAX only inside
the CPU twins' helpers, so the card's machine, which has no JAX, collects
it too)."""

import numpy as np
import pytest
import torch

from windflow_tpu_torch.ops import gather as g

DTYPES = (np.int32, np.float32)


def values(rng, dtype, shape):
    if np.dtype(dtype).kind == "f":
        return rng.uniform(-100, 100, size=shape).astype(dtype)
    return rng.integers(-1000, 1000, size=shape).astype(dtype)


def jax_restaging(flat, starts, lens, pad):
    """ops/device.py:156-161 over a flat buffer padded to N (the JAX
    executor pads it past every window)."""
    import jax.numpy as jnp
    N = len(flat)
    idx = starts[:, None] + jnp.arange(pad, dtype=jnp.int32)[None, :]
    idx = jnp.minimum(idx, N - 1)
    mask = jnp.arange(pad, dtype=jnp.int32)[None, :] < lens[:, None]
    return np.asarray(jnp.where(mask, jnp.asarray(flat)[idx], 0)), \
        np.asarray(mask)


def jax_ring(ring, rows, starts, lens, pad):
    """ops/resident.py:618-625 over a (KP, cap) ring."""
    import jax.numpy as jnp
    cap = ring.shape[1]
    idx = jnp.minimum(
        starts[:, None] + jnp.arange(pad, dtype=jnp.int32)[None, :], cap - 1)
    mask = jnp.arange(pad, dtype=jnp.int32)[None, :] < lens[:, None]
    vals = jnp.asarray(ring)[rows[:, None], idx]
    return np.asarray(jnp.where(mask, vals, 0)), np.asarray(mask)


def restaging_case(seed, dtype, B=40, max_len=24):
    """Windows laid out as DeviceWinSeqCore stages them: starts within the
    flat buffer, some empty, the last running to the buffer's end."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, max_len + 1, size=B)
    lens[::7] = 0
    starts = np.sort(rng.integers(0, 200, size=B))
    n = int((starts + lens).max())
    return values(rng, dtype, n), starts, lens


def ring_case(seed, dtype, KP=8, cap=64, B=50, pad=32):
    """Windows inside their rows, including ones ending at the ring's last
    column (their padded lanes pass cap) and empty ones."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, KP, size=B)
    lens = rng.integers(0, pad + 1, size=B)
    lens[::5] = 0
    starts = rng.integers(0, cap - pad + 1, size=B)
    starts[1::6] = cap - lens[1::6]       # a window ending at cap
    return values(rng, dtype, (KP, cap)), rows, starts, lens


def as32(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int32))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_restaging_form_matches_jax(seed, dtype):
    flat, starts, lens = restaging_case(seed, dtype)
    pad = 32    # the JAX executor's _bucket(max len)
    tile, mask = g.window_gather(torch.from_numpy(flat)[None, :], None,
                                 as32(starts), as32(lens), pad)
    want, want_mask = jax_restaging(flat, starts, lens, pad)
    assert tile.dtype == torch.from_numpy(flat).dtype
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    np.testing.assert_array_equal(tile.numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ring_form_matches_jax(seed, dtype):
    ring, rows, starts, lens = ring_case(seed, dtype)
    tiles, mask = g.window_gather([torch.from_numpy(ring),
                                   torch.from_numpy(ring * 2)],
                                  as32(rows), as32(starts), as32(lens), 32)
    want, want_mask = jax_ring(ring, rows, starts, lens, 32)
    want2, _ = jax_ring(ring * 2, rows, starts, lens, 32)
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    np.testing.assert_array_equal(tiles[0].numpy(), want)
    np.testing.assert_array_equal(tiles[1].numpy(), want2)


def test_clamp_reads_last_column_and_zeros_masked_lanes():
    """A live lane past the buffer's end reads its last column (XLA's
    clamp); a masked lane is 0 wherever it would point."""
    ring = np.arange(24, dtype=np.int32).reshape(2, 12) + 1
    rows, starts, lens = [1, 0, 1], [10, 11, 0], [4, 1, 0]
    tile, mask = g.window_gather(torch.from_numpy(ring), as32(rows),
                                 as32(starts), as32(lens), 8)
    want, want_mask = jax_ring(ring, np.array(rows), np.array(starts),
                               np.array(lens), 8)
    np.testing.assert_array_equal(tile.numpy(), want)
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    assert tile[0].tolist() == [23, 24, 24, 24, 0, 0, 0, 0]
    assert tile[1].tolist() == [12] + [0] * 7
    assert tile[2].tolist() == [0] * 8 and not mask[2].any()


def test_empty_buffer_and_empty_batch():
    empty = torch.zeros((1, 0), dtype=torch.float32)
    z = as32([0, 0])
    tile, mask = g.window_gather(empty, None, z, z, 8)
    assert tile.shape == (2, 8) and not tile.any() and not mask.any()
    tiles, mask = g.window_gather((torch.ones((2, 4), dtype=torch.int32),),
                                  as32([]), as32([]), as32([]), 8)
    assert tiles[0].shape == (0, 8) and mask.shape == (0, 8)


def mixed_fields(rng, nf, shape):
    """nf buffers of one shape, float32 and int32 alternating."""
    return [values(rng, DTYPES[k % 2], shape) for k in range(nf)]


@pytest.mark.parametrize("pad", [32, 29, 30, 31])
@pytest.mark.parametrize("nf", [1, 8, 9, 16])
def test_many_mixed_fields_match_jax(nf, pad):
    """One call gathers every field (the kernel: one launch per 8) with one
    mask; each tile is the JAX ring gather of its own field."""
    ring, rows, starts, lens = ring_case(nf + pad, np.float32)
    bufs = mixed_fields(np.random.default_rng(pad), nf, ring.shape)
    tiles, mask = g.window_gather([torch.from_numpy(b) for b in bufs],
                                  as32(rows), as32(starts), as32(lens), pad)
    assert len(tiles) == nf
    for buf, tile in zip(bufs, tiles):
        want, want_mask = jax_ring(buf, rows, starts, lens, pad)
        assert tile.dtype == torch.from_numpy(buf).dtype
        np.testing.assert_array_equal(tile.numpy(), want)
        np.testing.assert_array_equal(mask.numpy(), want_mask)


@pytest.mark.parametrize("pad", [29, 30, 31, 61])
def test_one_row_form_odd_pads_match_jax(pad):
    """The restaging one-row form with 3 mixed fields at pads that leave
    rows off 16-byte edges."""
    flat, starts, lens = restaging_case(pad, np.int32)
    rng = np.random.default_rng(pad)
    bufs = [flat, values(rng, np.float32, len(flat)),
            values(rng, np.int32, len(flat))]
    tiles, mask = g.window_gather([torch.from_numpy(b)[None, :]
                                   for b in bufs], None, as32(starts),
                                  as32(lens), pad)
    for buf, tile in zip(bufs, tiles):
        want, want_mask = jax_restaging(buf, starts, lens, pad)
        np.testing.assert_array_equal(tile.numpy(), want)
        np.testing.assert_array_equal(mask.numpy(), want_mask)


def test_refuses_fields_of_unequal_shape_past_one_launch():
    """Every field is checked, the ninth (the second launch's first) too."""
    bufs = [torch.zeros((2, 8), dtype=torch.int32) for _ in range(9)]
    bufs[8] = torch.zeros((2, 7), dtype=torch.int32)
    s = as32([0, 1])
    with pytest.raises(TypeError):
        g.window_gather(bufs, None, s, s, 4)
    bufs[8] = torch.zeros((2, 8), dtype=torch.float16)
    with pytest.raises(TypeError):
        g.window_gather(bufs, None, s, s, 4)


def test_wrapper_refuses_bad_inputs():
    buf = torch.zeros((2, 8), dtype=torch.int32)
    s = as32([0, 1])
    with pytest.raises(TypeError):
        g.window_gather(buf.to(torch.int16), None, s, s, 4)
    with pytest.raises(TypeError):
        g.window_gather((buf, torch.zeros((2, 9), dtype=torch.int32)),
                        None, s, s, 4)
    with pytest.raises(TypeError):
        g.window_gather(buf, None, s.long(), s, 4)
    with pytest.raises(TypeError):
        g.window_gather(buf, as32([0]), s, s, 4)
    with pytest.raises(ValueError):
        g.window_gather((), None, s, s, 4)


def test_cpu_tensors_do_not_count_launches():
    before = g.window_gather.launches
    ring, rows, starts, lens = ring_case(3, np.float32)
    g.window_gather(torch.from_numpy(ring), as32(rows), as32(starts),
                    as32(lens), 32)
    assert g.window_gather.launches == before


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_kernel_matches_plain_on_card(dtype):
    need_card()
    for seed in range(3):
        ring, rows, starts, lens = ring_case(seed, dtype)
        bufs = [torch.from_numpy(ring).cuda(), torch.from_numpy(ring).cuda()]
        args = (as32(rows).cuda(), as32(starts).cuda(), as32(lens).cuda())
        before = g.window_gather.launches
        tiles, mask = g.window_gather(bufs, *args, 32)
        want, want_mask = g.window_gather_reference(bufs, *args, 32)
        torch.cuda.synchronize()
        assert g.window_gather.launches == before + 1
        assert torch.equal(mask, want_mask)
        assert all(torch.equal(t, w) for t, w in zip(tiles, want))
        flat, st, ln = restaging_case(seed, dtype)
        args = (torch.from_numpy(flat).cuda()[None, :], None,
                as32(st).cuda(), as32(ln).cuda(), 32)
        tile, mask = g.window_gather(*args)
        want, want_mask = g.window_gather_reference(*args)
        torch.cuda.synchronize()
        assert torch.equal(tile, want) and torch.equal(mask, want_mask)


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [32, 29, 30, 31, 515])
@pytest.mark.parametrize("nf", [1, 8, 9, 16])
def test_kernel_many_fields_odd_pads_on_card(nf, pad):
    """ceil(nf / 8) launches, tiles and mask bit for bit the plain
    version's, rows aligned or straddling 16-byte edges."""
    need_card()
    ring, rows, starts, lens = ring_case(nf + pad, np.float32)
    bufs = [torch.from_numpy(b).cuda() for b in
            mixed_fields(np.random.default_rng(pad), nf, ring.shape)]
    args = (as32(rows).cuda(), as32(starts).cuda(), as32(lens).cuda(), pad)
    before = g.window_gather.launches
    tiles, mask = g.window_gather(bufs, *args)
    want, want_mask = g.window_gather_reference(bufs, *args)
    torch.cuda.synchronize()
    assert g.window_gather.launches == before + -(-nf // 8)
    assert torch.equal(mask, want_mask)
    assert all(torch.equal(t, w) for t, w in zip(tiles, want))
    flat, st, ln = restaging_case(pad, np.int32)
    one = [torch.from_numpy(flat).cuda()[None, :]] * nf
    args = (None, as32(st).cuda(), as32(ln).cuda(), pad)
    tiles, mask = g.window_gather(one, *args)
    want, want_mask = g.window_gather_reference(one, *args)
    torch.cuda.synchronize()
    assert torch.equal(mask, want_mask)
    assert all(torch.equal(t, w) for t, w in zip(tiles, want))
