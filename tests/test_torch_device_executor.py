"""The port's DeviceWindowExecutor (device="cpu": the kernel's plain
version) against the JAX package's (use_pallas=True: the Pallas kernel in
interpret mode), fed the same launches made with numpy from a seed.
Integer results must match exactly; float64 columns are reduced in float32
by both (jax.device_put without x64 / the port's explicit cast), and their
sums differ only by reduction order: rtol=1e-5 of the sum of |x|."""

import warnings

import numpy as np
import pytest

from windflow_tpu.ops.device import DeviceWindowExecutor as JaxExecutor
from windflow_tpu.ops.device import builtin_batch_fn
from windflow_tpu_torch.ops.device import DeviceWindowExecutor, canonical_dtype
from windflow_tpu_torch.ops.monoid import identity


def make_launch(seed, B, max_len, dtype=np.int64):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, max_len + 1, size=B).astype(np.int64)
    lens[::5] = 0
    starts = np.concatenate([[0], np.cumsum(lens)[:-1] // 2]).astype(np.int64)
    n = int((starts + lens).max()) if B else 0
    if np.dtype(dtype).kind == "f":
        col = rng.uniform(-100, 100, size=n).astype(dtype)
    else:
        col = rng.integers(-100, 100, size=n).astype(dtype)
    return {"value": col}, starts, lens


def pair(op, out_dtype=np.int64, depth=4, fields=("value",), **kw):
    empty = {"value": identity(op, out_dtype)}
    jax_ex = JaxExecutor(builtin_batch_fn(op, "value"), fields=fields,
                         out_fields=("value",), depth=depth, use_pallas=True,
                         op=op, out_dtypes={"value": out_dtype},
                         empty_fill=empty, **kw)
    port_ex = DeviceWindowExecutor(op, fields=fields, out_fields=("value",),
                                   device="cpu", depth=depth,
                                   out_dtypes={"value": out_dtype},
                                   empty_fill=empty, **kw)
    return jax_ex, port_ex


def launch_both(jax_ex, port_ex, meta, cols, starts, lens):
    keys = np.zeros(len(starts), dtype=np.int64)
    jax_ex.launch(meta, cols, starts, lens, keys, keys)
    port_ex.launch(meta, cols, starts, lens)


@pytest.mark.parametrize("op", ["sum", "count", "min", "max", "prod"])
def test_launch_matches_jax_with_empty_fill(op):
    """int64 payloads, empty windows filled with the int64 identity, the
    int32 results cast back to out_dtypes=int64."""
    jax_ex, port_ex = pair(op)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i in range(3):
            launch_both(jax_ex, port_ex, i, *make_launch(i, 37, 9))
    want, got = jax_ex.drain(), port_ex.drain()
    assert [m for m, _ in got] == [m for m, _ in want] == [0, 1, 2]
    for (_, g), (_, w) in zip(got, want):
        assert g["value"].dtype == w["value"].dtype == np.int64
        np.testing.assert_array_equal(g["value"], w["value"])
    if op in ("min", "max", "prod"):
        assert identity(op, np.int64) in got[0][1]["value"]


def test_int64_downcast_warns_once_like_jax():
    jax_ex, port_ex = pair("sum")
    cols, starts, lens = make_launch(1, 8, 4)
    keys = np.zeros(len(starts), dtype=np.int64)
    for ex, args in ((jax_ex, (cols, starts, lens, keys, keys)),
                     (port_ex, (cols, starts, lens))):
        with pytest.warns(UserWarning, match="downcasts int64 payloads"):
            ex.launch(0, *args)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            ex.launch(1, *args)


def test_compute_dtype_skips_downcast_warning():
    jax_ex, port_ex = pair("sum", out_dtype=np.float64,
                           compute_dtype=np.float32)
    cols, starts, lens = make_launch(2, 16, 6)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        launch_both(jax_ex, port_ex, 0, cols, starts, lens)
    (_, w), = jax_ex.drain()
    (_, g), = port_ex.drain()
    np.testing.assert_array_equal(g["value"], w["value"])


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_float64_canonicalised_to_float32(op):
    """float64 columns reduce in float32 on both sides (what
    jax.device_put does without x64), then cast to out_dtypes."""
    jax_ex, port_ex = pair(op, out_dtype=np.float64)
    cols, starts, lens = make_launch(3, 40, 12, dtype=np.float64)
    launch_both(jax_ex, port_ex, 0, cols, starts, lens)
    (_, w), = jax_ex.drain()
    (_, g), = port_ex.drain()
    assert g["value"].dtype == w["value"].dtype == np.float64
    if op == "sum":
        c = cols["value"].astype(np.float32)
        scale = np.array([np.abs(c[s:s + l]).sum()
                          for s, l in zip(starts, lens)])
        assert np.all(np.abs(g["value"] - w["value"]) <= 1e-5 * scale)
    else:
        np.testing.assert_array_equal(g["value"], w["value"])
    assert canonical_dtype(np.float64) == np.float32
    assert canonical_dtype(np.int64) == np.int32


def test_count_stages_no_field():
    jax_ex, port_ex = pair("count", fields=())
    _, starts, lens = make_launch(4, 24, 7)
    launch_both(jax_ex, port_ex, 0, {}, starts, lens)
    (_, w), = jax_ex.drain()
    (_, g), = port_ex.drain()
    np.testing.assert_array_equal(g["value"], w["value"])
    np.testing.assert_array_equal(g["value"], lens)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_depth_bounded_poll_drain_order(depth):
    """At most `depth` launches stay in flight; poll + drain hand results
    back in launch order, as the JAX executor does."""
    jax_ex, port_ex = pair("max", depth=depth)
    seen = {"jax": [], "port": []}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i in range(7):
            launch_both(jax_ex, port_ex, i, *make_launch(10 + i, 12, 5))
            assert len(port_ex._inflight) <= depth
            assert len(jax_ex._inflight) <= depth
            if i % 3 == 2:
                seen["jax"] += jax_ex.poll()
                seen["port"] += port_ex.poll()
    seen["jax"] += jax_ex.drain()
    seen["port"] += port_ex.drain()
    assert [m for m, _ in seen["port"]] == list(range(7))
    assert [m for m, _ in seen["jax"]] == list(range(7))
    for (_, g), (_, w) in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(g["value"], w["value"])
    assert not port_ex._inflight and port_ex.drain() == []
