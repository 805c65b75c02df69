"""Device execution of window batches on a CUDA card — the port of
``windflow_tpu/ops/device.py`` (itself the graft of the reference's CUDA
micro-batch path, win_seq_gpu.hpp:429-501).

A window batch is a *flat* buffer of archive rows plus per-window
(start, len): the flat buffer is staged once even though consecutive
sliding windows overlap.  For a builtin monoid one launch of the
hand-written windowed-reduce kernel (ops/windowed_reduce.py) evaluates
every window of the batch.  For a user window function
(``TorchWindowFunction``, patterns/win_seq_gpu.py) the hand-written
``window_gather`` kernel (ops/gather.py) expands each staged field into a
masked ``(B, pad)`` tile, and the function runs over the tiles on the
executor's device and stream: ``fn(keys, gwids, cols, mask)``.

Differences from the JAX executor, each on purpose:

* **No shape buckets.** XLA needs static shapes, so the JAX executor pads
  B, pad and N to powers of two (doubling the host-to-device copy at the
  bench shape).  The kernels take runtime sizes and mask their own tails.
  A user function's tiles keep the JAX width, ``pad = _bucket(max len)``,
  so it sees the same tile shape; ``B`` stays exact.
* **Explicit column dtypes.** A builtin monoid's column is staged and
  reduced in the dtype the JAX package's XLA route (its default, the
  non-Pallas one) computes in, written out here (:func:`staged_dtypes`):

  - a column without a 64-bit ``compute_dtype`` follows JAX's default
    config (no x64): int8 and int16 columns sum and multiply in int32,
    uint8 and uint16 in uint32 (their min and max keep the column's dtype);
    uint32 stays uint32 and uint64 is narrowed to uint32 (what
    ``jax.device_put`` does); int64 is narrowed to int32 with JAX's
    warning; float16 stays float16, reduced in float32 and rounded once;
    float64 is narrowed to float32; a bool column sums and multiplies in
    int32 (its min and max raise, as JAX's do);
  - an explicit 64-bit ``compute_dtype`` (int64, uint64, float64) follows
    JAX under x64: the column is staged and reduced in 64 bits (and a
    narrow column's sum widens to int64 or uint64).

  JAX's Pallas route (``use_pallas=True``) stores a sum or product of
  int8, int16, uint8 or uint16 values in the column dtype, so it wraps
  there; the port follows the XLA route, which does not.  A user window
  function's staged columns are 32-bit (:func:`canonical_dtype`), or 64-bit
  under a 64-bit ``compute_dtype``, as JAX under x64 hands them over.
* **Async protocol.** Every launch, copy and allocation runs on the
  executor's own ``torch.cuda.Stream`` inside its device context (a user
  function's torch ops included).  Host-to-device copies go through pinned
  staging tensors with ``non_blocking=True``; results come back into
  pinned host tensors; a ``torch.cuda.Event`` per launch takes the place
  of ``copy_to_host_async``/``is_ready``.  Every tensor of a launch, pinned
  or on the card, stays referenced in ``_inflight`` until its event has
  completed.
* **Dispatch by device.** A CUDA device launches the kernel; a CPU device
  (the tests) runs its plain version, synchronously.
"""

from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch

from .gather import window_gather
from .monoid import identity
from .windowed_reduce import windowed_reduce


def _bucket(n: int, lo: int = 8) -> int:
    """Next power of two >= n.  The restaging executor does not bucket; the
    resident ring's geometry (KP, cap, Rb, C) stays on this ladder because
    the native core (wf_native.cpp ``bucket``) hands over bucketed KP and
    cap, and the host rebase rules are written against it."""
    b = lo
    while b < n:
        b *= 2
    return b


def canonical_dtype(dtype: np.dtype) -> np.dtype:
    """The dtype a user window function's column is staged in without a
    64-bit ``compute_dtype``: the 32-bit width of its kind (float64 ->
    float32, int64 -> int32, as ``jax.device_put`` without x64); other
    integer and boolean columns are widened to int32."""
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return np.dtype(np.float32)
    if dtype.kind in "iub":
        return np.dtype(np.int32)
    raise TypeError(f"the device path reduces numeric columns only, got "
                    f"{dtype}")


def staged_dtypes(dtype, op: str, x64: bool = False):
    """``(staged, result)``: the dtype a builtin monoid `op` reads a column
    of `dtype` in (one of the windowed-reduce kernel's) and the dtype of
    its result, as the JAX package's XLA route gives them (module
    docstring); `x64` for a column cast by a 64-bit ``compute_dtype``."""
    dtype = np.dtype(dtype)
    kind, size = dtype.kind, dtype.itemsize
    wide = {"i": np.int64 if x64 else np.int32,
            "u": np.uint64 if x64 else np.uint32}
    if kind == "b":
        if op in ("min", "max"):
            raise TypeError(f"{op} over a bool column: the JAX package "
                            "raises too (no identity)")
        staged = np.dtype(wide["i"])
        return staged, staged
    if kind in "iu" and size < 4:
        # jnp.sum / jnp.prod widen to the default integer of the kind;
        # min and max keep the column's dtype (reduced 32 bits wide)
        staged = np.dtype(wide[kind] if op in ("sum", "prod") else
                          np.int32 if kind == "i" else np.uint32)
        return staged, (staged if op in ("sum", "prod") else dtype)
    if kind in "iuf" and (size <= 4 or x64):
        return dtype, dtype
    if kind in "iuf":
        staged = np.dtype({"i": np.int32, "u": np.uint32,
                           "f": np.float32}[kind])
        return staged, staged
    raise TypeError(f"the device path reduces numeric columns only, got "
                    f"{dtype}")


_INT32_MIN, _INT32_MAX = -(2 ** 31), 2 ** 31 - 1


def warn_id_range(keys: np.ndarray, gwids: np.ndarray) -> bool:
    """The JAX package's range warning: keys and gwids reach a user window
    function as int32 (``jax.device_put`` without x64), so values outside
    the int32 range wrap.  Returns True when it warned."""
    for name, a in (("keys", keys), ("gwids", gwids)):
        a = np.asarray(a)
        fits = (a.dtype.kind == "i" and a.dtype.itemsize <= 4) or \
               (a.dtype.kind == "u" and a.dtype.itemsize <= 2)
        if fits or not len(a):
            continue  # provably within int32: skip the O(B) scan
        mx, mn = int(a.max()), int(a.min())
        if mx > _INT32_MAX or mn < _INT32_MIN:
            bad = mx if mx > _INT32_MAX else mn
            warnings.warn(
                f"device path downcasts {name} to int32 and {bad} is out of "
                "range; a window function reading them will see wrapped "
                "values", stacklevel=4)
            return True
    return False


class DeviceWindowExecutor:
    """Launches batched window evaluations with bounded asynchronous depth.

    A builtin monoid: ``op`` (sum, count, min, max, prod) over the one
    staged field in ``fields`` (none for count), by the windowed-reduce
    kernel.  A user window function: ``fn(keys, gwids, cols, mask)``
    (``op`` None) over the masked ``(B, pad)`` tiles of every field in
    ``fields``, gathered by the window_gather kernel; it returns one
    ``(B,)`` tensor or a tuple of them, one per ``out_fields`` entry.
    Results land in ``out_fields`` cast to ``out_dtypes``, with
    ``empty_fill`` written over empty windows (builtins only: a user
    function answers empty windows itself, as in the JAX package)."""

    def __init__(self, op=None, fields=("value",), out_fields=("value",),
                 device="cuda", depth: int = 4, compute_dtype=None,
                 out_dtypes=None, empty_fill=None, fn=None):
        if (op is None) == (fn is None):
            raise ValueError("pass exactly one of op (a builtin monoid) and "
                             "fn (a user window function)")
        self.op = op
        self.fn = fn
        self.fields = tuple(fields)
        if op is not None and len(self.fields) > 1:
            raise ValueError("a builtin reduction stages at most one field")
        self.out_fields = tuple(out_fields)
        self.device = torch.device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.depth = depth
        self.compute_dtype = compute_dtype
        # result dtypes per out_field: harvest casts into them so that
        # empty-window fills (below) can hold full-width identities
        self.out_dtypes = {f: np.dtype(d) for f, d in (out_dtypes or {}).items()}
        # {field: value} written over empty windows at harvest — keeps the
        # device path's empty-window results identical to the host path's
        # even though compute happens in a narrower dtype (int32 vs int64)
        self.empty_fill = dict(empty_fill or {})
        # a 64-bit compute_dtype: the columns follow JAX under x64
        self._x64 = (compute_dtype is not None
                     and np.dtype(compute_dtype).itemsize == 8)
        # [(meta, B, empty_mask, host_results, event, keepalive,
        #   narrow)]: narrow is (result dtype, lens == 0) where a narrow
        #   column's min or max is cast back to its dtype
        self._inflight = []
        self._ready = []     # harvested result batches (host)
        self._warned_downcast = False
        self._warned_id_range = False

    @contextlib.contextmanager
    def _on_stream(self):
        """The executor's device and stream as the current ones: kernels
        launch, copies run, a user function's ops run and device tensors
        are allocated on them."""
        if self._stream is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            yield

    def _cast_column(self, col: np.ndarray) -> np.ndarray:
        """A value column as JAX's executor stages it: cast to
        ``compute_dtype`` (numeric columns), else int64 warned about."""
        col = np.asarray(col)
        if self.compute_dtype is not None and col.dtype.kind in "iuf":
            col = col.astype(self.compute_dtype)
        elif col.dtype == np.int64 and not self._warned_downcast:
            # device-native integer width; reductions exceeding int32
            # range will wrap — pick compute_dtype explicitly for wide sums
            self._warned_downcast = True
            warnings.warn(
                "device path downcasts int64 payloads to int32; "
                "window reductions beyond ±2^31 will overflow — pass "
                "compute_dtype (e.g. np.float32) for wide ranges",
                stacklevel=4)
        return col

    def _stage_fn_column(self, col: np.ndarray) -> np.ndarray:
        """A user function's column in its tile dtype: 32-bit, or 64-bit
        as it is under a 64-bit compute_dtype."""
        col = self._cast_column(col)
        if self._x64 and col.dtype.itemsize == 8:
            return col
        return col.astype(canonical_dtype(col.dtype), copy=False)

    def _to_device(self, host: np.ndarray):
        """(device tensor, pinned staging tensor or None) for one array;
        call on the executor's stream."""
        t = torch.from_numpy(np.ascontiguousarray(host))
        if self._stream is None:
            return t, None
        pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        pinned.copy_(t)
        return pinned.to(self.device, non_blocking=True), pinned

    def _fetch(self, outs):
        """Start the copies of `outs` into pinned host tensors; returns
        (host tensors, event) — event None on the CPU."""
        if self._stream is None:
            return tuple(outs), None
        hosts = []
        for o in outs:
            h = torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
            h.copy_(o, non_blocking=True)
            hosts.append(h)
        event = torch.cuda.Event()
        event.record(self._stream)
        return tuple(hosts), event

    def launch(self, meta, flat_cols: dict, starts: np.ndarray,
               lens: np.ndarray, keys: np.ndarray = None,
               gwids: np.ndarray = None):
        """Asynchronously evaluate one window batch.  `meta` is returned
        with the results at harvest time (host-side result headers);
        `keys`/`gwids` (one per window) are what a user function reads."""
        if self.fn is not None:
            self._launch_fn(meta, flat_cols, starts, lens, keys, gwids)
        else:
            self._launch_op(meta, flat_cols, starts, lens)
        while len(self._inflight) > self.depth:
            self._harvest_one()

    def _launch_op(self, meta, flat_cols, starts, lens):
        B = len(starts)
        pad = max(int(lens.max()) if B else 1, 1)
        narrow = None
        if self.fields and self.op != "count":
            col = self._cast_column(flat_cols[self.fields[0]])
            staged, result = staged_dtypes(col.dtype, self.op, self._x64)
            flat = col.astype(staged, copy=False)
            if result != staged:
                narrow = (result, np.asarray(lens) == 0)
        else:
            # count reads no values: it returns the lengths, in int32 as
            # JAX's jnp.sum of the mask (a staged field still warns)
            if self.fields:
                self._cast_column(flat_cols[self.fields[0]])
            flat = np.zeros(0, dtype=np.int32)
        sl = np.stack([np.asarray(starts, dtype=np.int32),
                       np.asarray(lens, dtype=np.int32)])
        with self._on_stream():
            d_flat, p_flat = self._to_device(flat)
            d_sl, p_sl = self._to_device(sl)
            out = windowed_reduce(d_flat, d_sl[0], d_sl[1], pad, self.op)
            hosts, event = self._fetch((out,))
        empty = lens == 0 if self.empty_fill and (lens == 0).any() else None
        self._inflight.append((meta, B, empty, hosts, event,
                               (p_flat, p_sl, d_flat, d_sl, out), narrow))

    def _launch_fn(self, meta, flat_cols, starts, lens, keys, gwids):
        B = len(starts)
        # the JAX executor's tile width, so the function sees the same shape
        pad = _bucket(int(lens.max()) if B else 1)
        keys = np.zeros(B, np.int64) if keys is None else np.asarray(keys)
        gwids = np.zeros(B, np.int64) if gwids is None else np.asarray(gwids)
        if not self._warned_id_range:
            self._warned_id_range = warn_id_range(keys, gwids)
        cols = [self._stage_fn_column(flat_cols[f]) for f in self.fields]
        # starts, lens, keys, gwids: one int32 copy (keys and gwids wrap
        # like the JAX package's int32 cast)
        vec = np.stack([np.asarray(a).astype(np.int32)
                        for a in (starts, lens, keys, gwids)])
        with self._on_stream():
            staged = [self._to_device(c) for c in cols]
            d_vec, p_vec = self._to_device(vec)
            if staged:
                tiles, mask = window_gather([d[None, :] for d, _ in staged],
                                            None, d_vec[0], d_vec[1], pad)
            else:
                tiles = ()
                mask = (torch.arange(pad, device=self.device)[None, :]
                        < d_vec[1][:, None])
            out = self.fn(d_vec[2], d_vec[3], dict(zip(self.fields, tiles)),
                          mask)
            outs = out if isinstance(out, tuple) else (out,)
            hosts, event = self._fetch(outs)
        self._inflight.append((meta, B, None, hosts, event,
                               (staged, d_vec, p_vec, tiles, mask, outs),
                               None))

    def _harvest_one(self):
        meta, B, empty, hosts, event, _keep, narrow = self._inflight.pop(0)
        if event is not None:
            event.synchronize()
        cols = {}
        for f, h in zip(self.out_fields, hosts):
            v = h.numpy()[:B]
            if narrow is not None:
                # a narrow column's min or max, reduced 32 bits wide: its
                # own dtype, and its identity over empty windows
                dt, zero = narrow
                v = v.astype(dt)
                v[zero] = identity(self.op, dt)
            dt = self.out_dtypes.get(f)
            if dt is not None and v.dtype != dt:
                v = v.astype(dt)
            if empty is not None and f in self.empty_fill:
                v = v.copy() if v.base is not None else v
                v[empty] = self.empty_fill[f]
            cols[f] = v
        self._ready.append((meta, cols))

    def poll(self):
        """Harvest any completed launches without blocking on new ones;
        returns [(meta, {field: values})]."""
        while self._inflight and (self._inflight[0][4] is None
                                  or self._inflight[0][4].query()):
            self._harvest_one()
        ready, self._ready = self._ready, []
        return ready

    def drain(self):
        """Block until every in-flight batch is harvested."""
        while self._inflight:
            self._harvest_one()
        ready, self._ready = self._ready, []
        return ready
