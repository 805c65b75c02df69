"""Device execution of window batches on a CUDA card — the port of
``windflow_tpu/ops/device.py`` (itself the graft of the reference's CUDA
micro-batch path, win_seq_gpu.hpp:429-501).

A window batch is a *flat* buffer of archive rows plus per-window
(start, len): the flat buffer is staged once even though consecutive
sliding windows overlap.  One launch of the hand-written windowed-reduce
kernel (ops/windowed_reduce.py) evaluates every window of the batch.

Differences from the JAX executor, each on purpose:

* **No shape buckets.** XLA needs static shapes, so the JAX executor pads
  B, pad and N to powers of two (doubling the host-to-device copy at the
  bench shape).  The kernel takes runtime sizes and masks its own tails.
* **Explicit dtype canonicalisation.** The JAX package runs without x64:
  ``jax.device_put`` turns float64 into float32 and int64 into int32.
  Here the same casts are written out (:func:`canonical_dtype`).
* **Async protocol.** Host-to-device copies go through pinned staging
  tensors with ``non_blocking=True``; results come back into pinned host
  tensors; a ``torch.cuda.Event`` per launch takes the place of
  ``copy_to_host_async``/``is_ready``.  Every pinned tensor of a launch
  stays referenced in ``_inflight`` until its event has completed.
* **Dispatch by device.** A CUDA device launches the kernel; a CPU device
  (the tests) runs its plain version, synchronously.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

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
    """The dtype a value column is reduced in on the device: the 32-bit
    width of its kind, as the JAX package gets it from ``jax.device_put``
    without x64 (float64 -> float32, int64 -> int32).  Other integer and
    boolean columns are widened to int32, the kernel's only integer type."""
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return np.dtype(np.float32)
    if dtype.kind in "iub":
        return np.dtype(np.int32)
    raise TypeError(f"the device path reduces numeric columns only, got "
                    f"{dtype}")


class DeviceWindowExecutor:
    """Launches batched window reductions with bounded asynchronous depth.

    ``op`` is the builtin monoid (sum, count, min, max, prod) over the one
    staged field in ``fields`` (none for count); results land in
    ``out_fields`` cast to ``out_dtypes``, with ``empty_fill`` written over
    empty windows."""

    def __init__(self, op: str, fields=("value",), out_fields=("value",),
                 device="cuda", depth: int = 4, compute_dtype=None,
                 out_dtypes=None, empty_fill=None):
        self.op = op
        self.fields = tuple(fields)
        if len(self.fields) > 1:
            raise ValueError("a builtin reduction stages at most one field")
        self.out_fields = tuple(out_fields)
        self.device = torch.device(device)
        self.depth = depth
        self.compute_dtype = compute_dtype
        # result dtypes per out_field: harvest casts into them so that
        # empty-window fills (below) can hold full-width identities
        self.out_dtypes = {f: np.dtype(d) for f, d in (out_dtypes or {}).items()}
        # {field: value} written over empty windows at harvest — keeps the
        # device path's empty-window results identical to the host path's
        # even though compute happens in a narrower dtype (int32 vs int64)
        self.empty_fill = dict(empty_fill or {})
        # [(meta, B, empty_mask, host_results, event, keepalive)]
        self._inflight = []
        self._ready = []     # harvested result batches (host)
        self._warned_downcast = False

    def _stage_column(self, col: np.ndarray) -> np.ndarray:
        """Host-side cast of one value column to the kernel's dtype."""
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
        return col.astype(canonical_dtype(col.dtype), copy=False)

    def _to_device(self, host: np.ndarray):
        """(device tensor, pinned staging tensor or None) for one array."""
        t = torch.from_numpy(np.ascontiguousarray(host))
        if self.device.type != "cuda":
            return t, None
        pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        pinned.copy_(t)
        return pinned.to(self.device, non_blocking=True), pinned

    def launch(self, meta, flat_cols: dict, starts: np.ndarray,
               lens: np.ndarray):
        """Asynchronously evaluate one window batch.  `meta` is returned
        with the results at harvest time (host-side result headers)."""
        B = len(starts)
        pad = max(int(lens.max()) if B else 1, 1)
        if self.fields:
            flat = self._stage_column(flat_cols[self.fields[0]])
        else:
            flat = np.zeros(0, dtype=np.int32)   # count reads no values
        d_flat, p_flat = self._to_device(flat)
        sl = np.stack([np.asarray(starts, dtype=np.int32),
                       np.asarray(lens, dtype=np.int32)])
        d_sl, p_sl = self._to_device(sl)
        out = windowed_reduce(d_flat, d_sl[0], d_sl[1], pad, self.op)
        if self.device.type == "cuda":
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            keep = (p_flat, p_sl, d_flat, d_sl, out)
        else:
            host, event, keep = out, None, ()
        empty = lens == 0 if self.empty_fill and (lens == 0).any() else None
        self._inflight.append((meta, B, empty, host, event, keep))
        while len(self._inflight) > self.depth:
            self._harvest_one()

    def _harvest_one(self):
        meta, B, empty, host, event, _keep = self._inflight.pop(0)
        if event is not None:
            event.synchronize()
        cols = {}
        for f, v in zip(self.out_fields, (host.numpy()[:B],)):
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
