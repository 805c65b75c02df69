"""Device-resident window archives on a CUDA card — the port of
``windflow_tpu/ops/resident.py`` (the single-ring executor, the per-field
one, and their mesh forms).

Each stream row crosses the host-to-device copy once and window evaluation
reads device memory:

* a per-key **ring archive** stays on the card: a ``(KP, cap)`` tensor
  whose row ``r`` holds the live tuples of dense key ``r`` in arrival order
  (the device twin of ``core/archive.py``'s ``KeyArchive``);
* each launch appends the new rows as ONE rectangle in the narrowest wire
  dtype that holds them (int8/int16/int32/float32), widened to the
  accumulate dtype on the card;
* the fired windows are then evaluated over the ring in the same launch
  as the append: regular windows by the ``ring_append_regular_sum``
  kernel (one launch a flush, as the JAX step ``_regular_body`` is one
  jitted step), windows given by explicit (row, start, len) descriptors
  by the ``ring_append_eval`` kernel, every op in that one launch (as
  JAX's ``_append_eval`` is one jitted step);
* with several fields (:class:`MultiFieldResidentExecutor`) each field has
  a ring of its own, each ``(op, field)`` stat reads its field's ring,
  and a bound user window function reads masked ``(B, pad)`` tiles of its
  fields; the ``ring_append_multi_eval`` kernel appends every field,
  evaluates every stat and cuts the tiles in one launch (as JAX's
  ``_make_multi_step`` is one jitted step), after one copy of the
  dispatch's staging buffer;
* with a device mesh (:class:`MeshResidentExecutor`,
  :class:`MeshMultiFieldResidentExecutor`) every kf shard holds the rows of
  its keys in rings of its own on its own device and stream, and a launch
  runs the same kernels on every shard;
* results come back through pinned host tensors with bounded depth.

The host side (``ResidentWinSeqCore`` in patterns/win_seq_gpu.py, or the
C++ core behind ``NativeResidentCore``) owns all bookkeeping — write
offsets, ring rebase, window descriptors — so this executor is a replayable
launch queue, like the reference's per-worker ``cudaStream_t``
(win_seq_gpu.hpp:294).

Differences from the JAX executor, each on purpose:

* **In place.** The append writes into the ring tensor (JAX produced a new
  array per launch), so a checkpoint copies the ring in stream order
  (:class:`RingSnapshot`).
* **One stream per executor.** Every launch, copy and allocation runs on
  the executor's own ``torch.cuda.Stream`` inside its device context,
  whichever thread calls it (ship threads have their own current stream).
* **Exact sizes.** The rectangle keeps the ladder widths the host hands
  over (KP, Rb, C: the native core's geometry is bucketed), but windows
  are launched at their exact count ``B``: the kernels take runtime sizes.
* **Events.** A ``torch.cuda.Event`` per launch takes the place of
  ``copy_to_host_async``/``is_ready``; every pinned and device temporary of
  a launch stays referenced in ``_inflight`` until its event completed.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque

import numpy as np
import torch

from ..utils import profile
from .device import _bucket
from .ring import (long_windows, ring_append_eval, ring_append_multi_eval,
                   ring_append_regular_sum)

# -- wire diagnostics (always on: one lock round-trip per dispatch) ---------
# Every resident dispatch feeds these process-wide counters: dispatch count,
# merge count (launches fused by wf_launch_coalesce), and wall service time
# from dispatch to result-ready.

_STATS_MU = threading.Lock()
_STATS = {"dispatches": 0, "merges": 0, "svc_s_sum": 0.0, "svc_n": 0}


def stats_add(name: str, value=1):
    with _STATS_MU:
        _STATS[name] = _STATS.get(name, 0) + value


def stats_max(name: str, value):
    """High-water gauge (e.g. the deepest proactive flush multiple a run
    reached) — snapshot/reset like the counters."""
    with _STATS_MU:
        if value > _STATS.get(name, 0):
            _STATS[name] = value


def stats_snapshot(reset: bool = False) -> dict:
    """{"dispatches", "merges", "mean_launch_ms"} since the last reset."""
    with _STATS_MU:
        snap = dict(_STATS)
        if reset:
            for k in _STATS:
                _STATS[k] = 0
    n = snap.pop("svc_n")
    s = snap.pop("svc_s_sum")
    snap["mean_launch_ms"] = round(1e3 * s / n, 2) if n else 0.0
    return snap


_REDUCE_OPS = ("sum", "min", "max", "prod")

#: process-global wire-weather record: an EMA of raw per-dispatch launch
#: service in ms and the floor of the recent observations.  It outlives
#: executors, so the budget-aware core routing (win_seq_gpu.make_core_for)
#: and the opt-in proactive flush sizing (native_core.py) can read what
#: earlier runs of this process measured.
_WEATHER = {"ema_ms": None, "recent": deque(maxlen=16), "floor_ms": None}
_WEATHER_MU = threading.Lock()


def note_wire_service_ms(ms: float, weight: float = 0.2):
    """Fold one raw per-dispatch launch-service observation (ms) into the
    global wire-weather EMA and the recent-window floor.  Mutation and
    the floor recompute happen under one lock (harvests run on ship
    threads AND node threads concurrently); readers get atomic floats."""
    with _WEATHER_MU:
        prev = _WEATHER["ema_ms"]
        _WEATHER["ema_ms"] = ms if prev is None else (
            (1.0 - weight) * prev + weight * ms)
        _WEATHER["recent"].append(ms)
        _WEATHER["floor_ms"] = min(_WEATHER["recent"])


def wire_weather_ms():
    """Current wire-weather estimate (None before any observation)."""
    return _WEATHER["ema_ms"]


def wire_service_floor_ms():
    """Best per-launch service among the recent observations (None before
    any) — the feasibility statistic for budget-aware routing: a latency
    budget the device path cannot meet even at its recent best is
    unmeetable by construction."""
    return _WEATHER["floor_ms"]


#: ring accumulate dtypes the kernels take
_TORCH_ACC = {np.dtype(np.int32): torch.int32,
              np.dtype(np.float32): torch.float32}


class RingSnapshot:
    """Checkpoint handle over a resident ring archive (recovery layer,
    docs/ROBUSTNESS.md "Recovery").

    The append updates the ring in place, so holding the tensor is not a
    consistent copy (it was in JAX, whose arrays are functional).  Taking a
    snapshot therefore copies the ring on the executor's stream — in
    stream order, before any later append — into pinned host memory, with
    a non-blocking copy whose event :meth:`resolve` waits on (on the
    checkpoint writer thread), so the copy overlaps the ring's ongoing
    compute."""

    __slots__ = ("rings", "KP", "cap", "_event")

    def __init__(self, rings, KP: int, cap: int, event=None):
        self.rings = rings      # tuple of host tensors, or None (lazy ring)
        self.KP = KP
        self.cap = cap
        self._event = event

    def resolve(self) -> dict:
        """Materialise to host numpy (pickle-ready)."""
        if self._event is not None:
            self._event.synchronize()
        rings = (None if self.rings is None
                 else tuple(r.numpy() for r in self.rings))
        return {"rings": rings, "KP": self.KP, "cap": self.cap}


def _pad2(a, rows, cols):
    out = np.zeros((rows, cols), dtype=a.dtype)
    out[:a.shape[0], :a.shape[1]] = a
    return out


def _check_ring_overflow(offs, Rb, cap):
    """The append must stay inside its row (dynamic_update_slice clamped
    the start, which would overwrite live cells near the ring end; the
    kernel drops such writes) — the host core's rebase invariant must
    prevent ever getting here."""
    if len(offs) and int(offs.max()) + Rb > cap:
        raise ValueError(
            f"ring overflow: offset {int(offs.max())} + {Rb} > {cap}")


def launch_vec(KP: int, offs, B: int, cols) -> np.ndarray:
    """The int32 vector one launch copies to the card: the KP per-key ring
    offsets (rows >= len(offs) at 0), then each column of `cols` (B values
    each, None for zeros; int64 values wrap in the cast).  The windows'
    descriptors go as (row, start, len) columns in ring coordinates, never
    as a flat offset row * cap + start: a ring may hold 2**31 cells and
    more, as the JAX ring's 2-D gather allows."""
    vec = np.zeros(KP + len(cols) * B, dtype=np.int32)
    vec[:len(offs)] = offs
    for i, col in enumerate(cols):
        if col is not None and B:
            vec[KP + i * B:KP + (i + 1) * B] = np.asarray(col).astype(np.int32)
    return vec


def launch_cols(d_vec, at: int, B: int, n: int):
    """The n (B,) columns of the launch vector from position `at` on."""
    return tuple(d_vec[at + i * B:at + (i + 1) * B] for i in range(n))


@contextlib.contextmanager
def _on(device, stream):
    """`device` and `stream` as the current ones (nothing on the CPU):
    kernels launch, copies run and device tensors are allocated there."""
    if stream is None:
        yield
        return
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield


def _upload(host: np.ndarray, device, stream):
    """(device tensor, pinned staging tensor or None) for one array; call
    on `stream` (its copy is asynchronous)."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if stream is None:
        return t, None
    pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    pinned.copy_(t)
    return pinned.to(device, non_blocking=True), pinned


def _stage(arrays, device, stream):
    """One host-to-device copy for a launch: the host arrays laid out in
    one byte buffer, each in its own 16-byte-aligned segment (pinned when
    `stream` is a CUDA stream; call on it, the copy is asynchronous).
    Returns (device views of the arrays, in order and in their dtypes and
    shapes; the staging buffers, to keep alive until the launch ran)."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    at, size = [], 0
    for a in arrays:
        at.append(size)
        size += -(-a.nbytes // 16) * 16
    host = torch.empty(size, dtype=torch.uint8,
                       pin_memory=stream is not None)
    flat = host.numpy()
    for a, o in zip(arrays, at):
        flat[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = host if stream is None else host.to(device, non_blocking=True)
    views = [dev[o:o + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
             .view(a.shape) for a, o in zip(arrays, at)]
    return views, (host, dev)


def _download(outs, stream):
    """Start the copies of `outs` into pinned host tensors on `stream`;
    returns (host tensors, event) — event None on the CPU."""
    if stream is None:
        return tuple(outs), None
    hosts = []
    for o in outs:
        h = torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
        h.copy_(o, non_blocking=True)
        hosts.append(h)
    event = torch.cuda.Event()
    event.record(stream)
    return tuple(hosts), event


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the resident executor runs on the card; "
                "pass device='cpu' explicitly to run it on the host")
        return torch.device("cuda:0")
    return torch.device(device)


class ResidentWindowExecutor:
    """Launch queue over a device-resident ring archive.

    The caller fully specifies each dispatch (rectangle, offsets, window
    descriptors in ring coordinates); this class handles dtype narrowing
    and widening, the ring tensor's lifetime, and asynchronous result
    harvest.  ``op`` is one of sum/min/max/prod, or a tuple of them
    evaluated over the same ring in one dispatch ("count" needs no device
    work — the host core answers it from window lengths).  The ring
    accumulates in int32 or float32 (``acc_dtype``): the kernels have no
    64-bit form.  A CUDA ``device`` launches the hand-written kernels; a
    CPU device runs their plain versions, synchronously.
    """

    def __init__(self, op, device=None, depth: int = 8,
                 acc_dtype=np.int32):
        self.single = isinstance(op, str)
        self.ops = (op,) if self.single else tuple(op)
        for o in self.ops:
            if o not in _REDUCE_OPS:
                raise ValueError(f"unsupported resident op {o!r}")
        if not self.ops:
            raise ValueError("need at least one resident op")
        self.op = self.ops[0]
        self.acc_dtype = np.dtype(acc_dtype)
        if self.acc_dtype not in _TORCH_ACC:
            raise ValueError(f"the ring kernels accumulate in int32 or "
                             f"float32, got {self.acc_dtype}")
        self._acc = _TORCH_ACC[self.acc_dtype]
        self.device = _resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.depth = depth
        self.cap = 0          # ring columns (set on first reset)
        self.KP = 0           # ring rows (padded key count)
        self._ring = None
        #: (meta, sel, host outputs, event, keepalive, t_dispatch)
        self._inflight = deque()
        self._ready = []
        self._svc = deque(maxlen=32)   # recent dispatch→ready seconds
        self._svc_mean = 0.0

    def _on_stream(self):
        """The executor's device and stream as the current ones: kernels
        launch, copies run and device tensors are allocated on them."""
        return _on(self.device, self._stream)

    # ------------------------------------------------------------ lifecycle

    def reset(self, n_keys: int, cap: int):
        """(Re)allocate an empty ring of at least (n_keys, cap); contents
        are repopulated by the next launch's rectangle (host rebase)."""
        self.KP = _bucket(max(n_keys, 1))
        self.cap = _bucket(max(cap, 16))
        self._ring = None  # lazily zeros on next launch

    def _ring_arr(self):
        if self._ring is None:
            self._ring = torch.zeros((self.KP, self.cap), dtype=self._acc,
                                     device=self.device)
        return self._ring

    # ---------------------------------------------------- checkpoint/restore

    # the ring accessors the checkpoint methods below share with the
    # per-field executor, which overrides them

    def _rings_tuple(self):
        """Current ring tensor(s) as a tuple, or None if lazily unbuilt."""
        return None if self._ring is None else (self._ring,)

    def _rings_assign(self, rings):
        self._ring = None if rings is None else rings[0]

    def _ring_dtypes(self):
        """Accumulate dtype of each ring, in _rings_tuple order."""
        return (self.acc_dtype,)

    def ring_snapshot(self) -> RingSnapshot:
        """Consistent copy of the ring(s) (the caller must have drained the
        in-flight launches first — their appends are already in the ring,
        but their undelivered results would be lost)."""
        if self._inflight:
            raise RuntimeError("ring_snapshot with launches in flight; "
                               "drain() first")
        rings = self._rings_tuple()
        if rings is None:
            return RingSnapshot(None, self.KP, self.cap)
        if self._stream is None:
            return RingSnapshot(tuple(r.clone() for r in rings), self.KP,
                                self.cap)
        with self._on_stream():
            hosts = []
            for r in rings:
                host = torch.empty(r.shape, dtype=r.dtype, pin_memory=True)
                host.copy_(r, non_blocking=True)
                hosts.append(host)
            event = torch.cuda.Event()
            event.record(self._stream)
        return RingSnapshot(tuple(hosts), self.KP, self.cap, event)

    def ring_restore(self, snap):
        """Reinstate a snapshot (RingSnapshot or its resolved dict) and
        clear the launch queue.  The rings are copied in: later appends
        never write into the snapshot's arrays."""
        data = snap.resolve() if isinstance(snap, RingSnapshot) else snap
        self._inflight.clear()
        self._ready = []
        self.KP = int(data["KP"])
        self.cap = int(data["cap"])
        rings = data["rings"]
        if rings is None:
            self._rings_assign(None)
            return
        rings = tuple(np.asarray(r) for r in rings)
        want = self._ring_dtypes()
        if len(rings) != len(want) or any(
                r.dtype != dt or r.shape != (self.KP, self.cap)
                for r, dt in zip(rings, want)):
            raise ValueError(
                f"snapshot rings are {[(r.dtype, r.shape) for r in rings]}, "
                f"the executor expects {list(want)} x ({self.KP}, "
                f"{self.cap})")
        with self._on_stream():
            self._rings_assign(tuple(torch.tensor(r, device=self.device)
                                     for r in rings))

    def invalidate(self):
        """Drop the ring(s) and launch queue entirely: the owning core's
        next flush rebases, rebuilding the ring from host-live archive rows
        (the no-ring-snapshot restore path)."""
        self._inflight.clear()
        self._ready = []
        self._rings_assign(None)
        self.KP = 0
        self.cap = 0

    # ------------------------------------------------------------- dispatch

    def narrow(self, vals: np.ndarray) -> np.dtype:
        """Narrowest wire dtype holding `vals` exactly: ints narrow to
        int8/int16/int32, floats ship as float32."""
        if vals.dtype.kind == "f":
            return np.dtype(np.float32)
        if not len(vals):
            return np.dtype(np.int8)
        lo, hi = int(vals.min()), int(vals.max())
        for dt in (np.int8, np.int16, np.int32):
            info = np.iinfo(dt)
            if info.min <= lo and hi <= info.max:
                return np.dtype(dt)
        return np.dtype(np.int32)  # wraps; the core warned at
        # construction when the result dtype exceeds the accumulate dtype

    def _to_device(self, host: np.ndarray):
        """(device tensor, pinned staging tensor or None) for one array;
        call on the executor's stream."""
        return _upload(host, self.device, self._stream)

    def _fetch(self, outs):
        """Start the copies of `outs` into pinned host tensors; returns
        (host tensors, event) — event None on the CPU."""
        return _download(outs, self._stream)

    def _stage_block(self, blk: np.ndarray, Rb: int) -> np.ndarray:
        """The (KP, Rb) rectangle as the kernel writes it: rows >= K and
        columns >= R zero, like the JAX executor's padding."""
        return (blk if blk.shape == (self.KP, Rb)
                else _pad2(blk, self.KP, Rb))

    def launch(self, meta, blk: np.ndarray, offs: np.ndarray,
               wrows: np.ndarray, wstarts: np.ndarray, wlens: np.ndarray):
        """One append + evaluation dispatch.

        blk: (K, R) new rows per dense key (narrow dtype, zero-padded);
        offs: (K,) per-key ring write offsets; wrows/wstarts/wlens: (B,)
        fired-window descriptors in ring coordinates.  `meta` is returned
        with the results at harvest.  Caller guarantees offs + R <= cap and
        wstarts + wlens <= cap."""
        K, R = blk.shape
        if K > self.KP:
            raise ValueError("rectangle exceeds ring rows; reset() first")
        B = len(wstarts)
        Rb = _bucket(max(R, 1))
        _check_ring_overflow(offs, Rb, self.cap)
        pad = _bucket(int(wlens.max()) if B else 1)
        KP = self.KP
        with profile.span("device_put"):
            blkp = self._stage_block(blk, Rb)
            long = long_windows(wrows, wstarts, wlens, pad, self.cap)
            vec = np.concatenate([launch_vec(KP, offs, B,
                                             (wrows, wstarts, wlens)),
                                  long.vec])
            with self._on_stream():
                d_blk, p_blk = self._to_device(blkp)
                d_vec, p_vec = self._to_device(vec)
        profile.add("bytes_shipped", blk.nbytes)
        profile.add("rows_shipped", blk.size)
        profile.add("windows", B)
        with profile.span("dispatch"), self._on_stream():
            outs = tuple(ring_append_eval(
                self._ring_arr(), d_blk, d_vec[:KP], self.ops,
                *launch_cols(d_vec, KP, B, 3), pad,
                long=long.on(d_vec[KP + 3 * B:])))
            hosts, event = self._fetch(outs)
        stats_add("dispatches")
        self._inflight.append((meta, B, hosts, event,
                               (p_blk, p_vec, d_blk, d_vec, outs),
                               time.perf_counter()))
        while len(self._inflight) > self.depth:
            self._harvest_one()

    def launch_regular(self, meta, blk: np.ndarray, offs: np.ndarray,
                       rcount: np.ndarray, rstart0: np.ndarray,
                       rlen: np.ndarray, slide: int, wrows: np.ndarray,
                       widx: np.ndarray, cmax: int = 0):
        """Append + evaluation with *regular* window descriptors: per ring
        row, windows i in [0, rcount[r]) start at rstart0[r] + i*slide with
        length rlen[r] — only per-key scalars cross the copy instead of 3
        arrays of B int32 (sum only; the (KP, C) result is mapped back to
        pending-window order via (wrows, widx) at harvest)."""
        if not (self.single and self.op == "sum"):
            raise ValueError("regular descriptors implemented for "
                             "single-stat sum")
        K, R = blk.shape
        if K > self.KP:
            raise ValueError("rectangle exceeds ring rows; reset() first")
        Rb = _bucket(max(R, 1))
        C = _bucket(int(cmax) if cmax else
                    (int(rcount.max()) if len(rcount) else 1))
        _check_ring_overflow(offs, Rb, self.cap)
        KP = self.KP
        with profile.span("device_put"):
            blkp = self._stage_block(blk, Rb)
            # rows >= K get offset 0, start 0 and length 0, as the JAX
            # executor's zero padding gives them
            vec = np.zeros(3 * KP, dtype=np.int32)
            vec[:len(offs)] = offs
            vec[KP:KP + len(rstart0)] = rstart0
            vec[2 * KP:2 * KP + len(rlen)] = rlen
            with self._on_stream():
                d_blk, p_blk = self._to_device(blkp)
                d_vec, p_vec = self._to_device(vec)
        profile.add("bytes_shipped", blk.nbytes)
        profile.add("rows_shipped", blk.size)
        profile.add("windows", len(wrows))
        with profile.span("dispatch"), self._on_stream():
            out = ring_append_regular_sum(self._ring_arr(), d_blk,
                                          d_vec[:KP], d_vec[KP:2 * KP],
                                          d_vec[2 * KP:], C, int(slide))
            hosts, event = self._fetch((out,))
        stats_add("dispatches")
        self._inflight.append((meta, (np.asarray(wrows), np.asarray(widx)),
                               hosts, event,
                               (p_blk, p_vec, d_blk, d_vec, out),
                               time.perf_counter()))
        while len(self._inflight) > self.depth:
            self._harvest_one()

    # -------------------------------------------------------------- harvest

    def _note_service(self, t0: float):
        dt = time.perf_counter() - t0
        self._svc.append(dt)
        # fold the window mean here, on the harvesting thread: readers on
        # OTHER threads (the proactive flush sizer runs on the node
        # thread) then see one atomic float instead of iterating a deque
        # that a ship thread is appending to
        self._svc_mean = sum(self._svc) / len(self._svc)
        stats_add("svc_s_sum", dt)
        stats_add("svc_n", 1)
        # always-on wire weather: the budget-aware core routing reads it
        # at construction time
        note_wire_service_ms(1e3 * dt)

    def mean_service_s(self) -> float:
        """Mean dispatch→ready wall time of recent launches (slightly
        overestimates when results sit ready before the next harvest
        poll).  Safe to read from any thread."""
        return self._svc_mean

    def _harvest_one(self):
        meta, sel, hosts, event, _keep, t0 = self._inflight.popleft()
        with profile.span("harvest_wait"):
            if event is not None:
                event.synchronize()
        self._note_service(t0)
        arrs = [h.numpy() for h in hosts]
        if isinstance(sel, tuple):   # regular: index map -> flat (B,)
            arrs = [a[sel[0], sel[1]] for a in arrs]
        else:
            arrs = [a[:sel] for a in arrs]
        self._ready.append((meta, arrs[0] if len(arrs) == 1
                            else tuple(arrs)))

    @staticmethod
    def _is_ready(entry) -> bool:
        event = entry[3]
        return event is None or event.query()

    def poll(self):
        """Harvest completed launches without blocking on the rest."""
        while self._inflight and self._is_ready(self._inflight[0]):
            self._harvest_one()
        ready, self._ready = self._ready, []
        return ready

    def unready_count(self) -> int:
        """Dispatches still being serviced by the card (the ship
        throttle's saturation signal)."""
        return sum(1 for entry in self._inflight
                   if not self._is_ready(entry))

    def drain(self):
        """Block until every in-flight launch is harvested (each launch
        started its result copies when it was dispatched)."""
        while self._inflight:
            self._harvest_one()
        ready, self._ready = self._ready, []
        return ready


class MultiFieldResidentExecutor(ResidentWindowExecutor):
    """Resident launch queue with one ring PER FIELD — the port of the JAX
    package's ``MultiFieldResidentExecutor`` and of its jitted step
    ``_make_multi_step`` (windflow_tpu/ops/resident.py:599-781).

    ``stats``: a tuple of ``(op, field)`` evaluations (sum/min/max/prod);
    ``fn``: an optional ``TorchWindowFunction`` whose ``fn(keys, gwids,
    cols, mask)`` runs over ``(B, pad)`` tiles of its fields;
    ``acc_dtypes`` maps every field to its ring dtype, int32 or float32
    (the ring kernels have no other).  A dispatch stages every field's
    rectangle and its launch vector in one copy and makes one
    ``ring_append_multi_eval`` launch (a further one for every 8 fields
    past the first 8 and every 8 stats past a group's first 8): every
    field's append, every stat
    and the function's tiles, as JAX's step is one jitted program; then
    the function runs on the tiles.  Its outputs are the stats' in
    ``stats`` order, then the function's."""

    def __init__(self, fields, stats=(), fn=None, acc_dtypes=None,
                 device=None, depth: int = 8):
        self.fields = tuple(fields)
        if not self.fields:
            raise ValueError("need at least one ring field")
        self.stats = tuple(stats)
        self.fn = fn
        for op, f in self.stats:
            if op not in _REDUCE_OPS:
                raise ValueError(f"unsupported resident op {op!r}")
            if f not in self.fields:
                raise ValueError(f"stat field {f!r} not in ring fields")
        if fn is not None:
            for f in fn.fields:
                if f not in self.fields:
                    raise ValueError(f"fn field {f!r} not in ring fields")
        if not self.stats and fn is None:
            raise ValueError("nothing to evaluate")
        self.acc_dtypes = {f: np.dtype(acc_dtypes[f]) for f in self.fields}
        for f, dt in self.acc_dtypes.items():
            if dt not in _TORCH_ACC:
                raise ValueError(
                    f"ring dtype {dt} for field {f!r}: the ring kernels "
                    "accumulate in int32 or float32 only (no 64-bit ring)")
        self.device = _resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.depth = depth
        self.cap = 0
        self.KP = 0
        self._rings = None
        self._inflight = deque()
        self._ready = []
        self._svc = deque(maxlen=32)
        self._svc_mean = 0.0

    # the base class's regular-descriptor launch does not apply
    single = False

    def reset(self, n_keys: int, cap: int):
        self.KP = _bucket(max(n_keys, 1))
        self.cap = _bucket(max(cap, 16))
        self._rings = None

    def _rings_arr(self):
        if self._rings is None:
            self._rings = tuple(
                torch.zeros((self.KP, self.cap),
                            dtype=_TORCH_ACC[self.acc_dtypes[f]],
                            device=self.device)
                for f in self.fields)
        return self._rings

    def _rings_tuple(self):
        return self._rings

    def _rings_assign(self, rings):
        self._rings = rings

    def _ring_dtypes(self):
        return tuple(self.acc_dtypes[f] for f in self.fields)

    def narrow_for(self, field, vals: np.ndarray) -> np.dtype:
        """Per-field wire narrowing (the base class's ladder, bounded by
        that field's ring dtype).  A float column headed into an integer
        ring raises instead of truncating."""
        acc = self.acc_dtypes[field]
        if len(vals) and vals.dtype.kind == "f" and acc.kind != "f":
            raise ValueError(
                f"float column {field!r} headed into a {acc} ring would "
                "silently truncate — declare a float ring dtype "
                f"(TorchWindowFunction(field_dtypes={{{field!r}: "
                "np.float32}}))")
        if acc.kind == "f":
            return np.dtype(np.float32)
        return self.narrow(vals)

    def launch(self, meta, blks: dict, offs: np.ndarray,
               wrows: np.ndarray, wstarts: np.ndarray, wlens: np.ndarray,
               wkeys: np.ndarray = None, wgwids: np.ndarray = None):
        """One dispatch: per-field rectangles `blks[f]` (K, R) append at
        `offs`, then every stat and the window function evaluate the
        described windows.  `wkeys`/`wgwids` (int64, one per window) are
        what the function reads (zeros when not given)."""
        K, R = next(iter(blks.values())).shape
        if K > self.KP:
            raise ValueError("rectangle exceeds ring rows; reset() first")
        B = len(wstarts)
        Rb = _bucket(max(R, 1))
        _check_ring_overflow(offs, Rb, self.cap)
        pad = _bucket(int(wlens.max()) if B else 1)
        KP = self.KP
        with profile.span("device_put"):
            blkps = [self._stage_block(blks[f], Rb) for f in self.fields]
            with self._on_stream():
                d_blks, d_vec, long, keep = self._stage_step(
                    blkps, KP, offs, B, wrows, wstarts, wlens, wkeys,
                    wgwids, pad, self.device, self._stream)
        for f in self.fields:
            profile.add("bytes_shipped", blks[f].nbytes)
            profile.add("rows_shipped", blks[f].size)
        profile.add("windows", B)
        with profile.span("dispatch"), self._on_stream():
            outs, tiles, mask = self._step(self._rings_arr(), d_blks, d_vec,
                                           KP, B, pad, long)
            hosts, event = self._fetch(outs)
        stats_add("dispatches")
        self._inflight.append((meta, B, hosts, event,
                               (keep, tiles, mask, outs),
                               time.perf_counter()))
        while len(self._inflight) > self.depth:
            self._harvest_one()

    def _stage_step(self, blkps, KP, offs, B, wrows, wstarts, wlens, wkeys,
                    wgwids, pad, device, stream):
        """Stages one dispatch of KP ring rows (a shard's, on a mesh) in
        one copy (_stage; call on `stream`, where the launch that reads
        it runs): every field's (KP, Rb) rectangle, then the
        launch vector: the offsets, the windows' (row, start, len)
        columns, with a function its keys and gwids (int32: they wrap as
        the JAX package's int32 cast does), and with stats the long
        windows' list.  Returns (device rectangles, device launch vector,
        long-window list or None, staging buffers)."""
        cols = (wrows, wstarts, wlens)
        if self.fn is not None:
            cols += (wkeys, wgwids)
        long = (long_windows(wrows, wstarts, wlens, pad, self.cap)
                if self.stats and B else None)
        vec = launch_vec(KP, offs, B, cols)
        if long is not None:
            vec = np.concatenate([vec, long.vec])
        views, keep = _stage([*blkps, vec], device, stream)
        d_vec = views[-1]
        if long is not None:
            long = long.on(d_vec[KP + len(cols) * B:])
        return views[:-1], d_vec, long, keep

    def _step(self, rings, d_blks, d_vec, KP, B, pad, long, call_fn=True):
        """The fused launch over `rings` (one a field) and, with
        `call_fn`, the window function on its tiles: returns (outputs,
        tiles, mask), the stats' outputs then the function's."""
        fn, fidx = self.fn, {f: i for i, f in enumerate(self.fields)}
        rows, starts, lens = launch_cols(d_vec, KP, B, 3)
        outs, tiles, mask = ring_append_multi_eval(
            rings, d_blks, d_vec[:KP],
            [(fidx[f], op) for op, f in self.stats], rows, starts, lens,
            pad, tile_fields=([fidx[f] for f in fn.fields]
                              if fn is not None else ()), long=long)
        outs = list(outs)
        if fn is not None and call_fn:
            d_keys, d_gwids = launch_cols(d_vec, KP + 3 * B, B, 2)
            res = fn.fn(d_keys, d_gwids, dict(zip(fn.fields, tiles)), mask)
            outs.extend(res if isinstance(res, tuple) else (res,))
        return outs, tiles, mask


class _EventGroup:
    """The per-shard copy events of a mesh snapshot, waited on together."""

    __slots__ = ("events",)

    def __init__(self, events):
        self.events = [e for e in events if e is not None]

    def synchronize(self):
        for e in self.events:
            e.synchronize()


class _MeshShards:
    """Per-shard rings, streams and harvest of the mesh executors — the
    port of ``MeshResidentExecutor`` / ``MeshMultiFieldResidentExecutor``
    (windflow_tpu/ops/resident.py:831-1111), where one ``shard_map`` step
    served every key group.

    * **Layout** (JAX's): dense ring row ``r`` lives on shard ``r % S`` at
      local row ``r // S``; ``KP = S * bucket(ceil(K / S))`` and every
      shard holds ``rps = KP // S`` rows.  The global physical row of
      ``(shard s, local l)`` is ``s * rps + l``: the layout of
      ``np.asarray`` of the JAX package's sharded ring, which the
      snapshots use, so a JAX mesh snapshot carries across unchanged.
    * **Placement.** Shard ``s`` keeps its ``(rps, cap)`` ring(s) on the
      mesh device at index ``s`` of the sharded axis (0 on the other
      axes), in one copy: JAX replicated the rings over the other axes
      (``P(kf, None)``).
    * **Streams.** Each shard launches on its own CUDA stream; a launch
      runs on every shard (the appends, then the shard's own windows,
      none where it has none) and is harvested once every shard's event
      completed, its ``(shard, slot)`` results put back in window order.
    """

    def _init_mesh(self, mesh, axis):
        self.mesh = mesh
        self.axis = axis
        S = self.n_shards = int(mesh.shape[axis])
        at = list(mesh.shape).index(axis)
        self.shard_devices = [
            torch.device(mesh.devices[tuple(s if i == at else 0
                                            for i in range(
                                                mesh.devices.ndim))])
            for s in range(S)]
        self._streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                         for d in self.shard_devices]
        self._shards = None     # per shard: a tuple of rings, field order

    # ------------------------------------------------------------ geometry

    def reset(self, n_keys: int, cap: int):
        S = self.n_shards
        self.KP = S * _bucket(max(-(-max(n_keys, 1) // S), 1))
        self.cap = _bucket(max(cap, 16))
        self._shards = None

    @property
    def rps(self) -> int:
        """Ring rows a shard holds."""
        return self.KP // self.n_shards

    def _on_shard(self, s):
        return _on(self.shard_devices[s], self._streams[s])

    def _shard_rings(self):
        """Per shard, its rings (one a field), allocated as zeros on first
        use."""
        if self._shards is None:
            dts = [_TORCH_ACC[d] for d in self._ring_dtypes()]
            shards = []
            for s, dev in enumerate(self.shard_devices):
                with self._on_shard(s):
                    shards.append(tuple(
                        torch.zeros((self.rps, self.cap), dtype=dt,
                                    device=dev) for dt in dts))
            self._shards = shards
        return self._shards

    def _rings_assign(self, rings):
        """Drop the rings (invalidate(); ring_restore() splits a global
        snapshot over the shards itself)."""
        self._shards = None

    def _shard_rows(self, a: np.ndarray, s: int, width=None):
        """The rows of dense (K, ...) array `a` that shard `s` holds (rows
        r = s, s + S, ...), zero-padded to rps rows (and `width`
        columns)."""
        part = a[s::self.n_shards]
        if a.ndim == 1:
            out = np.zeros(self.rps, dtype=a.dtype)
            out[:len(part)] = part
            return out
        return _pad2(part, self.rps, width)

    def _window_shards(self, wrows):
        """(shard of every window, its local row, and per shard the mask of
        its windows, in window order)."""
        wrows = np.asarray(wrows, dtype=np.int64)
        shard = wrows % self.n_shards
        return shard, wrows // self.n_shards, [shard == s for s in
                                               range(self.n_shards)]

    # --------------------------------------------------- checkpoint/restore

    def ring_snapshot(self) -> RingSnapshot:
        """Consistent copy of every field's ring in the global (KP, cap)
        physical layout (shard s's rows at s * rps ...); drain() first."""
        if self._inflight:
            raise RuntimeError("ring_snapshot with launches in flight; "
                               "drain() first")
        if self._shards is None:
            return RingSnapshot(None, self.KP, self.cap)
        rps, events = self.rps, []
        n_f = len(self._ring_dtypes())
        on_card = any(st is not None for st in self._streams)
        hosts = [torch.empty((self.KP, self.cap),
                             dtype=_TORCH_ACC[d], pin_memory=on_card)
                 for d in self._ring_dtypes()]
        for s, rings in enumerate(self._shards):
            with self._on_shard(s):
                for f in range(n_f):
                    hosts[f][s * rps:(s + 1) * rps].copy_(
                        rings[f], non_blocking=self._streams[s] is not None)
                if self._streams[s] is not None:
                    event = torch.cuda.Event()
                    event.record(self._streams[s])
                    events.append(event)
        return RingSnapshot(tuple(hosts), self.KP, self.cap,
                            _EventGroup(events) if events else None)

    def ring_restore(self, snap):
        """Reinstate a snapshot in the global (KP, cap) layout (a port mesh
        snapshot, or a JAX mesh one through interop.py): row block s goes
        to shard s.  Clears the launch queue."""
        data = snap.resolve() if isinstance(snap, RingSnapshot) else snap
        self._inflight.clear()
        self._ready = []
        KP, cap = int(data["KP"]), int(data["cap"])
        if KP % self.n_shards:
            raise ValueError(f"snapshot of {KP} ring rows does not split "
                             f"over {self.n_shards} shards")
        self.KP, self.cap = KP, cap
        rings = data["rings"]
        if rings is None:
            self._shards = None
            return
        rings = tuple(np.asarray(r) for r in rings)
        want = self._ring_dtypes()
        if len(rings) != len(want) or any(
                r.dtype != dt or r.shape != (KP, cap)
                for r, dt in zip(rings, want)):
            raise ValueError(
                f"snapshot rings are {[(r.dtype, r.shape) for r in rings]}, "
                f"the executor expects {list(want)} x ({KP}, {cap})")
        rps, shards = self.rps, []
        for s, dev in enumerate(self.shard_devices):
            with self._on_shard(s):
                shards.append(tuple(
                    torch.tensor(r[s * rps:(s + 1) * rps], device=dev)
                    for r in rings))
        self._shards = shards

    # -------------------------------------------------------------- harvest

    @staticmethod
    def _is_ready(entry) -> bool:
        return all(e is None or e.query() for e in entry[3])

    def _harvest_one(self):
        meta, sel, hosts, events, _keep, t0 = self._inflight.popleft()
        with profile.span("harvest_wait"):
            for e in events:
                if e is not None:
                    e.synchronize()
        self._note_service(t0)
        if sel[0] == "regular":
            # (shard, local row, window index) of each window
            _tag, shard, local, widx = sel
            B = len(shard)
            res = np.empty(B, dtype=self.acc_dtype)
            for s, h in enumerate(hosts):
                m = shard == s
                if m.any():
                    res[m] = h[0].numpy()[local[m], widx[m]]
            arrs = [res]
        else:
            _tag, masks, B = sel
            # a shard without windows launched no evaluation: with no
            # window at all (B = 0) the outputs are empty
            arrs = [np.zeros(0, dtype=dt) for dt in self._out_dtypes()]
            for s, h in enumerate(hosts):
                for i, o in enumerate(h):
                    a = o.numpy()
                    if i == len(arrs):
                        arrs.append(np.empty(B, dtype=a.dtype))
                    elif len(arrs[i]) != B:
                        arrs[i] = np.empty(B, dtype=a.dtype)
                    arrs[i][masks[s]] = a
        self._ready.append((meta, arrs[0] if len(arrs) == 1
                            else tuple(arrs)))


class MeshResidentExecutor(_MeshShards, ResidentWindowExecutor):
    """Resident ring sharded over a device mesh's key-group axis: dense-key
    ring rows are strided over the axis's shards, each shard appending to
    and evaluating windows over its own ``(rps, cap)`` ring with the
    single-device kernels — ``launch`` (M1: one ``ring_append_eval`` a
    shard, of ``_make_mesh_step``) and
    ``launch_regular`` (M2: one ``ring_append_regular_sum`` a shard, of
    ``_make_mesh_regular_step``).  The kf axis exchanges nothing, as in
    JAX; the harvest reads every shard's results back in window order."""

    def __init__(self, op: str, mesh, axis: str = "kf", depth: int = 8,
                 acc_dtype=np.int32):
        if axis not in mesh.shape:
            raise ValueError(f"mesh has no axis {axis!r}: {mesh.shape}")
        super().__init__(op, device=mesh.devices.flat[0], depth=depth,
                         acc_dtype=acc_dtype)
        self._init_mesh(mesh, axis)

    def _out_dtypes(self):
        return [self.acc_dtype] * len(self.ops)

    def launch(self, meta, blk: np.ndarray, offs: np.ndarray,
               wrows: np.ndarray, wstarts: np.ndarray, wlens: np.ndarray):
        S = self.n_shards
        K, R = blk.shape
        if K > self.KP:
            raise ValueError("rectangle exceeds ring rows; reset() first")
        B = len(wstarts)
        shard, local, masks = self._window_shards(wrows)
        Rb = _bucket(max(R, 1))
        _check_ring_overflow(offs, Rb, self.cap)
        pad = _bucket(int(wlens.max()) if B else 1)
        rps = self.rps
        hosts, events, keep = [], [], []
        rings = self._shard_rings()
        with profile.span("dispatch"):
            for s in range(S):
                m = masks[s]
                c = int(m.sum())
                cols = (local[m], wstarts[m], wlens[m])
                long = long_windows(*cols, pad, self.cap)
                vec = np.concatenate([launch_vec(
                    rps, self._shard_rows(offs, s), c, cols), long.vec])
                with self._on_shard(s):
                    d_blk, p_blk = _upload(self._shard_rows(blk, s, Rb),
                                           self.shard_devices[s],
                                           self._streams[s])
                    d_vec, p_vec = _upload(vec, self.shard_devices[s],
                                           self._streams[s])
                    outs = tuple(ring_append_eval(
                        rings[s][0], d_blk, d_vec[:rps], self.ops,
                        *launch_cols(d_vec, rps, c, 3), pad,
                        long=long.on(d_vec[rps + 3 * c:])))
                    # a shard without windows evaluates none
                    h, e = _download(outs if c else (), self._streams[s])
                hosts.append(h)
                events.append(e)
                keep.append((p_blk, p_vec, d_blk, d_vec, outs))
        profile.add("bytes_shipped", blk.nbytes)
        profile.add("rows_shipped", blk.size)
        profile.add("windows", B)
        stats_add("dispatches")
        self._inflight.append((meta, ("irregular", masks, B), hosts, events,
                               keep, time.perf_counter()))
        while len(self._inflight) > self.depth:
            self._harvest_one()

    def launch_regular(self, meta, blk: np.ndarray, offs: np.ndarray,
                       rcount: np.ndarray, rstart0: np.ndarray,
                       rlen: np.ndarray, slide: int, wrows: np.ndarray,
                       widx: np.ndarray, cmax: int = 0):
        """Regular-descriptor dispatch on the sharded ring: the per-key
        (count, start0, len) scalars go with their rows, and every shard
        sums its own rows' windows in one fused launch."""
        if not (self.single and self.op == "sum"):
            raise ValueError("regular descriptors implemented for "
                             "single-stat sum")
        S = self.n_shards
        K, R = blk.shape
        if K > self.KP:
            raise ValueError("rectangle exceeds ring rows; reset() first")
        Rb = _bucket(max(R, 1))
        C = _bucket(int(cmax) if cmax else
                    (int(rcount.max()) if len(rcount) else 1))
        _check_ring_overflow(offs, Rb, self.cap)
        rps = self.rps
        hosts, events, keep = [], [], []
        rings = self._shard_rings()
        with profile.span("dispatch"):
            for s in range(S):
                # rows without a key get offset 0, start 0 and length 0
                vec = np.concatenate([self._shard_rows(np.asarray(a[:K]), s)
                                      for a in (offs, rstart0, rlen)])
                with self._on_shard(s):
                    d_blk, p_blk = _upload(
                        self._shard_rows(blk, s, Rb),
                        self.shard_devices[s], self._streams[s])
                    d_vec, p_vec = _upload(vec.astype(np.int32),
                                           self.shard_devices[s],
                                           self._streams[s])
                    out = ring_append_regular_sum(
                        rings[s][0], d_blk, d_vec[:rps], d_vec[rps:2 * rps],
                        d_vec[2 * rps:], C, int(slide))
                    h, e = _download((out,), self._streams[s])
                hosts.append(h)
                events.append(e)
                keep.append((p_blk, p_vec, d_blk, d_vec, out))
        profile.add("bytes_shipped", blk.nbytes)
        profile.add("rows_shipped", blk.size)
        profile.add("windows", len(wrows))
        stats_add("dispatches")
        shard, local, _m = self._window_shards(wrows)
        self._inflight.append((meta, ("regular", shard, local,
                                      np.asarray(widx, dtype=np.int64)),
                               hosts, events, keep, time.perf_counter()))
        while len(self._inflight) > self.depth:
            self._harvest_one()


class MeshMultiFieldResidentExecutor(_MeshShards, MultiFieldResidentExecutor):
    """Per-field resident rings sharded over a device mesh's key-group
    axis (M3, the port of ``_make_mesh_multi_step``): on every shard, one
    staging copy and one ``ring_append_multi_eval`` launch on the shard's
    stream (every field's append, every stat over the shard's windows,
    the tiles of a ``TorchWindowFunction``'s fields), then the function
    over the shard's own window keys and gwids."""

    def __init__(self, fields, stats=(), fn=None, acc_dtypes=None,
                 mesh=None, axis: str = "kf", depth: int = 8):
        if mesh is None or axis not in mesh.shape:
            raise ValueError(f"need a mesh with axis {axis!r}")
        super().__init__(fields, stats=stats, fn=fn, acc_dtypes=acc_dtypes,
                         device=mesh.devices.flat[0], depth=depth)
        self._init_mesh(mesh, axis)

    def _out_dtypes(self):
        dts = [self.acc_dtypes[f] for _op, f in self.stats]
        if self.fn is not None:
            dts += [np.dtype(d) for d in self.fn.result_fields.values()]
        return dts

    def launch(self, meta, blks: dict, offs: np.ndarray,
               wrows: np.ndarray, wstarts: np.ndarray, wlens: np.ndarray,
               wkeys: np.ndarray = None, wgwids: np.ndarray = None):
        S = self.n_shards
        K, R = next(iter(blks.values())).shape
        if K > self.KP:
            raise ValueError("rectangle exceeds ring rows; reset() first")
        B = len(wstarts)
        shard, local, masks = self._window_shards(wrows)
        Rb = _bucket(max(R, 1))
        _check_ring_overflow(offs, Rb, self.cap)
        pad = _bucket(int(wlens.max()) if B else 1)
        rps = self.rps
        hosts, events, keep = [], [], []
        rings = self._shard_rings()
        with profile.span("dispatch"):
            for s in range(S):
                m = masks[s]
                c = int(m.sum())
                # the caller sends no header columns when no fn is bound
                hdr = tuple(None if a is None or len(a) != B else a[m]
                            for a in (wkeys, wgwids))
                with self._on_shard(s):
                    d_blks, d_vec, long, staged = self._stage_step(
                        [self._shard_rows(blks[f], s, Rb)
                         for f in self.fields], rps,
                        self._shard_rows(offs, s), c, local[m], wstarts[m],
                        wlens[m], *hdr, pad, self.shard_devices[s],
                        self._streams[s])
                    # one fused launch a shard: the append, and the
                    # shard's windows where it has some (the function
                    # runs only there)
                    outs, tiles, mask = self._step(rings[s], d_blks, d_vec,
                                                   rps, c, pad, long,
                                                   call_fn=bool(c))
                    h, e = _download(outs if c else (), self._streams[s])
                hosts.append(h)
                events.append(e)
                keep.append((staged, tiles, mask, outs))
        for f in self.fields:
            profile.add("bytes_shipped", blks[f].nbytes)
            profile.add("rows_shipped", blks[f].size)
        profile.add("windows", B)
        stats_add("dispatches")
        self._inflight.append((meta, ("irregular", masks, B), hosts, events,
                               keep, time.perf_counter()))
        while len(self._inflight) > self.depth:
            self._harvest_one()


def prewarm_regular_ladder(mults=(2, 4, 8, 16), devices=None,
                           max_cells=1 << 24) -> int:
    """Kept as API of the JAX package, where it compiled the coalesced-shape
    siblings of every jitted step.  The port's kernels take runtime sizes
    and compile nothing per shape, so there is nothing to warm: returns 0."""
    return 0
