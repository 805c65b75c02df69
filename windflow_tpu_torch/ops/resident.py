"""Device-resident window archives on a CUDA card — the port of
``windflow_tpu/ops/resident.py`` (the single-ring executor and the
per-field one).

Each stream row crosses the host-to-device copy once and window evaluation
reads device memory:

* a per-key **ring archive** stays on the card: a ``(KP, cap)`` tensor
  whose row ``r`` holds the live tuples of dense key ``r`` in arrival order
  (the device twin of ``core/archive.py``'s ``KeyArchive``);
* each launch appends the new rows as ONE rectangle in the narrowest wire
  dtype that holds them (int8/int16/int32/float32), widened to the
  accumulate dtype on the card by the ``ring_append`` kernel;
* the fired windows are then evaluated over the ring: regular windows by
  the ``regular_window_sum`` kernel, windows given by explicit descriptors
  by the windowed-reduce kernel on the ring's flat view, once per op;
* with several fields (:class:`MultiFieldResidentExecutor`) each field has
  a ring of its own, each ``(op, field)`` stat reads its field's ring, and
  a bound user window function reads masked ``(B, pad)`` tiles of its
  fields that the ``window_gather`` kernel cuts from the rings;
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
from .gather import window_gather
from .ring import regular_window_sum, ring_append
from .windowed_reduce import windowed_reduce

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

    @contextlib.contextmanager
    def _on_stream(self):
        """The executor's device and stream as the current ones: kernels
        launch, copies run and device tensors are allocated on them."""
        if self._stream is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            yield

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
            return outs, None
        hosts = []
        for o in outs:
            h = torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
            h.copy_(o, non_blocking=True)
            hosts.append(h)
        event = torch.cuda.Event()
        event.record(self._stream)
        return tuple(hosts), event

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
        self._check_flat_view()
        B = len(wstarts)
        Rb = _bucket(max(R, 1))
        _check_ring_overflow(offs, Rb, self.cap)
        pad = _bucket(int(wlens.max()) if B else 1)
        KP = self.KP
        with profile.span("device_put"):
            blkp = self._stage_block(blk, Rb)
            # per-key offsets, then the windows' flat-view starts and lens
            vec = np.zeros(KP + 2 * B, dtype=np.int32)
            vec[:len(offs)] = offs
            vec[KP:KP + B] = (np.asarray(wrows, dtype=np.int64) * self.cap
                              + np.asarray(wstarts, dtype=np.int64))
            vec[KP + B:] = wlens
            with self._on_stream():
                d_blk, p_blk = self._to_device(blkp)
                d_vec, p_vec = self._to_device(vec)
        profile.add("bytes_shipped", blk.nbytes)
        profile.add("rows_shipped", blk.size)
        profile.add("windows", B)
        with profile.span("dispatch"), self._on_stream():
            ring = ring_append(self._ring_arr(), d_blk, d_vec[:KP])
            flat = ring.view(-1)
            outs = tuple(windowed_reduce(flat, d_vec[KP:KP + B],
                                         d_vec[KP + B:], pad, op)
                         for op in self.ops)
            hosts, event = self._fetch(outs)
        stats_add("dispatches")
        self._inflight.append((meta, B, hosts, event,
                               (p_blk, p_vec, d_blk, d_vec, outs),
                               time.perf_counter()))
        while len(self._inflight) > self.depth:
            self._harvest_one()

    def _check_flat_view(self):
        if self.KP * self.cap >= 2 ** 31:
            raise ValueError(
                f"ring of {self.KP} x {self.cap} cells: the flat-view window "
                "starts are int32 and need KP * cap < 2**31")

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
            ring = ring_append(self._ring_arr(), d_blk, d_vec[:KP])
            out = regular_window_sum(ring, d_vec[KP:2 * KP],
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

    ``stats``: a tuple of ``(op, field)`` evaluations (sum/min/max/prod),
    each by the windowed-reduce kernel on its field's ring's flat view;
    ``fn``: an optional ``TorchWindowFunction`` whose ``fn(keys, gwids,
    cols, mask)`` runs over ``(B, pad)`` tiles of its fields, cut from the
    rings by the window_gather kernel; ``acc_dtypes`` maps every field to
    its ring dtype, int32 or float32 (the ring kernels have no other).
    One launch appends every field's rectangle (``ring_append`` per ring)
    and evaluates the windows; its outputs are the stats' in ``stats``
    order, then the function's."""

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
        self._check_flat_view()
        B = len(wstarts)
        Rb = _bucket(max(R, 1))
        _check_ring_overflow(offs, Rb, self.cap)
        pad = _bucket(int(wlens.max()) if B else 1)
        KP, fn = self.KP, self.fn
        with profile.span("device_put"):
            blkps = [self._stage_block(blks[f], Rb) for f in self.fields]
            # per-key offsets; the windows' flat-view starts and lens; with
            # a function also rows, starts, keys and gwids (int32: keys and
            # gwids wrap as the JAX package's int32 cast does)
            vec = np.zeros(KP + (6 if fn is not None else 2) * B,
                           dtype=np.int32)
            vec[:len(offs)] = offs
            rows = np.asarray(wrows, dtype=np.int64)
            starts = np.asarray(wstarts, dtype=np.int64)
            vec[KP:KP + B] = rows * self.cap + starts
            vec[KP + B:KP + 2 * B] = wlens
            if fn is not None:
                for i, a in enumerate((rows, starts, wkeys, wgwids)):
                    if a is not None and B:
                        o = KP + (2 + i) * B
                        vec[o:o + B] = np.asarray(a).astype(np.int32)
            with self._on_stream():
                d_blks = [self._to_device(b) for b in blkps]
                d_vec, p_vec = self._to_device(vec)
        for f in self.fields:
            profile.add("bytes_shipped", blks[f].nbytes)
            profile.add("rows_shipped", blks[f].size)
        profile.add("windows", B)
        tiles = mask = None
        with profile.span("dispatch"), self._on_stream():
            rings = tuple(ring_append(r, d, d_vec[:KP])
                          for r, (d, _p) in zip(self._rings_arr(), d_blks))
            ring_of = dict(zip(self.fields, rings))
            flat_starts = d_vec[KP:KP + B]
            lens = d_vec[KP + B:KP + 2 * B]
            outs = [windowed_reduce(ring_of[f].view(-1), flat_starts, lens,
                                    pad, op) for op, f in self.stats]
            if fn is not None:
                d_rows, d_starts, d_keys, d_gwids = (
                    d_vec[KP + i * B:KP + (i + 1) * B] for i in range(2, 6))
                tiles, mask = window_gather(
                    [ring_of[f] for f in fn.fields], d_rows, d_starts, lens,
                    pad)
                res = fn.fn(d_keys, d_gwids, dict(zip(fn.fields, tiles)),
                            mask)
                outs.extend(res if isinstance(res, tuple) else (res,))
            hosts, event = self._fetch(outs)
        stats_add("dispatches")
        self._inflight.append((meta, B, hosts, event,
                               (p_vec, d_vec, d_blks, tiles, mask, outs),
                               time.perf_counter()))
        while len(self._inflight) > self.depth:
            self._harvest_one()


def prewarm_regular_ladder(mults=(2, 4, 8, 16), devices=None,
                           max_cells=1 << 24) -> int:
    """Kept as API of the JAX package, where it compiled the coalesced-shape
    siblings of every jitted step.  The port's kernels take runtime sizes
    and compile nothing per shape, so there is nothing to warm: returns 0."""
    return 0
