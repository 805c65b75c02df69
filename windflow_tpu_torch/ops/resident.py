"""Device-resident window archives on a CUDA card — the port of
``windflow_tpu/ops/resident.py`` (the single-ring executor).

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

    def ring_snapshot(self) -> RingSnapshot:
        """Consistent copy of the ring (the caller must have drained the
        in-flight launches first — their appends are already in the ring,
        but their undelivered results would be lost)."""
        if self._inflight:
            raise RuntimeError("ring_snapshot with launches in flight; "
                               "drain() first")
        if self._ring is None:
            return RingSnapshot(None, self.KP, self.cap)
        if self._stream is None:
            return RingSnapshot((self._ring.clone(),), self.KP, self.cap)
        with self._on_stream():
            host = torch.empty(self._ring.shape, dtype=self._acc,
                               pin_memory=True)
            host.copy_(self._ring, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return RingSnapshot((host,), self.KP, self.cap, event)

    def ring_restore(self, snap):
        """Reinstate a snapshot (RingSnapshot or its resolved dict) and
        clear the launch queue.  The ring is copied in: later appends never
        write into the snapshot's arrays."""
        data = snap.resolve() if isinstance(snap, RingSnapshot) else snap
        self._inflight.clear()
        self._ready = []
        self.KP = int(data["KP"])
        self.cap = int(data["cap"])
        rings = data["rings"]
        if rings is None:
            self._ring = None
            return
        ring = np.asarray(rings[0])
        if ring.dtype != self.acc_dtype or ring.shape != (self.KP, self.cap):
            raise ValueError(
                f"snapshot ring is {ring.dtype} {ring.shape}, the executor "
                f"expects {self.acc_dtype} ({self.KP}, {self.cap})")
        with self._on_stream():
            self._ring = torch.tensor(ring, device=self.device)

    def invalidate(self):
        """Drop the ring and launch queue entirely: the owning core's next
        flush rebases, rebuilding the ring from host-live archive rows (the
        no-ring-snapshot restore path)."""
        self._inflight.clear()
        self._ready = []
        self._ring = None
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
        if self.KP * self.cap >= 2 ** 31:
            raise ValueError(
                f"ring of {self.KP} x {self.cap} cells: the flat-view window "
                "starts are int32 and need KP * cap < 2**31")
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


def prewarm_regular_ladder(mults=(2, 4, 8, 16), devices=None,
                           max_cells=1 << 24) -> int:
    """Kept as API of the JAX package, where it compiled the coalesced-shape
    siblings of every jitted step.  The port's kernels take runtime sizes
    and compile nothing per shape, so there is nothing to warm: returns 0."""
    return 0
