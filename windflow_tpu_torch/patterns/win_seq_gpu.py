"""Win_Seq_GPU: the sequential window core with device-batched evaluation on
a CUDA card — the port of ``windflow_tpu/patterns/win_seq_tpu.py`` and the
reference WindFlow's own Win_Seq_GPU (win_seq_gpu.hpp).

Same window bookkeeping as the host core (it *is* the host core: one
subclass hook), but fired NIC windows are not evaluated inline: their
(start, len) ranges plus the staged archive slice are queued, and at
``batch_len`` fired windows one launch of the hand-written windowed-reduce
kernel evaluates them all (ops/device.py).  Result headers (key, renumbered
id, result ts) are computed host-side at fire time, like the reference
pre-fills ``host_results[i].setInfo(...)`` before the kernel
(win_seq_gpu.hpp:447-449).  Launches are asynchronous with bounded depth;
results are emitted in launch order, so per-key result order is preserved.

Two device cores live here, as in the JAX package: the restaging core
(``DeviceWinSeqCore``, the windowed-reduce kernel over each fired batch's
archive segment, or a user window function over the window_gather
kernel's tiles) and the resident core (``ResidentWinSeqCore``: every row
is copied once into a per-key ring on the card, one ring per field when
several fields ship, ops/resident.py; the C++ twin is
patterns/native_core.py).  ``make_core_for`` routes between them and the
host core with the JAX package's rules, and ``WinFarmGPU``/``KeyFarmGPU``
are the host farms with device cores as workers.  ``PaneFarmGPU`` and
``WinMapReduceGPU`` are the two-stage patterns with a per-stage device
placement (an incremental stage stays on the host).  With ``mesh=`` (a
parallel/mesh.py ``DeviceMesh``) the resident rings are sharded over the
mesh's key-group axis (ops/resident.py ``MeshResidentExecutor`` and
``MeshMultiFieldResidentExecutor``).
"""

from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch

from ..core.tuples import Schema
from ..core.windows import PatternConfig, Role, WindowSpec, WinType
from ..core.winseq import WinSeqCore
from ..ops.device import DeviceWindowExecutor
from ..ops.functions import MultiReducer, Reducer
from ..runtime.node import RuntimeContext
from .basic import _Pattern
from .key_farm import KeyFarm
from .pane_farm import PaneFarm
from .win_farm import WinFarm
from .win_mapreduce import WinMapReduce
from .win_seq import WinSeqNode


#: set by :func:`deferred_devices` while the static checker builds a graph
_DEFERRED = contextvars.ContextVar("wf_deferred_devices", default=None)


@contextlib.contextmanager
def deferred_devices():
    """While active (in this thread), a worker asked for no device on a
    host without a card is placed on the ``meta`` device instead of
    raising: the static checker (check.validate) builds graphs it never
    runs, and resolves no device for them.  The yielded dict's
    ``"deferred"`` says whether any placement was deferred: such a graph
    must not run (its cores hold no data), and is built anew for a run,
    which then resolves its devices (and raises without a card)."""
    seen = {"deferred": False}
    token = _DEFERRED.set(seen)
    try:
        yield seen
    finally:
        _DEFERRED.reset(token)


def resolve_worker_device(device, i: int) -> torch.device:
    """Per-worker device placement — farm worker *i* owns a card the way
    each reference GPU worker owns a CUDA stream/device
    (win_farm_gpu.hpp:132-168, win_seq_gpu.hpp:271-306).

    ``None`` spreads workers round-robin over the visible CUDA devices and
    raises ``RuntimeError`` when there is none (it never falls back to the
    CPU: pass ``device="cpu"`` to run the kernels' plain versions; inside
    :func:`deferred_devices` it gives the ``meta`` device); a list/tuple
    spreads over exactly those devices; a single device pins every worker
    to it."""
    if isinstance(device, (list, tuple)):
        return torch.device(device[i % len(device)])
    if device is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            deferred = _DEFERRED.get()
            if deferred is not None:
                deferred["deferred"] = True
                return torch.device("meta")
            raise RuntimeError(
                "no CUDA device: the device path runs on the card; pass "
                "device='cpu' explicitly to run it on the host")
        return torch.device(f"cuda:{i % n}")
    return torch.device(device)


class TorchWindowFunction:
    """User window function for the device path: ``fn(keys, gwids, cols,
    mask) -> column(s)`` over a whole window batch in PyTorch — the port of
    the JAX package's ``JaxWindowFunction`` and the reference's CUDA device
    functor ``F(key, gwid, data, res, size, scratch)``
    (win_seq_gpu.hpp:54-67).

    The function runs on the executor's device, inside its CUDA stream.
    ``keys`` and ``gwids`` are ``(B,)`` int32 tensors (the JAX package's
    width without x64); ``cols[f]`` is a ``(B, pad)`` tensor of field
    ``f`` in its device dtype (its ring dtype on the resident path; on the
    restaging one float32 or int32, or the column's 64-bit dtype under a
    64-bit ``compute_dtype``) with zeros past each window's length;
    ``mask`` is the ``(B, pad)`` bool mask of real lanes.
    It returns one ``(B,)`` tensor or a tuple of them, in
    ``result_fields`` order; harvest casts each to its declared dtype.
    ``field_dtypes`` types each field's ring on the resident path (default
    int32; float columns need an explicit float16, float32 or float64
    there; every ring dtype of ``ops/ring.py`` is taken: int8-int64,
    uint8-uint64, float16-float64)."""

    def __init__(self, fn, fields=("value",), result_fields=None,
                 field_dtypes=None):
        self.fn = fn
        self.fields = tuple(fields)
        self.result_fields = dict(result_fields or {"value": np.int64})
        #: ring dtype per input field on the resident path (default int32;
        #: float columns need an explicit float32 here — the ring is typed
        #: at allocation, unlike the restaging path which stages whatever
        #: dtype each launch carries)
        self.field_dtypes = dict(field_dtypes or {})


def _host_standin(winfunc):
    """Host-side function object carrying the result schema for the
    core/farm template plumbing (the device path never calls it)."""
    if isinstance(winfunc, (Reducer, MultiReducer)):
        return winfunc
    if isinstance(winfunc, TorchWindowFunction):
        r = Reducer("count")
        r.result_fields = dict(winfunc.result_fields)
        return r
    raise TypeError(
        "the device path needs a builtin Reducer or a TorchWindowFunction "
        "(host Python functions cannot be staged to the GPU — same "
        "restriction as the reference's __device__ functor contract)")


class _AsyncLaunchRecovery:
    """Recovery-mode hooks shared by the async device cores
    (docs/ROBUSTNESS.md "Recovery").  Emission granularity is ONE batch
    per completed launch, in launch order: launch boundaries are
    count-triggered (deterministic), while how many launches any one
    poll()/drain() harvests is wall-clock — per-launch emission keeps a
    replayed run's output seq numbering identical to the original's
    regardless of harvest timing."""

    def _pre_poll(self):
        """Hook before harvesting in process_batches."""

    def _per_launch(self, harvested):
        outs = []
        for entry in harvested:
            built = self._build_results([entry])
            if built:
                outs.append(built[0] if len(built) == 1
                            else np.concatenate(built))
        return outs

    def process_batches(self, batch):
        """Recovery-mode process(): same work, per-launch outputs."""
        WinSeqCore.process(self, batch)
        self._pre_poll()
        return self._per_launch(self.executor.poll())

    def flush_batches(self):
        WinSeqCore.flush(self)
        self._flush_batch()
        return self._per_launch(self.executor.drain())

    def checkpoint_drain_batches(self):
        """Epoch-barrier drain: launch the partial batch and block out
        the in-flight results (they pre-date the snapshot cut and would
        otherwise be lost on restore) — per launch, like every other
        recovery-mode emission."""
        self._flush_batch()
        return self._per_launch(self.executor.drain())


class DeviceWinSeqCore(_AsyncLaunchRecovery, WinSeqCore):
    """WinSeqCore whose fired-window evaluation is device-batched."""

    #: control-plane live rescale declined (docs/CONTROL.md): the
    #: inherited keyed hooks would migrate only the host bookkeeping
    #: while launch queues / staged device work stay behind
    keyed_migratable = False

    def __init__(self, spec: WindowSpec, winfunc, batch_len: int = 512,
                 config: PatternConfig = None, role: Role = Role.SEQ,
                 map_indexes=(0, 1), result_ts_slide=None, device="cuda",
                 depth: int = 4, compute_dtype=None):
        host_fn = _host_standin(winfunc)
        if isinstance(winfunc, TorchWindowFunction):
            executor = DeviceWindowExecutor(
                fn=winfunc.fn, fields=winfunc.fields,
                out_fields=tuple(winfunc.result_fields),
                device=device, depth=depth, compute_dtype=compute_dtype,
                out_dtypes=winfunc.result_fields)
            self._stage_fields = winfunc.fields
        else:
            executor = DeviceWindowExecutor(
                winfunc.op, fields=winfunc.required_fields,
                out_fields=tuple(winfunc.result_fields),
                device=device, depth=depth, compute_dtype=compute_dtype,
                out_dtypes=winfunc.result_fields,
                # empty windows must produce the host-path identity even
                # though device compute may run in a narrower dtype
                empty_fill={winfunc.out_field: winfunc._identity()})
            self._stage_fields = tuple(winfunc.required_fields)
        super().__init__(spec, host_fn, config=config, role=role,
                         map_indexes=map_indexes,
                         result_ts_slide=result_ts_slide)
        self.executor = executor
        self.batch_len = batch_len
        # pending windows: (segment_cols, starts, lens) + headers
        self._segs = []        # [(cols{f: np}, starts, lens)]
        self._pending = 0
        self._hdr = []         # [(key, ids, ts) per enqueue]

    # -- device-batched NIC evaluation ------------------------------------

    def _emit_windows(self, key, st, lwids, eos: bool):
        spec = self.spec
        gwids = st.first_gwid + lwids * self.config.gwid_stride()
        ts = self._result_ts(st, lwids, gwids)
        ids = self._renumber_ids(key, st, gwids)
        starts_abs = spec.win_start(lwids) + st.initial_id
        ends_abs = spec.win_end(lwids) + st.initial_id
        p = st.archive.positions
        lo = np.searchsorted(p, starts_abs, side="left")
        hi = (np.full(len(lwids), len(p), dtype=np.int64) if eos
              else np.searchsorted(p, ends_abs, side="left"))
        base = int(lo[0]) if len(lo) else 0
        top = int(hi[-1]) if len(hi) else 0
        rows = st.archive.rows[base:top]
        cols = {f: rows[f].copy() for f in self._stage_fields}
        self._segs.append((cols, (lo - base).astype(np.int64),
                           (hi - lo).astype(np.int64),
                           np.full(len(lwids), key, dtype=np.int64), gwids))
        self._hdr.append((key, ids, ts))
        self._pending += len(lwids)
        if not eos and len(lwids):
            st.archive.purge_below(int(starts_abs[-1]))
        if self._pending >= self.batch_len:
            self._flush_batch()
        return None

    def _flush_batch(self):
        if not self._segs:
            return
        flat = {f: [] for f in self._stage_fields}
        starts, lens, keys, gwids = [], [], [], []
        off = 0
        for cols, s, l, k, g in self._segs:
            for f in self._stage_fields:
                flat[f].append(cols[f])
            starts.append(s + off)
            lens.append(l)
            keys.append(k)
            gwids.append(g)
            off += len(next(iter(cols.values()))) if cols else 0
        flat = {f: np.concatenate(v) for f, v in flat.items()}
        self.executor.launch(list(self._hdr), flat, np.concatenate(starts),
                             np.concatenate(lens), np.concatenate(keys),
                             np.concatenate(gwids))
        self._segs, self._hdr, self._pending = [], [], 0

    # -- harvest ----------------------------------------------------------

    def _build_results(self, harvested):
        outs = []
        for hdr, cols in harvested:
            off = 0
            for key, ids, ts in hdr:
                n = len(ids)
                payload = {f: v[off:off + n] for f, v in cols.items()}
                outs.append(self._make_results(key, ids, ts, payload))
                off += n
        return outs

    def process(self, batch):
        super().process(batch)  # fired windows are enqueued, not returned
        outs = self._build_results(self.executor.poll())
        if not outs:
            return np.zeros(0, dtype=self._result_dtype)
        return np.concatenate(outs)

    def flush(self):
        super().flush()         # enqueue EOS leftovers
        self._flush_batch()     # launch the partial batch
        outs = self._build_results(self.executor.drain())
        if not outs:
            return np.zeros(0, dtype=self._result_dtype)
        return np.concatenate(outs)

    # -- recovery (docs/ROBUSTNESS.md): emission hooks come from
    # _AsyncLaunchRecovery ------------------------------------------------

    def state_snapshot(self):
        """Post-drain snapshot: the restaging executor keeps no state
        across launches, so only the host Win_Seq bookkeeping (per-key
        archives + counters) needs capturing."""
        import copy
        return {"_keys": copy.deepcopy(self._keys),
                "_in_dtype": self._in_dtype}

    def state_restore(self, snap):
        import copy
        self._keys = copy.deepcopy(snap["_keys"])
        self._in_dtype = snap["_in_dtype"]
        self._segs, self._hdr, self._pending = [], [], 0
        self.executor._inflight.clear()
        self.executor._ready = []

    def use_incremental(self):
        raise TypeError("the device path is non-incremental only "
                        "(win_seq_gpu.hpp supports NIC device functors)")


#: (op, result-dtype, acc-dtype) combinations already warned about —
#: resident cores are built per farm worker / per run, and repeating the
#: same narrowing warning for each of them is noise
_ACC_WARNED = set()


def _acc_range_safe(reducer: Reducer, acc: np.dtype, spec) -> bool:
    """True when the reducer's declared ``value_range`` proves its window
    results cannot exceed ``acc``'s range: min/max never leave the input
    range; a CB window's sum is bounded by win_len * max|value| (a TB
    window's row count is unbounded, so sums stay unprovable there)."""
    vr = getattr(reducer, "value_range", None)
    if vr is None or acc.kind == "f":
        return False
    m = max(abs(int(vr[0])), abs(int(vr[1])))
    if reducer.op in ("min", "max"):
        bound = m
    elif (reducer.op == "sum" and spec is not None
          and spec.win_type is WinType.CB):
        bound = m * int(spec.win_len)
    else:
        return False
    info = np.iinfo(acc)
    return -bound >= info.min and bound <= info.max


def select_acc_dtype(reducer: Reducer, compute_dtype,
                     spec: WindowSpec = None) -> np.dtype:
    """Accumulate dtype for the resident device path: int32/float32 by
    default, overridable via ``compute_dtype`` (int8, int16, int32, int64,
    uint8, uint16, uint32, uint64, float16, float32 or float64: the ring
    kernels' dtypes; the executor refuses any other, bfloat16 as JAX's
    core does).  Warns when the
    reducer's result dtype exceeds the accumulate range — unless the
    reducer's declared ``value_range`` plus the window shape prove the
    results fit.  A 64-bit ``compute_dtype`` runs as the JAX package runs
    it with x64 on (the port has no x64 switch; JAX without x64 raises)."""
    if compute_dtype is not None:
        acc = np.dtype(compute_dtype)
    elif np.issubdtype(reducer.dtype, np.floating):
        acc = np.dtype(np.float32)
    else:
        acc = np.dtype(np.int32)
    if (reducer.dtype.itemsize > acc.itemsize
            and not _acc_range_safe(reducer, acc, spec)):
        key = (reducer.op, reducer.dtype.str, acc.str)
        if key not in _ACC_WARNED:
            _ACC_WARNED.add(key)
            import warnings
            warnings.warn(
                f"resident device path accumulates in {acc}; {reducer.op} "
                "results beyond its range will wrap — pass compute_dtype "
                "for wide ranges, or declare the field's value_range on "
                "the Reducer to prove the fit (warned once per "
                "configuration)",
                stacklevel=4)
    return acc


def finalize_window_values(reducer: Reducer, vals: np.ndarray,
                           lens: np.ndarray) -> np.ndarray:
    """Shared harvest step: cast device outputs to the reducer's result
    dtype and write the host identity over empty windows (min/max/prod
    identities exceed narrow accumulate dtypes; sum's identity 0 is what
    an empty window sum already yields)."""
    owned = vals.dtype != reducer.dtype
    if owned:
        vals = vals.astype(reducer.dtype)
    if (reducer.op in ("min", "max", "prod") and len(lens)
            and (lens == 0).any()):
        if not owned:
            vals = vals.copy()
        vals[lens == 0] = reducer._identity()
    return vals


class ResidentWinSeqCore(_AsyncLaunchRecovery, WinSeqCore):
    """Window core whose archive lives in device memory (ops/resident.py).

    Host-side it is the same Win_Seq bookkeeping as every other core; the
    differences from :class:`DeviceWinSeqCore` (which restages each fired
    window's rows per batch, like the reference's per-batch H2D memcpy,
    win_seq_gpu.hpp:451-476) are:

    * appended rows are mirrored once into the device ring archive, in the
      narrowest dtype holding their range — each row is copied once;
    * fired windows are described by (ring row, start, len) only; append and
      evaluation go to the card as one dispatch per flush;
    * the host archive's purge is deferred to flush time so a rebase (ring
      compaction) can always rebuild the ring from host-live rows.

    It serves a ``Reducer``, a ``MultiReducer`` (stats over one field share
    one ring; stats over several fields get one ring each,
    ``MultiFieldResidentExecutor``) or a ``TorchWindowFunction`` (one ring
    per input field, typed by its ``field_dtypes``).
    """

    #: control-plane live rescale declined (docs/CONTROL.md): a key's
    #: rows are mirrored into THIS worker's device ring archive — the
    #: inherited host-dict hooks cannot move that half
    keyed_migratable = False

    def __init__(self, spec: WindowSpec, reducer, batch_len: int = 8192,
                 flush_rows: int = 1 << 20, config: PatternConfig = None,
                 role: Role = Role.SEQ, map_indexes=(0, 1),
                 result_ts_slide=None, device=None, depth: int = 8,
                 compute_dtype=None, worker_index: int = 0, mesh=None,
                 max_delay_ms=None):
        from ..ops.resident import (MeshMultiFieldResidentExecutor,
                                    MeshResidentExecutor,
                                    MultiFieldResidentExecutor,
                                    ResidentWindowExecutor)
        self._fn = None
        self._pos_max_parts = []
        if isinstance(reducer, TorchWindowFunction):
            # a batched torch window fn over device-resident rings — one
            # ring per input field (win_seq_gpu.hpp:54-67's arbitrary
            # functor over whole POD tuples, without per-fire restaging)
            self._device_parts = []
            self._count_parts = []
            self._fn = reducer
        elif isinstance(reducer, MultiReducer):
            # multi-stat: counts come free from window lengths, and MAX/MIN
            # over the POSITION field (ts for TB, id for CB) from the
            # position-ordered host archive — so e.g. COUNT + MAX(ts) +
            # SUM(revenue) ships only the revenue column
            self._device_parts, self._pos_max_parts = \
                split_pos_max(spec, reducer)
            self._count_parts = reducer.count_parts
            if not self._device_parts:
                # an entirely host-free aggregate forced onto the device
                # (use_resident=True): ship the position column after all
                self._device_parts, self._pos_max_parts = \
                    self._pos_max_parts, []
            if not self._device_parts:
                raise ValueError(
                    "resident MultiReducer needs >=1 non-count stat "
                    "(use Reducer('count') for pure counts)")
        elif isinstance(reducer, Reducer):
            self._device_parts = [reducer]
            self._count_parts = []
        else:
            raise TypeError("resident device path needs a builtin Reducer, "
                            "MultiReducer, or TorchWindowFunction")
        fields = {p.field for p in self._device_parts}
        field = (fields.pop() if self._fn is None and len(fields) == 1
                 else None)
        host_fn = _host_standin(reducer)
        super().__init__(spec, host_fn, config=config, role=role,
                         map_indexes=map_indexes,
                         result_ts_slide=result_ts_slide)
        self.reducer = reducer
        self.field = field
        if self._fn is not None:
            self._ship_fields = tuple(self._fn.fields)
        elif field is not None:
            self._ship_fields = (field,)
        else:
            self._ship_fields = tuple(dict.fromkeys(
                p.field for p in self._device_parts))
        if mesh is None:
            device = resolve_worker_device(device, worker_index)
        if field is None:
            # per-field ring dtypes: reducer parts pick theirs via
            # select_acc_dtype; fn fields use the fn's declared
            # field_dtypes (default int32)
            acc_by_field = {}
            for p in self._device_parts:
                a = select_acc_dtype(p, compute_dtype, spec)
                prev = acc_by_field.get(p.field)
                if prev is not None and prev.kind != a.kind:
                    raise ValueError(
                        f"stats over field {p.field!r} disagree on "
                        f"accumulate kind ({prev} vs {a})")
                if prev is None or a.itemsize > prev.itemsize:
                    acc_by_field[p.field] = a
            if self._fn is not None:
                for f in self._ship_fields:
                    acc_by_field.setdefault(f, np.dtype(
                        self._fn.field_dtypes.get(f, np.int32)))
            stats = tuple((p.op, p.field) for p in self._device_parts)
            if mesh is not None:
                self.executor = MeshMultiFieldResidentExecutor(
                    self._ship_fields, stats=stats, fn=self._fn,
                    acc_dtypes=acc_by_field, mesh=mesh, depth=depth)
            else:
                self.executor = MultiFieldResidentExecutor(
                    self._ship_fields, stats=stats, fn=self._fn,
                    acc_dtypes=acc_by_field, device=device, depth=depth)
        else:
            accs = [select_acc_dtype(p, compute_dtype, spec)
                    for p in self._device_parts]
            if len({d.kind for d in accs}) > 1:
                # one shared ring, one accumulate dtype: a float ring would
                # silently round sibling integer sums (float32 spacing > 1
                # above 2^24) — refuse instead
                raise ValueError(
                    "multi-stat parts disagree on accumulate kind "
                    f"({sorted(str(a) for a in accs)}): split the stats or "
                    "pass an explicit compute_dtype")
            acc = max(accs, key=lambda d: d.itemsize)
            ops = tuple(p.op for p in self._device_parts)
            op_arg = ops[0] if len(ops) == 1 else ops
            if mesh is not None:
                self.executor = MeshResidentExecutor(
                    op_arg, mesh, depth=depth, acc_dtype=acc)
            else:
                self.executor = ResidentWindowExecutor(
                    op_arg, device=device, depth=depth, acc_dtype=acc)
        self.batch_len = batch_len
        self.flush_rows = flush_rows
        # latency bound: ship pending windows/rows after this many ms even
        # when neither batch_len nor flush_rows is reached (checked per
        # process() call — the trigger cadence is the chunk cadence)
        self.max_delay_s = (None if max_delay_ms is None
                            else max_delay_ms / 1e3)
        self._last_flush_t = None
        self._rowmap = {}     # key -> dense ring row
        self._appended = {}   # key -> rows ever archived (abs row domain)
        self._launched = {}   # key -> rows already shipped to the ring
        self._base = {}       # key -> abs row index of ring column 0
        #: field -> key -> [column arrays not yet shipped]
        self._pend_cols = {f: {} for f in self._ship_fields}
        self._pend_rows = 0
        self._wdesc = []      # (key, abs_lo array, len array, gwids)
        self._hdr = []        # (key, ids, ts, lens, pos extrema) per fire
        self._n_wins = 0
        self._purge_pos = {}  # key -> purge threshold deferred to flush

    # ------------------------------------------------------------ bookkeeping

    def _on_append(self, key, st, rows):
        self._rowmap.setdefault(key, len(self._rowmap))
        for f in self._ship_fields:
            self._pend_cols[f].setdefault(key, []).append(
                np.asarray(rows[f]))
        self._appended[key] = self._appended.get(key, 0) + len(rows)
        self._pend_rows += len(rows)
        if self._pend_rows >= self.flush_rows:
            self._flush_batch()

    def _emit_windows(self, key, st, lwids, eos: bool):
        spec = self.spec
        self._rowmap.setdefault(key, len(self._rowmap))
        gwids = st.first_gwid + lwids * self.config.gwid_stride()
        ts = self._result_ts(st, lwids, gwids)
        ids = self._renumber_ids(key, st, gwids)
        starts_abs = spec.win_start(lwids) + st.initial_id
        ends_abs = spec.win_end(lwids) + st.initial_id
        p = st.archive.positions
        lo = np.searchsorted(p, starts_abs, side="left")
        hi = (np.full(len(lwids), len(p), dtype=np.int64) if eos
              else np.searchsorted(p, ends_abs, side="left"))
        live_start = self._appended.get(key, 0) - len(p)
        self._wdesc.append((key, lo + live_start, (hi - lo).astype(np.int64),
                            gwids))
        if self._pos_max_parts and len(p):
            # MAX/MIN over the position field, free from the ordered
            # archive: the window's last row holds the max and its first
            # row the min (empty windows fixed up to the identity at
            # harvest, finalize_window_values)
            pm = (p[np.minimum(np.maximum(hi - 1, 0), len(p) - 1)],
                  p[np.minimum(lo, len(p) - 1)])
        else:
            z = np.zeros(len(lwids), dtype=np.int64)
            pm = (z, z)
        self._hdr.append((key, ids, ts, (hi - lo).astype(np.int64), pm))
        self._n_wins += len(lwids)
        if not eos and len(lwids):
            # defer the purge so a flush-time rebase can rebuild the ring
            # from host-live rows (win_seq.hpp:390-392 purges at fire time)
            self._purge_pos[key] = max(self._purge_pos.get(key, -2 ** 62),
                                       int(starts_abs[-1]))
        if self._n_wins >= self.batch_len:
            self._flush_batch()
        return None

    # ------------------------------------------------------------------ flush

    def _flush_batch(self):
        if not self._wdesc and not self._pend_rows:
            return
        from ..ops.device import _bucket
        ex = self.executor
        rowmap = self._rowmap
        K = len(rowmap)
        # --- decide append vs rebase ---
        rebase = ex.cap == 0 or ex.KP < max(K, 1)
        if not rebase:
            # the append rectangle is (K, Rb) with one global padded width,
            # so every key needs fill + Rb columns of room
            maxpend = max((self._appended.get(key, 0)
                           - self._launched.get(key, 0) for key in rowmap),
                          default=0)
            Rb = _bucket(max(maxpend, 1))
            for key in rowmap:
                fill = self._launched.get(key, 0) - self._base.get(key, 0)
                if fill + Rb > ex.cap:
                    rebase = True
                    break
        if rebase:
            counts = {}
            maxlive = 0
            for key in rowmap:
                st = self._keys.get(key)
                counts[key] = len(st.archive) if st is not None else 0
                maxlive = max(maxlive, counts[key])
            per_key_slack = max(self.flush_rows // max(K, 1), 64)
            ex.reset(K, _bucket(2 * maxlive + 2 * per_key_slack))
            R = maxlive
            srcs = {f: {key: ([np.asarray(self._keys[key].archive.rows[f])]
                              if key in self._keys else [])
                        for key in rowmap}
                    for f in self._ship_fields}
            for key in rowmap:
                self._base[key] = self._appended.get(key, 0) - counts[key]
                self._launched[key] = self._base[key]
            offs = np.zeros(ex.KP, dtype=np.int64)
        else:
            srcs = self._pend_cols
            counts = {key: self._appended.get(key, 0)
                      - self._launched.get(key, 0) for key in rowmap}
            R = max(counts.values(), default=0)
            offs = np.zeros(ex.KP, dtype=np.int64)
            for key, r in rowmap.items():
                offs[r] = self._launched.get(key, 0) - self._base.get(key, 0)
        # --- per-field rectangles in the narrowest wire dtype ---
        blks = {}
        for f in self._ship_fields:
            fsrcs = srcs[f]
            arrays = [a for key in rowmap for a in fsrcs.get(key, [])
                      if len(a)]
            if arrays:
                lo = min(a.min() for a in arrays)
                hi = max(a.max() for a in arrays)
                probe = np.array([lo, hi], dtype=arrays[0].dtype)
            else:
                probe = np.zeros(0, dtype=np.int64)
            wire = (ex.narrow_for(f, probe) if self.field is None
                    else ex.narrow(probe))
            blk = np.zeros((K, max(R, 1)), dtype=wire)
            for key, r in rowmap.items():
                c = 0
                for a in fsrcs.get(key, []):
                    blk[r, c:c + len(a)] = a
                    c += len(a)
            blks[f] = blk
        # --- window descriptors in ring coordinates ---
        if self._wdesc:
            wrows = np.concatenate([
                np.full(len(lens), rowmap[key], dtype=np.int64)
                for key, _, lens, _g in self._wdesc])
            wstarts = np.concatenate([
                abs_lo - self._base.get(key, 0)
                for key, abs_lo, _l, _g in self._wdesc])
            wlens = np.concatenate([lens for _k, _a, lens, _g in self._wdesc])
        else:
            wrows = wstarts = wlens = np.zeros(0, dtype=np.int64)
        if self.field is None:
            # per-field rings: every field's rectangle, plus the (keys,
            # gwids) a window function reads
            if self._fn is not None and self._wdesc:
                wkeys = np.concatenate([
                    np.full(len(lens), key, dtype=np.int64)
                    for key, _a, lens, _g in self._wdesc])
                wgwids = np.concatenate(
                    [g for _k, _a, _l, g in self._wdesc]).astype(np.int64)
            else:
                wkeys = wgwids = None
            ex.launch(self._hdr, blks, offs[:K], wrows, wstarts, wlens,
                      wkeys=wkeys, wgwids=wgwids)
        else:
            ex.launch(self._hdr, blks[self.field], offs[:K], wrows, wstarts,
                      wlens)
        # --- advance cursors, apply deferred purges ---
        for key in rowmap:
            self._launched[key] = self._appended.get(key, 0)
        for key, pos in self._purge_pos.items():
            st = self._keys.get(key)
            if st is not None:
                st.archive.purge_below(pos)
        self._pend_cols = {f: {} for f in self._ship_fields}
        self._pend_rows = 0
        self._wdesc, self._hdr, self._n_wins = [], [], 0
        self._purge_pos = {}
        if self.max_delay_s is not None:
            # every flush (natural or forced) restarts the latency clock —
            # otherwise a saturated stream would fragment launches at
            # max_delay cadence despite fresh batch_len/flush_rows flushes
            import time as _time
            self._last_flush_t = _time.monotonic()

    # ---------------------------------------------------------------- harvest

    def _build_results(self, harvested):
        outs = []
        fn_fields = (tuple(self._fn.result_fields.items())
                     if self._fn is not None else ())
        for hdr, out in harvested:
            stat_arrs = out if isinstance(out, tuple) else (out,)
            off = 0
            for key, ids, ts, lens, pos_max in hdr:
                n = len(ids)
                payload = {}
                for p, arr in zip(self._device_parts, stat_arrs):
                    payload[p.out_field] = finalize_window_values(
                        p, arr[off:off + n], lens)
                # a window function's outputs follow the stats' (the
                # float32 checksum of a skyline becomes its float64 field)
                for (name, dt), arr in zip(
                        fn_fields, stat_arrs[len(self._device_parts):]):
                    payload[name] = arr[off:off + n].astype(dt)
                for p in self._count_parts:
                    payload[p.out_field] = lens.astype(p.dtype)
                for p in self._pos_max_parts:
                    payload[p.out_field] = finalize_window_values(
                        p, pos_max[0] if p.op == "max" else pos_max[1],
                        lens)
                outs.append(self._make_results(key, ids, ts, payload))
                off += n
        return outs

    def _maybe_delay_flush(self):
        if self.max_delay_s is not None and (self._wdesc or self._pend_rows):
            import time as _time
            now = _time.monotonic()
            if self._last_flush_t is None:
                self._last_flush_t = now
            elif now - self._last_flush_t >= self.max_delay_s:
                self._flush_batch()
                self._last_flush_t = now

    def process(self, batch):
        super().process(batch)  # fired windows are enqueued, not returned
        self._maybe_delay_flush()
        outs = self._build_results(self.executor.poll())
        if not outs:
            return np.zeros(0, dtype=self._result_dtype)
        return np.concatenate(outs)

    def flush(self):
        super().flush()          # enqueue EOS leftovers
        self._flush_batch()      # launch the partial batch
        outs = self._build_results(self.executor.drain())
        if not outs:
            return np.zeros(0, dtype=self._result_dtype)
        return np.concatenate(outs)

    # -- recovery (docs/ROBUSTNESS.md): emission hooks come from
    # _AsyncLaunchRecovery ------------------------------------------------

    def _pre_poll(self):
        self._maybe_delay_flush()

    #: include the ring contents in snapshots (copied in stream order,
    #: ops/resident.RingSnapshot); the Supervisor mirrors
    #: RecoveryPolicy.snapshot_rings here.  False = restore by forcing a
    #: rebase from the host-live archive rows instead.
    snapshot_rings = True
    #: ring/cursor bookkeeping captured alongside the host archives
    _RES_ATTRS = ("_rowmap", "_appended", "_launched", "_base")

    def state_snapshot(self):
        if self.max_delay_s is not None:
            # the latency-bound flush is wall-clock-triggered: replayed
            # LAUNCH boundaries would diverge from the original run's,
            # and with them the emission seqs — decline rather than
            # risk duplicated/lost windows after a restart
            from ..runtime.node import SnapshotUnsupported
            raise SnapshotUnsupported(
                "max_delay_ms wall-clock flushes make replay emission "
                "boundaries nondeterministic; recovery supports "
                "count-triggered flushes only")
        import copy
        snap = {
            "_keys": copy.deepcopy(self._keys),
            "_in_dtype": self._in_dtype,
            "resident": copy.deepcopy(
                {a: getattr(self, a) for a in self._RES_ATTRS}),
        }
        if self.snapshot_rings:
            snap["ring"] = self.executor.ring_snapshot()
        return snap

    def state_restore(self, snap):
        import copy
        self._keys = copy.deepcopy(snap["_keys"])
        self._in_dtype = snap["_in_dtype"]
        for a, v in snap["resident"].items():
            setattr(self, a, copy.deepcopy(v))
        self._pend_cols = {f: {} for f in self._ship_fields}
        self._pend_rows = 0
        self._wdesc, self._hdr, self._n_wins = [], [], 0
        self._purge_pos = {}
        self._last_flush_t = None
        ring = snap.get("ring")
        if ring is not None:
            self.executor.ring_restore(ring)
        else:
            # no ring in the snapshot: invalidate so the next flush
            # rebases — the deferred-purge invariant guarantees the
            # host archives still hold every ring-live row
            self.executor.invalidate()

    def use_incremental(self):
        raise TypeError("the device path is non-incremental only "
                        "(win_seq_gpu.hpp supports NIC device functors)")


#: reducer ops the resident path evaluates on the card (count carries no
#: device work and routes to the HOST core via _host_free, as does max or
#: min over the position field)
_RESIDENT_OPS = ("sum", "min", "max", "prod")


def split_pos_max(spec: WindowSpec, reducer: MultiReducer):
    """Partition a MultiReducer's non-count stats into (device_parts,
    pos_extremum_parts): MAX *and MIN* over the POSITION field (ts for
    TB, id for CB) are free from the position-ordered archive — the
    window's last row holds the max and its FIRST row the min — so
    neither ever ships.  Harvesters pick the per-window last/first-row
    array by each returned part's ``op``."""
    pos_field = "id" if spec.win_type is WinType.CB else "ts"
    dev = reducer.device_parts
    pos = [p for p in dev
           if p.op in ("max", "min") and p.field == pos_field]
    return [p for p in dev if p not in pos], pos


def _host_free(spec: WindowSpec, winfunc) -> bool:
    """True when every stat is free on the host: counts come from window
    lengths, and ``max``/``min`` over the POSITION field (ts for TB, id
    for CB) are the last/first archived row's values — archives are kept
    ordered by position, so the host bookkeeping already holds the
    answers."""
    pos_field = "id" if spec.win_type is WinType.CB else "ts"
    parts = winfunc.parts if isinstance(winfunc, MultiReducer) else [winfunc]
    return all(p.op == "count"
               or (p.op in ("max", "min") and p.field == pos_field)
               for p in parts)


def _multi_resident_ok(winfunc: MultiReducer, use_reduce_kernel: bool) -> bool:
    """Whether a MultiReducer can run on the resident path: >=1 non-count
    stat, all ops resident-evaluable, no float-sum."""
    dev = winfunc.device_parts
    return (not use_reduce_kernel and bool(dev)
            and all(p.op in _RESIDENT_OPS for p in dev)
            and not any(p.op == "sum"
                        and np.issubdtype(p.dtype, np.floating)
                        for p in dev))


def _native_core_lib():
    """The native library handle for core routing, or None — also None
    under WF_NO_NATIVE_CORE=1, which pins the Python resident core."""
    import os
    if os.environ.get("WF_NO_NATIVE_CORE", "") == "1":
        return None
    from ..native import enabled
    return enabled()


def make_device_core(worker, fn, dev_kw, index=0):
    """Build the device-batched core for a prototype host worker (a WinSeq
    carrying the farm's per-worker spec/config/role plumbing); ``index`` is
    the farm worker index driving per-worker device placement."""
    return make_core_for(worker.spec, fn, config=worker.config,
                         role=worker.role, map_indexes=worker.map_indexes,
                         result_ts_slide=worker.result_ts_slide,
                         worker_index=index, **dev_kw)


def make_core_for(spec, winfunc, *, batch_len=512, config=None,
                  role=Role.SEQ, map_indexes=(0, 1), result_ts_slide=None,
                  device=None, depth=None, use_reduce_kernel=False,
                  compute_dtype=None, use_resident=None,
                  flush_rows=1 << 20, shards=1, worker_index=0, mesh=None,
                  max_delay_ms=None):
    """Choose the core implementation with the JAX package's routing
    (win_seq_tpu.py:make_core_for): host-free aggregates go to the host
    core; builtin monoids the resident executor evaluates go to the
    resident core — the C++ ``NativeResidentCore`` when the native library
    loads (several integer stats over up to ``wf_max_fields()`` fields
    included), else the Python ``ResidentWinSeqCore``; a
    ``TorchWindowFunction`` goes to the resident core with
    ``use_resident=True`` and to the restaging core by default; everything
    else, and any Reducer with ``use_reduce_kernel=True``, goes to the
    restaging core.  A latency budget (``max_delay_ms``) under twice the
    best recently measured launch service routes to the host core.  With
    ``mesh`` (a parallel/mesh.py ``DeviceMesh``) the resident rings are
    sharded over its kf axis: a builtin Reducer, a MultiReducer or a
    ``TorchWindowFunction`` takes the resident route (the host route and
    the latency routing do not apply), anything else raises."""
    def _host_core():
        from .win_seq import WinSeq
        return WinSeq(winfunc, spec.win_len, spec.slide_len,
                      spec.win_type, config=config, role=role,
                      map_indexes=map_indexes,
                      result_ts_slide=result_ts_slide).make_core()

    if (max_delay_ms is not None and use_resident is None
            and mesh is None and not use_reduce_kernel
            and isinstance(winfunc, (Reducer, MultiReducer))
            # a MultiReducer invalid on EVERY device path must fall
            # through to the deterministic ValueError below — routing it
            # host only when some earlier run seeded the weather record
            # would make raise-vs-success depend on hidden global state
            and not (isinstance(winfunc, MultiReducer)
                     and not _multi_resident_ok(winfunc, use_reduce_kernel))):
        # budget-aware routing: every device result pays at least one
        # launch round trip, so a latency budget under ~2x the measured
        # per-launch service FLOOR is unmeetable on the device path by
        # construction, while the host core has no device round trip.
        # With no observation yet the device keeps the benefit of the
        # doubt; any explicit path pin outranks the heuristic.
        from ..ops.resident import wire_service_floor_ms
        floor = wire_service_floor_ms()
        if floor is not None and max_delay_ms < 2.0 * floor:
            return _host_core()
    if (isinstance(winfunc, (Reducer, MultiReducer))
            and use_resident is None and mesh is None
            and (isinstance(winfunc, MultiReducer) or not use_reduce_kernel)
            and _host_free(spec, winfunc)):
        # every stat is answerable from host bookkeeping — shipping the
        # column to the device buys nothing but copies.  use_resident=True
        # forces the device; a Reducer with use_reduce_kernel=True keeps
        # the restaging path (benchmarking).
        return _host_core()
    resident_kw = dict(batch_len=batch_len, flush_rows=flush_rows,
                       config=config, role=role, map_indexes=map_indexes,
                       result_ts_slide=result_ts_slide, device=device,
                       depth=depth if depth is not None else 8,
                       compute_dtype=compute_dtype,
                       worker_index=worker_index, max_delay_ms=max_delay_ms,
                       mesh=mesh)
    if isinstance(winfunc, MultiReducer):
        # multi-stat windows are resident-only (the restaging executor has
        # no multi-output contract)
        if use_resident is False or not _multi_resident_ok(
                winfunc, use_reduce_kernel):
            raise ValueError(
                "MultiReducer runs on the resident device path only: "
                "needs >=1 non-count stat, ops in "
                f"{_RESIDENT_OPS}, no float sum (got {winfunc.parts})")
        dev_parts, _pos = split_pos_max(spec, winfunc)
        nat = _native_core_lib()
        if (nat is not None and dev_parts
                # dev_parts empty = a fully pos-free aggregate forced onto
                # the device: only the Python core ships the position
                # column for that shape
                and (len(dev_parts) == 1
                     or (len({p.field for p in dev_parts})
                         <= int(nat.wf_max_fields())
                         and not any(np.issubdtype(p.dtype, np.floating)
                                     for p in dev_parts)))):
            # the C++ core carries the whole hot loop: counts and position
            # extrema come from its archive, and the device stats stage one
            # narrowed column per distinct field into per-field rings (one
            # column, one ring, for a single stat); float stats keep the
            # Python core
            from .native_core import NativeResidentCore
            return NativeResidentCore(spec, winfunc, shards=shards,
                                      **resident_kw)
        return ResidentWinSeqCore(spec, winfunc, **resident_kw)
    if (isinstance(winfunc, TorchWindowFunction)
            and (use_resident or mesh is not None) and not use_reduce_kernel):
        # window functions evaluate over per-field resident rings on
        # request; the default stays the restaging executor, whose staged
        # columns carry each launch's exact dtypes (rings are typed at
        # allocation — TorchWindowFunction.field_dtypes declares them).
        # The resident path is the only one with a sharded form, so a mesh
        # implies it
        return ResidentWinSeqCore(spec, winfunc, **resident_kw)
    resident = use_resident
    if resident is None:
        resident = (not use_reduce_kernel and isinstance(winfunc, Reducer)
                    and winfunc.op in _RESIDENT_OPS
                    # a float cumsum accumulates rounding error the host
                    # path's per-window reduction does not; floats keep the
                    # segment-restaging path unless the user opts in
                    and not (winfunc.op == "sum"
                             and np.issubdtype(winfunc.dtype, np.floating)))
    if mesh is not None:
        if not (isinstance(winfunc, Reducer)
                and winfunc.op in _RESIDENT_OPS):
            raise ValueError(
                "mesh execution needs a resident-path Reducer "
                f"(one of {_RESIDENT_OPS}); got {winfunc!r}")
        if not resident:
            raise ValueError(
                "mesh execution requires the resident path: drop "
                "use_reduce_kernel, and for float sums opt in explicitly "
                "with use_resident=True (cumsum rounding differs from the "
                "host's per-window reduction)")
    if resident:
        # with a mesh the C++ bookkeeping feeds the sharded rings, and host
        # key shards compose with it: each shard owns its own mesh executor
        if _native_core_lib() is not None:
            from .native_core import NativeResidentCore
            return NativeResidentCore(spec, winfunc, shards=shards,
                                      **resident_kw)
        return ResidentWinSeqCore(spec, winfunc, **resident_kw)
    return DeviceWinSeqCore(
        spec, winfunc, batch_len=batch_len, config=config, role=role,
        map_indexes=map_indexes, result_ts_slide=result_ts_slide,
        device=resolve_worker_device(device, worker_index),
        depth=depth if depth is not None else 4,
        compute_dtype=compute_dtype)


class _DeviceCoreFactory:
    """Mixin for farm variants whose workers are device-batched: the host
    farm builds its prototype workers, `_make_core` swaps in the device
    core (set `_raw_fn` and `_dev_kw` before calling the farm ctor).
    Worker *i*'s executor lands on ``resolve_worker_device(device, i)``,
    so a pardegree-n farm on an n-card host owns one card per worker; on
    one card each worker has its own executor and CUDA stream."""

    def _make_core(self, worker, i=0):
        return make_device_core(worker, self._raw_fn, self._dev_kw, index=i)


class WinSeqGPU(_Pattern):
    """Sequential GPU window pattern (reference Win_Seq_GPU builder shape:
    withBatch(batch_len) replaces withBatch(batch_len, n_thread_block)).

    By default a builtin Reducer runs on the resident path (rows copied
    once into per-key rings on the card; ``flush_rows`` rows per append,
    ``shards`` host key shards for the C++ core, ``max_delay_ms`` a latency
    bound).  ``use_reduce_kernel`` is the counterpart of the JAX package's
    ``use_pallas``: it pins a builtin Reducer to the restaging path, whose
    fired window batches the hand-written windowed-reduce kernel
    evaluates.  ``device=None`` places the core on ``cuda:0`` (and raises
    without CUDA); ``device="cpu"`` runs the kernels' plain versions."""

    def __init__(self, winfunc, win_len, slide_len, win_type=WinType.CB,
                 batch_len=512, name="win_seq_gpu",
                 config: PatternConfig = None, role: Role = Role.SEQ,
                 map_indexes=(0, 1), result_ts_slide=None, device=None,
                 depth=None, use_reduce_kernel=False, compute_dtype=None,
                 use_resident=None, flush_rows=1 << 20, shards=1,
                 mesh=None, max_delay_ms=None):
        super().__init__(name, parallelism=1)
        self.spec = WindowSpec(win_len, slide_len, win_type)
        self._kw = dict(batch_len=batch_len, config=config, role=role,
                        map_indexes=map_indexes,
                        result_ts_slide=result_ts_slide, device=device,
                        depth=depth, use_reduce_kernel=use_reduce_kernel,
                        compute_dtype=compute_dtype,
                        use_resident=use_resident, flush_rows=flush_rows,
                        shards=shards, mesh=mesh,
                        max_delay_ms=max_delay_ms)
        self.winfunc = winfunc

    def make_core(self):
        return make_core_for(self.spec, self.winfunc, **self._kw)

    @property
    def result_schema(self):
        return Schema(**self.winfunc.result_fields)

    def _make_replica(self, i):
        node = WinSeqNode(self.make_core(), f"{self.name}.{i}")
        node.ctx = RuntimeContext(1, 0, self.name)
        return node


class WinFarmGPU(_DeviceCoreFactory, WinFarm):
    """Win_Farm of device-batched window cores — the reference's
    Win_Farm_GPU (win_farm_gpu.hpp:132-168: the CPU farm's emitter and
    collector, device workers)."""

    def __init__(self, winfunc, win_len, slide_len, win_type=WinType.CB,
                 pardegree=2, batch_len=512, name="win_farm_gpu",
                 ordered=True, n_emitters=1, config=None, role=Role.SEQ,
                 device=None, depth=None, use_reduce_kernel=False,
                 compute_dtype=None, use_resident=None, flush_rows=1 << 20,
                 max_delay_ms=None):
        self._raw_fn = winfunc
        self._dev_kw = dict(batch_len=batch_len, device=device, depth=depth,
                            use_reduce_kernel=use_reduce_kernel,
                            compute_dtype=compute_dtype,
                            use_resident=use_resident, flush_rows=flush_rows,
                            max_delay_ms=max_delay_ms)
        super().__init__(_host_standin(winfunc), win_len, slide_len, win_type,
                         pardegree=pardegree, name=name, ordered=ordered,
                         n_emitters=n_emitters, config=config, role=role)


class KeyFarmGPU(_DeviceCoreFactory, KeyFarm):
    """Key_Farm of device-batched window cores (key_farm_gpu.hpp:151-161):
    each worker keeps its keys resident on its own card."""

    def __init__(self, winfunc, win_len, slide_len, win_type=WinType.CB,
                 pardegree=2, batch_len=512, name="key_farm_gpu",
                 routing=None, config=None, role=Role.SEQ, device=None,
                 depth=None, use_reduce_kernel=False, compute_dtype=None,
                 use_resident=None, flush_rows=1 << 20, max_delay_ms=None):
        self._raw_fn = winfunc
        self._dev_kw = dict(batch_len=batch_len, device=device, depth=depth,
                            use_reduce_kernel=use_reduce_kernel,
                            compute_dtype=compute_dtype,
                            use_resident=use_resident, flush_rows=flush_rows,
                            max_delay_ms=max_delay_ms)
        super().__init__(_host_standin(winfunc), win_len, slide_len, win_type,
                         pardegree=pardegree, name=name, routing=routing,
                         config=config, role=role)


class PaneFarmGPU(PaneFarm):
    """Pane_Farm with per-stage device placement — the 4 constructor
    families of the reference's Pane_Farm_GPU (pane_farm_gpu.hpp:176-480)
    become two booleans; an incremental stage always runs on the host (the
    reference likewise pairs INC stages with host execution)."""

    def __init__(self, plq_func, wlq_func, win_len, slide_len,
                 win_type=WinType.CB, plq_degree=1, wlq_degree=1,
                 name="pane_farm_gpu", plq_on_device=True, wlq_on_device=True,
                 batch_len=512, device=None, depth=None,
                 use_reduce_kernel=False, compute_dtype=None,
                 use_resident=None, flush_rows=1 << 20, **kw):
        self._on_device = {"plq": plq_on_device, "wlq": wlq_on_device}
        self._dev_kw = dict(batch_len=batch_len, device=device, depth=depth,
                            use_reduce_kernel=use_reduce_kernel,
                            compute_dtype=compute_dtype,
                            use_resident=use_resident, flush_rows=flush_rows)
        super().__init__(plq_func, wlq_func, win_len, slide_len, win_type,
                         plq_degree=plq_degree, wlq_degree=wlq_degree,
                         name=name, **kw)

    def _make_stage(self, which, func, win, slide, wt, degree, name,
                    incremental, result_fields, ordered, role):
        if not self._on_device.get(which) or incremental:
            return super()._make_stage(which, func, win, slide, wt, degree,
                                       name, incremental, result_fields,
                                       ordered, role)
        cfg = self.config
        if degree > 1:
            return WinFarmGPU(func, win, slide, wt, pardegree=degree,
                              name=name, ordered=ordered, config=cfg,
                              role=role, **self._dev_kw)
        seq_cfg = PatternConfig(cfg.id_inner, cfg.n_inner, cfg.slide_inner,
                                0, 1, slide)
        return WinSeqGPU(func, win, slide, wt, name=name, config=seq_cfg,
                         role=role, **self._dev_kw)

    def clone_with(self, name, slide_len=None, config=None, ordered=False):
        kw = dict(self._proto)
        if slide_len is not None:
            kw["slide_len"] = slide_len
        return PaneFarmGPU(name=name, config=config, ordered=ordered,
                           plq_on_device=self._on_device["plq"],
                           wlq_on_device=self._on_device["wlq"],
                           **self._dev_kw, **kw)


class WinMapReduceGPU(WinMapReduce):
    """Win_MapReduce with per-stage device placement — the reference's
    Win_MapReduce_GPU (win_mapreduce_gpu.hpp:171-521); an incremental
    stage always runs on the host."""

    def __init__(self, map_func, reduce_func, win_len, slide_len,
                 win_type=WinType.CB, map_degree=2, reduce_degree=1,
                 name="win_mr_gpu", map_on_device=True,
                 reduce_on_device=False, batch_len=512, device=None,
                 depth=None, use_reduce_kernel=False, compute_dtype=None,
                 use_resident=None, flush_rows=1 << 20, max_delay_ms=None,
                 **kw):
        self._on_device = {"map": map_on_device, "reduce": reduce_on_device}
        self._dev_kw = dict(batch_len=batch_len, device=device, depth=depth,
                            use_reduce_kernel=use_reduce_kernel,
                            compute_dtype=compute_dtype,
                            use_resident=use_resident, flush_rows=flush_rows,
                            max_delay_ms=max_delay_ms)
        super().__init__(map_func, reduce_func, win_len, slide_len, win_type,
                         map_degree=map_degree, reduce_degree=reduce_degree,
                         name=name, **kw)

    def _make_map_stage(self, map_func, n, name, incremental, result_fields):
        from .win_mapreduce import _MapStage
        if not self._on_device["map"] or incremental:
            return super()._make_map_stage(map_func, n, name, incremental,
                                           result_fields)
        return _MapStage(_host_standin(map_func), self.spec, n, name, None,
                         result_fields, self.config, device_fn=map_func,
                         device_opts=self._dev_kw)

    def _make_reduce_stage(self, reduce_func, n, degree, name, incremental,
                           result_fields, ordered):
        if not self._on_device["reduce"] or incremental:
            return super()._make_reduce_stage(reduce_func, n, degree, name,
                                              incremental, result_fields,
                                              ordered)
        cfg = self.config
        if degree > 1:
            return WinFarmGPU(reduce_func, n, n, WinType.CB, pardegree=degree,
                              name=name, ordered=ordered, config=cfg,
                              role=Role.REDUCE, **self._dev_kw)
        red_cfg = PatternConfig(cfg.id_inner, cfg.n_inner, cfg.slide_inner,
                                0, 1, n)
        return WinSeqGPU(reduce_func, n, n, WinType.CB, name=name,
                         config=red_cfg, role=Role.REDUCE, **self._dev_kw)

    def clone_with(self, name, slide_len=None, config=None, ordered=False):
        kw = dict(self._proto)
        if slide_len is not None:
            kw["slide_len"] = slide_len
        return WinMapReduceGPU(name=name, config=config, ordered=ordered,
                               map_on_device=self._on_device["map"],
                               reduce_on_device=self._on_device["reduce"],
                               **self._dev_kw, **kw)
