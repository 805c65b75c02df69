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

This module holds the restaging path only.  The routes that the JAX package
sends to its resident, native-resident and mesh cores raise
``NotImplementedError`` naming the ROADMAP.md slice that brings them; user
window functions over the device batch (``JaxWindowFunction``) and the
device farms come in later slices too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.tuples import Schema
from ..core.windows import PatternConfig, Role, WindowSpec, WinType
from ..core.winseq import WinSeqCore
from ..ops.device import DeviceWindowExecutor
from ..ops.functions import MultiReducer, Reducer
from ..runtime.node import RuntimeContext
from .basic import _Pattern
from .win_seq import WinSeqNode

_RESIDENT_SLICE = ("the resident device path (ops/resident.py, "
                   "patterns/native_core.py) is ROADMAP.md Queue 1 slice 2, "
                   "not ported yet")


def resolve_worker_device(device, i: int) -> torch.device:
    """Per-worker device placement — farm worker *i* owns a card the way
    each reference GPU worker owns a CUDA stream/device
    (win_farm_gpu.hpp:132-168, win_seq_gpu.hpp:271-306).

    ``None`` spreads workers round-robin over the visible CUDA devices and
    raises ``RuntimeError`` when there is none (it never falls back to the
    CPU: pass ``device="cpu"`` to run the kernels' plain versions); a
    list/tuple spreads over exactly those devices; a single device pins
    every worker to it."""
    if isinstance(device, (list, tuple)):
        return torch.device(device[i % len(device)])
    if device is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "no CUDA device: the device path runs on the card; pass "
                "device='cpu' explicitly to run it on the host")
        return torch.device(f"cuda:{i % n}")
    return torch.device(device)


def _host_standin(winfunc):
    """Host-side function object carrying the result schema for the
    core/farm template plumbing (the device path never calls it)."""
    if isinstance(winfunc, Reducer):
        return winfunc
    raise TypeError(
        "the device path needs a builtin Reducer (host Python functions "
        "cannot be staged to the GPU — same restriction as the reference's "
        "__device__ functor contract; user device functions are not ported "
        "yet)")


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
                           (hi - lo).astype(np.int64)))
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
        starts, lens = [], []
        off = 0
        for cols, s, l in self._segs:
            for f in self._stage_fields:
                flat[f].append(cols[f])
            starts.append(s + off)
            lens.append(l)
            off += len(next(iter(cols.values()))) if cols else 0
        flat = {f: np.concatenate(v) for f, v in flat.items()}
        self.executor.launch(list(self._hdr), flat, np.concatenate(starts),
                             np.concatenate(lens))
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


#: reducer ops the JAX package evaluates on its resident path (count
#: carries no device work and routes to the HOST core via _host_free)
_RESIDENT_OPS = ("sum", "min", "max", "prod")


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
                  compute_dtype=None, use_resident=None, worker_index=0,
                  mesh=None):
    """Choose the core implementation with the JAX package's routing
    (win_seq_tpu.py:make_core_for): host-free aggregates go to the host
    core; builtin monoids the resident executor evaluates go to the
    resident core (not ported yet: raises); everything else, and any
    Reducer with ``use_reduce_kernel=True``, goes to the restaging core.
    The resident path's own knobs (``flush_rows``, ``shards``,
    ``max_delay_ms`` and its budget routing) come with that path."""
    def _host_core():
        from .win_seq import WinSeq
        return WinSeq(winfunc, spec.win_len, spec.slide_len,
                      spec.win_type, config=config, role=role,
                      map_indexes=map_indexes,
                      result_ts_slide=result_ts_slide).make_core()

    if (isinstance(winfunc, (Reducer, MultiReducer))
            and use_resident is None and mesh is None
            and (isinstance(winfunc, MultiReducer) or not use_reduce_kernel)
            and _host_free(spec, winfunc)):
        # every stat is answerable from host bookkeeping — shipping the
        # column to the device buys nothing but copies.  use_resident=True
        # forces the device; a Reducer with use_reduce_kernel=True keeps
        # the restaging path (benchmarking).
        return _host_core()
    if isinstance(winfunc, MultiReducer):
        # multi-stat windows are resident-only in the JAX package
        if use_resident is False or not _multi_resident_ok(
                winfunc, use_reduce_kernel):
            raise ValueError(
                "MultiReducer runs on the resident device path only: "
                "needs >=1 non-count stat, ops in "
                f"{_RESIDENT_OPS}, no float sum (got {winfunc.parts})")
        raise NotImplementedError(f"MultiReducer: {_RESIDENT_SLICE}")
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
        raise NotImplementedError(
            "mesh execution: multi-GPU is ROADMAP.md Queue 1 slice 8, not "
            "ported yet")
    if resident:
        raise NotImplementedError(
            f"{_RESIDENT_SLICE}; pass use_reduce_kernel=True for the "
            "restaging path and its windowed-reduce kernel")
    return DeviceWinSeqCore(
        spec, winfunc, batch_len=batch_len, config=config, role=role,
        map_indexes=map_indexes, result_ts_slide=result_ts_slide,
        device=resolve_worker_device(device, worker_index),
        depth=depth if depth is not None else 4,
        compute_dtype=compute_dtype)


class WinSeqGPU(_Pattern):
    """Sequential GPU window pattern (reference Win_Seq_GPU builder shape:
    withBatch(batch_len) replaces withBatch(batch_len, n_thread_block)).

    ``use_reduce_kernel`` is the counterpart of the JAX package's
    ``use_pallas``: it pins a builtin Reducer to the restaging path, whose
    fired window batches the hand-written windowed-reduce kernel
    evaluates.  ``device=None`` places the core on ``cuda:0`` (and raises
    without CUDA); ``device="cpu"`` runs the kernel's plain version."""

    def __init__(self, winfunc, win_len, slide_len, win_type=WinType.CB,
                 batch_len=512, name="win_seq_gpu",
                 config: PatternConfig = None, role: Role = Role.SEQ,
                 map_indexes=(0, 1), result_ts_slide=None, device=None,
                 depth=None, use_reduce_kernel=False, compute_dtype=None,
                 use_resident=None, mesh=None):
        super().__init__(name, parallelism=1)
        self.spec = WindowSpec(win_len, slide_len, win_type)
        self._kw = dict(batch_len=batch_len, config=config, role=role,
                        map_indexes=map_indexes,
                        result_ts_slide=result_ts_slide, device=device,
                        depth=depth, use_reduce_kernel=use_reduce_kernel,
                        compute_dtype=compute_dtype,
                        use_resident=use_resident, mesh=mesh)
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
