"""Basic streaming patterns: Source, Map, Filter, FlatMap, Accumulator, Sink.

Functional parity with the reference L3a patterns (source.hpp, map.hpp,
filter.hpp, flatmap.hpp, accumulator.hpp, sink.hpp): every user-function
flavour — {itemized, loop} sources; {in-place, non-in-place} maps; plain and
"rich" (RuntimeContext-receiving) variants; optional keyed routing — plus a
`vectorized` flavour the reference cannot express: the user function operates
on the whole structure-of-arrays batch, which is the idiomatic form here and
the only one used on hot paths.

Each pattern class is a *node factory*: `replicas()` returns the worker
nodes, and `emitter()`/`collector()` the routing shell, which MultiPipe (or
a manual Dataflow) wires into a farm, mirroring the reference's
ff_farm(emitter, workers, collector) structure (map.hpp:196-209).
"""

from __future__ import annotations

import os
import sys
from functools import lru_cache
from time import perf_counter_ns as _pc_ns

import numpy as np

from ..core.tuples import INFO_FIELDS, MARKER_FIELD, Schema
from ..runtime.emitters import Collector, StandardEmitter, default_routing
from ..runtime.node import Node, RuntimeContext, SourceNode
from ..utils.profile import timeline_record as _tl_record
from ..utils.profile import timeline_stamp as _tl_stamp


class Shipper:
    """Push-many output handle for loop-sources and flatmaps
    (shipper.hpp:52-105), buffering rows into batches.

    Given a source's `stats` that keep operator states, it times each batch
    it pushes on (the stages fused after the source, or the put into the
    next inbox) into ``stats.push_ns_total``; the rest of the source's
    ``generate`` is the generator's own time (its ``pull``)."""

    def __init__(self, schema: Schema, emit_fn, chunk: int = 4096,
                 stats=None):
        self._schema = schema
        self._dtype = schema.dtype() if schema is not None else None
        self._emit = emit_fn
        self._chunk = chunk
        self._rows = []
        self.delivered = 0
        if stats is not None and not stats.states:
            stats = None
        self._stats = stats
        if stats is not None:
            stats.push_ns_total = 0
            self._pulled = _tl_stamp()   # the generator's turn since

    def push(self, key=0, id=0, ts=0, **payload):
        row = np.zeros((), dtype=self._dtype)
        row["key"], row["id"], row["ts"] = key, id, ts
        for k, v in payload.items():
            row[k] = v
        self._rows.append(row)
        self.delivered += 1
        if len(self._rows) >= self._chunk:
            self.flush()

    def push_batch(self, batch: np.ndarray):
        """Vectorised push of a whole pre-built batch."""
        self.flush()
        self.delivered += len(batch)
        self._push(batch)

    def flush(self):
        if self._rows:
            self._push(np.stack(self._rows))
            self._rows = []

    def _push(self, batch):
        st = self._stats
        if st is None:
            self._emit(batch)
            return
        if self._pulled is not None:
            _tl_record("pull", self._pulled)
        stamp = _tl_stamp()
        t0 = _pc_ns()
        self._emit(batch)
        st.push_ns_total += _pc_ns() - t0
        if stamp is not None:
            _tl_record("push", stamp)
        self._pulled = _tl_stamp()


_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def user_call_site() -> tuple[str, int] | None:
    """(filename, lineno) of the nearest stack frame OUTSIDE the
    windflow_tpu package — the line where user/app code constructed the
    pattern.  Static-analysis diagnostics (windflow_tpu/check/,
    docs/CHECKS.md) anchor there, and ``# wf-lint: disable=WF###`` on
    that line suppresses them.  Construction-time only — never on a hot
    path — and best-effort: None when everything on the stack is
    internal (e.g. tests driving patterns through framework helpers)."""
    pkg = _PKG_DIR + os.sep      # separator-guarded: a sibling dir whose
    apps = os.path.join(_PKG_DIR, "apps") + os.sep   # name merely shares
    f = sys._getframe(1)                             # the prefix is user code
    for _ in range(24):
        if f is None:
            return None
        fname = os.path.abspath(f.f_code.co_filename)
        # the bundled bench apps are *user* code for anchoring purposes
        if not fname.startswith(pkg) or fname.startswith(apps):
            return (f.f_code.co_filename, f.f_lineno)
        f = f.f_back
    return None


class _Pattern:
    """Common shell: parallelism + optional keyed routing."""

    def __init__(self, name, parallelism=1, routing=None):
        self.name = name
        self.parallelism = parallelism
        self.routing = routing  # vectorised fn(keys, n) -> dest
        #: construction-site anchor for check/ diagnostics
        self.anchor = user_call_site()

    def emitter(self):
        return StandardEmitter(self.parallelism, self.routing,
                               name=f"{self.name}.emitter")

    def collector(self):
        return Collector(name=f"{self.name}.collector")

    def replicas(self):
        return [self._make_replica(i) for i in range(self.parallelism)]

    def _make_replica(self, i) -> Node:
        raise NotImplementedError


# ----------------------------------------------------------------- Row moves
#
# numpy copies a structured array field by field; the Filter and the
# out-schema Map move their rows as whole rows of bytes instead, where the
# dtypes show that the bytes are exactly the fields.  Each plan is worked
# out on a dtype's first batch and cached.

#: the header every Schema's rows start with, in this order (core/tuples.py)
_HEADER = INFO_FIELDS + (MARKER_FIELD,)


def _gapless(dt: np.dtype) -> bool:
    """Every byte of `dt` belongs to exactly one field (recursively): no
    padding, no overlap, no object."""
    if dt.subdtype is not None:
        return _gapless(dt.subdtype[0])
    if dt.names is None:
        return not dt.hasobject
    end = 0
    for fd, off in sorted((dt.fields[n][:2] for n in dt.names),
                          key=lambda f: f[1]):
        if off != end or not _gapless(fd):
            return False
        end = off + fd.itemsize
    return end == dt.itemsize


@lru_cache(maxsize=64)
def _row_type(dt: np.dtype):
    """The void dtype of one row of `dt`, where copying a row's bytes is
    copying its fields; None where not (no fields, padding, objects)."""
    if dt.names is None or not _gapless(dt):
        return None
    return np.dtype((np.void, dt.itemsize))


@lru_cache(maxsize=64)
def _header_types(src: np.dtype, dst: np.dtype):
    """(source view, output view): dtypes of one field ``h``, the bytes of
    the Schema header (key, id, ts, marker) at the start of a row of `src`
    and of `dst`, a Schema's dtype.  None unless `src` gives the header
    fields the types and offsets `dst` gives them, and neither holds
    objects."""
    if src.names is None or src.hasobject or dst.hasobject or any(
            src.fields.get(f, (None,))[:2] != dst.fields[f][:2]
            for f in _HEADER):
        return None
    head = (np.void, sum(dst.fields[f][0].itemsize for f in _HEADER))
    return tuple(np.dtype({"names": ["h"], "formats": [head], "offsets": [0],
                           "itemsize": dt.itemsize}) for dt in (src, dst))


def _moves_of(node):
    """The node's ``[by bytes, by fields]`` counter in its node log, or
    None where no node log is written."""
    st = node.stats
    return st.moves_of(node.name) if st is not None and st.states else None


# --------------------------------------------------------------------- Source

class _ItemizedSourceNode(SourceNode):
    """Itemized source: fn(shipper-row emit) -> bool continue
    (source.hpp:59-65, itemized flavour fn(tuple&)->bool)."""

    yields_fresh = True   # every emission is a fresh np.stack

    def __init__(self, fn, schema, name, rich, chunk=4096):
        super().__init__(name)
        self.fn = fn
        self.schema = schema
        self.rich = rich
        self.chunk = chunk

    def generate(self):
        dtype = self.schema.dtype()
        shipper = Shipper(None, self.emit, stats=self.stats)
        rows = []
        alive = True
        while alive:
            row = np.zeros((), dtype=dtype)
            alive = (self.fn(row, self.ctx) if self.rich else self.fn(row))
            rows.append(row)
            if len(rows) >= self.chunk or not alive:
                shipper._push(np.stack(rows))
                rows = []


class _LoopSourceNode(SourceNode):
    """Loop source: fn(Shipper) called once (source.hpp:134-144)."""

    def __init__(self, fn, schema, name, rich, chunk=4096):
        super().__init__(name)
        self.fn = fn
        self.schema = schema
        self.rich = rich
        self.chunk = chunk

    def generate(self):
        shipper = Shipper(self.schema, self.emit, self.chunk,
                          stats=self.stats)
        if self.rich:
            self.fn(shipper, self.ctx)
        else:
            self.fn(shipper)
        shipper.flush()


class _BatchSourceNode(SourceNode):
    """Vectorised source: an iterable of ready-made batches."""

    def __init__(self, batches, name):
        super().__init__(name)
        self.batches = batches

    def generate(self):
        shipper = Shipper(None, self.emit, stats=self.stats)
        for b in self.batches:
            shipper._push(b)


class Source(_Pattern):
    def __init__(self, fn=None, schema: Schema = None, parallelism=1,
                 name="source", rich=False, itemized=False, batches=None,
                 chunk=4096, fresh=False):
        super().__init__(name, parallelism)
        self.fn = fn
        self.schema = schema
        self.rich = rich
        self.itemized = itemized
        self.batches = batches
        self.chunk = chunk
        #: app declaration (node.py ownership protocol): every batch the
        #: generator pushes / the iterable yields is transfer-owned — the
        #: app never touches it again, so fused downstream stages may
        #: mutate it in place instead of copying
        self.fresh = fresh

    def _make_replica(self, i):
        ctx = RuntimeContext(self.parallelism, i, self.name)
        if self.batches is not None:
            src = self.batches(i) if callable(self.batches) else self.batches
            node = _BatchSourceNode(src, f"{self.name}.{i}")
            node.yields_fresh = bool(self.fresh)
        elif self.itemized:
            node = _ItemizedSourceNode(self.fn, self.schema, f"{self.name}.{i}",
                                       self.rich, self.chunk)
        else:
            node = _LoopSourceNode(self.fn, self.schema, f"{self.name}.{i}",
                                   self.rich, self.chunk)
            node.yields_fresh = bool(self.fresh)
        node.ctx = ctx
        return node

    def emitter(self):
        return None  # sources have no input side


# ----------------------------------------------------------------------- Map

class _MapNode(Node):
    shed_safe = True   # stateless operator: shedding drops stream rows
    recoverable = True  # stateless: supervised restart needs no snapshot
    #: always true: emits either its private copy, a fresh out-schema
    #: array, or (elided path) an input batch that was itself handed off
    yields_fresh = True

    #: the output dtype and the input dtype last seen, with its header
    #: plan (``_header_types``)
    _out_dtype = _seen = _plan = None
    #: [batches by bytes, by fields] where the node log is written
    _moves = None

    def __init__(self, fn, name, rich, vectorized, out_schema):
        super().__init__(name)
        self.fn = fn
        self.rich = rich
        self.vectorized = vectorized
        self.out_schema = out_schema  # None => in-place

    def svc_init(self):
        if self.out_schema is not None:
            self._moves = _moves_of(self)

    def _new_rows(self, batch):
        """The output batch: zeros, but for the header copied from
        `batch`'s rows, as one block of bytes a row where the dtypes
        allow it (``_header_types``)."""
        odt = self._out_dtype
        if odt is None:
            odt = self._out_dtype = self.out_schema.dtype()
        if batch.dtype is not self._seen:
            self._seen = batch.dtype
            self._plan = _header_types(batch.dtype, odt)
        out = np.zeros(len(batch), dtype=odt)
        plan = self._plan
        if plan is None:
            for f in _HEADER:
                out[f] = batch[f]
        else:
            out.view(plan[1])["h"] = batch.view(plan[0])["h"]
        if self._moves is not None:
            self._moves[plan is None] += 1
        return out

    def svc(self, batch, channel=0):
        args = (self.ctx,) if self.rich else ()
        if self.out_schema is None:
            # in-place semantics (map.hpp:141): on a handed-off batch the
            # runtime proved nobody else holds (input_fresh, node.py
            # ownership protocol) mutate directly; otherwise on a private
            # copy.  The copy was 0.26 s of the 8M-row pipe benchmark.
            out = batch if self.input_fresh else batch.copy()
            if self.vectorized:
                self.fn(out, *args)
            else:
                for row in out:
                    self.fn(row, *args)
        else:
            out = self._new_rows(batch)
            if self.vectorized:
                self.fn(batch, out, *args)
            else:
                for i in range(len(batch)):
                    self.fn(batch[i], out[i], *args)
        self.emit(out)


class Map(_Pattern):
    """Map: in-place fn(row) / non-in-place fn(in_row, out_row), plain or
    rich or vectorized (whole-batch), optional keyed routing
    (map.hpp:60-68)."""

    def __init__(self, fn, parallelism=1, name="map", rich=False,
                 vectorized=False, output_schema: Schema = None, routing=None,
                 keyed=False):
        if keyed and routing is None:
            routing = default_routing
        super().__init__(name, parallelism, routing)
        self.fn = fn
        self.rich = rich
        self.vectorized = vectorized
        self.output_schema = output_schema

    def _make_replica(self, i):
        node = _MapNode(self.fn, f"{self.name}.{i}", self.rich,
                        self.vectorized, self.output_schema)
        node.ctx = RuntimeContext(self.parallelism, i, self.name)
        return node


# -------------------------------------------------------------------- Filter

class _FilterNode(Node):
    shed_safe = True   # stateless operator: shedding drops stream rows
    recoverable = True  # stateless: supervised restart needs no snapshot
    #: the surviving-rows gather is a fresh allocation every time
    yields_fresh = True
    #: the input dtype last seen and its row type (``_row_type``)
    _seen = _rows = None
    #: [batches by bytes, by fields] where the node log is written
    _moves = None

    def __init__(self, fn, name, rich, vectorized):
        super().__init__(name)
        self.fn = fn
        self.rich = rich
        self.vectorized = vectorized

    def svc_init(self):
        self._moves = _moves_of(self)

    def svc(self, batch, channel=0):
        args = (self.ctx,) if self.rich else ()
        if self.vectorized:
            mask = np.asarray(self.fn(batch, *args), dtype=bool)
        else:
            mask = np.fromiter((bool(self.fn(row, *args)) for row in batch),
                               dtype=bool, count=len(batch))
        if batch.dtype is not self._seen:
            self._seen = batch.dtype
            self._rows = _row_type(batch.dtype)
        rows = self._rows
        # an ndarray subclass keeps its type, a mask of another shape its
        # IndexError, on the field path
        if rows is None or type(batch) is not np.ndarray \
                or mask.shape != batch.shape:
            rows = None
            out = batch[mask]
        else:
            # the survivors' bytes, a row at a time
            out = batch.view(rows).take(np.flatnonzero(mask)).view(
                batch.dtype)
        if self._moves is not None:
            self._moves[rows is None] += 1
        if len(out):
            self.emit(out)


class Filter(_Pattern):
    """Filter: drop rows where fn is false (filter.hpp:59-61)."""

    def __init__(self, fn, parallelism=1, name="filter", rich=False,
                 vectorized=False, routing=None, keyed=False):
        if keyed and routing is None:
            routing = default_routing
        super().__init__(name, parallelism, routing)
        self.fn = fn
        self.rich = rich
        self.vectorized = vectorized

    def _make_replica(self, i):
        node = _FilterNode(self.fn, f"{self.name}.{i}", self.rich,
                           self.vectorized)
        node.ctx = RuntimeContext(self.parallelism, i, self.name)
        return node


# ------------------------------------------------------------------- FlatMap

class _FlatMapNode(Node):
    shed_safe = True   # stateless operator: shedding drops stream rows
    #: the shipper flushes per input batch, so between svc calls (where
    #: epoch snapshots happen) there is no state to capture
    recoverable = True

    def __init__(self, fn, name, rich, vectorized, out_schema, chunk):
        super().__init__(name)
        self.fn = fn
        self.rich = rich
        self.vectorized = vectorized
        self.out_schema = out_schema
        self.chunk = chunk
        self._shipper = None

    def svc_init(self):
        self._shipper = Shipper(self.out_schema, self.emit, self.chunk)

    def svc(self, batch, channel=0):
        args = (self.ctx,) if self.rich else ()
        if self.vectorized:
            self.fn(batch, self._shipper, *args)
        else:
            for row in batch:
                self.fn(row, self._shipper, *args)
        # flush per input batch to bound latency (one-to-any, flatmap.hpp:61)
        self._shipper.flush()


class FlatMap(_Pattern):
    """FlatMap: fn(row, shipper) pushing 0..n rows per input
    (flatmap.hpp:61-63)."""

    def __init__(self, fn, output_schema: Schema, parallelism=1,
                 name="flatmap", rich=False, vectorized=False, routing=None,
                 keyed=False, chunk=4096):
        if keyed and routing is None:
            routing = default_routing
        super().__init__(name, parallelism, routing)
        self.fn = fn
        self.rich = rich
        self.vectorized = vectorized
        self.output_schema = output_schema
        self.chunk = chunk

    def _make_replica(self, i):
        node = _FlatMapNode(self.fn, f"{self.name}.{i}", self.rich,
                            self.vectorized, self.output_schema, self.chunk)
        node.ctx = RuntimeContext(self.parallelism, i, self.name)
        return node


# --------------------------------------------------------------- Accumulator

class _AccumulatorNode(Node):
    shed_safe = True   # keyed fold: shedding drops rows, no dense-id need
    recoverable = True          # per-key fold state deep-copies cleanly
    state_attrs = ("_keys",)    # key -> accumulator record

    def __init__(self, fn, init_value, result_schema, name, rich,
                 vectorized=False):
        super().__init__(name)
        self.fn = fn
        self.init_value = init_value
        self.result_schema = result_schema
        self.rich = rich
        self.vectorized = vectorized
        self._keys = {}

    def _acc(self, key: int):
        acc = self._keys.get(key)
        if acc is None:
            acc = np.zeros((), dtype=self.result_schema.dtype())
            acc["key"] = key
            for f, v in (self.init_value or {}).items():
                acc[f] = v
            self._keys[key] = acc
        return acc

    # keyed-state migration (control plane live rescale, docs/CONTROL.md):
    # the fold state is a plain key -> record dict, so fragments move
    # verbatim between sibling replicas of one keyed farm
    keyed_migratable = True

    def keyed_state_keys(self):
        if not self._keys:
            return np.zeros(0, dtype=np.int64)
        return np.fromiter(self._keys.keys(), dtype=np.int64,
                           count=len(self._keys))

    def keyed_state_export(self, keys):
        return {"kind": "accumulator",
                "keys": {int(k): self._keys.pop(int(k)) for k in keys}}

    def keyed_state_import(self, frag):
        if frag["kind"] != "accumulator":
            raise TypeError(f"cannot import {frag['kind']!r} state into "
                            f"{type(self).__name__}")
        self._keys.update(frag["keys"])

    def svc(self, batch, channel=0):
        if len(batch) == 0:
            return
        out = np.zeros(len(batch), dtype=self.result_schema.dtype())
        args = (self.ctx,) if self.rich else ()
        # group rows by key once (sorted contiguous slices): one state
        # lookup per distinct key per chunk instead of per row
        from ..core.tuples import group_by_key
        keys = batch["key"]
        order, starts, ends = group_by_key(keys)
        sk = keys[order]
        for s, e in zip(starts, ends):
            idx = order[s:e]
            acc = self._acc(int(sk[s]))
            rows = batch[idx]
            if self.vectorized:
                # vectorised fold: fn(rows, acc) -> per-row snapshots of
                # the result fields (len(rows) records)
                out[idx] = self.fn(rows, acc, *args)
            else:
                for j, row in zip(idx, rows):
                    self.fn(row, acc, *args)
                    out[j] = acc  # emit a copy of the running result
        # each snapshot carries the header of the row that triggered it
        # (per-key ts order is preserved for downstream consumers)
        for f in ("key", "id", "ts"):
            out[f] = batch[f]
        self.emit(out)


class Accumulator(_Pattern):
    """Keyed rolling reduce/fold: per-key state initialised to `init_value`,
    fn(row, acc) mutates it, a copy of the state is emitted per input row
    (accumulator.hpp:157-193). Always keyed (Accumulator_Emitter,
    accumulator.hpp:50-85)."""

    def __init__(self, fn, result_schema: Schema, init_value: dict = None,
                 parallelism=1, name="accumulator", rich=False, routing=None,
                 vectorized=False):
        super().__init__(name, parallelism, routing or default_routing)
        self.fn = fn
        self.result_schema = result_schema
        self.init_value = init_value
        self.rich = rich
        #: vectorised flavour: fn(rows, acc) folds one key's chunk rows
        #: into acc and returns len(rows) per-row result snapshots
        self.vectorized = vectorized

    def _make_replica(self, i):
        node = _AccumulatorNode(self.fn, self.init_value, self.result_schema,
                                f"{self.name}.{i}", self.rich,
                                vectorized=self.vectorized)
        node.ctx = RuntimeContext(self.parallelism, i, self.name)
        return node


# ---------------------------------------------------------------------- Sink

class _SinkNode(Node):
    shed_safe = True   # terminal: shedding drops deliveries only
    #: NOT restartable by default: a sink has no downstream to dedup the
    #: journal replay, so a restarted sink would re-fire already-
    #: delivered rows into the user's (possibly irreversible) side
    #: effects.  Idempotent sinks opt in per pattern
    #: (``sink_pattern.recoverable = True``, propagated by farm.py).
    recoverable = False

    def __init__(self, fn, name, rich, vectorized):
        super().__init__(name)
        self.fn = fn
        self.rich = rich
        self.vectorized = vectorized

    def svc(self, batch, channel=0):
        args = (self.ctx,) if self.rich else ()
        if self.vectorized:
            self.fn(batch, *args)
        else:
            for row in batch:
                self.fn(row, *args)

    def eosnotify(self):
        # the reference signals stream end with an empty optional
        # (sink.hpp:118); here: one call with None (vectorized sinks get it
        # too — the fn must treat None as the end-of-stream signal)
        args = (self.ctx,) if self.rich else ()
        self.fn(None, *args)


class Sink(_Pattern):
    """Sink: fn(row) per tuple and fn(None) at EOS (sink.hpp:63-65)."""

    def __init__(self, fn, parallelism=1, name="sink", rich=False,
                 vectorized=False, routing=None, keyed=False):
        if keyed and routing is None:
            routing = default_routing
        super().__init__(name, parallelism, routing)
        self.fn = fn
        self.rich = rich
        self.vectorized = vectorized

    def _make_replica(self, i):
        node = _SinkNode(self.fn, f"{self.name}.{i}", self.rich,
                         self.vectorized)
        node.ctx = RuntimeContext(self.parallelism, i, self.name)
        return node

    def collector(self):
        return None  # sinks have no output side
