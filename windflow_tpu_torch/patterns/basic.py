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

import numpy as np

from ..core.tuples import MARKER_FIELD, Schema
from ..runtime.emitters import Collector, StandardEmitter, default_routing
from ..runtime.node import Node, RuntimeContext, SourceNode


class Shipper:
    """Push-many output handle for loop-sources and flatmaps
    (shipper.hpp:52-105), buffering rows into batches."""

    def __init__(self, schema: Schema, emit_fn, chunk: int = 4096):
        self._schema = schema
        self._dtype = schema.dtype()
        self._emit = emit_fn
        self._chunk = chunk
        self._rows = []
        self.delivered = 0

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
        self._emit(batch)

    def flush(self):
        if self._rows:
            self._emit(np.stack(self._rows))
            self._rows = []


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
        rows = []
        alive = True
        while alive:
            row = np.zeros((), dtype=dtype)
            alive = (self.fn(row, self.ctx) if self.rich else self.fn(row))
            rows.append(row)
            if len(rows) >= self.chunk or not alive:
                self.emit(np.stack(rows))
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
        shipper = Shipper(self.schema, self.emit, self.chunk)
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
        for b in self.batches:
            self.emit(b)


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

    def __init__(self, fn, name, rich, vectorized, out_schema):
        super().__init__(name)
        self.fn = fn
        self.rich = rich
        self.vectorized = vectorized
        self.out_schema = out_schema  # None => in-place

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
            out = np.zeros(len(batch), dtype=self.out_schema.dtype())
            for f in ("key", "id", "ts", MARKER_FIELD):
                out[f] = batch[f]
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

    def __init__(self, fn, name, rich, vectorized):
        super().__init__(name)
        self.fn = fn
        self.rich = rich
        self.vectorized = vectorized

    def svc(self, batch, channel=0):
        args = (self.ctx,) if self.rich else ()
        if self.vectorized:
            mask = np.asarray(self.fn(batch, *args), dtype=bool)
        else:
            mask = np.fromiter((bool(self.fn(row, *args)) for row in batch),
                               dtype=bool, count=len(batch))
        out = batch[mask]
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
