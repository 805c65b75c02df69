"""Fluent builders — the 16 builder classes of the reference's
``builders.hpp`` (Source_Builder:57 ... Sink_Builder:2186), a copy of
``windflow_tpu/api/builders.py`` for the PyTorch/CUDA port, where the five
device builders keep the reference's own ``*GPU_Builder`` names.

Differences forced by the platform, mirroring the pattern layer:

* the reference deduces functor flavour (plain/rich, NIC/INC) from the C++
  signature (meta_utils.hpp:47-259); Python has no signatures to deduce
  from, so flavour is explicit: ``withRich()``, ``incremental()``,
  ``vectorized()``;
* window result payloads need declared dtypes: ``withResultFields``
  (C++ gets this from the result template parameter);
* ``withBatch(batch_len, n_thread_block)``'s second argument was the CUDA
  thread-block size of the user's functor — accepted and ignored here
  (the port's hand-written kernels choose their own blocks);
  ``withScratchpad`` likewise only matters to raw CUDA functors and is
  accepted for source compatibility with a warning;
* ``withOpt(level)`` drives real graph surgery on the two-stage patterns
  (Pane_Farm / Win_MapReduce): LEVEL1 fuses the internal
  collector/emitter boundary into one thread, LEVEL2 removes it entirely
  and merges at OrderingCore-fronted stage-2 workers
  (runtime/farm.py:fuse_two_stage — optimize_PaneFarm,
  pane_farm.hpp:426-466).  For single-farm patterns the engine already
  fuses pass-through shells automatically and ``chain()`` on MultiPipe is
  the explicit fusion path, so the level is advisory there.
"""

from __future__ import annotations

import warnings

from ..core.windows import WinType
from ..patterns.basic import (Accumulator, Filter, FlatMap, Map, Sink,
                              Source)
from ..patterns.key_farm import KeyFarm
from ..patterns.nesting import KeyFarmOf, WinFarmOf
from ..patterns.pane_farm import PaneFarm
from ..patterns.win_farm import WinFarm
from ..patterns.win_mapreduce import WinMapReduce
from ..patterns.win_seq import WinSeq
from ..patterns.win_seq_gpu import (KeyFarmGPU, PaneFarmGPU, WinFarmGPU,
                                    WinMapReduceGPU, WinSeqGPU)

LEVEL0, LEVEL1, LEVEL2 = 0, 1, 2  # opt_level_t (basic.hpp:94)


class _Builder:
    """Shared fluent machinery: every option mutates and returns self;
    ``build()`` constructs the pattern (build_ptr/build_unique are aliases
    of the reference API — Python has one object model)."""

    _pattern_cls = None

    def __init__(self):
        self._kw = {}

    def withName(self, name: str):
        self._kw["name"] = name
        return self

    def _build_kw(self) -> dict:
        return dict(self._kw)

    def build(self):
        return self._pattern_cls(**self._build_kw())

    build_ptr = build
    build_unique = build


class _ParallelMixin:
    def withParallelism(self, n: int):
        self._kw["parallelism"] = int(n)
        return self


class _RichMixin:
    def withRich(self):
        """Mark the functor as RuntimeContext-receiving (the reference's
        rich variants, e.g. map.hpp:64-68).  Beyond parallelism/index,
        the context carries the dataflow's live metrics registry when
        observability is on (``MultiPipe(metrics=…/sample_period=…)``,
        docs/OBSERVABILITY.md): a rich functor may record custom
        counters/histograms via ``ctx.metrics`` (None when off)."""
        self._kw["rich"] = True
        return self


class _KeyByMixin:
    def keyBy(self, routing=None):
        """Keyed routing (builders.hpp:190,299,408); default ``key % n``."""
        from ..runtime.emitters import default_routing
        self._kw["routing"] = routing or default_routing
        return self


class _VectorizedMixin:
    def vectorized(self, flag: bool = True):
        """Whole-batch user function — the batch-idiomatic flavour the
        reference cannot express."""
        self._kw["vectorized"] = flag
        return self


class _ErrorBudgetMixin:
    """Poison-tuple quarantine knob (runtime/overload.py, no reference
    analog — FastFlow tears the farm down on any svc error).  Applies to
    the operator's worker replicas; stamped on the built pattern and
    propagated per node by runtime/farm.py."""

    def withErrorBudget(self, n: int):
        """Allow each replica to quarantine up to `n` failing batches to
        the dataflow's dead-letter queue before failing fast."""
        n = int(n)
        if n < 0:
            raise ValueError("error budget must be >= 0")
        self._error_budget = n
        return self

    def build(self):
        pattern = super().build()
        budget = getattr(self, "_error_budget", None)
        if budget is not None:
            pattern.error_budget = budget
        return pattern

    build_ptr = build
    build_unique = build


# ------------------------------------------------------------ basic patterns

class Source_Builder(_Builder, _ParallelMixin, _RichMixin):
    """builders.hpp:57."""
    _pattern_cls = Source

    def __init__(self, fn=None):
        super().__init__()
        self._kw["fn"] = fn

    def withSchema(self, schema):
        self._kw["schema"] = schema
        return self

    def withBatches(self, batches):
        """Pre-built structured-array batches (or replica-index -> batches
        callable) instead of a generator function."""
        self._kw["batches"] = batches
        return self

    def itemized(self):
        """bool(tuple&) flavour (source.hpp:59): fn fills one row dict and
        returns False at end-of-stream."""
        self._kw["itemized"] = True
        return self

    def withChunk(self, n: int):
        self._kw["chunk"] = int(n)
        return self


class Filter_Builder(_ErrorBudgetMixin, _Builder, _ParallelMixin,
                     _RichMixin, _KeyByMixin, _VectorizedMixin):
    """builders.hpp:139."""
    _pattern_cls = Filter

    def __init__(self, fn):
        super().__init__()
        self._kw["fn"] = fn


class Map_Builder(_ErrorBudgetMixin, _Builder, _ParallelMixin, _RichMixin,
                  _KeyByMixin, _VectorizedMixin):
    """builders.hpp:247."""
    _pattern_cls = Map

    def __init__(self, fn):
        super().__init__()
        self._kw["fn"] = fn

    def withOutputSchema(self, schema):
        """Non-in-place Map producing a different tuple type
        (map.hpp:63-68)."""
        self._kw["output_schema"] = schema
        return self


class FlatMap_Builder(_ErrorBudgetMixin, _Builder, _ParallelMixin,
                      _RichMixin, _KeyByMixin, _VectorizedMixin):
    """builders.hpp:356."""
    _pattern_cls = FlatMap

    def __init__(self, fn):
        super().__init__()
        self._kw["fn"] = fn

    def withOutputSchema(self, schema):
        self._kw["output_schema"] = schema
        return self


class Accumulator_Builder(_ErrorBudgetMixin, _Builder, _ParallelMixin,
                          _RichMixin):
    """builders.hpp:465."""
    _pattern_cls = Accumulator

    def __init__(self, fn):
        super().__init__()
        self._kw["fn"] = fn

    def withInitialValue(self, init: dict):
        self._kw["init_value"] = dict(init)
        return self

    def withResultSchema(self, schema):
        self._kw["result_schema"] = schema
        return self

    def withRouting(self, routing):
        self._kw["routing"] = routing
        return self


class Sink_Builder(_ErrorBudgetMixin, _Builder, _ParallelMixin, _RichMixin,
                   _KeyByMixin, _VectorizedMixin):
    """builders.hpp:2186."""
    _pattern_cls = Sink

    def __init__(self, fn):
        super().__init__()
        self._kw["fn"] = fn


# --------------------------------------------------------- windowed patterns

class _WindowMixin:
    def withCBWindow(self, win_len: int, slide_len: int):
        self._kw["win_len"] = int(win_len)
        self._kw["slide_len"] = int(slide_len)
        self._kw["win_type"] = WinType.CB
        return self

    def withTBWindow(self, win_us: int, slide_us: int):
        """Time-based window; extents in the stream's `ts` units (the
        reference takes std::chrono microseconds)."""
        self._kw["win_len"] = int(win_us)
        self._kw["slide_len"] = int(slide_us)
        self._kw["win_type"] = WinType.TB
        return self

    def incremental(self, flag: bool = True):
        """INC (per-tuple fold) flavour; default NIC (win_seq.hpp:116)."""
        self._kw["incremental"] = flag
        return self

    def withResultFields(self, fields: dict):
        self._kw["result_fields"] = dict(fields)
        return self

    def withOpt(self, level: int):
        """Graph-optimization level (opt_level_t, basic.hpp:94).  Two-stage
        patterns (Pane_Farm / Win_MapReduce) honour it: LEVEL1 fuses the
        stage boundary into one thread, LEVEL2 removes the internal
        collector and merges at OrderingCore-fronted stage-2 workers
        (optimize_PaneFarm, pane_farm.hpp:426-466).  For single-farm
        patterns the engine's chaining already provides the LEVEL1
        fusion, so the level is advisory there."""
        self._opt_level = level
        return self


class _WinParMixin:
    def withParallelism(self, n: int):
        self._kw["pardegree"] = int(n)
        return self


class WinSeq_Builder(_Builder, _WindowMixin):
    """builders.hpp:579."""
    _pattern_cls = WinSeq

    def __init__(self, winfunc):
        super().__init__()
        self._kw["winfunc"] = winfunc


class _NestingMixin:
    """Shared nesting acceptance of WinFarm/KeyFarm builders: the input may
    be a window function OR a Pane_Farm / Win_MapReduce instance
    (Constructor III/IV of win_farm.hpp; initWindowConf,
    builders.hpp:1210-1234).  Subclasses set `_nested_cls` and may override
    `_nested_kw` to add routing etc."""

    _nested_cls = None

    def __init__(self, input_):
        super().__init__()
        self._input = input_
        if not isinstance(input_, (PaneFarm, WinMapReduce)):
            self._kw["winfunc"] = input_

    def withOrdered(self, flag: bool = True):
        self._kw["ordered"] = flag
        return self

    def _nested_kw(self) -> dict:
        return dict(pardegree=self._kw.get("pardegree", 2),
                    ordered=self._kw.get("ordered", True),
                    name=self._kw.get("name",
                                      self._nested_cls.__name__.lower()))

    def build(self):
        if isinstance(self._input, (PaneFarm, WinMapReduce)):
            return self._nested_cls(self._input, **self._nested_kw())
        return _Builder.build(self)

    build_ptr = build
    build_unique = build


class WinFarm_Builder(_NestingMixin, _Builder, _WindowMixin, _WinParMixin):
    """builders.hpp:803."""
    _pattern_cls = WinFarm
    _nested_cls = WinFarmOf

    def withEmitters(self, n: int):
        self._kw["n_emitters"] = int(n)
        return self


class KeyFarm_Builder(_NestingMixin, _Builder, _WindowMixin, _WinParMixin):
    """builders.hpp:1193."""
    _pattern_cls = KeyFarm
    _nested_cls = KeyFarmOf

    def withRouting(self, routing):
        self._kw["routing"] = routing
        return self

    def _nested_kw(self):
        kw = super()._nested_kw()
        kw["routing"] = self._kw.get("routing")
        return kw

    def _build_kw(self):
        kw = dict(self._kw)
        kw.pop("ordered", None)  # plain Key_Farm workers are per-key-ordered
        return kw


class _TwoStageParMixin:
    def withParallelism(self, n1: int, n2: int):
        self._deg = (int(n1), int(n2))
        return self

    def withOrdered(self, flag: bool = True):
        self._kw["ordered"] = flag
        return self


class PaneFarm_Builder(_Builder, _WindowMixin, _TwoStageParMixin):
    """builders.hpp:1561."""
    _pattern_cls = PaneFarm

    def __init__(self, plq_func, wlq_func):
        super().__init__()
        self._kw["plq_func"] = plq_func
        self._kw["wlq_func"] = wlq_func
        self._deg = (1, 1)

    def incremental(self, plq: bool = None, wlq: bool = None):
        if plq is not None:
            self._kw["plq_incremental"] = plq
        if wlq is not None:
            self._kw["wlq_incremental"] = wlq
        return self

    def withResultFields(self, plq: dict = None, wlq: dict = None):
        if plq is not None:
            self._kw["plq_result_fields"] = dict(plq)
        if wlq is not None:
            self._kw["wlq_result_fields"] = dict(wlq)
        return self

    def _build_kw(self):
        kw = dict(self._kw)
        kw["plq_degree"], kw["wlq_degree"] = self._deg
        kw["opt_level"] = getattr(self, "_opt_level", 0)
        return kw


class WinMapReduce_Builder(_Builder, _WindowMixin, _TwoStageParMixin):
    """builders.hpp:1873."""
    _pattern_cls = WinMapReduce

    def __init__(self, map_func, reduce_func):
        super().__init__()
        self._kw["map_func"] = map_func
        self._kw["reduce_func"] = reduce_func
        self._deg = (2, 1)

    def incremental(self, map: bool = None, reduce: bool = None):
        if map is not None:
            self._kw["map_incremental"] = map
        if reduce is not None:
            self._kw["reduce_incremental"] = reduce
        return self

    def withResultFields(self, map: dict = None, reduce: dict = None):
        if map is not None:
            self._kw["map_result_fields"] = dict(map)
        if reduce is not None:
            self._kw["reduce_result_fields"] = dict(reduce)
        return self

    def _build_kw(self):
        kw = dict(self._kw)
        kw["map_degree"], kw["reduce_degree"] = self._deg
        kw["opt_level"] = getattr(self, "_opt_level", 0)
        return kw


# ------------------------------------------------------------- GPU builders

class _GPUMixin:
    """Device-path options shared by the five *GPU builders — the
    ``withBatch(batch_len, n_thread_block)`` family of the reference's GPU
    builders (builders.hpp:987+).

    Note on the native C++ hot loop: a resident stage runs its per-row
    window bookkeeping in C++ (native/wf_native.cpp, built by ``make -C
    native`` on first use) when every payload field its device stats read
    is **int64** (the native ABI ships int64 columns, narrowed per flush
    to the smallest wire dtype), at most ``wf_max_fields()`` of them and
    no float stat across several fields; any other payload switches
    transparently to the pure-Python resident core — same results, slower
    host loop (patterns/native_core.py:_fall_back).  Without the native
    library, or with WF_NO_NATIVE=1 / WF_NO_NATIVE_CORE=1, the Python core
    runs.  The restaging path (``withReduceKernel()``, user window
    functions) keeps the Python bookkeeping either way."""

    def withBatch(self, batch_len: int, n_thread_block: int = None):
        self._kw["batch_len"] = int(batch_len)
        if n_thread_block is not None:
            warnings.warn("n_thread_block sized the reference's CUDA "
                          "functor launches; the port's kernels choose "
                          "their own blocks — argument ignored",
                          stacklevel=2)
        return self

    def withScratchpad(self, size: int):
        warnings.warn("withScratchpad applies to raw CUDA functors; the "
                      "TorchWindowFunction contract passes columns instead "
                      "— argument ignored", stacklevel=2)
        return self

    def withDevice(self, device):
        """The card (``"cuda:0"``, a list to spread farm workers), or
        ``"cpu"`` for the kernels' plain versions; default ``cuda:0``."""
        self._kw["device"] = device
        return self

    def withDepth(self, depth: int):
        """Async launch pipeline depth (replaces per-batch stream sync)."""
        self._kw["depth"] = int(depth)
        return self

    def withReduceKernel(self, flag: bool = True):
        """Pin a builtin Reducer to the restaging path and its
        hand-written windowed-reduce kernel (the JAX builders'
        ``withPallas``)."""
        self._kw["use_reduce_kernel"] = flag
        return self

    def withComputeDtype(self, dtype):
        self._kw["compute_dtype"] = dtype
        return self


class WinSeqGPU_Builder(WinSeq_Builder, _GPUMixin):
    """builders.hpp:682 (WinSeqGPU_Builder)."""
    _pattern_cls = WinSeqGPU


class WinFarmGPU_Builder(_Builder, _WindowMixin, _WinParMixin, _GPUMixin):
    """builders.hpp:987 (WinFarmGPU_Builder)."""
    _pattern_cls = WinFarmGPU

    def __init__(self, winfunc):
        super().__init__()
        self._kw["winfunc"] = winfunc

    def withOrdered(self, flag: bool = True):
        self._kw["ordered"] = flag
        return self


class KeyFarmGPU_Builder(_Builder, _WindowMixin, _WinParMixin, _GPUMixin):
    """builders.hpp:1366 (KeyFarmGPU_Builder)."""
    _pattern_cls = KeyFarmGPU

    def __init__(self, winfunc):
        super().__init__()
        self._kw["winfunc"] = winfunc

    def withRouting(self, routing):
        self._kw["routing"] = routing
        return self


class PaneFarmGPU_Builder(PaneFarm_Builder, _GPUMixin):
    """builders.hpp:1707 (PaneFarmGPU_Builder) — the 4 constructor families
    (GPU-PLQ/CPU-WLQ etc., pane_farm_gpu.hpp:176-480) become two placement
    flags."""
    _pattern_cls = PaneFarmGPU

    def plqOnDevice(self, flag: bool = True):
        self._kw["plq_on_device"] = flag
        return self

    def wlqOnDevice(self, flag: bool = True):
        self._kw["wlq_on_device"] = flag
        return self


class WinMapReduceGPU_Builder(WinMapReduce_Builder, _GPUMixin):
    """builders.hpp:2020 (WinMapReduceGPU_Builder)."""
    _pattern_cls = WinMapReduceGPU

    def mapOnDevice(self, flag: bool = True):
        self._kw["map_on_device"] = flag
        return self

    def reduceOnDevice(self, flag: bool = True):
        self._kw["reduce_on_device"] = flag
        return self
