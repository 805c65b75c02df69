"""windflow_tpu_torch — the PyTorch/CUDA port of windflow_tpu.

The port runs the window patterns' device paths on an NVIDIA GPU: the
resident path (rows copied once into per-key rings on the card, one ring
per field, the C++ bookkeeping of native/wf_native.cpp, the ring kernels
of ops/csrc/resident.cuh) and the restaging path (fired window batches
evaluated by ops/csrc/windowed_reduce.cu), for builtin reducers and for
user window functions (``TorchWindowFunction``, fed masked tiles by
ops/csrc/gather.cu), in a sequential pattern (``WinSeqGPU``), a farm
(``WinFarmGPU``, ``KeyFarmGPU``) or a two-stage pattern with per-stage
placement (``PaneFarmGPU``, ``WinMapReduceGPU``).  Entry points run on the
card unless the caller passes ``device="cpu"``.

Like the JAX package's umbrella module (and the reference's
``windflow.hpp`` + ``windflow_gpu.hpp``), this one exports everything an
application needs: patterns, builders, MultiPipe, and the robustness and
observability layers, under the JAX package's names with ``TPU`` → ``GPU``
and ``JaxWindowFunction`` → ``TorchWindowFunction``.  The JAX package
``windflow_tpu`` stays the reference; this package imports neither it nor
JAX.
"""

from .api import (LEVEL0, LEVEL1, LEVEL2, Accumulator_Builder,
                  Filter_Builder, FlatMap_Builder, KeyFarm_Builder,
                  KeyFarmGPU_Builder, Map_Builder, MultiPipe,
                  PaneFarm_Builder, PaneFarmGPU_Builder, Sink_Builder,
                  Source_Builder, WinFarm_Builder, WinFarmGPU_Builder,
                  WinMapReduce_Builder, WinMapReduceGPU_Builder,
                  WinSeq_Builder, WinSeqGPU_Builder, union_multipipes)
from .core.tuples import Schema, batch_from_columns
from .core.windows import WinType
from .ops.functions import (FnWindowFunction, FnWindowUpdate, MultiReducer,
                            Reducer, WindowFunction, WindowUpdate)
from .patterns.basic import (Accumulator, Filter, FlatMap, Map, Shipper,
                             Sink, Source)
from .patterns.key_farm import KeyFarm
from .patterns.nesting import KeyFarmOf, WinFarmOf
from .patterns.pane_farm import PaneFarm
from .patterns.win_farm import WinFarm
from .patterns.win_mapreduce import WinMapReduce
from .patterns.win_seq import WinSeq
from .patterns.native_core import NativeResidentCore
from .patterns.win_seq_gpu import (KeyFarmGPU, PaneFarmGPU,
                                   ResidentWinSeqCore, TorchWindowFunction,
                                   WinFarmGPU, WinMapReduceGPU, WinSeqGPU)
from .obs import EventLog, MetricsRegistry
from .recovery import CheckpointStore, EpochMarker, RecoveryPolicy
from .runtime.engine import Dataflow
from .runtime.farm import build_pipeline
from .runtime.node import RuntimeContext
from .runtime.overload import DeadLetter, OverloadError, OverloadPolicy

__all__ = [
    # core
    "Schema", "batch_from_columns", "WinType", "RuntimeContext",
    # window-function contracts
    "WindowFunction", "WindowUpdate", "FnWindowFunction", "FnWindowUpdate",
    "Reducer", "MultiReducer", "TorchWindowFunction",
    # patterns
    "Source", "Map", "Filter", "FlatMap", "Accumulator", "Sink", "Shipper",
    "WinSeq", "WinFarm", "KeyFarm", "PaneFarm", "WinMapReduce",
    "WinFarmOf", "KeyFarmOf",
    "WinSeqGPU", "WinFarmGPU", "KeyFarmGPU", "PaneFarmGPU",
    "WinMapReduceGPU",
    # composition
    "MultiPipe", "union_multipipes",
    "Source_Builder", "Filter_Builder", "Map_Builder", "FlatMap_Builder",
    "Accumulator_Builder", "Sink_Builder", "WinSeq_Builder",
    "WinFarm_Builder", "KeyFarm_Builder", "PaneFarm_Builder",
    "WinMapReduce_Builder", "WinSeqGPU_Builder", "WinFarmGPU_Builder",
    "KeyFarmGPU_Builder", "PaneFarmGPU_Builder", "WinMapReduceGPU_Builder",
    "LEVEL0", "LEVEL1", "LEVEL2",
    # robustness (docs/ROBUSTNESS.md)
    "OverloadPolicy", "OverloadError", "DeadLetter",
    "RecoveryPolicy", "CheckpointStore", "EpochMarker",
    # observability (docs/OBSERVABILITY.md)
    "MetricsRegistry", "EventLog",
    # the port's own: the resident cores and the engine
    "NativeResidentCore", "ResidentWinSeqCore", "Dataflow", "build_pipeline",
]
