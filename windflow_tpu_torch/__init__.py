"""windflow_tpu_torch — the PyTorch/CUDA port of windflow_tpu.

The port runs the sequential window pattern's device paths on an NVIDIA GPU:
the resident path (rows copied once into per-key rings on the card, the
C++ bookkeeping of native/wf_native.cpp, the ring kernels of
ops/csrc/resident.cu) and the restaging path (fired window batches
evaluated by ops/csrc/windowed_reduce.cu).  Entry points run on the card
unless the caller passes ``device="cpu"``.  The JAX package
``windflow_tpu`` stays the reference; this package imports neither it nor
JAX.
"""

from .core.tuples import Schema, batch_from_columns
from .core.windows import WinType
from .ops.functions import MultiReducer, Reducer
from .patterns.basic import Sink, Source
from .patterns.win_seq import WinSeq
from .patterns.native_core import NativeResidentCore
from .patterns.win_seq_gpu import ResidentWinSeqCore, WinSeqGPU
from .runtime.engine import Dataflow
from .runtime.farm import build_pipeline

__all__ = [
    "Schema", "batch_from_columns", "WinType", "Reducer", "MultiReducer",
    "Source", "Sink", "WinSeq", "WinSeqGPU", "ResidentWinSeqCore",
    "NativeResidentCore", "Dataflow", "build_pipeline",
]
