"""windflow_tpu_torch — the PyTorch/CUDA port of windflow_tpu.

The port runs the window patterns' device paths on an NVIDIA GPU: the
resident path (rows copied once into per-key rings on the card, one ring
per field, the C++ bookkeeping of native/wf_native.cpp, the ring kernels
of ops/csrc/resident.cu) and the restaging path (fired window batches
evaluated by ops/csrc/windowed_reduce.cu), for builtin reducers and for
user window functions (``TorchWindowFunction``, fed masked tiles by
ops/csrc/gather.cu), in a sequential pattern (``WinSeqGPU``) or a farm
(``WinFarmGPU``, ``KeyFarmGPU``).  Entry points run on the card unless the
caller passes ``device="cpu"``.  The JAX package
``windflow_tpu`` stays the reference; this package imports neither it nor
JAX.
"""

from .api import MultiPipe
from .core.tuples import Schema, batch_from_columns
from .core.windows import WinType
from .ops.functions import MultiReducer, Reducer
from .patterns.basic import Sink, Source
from .patterns.win_seq import WinSeq
from .patterns.native_core import NativeResidentCore
from .patterns.win_seq_gpu import (KeyFarmGPU, ResidentWinSeqCore,
                                   TorchWindowFunction, WinFarmGPU,
                                   WinSeqGPU)
from .runtime.engine import Dataflow
from .runtime.farm import build_pipeline

__all__ = [
    "Schema", "batch_from_columns", "WinType", "Reducer", "MultiReducer",
    "Source", "Sink", "WinSeq", "WinSeqGPU", "ResidentWinSeqCore",
    "NativeResidentCore", "Dataflow", "build_pipeline",
    "TorchWindowFunction", "WinFarmGPU", "KeyFarmGPU", "MultiPipe",
]
