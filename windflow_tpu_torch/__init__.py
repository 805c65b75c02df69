"""windflow_tpu_torch — the PyTorch/CUDA port of windflow_tpu.

The port runs the sequential window pattern's device path on an NVIDIA GPU:
fired window batches are evaluated by a hand-written CUDA kernel
(ops/csrc/windowed_reduce.cu).  Entry points run on the card unless the
caller passes ``device="cpu"``.  The JAX package ``windflow_tpu`` stays the
reference; this package imports neither it nor JAX.
"""

from .core.tuples import Schema, batch_from_columns
from .core.windows import WinType
from .ops.functions import Reducer
from .patterns.basic import Sink, Source
from .patterns.win_seq import WinSeq
from .patterns.win_seq_gpu import WinSeqGPU
from .runtime.engine import Dataflow
from .runtime.farm import build_pipeline

__all__ = [
    "Schema", "batch_from_columns", "WinType", "Reducer", "Source", "Sink",
    "WinSeq", "WinSeqGPU", "Dataflow", "build_pipeline",
]
