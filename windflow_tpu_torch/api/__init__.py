"""Composition layer of the port: MultiPipe + the 16 fluent builders —
copies of ``windflow_tpu/api``, the equivalents of the reference's
multipipe.hpp and builders.hpp, with the five device builders under the
reference's own ``*GPU_Builder`` names."""

from .builders import (LEVEL0, LEVEL1, LEVEL2, Accumulator_Builder,
                       Filter_Builder, FlatMap_Builder, KeyFarm_Builder,
                       KeyFarmGPU_Builder, Map_Builder, PaneFarm_Builder,
                       PaneFarmGPU_Builder, Sink_Builder, Source_Builder,
                       WinFarm_Builder, WinFarmGPU_Builder,
                       WinMapReduce_Builder, WinMapReduceGPU_Builder,
                       WinSeq_Builder, WinSeqGPU_Builder)
from .multipipe import MultiPipe, union_multipipes

__all__ = [
    "MultiPipe", "union_multipipes",
    "Source_Builder", "Filter_Builder", "Map_Builder", "FlatMap_Builder",
    "Accumulator_Builder", "Sink_Builder",
    "WinSeq_Builder", "WinFarm_Builder", "KeyFarm_Builder",
    "PaneFarm_Builder", "WinMapReduce_Builder",
    "WinSeqGPU_Builder", "WinFarmGPU_Builder", "KeyFarmGPU_Builder",
    "PaneFarmGPU_Builder", "WinMapReduceGPU_Builder",
    "LEVEL0", "LEVEL1", "LEVEL2",
]
