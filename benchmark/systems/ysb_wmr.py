"""The Yahoo Streaming Benchmark through Win_MapReduce: the port's YSB
app as ``build_pipeline("wmr-gpu")`` (Source -> Filter(views) ->
Join(ad -> campaign) -> WinMapReduceGPU: the WinMap emitter's per-key
round robin over ``pardegree2`` MAP replicas on the device, their dense-id
reorder collector, the REDUCE stage merging each window's partials on the
host -> Sink), fed by ``ysb.System``'s generator and checked against the
same campaign windows: Win_MapReduce gives the key farm's results.

The nodes the metric readers read: ``<farm>.<i>`` (the MAP replicas),
``<farm>.emitter`` and ``<farm>.collector``, and the REDUCE stage
``<reduce>.0``, the one node whose log counts ``reduce_windows``."""

from __future__ import annotations

from benchmark.systems import ysb

#: the pattern's name in ``apps/ysb.py``, and its stages' node names
PATTERN = "ysb_wmr_gpu"
MAP = f"{PATTERN}_map"
REDUCE = f"{PATTERN}_reduce"


class System(ysb.System):
    def __init__(self, config: dict, mix: dict, seed: int, device: str):
        super().__init__(config, mix, seed, device)
        self.farm = MAP
        self.emitter = f"{MAP}.emitter"
        self.collector = f"{MAP}.collector"
        self.reduce = f"{REDUCE}.0"
