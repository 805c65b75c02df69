"""Two-level nesting: Win_Farm / Key_Farm whose workers are whole Pane_Farm
or Win_MapReduce instances (reference Win_Farm/Key_Farm constructors III/IV,
win_farm.hpp:339-549, key_farm.hpp:210-334).

The reference fuses the two routing levels into dedicated nested emitters
(WF_NestedEmitter / KF_NestedEmitter, wf_nodes.hpp:199, kf_nodes.hpp:85);
here the same routing is obtained compositionally — the outer emitter feeds
each inner instance's own emitter — because the distribution math lives
entirely in the PatternConfig each nested instance is built with:

* WinFarmOf: instance i gets a private slide ``slide*pardegree`` and
  PatternConfig(0, 1, slide, i, pardegree, slide)  (win_farm.hpp:379);
* KeyFarmOf: instances keep the original slide with a plain config — keys,
  not windows, are partitioned (key_farm.hpp:252).

Inner instances are built unordered; the outer collector restores per-key
dense-id order (the KF_NestedCollector / WF_Collector role).
"""

from __future__ import annotations

from ..core.windows import PatternConfig, Role, WindowSpec
from ..runtime.emitters import Collector, StandardEmitter, default_routing
from .win_farm import WFCollectorNode, WFEmitterNode


class _NestedFarm:
    def __init__(self, name):
        self.name = name
        self.instances = []

    @property
    def result_schema(self):
        return self.instances[0].result_schema

    def _wire(self, df, upstreams, emitter, ordered):
        df.add(emitter)
        for up in upstreams:
            df.connect(up, emitter)
        tails = []
        for inst in self.instances:
            # each instantiate() call issues exactly one connect() from the
            # emitter, so output port i feeds instance i
            tails += inst.instantiate(df, [emitter])
        collector = (WFCollectorNode(name=f"{self.name}.collector") if ordered
                     else Collector(name=f"{self.name}.collector"))
        df.add(collector)
        for t in tails:
            df.connect(t, collector)
        return [collector]


class WinFarmOf(_NestedFarm):
    """Win_Farm of Pane_Farm / Win_MapReduce instances: windows are assigned
    round-robin to instances, each seeing a private slide."""

    def __init__(self, inner, pardegree=2, ordered=True, name="wf_nested"):
        super().__init__(name)
        self.pardegree = pardegree
        self.ordered = ordered
        spec = inner.spec
        self.spec = WindowSpec(spec.win_len, spec.slide_len, spec.win_type)
        slide = spec.slide_len
        self.instances = [
            inner.clone_with(
                name=f"{name}_wf_{i}", slide_len=slide * pardegree,
                config=PatternConfig(0, 1, slide, i, pardegree, slide),
                ordered=False)
            for i in range(pardegree)]

    def instantiate(self, df, upstreams):
        emitter = WFEmitterNode(self.spec, self.pardegree, 0, 1,
                                self.spec.slide_len, Role.SEQ,
                                name=f"{self.name}.emitter")
        return self._wire(df, upstreams, emitter, self.ordered)


class KeyFarmOf(_NestedFarm):
    """Key_Farm of Pane_Farm / Win_MapReduce instances: whole keys to
    instances."""

    def __init__(self, inner, pardegree=2, routing=None, ordered=True,
                 name="kf_nested"):
        super().__init__(name)
        self.pardegree = pardegree
        self.ordered = ordered
        self.routing = routing or default_routing
        spec = inner.spec
        self.spec = WindowSpec(spec.win_len, spec.slide_len, spec.win_type)
        self.instances = [
            inner.clone_with(
                name=f"{name}_kf_{i}",
                config=PatternConfig.plain(spec.slide_len), ordered=False)
            for i in range(pardegree)]

    def instantiate(self, df, upstreams):
        emitter = StandardEmitter(self.pardegree, self.routing,
                                  name=f"{self.name}.emitter")
        return self._wire(df, upstreams, emitter, self.ordered)
