"""Key_Farm: key parallelism — whole keys are routed to workers, each
running a full sequential window core over its keys' substreams
(reference key_farm.hpp:143-156, kf_nodes.hpp:38-82).

No reordering is needed downstream: every result of a key comes from the
same worker, so per-key order is preserved by construction — the property
the TPU mesh version exploits to keep keys resident per core with no
collectives (SURVEY.md §7).
"""

from __future__ import annotations

from ..core.windows import PatternConfig, Role, WinType
from ..runtime.emitters import StandardEmitter, default_routing
from ..runtime.node import RuntimeContext
from .basic import _Pattern
from .win_seq import WinSeq, WinSeqNode


class KeyFarm(_Pattern):
    def __init__(self, winfunc, win_len, slide_len, win_type=WinType.CB,
                 pardegree=2, name="key_farm", incremental=None,
                 result_fields=None, routing=None,
                 config: PatternConfig = None, role: Role = Role.SEQ):
        super().__init__(name, pardegree, routing or default_routing)
        self._seq_template = WinSeq(
            winfunc, win_len, slide_len, win_type, name=f"{name}_kf",
            incremental=incremental, result_fields=result_fields,
            config=config, role=role)

    @property
    def result_schema(self):
        return self._seq_template.result_schema

    def emitter(self):
        # pure key routing (kf_nodes.hpp:73)
        return StandardEmitter(self.parallelism, self.routing,
                               name=f"{self.name}.emitter")

    def _make_core(self, worker, i=0):
        """Core-factory hook: TPU farms override to build device cores
        (worker index `i` drives per-worker device placement)."""
        return worker.make_core()

    def _make_replica(self, i):
        node = WinSeqNode(self._make_core(self._seq_template, i),
                          f"{self.name}.{i}")
        node.ctx = RuntimeContext(self.parallelism, i, self.name)
        return node
