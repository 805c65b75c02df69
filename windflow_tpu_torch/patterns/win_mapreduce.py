"""Win_MapReduce: window-partition parallelism — each window's tuples are
split round-robin across MAP workers computing partial results, merged per
window by a REDUCE stage (reference win_mapreduce.hpp, wm_nodes.hpp).

* MAP: ``map_degree`` sequential cores with the SAME win/slide, role MAP,
  ``map_indexes=(i, n)`` — worker i's k-th result gets the dense id
  ``i + k*n`` (win_seq.hpp:397-399), so the merged per-key MAP output ids
  are 0,1,2,... with n consecutive ids = the n partials of one window.
* The emitter assigns tuples per key round-robin starting at
  ``key % map_degree`` (wm_nodes.hpp:101-110) and broadcasts each key's last
  tuple to all workers as an EOS marker (wm_nodes.hpp:115-129).
* A reorder collector restores dense-id order per key (wm_nodes.hpp:218).
* REDUCE: a CB window of len = slide = ``map_degree`` over the partial
  stream, role REDUCE (win_mapreduce.hpp:173-183) — one firing = one
  window's n partials combined.

This is the streaming analog of tensor parallelism over one long window —
the TPU mesh version computes the partials per core and the REDUCE merge as
an on-device tree reduction over ICI (parallel/mesh.py).

The reference's ``WinMap_Dropper`` (wm_nodes.hpp:137-214) has no separate
equivalent here: it exists only to invert a ``broadcast_node`` in the
MultiPipe CB path (multipipe.hpp:766-777, broadcast-then-keep-my-turn);
this framework's MultiPipe composes the round-robin ``WinMapEmitter``
directly, so the broadcast+drop pair never arises while the tuple
assignment is identical.
"""

from __future__ import annotations

from time import perf_counter_ns as _pc_ns

import numpy as np

from ..core.windows import PatternConfig, Role, WindowSpec, WinType
from ..runtime.emitters import KeyedStreamState
from ..runtime.node import Node, RuntimeContext, blocked_put_ns
from .basic import _Pattern
from .win_farm import WFCollectorNode, WinFarm
from .win_seq import WinSeq, WinSeqNode

_NEG_INF = np.int64(-(2 ** 62))


class WinMapEmitterNode(Node):
    """Per-key round-robin partitioner (wm_nodes.hpp:40-133).

    Where the node keeps operator states (node logs), it times its two
    parts into its log: ``wm_assign_ms_total``, the sort by key and the
    per-key round-robin bases; ``wm_scatter_ms_total``, the per-replica
    mask passes and emits, less the time blocked in their puts."""

    quarantine_exempt = True    # framework shell: errors here fail fast
    shed_safe = True            # farm head: shedding drops raw stream rows

    def __init__(self, map_degree: int, win_type: WinType, name="wm_emitter"):
        super().__init__(name)
        self.map_degree = map_degree
        self.pos_field = "id" if win_type is WinType.CB else "ts"
        self._state = KeyedStreamState(self.pos_field)
        self._next_dst = {}  # key -> next round-robin destination
        self._ns = None      # [assign, scatter] ns, only with node logs

    def svc_init(self):
        st = self.stats
        if st is not None and st.states:
            self._ns = [0, 0]

    def svc(self, batch, channel=0):
        # marker absorption + ooo drop shared with WF emitter
        # (wm_nodes.hpp:87-104 mirrors wf_nodes.hpp:104-121)
        batch = self._state.filter(batch)
        if len(batch) == 0:
            return
        ns = self._ns
        if ns is None:
            self._scatter(batch, self._destinations(batch["key"]))
            return
        t0 = _pc_ns()
        dest = self._destinations(batch["key"])
        t1 = _pc_ns()
        put0 = blocked_put_ns(self._outputs)
        self._scatter(batch, dest)
        ns[0] += t1 - t0
        ns[1] += _pc_ns() - t1 - (blocked_put_ns(self._outputs) - put0)

    def _destinations(self, keys):
        """Each row's replica: its key's rows go round-robin from the key's
        next destination (``key % map_degree`` at first), in row order."""
        n = self.map_degree
        # sort-by-key + segmented arange: O(n log n + K) instead of a
        # full-batch mask per distinct key (collapses at 1e5 keys)
        from ..core.tuples import group_by_key
        order, starts, ends = group_by_key(keys)
        sk = keys[order]
        counts = ends - starts
        base = np.empty(len(starts), dtype=np.int64)
        nd = self._next_dst
        for i, s in enumerate(starts):     # O(K) scalar dict ops
            k = int(sk[s])
            b = nd.get(k)
            if b is None:
                b = k % n
            base[i] = b
            nd[k] = (b + int(counts[i])) % n
        rank = np.arange(len(sk), dtype=np.int64) - np.repeat(starts, counts)
        dest = np.empty(len(keys), dtype=np.int64)
        dest[order] = (np.repeat(base, counts) + rank) % n
        return dest

    def _scatter(self, batch, dest):
        for d in range(self.map_degree):
            sub = batch[dest == d]
            if len(sub):
                self.emit_to(d, sub)

    def svc_end(self):
        if self._ns is not None:
            self.stats.counters.update(
                wm_assign_ms_total=round(self._ns[0] / 1e6, 3),
                wm_scatter_ms_total=round(self._ns[1] / 1e6, 3))

    def eosnotify(self):
        markers = self._state.marker_batch()
        if markers is None:
            return
        for d in range(self.map_degree):
            self.emit_to(d, markers)


class _MapStage(_Pattern):
    """The MAP farm: per-replica map_indexes, round-robin emitter, dense-id
    reorder collector (win_mapreduce.hpp:147-163)."""

    def __init__(self, map_func, spec: WindowSpec, map_degree, name,
                 incremental, result_fields, config: PatternConfig,
                 device_fn=None, device_opts=None):
        super().__init__(name, map_degree)
        cfg = PatternConfig(config.id_inner, config.n_inner, config.slide_inner,
                            0, 1, spec.slide_len)
        self._workers = [
            WinSeq(map_func, spec.win_len, spec.slide_len, spec.win_type,
                   name=f"{name}.{i}", incremental=incremental,
                   result_fields=result_fields, config=cfg, role=Role.MAP,
                   map_indexes=(i, map_degree))
            for i in range(map_degree)]
        self.spec = spec
        self._device_fn = device_fn       # raw Reducer/TorchWindowFunction
        self._device_opts = device_opts   # not None => device-batched MAP

    @property
    def result_schema(self):
        return self._workers[0].result_schema

    def emitter(self):
        return WinMapEmitterNode(self.parallelism, self.spec.win_type,
                                 name=f"{self.name}.emitter")

    def collector(self):
        return WFCollectorNode(name=f"{self.name}.collector")

    def _make_replica(self, i):
        w = self._workers[i]
        if self._device_opts is not None:
            from .win_seq_gpu import make_device_core
            core = make_device_core(w, self._device_fn, self._device_opts,
                                    index=i)
        else:
            core = w.make_core()
        node = WinSeqNode(core, f"{self.name}.{i}")
        node.ctx = RuntimeContext(self.parallelism, i, self.name)
        return node


class WinMapReduce:
    """Composite two-stage pattern (MAP farm + REDUCE)."""

    def __init__(self, map_func, reduce_func, win_len, slide_len,
                 win_type=WinType.CB, map_degree=2, reduce_degree=1,
                 name="win_mr", map_incremental=None, reduce_incremental=None,
                 map_result_fields=None, reduce_result_fields=None,
                 ordered=True, config: PatternConfig = None,
                 opt_level: int = 0):
        if map_degree < 2:
            raise ValueError("Win_MapReduce needs a parallel MAP stage "
                             "(win_mapreduce.hpp:135)")
        self.opt_level = opt_level
        self._proto = dict(
            map_func=map_func, reduce_func=reduce_func, win_len=win_len,
            slide_len=slide_len, win_type=win_type, map_degree=map_degree,
            reduce_degree=reduce_degree, map_incremental=map_incremental,
            reduce_incremental=reduce_incremental,
            map_result_fields=map_result_fields,
            reduce_result_fields=reduce_result_fields,
            opt_level=opt_level)
        self.spec = WindowSpec(win_len, slide_len, win_type)
        self.name = name
        self.config = config or PatternConfig.plain(slide_len)
        from .basic import user_call_site
        #: construction-site anchor for check/ diagnostics
        self.anchor = user_call_site()
        cfg = self.config
        n = map_degree
        self.map_stage = self._make_map_stage(
            map_func, n, f"{name}_map", map_incremental, map_result_fields)
        # REDUCE: CB window n/n over the dense partial stream
        # (win_mapreduce.hpp:173-183)
        self.reduce_stage = self._make_reduce_stage(
            reduce_func, n, reduce_degree, f"{name}_reduce",
            reduce_incremental, reduce_result_fields, ordered)

    def _make_map_stage(self, map_func, n, name, incremental, result_fields):
        return _MapStage(map_func, self.spec, n, name, incremental,
                         result_fields, self.config)

    def _make_reduce_stage(self, reduce_func, n, degree, name, incremental,
                           result_fields, ordered):
        cfg = self.config
        if degree > 1:
            return WinFarm(reduce_func, n, n, WinType.CB, pardegree=degree,
                           name=name, incremental=incremental,
                           result_fields=result_fields, ordered=ordered,
                           config=cfg, role=Role.REDUCE)
        red_cfg = PatternConfig(cfg.id_inner, cfg.n_inner, cfg.slide_inner,
                                0, 1, n)
        return WinSeq(reduce_func, n, n, WinType.CB, name=name,
                      incremental=incremental, result_fields=result_fields,
                      config=red_cfg, role=Role.REDUCE)

    @property
    def result_schema(self):
        return self.reduce_stage.result_schema

    def instantiate(self, df, upstreams):
        from ..runtime.farm import add_farm, fuse_two_stage
        if self.opt_level >= 1:
            # optimize_WinMapReduce (the Pane_Farm optimizer's mirror,
            # win_mapreduce.hpp): fuse the MAP-collector/REDUCE-emitter
            # boundary (LEVEL1) or merge at the REDUCE workers (LEVEL2)
            return fuse_two_stage(df, self.map_stage, self.reduce_stage,
                                  upstreams, self.opt_level)
        tails = add_farm(df, self.map_stage, upstreams)
        return add_farm(df, self.reduce_stage, tails)

    def clone_with(self, name, slide_len=None, config=None, ordered=False):
        """Replicate as a nested-farm worker (win_farm.hpp ctor IV)."""
        kw = dict(self._proto)
        if slide_len is not None:
            kw["slide_len"] = slide_len
        return WinMapReduce(name=name, config=config, ordered=ordered, **kw)
