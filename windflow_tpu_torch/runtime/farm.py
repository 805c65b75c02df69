"""Wiring helpers: build farm shells (emitter -> replicas -> collector) into
a Dataflow graph — the structural equivalent of the reference's
``ff_farm(emitter, workers, collector)`` containers (map.hpp:196-209) and of
pipeline composition.  MultiPipe (api/) layers the fluent construction on
top of these primitives.
"""

from __future__ import annotations

from .engine import Dataflow
from .node import Node

#: sentinel: "use the pattern's default shell node"; pass None to fuse it away
DEFAULT = object()


def _apply_error_budget(pattern, replicas: list[Node]) -> list[Node]:
    """Propagate per-node policy knobs a pattern carries onto the worker
    nodes the engine actually runs — shell nodes (emitter/collector)
    keep their class defaults:

    * ``error_budget`` (builders' withErrorBudget): poison-tuple
      quarantine allowance — an error in a shell is a framework bug,
      not a poison tuple, so shells never inherit it;
    * ``recoverable`` (a pattern attribute, default absent): an explicit
      False opts the pattern's workers out of supervised restart
      (docs/ROBUSTNESS.md "Recovery") — e.g. a sink with irreversible
      external side effects where replayed emissions must not re-fire.
    """
    budget = getattr(pattern, "error_budget", None)
    if budget is not None:
        for r in replicas:
            r.error_budget = int(budget)
    recover = getattr(pattern, "recoverable", None)
    if recover is not None:
        for r in replicas:
            r.recoverable = bool(recover)
    return replicas


def _provision_rescale(df: Dataflow, pattern) -> int | None:
    """Control-plane pre-provisioning (docs/CONTROL.md): when a
    ``Rescale`` rule targets this pattern, widen its worker set to the
    rule's ``max_workers`` at build time — the engine graph is fixed once
    ``run()`` starts, so elasticity means building the ceiling and
    routing over an *active* subset (emitters' ``n_active``).  Returns
    the initial active width (the pattern's declared parallelism), or
    None when no rule applies."""
    ctl = getattr(df, "control", None)
    rule = (ctl.rescale_for(getattr(pattern, "name", None))
            if ctl is not None else None)
    if rule is None:
        return None
    if getattr(df, "metrics", None) is None:
        # blind control (WF209): the engine never attaches a Controller,
        # so pre-provisioned spare workers could never activate — build
        # the farm at its declared width instead of parking idle threads
        return None
    if getattr(pattern, "routing", None) is None:
        raise ValueError(
            f"[WF210] Rescale rule targets {pattern.name!r}, which is "
            f"not key-partitioned (no keyed routing): live rescale "
            f"migrates per-key state between workers, and a "
            f"window-parallel farm's workers own window slices, not "
            f"keys — wrap the computation in a Key_Farm "
            f"(docs/CONTROL.md)")
    if getattr(pattern, "recoverable", None) is False:
        raise ValueError(
            f"[WF210] Rescale rule targets {pattern.name!r}, whose "
            f"recoverable flag is opted out: a pattern that cannot "
            f"snapshot cannot seal the migration cut — drop the "
            f"opt-out or the rule (docs/CONTROL.md)")
    if getattr(pattern, "n_emitters", 1) > 1:
        raise ValueError(
            f"Rescale rule targets multi-emitter farm {pattern.name!r}: "
            f"ordered multi-emitter merges pin the channel count at "
            f"build time and cannot rescale")
    n0 = getattr(pattern, "_ctl_width0", None)
    if n0 is None:
        n0 = pattern.parallelism
        pattern._ctl_width0 = n0
    # validated on EVERY build, stamped or not: a pattern reused under a
    # different rule must not route n_active past the new ceiling
    if not rule.min_workers <= n0 <= rule.max_workers:
        raise ValueError(
            f"{pattern.name!r}: declared parallelism {n0} outside "
            f"the Rescale rule's [{rule.min_workers}, "
            f"{rule.max_workers}] range")
    # widen for THIS build only — add_farm restores the declared width
    # after wiring, so the user's pattern object is not permanently
    # mutated (a later control-less build must not inherit the ceiling)
    pattern.parallelism = rule.max_workers
    return n0


def add_farm(df: Dataflow, pattern, upstreams: list[Node],
             emitter: Node = DEFAULT, collector: Node = DEFAULT) -> list[Node]:
    """Instantiate `pattern` as emitter -> replicas -> collector, feeding it
    from `upstreams`.  Pass emitter/collector = None to fuse the shell node
    away (the LEVEL1 `ff_comb` analog, pane_farm.hpp:435).  Pass-through
    shells at parallelism 1 are skipped automatically.  Returns the nodes
    downstream should connect from."""
    if hasattr(pattern, "instantiate"):
        # composite pattern (a pipeline of farms, e.g. Pane_Farm): it wires
        # its own stages (reference: Pane_Farm is an ff_pipeline of two
        # Win_Seq/Win_Farm stages, pane_farm.hpp:149-181)
        if emitter is not DEFAULT or collector is not DEFAULT:
            raise ValueError(
                "emitter/collector overrides do not apply to composite "
                f"patterns ({type(pattern).__name__} wires its own stages)")
        return pattern.instantiate(df, upstreams)
    n_emitters = getattr(pattern, "n_emitters", 1)
    if n_emitters > 1 and emitter is DEFAULT:
        # multi-emitter farm (win_farm.hpp:147-166): one emitter clone per
        # upstream producer, all-to-all into OrderingCore-fronted workers
        # that k-way-merge the emitters' interleaved substreams
        if len(upstreams) != n_emitters:
            raise ValueError(
                f"{pattern.name}: n_emitters={n_emitters} needs exactly "
                f"that many upstream producers, got {len(upstreams)}")
        replicas = _apply_error_budget(pattern, pattern.replicas())
        for r in replicas:
            df.add(r)
        for up in upstreams:
            em = pattern.emitter()
            df.add(em)
            df.connect(up, em)
            for r in replicas:
                df.connect(em, r)
        if collector is DEFAULT:
            collector = pattern.collector()
        if collector is not None:
            df.add(collector)
            for r in replicas:
                df.connect(r, collector)
            return [collector]
        return replicas
    rescale_width = _provision_rescale(df, pattern)
    try:
        replicas = _apply_error_budget(pattern, pattern.replicas())
        for r in replicas:
            df.add(r)
        if emitter is DEFAULT:
            emitter = pattern.emitter()
            # a 1-replica unrouted farm needs no emitter thread: the
            # engine's multi-in inboxes merge upstreams at the replica
            # directly
            if (emitter is not None
                    and type(emitter).__name__ == "StandardEmitter"
                    and pattern.parallelism == 1):
                emitter = None
        if rescale_width is not None:
            if emitter is None or not hasattr(emitter, "n_active"):
                raise ValueError(
                    f"Rescale rule targets {pattern.name!r} but its farm "
                    f"has no routing emitter to move the active width on")
            emitter.n_active = rescale_width
            df._farms.append({
                "pattern": pattern, "emitter": emitter,
                "workers": replicas,
                "rule": df.control.rescale_for(pattern.name),
                "width": rescale_width,
            })
        if collector is DEFAULT:
            collector = pattern.collector()
            if (collector is not None
                    and type(collector).__name__ == "Collector"
                    and pattern.parallelism == 1):
                collector = None
    finally:
        if rescale_width is not None:
            # the widening was for shell/replica construction only (the
            # emitter/collector fuse checks above must see the ceiling):
            # hand the user's pattern object back at its declared width
            # on EVERY exit, so neither a later control-less build nor a
            # failed one inherits max_workers
            pattern.parallelism = rescale_width
    if emitter is not None:
        df.add(emitter)
        for up in upstreams:
            df.connect(up, emitter)
        for r in replicas:
            df.connect(emitter, r)
    elif upstreams:
        # fused emitter: wire upstreams straight to replicas
        if len(replicas) == 1:
            for up in upstreams:
                df.connect(up, replicas[0])
        elif len(upstreams) == len(replicas):
            for up, r in zip(upstreams, replicas):
                df.connect(up, r)
        else:
            raise ValueError(
                f"cannot fuse emitter: {len(upstreams)} upstreams vs "
                f"{len(replicas)} replicas (all-to-all would duplicate data)")
    if collector is not None:
        df.add(collector)
        for r in replicas:
            df.connect(r, collector)
        return [collector]
    return replicas


def _is_passthrough_emitter(em) -> bool:
    return em is None or type(em).__name__ == "StandardEmitter"


def fuse_two_stage(df: Dataflow, stage1, stage2, upstreams: list[Node],
                   level: int) -> list[Node]:
    """LEVEL1/LEVEL2 fusion of a two-stage windowed composite — the
    engine-side port of ``optimize_PaneFarm`` / ``optimize_WinMapReduce``
    (pane_farm.hpp:426-466, win_mapreduce.hpp's mirror).

    * LEVEL1: both boundary nodes survive but run in ONE thread — the
      stage-1 collector and stage-2 emitter become a :class:`Comb`
      (``combine_nodes_in_pipeline``, pane_farm.hpp:435-449).  With both
      stages at degree 1 the two window cores themselves fuse into one
      thread.
    * LEVEL2: the stage-1 collector is REMOVED; a clone of stage 2's
      emitter is fused onto every stage-1 worker
      (``combine_farms(plq, wlq_emitter, wlq, OrderingNode)``,
      pane_farm.hpp:459), and every stage-2 worker is fronted by an
      OrderingCore that k-way merges the stage-1 workers' substreams
      (the ff_comb(OrderingNode, worker) of multipipe.hpp:218-224).
    """
    from ..runtime.comb import make_comb
    from ..runtime.node import RuntimeContext
    from ..runtime.ordering import OrderingMode
    from ..patterns.win_farm import WinFarm, _OrderedWorkerNode
    from ..core.windows import WinType

    P = stage1.parallelism
    W = stage2.parallelism

    if level >= 2:
        # ---- stage 1 workers, each with a fused stage-2 emitter clone ----
        s1_workers = _apply_error_budget(stage1, stage1.replicas())
        need_emitter = (W > 1
                        and not _is_passthrough_emitter(stage2.emitter()))
        combs = []
        for w in s1_workers:
            if not need_emitter:
                combs.append(w)   # single consumer: no routing needed
            else:
                em = stage2.emitter()
                combs.append(make_comb([w, em], name=f"{w.name}+{em.name}"))
        for c in combs:
            df.add(c)
        s1_em = stage1.emitter()
        if _is_passthrough_emitter(s1_em) and P == 1:
            for up in upstreams:
                df.connect(up, combs[0])
        else:
            df.add(s1_em)
            for up in upstreams:
                df.connect(up, s1_em)
            for c in combs:
                df.connect(s1_em, c)
        # ---- stage 2 workers fronted by an OrderingCore over P channels ----
        # per-key watermarks: stage-1 workers emit per-key renumbered ids
        # (PLQ/MAP role), which are NOT globally monotone per channel
        if isinstance(stage2, WinFarm):
            stage2.n_emitters = P   # replicas become _OrderedWorkerNodes
            stage2.ordering_per_key = True
            s2_workers = _apply_error_budget(stage2, stage2.replicas())
        else:  # degree-1 sequential stage
            mode = (OrderingMode.ID
                    if stage2.spec.win_type is WinType.CB else OrderingMode.TS)
            node = _OrderedWorkerNode(stage2.make_core(), P, mode,
                                      f"{stage2.name}.0", per_key=True)
            node.ctx = RuntimeContext(1, 0, stage2.name)
            s2_workers = [node]
        for r in s2_workers:
            df.add(r)
        for c in combs:
            for r in s2_workers:
                df.connect(c, r)
        collector = stage2.collector() if hasattr(stage2, "collector") else None
        if collector is not None and not (
                type(collector).__name__ == "Collector" and W == 1):
            df.add(collector)
            for r in s2_workers:
                df.connect(r, collector)
            return [collector]
        return s2_workers

    # ---- LEVEL1 ----
    if P == 1 and W == 1:
        # two sequential cores in one thread (ff_comb of the two Win_Seqs)
        s1 = stage1.replicas()[0]
        s2 = stage2.replicas()[0]
        comb = make_comb([s1, s2], name=f"{s1.name}+{s2.name}")
        df.add(comb)
        for up in upstreams:
            df.connect(up, comb)
        return [comb]
    # fuse the boundary: stage-1 collector + stage-2 emitter in one thread
    s1_coll = stage1.collector()
    s2_em = stage2.emitter()
    if s1_coll is None or _is_passthrough_emitter(s2_em):
        tails = add_farm(df, stage1, upstreams)
        return add_farm(df, stage2, tails)
    boundary = make_comb([s1_coll, s2_em],
                         name=f"{s1_coll.name}+{s2_em.name}")
    add_farm(df, stage1, upstreams, collector=boundary)
    # the fused emitter routes per output channel: boundary channel d is
    # stage-2 worker d (connect order defines emit_to indexing)
    reps = stage2.replicas()
    for r in reps:
        df.add(r)
        df.connect(boundary, r)
    collector = stage2.collector()
    if collector is not None and not (
            type(collector).__name__ == "Collector" and W == 1):
        df.add(collector)
        for r in reps:
            df.connect(r, collector)
        return [collector]
    return reps


def build_pipeline(df: Dataflow, patterns: list) -> list[Node]:
    """Chain patterns into a linear pipeline; returns the tail nodes."""
    tails: list[Node] = []
    for p in patterns:
        tails = add_farm(df, p, tails)
    return tails
