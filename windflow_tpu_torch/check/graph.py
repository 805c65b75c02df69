"""Graph validation: a walk over a built (not yet running)
:class:`~windflow_tpu_torch.runtime.engine.Dataflow`.

Everything here works on the materialised node graph — ``df.nodes``,
``df._edges``, and per-node cores — so it covers manual wirings exactly
like MultiPipe-built ones.  When the graph came from a MultiPipe
(``df._check_pipe``, stamped by ``MultiPipe._build``), window-geometry
diagnostics anchor at the pattern's construction site instead of a bare
node name.

Detection is duck-typed by design (class names / attribute probes, no
pattern imports): the check package must stay import-light so the lazy
``check=`` hook costs nothing when off, and a stubbed core in a test is
as checkable as the real native one.
"""

from __future__ import annotations

from .closures import analyze_function
from .config import _iter_pipe_patterns as _iter_patterns
from .config import check_dataflow_config
from .diagnostics import Diagnostic


def _stats_name(df, node) -> str:
    from ..utils.tracing import node_stats_name
    try:
        idx = df.nodes.index(node)
    except ValueError:
        return node.name
    return node_stats_name(df.name, idx, node.name)


def _leaf_nodes(node):
    """A node and its fused members (Comb stages), flattened."""
    stages = getattr(node, "stages", None)
    if not stages:
        return [node]
    out = []
    for s in stages:
        out.extend(_leaf_nodes(s))
    return out


def _core_of(leaf):
    return getattr(leaf, "core", None)


def _is_async_core(core) -> bool:
    return core is not None and hasattr(core, "process_batches")


def _has_keyed_state(node) -> bool:
    """Per-key mutable stream state that keyed routing must protect:
    window cores (their substream arithmetic assumes one worker sees a
    key's whole slice) and accumulator folds."""
    for leaf in _leaf_nodes(node):
        if type(leaf).__name__ == "_AccumulatorNode":
            return True
        core = _core_of(leaf)
        if core is not None and hasattr(core, "spec"):
            return True
    return False


def _anchor_of(pattern):
    return getattr(pattern, "anchor", None)


# --------------------------------------------------------------- passes

def _check_recovery(df) -> list[Diagnostic]:
    """WF202-204 + WF215: recovery= over nodes whose configuration
    declines snapshots or restart — today these die at the FIRST
    checkpoint (SnapshotUnsupported) or silently degrade to
    fail-like-seed."""
    diags = []
    if df.recovery is None:
        return diags
    from ..runtime.node import SourceNode
    for node in df.nodes:
        name = _stats_name(df, node)
        leaves = _leaf_nodes(node)
        for leaf in leaves:
            core = _core_of(leaf)
            if core is None:
                continue
            if (type(core).__name__ == "NativeResidentCore"
                    and not getattr(core, "has_state_abi", False)):
                diags.append(Diagnostic(
                    "WF215",
                    f"recovery= over the native C++ resident core at "
                    f"{name}, but the loaded libwfnative.so predates "
                    f"the state ABI (no wf_core_state_export) — the "
                    f"first epoch checkpoint raises SnapshotUnsupported "
                    f"(patterns/native_core.py); rebuild with `make -C "
                    f"native`, or set WF_NO_NATIVE_CORE=1 to pin the "
                    f"snapshotable Python resident core",
                    node=name))
            elif (_is_async_core(core)
                    and getattr(core, "max_delay_s", None) is not None):
                diags.append(Diagnostic(
                    "WF202",
                    f"recovery= over a max_delay_ms device core at "
                    f"{name}: wall-clock flushes make replayed emission "
                    f"boundaries nondeterministic, so the core declines "
                    f"snapshots — drop max_delay_ms (count-triggered "
                    f"flushes recover exactly-once) or exclude this "
                    f"stage from recovery",
                    node=name))
        stages = getattr(node, "stages", None)
        if stages and any(_is_async_core(_core_of(s))
                          for s in stages[:-1]):
            diags.append(Diagnostic(
                "WF203",
                f"recovery= over fused chain {name}: a NON-TAIL stage "
                f"is an async device core, so the poll-timing of its "
                f"harvests shapes the tail's emission grouping and "
                f"replay cannot regenerate the seq numbering — use "
                f"add() instead of chain() to give the device stage "
                f"its own engine-driven thread",
                node=name))
        # terminal stage: judge the TAIL leaf, so a sink chained into a
        # fused group (SourceComb/Comb) is still seen as the sink it is
        tail = leaves[-1]
        if (not node._outputs and not isinstance(tail, SourceNode)
                and not getattr(tail, "recoverable", False)
                and not getattr(tail, "quarantine_exempt", False)):
            diags.append(Diagnostic(
                "WF204",
                f"recovery= with sink {name} not opted into restart: "
                f"sinks default to non-restartable (no downstream edge "
                f"can dedup replayed side effects), so a crash there "
                f"still tears the graph down — set "
                f"pattern.recoverable = True if the sink is idempotent",
                node=name))
    return diags


def _check_routing(df) -> list[Diagnostic]:
    """WF101: >= 2 keyed-state workers fed by a round-robin emitter —
    rows of one key land on different replicas and every per-key
    invariant (window content, fold state) silently corrupts."""
    diags = []
    dests: dict[int, list] = {}
    for src, dst in df._edges:
        if (type(src).__name__ == "StandardEmitter"
                and getattr(src, "routing", None) is None):
            dests.setdefault(id(src), [src]).append(dst)
    for _sid, group in dests.items():
        emitter, targets = group[0], group[1:]
        keyed = [t for t in {id(t): t for t in targets}.values()
                 if _has_keyed_state(t)]
        if len(keyed) >= 2:
            names = ", ".join(_stats_name(df, t) for t in keyed)
            diags.append(Diagnostic(
                "WF101",
                f"non-keyed emitter {_stats_name(df, emitter)} "
                f"round-robins batches across keyed-state workers "
                f"[{names}]: same-key rows split across replicas and "
                f"per-key state silently corrupts — route with "
                f"keyBy()/routing= (emitters.default_routing)",
                node=_stats_name(df, emitter)))
    return diags


def _check_windows(df) -> list[Diagnostic]:
    """WF102/WF103: window geometry.  Pattern-level when the graph came
    from a MultiPipe (anchored at the construction site, deduped per
    stage); node-core fallback for manual wirings."""
    diags = []
    pipe = getattr(df, "_check_pipe", None)
    if pipe is not None:
        for pattern in _iter_patterns(pipe):
            diags.extend(_check_pattern_window(pattern))
        return diags
    seen = set()
    for node in df.nodes:
        for leaf in _leaf_nodes(node):
            core = _core_of(leaf)
            spec = getattr(core, "spec", None)
            if spec is None:
                continue
            key = (leaf.name.rsplit(".", 1)[0], spec.win_len,
                   spec.slide_len)
            if key in seen:
                continue
            seen.add(key)
            if spec.slide_len > spec.win_len:
                diags.append(_hopping_diag(spec, _stats_name(df, node),
                                           None))
    return diags


def _hopping_diag(spec, where, anchor):
    return Diagnostic(
        "WF102",
        f"{where}: hopping window (slide {spec.slide_len} > win_len "
        f"{spec.win_len}) leaves gaps of {spec.slide_len - spec.win_len} "
        f"ids/ts between consecutive windows — rows landing there are "
        f"never aggregated; use slide <= win_len unless sampling is "
        f"intended", node=where, anchor=anchor)


def _check_pattern_window(pattern) -> list[Diagnostic]:
    diags = []
    spec = getattr(pattern, "spec", None)
    name = getattr(pattern, "name", type(pattern).__name__)
    anchor = _anchor_of(pattern)
    if spec is not None and spec.slide_len > spec.win_len:
        diags.append(_hopping_diag(spec, name, anchor))
    # pane decomposition (Pane_Farm family): panes are gcd(win, slide)
    # long, so a slide that does not divide the window degenerates the
    # decomposition (worst case gcd 1: every tuple its own pane)
    pane = getattr(pattern, "pane_len", None)
    if (pane is not None and spec is not None
            and spec.win_len % spec.slide_len != 0):
        diags.append(Diagnostic(
            "WF103",
            f"{name}: slide {spec.slide_len} does not divide win_len "
            f"{spec.win_len}, so the pane decomposition runs "
            f"gcd-sized panes of {pane} (win/pane={spec.win_len // pane} "
            f"partials per window) — pick win_len a multiple of "
            f"slide_len to keep panes slide-sized",
            node=name, anchor=anchor))
    return diags


def _check_closures(df) -> list[Diagnostic]:
    """WF301/WF302 over every user function object shared by >= 2
    runtime nodes (the replica-sharing that makes captured state a
    cross-thread race)."""
    fns: dict[int, list] = {}
    for node in df.nodes:
        for leaf in _leaf_nodes(node):
            fn = getattr(leaf, "fn", None)
            if fn is not None and hasattr(fn, "__code__"):
                fns.setdefault(id(fn), []).append((fn, leaf))
    diags = []
    for group in fns.values():
        if len(group) < 2:
            continue
        fn, leaf = group[0]
        owner = leaf.name.rsplit(".", 1)[0]
        diags.extend(analyze_function(fn, len(group), owner))
    return diags


def _check_effects(df) -> list[Diagnostic]:
    """WF303/304/305 (check/effects.py) over user functions whose node
    contracts arm an effect family: recovery+recoverable arms the
    replay checks, a latency-triggered Rescale rule arms the blocking
    check.  One finding per (pattern, call site) — farm replicas share
    the fn, so the walk dedups by pattern name."""
    from .effects import analyze_effects

    ctl = df.control
    diags = []
    seen: set[tuple] = set()
    for node in df.nodes:
        for leaf in _leaf_nodes(node):
            fns = []
            fn = getattr(leaf, "fn", None)
            if fn is not None and hasattr(fn, "__code__"):
                fns.append(fn)
            wfn = getattr(getattr(_core_of(leaf), "winfunc", None),
                          "fn", None)
            if wfn is not None and hasattr(wfn, "__code__"):
                fns.append(wfn)
            if not fns:
                continue
            owner = leaf.name.rsplit(".", 1)[0]
            active = set()
            if (df.recovery is not None
                    and getattr(leaf, "recoverable", False)):
                active |= {"WF303", "WF304"}
            if ctl is not None and hasattr(ctl, "rescale_for"):
                rule = ctl.rescale_for(owner)
                if rule is not None and (
                        getattr(rule, "up_q95_us", None) is not None
                        or getattr(rule, "up_slo_burn", None)
                        is not None):
                    active.add("WF305")
            if not active:
                continue
            for f in fns:
                for d in analyze_effects(f, active, owner):
                    key = (d.code, owner, d.anchor)
                    if key in seen:
                        continue
                    seen.add(key)
                    diags.append(d)
    return diags


def check_dataflow(df, skip_config: bool = False) -> list[Diagnostic]:
    """Every graph-level pass over a built Dataflow; ``skip_config``
    when the caller already ran the pipe-level knob checks (avoids
    duplicate WF207)."""
    diags = []
    if not skip_config:
        diags.extend(check_dataflow_config(df))
    diags.extend(_check_recovery(df))
    diags.extend(_check_routing(df))
    diags.extend(_check_windows(df))
    diags.extend(_check_closures(df))
    diags.extend(_check_effects(df))
    return diags
