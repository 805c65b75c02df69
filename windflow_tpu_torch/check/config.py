"""Configuration-conflict checks (WF2xx): knobs that are individually
valid but jointly inert or fatal — the misconfigurations that otherwise
surface only deep at runtime (a ``recovery=`` graph dying at its first
checkpoint, a sampler that never writes a file, a heartbeat nobody
listens to)."""

from __future__ import annotations

from .diagnostics import Diagnostic


def check_wire(cfg) -> list[Diagnostic]:
    """WF205/WF206/WF214 over one :class:`~windflow_tpu_torch.parallel.
    channel.WireConfig` (sender heartbeat vs receiver stall timeout —
    and resume journal vs recovery acks — live on the same bundle, so
    the pairings are statically visible here)."""
    diags = []
    hb, stall = cfg.heartbeat, cfg.stall_timeout
    if hb is not None and stall is not None and hb >= stall:
        diags.append(Diagnostic(
            "WF205",
            f"heartbeat ({hb}s) must be < stall_timeout ({stall}s): the "
            f"receiver declares PeerStall before a healthy peer's next "
            f"beat can arrive (size stall_timeout to several heartbeat "
            f"intervals — WireConfig.hardened() uses 2s/10s)"))
    elif hb is not None and stall is None:
        diags.append(Diagnostic(
            "WF206",
            f"heartbeat={hb}s is sent but the receiving side has no "
            f"stall_timeout: beats buy nothing — a dead peer still "
            f"hangs the read forever (set stall_timeout on the paired "
            f"RowReceiver/WireConfig, docs/ROBUSTNESS.md)"))
    if getattr(cfg, "resume", None) and not getattr(cfg, "recovery",
                                                    False):
        diags.append(Diagnostic(
            "WF214",
            f"resume= is set but recovery= is not: the receiver never "
            f"acks sealed epochs back, so the sender journal can never "
            f"trim — it fills to journal_frames and then evicts, "
            f"breaking the replay guarantee for long streams (set "
            f"recovery=True, or ack sealed epochs yourself via "
            f"RowReceiver.ack_epoch; docs/ROBUSTNESS.md \"Wire "
            f"resume\")"))
    return diags


def check_plane(policy) -> list[Diagnostic]:
    """WF216 (plus the wire's own WF205/206/214) over one
    :class:`~windflow_tpu_torch.parallel.plane.PlanePolicy`: a supervised
    plane promises handoff — the successor's takeover receiver resumes
    from the dead peer's last sealed epoch and expects every surviving
    sender to REPLAY its journaled tail.  Without ``resume=`` on the
    plane's wire there is no journal, so the frames in flight at the
    death are silently lost at every handoff."""
    wire = getattr(policy, "wire", None)
    diags = [] if wire is None else list(check_wire(wire))
    if wire is None or not getattr(wire, "resume", None):
        diags.append(Diagnostic(
            "WF216",
            f"PlanePolicy wire "
            f"{'is unset' if wire is None else 'has no resume='}: the "
            f"supervisor's handoff rebinds a dead peer's address with "
            f"resume_epoch=, but non-journaling senders cannot replay "
            f"their in-flight tail to the successor — every handoff "
            f"silently drops the frames in flight at the death (set "
            f"WireConfig(resume=True, recovery=True) on the plane; "
            f"docs/ROBUSTNESS.md \"Cross-host recovery\")"))
    return diags


def _obs_configured(metrics, sample_period) -> bool:
    # mirror the engine's truthiness rule: metrics=False/0 means OFF
    return bool(metrics) or sample_period is not None


def _native_state_abi() -> bool:
    """True when device-farm workers would route to the native C++ core
    AND that core can migrate keyed state (the loaded .so exports the
    state ABI)."""
    from ..native import enabled
    lib = enabled()
    return lib is not None and getattr(lib, "wf_has_state_abi", False)


def _iter_pipe_patterns(pipe):
    for branch in pipe._branches:
        yield from _iter_pipe_patterns(branch)
    for _kind, pattern in pipe._stages:
        yield pattern


def check_pipe_control(pipe) -> list[Diagnostic]:
    """WF209/210/211 over a MultiPipe's ``control=`` knob — the WF210/
    WF211 conflicts are refused outright at build/construction time
    (like WF208), so they must be *reportable* pre-build."""
    diags = []
    ctl = pipe.control
    if ctl is None:
        return diags
    if not _obs_configured(pipe._metrics_arg, pipe.sample_period):
        diags.append(_blind_control_diag(f"MultiPipe {pipe.name!r}"))
    if getattr(ctl, "has_rescale", False) and pipe.recovery is None:
        diags.append(Diagnostic(
            "WF211",
            f"MultiPipe {pipe.name!r}: control= has Rescale rules but "
            f"recovery= is unset — live rescale seals at epoch "
            f"barriers, which only a RecoveryPolicy's epoch triggers "
            f"inject (the Dataflow constructor refuses this pair; "
            f"docs/CONTROL.md)"))
    targeted = {r.pattern for r in getattr(ctl, "rules", ())
                if type(r).__name__ == "Rescale"}
    wired = {getattr(p, "name", None)
             for p in _iter_pipe_patterns(pipe)}
    for missing in sorted(targeted - wired):
        diags.append(Diagnostic(
            "WF212",
            f"Rescale rule targets {missing!r}, but no pattern of that "
            f"name is wired into MultiPipe {pipe.name!r} — the "
            f"controller will refuse to attach at run() (typo'd "
            f"pattern name?)", node=missing))
    for pattern in _iter_pipe_patterns(pipe):
        name = getattr(pattern, "name", None)
        rule = ctl.rescale_for(name)
        if rule is None:
            continue
        anchor = getattr(pattern, "anchor", None)
        width = getattr(pattern, "_ctl_width0", None)
        if width is None:
            width = getattr(pattern, "parallelism", 1)
        if getattr(pattern, "routing", None) is None:
            diags.append(Diagnostic(
                "WF210",
                f"Rescale rule targets {name!r}, which is not "
                f"key-partitioned (no keyed routing): live rescale "
                f"migrates per-key state between workers — wrap the "
                f"computation in a Key_Farm (docs/CONTROL.md)",
                node=name, anchor=anchor))
        elif getattr(pattern, "recoverable", None) is False:
            diags.append(Diagnostic(
                "WF210",
                f"Rescale rule targets {name!r}, whose recoverable "
                f"flag is opted out: a pattern that cannot snapshot "
                f"cannot seal the migration cut — drop the opt-out or "
                f"the rule (docs/CONTROL.md)",
                node=name, anchor=anchor))
        elif not rule.min_workers <= width <= rule.max_workers:
            # the wiring layer refuses this at build, so it must be
            # REPORTABLE pre-build like WF208 (the skip list below keeps
            # validate() from attempting the raising _build)
            diags.append(Diagnostic(
                "WF210",
                f"Rescale rule for {name!r}: declared parallelism "
                f"{width} is outside the rule's "
                f"[{rule.min_workers}, {rule.max_workers}] range — the "
                f"build refuses it (docs/CONTROL.md)",
                node=name, anchor=anchor))
        elif getattr(pattern, "n_emitters", 1) > 1:
            diags.append(Diagnostic(
                "WF210",
                f"Rescale rule targets multi-emitter farm {name!r}: "
                f"ordered multi-emitter merges pin the channel count "
                f"at build time and cannot rescale (docs/CONTROL.md)",
                node=name, anchor=anchor))
        elif (type(pattern).__name__.endswith("GPU")
                and not _native_state_abi()):
            # duck-typed like the WF215 native-core probe: device farm
            # workers mirror per-key rows into HBM rings the host
            # migration hooks cannot move, so their cores set
            # keyed_migratable=False and attach refuses.  When the
            # native library exports the state ABI the farm's workers
            # route to the migratable C++ core instead, so stay quiet
            # and let attach-time validation judge the actual cores
            # (a float reducer still lands on a device core and is
            # refused there with the precise ValueError).
            diags.append(Diagnostic(
                "WF210",
                f"Rescale rule targets device farm {name!r} "
                f"({type(pattern).__name__}): device cores decline "
                f"keyed-state migration (per-key rows live in device "
                f"rings) — target a host Key_Farm (docs/CONTROL.md)",
                node=name, anchor=anchor))
    return diags


def check_pipe_config(pipe) -> list[Diagnostic]:
    """Pre-build knob checks on a MultiPipe — including the conflicts
    the engine would refuse at ``Dataflow`` construction (WF208/WF210/
    WF211), which must be *reportable* here because the deferred build
    hides them until ``run()``."""
    diags = []
    overload = pipe.overload
    if (overload is not None and getattr(overload, "reshapes_put", False)
            and pipe.capacity <= 0):
        diags.append(Diagnostic(
            "WF208",
            f"MultiPipe {pipe.name!r}: OverloadPolicy "
            f"shed={overload.shed!r}/put_deadline="
            f"{overload.put_deadline} needs a bounded inbox (capacity > "
            f"0, got {pipe.capacity}): an unbounded queue never sheds "
            f"and never times out"))
    diags.extend(check_pipe_control(pipe))
    from ..utils.tracing import default_trace_dir
    # judged on the pipe's OWN (merged) knobs only: union_multipipes has
    # already hoisted the operands' trace_dir/metrics/overload onto the
    # merged pipe, so recursing into branches would re-judge them in
    # isolation and report a false WF207 on a union whose other branch
    # supplies the trace_dir
    if (_obs_configured(pipe._metrics_arg, pipe.sample_period)
            and not (pipe.trace_dir or default_trace_dir())):
        diags.append(_no_trace_dir_diag(pipe.name))
    # trace= is truthiness-gated exactly like metrics= (falsy = OFF), and
    # judged on the pipe's own merged knobs for the same union reason
    if (getattr(pipe, "trace", None)
            and not (pipe.trace_dir or default_trace_dir())):
        diags.append(_ring_only_trace_diag(pipe.name))
    if (getattr(pipe, "federate", None)
            and not _obs_configured(pipe._metrics_arg,
                                    pipe.sample_period)):
        diags.append(_blind_federation_diag(f"MultiPipe {pipe.name!r}"))
    return diags


def _blind_control_diag(owner: str) -> Diagnostic:
    return Diagnostic(
        "WF209",
        f"{owner}: control= is set but neither metrics= nor "
        f"sample_period= is — the controller never receives a sampler "
        f"snapshot, so no rule can fire (set metrics=True; "
        f"docs/CONTROL.md)")


def _no_trace_dir_diag(name: str) -> Diagnostic:
    return Diagnostic(
        "WF207",
        f"{name!r} runs with metrics=/sample_period= but no resolvable "
        f"trace_dir (trace_dir= or WF_LOG_DIR): the live registry works "
        f"but metrics.jsonl/events.jsonl are never written — set "
        f"trace_dir to keep the telemetry")


def _blind_federation_diag(owner: str) -> Diagnostic:
    return Diagnostic(
        "WF217",
        f"{owner}: federate= is set but neither metrics= nor "
        f"sample_period= is — the federation shipper's only source is "
        f"the sampler, so no telemetry snapshot is ever shipped and "
        f"federation is silently inert (set metrics=True; "
        f"docs/OBSERVABILITY.md \"Federation & SLOs\")")


def _ring_only_trace_diag(name: str) -> Diagnostic:
    return Diagnostic(
        "WF213",
        f"{name!r} runs with trace= but no resolvable trace_dir "
        f"(trace_dir= or WF_LOG_DIR): sampled spans stay in the bounded "
        f"in-memory ring — trace.jsonl is never written, so wf_trace / "
        f"Perfetto export has nothing to read; set trace_dir to keep "
        f"the spans (docs/OBSERVABILITY.md §tracing)")


def check_dataflow_config(df) -> list[Diagnostic]:
    """Knob checks on a built Dataflow (the WF208/WF210/WF211 conflicts
    cannot exist here — constructor and wiring refuse them)."""
    diags = []
    if (_obs_configured(df.metrics, df.sample_period)
            and not df.trace_dir):
        diags.append(_no_trace_dir_diag(df.name))
    if getattr(df, "trace", None) and not df.trace_dir:
        diags.append(_ring_only_trace_diag(df.name))
    if df.control is not None and df.metrics is None:
        diags.append(_blind_control_diag(f"Dataflow {df.name!r}"))
    if getattr(df, "federate", None) is not None and df.metrics is None:
        diags.append(_blind_federation_diag(f"Dataflow {df.name!r}"))
    return diags
