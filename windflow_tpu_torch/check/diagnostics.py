"""The ``WF###`` diagnostic catalog — the single source of truth for
code, severity, and one-line meaning.  docs/CHECKS.md documents each
entry and ``tests/test_docs.py`` drift-tests that the doc table and this
catalog list identical ids, the same contract ``obs.events.EVENT_KINDS``
has with the docs/OBSERVABILITY.md event table.

Codes are **append-only**: a released id never changes meaning or
severity family, because suppression directives (``# wf-lint:
disable=WF###``) embedded in user code reference them by id.

Numbering: WF1xx graph/topology, WF2xx configuration conflicts, WF3xx
closure/bytecode analysis.
"""

from __future__ import annotations

ERROR = "error"
WARNING = "warning"

#: code -> (severity, one-line title).  docs/CHECKS.md carries the long
#: form (example, fix, suppression); tests enforce id-set equality.
CATALOG: dict[str, tuple[str, str]] = {
    # -- WF1xx: graph / topology ----------------------------------------
    "WF101": (ERROR,
              "keyed-state workers fed by a non-keyed (round-robin) "
              "emitter: same-key rows split across replicas"),
    "WF102": (WARNING,
              "hopping window (slide > win_len): rows falling in the "
              "inter-window gaps are never aggregated"),
    "WF103": (WARNING,
              "pane factor does not divide the window: pane "
              "decomposition degenerates to gcd-sized panes"),
    # -- WF2xx: configuration conflicts ---------------------------------
    # WF201 retired (id never reused): the native core gained a state
    # ABI, so recovery= over it is supported whenever the loaded .so
    # exports the state symbols — WF215 warns on the stale-.so case.
    "WF202": (ERROR,
              "recovery= over a max_delay_ms device core: wall-clock "
              "flushes make replay emission boundaries nondeterministic"),
    "WF203": (ERROR,
              "recovery= over a fused chain with a non-tail async device "
              "stage: replay cannot regenerate the emission numbering"),
    "WF204": (WARNING,
              "recovery= with a sink not opted into restart: a sink "
              "crash still tears the graph down (side effects cannot be "
              "deduplicated)"),
    "WF205": (ERROR,
              "WireConfig heartbeat >= stall_timeout: a healthy peer's "
              "beats arrive too late and every read stall-times-out"),
    "WF206": (WARNING,
              "heartbeat sender paired with a receiver lacking "
              "stall_timeout: the beats are sent but nothing bounds the "
              "read, so a dead peer still hangs forever"),
    "WF207": (WARNING,
              "metrics=/sample_period= with no resolvable trace_dir: "
              "the sampler runs but metrics.jsonl/events.jsonl are "
              "never written"),
    "WF208": (ERROR,
              "shed/put_deadline overload knobs on unbounded inboxes "
              "(capacity <= 0): the queue never fills, so the knobs are "
              "inert while memory grows without bound"),
    "WF209": (WARNING,
              "control= set without metrics=/sample_period=: the "
              "controller's only sensor is the sampler, so every rule "
              "is silently inert"),
    "WF210": (ERROR,
              "Rescale rule targets a pattern that cannot migrate "
              "keyed state (recoverable opted out, or not "
              "key-partitioned): the migration cut can never seal"),
    "WF211": (ERROR,
              "control= has Rescale rules but recovery= is unset: live "
              "rescale seals at epoch barriers, which only a "
              "RecoveryPolicy's triggers inject"),
    "WF212": (ERROR,
              "Rescale rule targets a pattern name not wired into the "
              "graph: the controller refuses to attach at run()"),
    "WF213": (WARNING,
              "trace= with no resolvable trace_dir: sampled spans stay "
              "in the bounded in-memory ring and trace.jsonl is never "
              "written"),
    "WF214": (WARNING,
              "WireConfig resume= without recovery=: no sealed-epoch "
              "acks flow back, so the sender journal can never trim and "
              "fills to its cap"),
    "WF215": (WARNING,
              "recovery=/Rescale over a native core whose loaded .so "
              "lacks the state ABI: default execution runs, but the "
              "first snapshot or migration declines with "
              "SnapshotUnsupported"),
    "WF216": (WARNING,
              "plane supervisor/rolling restart over a wire without "
              "resume=: at handoff the dead process's in-flight frames "
              "have no journal to replay from and are silently lost"),
    "WF217": (WARNING,
              "federate= set without metrics=/sample_period=: the "
              "shipper's only source is the sampler, so no snapshot is "
              "ever shipped and federation is silently inert"),
    # -- WF22x: plane topology (cross-process, check/plane.py) ----------
    "WF220": (ERROR,
              "plane topology broken: a host ships rows to a pid with "
              "no declared address/spec, two hosts claim one address, "
              "or the address book and host specs disagree on the pid "
              "set"),
    "WF221": (ERROR,
              "row dtype mismatch across a plane edge: the sender's "
              "row dtype is not what the receiver expects, so every "
              "decoded batch is garbage (or the decoder rejects it)"),
    "WF222": (ERROR,
              "resume= on only one end of a plane edge: a journaling "
              "sender facing a non-resuming receiver (or vice versa) "
              "breaks the resume handshake at reconnect"),
    "WF223": (WARNING,
              "PlanePolicy supervision declared but no host offers a "
              "ckpt_sink/portable-spool replica target: a takeover has "
              "no portable checkpoint to restore from, so cross-host "
              "recovery silently degrades to an empty restart"),
    "WF224": (ERROR,
              "federation shipping misrouted: a host federates but no "
              "host aggregates the plane's telemetry, or two hosts "
              "claim the aggregator role for one plane"),
    # -- WF3xx: closure race analysis -----------------------------------
    "WF301": (WARNING,
              "user function shared by parallel replicas mutates "
              "closed-over mutable state: probable data race"),
    "WF302": (WARNING,
              "user function shared by parallel replicas rebinds a "
              "module global: probable data race"),
    # -- WF30x: effect analysis (check/effects.py) ----------------------
    "WF303": (WARNING,
              "nondeterministic call (time/random/uuid/os.urandom/"
              "numpy RNG) in a recovery=-recoverable node without a "
              "captured seeded generator: replay after a crash "
              "re-executes the fn and diverges from the journal"),
    "WF304": (WARNING,
              "external side effect (file/socket/subprocess/HTTP) in a "
              "node opted into restart: replay re-fires the effect — "
              "no downstream edge can deduplicate it"),
    "WF305": (WARNING,
              "blocking call (sleep/untimed acquire/blocking recv) in "
              "a node governed by a latency-triggered Rescale rule: "
              "self-inflicted q95/SLO-burn skew triggers phantom "
              "rescales"),
}


class CheckWarning(UserWarning):
    """Category for ``check='warn'`` diagnostics (and the engine's
    stand-alone WF207 silent-no-op warning)."""


class Diagnostic:
    """One finding: a catalog code plus the specific site."""

    __slots__ = ("code", "severity", "message", "node", "anchor",
                 "suppressed")

    def __init__(self, code: str, message: str, node: str = None,
                 anchor: tuple[str, int] = None):
        if code not in CATALOG:
            raise KeyError(f"unknown diagnostic code {code!r} "
                           f"(add it to check.diagnostics.CATALOG)")
        self.code = code
        self.severity = CATALOG[code][0]
        self.message = message
        #: canonical node id (tracing.node_stats_name) or node name,
        #: when the finding pins to one node
        self.node = node
        #: (filename, lineno) source anchor, when one is known — pattern
        #: construction sites and closure bytecode carry these
        self.anchor = anchor
        self.suppressed = False

    def where(self) -> str:
        if self.anchor:
            return f"{self.anchor[0]}:{self.anchor[1]}"
        return self.node or "<config>"

    def __str__(self):
        loc = f" [{self.where()}]" if (self.anchor or self.node) else ""
        return f"{self.code} {self.severity}: {self.message}{loc}"

    def __repr__(self):
        return f"<Diagnostic {self.code} {self.where()}>"


class CheckReport:
    """Ordered collection of diagnostics with suppression applied at
    :meth:`finish` (``# wf-lint: disable=WF###`` at the anchor line —
    check/directives.py)."""

    def __init__(self):
        self.diagnostics: list[Diagnostic] = []
        self.suppressed: list[Diagnostic] = []

    def add(self, diag: Diagnostic):
        self.diagnostics.append(diag)

    def extend(self, diags):
        self.diagnostics.extend(diags)

    def finish(self) -> "CheckReport":
        """Partition out anchor-line-suppressed diagnostics; idempotent."""
        from .directives import suppressed_at
        keep, drop = [], []
        for d in self.diagnostics:
            if d.anchor and suppressed_at(d.anchor[0], d.anchor[1], d.code):
                d.suppressed = True
                drop.append(d)
            else:
                keep.append(d)
        self.diagnostics = keep
        self.suppressed.extend(drop)
        return self

    @property
    def has_errors(self) -> bool:
        return any(d.severity == ERROR for d in self.diagnostics)

    def codes(self) -> set[str]:
        return {d.code for d in self.diagnostics}

    def __len__(self):
        return len(self.diagnostics)

    def __iter__(self):
        return iter(self.diagnostics)

    def render(self) -> str:
        if not self.diagnostics:
            return "no diagnostics"
        return "\n".join(str(d) for d in self.diagnostics)


class CheckError(RuntimeError):
    """Raised by ``check='error'`` before any node thread starts; carries
    the full report on ``.report``."""

    def __init__(self, report: CheckReport):
        self.report = report
        errs = [d for d in report if d.severity == ERROR]
        head = (f"{len(errs)} error diagnostic"
                f"{'s' if len(errs) != 1 else ''} "
                f"(and {len(report) - len(errs)} warning(s)); "
                f"docs/CHECKS.md documents each code, `# wf-lint: "
                f"disable=<code>` at the anchor line suppresses one")
        super().__init__(head + "\n" + report.render())
