"""Pre-flight static analysis — the Python port's stand-in for the C++
reference's compile-time template checks (PAPER.md: WindFlow rejects
ill-formed graphs at template-instantiation time; a dynamic port must
recover that property with an explicit validation pass).

The subsystem is a catalog of ``WF###`` diagnostics (docs/CHECKS.md) plus
three passes over a *built but not yet running* graph:

* :mod:`.config` — knob-conflict checks on ``Dataflow``/``MultiPipe``
  configuration and on :class:`~windflow_tpu_torch.parallel.channel.WireConfig`
  (WF2xx);
* :mod:`.graph` — a walk of the materialised node graph: recovery over
  non-snapshotable cores, keyed state behind non-keyed emitters, window
  geometry (WF1xx/WF2xx);
* :mod:`.closures` — the closure race analyzer: bytecode inspection of
  user functions shared by parallel replicas (WF3xx).

Entry points: :func:`validate` (returns a :class:`CheckReport`) and
:func:`enforce` (the ``check=`` knob's runtime hook — warn or raise).

Contract with the engine: ``check=`` unset means this package
is **never imported** — the engine's lazy import is the only coupling, so
the seed hot paths stay byte-identical.
"""

from __future__ import annotations

import warnings

from .diagnostics import (CATALOG, CheckError, CheckReport, CheckWarning,
                          Diagnostic)


def validate(target) -> CheckReport:
    """Run every applicable pass over ``target`` and return the report.

    ``target`` may be a :class:`~windflow_tpu_torch.api.multipipe.MultiPipe`
    (built on demand — pre-build config conflicts that would make the
    build itself raise, e.g. WF208, are reported instead of raised), a
    built :class:`~windflow_tpu_torch.runtime.engine.Dataflow`, a
    :class:`~windflow_tpu_torch.parallel.channel.WireConfig`, or a
    :class:`~windflow_tpu_torch.parallel.plane.PlanePolicy`.
    """
    from .config import check_pipe_config, check_plane, check_wire
    from .graph import check_dataflow

    report = CheckReport()
    kind = type(target).__name__
    if kind == "WireConfig":
        report.extend(check_wire(target))
        return report.finish()
    if kind == "PlanePolicy":
        # dispatched by type NAME, like WireConfig: the check package
        # must not import parallel.plane (the knob contract keeps that
        # module un-imported until a supervisor is actually built)
        report.extend(check_plane(target))
        return report.finish()
    if kind == "PlaneSpec":
        # declared multi-host topology (check/plane.py, WF22x)
        from .plane import check_plane_spec
        report.extend(check_plane_spec(target))
        return report.finish()
    if hasattr(target, "_build") and hasattr(target, "_stages"):
        # a MultiPipe: pre-build knob checks first — a fatal knob
        # conflict (WF208 at the Dataflow constructor, WF210/WF211 at
        # the control-plane wiring) means _build() itself would raise,
        # so the static report must not attempt it
        pre = check_pipe_config(target)
        report.extend(pre)
        if any(d.code in ("WF208", "WF210", "WF211") for d in pre):
            return report.finish()
        with warnings.catch_warnings():
            # the Dataflow constructor re-warns the WF207/WF209
            # conditions this report already carries as diagnostics —
            # a lint run must not double-fire them as live warnings
            warnings.simplefilter("ignore")
            df = target._build()
        report.extend(check_dataflow(df, skip_config=True))
        return report.finish()
    # a built Dataflow
    report.extend(check_dataflow(target))
    return report.finish()


def enforce(df):
    """The ``check=`` knob's hook, called by ``Dataflow.run()`` before
    any thread starts.  ``check='warn'`` reports every diagnostic as a
    :class:`CheckWarning`; ``check='error'`` additionally raises
    :class:`CheckError` when any error-severity diagnostic survives
    suppression.  Diagnostics are also mirrored into the dataflow's
    event log (kind ``check``) when observability is on."""
    from .graph import check_dataflow

    report = CheckReport()
    report.extend(check_dataflow(df))
    report.finish()
    for d in report.diagnostics:
        if df.events is not None:
            df.events.emit("check", dataflow=df.name, code=d.code,
                           severity=d.severity, node=d.node or "",
                           message=d.message)
        warnings.warn(str(d), CheckWarning, stacklevel=3)
    if df.check == "error" and report.has_errors:
        raise CheckError(report)
    return report


__all__ = ["CATALOG", "CheckError", "CheckReport", "CheckWarning",
           "Diagnostic", "validate", "enforce"]
