#!/usr/bin/env python3
"""Twin of scripts/wf_lint.py over the PyTorch/CUDA port (windflow_tpu_torch):
the same CLI, seeds, cases and output lines, with every import taken from
the port.

wf-lint — stand-alone static analysis for windflow_tpu_torch graphs
(docs/CHECKS.md).

Imports one or more app modules, collects their dataflow graphs, runs
the ``windflow_tpu_torch/check`` validator, and prints each diagnostic with a
``file:line`` anchor when one is known:

    python scripts/torch_wf_lint.py windflow_tpu_torch.apps.ysb \
        windflow_tpu_torch.apps.pipe
    python scripts/torch_wf_lint.py path/to/my_app.py --error
    python scripts/torch_wf_lint.py --plane deploy/plane_spec.py --error
    python scripts/torch_wf_lint.py my_app.py --json

Graph discovery, per module:

* a callable ``wf_check_pipelines()`` (the convention the bundled bench
  apps follow) — returns an iterable of ``MultiPipe``/``Dataflow``/
  ``WireConfig``/``PlanePolicy`` objects to validate;
* otherwise, module-level attributes that already ARE such objects
  (manual-graph scripts that build a bare ``Dataflow`` at module level
  are lintable without the hook).

``--plane <spec>`` lints a declared multi-host topology instead
(check/plane.py, WF22x): the spec module advertises its
``windflow_tpu_torch.check.plane.PlaneSpec`` objects via a ``wf_plane_spec()``
callable or module-level instances.  ``--plane`` may repeat and may be
combined with positional app modules.

``--json`` replaces the human-readable report with one JSON document on
stdout for CI consumption::

    {"targets": 3, "diagnostics": [
        {"id": "WF205", "severity": "error", "module": "...",
         "target": "...", "file": "...", "line": 42,
         "message": "..."}, ...],
     "suppressed": [...]}       # only under --show-suppressed

Exit-code contract (stable, scriptable):

* **0** — every target validated; no diagnostic reported, or
  diagnostics were reported but ``--error`` was not given (lint is
  informational by default);
* **1** — ``--error`` was given and at least one non-suppressed
  diagnostic was reported (any severity: a warning-severity finding is
  still a finding);
* **2** — usage or import failure: a module failed to import, a
  ``--plane`` spec contained no PlaneSpec, or no lintable target was
  named.

``# wf-lint: disable=WF###`` on the anchored source line suppresses a
diagnostic (``--show-suppressed`` lists them anyway).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: module-level type names the fallback scan (no wf_check_pipelines()
#: hook) picks up as validation targets
_SCAN_TYPES = ("MultiPipe", "Dataflow", "WireConfig", "PlanePolicy")


def load_module(spec: str):
    """Import ``spec`` — a dotted module name or a path to a .py file."""
    if spec.endswith(".py") or os.path.sep in spec:
        path = os.path.abspath(spec)
        name = os.path.splitext(os.path.basename(path))[0]
        mspec = importlib.util.spec_from_file_location(name, path)
        if mspec is None:
            raise ImportError(f"cannot load {spec!r}")
        mod = importlib.util.module_from_spec(mspec)
        sys.modules.setdefault(name, mod)
        mspec.loader.exec_module(mod)
        return mod
    return importlib.import_module(spec)


def collect_targets(mod):
    """Validation targets of one module (see module docstring)."""
    hook = getattr(mod, "wf_check_pipelines", None)
    if callable(hook):
        targets = list(hook())
    else:
        targets = []
        for name in sorted(vars(mod)):
            obj = getattr(mod, name)
            if type(obj).__name__ in _SCAN_TYPES:
                targets.append(obj)
    return targets


def collect_plane_specs(mod):
    """PlaneSpec targets of one ``--plane`` spec module: a
    ``wf_plane_spec()`` hook, else module-level PlaneSpec objects."""
    hook = getattr(mod, "wf_plane_spec", None)
    if callable(hook):
        out = hook()
        return list(out) if isinstance(out, (list, tuple)) else [out]
    return [getattr(mod, name) for name in sorted(vars(mod))
            if type(getattr(mod, name)).__name__ == "PlaneSpec"]


def _diag_record(d, module: str, target: str) -> dict:
    rec = {"id": d.code, "severity": d.severity, "module": module,
           "target": target, "message": d.message}
    if d.anchor:
        rec["file"], rec["line"] = d.anchor[0], d.anchor[1]
    if d.node:
        rec["node"] = d.node
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="wf_lint", description="static analysis for windflow_tpu_torch "
        "graphs (docs/CHECKS.md)")
    ap.add_argument("modules", nargs="*",
                    help="dotted module names or .py paths to lint")
    ap.add_argument("--plane", action="append", default=[],
                    metavar="SPEC",
                    help="lint a declared multi-host topology: a module "
                    "exposing PlaneSpec objects (wf_plane_spec() hook "
                    "or module level); repeatable")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit one JSON document instead of the "
                    "human-readable report (see module docstring)")
    ap.add_argument("--error", action="store_true",
                    help="exit 1 when any diagnostic is reported")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print wf-lint:disable'd diagnostics")
    args = ap.parse_args(argv)
    if not args.modules and not args.plane:
        ap.print_usage(sys.stderr)
        print("wf_lint: name at least one module or --plane spec",
              file=sys.stderr)
        return 2

    from windflow_tpu_torch.check import validate

    out = [] if args.as_json else None
    out_sup = [] if args.as_json else None
    n_diags = n_targets = 0
    failed = False

    def run_targets(spec, targets):
        nonlocal n_diags, n_targets
        for target in targets:
            n_targets += 1
            tname = getattr(target, "name", type(target).__name__)
            report = validate(target)
            for d in report:
                n_diags += 1
                if out is not None:
                    out.append(_diag_record(d, spec, tname))
                else:
                    print(f"{d.where()}: {d.code} {d.severity}: "
                          f"{d.message}")
            if args.show_suppressed:
                for d in report.suppressed:
                    if out_sup is not None:
                        out_sup.append(_diag_record(d, spec, tname))
                    else:
                        print(f"{d.where()}: {d.code} suppressed: "
                              f"{d.message}")
            if not len(report) and out is None:
                print(f"{spec}:{tname}: OK")

    for spec in args.modules:
        try:
            mod = load_module(spec)
        except Exception as e:
            print(f"{spec}: import failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            return 2
        targets = collect_targets(mod)
        if not targets:
            print(f"{spec}: no dataflow graphs found (define "
                  f"wf_check_pipelines() or module-level MultiPipe/"
                  f"Dataflow/WireConfig/PlanePolicy objects)",
                  file=sys.stderr)
            failed = True
            continue
        run_targets(spec, targets)

    for spec in args.plane:
        try:
            mod = load_module(spec)
        except Exception as e:
            print(f"{spec}: import failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            return 2
        specs = collect_plane_specs(mod)
        if not specs:
            print(f"{spec}: no PlaneSpec found (define wf_plane_spec() "
                  f"or module-level PlaneSpec objects)", file=sys.stderr)
            failed = True
            continue
        run_targets(spec, specs)

    if out is not None:
        doc = {"targets": n_targets, "diagnostics": out}
        if args.show_suppressed:
            doc["suppressed"] = out_sup
        json.dump(doc, sys.stdout, indent=2)
        print()
    else:
        print(f"wf-lint: {n_targets} graph(s), {n_diags} diagnostic(s)")
    if failed:
        return 2
    if args.error and n_diags:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
