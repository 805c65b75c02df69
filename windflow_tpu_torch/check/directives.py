"""``# wf-lint:`` suppression directives.

A diagnostic anchored at ``file:line`` is suppressed when that source
line (or, for multi-line statements, the line the anchor points into)
carries a trailing directive:

    agg = PaneFarm(plq, wlq, 10, 3)   # wf-lint: disable=WF103
    counts[key] += 1                  # wf-lint: disable=WF301,WF302
    legacy_build()                    # wf-lint: disable

``disable`` with no code list suppresses every diagnostic anchored at
the line.  Codes are comma-separated, case-insensitive, and must look
like catalog ids (``WF`` + digits) — anything else is ignored rather
than silently suppressing the world.
"""

from __future__ import annotations

import linecache
import re

_DIRECTIVE = re.compile(r"#\s*wf-lint\s*:\s*disable(?:\s*=\s*([\w,\s]+))?",
                        re.IGNORECASE)


def parse_directive(line: str) -> set[str] | None:
    """Codes disabled by ``line``: a set of WF ids, the sentinel
    ``{"all"}`` for a bare ``disable``, or None when no directive."""
    m = _DIRECTIVE.search(line)
    if m is None:
        return None
    raw = m.group(1)
    if raw is None:
        return {"all"}
    codes = {c.strip().upper() for c in raw.split(",") if c.strip()}
    # drop anything that does not look like a catalog id: a typo'd code
    # must suppress NOTHING (an empty set), never widen to everything
    return {c for c in codes if re.fullmatch(r"WF\d+", c)}


def suppressed_at(filename: str, lineno: int, code: str,
                  also_lines=()) -> bool:
    """True when ``code`` is disabled at ``filename:lineno`` (or any of
    the extra candidate lines — e.g. a function's ``def`` line for a
    diagnostic anchored at a body instruction)."""
    # suppression is consulted only when a diagnostic fired (cold path):
    # pay the stat to never read a stale cached copy of an edited file
    linecache.checkcache(filename)
    for ln in (lineno, *also_lines):
        if not ln:
            continue
        disabled = parse_directive(linecache.getline(filename, ln))
        if disabled and ("all" in disabled or code in disabled):
            return True
    return False
