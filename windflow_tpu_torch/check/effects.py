"""Effect analyzer (WF303-WF305): bytecode inspection of user functions
for calls whose *runtime effects* break a declared contract.

The closure analyzer (WF301/302, check/closures.py) asks "does this fn
race against its own replicas?".  This pass asks the complementary
question the recovery/control subsystems need answered: "is this fn
safe to RE-EXECUTE (replay) or to sit under a latency trigger?"

* **WF303 — replay nondeterminism.**  ``recovery=`` replays a crashed
  node's input from the journal and promises byte-identical re-emission
  (docs/ROBUSTNESS.md).  A recoverable fn calling ``time.time()``,
  ``random.random()``, ``os.urandom()``, ``uuid.uuid4()`` or the numpy
  *global* RNG produces different bytes on replay and diverges from the
  journal oracle.  A fn that CAPTURES a seeded generator
  (``np.random.default_rng(seed)``, ``random.Random(seed)``) is exempt:
  seeded-generator state is part of the snapshot, the blessed pattern.
* **WF304 — side effects under restart.**  A node opted into restart
  (``pattern.recoverable = True`` under ``recovery=``) re-fires
  file/socket/subprocess/HTTP calls on replay, and no downstream edge
  can deduplicate an external effect — the "sinks are not restartable
  by default" rationale of recovery/, caught at lint time.
* **WF305 — blocking calls under latency control.**  ``sleep``, an
  untimed ``.acquire()``, a blocking ``.recv()`` inside the svc of a
  node governed by ``Rescale(up_q95_us=/up_slo_burn=)`` inflates the
  very tail-latency signal the rule watches: phantom rescales.

Mechanics: a conservative ``dis`` pass sharing the WF301/302 suppression
machinery (``# wf-lint: disable=`` on the call line or the ``def``
line).  Call targets are resolved through a small shadow stack —
``LOAD_GLOBAL``/``LOAD_ATTR`` chains are resolved against the live
module globals, everything unrecognised degrades to *opaque* (never
misattributed, so the pass under-reports rather than false-positives).
One level of same-module call following: a helper defined next to the
user fn is scanned too, anchored at the helper's offending line.
"""

from __future__ import annotations

import dis
import sys

from .diagnostics import Diagnostic
from .directives import suppressed_at

#: WF305 method-name heuristic: a method call of one of these names on
#: an UNRESOLVED receiver blocks the caller (``acquire`` only when
#: called with no arguments — a timeout argument bounds the wait)
_BLOCKING_METHODS = frozenset({
    "acquire", "recv", "recvfrom", "recv_into", "accept",
})

_tables = None


def _put(table, obj, code, label):
    if obj is None:
        return
    try:
        table[obj] = (code, label)
    except TypeError:        # unhashable callable: cannot be looked up
        pass


def _build_tables():
    """callable -> (WF###, printable name).  Keyed by the object itself
    (plain functions hash by identity; builtin bound methods hash/compare
    by ``__self__`` + slot, so a freshly resolved ``datetime.now`` still
    matches).  Built lazily on the first analyzed fn — the check package
    is only ever imported on the cold lint path."""
    import datetime
    import os
    import random
    import secrets
    import select
    import shutil
    import socket
    import subprocess
    import time
    import uuid

    t: dict[object, tuple[str, str]] = {}

    # -- WF303: replay nondeterminism ----------------------------------
    for name in ("time", "time_ns", "monotonic", "monotonic_ns",
                 "perf_counter", "perf_counter_ns", "clock_gettime",
                 "clock_gettime_ns", "process_time", "process_time_ns",
                 "thread_time", "thread_time_ns"):
        _put(t, getattr(time, name, None), "WF303", f"time.{name}")
    for name in ("random", "randint", "randrange", "uniform", "gauss",
                 "normalvariate", "lognormvariate", "expovariate",
                 "betavariate", "gammavariate", "triangular", "choice",
                 "choices", "sample", "shuffle", "getrandbits",
                 "randbytes", "vonmisesvariate", "paretovariate",
                 "weibullvariate", "seed"):
        _put(t, getattr(random, name, None), "WF303", f"random.{name}")
    _put(t, os.urandom, "WF303", "os.urandom")
    _put(t, getattr(os, "getrandom", None), "WF303", "os.getrandom")
    for name in ("uuid1", "uuid4"):
        _put(t, getattr(uuid, name, None), "WF303", f"uuid.{name}")
    for name in ("token_bytes", "token_hex", "token_urlsafe",
                 "randbelow", "choice", "randbits"):
        _put(t, getattr(secrets, name, None), "WF303", f"secrets.{name}")
    _put(t, datetime.datetime.now, "WF303", "datetime.datetime.now")
    _put(t, datetime.datetime.utcnow, "WF303", "datetime.datetime.utcnow")
    _put(t, datetime.date.today, "WF303", "datetime.date.today")
    try:
        import numpy as np
    except ImportError:
        np = None
    if np is not None:
        # the legacy GLOBAL RNG only — np.random.default_rng(seed) is
        # the blessed replay-safe pattern and must never flag
        for name in ("rand", "randn", "random", "randint", "normal",
                     "uniform", "choice", "shuffle", "permutation",
                     "standard_normal", "random_sample", "ranf",
                     "sample", "bytes", "exponential", "poisson",
                     "binomial", "beta", "gamma", "seed"):
            _put(t, getattr(np.random, name, None), "WF303",
                 f"numpy.random.{name}")

    # -- WF304: external side effects ----------------------------------
    import builtins
    _put(t, builtins.open, "WF304", "open")
    _put(t, getattr(os, "open", None), "WF304", "os.open")
    for name in ("remove", "unlink", "rename", "replace", "rmdir",
                 "mkdir", "makedirs", "removedirs", "truncate", "write",
                 "system", "popen", "symlink", "link"):
        _put(t, getattr(os, name, None), "WF304", f"os.{name}")
    for name in ("copy", "copy2", "copyfile", "copytree", "move",
                 "rmtree"):
        _put(t, getattr(shutil, name, None), "WF304", f"shutil.{name}")
    for name in ("run", "Popen", "call", "check_call", "check_output"):
        _put(t, getattr(subprocess, name, None), "WF304",
             f"subprocess.{name}")
    _put(t, socket.socket, "WF304", "socket.socket")
    _put(t, socket.create_connection, "WF304", "socket.create_connection")
    try:
        import urllib.request as _urlreq
    except ImportError:
        _urlreq = None
    if _urlreq is not None:
        _put(t, _urlreq.urlopen, "WF304", "urllib.request.urlopen")
    try:
        import http.client as _httpc
    except ImportError:
        _httpc = None
    if _httpc is not None:
        _put(t, _httpc.HTTPConnection, "WF304",
             "http.client.HTTPConnection")
        _put(t, getattr(_httpc, "HTTPSConnection", None), "WF304",
             "http.client.HTTPSConnection")
    if "requests" in sys.modules:    # never imported just for the table
        req = sys.modules["requests"]
        for name in ("get", "post", "put", "delete", "head", "patch",
                     "request"):
            _put(t, getattr(req, name, None), "WF304", f"requests.{name}")

    # -- WF305: blocking calls -----------------------------------------
    _put(t, time.sleep, "WF305", "time.sleep")
    _put(t, select.select, "WF305", "select.select")
    return t


def _flag_tables():
    global _tables
    if _tables is None:
        _tables = _build_tables()
    return _tables


# ------------------------------------------------------- shadow stack

class _Chain:
    """A resolvable global-attribute chain on the shadow stack."""

    __slots__ = ("names",)

    def __init__(self, names):
        self.names = names


class _Method:
    """A method loaded off an opaque receiver (WF305 name heuristic)."""

    __slots__ = ("name", "line")

    def __init__(self, name, line):
        self.name = name
        self.line = line


_OPAQUE = object()    # any value the scanner does not model

#: ops handled by the shadow stack as "push one opaque value"
_PUSH1 = frozenset({
    "LOAD_CONST", "LOAD_FAST", "LOAD_DEREF", "LOAD_CLOSURE",
    "LOAD_CLASSDEREF", "LOAD_FAST_AND_CLEAR", "LOAD_FAST_CHECK",
    "LOAD_BUILD_CLASS", "PUSH_NULL", "LOAD_LOCALS", "GET_LEN",
})
_POP1 = frozenset({
    "POP_TOP", "STORE_FAST", "STORE_DEREF", "STORE_GLOBAL",
    "STORE_NAME", "RETURN_VALUE", "LIST_APPEND", "SET_ADD",
    "LIST_EXTEND", "SET_UPDATE", "DICT_UPDATE", "DICT_MERGE",
    "MAP_ADD", "YIELD_VALUE", "POP_JUMP_IF_TRUE", "POP_JUMP_IF_FALSE",
    "POP_JUMP_FORWARD_IF_TRUE", "POP_JUMP_FORWARD_IF_FALSE",
})
#: binary ops: pop two, push one opaque
_POP2_PUSH1 = frozenset({
    "BINARY_SUBSCR", "BINARY_OP", "COMPARE_OP", "IS_OP", "CONTAINS_OP",
    "BINARY_ADD", "BINARY_SUBTRACT", "BINARY_MULTIPLY", "BINARY_POWER",
    "BINARY_TRUE_DIVIDE", "BINARY_FLOOR_DIVIDE", "BINARY_MODULO",
    "BINARY_LSHIFT", "BINARY_RSHIFT", "BINARY_AND", "BINARY_OR",
    "BINARY_XOR", "BINARY_MATRIX_MULTIPLY", "INPLACE_ADD",
    "INPLACE_SUBTRACT", "INPLACE_MULTIPLY", "INPLACE_TRUE_DIVIDE",
    "INPLACE_FLOOR_DIVIDE", "INPLACE_MODULO", "INPLACE_POWER",
    "INPLACE_LSHIFT", "INPLACE_RSHIFT", "INPLACE_AND", "INPLACE_OR",
    "INPLACE_XOR", "INPLACE_MATRIX_MULTIPLY",
})
_UNARY = frozenset({
    "UNARY_NEGATIVE", "UNARY_POSITIVE", "UNARY_NOT", "UNARY_INVERT",
    "GET_ITER", "UNARY_CALL_INTRINSIC_1", "CALL_INTRINSIC_1",
    "TO_BOOL", "CAST",
})


def _resolve(chain, globals_ns):
    """The live object a ``_Chain`` names, or None."""
    import builtins
    obj = globals_ns.get(chain.names[0], _OPAQUE)
    if obj is _OPAQUE:
        obj = getattr(builtins, chain.names[0], _OPAQUE)
        if obj is _OPAQUE:
            return None
    for name in chain.names[1:]:
        try:
            obj = getattr(obj, name)
        except Exception:
            return None
    return obj


def _scan_code(fn, depth, seen, findings):
    """Append raw findings ``(wfcode, label, filename, line, def_line,
    via)`` for ``fn`` — and, at depth 0, one level of same-module
    helpers."""
    code = fn.__code__
    if code in seen:
        return
    seen.add(code)
    tables = _flag_tables()
    globals_ns = getattr(fn, "__globals__", {}) or {}
    filename = code.co_filename
    def_line = code.co_firstlineno
    is311 = sys.version_info >= (3, 11)

    stack: list = []
    line = def_line

    def pop(n):
        del stack[max(0, len(stack) - n):]

    def callee_at(pos):
        """Stack entry ``pos`` slots below the top (1-based), or
        _OPAQUE on underflow."""
        return stack[-pos] if len(stack) >= pos else _OPAQUE

    def record(entry, argc, call_line):
        """Judge one call: ``entry`` is the shadow-stack callee."""
        if isinstance(entry, _Method):
            if entry.name in _BLOCKING_METHODS and (
                    entry.name != "acquire" or argc == 0):
                what = (f"untimed .{entry.name}()" if entry.name ==
                        "acquire" else f"blocking .{entry.name}(...)")
                findings.append(("WF305", what, filename, entry.line,
                                 def_line, None))
            return
        if not isinstance(entry, _Chain):
            return
        obj = _resolve(entry, globals_ns)
        if obj is None:
            # unresolvable attribute call: the name heuristic still
            # applies (x.acquire() blocks whoever x turns out to be)
            if (len(entry.names) > 1
                    and entry.names[-1] in _BLOCKING_METHODS
                    and (entry.names[-1] != "acquire" or argc == 0)):
                findings.append(("WF305",
                                 f".{entry.names[-1]}(...)", filename,
                                 call_line, def_line, None))
            return
        try:
            hit = tables.get(obj)
        except TypeError:
            hit = None
        if hit is not None:
            wfcode, label = hit
            findings.append((wfcode, f"{label}()", filename, call_line,
                             def_line, None))
            return
        if (getattr(obj, "__name__", None) in _BLOCKING_METHODS
                and (obj.__name__ != "acquire" or argc == 0)):
            findings.append(("WF305", f".{obj.__name__}(...)", filename,
                             call_line, def_line, None))
            return
        # one level of same-module call following: a helper defined in
        # the fn's own module is effectively part of the user function
        if (depth == 0 and getattr(obj, "__code__", None) is not None
                and getattr(obj, "__globals__", None) is globals_ns):
            pre = len(findings)
            _scan_code(obj, 1, seen, findings)
            via = (getattr(obj, "__qualname__", "<helper>"), call_line,
                   def_line)
            for i in range(pre, len(findings)):
                f = findings[i]
                if f[5] is None:
                    findings[i] = f[:5] + (via,)

    for ins in dis.get_instructions(code):
        if ins.starts_line:
            line = getattr(ins, "line_number", None) or int(ins.starts_line)
        op = ins.opname
        # control flow invalidates the linear shadow stack: reset (calls
        # spanning a jump degrade to opaque — under-report, never
        # misattribute)
        if ins.is_jump_target:
            stack.clear()
            continue
        if op in ("LOAD_GLOBAL", "LOAD_NAME"):
            if is311 and op == "LOAD_GLOBAL" and ins.arg is not None \
                    and ins.arg & 1:
                stack.append(_OPAQUE)    # the NULL the call protocol eats
            stack.append(_Chain([ins.argval]))
        elif op == "LOAD_ATTR":
            top = stack.pop() if stack else _OPAQUE
            pushes_self = is311 and ins.arg is not None and ins.arg & 1 \
                and sys.version_info >= (3, 12)
            if isinstance(top, _Chain):
                entry = _Chain(top.names + [ins.argval])
            elif ins.argval in _BLOCKING_METHODS:
                entry = _Method(ins.argval, line)
            else:
                entry = _OPAQUE
            stack.append(entry)
            if pushes_self:
                stack.append(_OPAQUE)
        elif op == "LOAD_METHOD":
            top = stack.pop() if stack else _OPAQUE
            if isinstance(top, _Chain):
                entry = _Chain(top.names + [ins.argval])
            elif ins.argval in _BLOCKING_METHODS:
                entry = _Method(ins.argval, line)
            else:
                entry = _OPAQUE
            # 3.10 layout: push method, then self-or-NULL
            stack.append(entry)
            stack.append(_OPAQUE)
        elif op == "CALL_METHOD":            # 3.10
            argc = ins.arg or 0
            record(callee_at(argc + 2), argc, line)
            pop(argc + 2)
            stack.append(_OPAQUE)
        elif op == "CALL_FUNCTION":          # 3.10
            argc = ins.arg or 0
            record(callee_at(argc + 1), argc, line)
            pop(argc + 1)
            stack.append(_OPAQUE)
        elif op == "CALL_FUNCTION_KW":       # 3.10
            argc = ins.arg or 0
            record(callee_at(argc + 2), argc + 1, line)
            pop(argc + 2)
            stack.append(_OPAQUE)
        elif op == "CALL_FUNCTION_EX":
            n = 3 if (ins.arg or 0) & 1 else 2
            record(callee_at(n), 1, line)
            pop(n)
            stack.append(_OPAQUE)
        elif op in ("CALL", "CALL_KW"):      # 3.11+
            argc = ins.arg or 0
            extra = 3 if op == "CALL_KW" else 2
            record(callee_at(argc + extra), argc, line)
            pop(argc + extra)
            stack.append(_OPAQUE)
        elif op == "PRECALL" or op == "KW_NAMES":
            pass
        elif op in _PUSH1:
            stack.append(_OPAQUE)
        elif op in _POP1:
            pop(1)
        elif op in _POP2_PUSH1:
            pop(2)
            stack.append(_OPAQUE)
        elif op in _UNARY:
            pop(1)
            stack.append(_OPAQUE)
        elif op in ("BUILD_LIST", "BUILD_TUPLE", "BUILD_SET",
                    "BUILD_STRING", "BUILD_SLICE"):
            pop(ins.arg or 0)
            stack.append(_OPAQUE)
        elif op == "BUILD_MAP":
            pop(2 * (ins.arg or 0))
            stack.append(_OPAQUE)
        elif op == "BUILD_CONST_KEY_MAP":
            pop((ins.arg or 0) + 1)
            stack.append(_OPAQUE)
        elif op == "STORE_SUBSCR":
            pop(3)
        elif op in ("STORE_ATTR", "DELETE_SUBSCR"):
            pop(2)
        elif op == "DUP_TOP":
            stack.append(stack[-1] if stack else _OPAQUE)
        elif op == "DUP_TOP_TWO":
            pair = stack[-2:] if len(stack) >= 2 else [_OPAQUE, _OPAQUE]
            stack.extend(pair)
        elif op == "COPY":
            i = ins.arg or 1
            stack.append(stack[-i] if len(stack) >= i else _OPAQUE)
        elif op in ("ROT_TWO", "ROT_THREE", "ROT_FOUR", "SWAP"):
            # depth-preserving, but the reordered entries could land a
            # chain in a callee slot it does not occupy: blank them
            n = {"ROT_TWO": 2, "ROT_THREE": 3, "ROT_FOUR": 4}.get(
                op, ins.arg or 2)
            for i in range(1, min(n, len(stack)) + 1):
                stack[-i] = _OPAQUE
        elif op in ("NOP", "RESUME", "CACHE", "EXTENDED_ARG",
                    "SETUP_LOOP", "MAKE_CELL", "COPY_FREE_VARS",
                    "DELETE_FAST", "DELETE_DEREF", "DELETE_GLOBAL",
                    "DELETE_NAME"):
            pass
        else:
            # unmodelled opcode: degrade the whole expression to opaque
            stack.clear()
    seen.discard(code)


_raw_cache: dict[object, list] = {}


def _raw_effects(fn) -> list:
    """All raw effect findings of ``fn`` (every WF30x family, ungated) —
    cached per code object, the gate filters per node."""
    code = fn.__code__
    cached = _raw_cache.get(code)
    if cached is None:
        cached = []
        _scan_code(fn, 0, set(), cached)
        _raw_cache[code] = cached
    return cached


def _captures_seeded_generator(fn) -> bool:
    """True when ``fn`` closes over (or defaults to) a seeded RNG —
    the replay-safe pattern WF303 must trust, like the closure
    analyzer trusts a captured lock."""
    import random as _random
    candidates = []
    closure = getattr(fn, "__closure__", None)
    if closure:
        for cell in closure:
            try:
                candidates.append(cell.cell_contents)
            except ValueError:
                continue
    candidates.extend(getattr(fn, "__defaults__", None) or ())
    candidates.extend((getattr(fn, "__kwdefaults__", None) or {}).values())
    for v in candidates:
        tname = type(v).__name__
        tmod = type(v).__module__ or ""
        if tname in ("Generator", "RandomState") and \
                tmod.startswith("numpy"):
            return True
        if isinstance(v, _random.Random) and \
                not isinstance(v, _random.SystemRandom):
            return True
    return False


#: per-code gate context rendered into the message
_WHY = {
    "WF303": ("recovery= replays this node from the journal: the call "
              "returns different bytes on replay and the re-emission "
              "diverges from the journal oracle — capture a seeded "
              "generator (np.random.default_rng(seed)) instead"),
    "WF304": ("this node is opted into restart under recovery=: replay "
              "re-fires the external effect and no downstream edge can "
              "deduplicate it — drop the recoverable opt-in, or make "
              "the effect idempotent and suppress"),
    "WF305": ("a Rescale(up_q95_us=/up_slo_burn=) rule watches this "
              "node's tail latency: the block inflates q95/SLO burn and "
              "triggers phantom rescales — move the wait off the svc "
              "path, or gate scaling on depth instead"),
}


def analyze_effects(fn, active: set, owner: str) -> list[Diagnostic]:
    """Gated WF303/304/305 findings for user fn ``fn`` of node/pattern
    ``owner``; ``active`` is the subset of effect codes the node's
    declared contracts arm."""
    if getattr(fn, "__code__", None) is None or not active:
        return []
    wanted = set(active)
    if "WF303" in wanted and _captures_seeded_generator(fn):
        wanted.discard("WF303")
    if not wanted:
        return []
    fname = getattr(fn, "__qualname__", getattr(fn, "__name__", "<fn>"))
    caller_def = fn.__code__.co_firstlineno
    diags = []
    emitted = set()
    for wfcode, label, filename, line, def_line, via in _raw_effects(fn):
        if wfcode not in wanted:
            continue
        key = (wfcode, filename, line, label)
        if key in emitted:
            continue
        emitted.add(key)
        also = [def_line]
        detail = f"{fname!r} ({owner}) calls {label}"
        if via is not None:
            helper, call_line, _ = via
            detail = (f"{fname!r} ({owner}) calls {label} via helper "
                      f"{helper!r}")
            also.extend((call_line, caller_def))
        if suppressed_at(filename, line, wfcode, also_lines=tuple(also)):
            continue
        diags.append(Diagnostic(
            wfcode, f"{detail}: {_WHY[wfcode]}", node=owner,
            anchor=(filename, line)))
    return diags
