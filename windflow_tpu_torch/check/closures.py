"""Closure race analyzer (WF3xx): bytecode inspection of user functions
shared by parallel replicas.

A pattern built with ``parallelism > 1`` hands the SAME function object
to every replica thread (patterns/basic.py ``_make_replica``).  Captured
state is therefore shared across threads, and a function that *mutates*
a closed-over list/dict — ``sent[0] += n``, ``counts.update(...)`` — or
rebinds a closed-over variable (``STORE_DEREF``) is a probable data
race: the classic "my benchmark counter loses increments at pardegree 4"
bug the C++ reference cannot even express (its functors are copied per
replica).

Heuristics, deliberately conservative:

* only functions actually shared by >= 2 runtime nodes are analyzed;
* only free variables whose **live cell contents** are mutable
  containers (list/dict/set/bytearray/ndarray) can trigger the
  mutation checks — captured ints, schemas, and callables never flag;
* a function that also captures a ``threading`` lock (Lock/RLock/
  Semaphore/Condition) is skipped entirely: the author synchronised,
  and the analyzer cannot see critical-section extents;
* ``# wf-lint: disable=WF301`` on the offending line or the ``def``
  line suppresses (check/directives.py).
"""

from __future__ import annotations

import dis

from .diagnostics import Diagnostic
from .directives import suppressed_at

#: method names that mutate their receiver — flagging a call of one on a
#: closed-over container
_MUTATORS = frozenset({
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "update", "setdefault", "add", "discard", "sort", "reverse",
    "appendleft", "extendleft", "popleft", "rotate", "fill", "put",
    "__setitem__",
})

import collections as _collections  # noqa: E402  (stdlib, import-light)

_MUTABLE_TYPES = (list, dict, set, bytearray, _collections.deque)

#: 3.10 spells augmented assignment as dedicated opcodes; 3.11+ folds
#: them into BINARY_OP whose argrepr carries the ``=`` (e.g. ``+=``)
_INPLACE_OPS = frozenset({
    "INPLACE_ADD", "INPLACE_SUBTRACT", "INPLACE_MULTIPLY",
    "INPLACE_TRUE_DIVIDE", "INPLACE_FLOOR_DIVIDE", "INPLACE_MODULO",
    "INPLACE_POWER", "INPLACE_LSHIFT", "INPLACE_RSHIFT", "INPLACE_AND",
    "INPLACE_OR", "INPLACE_XOR", "INPLACE_MATRIX_MULTIPLY",
})


def _is_inplace(ins) -> bool:
    if ins.opname in _INPLACE_OPS:
        return True
    return (ins.opname == "BINARY_OP"
            and "=" in (getattr(ins, "argrepr", "") or ""))


def _is_mutable_cell(value) -> bool:
    if isinstance(value, _MUTABLE_TYPES):
        return True
    # numpy arrays without importing numpy here
    return type(value).__name__ == "ndarray"


def _is_lock(value) -> bool:
    name = type(value).__name__
    mod = type(value).__module__
    return (mod in ("_thread", "threading")
            and name in ("lock", "LockType", "RLock", "_RLock", "Lock",
                         "Semaphore", "BoundedSemaphore", "Condition"))


def _cells(fn) -> dict[str, object]:
    """freevar name -> live cell content (unset cells are skipped)."""
    code = getattr(fn, "__code__", None)
    closure = getattr(fn, "__closure__", None)
    if code is None or not closure:
        return {}
    out = {}
    for name, cell in zip(code.co_freevars, closure):
        try:
            out[name] = cell.cell_contents
        except ValueError:       # cell not yet filled
            continue
    return out


def analyze_function(fn, shared_by: int, owner: str) -> list[Diagnostic]:
    """WF301/WF302 findings for ``fn`` running concurrently in
    ``shared_by`` replica threads of pattern/node ``owner``."""
    code = getattr(fn, "__code__", None)
    if code is None or shared_by < 2:
        return []
    cells = _cells(fn)
    if any(_is_lock(v) for v in cells.values()):
        return []        # author synchronised: trust the lock
    mutable = {n for n, v in cells.items() if _is_mutable_cell(v)}
    filename = code.co_filename
    def_line = code.co_firstlineno

    diags: list[Diagnostic] = []
    seen: set[tuple[str, str, int]] = set()

    def flag(codeid, msg, line):
        key = (codeid, msg, line or def_line)
        if key in seen:
            return
        seen.add(key)
        if suppressed_at(filename, line or def_line, codeid,
                         also_lines=(def_line,)):
            return
        diags.append(Diagnostic(codeid, msg, node=owner,
                                anchor=(filename, line or def_line)))

    fname = getattr(fn, "__qualname__", getattr(fn, "__name__", "<fn>"))
    line = def_line
    #: freevar names whose value is on the stack "recently" — a cheap
    #: window: a LOAD_DEREF of a mutable freevar arms the next
    #: subscript-store / mutator-call on the same source line
    armed: dict[str, int] = {}    # container itself on the stack
    derived: dict[str, int] = {}  # value read OUT of a closed container
    pending_method: tuple[str, int] | None = None
    #: (var, line) pairs already reported as in-place mutations — the
    #: compiler follows the INPLACE op with a STORE_DEREF rebind of the
    #: same name, which must not double-flag
    inplace_hit: set[tuple[str, int]] = set()
    prev = prev_val = ""
    for ins in dis.get_instructions(code):
        sl = ins.starts_line
        if sl:   # int on <= 3.12, True on 3.13+ (line_number carries it)
            line = getattr(ins, "line_number", None) or int(sl)
            armed.clear()
            derived.clear()
            pending_method = None
        op = ins.opname
        # 3.10 spells the augmented-subscript pair-duplication
        # DUP_TOP_TWO; 3.11+ spells it as two COPY instructions
        if (op == "BINARY_SUBSCR" and armed
                and prev not in ("DUP_TOP_TWO", "COPY")):
            # a plain read (`x = closed[k]`) consumed the container — a
            # later same-line STORE_SUBSCR targets something else, but a
            # mutating METHOD on the read-out value (`closed[k].append`)
            # still mutates shared state.  The augmented form
            # (`closed[k] += v`) duplicates the pair first
            # (DUP_TOP_TWO), so the container stays the store's target.
            derived.update(armed)
            armed.clear()
        if op in ("STORE_DEREF", "DELETE_DEREF") \
                and ins.argval in code.co_freevars:
            if (ins.argval, line) not in inplace_hit:
                flag("WF301",
                     f"{fname!r} ({owner}, parallelism {shared_by}) "
                     f"rebinds closed-over {ins.argval!r} from parallel "
                     f"replicas", line)
        elif op in ("STORE_GLOBAL", "DELETE_GLOBAL"):
            flag("WF302",
                 f"{fname!r} ({owner}, parallelism {shared_by}) rebinds "
                 f"module global {ins.argval!r} from parallel replicas",
                 line)
        elif op == "LOAD_DEREF" and ins.argval in mutable:
            armed[ins.argval] = line
        elif _is_inplace(ins) and armed:
            # `closed[k] += v` / `closed += [v]`: the in-place op runs
            # on the shared container (read-modify-write, the classic
            # lost-increment race).  Consume `armed` so the compiler's
            # trailing STORE_SUBSCR does not flag the same site twice.
            var, at = next(iter(armed.items()))
            flag("WF301",
                 f"{fname!r} ({owner}, parallelism {shared_by}) "
                 f"augments closed-over {type(cells[var]).__name__} "
                 f"{var!r} in place (read-modify-write) from parallel "
                 f"replicas", at)
            inplace_hit.add((var, at))
            armed.clear()
        elif op in ("STORE_SUBSCR", "DELETE_SUBSCR") and armed:
            var, at = next(iter(armed.items()))
            flag("WF301",
                 f"{fname!r} ({owner}, parallelism {shared_by}) writes "
                 f"into closed-over {type(cells[var]).__name__} "
                 f"{var!r} from parallel replicas", at)
            armed.clear()
        elif op in ("LOAD_METHOD", "LOAD_ATTR") and (armed or derived):
            # receiver-aware: the attribute is ON the shared container
            # only when the previous instruction put that container (or
            # a value read out of it) on top of the stack — an
            # unrelated receiver (`counts[b.x] += 1` loading `b.x`)
            # must not disarm the pending container
            on_container = ((prev == "LOAD_DEREF" and prev_val in armed)
                            or (prev == "BINARY_SUBSCR" and derived))
            if on_container:
                if ins.argval in _MUTATORS:
                    var, at = next(iter((armed or derived).items()))
                    pending_method = (var, at)
                armed.clear()
                derived.clear()
        elif op.startswith("CALL") and pending_method is not None:
            var, at = pending_method
            flag("WF301",
                 f"{fname!r} ({owner}, parallelism {shared_by}) calls a "
                 f"mutating method on closed-over "
                 f"{type(cells[var]).__name__} {var!r} from parallel "
                 f"replicas", at)
            pending_method = None
        prev, prev_val = op, ins.argval
    return diags
