"""Carrying window state across from the JAX package.

This system has no weights: its state is the window core's per-key
bookkeeping, ``WinSeqCore._keys`` — a dict from key to ``_KeyState``, each
holding a ``KeyArchive`` of in-flight rows and the window counters.  A JAX
``DeviceWinSeqCore.state_snapshot()`` returns that dict; :func:`carry_core_state`
rebuilds it from the port's own classes so that a port core continues the
stream with ``state_restore`` where the JAX core left off.

A JAX ``ResidentWinSeqCore.state_snapshot()`` adds the ring cursors and
a ``RingSnapshot`` of the device ring — of every field's ring, in field
order, for a core over a ``MultiFieldResidentExecutor``;
:func:`carry_resident_state` carries those too.  A mesh core's rings
(sharded over the kf axis in JAX) resolve to one physical ``(KP, cap)``
array each, shard ``s``'s rows at ``s * KP / S``: the layout the port's
mesh executors restore from.  (``NativeResidentCore`` state blobs come from the same C++
library in both packages and carry across as bytes.)

The source objects are read by attribute name only (duck typing): nothing
here imports the JAX package.
"""

from __future__ import annotations

import copy

import numpy as np

from .core.archive import KeyArchive
from .core.winseq import _KeyState


def _carry_archive(src) -> KeyArchive:
    arch = KeyArchive.__new__(KeyArchive)
    arch.pos_field = src.pos_field
    arch._buf = np.array(src._buf, copy=True)
    arch._start = int(src._start)
    arch._end = int(src._end)
    return arch


def _carry_key_state(src) -> _KeyState:
    st = _KeyState.__new__(_KeyState)
    for name in _KeyState.__slots__:
        value = getattr(src, name)
        setattr(st, name, _carry_archive(value) if name == "archive"
                else copy.deepcopy(value))
    return st


def carry_core_state(snapshot: dict) -> dict:
    """A window core snapshot (``{"_keys": {key: _KeyState}, "_in_dtype":
    dtype}``, as ``state_snapshot()`` of a JAX ``DeviceWinSeqCore`` returns
    it) rebuilt with the port's ``_KeyState``/``KeyArchive``, ready for the
    port core's ``state_restore``."""
    return {"_keys": {key: _carry_key_state(st)
                      for key, st in snapshot["_keys"].items()},
            "_in_dtype": snapshot["_in_dtype"]}


def carry_resident_state(snapshot: dict) -> dict:
    """A JAX ``ResidentWinSeqCore.state_snapshot()`` rebuilt for the port's
    ``ResidentWinSeqCore.state_restore``: the host bookkeeping through
    :func:`carry_core_state`, the ring cursors deep-copied, and the
    ring(s) as numpy arrays from the snapshot's ``resolve()`` (one per
    field for a multi-field core, in the executor's field order)."""
    out = carry_core_state(snapshot)
    out["resident"] = copy.deepcopy(snapshot["resident"])
    ring = snapshot.get("ring")
    if ring is not None:
        data = ring.resolve() if hasattr(ring, "resolve") else ring
        rings = data["rings"]
        out["ring"] = {"rings": (None if rings is None else
                                 tuple(np.array(r, copy=True) for r in rings)),
                       "KP": int(data["KP"]), "cap": int(data["cap"])}
    return out
