"""Structure-of-arrays tuple batches — the unit of data exchange.

The reference library moves one C++ struct at a time between threads
(``wrapper_tuple_t``, reference ``meta_utils.hpp:354``) and only forms
contiguous batches at the GPU boundary (``win_seq_gpu.hpp:96``).  A TPU-native
design inverts this: the *stream itself* is chunked into structure-of-arrays
batches from the source onward, so every operator is a vectorised array
transform and the device boundary needs no marshalling step — the batch
columns stage straight into device buffers.

The reference "tuple protocol" ``getInfo()/setInfo()`` returning
``(key, id, ts)`` (reference ``src/sum_test_cpu/sum_cb.hpp:31-88``) becomes
three mandatory int64 columns ``key``/``id``/``ts`` plus arbitrary payload
columns described by a :class:`Schema`.
"""

from __future__ import annotations

import numpy as np

# Mandatory columns implementing the (key, id, ts) tuple protocol.
INFO_FIELDS = ("key", "id", "ts")
# Internal column: EOS punctuation markers travel in-band like the reference's
# per-key EOS marker tuples (reference wf_nodes.hpp:177-191).  Marker rows
# advance window state but are never archived nor folded into results.
MARKER_FIELD = "marker"


class Schema:
    """Describes the payload columns of a stream (name -> numpy dtype)."""

    def __init__(self, **fields):
        self.fields = {name: np.dtype(dt) for name, dt in fields.items()}

    def dtype(self) -> np.dtype:
        base = [(f, np.int64) for f in INFO_FIELDS]
        base.append((MARKER_FIELD, np.bool_))
        base += [(name, dt) for name, dt in self.fields.items()]
        return np.dtype(base)

    def payload_names(self):
        return tuple(self.fields.keys())

    def __repr__(self):
        inner = ", ".join(f"{k}={v}" for k, v in self.fields.items())
        return f"Schema({inner})"

    def __eq__(self, other):
        return isinstance(other, Schema) and self.fields == other.fields


def make_batch(schema: Schema, n: int) -> np.ndarray:
    """Allocate an empty (zeroed) batch of `n` rows for `schema`."""
    return np.zeros(n, dtype=schema.dtype())


def batch_from_columns(schema: Schema, key, id, ts, **payload) -> np.ndarray:
    key = np.asarray(key, dtype=np.int64)
    out = make_batch(schema, key.shape[0])
    out["key"] = key
    out["id"] = np.asarray(id, dtype=np.int64)
    out["ts"] = np.asarray(ts, dtype=np.int64)
    for name, col in payload.items():
        out[name] = col
    return out


def concat(batches) -> np.ndarray:
    batches = [b for b in batches if b is not None and len(b)]
    if not batches:
        return None
    if len(batches) == 1:
        return batches[0]
    return np.concatenate(batches)


def schema_of(batch: np.ndarray) -> Schema:
    """Recover a Schema from a structured batch array."""
    skip = set(INFO_FIELDS) | {MARKER_FIELD}
    return Schema(**{n: batch.dtype[n] for n in batch.dtype.names if n not in skip})


def group_by_key(keys: np.ndarray):
    """Stable group-by: returns ``(order, starts, ends)`` where
    ``order[starts[i]:ends[i]]`` indexes group *i*'s rows in arrival order
    and ``keys[order[starts[i]]]`` is its key.  The one idiom behind every
    per-key hot path (emitters, accumulator, ordering, window cores);
    handles the empty batch (all three arrays empty)."""
    order = np.argsort(keys, kind="stable")
    if len(order) == 0:
        z = np.zeros(0, dtype=np.int64)
        return order, z, z
    sk = keys[order]
    starts = np.concatenate(([0], np.flatnonzero(np.diff(sk)) + 1))
    ends = np.concatenate((starts[1:], [len(sk)]))
    return order, starts, ends
