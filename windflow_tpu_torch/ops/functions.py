"""Window-function contracts: non-incremental, incremental, and batched.

The reference supports two user-function shapes per window pattern
(``win_seq.hpp:116-117``):

* non-incremental (NIC): ``winFunction(key, gwid, Iterable<tuple>, result&)``
  evaluated over the whole window content on fire;
* incremental (INC): ``winUpdate(key, gwid, tuple, result&)`` folded per
  tuple as it arrives.

Its GPU path additionally requires a CUDA-compilable functor over flat arrays
(``win_seq_gpu.hpp:54-67``): ``F(key, gwid, data*, result*, size, scratch*)``.

A TPU cannot JIT arbitrary host C++/Python per window, so this framework
defines the device contract at the *batch* level: a window function may
provide ``apply_batch(keys, gwids, cols, lens)`` where ``cols`` maps each
payload field to a ``(n_windows, pad_len)`` array and ``lens`` gives the
valid prefix per window.  Built-in monoid reducers implement all three
shapes; arbitrary user JAX functions are wrapped by :class:`JaxWindowFunction`
which vmaps them over the window batch; arbitrary Python functions fall back
to the host path.
"""

from __future__ import annotations

import numpy as np


class WindowFunction:
    """Non-incremental window function (host contract).

    Subclasses implement :meth:`apply`; implementing :meth:`apply_batch`
    opts into the batched/device path.
    """

    #: name -> numpy dtype of the produced result payload
    result_fields: dict
    #: input columns apply_batch needs (None = all); declaring them lets the
    #: engine gather/stage only what the function reads
    required_fields = None

    def apply(self, key: int, gwid: int, rows: np.ndarray) -> tuple:
        """Evaluate one window. `rows` is a structured array of the tuples in
        the window (possibly empty). Returns the result payload values in
        `result_fields` order."""
        raise NotImplementedError

    def apply_batch(self, keys, gwids, cols, lens):
        """Optional vectorised evaluation of many windows at once.

        cols: {field: (n, pad)} padded columns; lens: (n,) valid lengths.
        Returns {field: (n,)} result payload columns. Padding rows are zeros.
        """
        raise NotImplementedError

    @property
    def supports_batch(self) -> bool:
        return type(self).apply_batch is not WindowFunction.apply_batch


class WindowUpdate:
    """Incremental per-tuple fold (host contract, O(1) state per window)."""

    result_fields: dict

    def init(self, key: int, gwid: int) -> np.void:
        """Fresh accumulator record (defaults to zeros)."""
        dt = np.dtype([(k, v) for k, v in self.result_fields.items()])
        return np.zeros((), dtype=dt)

    def update(self, key: int, gwid: int, row: np.void, acc: np.void) -> None:
        raise NotImplementedError

    def update_many(self, key: int, gwid: int, rows: np.ndarray, acc: np.void) -> None:
        """Fold a chunk of in-order rows; default is a per-row loop —
        monoid reducers override with a vectorised fold."""
        for row in rows:
            self.update(key, gwid, row, acc)


class FnWindowFunction(WindowFunction):
    """Adapts a plain Python callable ``fn(key, gwid, rows) -> value(s)``."""

    def __init__(self, fn, result_fields):
        self.fn = fn
        self.result_fields = dict(result_fields)

    def apply(self, key, gwid, rows):
        out = self.fn(key, gwid, rows)
        return out if isinstance(out, tuple) else (out,)


class FnWindowUpdate(WindowUpdate):
    """Adapts a plain Python callable ``fn(key, gwid, row, acc) -> None``."""

    def __init__(self, fn, result_fields):
        self.fn = fn
        self.result_fields = dict(result_fields)

    def update(self, key, gwid, row, acc):
        self.fn(key, gwid, row, acc)


from .monoid import NP_UFUNCS as _UFUNCS
from .monoid import identity as _monoid_identity


class Reducer(WindowFunction, WindowUpdate):
    """Built-in monoid reduction over one payload field.

    Serves as NIC function, INC update, *and* batched/device function —
    the three are algebraically identical for a monoid, which the
    differential tests rely on (mirroring the reference's NIC/INC parity
    in ``src/sum_test_cpu/test_all_cb.cpp``).
    """

    def __init__(self, op: str, field: str = "value", out_field: str = None,
                 dtype=np.int64, value_range=None):
        if op == "count":
            self.ufunc = None
        else:
            self.ufunc = _UFUNCS[op]
        self.op = op
        self.field = field
        self.out_field = out_field or field
        self.dtype = np.dtype(dtype)
        self.result_fields = {self.out_field: self.dtype}
        self.required_fields = () if op == "count" else (self.field,)
        #: optional (lo, hi) bound on the input field's values — lets the
        #: device path prove a narrow accumulate dtype cannot wrap (e.g.
        #: values in [0, 100) summed over a 256-row window fit int32) and
        #: skip the wrap warning that would otherwise fire on dtypes alone
        self.value_range = value_range

    # identity element for empty windows / fresh accumulators
    def _identity(self):
        return _monoid_identity(self.op, self.dtype)

    # --- NIC ---
    def apply(self, key, gwid, rows):
        if self.op == "count":
            return (len(rows),)
        if len(rows) == 0:
            return (self.dtype.type(self._identity()),)
        return (self.ufunc.reduce(rows[self.field].astype(self.dtype)),)

    def apply_batch(self, keys, gwids, cols, lens):
        n, pad = next(iter(cols.values())).shape if cols else (len(lens), 0)
        if self.op == "count":
            return {self.out_field: lens.astype(self.dtype)}
        vals = cols[self.field].astype(self.dtype)
        mask = np.arange(pad)[None, :] < lens[:, None]
        ident = self.dtype.type(self._identity())
        vals = np.where(mask, vals, ident)
        return {self.out_field: self.ufunc.reduce(vals, axis=1)}

    # --- INC ---
    def init(self, key, gwid):
        acc = np.zeros((), dtype=np.dtype([(self.out_field, self.dtype)]))
        acc[self.out_field] = self._identity()
        return acc

    def update(self, key, gwid, row, acc):
        if self.op == "count":
            acc[self.out_field] += 1
        else:
            acc[self.out_field] = self.ufunc(
                acc[self.out_field], self.dtype.type(row[self.field]))

    def update_many(self, key, gwid, rows, acc):
        if self.op == "count":
            acc[self.out_field] += len(rows)
        elif len(rows):
            acc[self.out_field] = self.ufunc(
                acc[self.out_field],
                self.ufunc.reduce(rows[self.field].astype(self.dtype)))

    @property
    def supports_batch(self):
        return True


class MultiReducer(WindowFunction, WindowUpdate):
    """Several monoid stats over the same windows in one evaluation — e.g.
    YSB's per-campaign COUNT(*) + MAX(ts) (yahoo_app.hpp:150-156), or
    count + sum + max of one value column.

    ``stats`` are (op, field, out_field) triples or ready Reducers.  Like
    :class:`Reducer` it serves as NIC function, INC update, and batched
    function; the resident device path evaluates every non-count stat over
    ONE shipped column set in one fused dispatch (count is answered
    host-side from the window lengths — no device work).
    """

    def __init__(self, *stats, dtype=np.int64):
        parts = []
        for s in stats:
            if isinstance(s, Reducer):
                parts.append(s)
            else:
                op, field, out_field = s
                parts.append(Reducer(op, field or "value", out_field,
                                     dtype=dtype))
        if not parts:
            raise ValueError("MultiReducer needs at least one stat")
        outs = [p.out_field for p in parts]
        if len(set(outs)) != len(outs):
            raise ValueError(f"duplicate out_fields: {outs}")
        self.parts = parts
        self.result_fields = {}
        for p in parts:
            self.result_fields.update(p.result_fields)
        self.required_fields = tuple(dict.fromkeys(
            f for p in parts for f in p.required_fields))

    @property
    def device_parts(self):
        """Stats needing device evaluation (count is free host-side)."""
        return [p for p in self.parts if p.op != "count"]

    @property
    def count_parts(self):
        return [p for p in self.parts if p.op == "count"]

    # --- NIC ---
    def apply(self, key, gwid, rows):
        return tuple(v for p in self.parts for v in p.apply(key, gwid, rows))

    def apply_batch(self, keys, gwids, cols, lens):
        out = {}
        for p in self.parts:
            out.update(p.apply_batch(keys, gwids, cols, lens))
        return out

    # --- INC ---
    def init(self, key, gwid):
        acc = np.zeros((), dtype=np.dtype(
            [(k, v) for k, v in self.result_fields.items()]))
        for p in self.parts:
            if p.op != "count":
                acc[p.out_field] = p._identity()
        return acc

    def update(self, key, gwid, row, acc):
        for p in self.parts:
            p.update(key, gwid, row, acc)

    def update_many(self, key, gwid, rows, acc):
        for p in self.parts:
            p.update_many(key, gwid, rows, acc)

    @property
    def supports_batch(self):
        return True


def as_window_function(f, result_fields=None) -> WindowFunction:
    if isinstance(f, WindowFunction):
        return f
    if callable(f):
        if result_fields is None:
            raise ValueError("result_fields required for a plain callable")
        return FnWindowFunction(f, result_fields)
    raise TypeError(f"cannot interpret {f!r} as a window function")


def as_window_update(f, result_fields=None) -> WindowUpdate:
    if isinstance(f, WindowUpdate):
        return f
    if callable(f):
        if result_fields is None:
            raise ValueError("result_fields required for a plain callable")
        return FnWindowUpdate(f, result_fields)
    raise TypeError(f"cannot interpret {f!r} as a window update")
