"""The sequential window core: batch-vectorised re-derivation of Win_Seq.

This is the engine at the centre of every windowed pattern (the reference's
``Win_Seq``, ``win_seq.hpp:268-474``, is the worker of every farm).  The
reference processes one tuple at a time, keeping a vector of live ``Window``
objects per key and evaluating a triggerer closure per tuple per window.
Here the same semantics are derived in closed form over *chunks*:

* the set of windows created by a chunk is ``[next_lwid, last_w(max_pos)]``
  (lazy creation, win_seq.hpp:344-352);
* the set of windows fired is ``[n_fired, fired_before(max_pos)) ∩ created``
  (triggerer, window.hpp:63-66);
* a fired window's content is the archive range ``[start, end)`` by
  position — equal to the reference's ``[firstTuple, firingTuple)`` range
  for in-order streams (win_seq.hpp:366-384);
* out-of-order tuples are dropped (win_seq.hpp:293-305), hopping-gap tuples
  are dropped (win_seq.hpp:326-338), EOS markers participate in window
  creation/firing but are never archived nor folded (win_seq.hpp:340,357);
* fired NIC windows purge the archive below their start (win_seq.hpp:390-392);
* PLQ/MAP roles renumber emitted result ids (win_seq.hpp:396-405);
* at EOS every still-open window is flushed over the archive tail
  (win_seq.hpp:433-474).

All per-chunk work is numpy array arithmetic; the per-window evaluation
either loops (arbitrary host functions) or batches (monoid reducers / JAX
functions via ``apply_batch``) — the batched form is exactly what the TPU
pattern stages to the device.
"""

from __future__ import annotations

import numpy as np

from .tuples import MARKER_FIELD, Schema
from .windows import PatternConfig, Role, WindowSpec, WinType
from ..ops.functions import WindowFunction, WindowUpdate

_NEG_INF = np.int64(-(2 ** 62))


class _KeyState:
    __slots__ = (
        "archive", "next_lwid", "n_fired", "rcv_counter", "last_pos",
        "emit_counter", "inc_accs", "inc_last_ts", "first_gwid", "initial_id",
        "marker_pos", "marker_ts",
    )

    def __init__(self, dtype, pos_field, first_gwid, initial_id, emit_counter0):
        from .archive import KeyArchive
        self.archive = KeyArchive(dtype, pos_field)
        self.next_lwid = 0
        self.n_fired = 0
        self.rcv_counter = 0
        self.last_pos = _NEG_INF
        self.emit_counter = emit_counter0
        self.inc_accs = {}      # lwid -> accumulator record (INC mode)
        self.inc_last_ts = {}   # lwid -> ts of last folded/continue row (CB)
        self.first_gwid = first_gwid
        self.initial_id = initial_id
        self.marker_pos = _NEG_INF
        self.marker_ts = 0


class WinSeqCore:
    """Role-aware sequential window engine over one keyed stream partition."""

    def __init__(self, spec: WindowSpec, winfunc, config: PatternConfig = None,
                 role: Role = Role.SEQ, map_indexes=(0, 1),
                 result_ts_slide: int = None):
        self.spec = spec
        # TB result ts uses the *global* slide of the logical window, which
        # differs from spec.slide_len inside a farm worker (private slide =
        # slide*pardegree). The reference quirkily uses the private slide
        # (window.hpp:124 with win_farm.hpp:134's slide), making farm output
        # ts diverge from Win_Seq's on the same stream; we normalise to the
        # sequential semantics so all compositions agree.
        self.result_ts_slide = (result_ts_slide if result_ts_slide is not None
                                else spec.slide_len)
        self.config = config or PatternConfig.plain(spec.slide_len)
        self.role = role
        self.map_indexes = map_indexes
        if isinstance(winfunc, WindowUpdate) and not isinstance(winfunc, WindowFunction):
            self.is_nic = False
        elif isinstance(winfunc, WindowFunction) and not isinstance(winfunc, WindowUpdate):
            self.is_nic = True
        else:
            # dual-mode (e.g. Reducer): default to NIC unless told otherwise
            self.is_nic = True
        self.winfunc = winfunc
        self.result_schema = Schema(**winfunc.result_fields)
        self._result_dtype = self.result_schema.dtype()
        self._payload_names = tuple(winfunc.result_fields.keys())
        self.pos_field = "id" if spec.win_type is WinType.CB else "ts"
        self._keys = {}           # key -> _KeyState, insertion ordered
        self._in_dtype = None

    def use_incremental(self):
        """Force INC mode for a dual-mode function (monoid reducer)."""
        self.is_nic = False
        return self

    # ------------------------------------------------------------------ utils

    def _state(self, key: int) -> _KeyState:
        st = self._keys.get(key)
        if st is None:
            emit0 = self.map_indexes[0] if self.role is Role.MAP else 0
            st = _KeyState(
                self._in_dtype, self.pos_field,
                self.config.first_gwid(key),
                self.config.initial_id(key, self.role),
                emit0,
            )
            self._keys[key] = st
        return st

    def _renumber_ids(self, key: int, st: _KeyState, gwids: np.ndarray) -> np.ndarray:
        """Result-id assignment incl. PLQ/MAP renumbering (win_seq.hpp:396-405)."""
        n = len(gwids)
        if self.role is Role.MAP:
            ids = st.emit_counter + np.arange(n, dtype=np.int64) * self.map_indexes[1]
            st.emit_counter += n * self.map_indexes[1]
            return ids
        if self.role is Role.PLQ:
            ni = self.config.n_inner
            inner_off = (self.config.id_inner - (key % ni) + ni) % ni
            ids = inner_off + (st.emit_counter + np.arange(n, dtype=np.int64)) * ni
            st.emit_counter += n
            return ids
        return gwids

    def _result_ts(self, st: _KeyState, lwids: np.ndarray, gwids: np.ndarray) -> np.ndarray:
        """CB: ts of the last CONTINUE row per window; TB: closed form
        (window.hpp:121-124,154)."""
        if self.spec.win_type is WinType.TB:
            return gwids * self.result_ts_slide + self.spec.win_len - 1
        ends_abs = self.spec.win_end(lwids) + st.initial_id
        starts_abs = self.spec.win_start(lwids) + st.initial_id
        out = np.zeros(len(lwids), dtype=np.int64)
        if self.is_nic:
            p = st.archive.positions
            ts = st.archive.rows["ts"]
            if len(p):
                idx = np.searchsorted(p, ends_abs, side="left") - 1
                # only rows inside [start, end) ever raised CONTINUE on this
                # window (rows archived before the window was created must
                # not contribute a timestamp; empty windows keep ts=0)
                valid = (idx >= 0) & (p[np.maximum(idx, 0)] >= starts_abs)
                out[valid] = ts[idx[valid]]
        else:
            for i, lw in enumerate(lwids):
                if int(lw) in st.inc_last_ts:
                    out[i] = st.inc_last_ts[int(lw)]
        # an EOS marker arrives after every real row and also raises CONTINUE,
        # so it overwrites the result ts of any window it falls below
        # (window.hpp:149-154 runs for marker tuples too)
        if st.marker_pos > _NEG_INF:
            out = np.where(st.marker_pos < ends_abs, st.marker_ts, out)
        return out

    def _make_results(self, key, ids, ts, payload_cols) -> np.ndarray:
        out = np.zeros(len(ids), dtype=self._result_dtype)
        out["key"] = key
        out["id"] = ids
        out["ts"] = ts
        for name in self._payload_names:
            out[name] = payload_cols[name]
        return out

    # ------------------------------------------------------------- processing

    def process(self, batch: np.ndarray) -> np.ndarray:
        """Consume one chunk (any mix of keys, in arrival order); return the
        chunk of window results emitted."""
        if self._in_dtype is None:
            self._in_dtype = batch.dtype
        if len(batch) == 0:
            return np.zeros(0, dtype=self._result_dtype)
        outs = []
        keys = batch["key"]
        if keys[0] == keys[-1] and not np.any(keys != keys[0]):
            r = self._process_key(int(keys[0]), batch)
            if r is not None:
                outs.append(r)
        else:
            # stable group-by key preserving arrival order within key
            order = np.argsort(keys, kind="stable")
            sorted_keys = keys[order]
            bounds = np.flatnonzero(np.diff(sorted_keys)) + 1
            for grp in np.split(order, bounds):
                r = self._process_key(int(keys[grp[0]]), batch[grp])
                if r is not None:
                    outs.append(r)
        if not outs:
            return np.zeros(0, dtype=self._result_dtype)
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    def _process_key(self, key: int, rows: np.ndarray):
        spec = self.spec
        st = self._state(key)
        pos = rows[self.pos_field].astype(np.int64)
        marker = rows[MARKER_FIELD]
        # --- drop out-of-order rows (strictly decreasing pos) ---
        runmax = np.maximum.accumulate(np.concatenate(([st.last_pos], pos)))[:-1]
        keep = pos >= runmax
        # --- drop rows before this worker's initial position ---
        keep &= pos >= st.initial_id
        rel = pos - st.initial_id
        # --- hopping gaps: drop non-marker rows outside every window ---
        if spec.is_hopping:
            keep &= spec.in_any_window(rel) | marker
        n_seen = int(np.count_nonzero(pos >= runmax))
        if n_seen:
            st.rcv_counter += n_seen
            st.last_pos = max(st.last_pos, int(pos.max()))
        if not np.all(keep):
            rows = rows[keep]
            pos = pos[keep]
            rel = rel[keep]
            marker = marker[keep]
        if len(rows) == 0:
            return None
        # --- track markers (they participate in firing & result-ts) ---
        if np.any(marker):
            mrows = rows[marker]
            st.marker_pos = int(mrows[self.pos_field][-1])
            st.marker_ts = int(mrows["ts"][-1])
            real = rows[~marker]
            real_pos = pos[~marker]
        else:
            real = rows
            real_pos = pos
        # --- archive (NIC only, non-marker rows; win_seq.hpp:340) ---
        if self.is_nic and len(real):
            st.archive.append(real)
            self._on_append(key, st, real)
        # --- window creation ---
        max_rel = int(rel.max())
        last_w = int(spec.last_win_containing(max_rel))
        new_next = max(st.next_lwid, last_w + 1)
        created = range(st.next_lwid, new_next)
        st.next_lwid = new_next
        # --- INC: fold chunk rows into every open window ---
        if not self.is_nic:
            for lw in created:
                gw = st.first_gwid + lw * self.config.gwid_stride()
                st.inc_accs[lw] = self.winfunc.init(key, gw)
            if len(real):
                rel_real = real_pos - st.initial_id
                for lw in list(st.inc_accs.keys()):
                    s, e = spec.win_start(lw), spec.win_end(lw)
                    lo = np.searchsorted(rel_real, s, side="left")
                    hi = np.searchsorted(rel_real, e, side="left")
                    if hi > lo:
                        gw = st.first_gwid + lw * self.config.gwid_stride()
                        self.winfunc.update_many(key, gw, real[lo:hi], st.inc_accs[lw])
                        st.inc_last_ts[lw] = int(real["ts"][hi - 1])
        # --- firing ---
        n_fireable = int(spec.fired_before(max_rel))
        n_fire_to = min(max(n_fireable, st.n_fired), st.next_lwid)
        if n_fire_to <= st.n_fired:
            return None
        lwids = np.arange(st.n_fired, n_fire_to, dtype=np.int64)
        st.n_fired = n_fire_to
        return self._emit_windows(key, st, lwids, eos=False)

    def _on_append(self, key, st: _KeyState, rows: np.ndarray):
        """Hook: called after `rows` are appended to `key`'s archive (the
        device-resident core mirrors appends into the HBM archive here)."""

    def _emit_windows(self, key, st: _KeyState, lwids: np.ndarray, eos: bool):
        spec = self.spec
        gwids = st.first_gwid + lwids * self.config.gwid_stride()
        ts = self._result_ts(st, lwids, gwids)
        if self.is_nic:
            starts_abs = spec.win_start(lwids) + st.initial_id
            ends_abs = spec.win_end(lwids) + st.initial_id
            cols = self._eval_nic(key, st, gwids, starts_abs, ends_abs, eos)
            if not eos and len(lwids):
                # purge below the start of the last fired window
                st.archive.purge_below(int(starts_abs[-1]))
        else:
            cols = {n: np.zeros(len(lwids), dtype=dt)
                    for n, dt in self.winfunc.result_fields.items()}
            for i, lw in enumerate(lwids):
                acc = st.inc_accs.pop(int(lw))
                st.inc_last_ts.pop(int(lw), None)
                for n in self._payload_names:
                    cols[n][i] = acc[n]
        ids = self._renumber_ids(key, st, gwids)
        return self._make_results(key, ids, ts, cols)

    def _eval_nic(self, key, st: _KeyState, gwids, starts_abs, ends_abs, eos: bool):
        """Evaluate NIC windows; batched when the function supports it."""
        p = st.archive.positions
        lo = np.searchsorted(p, starts_abs, side="left")
        hi = (np.full(len(starts_abs), len(p), dtype=np.int64) if eos
              else np.searchsorted(p, ends_abs, side="left"))
        lens = (hi - lo).astype(np.int64)
        if getattr(self.winfunc, "supports_batch", False) and len(gwids) > 1:
            pad = int(lens.max()) if len(lens) else 0
            arch = st.archive.rows
            idx = np.minimum(lo[:, None] + np.arange(max(pad, 1))[None, :],
                             max(len(arch) - 1, 0))
            pad_mask = np.arange(max(pad, 1))[None, :] >= lens[:, None]
            cols_in = {}
            req = getattr(self.winfunc, "required_fields", None)
            names = (tuple(req) if req is not None
                     else tuple(n for n in arch.dtype.names if n != MARKER_FIELD))
            for name in names:
                if len(arch):
                    col = arch[name][idx]
                    # honour the apply_batch contract: padding slots are zeros
                    col[pad_mask] = 0
                else:
                    col = np.zeros((len(gwids), max(pad, 1)),
                                   dtype=arch.dtype[name])
                cols_in[name] = col
            return self.winfunc.apply_batch(
                np.full(len(gwids), key, dtype=np.int64), gwids, cols_in, lens)
        cols = {n: np.zeros(len(gwids), dtype=dt)
                for n, dt in self.winfunc.result_fields.items()}
        arch = st.archive.rows
        for i in range(len(gwids)):
            vals = self.winfunc.apply(key, int(gwids[i]), arch[lo[i]:hi[i]])
            for n, v in zip(self._payload_names, vals):
                cols[n][i] = v
        return cols

    # -------------------------------------------------- keyed state migration

    #: explicit opt-in for the control plane's live rescale
    #: (control/rescale.py): the hooks below move the HOST per-key
    #: state only, so subclasses that mirror state elsewhere (device
    #: HBM ring archives, native C tables) MUST override this to False
    #: or a rescale would migrate half a key's state
    keyed_migratable = True

    def keyed_state_keys(self) -> np.ndarray:
        """Keys holding live state — the unit the control plane's live
        rescale repartitions (docs/CONTROL.md).  Key-partitioned farm
        workers share one PatternConfig, so a key's ``_KeyState`` is
        meaningful verbatim on any sibling worker."""
        if not self._keys:
            return np.zeros(0, dtype=np.int64)
        return np.fromiter(self._keys.keys(), dtype=np.int64,
                           count=len(self._keys))

    def keyed_state_export(self, keys: np.ndarray) -> dict:
        """Remove and return the per-key state of ``keys`` (a fragment
        ``keyed_state_import`` absorbs on a same-class, same-config
        sibling core).  Only called while both cores are quiescent (the
        rescale barrier parks every worker thread)."""
        return {"kind": "winseq",
                "keys": {int(k): self._keys.pop(int(k)) for k in keys},
                "in_dtype": self._in_dtype}

    def keyed_state_import(self, frag: dict):
        if frag["kind"] != "winseq":  # harmonized by control/rescale.py
            raise TypeError(f"cannot import {frag['kind']!r} state into "
                            f"WinSeqCore")
        if self._in_dtype is None:
            self._in_dtype = frag["in_dtype"]
        self._keys.update(frag["keys"])

    # ------------------------------------------------------------------- EOS

    def flush(self) -> np.ndarray:
        """Flush every still-open window (eosnotify, win_seq.hpp:433-474)."""
        outs = []
        for key, st in self._keys.items():
            if st.n_fired >= st.next_lwid:
                continue
            lwids = np.arange(st.n_fired, st.next_lwid, dtype=np.int64)
            st.n_fired = st.next_lwid
            r = self._emit_windows(key, st, lwids, eos=True)
            if r is not None:  # device cores enqueue instead of returning
                outs.append(r)
        if not outs:
            return np.zeros(0, dtype=self._result_dtype)
        return np.concatenate(outs)
