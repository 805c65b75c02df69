"""Shared key->dense-slot registry for vectorised per-key state.

The multi-key hot paths (VecIncTumblingCore, WFCollectorNode) keep per-key
state in parallel arrays indexed by a dense slot id.  This helper owns the
one subtle piece both need: a vectorised lookup that maps a chunk's key
column to slots, registering first-seen keys in first-appearance order and
maintaining a sorted view for ``np.searchsorted`` lookups.
"""

from __future__ import annotations

import numpy as np


def segments(sorted_vals: np.ndarray):
    """(starts, ends) of equal-value runs in a sorted array."""
    starts = np.concatenate(([0], np.flatnonzero(np.diff(sorted_vals)) + 1))
    ends = np.concatenate((starts[1:], [len(sorted_vals)]))
    return starts, ends


def segmented_excl_running_max(s: np.ndarray, p: np.ndarray,
                               starts: np.ndarray,
                               head_seed: np.ndarray) -> np.ndarray:
    """Per-segment EXCLUSIVE running max of `p` (segments = equal runs of
    the sorted `s`), seeded with `head_seed[i]` at segment i's head — the
    vectorised form of the reference's per-row running-max ordering check
    (win_seq.hpp:293-305), O(rows log rows) by Hillis-Steele doubling."""
    q = p.copy()
    q[starts] = np.maximum(q[starts], head_seed)
    sh = 1
    n = len(q)
    while sh < n:
        same = s[sh:] == s[:-sh]
        np.maximum(q[sh:], np.where(same, q[:-sh], q[sh:]), out=q[sh:])
        sh *= 2
    excl = np.empty(n, dtype=np.int64)
    excl[1:] = q[:-1]
    excl[starts] = head_seed
    return excl


class SlotMap:
    """Dense int slots for int64 keys; lookup is O(rows log keys)."""

    __slots__ = ("n", "keys", "_sorted_keys", "_sorted_slots", "_on_register")

    def __init__(self, on_register=None):
        self.n = 0
        self.keys = np.zeros(0, dtype=np.int64)      # slot -> key
        self._sorted_keys = np.zeros(0, dtype=np.int64)
        self._sorted_slots = np.zeros(0, dtype=np.int64)
        #: optional hook called with the (m,) array of newly registered keys
        #: (their slots are n-m .. n-1) — per-key init math goes here
        self._on_register = on_register

    def _register(self, new_keys: np.ndarray):
        uniq, first_idx = np.unique(new_keys, return_index=True)
        k = uniq[np.argsort(first_idx)]              # first-appearance order
        new_slots = np.arange(self.n, self.n + len(k), dtype=np.int64)
        self.keys = np.concatenate((self.keys[:self.n], k))
        self.n += len(k)
        # merge the m new keys into the sorted view (O(K + m log m)): a
        # full re-argsort here is O(K log K) *per registration*, quadratic
        # total when keys trickle in one-per-chunk (ADVICE r2)
        order = np.argsort(k, kind="stable")
        ks, ss = k[order], new_slots[order]
        pos = np.searchsorted(self._sorted_keys, ks)
        self._sorted_keys = np.insert(self._sorted_keys, pos, ks)
        self._sorted_slots = np.insert(self._sorted_slots, pos, ss)
        if self._on_register is not None:
            self._on_register(k)

    def state_snapshot(self) -> dict:
        """Data-only snapshot (recovery layer): the registered keys and
        the sorted lookup view — the ``on_register`` hook is identity,
        not state, and stays bound to the live owner on restore."""
        return {"n": self.n, "keys": self.keys[:self.n].copy(),
                "sorted_keys": self._sorted_keys.copy(),
                "sorted_slots": self._sorted_slots.copy()}

    def state_restore(self, snap: dict):
        self.n = snap["n"]
        self.keys = snap["keys"].copy()
        self._sorted_keys = snap["sorted_keys"].copy()
        self._sorted_slots = snap["sorted_slots"].copy()

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Slots for `keys` (int64 array), registering unseen keys."""
        if self.n:
            idx = np.searchsorted(self._sorted_keys, keys)
            idxc = np.minimum(idx, self.n - 1)
            found = self._sorted_keys[idxc] == keys
            if found.all():
                return self._sorted_slots[idxc]
            self._register(keys[~found])
        else:
            self._register(keys)
        idx = np.searchsorted(self._sorted_keys, keys)
        return self._sorted_slots[idx]
