"""Durable checkpoint store: per-node pickle blobs + an atomically renamed
manifest per epoch, retained last-K.

Layout (under ``RecoveryPolicy.checkpoint_dir``)::

    epoch_000003/
        <node_id>.ckpt      # pickle of the node's state snapshot
        MANIFEST.json       # written LAST, via tmp + os.replace

An epoch directory without a manifest is an incomplete (in-progress or
crashed) checkpoint and is ignored by :meth:`latest_complete`.  Blobs are
also written tmp-then-rename so a reader never observes a torn file.
Each committed blob's manifest entry also records its CRC32
(``{"bytes": n, "crc": c}``), and :meth:`latest_complete` *verifies*
the newest sealed epoch against it — a torn or bit-flipped ``.ckpt``
(filesystem damage after the rename, a partially copied directory)
makes the restore fall back to the previous sealed epoch (counted as
``ckpt_fallbacks`` and evented as ``checkpoint_fallback``) instead of
raising mid-restore.
Snapshot states may contain lazy handles (e.g. the resident ring's
device→host copy, ops/resident.RingSnapshot): :func:`resolve_state`
materialises them just before pickling, on the supervisor's writer
thread — which is what lets the device transfer overlap ongoing compute.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import shutil
import time
import zlib

_EPOCH_DIR = re.compile(r"^epoch_(\d{6,})$")


def _safe_id(node_id: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.+-]", "_", node_id)


def resolve_state(state):
    """Materialise lazy snapshot handles (objects exposing ``resolve()``)
    into plain picklable values, recursively through dicts/lists/tuples."""
    if hasattr(state, "resolve"):
        return state.resolve()
    if isinstance(state, dict):
        return {k: resolve_state(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        out = [resolve_state(v) for v in state]
        return out if isinstance(state, list) else tuple(out)
    return state


class CheckpointStore:
    """Filesystem checkpoint store (one instance per Dataflow run, used
    from the supervisor's writer thread only — no internal locking)."""

    def __init__(self, root: str, retain: int = 2, metrics=None,
                 events=None):
        self.root = root
        self.retain = int(retain)
        #: optional observability hooks (obs.MetricsRegistry / EventLog):
        #: only the integrity-fallback path uses them, so a bare store
        #: stays dependency-free
        self._metrics = metrics
        self._events = events
        #: CRC32 of each blob written this run, keyed (epoch, safe_id);
        #: commit() folds them into the manifest's node meta
        self._crc: dict = {}
        os.makedirs(root, exist_ok=True)

    # ------------------------------------------------------------- writing

    def _epoch_dir(self, epoch: int) -> str:
        return os.path.join(self.root, f"epoch_{epoch:06d}")

    def save_blob(self, epoch: int, node_id: str, state) -> int:
        """Pickle one node's (resolved) state; returns the blob size in
        bytes.  Raises on unpicklable state — callers degrade to
        in-memory-only recovery for that node (checkpoint_skip event)."""
        d = self._epoch_dir(epoch)
        os.makedirs(d, exist_ok=True)
        blob = pickle.dumps(resolve_state(state),
                            protocol=pickle.HIGHEST_PROTOCOL)
        safe = _safe_id(node_id)
        path = os.path.join(d, f"{safe}.ckpt")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
        self._crc[(epoch, safe)] = zlib.crc32(blob) & 0xFFFFFFFF
        return len(blob)

    def commit(self, epoch: int, nodes: dict, partial: bool = False):
        """Seal the epoch: write the manifest (atomic rename, LAST) and
        prune beyond the retention window.  ``nodes`` maps node_id ->
        {"bytes": n} (or {"skipped": reason})."""
        d = self._epoch_dir(epoch)
        os.makedirs(d, exist_ok=True)
        safe_nodes = {}
        for k, v in nodes.items():
            safe = _safe_id(k)
            crc = self._crc.pop((epoch, safe), None)
            if crc is not None and "bytes" in v:
                v = dict(v, crc=crc)
            safe_nodes[safe] = v
        manifest = {"epoch": epoch, "t": time.time(), "partial": partial,
                    "nodes": safe_nodes}
        tmp = os.path.join(d, "MANIFEST.json.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(d, "MANIFEST.json"))
        # epochs seal in ascending order: CRCs staged at or below this
        # epoch but not committed belong to skipped blobs — drop them
        self._crc = {k: v for k, v in self._crc.items() if k[0] > epoch}
        self._prune()

    def _prune(self):
        done = self.epochs()
        keep_from = done[-self.retain] if len(done) >= self.retain else \
            (done[0] if done else 0)
        try:
            entries = os.listdir(self.root)
        except OSError:
            return
        for name in entries:
            m = _EPOCH_DIR.match(name)
            # anything older than the retention window goes — including
            # UNSEALED directories (torn checkpoints from a crashed
            # writer), which would otherwise accumulate forever; newer
            # unsealed dirs are in-progress epochs and stay
            if m and int(m.group(1)) < keep_from:
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)

    # ------------------------------------------------------------- reading

    def epochs(self) -> list:
        """Manifested (complete) epochs, ascending."""
        out = []
        try:
            entries = os.listdir(self.root)
        except OSError:
            return out
        for name in entries:
            m = _EPOCH_DIR.match(name)
            if m and os.path.exists(os.path.join(self.root, name,
                                                 "MANIFEST.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def verify_epoch(self, epoch: int, manifest: dict) -> str:
        """Integrity-check a sealed epoch's blobs against the manifest:
        every non-skipped node's ``.ckpt`` must exist, match its
        recorded size, and (when the manifest carries one) match its
        CRC32.  Returns None when clean, else a one-line reason."""
        d = self._epoch_dir(epoch)
        for safe, meta in manifest.get("nodes", {}).items():
            if "bytes" not in meta:
                continue            # skipped node: no blob expected
            path = os.path.join(d, f"{safe}.ckpt")
            try:
                with open(path, "rb") as f:
                    blob = f.read()
            except OSError as e:
                return f"{safe}.ckpt unreadable: {type(e).__name__}: {e}"
            if len(blob) != int(meta["bytes"]):
                return (f"{safe}.ckpt torn: {len(blob)} bytes on disk, "
                        f"manifest says {meta['bytes']}")
            crc = meta.get("crc")
            if crc is not None \
                    and (zlib.crc32(blob) & 0xFFFFFFFF) != int(crc):
                return f"{safe}.ckpt corrupt: CRC32 mismatch"
        return None

    def latest_complete(self):
        """(epoch, manifest) of the newest sealed checkpoint whose blobs
        VERIFY (size + CRC32 against the manifest), or None.  A torn or
        corrupt newest epoch falls back to the previous sealed one —
        counted (``ckpt_fallbacks``) and evented (``checkpoint_fallback``)
        — instead of raising mid-restore."""
        for epoch in reversed(self.epochs()):
            try:
                with open(os.path.join(self._epoch_dir(epoch),
                                       "MANIFEST.json")) as f:
                    manifest = json.load(f)
            except (OSError, ValueError) as e:
                self._note_fallback(epoch, f"MANIFEST.json unreadable: "
                                           f"{type(e).__name__}: {e}")
                continue
            reason = self.verify_epoch(epoch, manifest)
            if reason is None:
                return epoch, manifest
            self._note_fallback(epoch, reason)
        return None

    def _note_fallback(self, epoch: int, reason: str):
        if self._metrics is not None:
            self._metrics.counter("ckpt_fallbacks").inc()
        if self._events is not None:
            self._events.emit("checkpoint_fallback", epoch=epoch,
                              reason=reason)

    def load(self, epoch: int, node_id: str):
        """Unpickle one node's blob from a sealed epoch."""
        path = os.path.join(self._epoch_dir(epoch),
                            f"{_safe_id(node_id)}.ckpt")
        with open(path, "rb") as f:
            return pickle.load(f)
