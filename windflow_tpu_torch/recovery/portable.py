"""Portable checkpoints — self-describing export/import of a sealed
epoch (docs/ROBUSTNESS.md "Cross-host recovery").

A :class:`~windflow_tpu_torch.recovery.store.CheckpointStore` epoch is local
by construction: pickle blobs plus a manifest in one process's
``checkpoint_dir``.  This module makes a sealed epoch *portable*:

* :func:`export_header` builds the versioned portable header — the
  store manifest plus ``{"v": PORTABLE_VERSION, "origin": pid}`` and a
  CRC32 per blob (recorded at :meth:`CheckpointStore.save_blob` time,
  or computed here for pre-CRC manifests), so the receiving side can
  verify every byte without unpickling anything;
* :func:`ship_checkpoint` streams header + blobs + commit over a
  :class:`~windflow_tpu_torch.parallel.channel.RowSender` as the ``-7``
  portable-checkpoint wire family (the ``-4``/``-5``/``-6`` control
  idiom), riding the existing row plane — no extra port, no sidecar
  protocol;
* :class:`PortableSpool` is the receiving half (a ``RowReceiver``'s
  ``ckpt_sink=``): it verifies version + CRC per frame and lands each
  peer's epochs under ``<root>/peer_<origin>/epoch_NNNNNN`` in the
  exact CheckpointStore layout — so a successor restores a dead peer's
  nodes with the ordinary ``latest_complete()/load()`` recipe.

Blobs ride through OPAQUE: a pickle of host state and the flat
native state blobs ship byte-identically — portability is framing +
integrity, never re-encoding.  Version skew is refused at the header
(:class:`PortableSkew`): a spool never guesses at a future layout.
"""

from __future__ import annotations

import json
import os
import re
import time
import zlib

from .store import CheckpointStore, _EPOCH_DIR, _safe_id  # noqa: F401

#: bump when the header/frame layout changes; a spool REFUSES other
#: versions (PortableSkew) instead of mis-parsing them
PORTABLE_VERSION = 1

_PEER_DIR = re.compile(r"^peer_(.+)$")


class PortableSkew(RuntimeError):
    """Portable header from an incompatible layout version — refused
    outright (shipping continues to other, same-version peers)."""


def blob_crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def export_header(store: CheckpointStore, epoch: int,
                  origin=None) -> dict:
    """The self-describing portable header for one sealed epoch of
    ``store``: the manifest's node map with a guaranteed ``crc`` per
    blob (computed from disk when the manifest predates CRC recording),
    under a version + origin envelope."""
    path = os.path.join(store._epoch_dir(epoch), "MANIFEST.json")
    with open(path) as f:
        manifest = json.load(f)
    nodes = {}
    for safe, meta in manifest.get("nodes", {}).items():
        meta = dict(meta)
        if "bytes" in meta and meta.get("crc") is None:
            with open(os.path.join(store._epoch_dir(epoch),
                                   f"{safe}.ckpt"), "rb") as f:
                meta["crc"] = blob_crc(f.read())
        nodes[safe] = meta
    return {"v": PORTABLE_VERSION, "origin": origin, "epoch": int(epoch),
            "t": manifest.get("t"), "partial": manifest.get("partial",
                                                            False),
            "nodes": nodes}


def iter_blobs(store: CheckpointStore, epoch: int, header: dict):
    """Yield ``(meta, raw)`` per non-skipped node of the header —
    ``meta`` is the blob's wire envelope (origin/epoch/node/bytes/crc),
    ``raw`` the exact on-disk bytes."""
    for safe, m in header["nodes"].items():
        if "bytes" not in m:
            continue
        with open(os.path.join(store._epoch_dir(epoch),
                               f"{safe}.ckpt"), "rb") as f:
            raw = f.read()
        yield ({"origin": header["origin"], "epoch": header["epoch"],
                "node": safe, "bytes": len(raw),
                "crc": blob_crc(raw)}, raw)


def ship_checkpoint(sender, store: CheckpointStore, epoch: int,
                    origin=None) -> int:
    """Stream one sealed epoch to a peer over its row-plane sender
    (``RowSender.send_ckpt``); returns the bytes shipped.  Idempotent
    on the receiving spool (re-ships of a landed epoch overwrite it
    bit-identically), so callers simply retry at the next seal when a
    ship raises mid-way."""
    header = export_header(store, epoch, origin=origin)
    return sender.send_ckpt(header, iter_blobs(store, epoch, header))


class PortableSpool:
    """Receiver-side landing zone for ``-7`` portable-checkpoint frames
    (a ``RowReceiver(ckpt_sink=...)``).

    Layout: ``<root>/peer_<origin>/epoch_NNNNNN/<node>.ckpt`` +
    ``MANIFEST.json`` — the CheckpointStore layout per peer, manifest
    written LAST via tmp + rename, so :meth:`store_for` hands back an
    ordinary (read-only) store and :meth:`latest` is exactly
    ``latest_complete()``.  Every blob frame is CRC-verified before the
    rename; a mismatch raises (the connection's read loop surfaces it
    like any torn frame) and the epoch stays unsealed — torn spools are
    invisible to restore, never half-trusted.

    Frames for one origin arrive serially on that sender's connection
    thread; distinct origins land in distinct directories — no locking
    needed.
    """

    def __init__(self, root: str, retain: int = 2, metrics=None,
                 events=None):
        self.root = root
        self.retain = int(retain)
        self._metrics = metrics
        self._events = events
        #: (origin, epoch) -> pending header, staged at offer() and
        #: consumed at commit()
        self._pending: dict = {}
        os.makedirs(root, exist_ok=True)

    # ------------------------------------------------------------ sink API

    def _peer_dir(self, origin) -> str:
        return os.path.join(self.root, f"peer_{_safe_id(str(origin))}")

    def _epoch_dir(self, origin, epoch: int) -> str:
        return os.path.join(self._peer_dir(origin),
                            f"epoch_{int(epoch):06d}")

    def offer(self, header: dict):
        """OFFER frame: version gate + stage the header."""
        v = header.get("v")
        if v != PORTABLE_VERSION:
            raise PortableSkew(
                f"portable checkpoint header v{v} from peer "
                f"{header.get('origin')!r}, this build speaks "
                f"v{PORTABLE_VERSION} — refusing (upgrade the older "
                f"side; docs/ROBUSTNESS.md \"Cross-host recovery\")")
        key = (str(header.get("origin")), int(header["epoch"]))
        self._pending[key] = header
        os.makedirs(self._epoch_dir(*key), exist_ok=True)

    def blob(self, meta: dict, raw: bytes):
        """BLOB frame: CRC + size gate, then tmp-rename into the staged
        epoch directory."""
        if len(raw) != int(meta["bytes"]):
            raise ValueError(
                f"portable blob {meta.get('node')!r}: {len(raw)} bytes "
                f"framed, envelope says {meta['bytes']}")
        if blob_crc(raw) != int(meta["crc"]):
            raise ValueError(
                f"portable blob {meta.get('node')!r}: CRC32 mismatch "
                f"in transit (refusing to land a corrupt checkpoint)")
        d = self._epoch_dir(meta.get("origin"), meta["epoch"])
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{_safe_id(str(meta['node']))}.ckpt")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(raw)
        os.replace(tmp, path)

    def commit(self, meta: dict):
        """COMMIT frame: every offered blob must have landed; write the
        manifest (CheckpointStore format + the portable envelope) LAST,
        then prune the peer's retention window."""
        key = (str(meta.get("origin")), int(meta["epoch"]))
        header = self._pending.pop(key, None)
        if header is None:
            raise ValueError(
                f"portable COMMIT for epoch {key[1]} of peer {key[0]!r} "
                f"without a preceding OFFER")
        d = self._epoch_dir(*key)
        for safe, m in header["nodes"].items():
            if "bytes" in m \
                    and not os.path.exists(os.path.join(d,
                                                        f"{safe}.ckpt")):
                raise ValueError(
                    f"portable COMMIT for epoch {key[1]} of peer "
                    f"{key[0]!r}: blob {safe!r} never arrived")
        manifest = {"epoch": header["epoch"],
                    "t": header.get("t") or time.time(),
                    "partial": header.get("partial", False),
                    "nodes": header["nodes"],
                    "v": header["v"], "origin": header["origin"]}
        tmp = os.path.join(d, "MANIFEST.json.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(d, "MANIFEST.json"))
        self.store_for(key[0])._prune()
        if self._metrics is not None:
            self._metrics.counter("ckpt_spooled").inc()

    # ------------------------------------------------------------- reading

    def peers(self) -> list:
        try:
            entries = os.listdir(self.root)
        except OSError:
            return []
        return sorted(m.group(1) for m in map(_PEER_DIR.match, entries)
                      if m)

    def store_for(self, origin) -> CheckpointStore:
        """An ordinary CheckpointStore over one peer's spooled epochs —
        restore with the usual ``latest_complete()/load()`` recipe."""
        return CheckpointStore(self._peer_dir(origin), retain=self.retain,
                               metrics=self._metrics, events=self._events)

    def latest(self, origin):
        """(epoch, manifest) of a peer's newest VERIFIED spooled epoch,
        or None (integrity fallback exactly as the local store)."""
        return self.store_for(origin).latest_complete()
