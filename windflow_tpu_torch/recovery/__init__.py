"""Epoch checkpoints and supervised restart (docs/ROBUSTNESS.md "Recovery").

The reference (WindFlow/FastFlow) is a single-process graph with no fault
tolerance: one node exception cancels every queue and all window state is
lost.  This package adds the opt-in recovery layer on top of the failure
*detectors* (overload error budgets, wire ``PeerStall``/``PeerAbort``) and
*sensors* (obs events/metrics) the robustness and observability layers
already provide:

* **epoch barriers** — sources inject :class:`EpochMarker` control frames
  (count- or time-triggered, ``RecoveryPolicy``); markers flow through
  inboxes and align per consumer (Chandy–Lamport over the engine's FIFO
  channels), so each node's snapshot is a globally consistent cut;
* **asynchronous checkpoints** — on barrier alignment each node snapshots
  via ``Node.state_snapshot()/state_restore()`` (host archives and vecinc
  state by deep copy; device-resident rings as a handle whose device→host
  copy overlaps the next batches' compute) into a :class:`CheckpointStore`
  (per-node blobs + manifest, atomic rename, retain last K);
* **supervised restart** — a failed node thread restores the last
  snapshot, replays its bounded per-edge input journal (retained until
  the next epoch checkpoint), and resumes, under a restart budget with
  exponential backoff; emissions are sequence-tagged per edge so replayed
  duplicates are dropped downstream (exactly-once for deterministic
  operators).  Budget spent ⇒ the graph fails exactly as today.

**The contract (same as OverloadPolicy / the obs layer): ``recovery=``
unset ⇒ seed-identical behavior** — no markers, no journals, no
supervisor thread, and a single dead branch on the emit hot path.
"""

from .epoch import EpochMarker, NodeRecovery, Tagged
from .policy import RecoveryPolicy
from .store import CheckpointStore
from .supervisor import Supervisor

__all__ = [
    "RecoveryPolicy", "CheckpointStore", "Supervisor", "EpochMarker",
    "NodeRecovery", "Tagged",
]
