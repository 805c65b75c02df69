"""RecoveryPolicy — the knobs of the checkpoint/restart layer.

Passing a policy to ``Dataflow``/``MultiPipe`` (``recovery=``) opts the
graph in; ``None`` (the default everywhere) keeps every code path
seed-identical (docs/ROBUSTNESS.md "Recovery").
"""

from __future__ import annotations


class RecoveryPolicy:
    """Per-dataflow recovery knobs.

    Parameters
    ----------
    epoch_batches:
        Count trigger: every source injects an epoch barrier marker after
        this many emitted batches.  ``None`` (default) = no count trigger.
    epoch_period:
        Time trigger, seconds: a source injects a marker when this much
        time has passed since its last one (checked at emission cadence,
        so a silent source injects nothing).  ``None`` = no time trigger.
        With *neither* trigger set only the initial (epoch-0) snapshot
        exists; restart still works but journals are never trimmed by
        barriers, so long streams will exhaust ``replay_capacity``.
    checkpoint_dir:
        Directory for durable checkpoints (per-node blobs + an atomically
        renamed manifest per epoch, written by the supervisor's writer
        thread).  ``None`` = in-memory snapshots only: supervised restart
        works, nothing touches disk.
    retain:
        Keep the last K manifested epochs on disk; older epoch
        directories are pruned after each commit.
    max_restarts:
        Per-node restart budget.  Once spent, the next failure tears the
        graph down exactly like the un-supervised engine.
    restart_backoff:
        Base backoff in seconds before a restart; restart ``i`` sleeps
        ``restart_backoff * 2**(i-1)``.  While a node backs off, its
        bounded inbox backpressures producers — the quiesce.
    replay_capacity:
        Bound on journaled input items per node (batches consumed since
        the last completed checkpoint).  Overflow makes the node
        non-restartable until its next checkpoint trims the journal; a
        crash in that window fails the graph as today.
    snapshot_rings:
        Include device-resident ring contents in checkpoint state (an
        asynchronous device→host copy that overlaps ongoing compute).
        ``False`` restores rings by rebasing from the host archives
        instead — smaller blobs, slower first post-restore flush.
    """

    __slots__ = ("epoch_batches", "epoch_period", "checkpoint_dir",
                 "retain", "max_restarts", "restart_backoff",
                 "replay_capacity", "snapshot_rings")

    def __init__(self, epoch_batches: int = None, epoch_period: float = None,
                 checkpoint_dir: str = None, retain: int = 2,
                 max_restarts: int = 3, restart_backoff: float = 0.05,
                 replay_capacity: int = 1024, snapshot_rings: bool = True):
        if epoch_batches is not None and int(epoch_batches) <= 0:
            raise ValueError("epoch_batches must be a positive batch count "
                             "(None for no count trigger)")
        if epoch_period is not None and float(epoch_period) <= 0:
            raise ValueError("epoch_period must be positive seconds "
                             "(None for no time trigger)")
        if int(retain) < 1:
            raise ValueError("retain must keep at least 1 epoch")
        if int(max_restarts) < 0:
            raise ValueError("max_restarts must be >= 0")
        if float(restart_backoff) < 0:
            raise ValueError("restart_backoff must be >= 0 seconds")
        if int(replay_capacity) < 1:
            raise ValueError("replay_capacity must be >= 1 journaled item")
        self.epoch_batches = (None if epoch_batches is None
                              else int(epoch_batches))
        self.epoch_period = (None if epoch_period is None
                             else float(epoch_period))
        self.checkpoint_dir = checkpoint_dir
        self.retain = int(retain)
        self.max_restarts = int(max_restarts)
        self.restart_backoff = float(restart_backoff)
        self.replay_capacity = int(replay_capacity)
        self.snapshot_rings = bool(snapshot_rings)

    def agrees_with(self, other: "RecoveryPolicy") -> bool:
        """Field equality — the union-merge conflict rule (one Dataflow
        runs one policy, api/multipipe.py)."""
        return all(getattr(self, a) == getattr(other, a)
                   for a in self.__slots__)

    def __repr__(self):
        # every agrees_with() field, so union-conflict errors show the
        # actual difference
        return ("RecoveryPolicy("
                + ", ".join(f"{a}={getattr(self, a)!r}"
                            for a in self.__slots__) + ")")
