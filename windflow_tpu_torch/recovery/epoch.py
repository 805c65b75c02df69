"""Epoch markers, sequence tagging, and the per-node recovery record.

Wire format of the recovery layer, in-process edition: when a dataflow
runs with ``recovery=``, every batch crossing an engine edge is wrapped in
a :class:`Tagged` envelope carrying a per-edge monotone sequence number,
and sources interleave :class:`EpochMarker` control frames.  The envelope
is what makes restart exactly-once for deterministic operators: a
restarted node replays its input journal, regenerates the *same* output
sequence numbers, and consumers drop everything at or below the last
sequence they saw per input channel.

:class:`NodeRecovery` is the per-node state machine the engine's
supervised receive loop drives (runtime/engine.py ``_run_supervised``):
sequence counters, per-channel epoch levels (Chandy–Lamport alignment
over the FIFO inboxes), the bounded input journal retained until the next
epoch checkpoint, held-back items from channels that are ahead of the
node's epoch, and the committed snapshot restarts restore from.
"""

from __future__ import annotations

import time


class EpochMarker:
    """Epoch barrier control frame: "every row of epochs <= ``epoch`` has
    been emitted on this edge".  Injected by sources (RecoveryPolicy
    triggers, or forwarded from a wire channel's epoch frame) and
    forwarded by each node once all its live input channels align."""

    __slots__ = ("epoch",)

    def __init__(self, epoch: int):
        self.epoch = int(epoch)

    def __repr__(self):
        return f"<EpochMarker {self.epoch}>"


class Tagged:
    """Per-edge envelope: ``seq`` is the producer's monotone sequence
    number on that output channel; ``payload`` is a batch or an
    :class:`EpochMarker`."""

    __slots__ = ("seq", "payload")

    def __init__(self, seq: int, payload):
        self.seq = seq
        self.payload = payload

    def __repr__(self):
        return f"<Tagged #{self.seq} {type(self.payload).__name__}>"


def is_ctrl_payload(item) -> bool:
    """True for envelopes whose payload is an epoch marker — the shedding
    inboxes treat these like EOS (never dropped, re-queued on evict)."""
    return type(item) is Tagged and type(item.payload) is EpochMarker


class NodeRecovery:
    """Per-node recovery record (see module docstring).  Created by the
    :class:`~windflow_tpu_torch.recovery.supervisor.Supervisor` at ``run()`` and
    installed as ``node._recov`` — the single hot-path hook
    (runtime/node.py ``emit``/``emit_to``)."""

    __slots__ = (
        "node_id", "policy", "supervisor", "is_source", "journaling",
        "copy_inputs",
        # producer side
        "out_seq", "batches_out", "src_epoch", "last_mark_t",
        # consumer side
        "last_seen", "chan_epoch", "eos", "live", "budget", "epoch",
        "journal", "held", "overflowed", "quarantined",
        "requarantine_skip",
        # restart bookkeeping
        "snapshot", "restarts_used", "unrecoverable",
    )

    def __init__(self, node_id: str, policy, supervisor, is_source: bool,
                 journaling: bool, copy_inputs: bool = False):
        self.node_id = node_id
        self.policy = policy
        self.supervisor = supervisor
        self.is_source = is_source
        #: False for nodes that cannot snapshot (restart impossible):
        #: skip the journal so unbounded streams don't hoard batches
        self.journaling = journaling
        #: the consumer mutates handed-off input batches in place
        #: (node.py ownership protocol) — journal private copies so
        #: replay sees pristine inputs
        self.copy_inputs = copy_inputs
        self.out_seq: list[int] = []
        self.batches_out = 0
        self.src_epoch = 0
        self.last_mark_t = None
        self.last_seen: dict[int, int] = {}
        self.chan_epoch: dict[int, int] = {}
        self.eos: set[int] = set()
        self.live = 0
        self.budget = 0
        self.epoch = 0
        self.journal: list = []
        self.held: list = []
        self.overflowed = False
        #: poison batches quarantined since the last checkpoint, and how
        #: many re-raises a replay should spend budget on WITHOUT
        #: appending a duplicate dead letter (engine._svc_supervised)
        self.quarantined = 0
        self.requarantine_skip = 0
        self.snapshot = None          # (epoch, node_state, runner_state)
        self.restarts_used = 0
        self.unrecoverable = None     # reason string once set

    # ------------------------------------------------------------- producer

    def emit(self, outputs, batch):
        """Tagged broadcast to every output channel; sources then check
        the epoch triggers (markers ride *behind* the batch that tripped
        them, so an epoch is a closed prefix of the stream)."""
        seq = self.out_seq
        for i, (inbox, src) in enumerate(outputs):
            seq[i] += 1
            if type(batch) is EpochMarker:
                # a source forwarding wire-driven epochs (channel.py
                # epoch frames): policy-exempt like EOS
                inbox.put_ctrl(src, Tagged(seq[i], batch))
            else:
                inbox.put(src, Tagged(seq[i], batch))
        if self.is_source and type(batch) is not EpochMarker:
            self._after_source_emit(outputs)

    def emit_to(self, outputs, out: int, batch):
        inbox, src = outputs[out]
        self.out_seq[out] += 1
        if type(batch) is EpochMarker:
            # same contract as emit(): markers are policy-exempt and
            # never count as source batches (a shed marker would stall
            # downstream alignment; a counted one would self-trigger)
            inbox.put_ctrl(src, Tagged(self.out_seq[out], batch))
            return
        inbox.put(src, Tagged(self.out_seq[out], batch))
        if self.is_source:
            self._after_source_emit(outputs)

    def _after_source_emit(self, outputs):
        pol = self.policy
        self.batches_out += 1
        fire = (pol.epoch_batches is not None
                and self.batches_out % pol.epoch_batches == 0)
        if not fire and pol.epoch_period is not None:
            now = time.monotonic()
            if self.last_mark_t is None:
                self.last_mark_t = now
            elif now - self.last_mark_t >= pol.epoch_period:
                fire = True
        if fire:
            self.src_epoch += 1
            self.forward_marker(outputs, self.src_epoch)
            self.last_mark_t = time.monotonic()

    def forward_marker(self, outputs, epoch: int):
        """Broadcast ``EpochMarker(epoch)`` on every output, sequence
        tagged and policy-exempt (a shed marker would stall downstream
        alignment)."""
        marker = EpochMarker(epoch)
        for i, (inbox, src) in enumerate(outputs):
            self.out_seq[i] += 1
            inbox.put_ctrl(src, Tagged(self.out_seq[i], marker))

    # ------------------------------------------------------------- consumer

    def begin(self, n_outputs: int, live: int, budget: int):
        self.out_seq = [0] * n_outputs
        self.live = live
        self.budget = budget

    def journal_append(self, src: int, item, lvl: int = 0):
        """Record one consumed input.  ``lvl`` pins the channel's epoch
        level AT ARRIVAL: replay must make the same hold-or-process
        decision the original dispatch made, and the restored
        ``chan_epoch`` only knows the (possibly later) commit-time
        level — deciding off that would defer items the original run
        processed immediately, perturbing order-sensitive consumers'
        release batching and breaking replay determinism."""
        if not self.journaling or self.overflowed:
            return
        if len(self.journal) >= self.policy.replay_capacity:
            # past the bound the journal can no longer reproduce the
            # post-snapshot input, so restart is off until the next
            # checkpoint trims it — note it once, loudly
            self.overflowed = True
            self.journal.clear()
            self.supervisor.note_overflow(self)
            return
        self.journal.append((src, self._journal_item(item), lvl))

    def _journal_item(self, item):
        if (self.copy_inputs and type(item) is Tagged
                and type(item.payload) is not EpochMarker
                and hasattr(item.payload, "copy")):
            return Tagged(item.seq, item.payload.copy())
        return item

    def barrier_ready(self):
        """The epoch whose barrier is now complete (min channel level over
        live channels, above the node's current epoch); the string
        ``"eos"`` when every channel reached EOS while items are still
        held back (no further barrier can complete — the engine drains
        them); None otherwise."""
        levels = [e for c, e in self.chan_epoch.items() if c not in self.eos]
        if self.live <= 0 and not levels:
            return "eos" if self.held else None
        if len(levels) < self.live:     # a live channel has no marker yet
            return None
        m = min(levels)
        return m if m > self.epoch else None

    def commit(self, epoch: int, node_state):
        """Record the completed checkpoint: runner state + node state;
        the journal resets to exactly the currently held (consumed but
        not yet processed) items — everything else is in the snapshot."""
        # the snapshot's view of last_seen must treat held items as
        # UNSEEN: they are the journal the restore replays, and replay
        # goes through the duplicate check — snapshotting their seqs
        # would silently drop that whole prefix on restore (held seqs
        # are a contiguous per-edge suffix, so first-held-minus-one is
        # the consistent rollback point).  The LIVE last_seen keeps the
        # full values: a true duplicate from a restarted producer still
        # drops, while the held copy processes from the hold queue.
        last = dict(self.last_seen)
        for src, item, _lvl in self.held:
            if type(item) is Tagged:
                if item.seq - 1 < last.get(src, -1):
                    last[src] = item.seq - 1
        runner_state = {
            "live": self.live,
            "eos": set(self.eos),
            "chan_epoch": dict(self.chan_epoch),
            "last_seen": last,
            "out_seq": list(self.out_seq),
            "budget": self.budget,
            "epoch": epoch,
        }
        self.epoch = epoch
        self.snapshot = (epoch, node_state, runner_state)
        self.quarantined = 0
        # held items are consumed-but-unprocessed: they are the exact
        # post-snapshot input prefix, so the journal resets to them
        # (copied under the same mutating-consumer rule as appends)
        self.journal = ([(s, self._journal_item(i), l)
                         for s, i, l in self.held]
                        if self.journaling else [])
        self.overflowed = False

    def restore(self):
        """Reset runner state to the committed snapshot; returns
        (node_state, journal_to_replay).  The journal is re-built by the
        replay itself (dispatch re-appends), so it is detached here."""
        epoch, node_state, rs = self.snapshot
        self.live = rs["live"]
        self.eos = set(rs["eos"])
        self.chan_epoch = dict(rs["chan_epoch"])
        self.last_seen = dict(rs["last_seen"])
        self.out_seq = list(rs["out_seq"])
        self.budget = rs["budget"]
        self.epoch = rs["epoch"]
        todo, self.journal, self.held = self.journal, [], []
        self.overflowed = False
        # replay will re-raise on batches already quarantined since the
        # snapshot: spend budget again, skip the duplicate dead letters
        self.requarantine_skip = self.quarantined
        self.quarantined = 0
        return node_state, todo

    def mark_unrecoverable(self, reason: str):
        if self.unrecoverable is None:
            self.unrecoverable = reason
            self.journal = []
            self.journaling = False
            self.supervisor.note_unrecoverable(self, reason)
