"""The Supervisor: restart arbitration + the asynchronous checkpoint
writer.

One Supervisor per recovering Dataflow (created at ``run()``, stopped in
``wait()``).  Two jobs:

* **restart arbitration** — a failed node thread asks
  :meth:`authorize_restart`; the supervisor spends the node's restart
  budget, sleeps the exponential backoff (during which the node's bounded
  inbox backpressures producers — the quiesce), and reports the decision.
  The restart itself runs on the node's own thread
  (runtime/engine.py ``_run_supervised``): restore the last snapshot,
  replay the input journal, resume.  Budget spent ⇒ the failure
  propagates exactly as in the un-supervised engine.
* **asynchronous checkpoint writing** — node threads enqueue snapshot
  states at barrier alignment and move on; the writer thread resolves
  lazy handles (the resident ring's device→host copy — overlapping the
  ring's ongoing compute), pickles blobs into the
  :class:`~windflow_tpu_torch.recovery.store.CheckpointStore`, and seals each
  epoch's manifest once every participating node's blob landed.

Checkpoint/restore/restart surface as obs events (``checkpoint``,
``checkpoint_commit``, ``checkpoint_skip``, ``restore``, ``node_restart``,
``recovery_giveup``, ``epoch``) and byte/duration metrics (``ckpt_*``,
``node_restarts`` counters, ``ckpt_write_s`` histogram) when the dataflow
runs with the observability layer on.
"""

from __future__ import annotations

import queue
import threading
import time
from time import perf_counter as _pc

from .epoch import NodeRecovery
from .policy import RecoveryPolicy


def _mutates_input(node) -> bool:
    """True when the node (or a fused head stage) may mutate handed-off
    input batches in place (node.py ownership protocol) — its journal
    must hold private copies for replay."""
    if getattr(node, "input_fresh", False):
        return True
    core = getattr(node, "core", None)
    if core is not None and getattr(core, "owned_input", False):
        return True
    stages = getattr(node, "stages", None)
    if stages:
        return _mutates_input(stages[0])
    return False


class Supervisor:
    """See module docstring.  Thread-safety: restart arbitration and
    blob enqueueing are called from node threads (locked); the store is
    touched only by the writer thread."""

    def __init__(self, dataflow, policy: RecoveryPolicy):
        self.dataflow = dataflow
        self.policy = policy
        self._mu = threading.Lock()
        self.store = None
        self._writer = None
        self._wq = None
        #: node_ids whose blobs an epoch manifest waits for
        self._expected: set[str] = set()
        self._epoch_blobs: dict[int, dict] = {}
        #: highest epoch each node has blobbed (monotone progress)
        self._node_epoch: dict[str, int] = {}
        if policy.checkpoint_dir:
            from .store import CheckpointStore
            self.store = CheckpointStore(policy.checkpoint_dir,
                                         retain=policy.retain,
                                         metrics=dataflow.metrics,
                                         events=dataflow.events)
            self._wq = queue.Queue()
            self._writer = threading.Thread(
                target=self._writer_loop, daemon=True,
                name=f"{dataflow.name}/ckpt-writer")

    # ------------------------------------------------------------- wiring

    def attach_all(self):
        """Install a NodeRecovery on every node of the graph (and on the
        emitting tail stage of fused Combs, whose emissions bypass the
        Comb object itself)."""
        from ..runtime.node import SourceNode
        from ..utils.tracing import node_stats_name
        df = self.dataflow
        for idx, node in enumerate(df.nodes):
            is_source = isinstance(node, SourceNode)
            journaling = bool(getattr(node, "recoverable", False)
                              and not is_source)
            rec = NodeRecovery(
                node_stats_name(df.name, idx, node.name), self.policy,
                self, is_source=is_source, journaling=journaling,
                copy_inputs=_mutates_input(node))
            node._recov = rec
            stages = getattr(node, "stages", None)
            if stages:
                # the Comb's last stage owns the real output channels
                stages[-1]._recov = rec
            for member in (node, *(stages or ())):
                core = getattr(member, "core", None)
                if core is not None and hasattr(core, "snapshot_rings"):
                    # mirror the ring-snapshot knob onto resident cores
                    core.snapshot_rings = self.policy.snapshot_rings
                if core is not None and hasattr(core, "_obs_metrics"):
                    # hand cores with their own snapshot counters (the
                    # native core's native_state_* series) the dataflow
                    # metrics sink — cores hold no dataflow reference
                    core._obs_metrics = df.metrics
            if journaling:
                self._expected.add(rec.node_id)
        if self._writer is not None:
            self._writer.start()

    # ------------------------------------------------------- restart logic

    def authorize_restart(self, node, rec: NodeRecovery,
                          error: BaseException) -> bool:
        """Decide whether the failed node may restore + replay; sleeps
        the backoff on approval.  Called on the failing node's thread."""
        if rec.snapshot is None:
            self._giveup(node, rec, error, "no snapshot")
            return False
        if rec.unrecoverable is not None:
            self._giveup(node, rec, error, rec.unrecoverable)
            return False
        if rec.overflowed:
            self._giveup(node, rec, error, "journal overflowed")
            return False
        with self._mu:
            if rec.restarts_used >= self.policy.max_restarts:
                spent = True
            else:
                spent = False
                rec.restarts_used += 1
                attempt = rec.restarts_used
        if spent:
            self._giveup(node, rec, error,
                         f"restart budget ({self.policy.max_restarts}) "
                         "spent")
            return False
        self._event("node_restart", node=rec.node_id, attempt=attempt,
                    max_restarts=self.policy.max_restarts,
                    epoch=rec.snapshot[0], error=type(error).__name__,
                    message=str(error))
        self._count("node_restarts")
        backoff = self.policy.restart_backoff * (2 ** (attempt - 1))
        # backoff in small slices so a graph failing ELSEWHERE still
        # cancels this node promptly (its producers are blocked on us)
        t_end = time.monotonic() + backoff
        failed = self.dataflow._failed
        while time.monotonic() < t_end:
            if failed.is_set():
                return False
            time.sleep(min(0.02, max(t_end - time.monotonic(), 0)))
        return True

    def _giveup(self, node, rec, error, reason: str):
        self._event("recovery_giveup", node=rec.node_id, reason=reason,
                    error=type(error).__name__, message=str(error))
        bb = getattr(self.dataflow, "_blackbox", None)
        if bb is not None:
            # budget exhaustion is a flight-recorder trigger
            # (docs/OBSERVABILITY.md "Federation & SLOs"): the rings
            # still hold every restart attempt that led here
            bb.dump("recovery_giveup", failed_node=rec.node_id,
                    reason=reason, error=type(error).__name__)

    def note_restored(self, node, rec: NodeRecovery, replayed: int,
                      duration_s: float):
        self._event("restore", node=rec.node_id, epoch=rec.epoch,
                    replayed=replayed, ms=round(duration_s * 1e3, 3))
        self._count("node_restores")

    def note_overflow(self, rec: NodeRecovery):
        self._event("recovery_giveup", node=rec.node_id,
                    reason=f"replay journal exceeded "
                           f"{self.policy.replay_capacity} items "
                           "(restart disabled until the next checkpoint)")

    def note_unrecoverable(self, rec: NodeRecovery, reason: str):
        with self._mu:
            self._expected.discard(rec.node_id)
        self._event("checkpoint_skip", node=rec.node_id, reason=reason)
        if self._wq is not None:
            # epochs parked waiting only on this node can seal now; the
            # store is writer-thread-only, so route through the queue
            self._wq.put(("seal",))

    # ----------------------------------------------------- checkpoint path

    def note_checkpoint(self, node, rec: NodeRecovery, epoch: int,
                        duration_s: float):
        self._event("checkpoint", node=rec.node_id, epoch=epoch,
                    ms=round(duration_s * 1e3, 3))
        self._count("ckpt_snapshots")

    def enqueue_blob(self, rec: NodeRecovery, epoch: int, state):
        """Hand a snapshot to the writer thread (no-op without a store):
        the node thread returns to stream work immediately; lazy handles
        (device→host ring copies) resolve on the writer."""
        if self._wq is not None:
            self._wq.put(("blob", rec.node_id, epoch, state))

    def _writer_loop(self):
        while True:
            item = self._wq.get()
            if item[0] == "stop":
                return
            if item[0] == "seal":
                self._seal_ready()
                continue
            _kind, node_id, epoch, state = item
            t0 = _pc()
            try:
                n = self.store.save_blob(epoch, node_id, state)
                meta = {"bytes": n}
                self._count("ckpt_blobs")
                self._count("ckpt_bytes", n)
                self._hist("ckpt_write_s", _pc() - t0)
            except Exception as e:  # unpicklable user state, disk error
                meta = {"skipped": f"{type(e).__name__}: {e}"}
                self._count("ckpt_skips")
                self._event("checkpoint_skip", node=node_id, epoch=epoch,
                            reason=f"{type(e).__name__}: {e}")
            self._note_blob(epoch, node_id, meta)

    def _note_blob(self, epoch: int, node_id: str, meta: dict):
        with self._mu:
            self._epoch_blobs.setdefault(epoch, {})[node_id] = meta
            # progress is per-node monotone: a blob for epoch E also
            # vouches for every earlier pending epoch of that node —
            # barrier alignment can legitimately skip epochs (a lagging
            # channel EOSing jumps the min), and a strict exact-epoch
            # wait would strand those manifests forever
            if epoch > self._node_epoch.get(node_id, -1):
                self._node_epoch[node_id] = epoch
        self._seal_ready()

    def _seal_ready(self):
        """Seal (manifest + prune) every pending epoch all expected
        nodes have reached, in ascending order so nothing strands."""
        while True:
            with self._mu:
                ready = sorted(
                    e for e in self._epoch_blobs
                    if all(self._node_epoch.get(n, -1) >= e
                           for n in self._expected))
                if not ready:
                    return
                epoch = ready[0]
                blobs = self._epoch_blobs.pop(epoch)
                skipped = [n for n in self._expected if n not in blobs]
            for n in skipped:
                blobs[n] = {"skipped": "epoch passed without checkpoint"}
            partial = any("skipped" in m for m in blobs.values())
            self.store.commit(epoch, blobs, partial=partial)
            self._event("checkpoint_commit", epoch=epoch,
                        nodes=len(blobs), partial=partial,
                        bytes=sum(m.get("bytes", 0)
                                  for m in blobs.values()))
            # the seal is the durability boundary resumable wire edges
            # ack at (Dataflow.on_epoch_sealed → RowReceiver.ack_epoch
            # → sender journals trim).  Read live so listeners
            # registered after run() still fire; swallow — a telemetry
            # hook must not fail a seal.
            for fn in getattr(self.dataflow, "_seal_listeners", ()):
                try:
                    fn(epoch)
                except Exception:
                    pass

    def stop(self, wait_s: float = 30.0):
        """Flush and stop the writer (called from ``Dataflow.wait``).
        ``wait_s`` bounds the flush — a timed-out wait() passes a small
        grace so pending blob writes cannot blow its promised bound
        (the writer is a daemon; unfinished epochs stay unsealed and
        are pruned as torn checkpoints later)."""
        if self._writer is not None and self._writer.is_alive():
            self._wq.put(("stop",))
            self._writer.join(timeout=wait_s)

    # ------------------------------------------------------------- plumbing

    def _event(self, kind: str, **fields):
        ev = self.dataflow.events
        if ev is not None:
            ev.emit(kind, dataflow=self.dataflow.name, **fields)

    def _count(self, name: str, n: int = 1):
        m = self.dataflow.metrics
        if m is not None:
            m.counter(name).inc(n)

    def _hist(self, name: str, v: float):
        m = self.dataflow.metrics
        if m is not None:
            m.histogram(name).observe(v)
