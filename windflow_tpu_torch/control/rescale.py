"""Live rescale of a key-partitioned farm at an epoch barrier.

The engine graph is fixed once ``run()`` starts, so elasticity is built
as *capacity + active subset*: ``runtime/farm.py`` pre-provisions the
farm to the ``Rescale`` rule's ``max_workers`` replicas and the routing
emitter serves only ``n_active`` of them.  Changing the width then never
spawns a thread — it migrates per-key window state between sibling
workers and moves ``n_active``, all inside one epoch barrier (recovery/'s
consistent cut):

1. the controller records a pending target width;
2. the **emitter**, completing its next epoch barrier (snapshot
   committed, marker already forwarded downstream, no post-barrier row
   routed yet — engine ``_complete_barriers``), publishes the seal epoch
   and parks;
3. each **worker** drains its pre-barrier input FIFO, seals the same
   epoch (its own snapshot commit), and parks in the seal barrier; the
   last worker to arrive — with every sibling provably quiescent —
   migrates the per-key state fragments (``keyed_state_export`` /
   ``keyed_state_import`` on the host window cores) to their new owners
   under the new width, then **re-commits every worker's snapshot at the
   seal epoch through the supervisor's writer path**, so a post-rescale crash
   restores post-migration state and the journal replay machinery keeps
   exactly-once intact;
4. everyone resumes; the emitter switches ``n_active``, re-commits its
   own snapshot (the active width is routing state — a replayed emitter
   must route the journal tail at the new width), and routes on.

Per-key order is preserved by construction: a migrating key's old owner
processed and emitted everything up to the barrier before the cut, the
new owner everything after it, and the collector's inbox serialises the
two (the old owner's puts happen-before the migration happens-before the
new owner's puts).

A failure *inside* the migration leaves sibling cores inconsistent in a
way no single node's snapshot can repair, so it aborts the whole graph
(``RescaleError.wf_no_restart`` — the engine refuses supervised restart
through it) instead of restoring silently-wrong state.
"""

from __future__ import annotations

import threading
import numpy as np
from time import monotonic as _monotonic

from ..runtime.engine import _Cancelled


class RescaleError(RuntimeError):
    """A live-rescale migration failed: sibling worker state may be
    inconsistent, so the graph fails like the seed engine (the engine's
    supervised loop checks ``wf_no_restart`` and never restores through
    this)."""

    wf_no_restart = True


def _migration_target(node):
    """The object carrying the keyed-state hooks for one worker node:
    its window core, or the node itself (keyed Accumulators).  None when
    neither supports migration.  Gated on the explicit
    ``keyed_migratable`` opt-in, NOT hook presence: device cores inherit
    the host hooks from WinSeqCore but mirror per-key state into device
    rings the hooks cannot move — they opt out (docs/CONTROL.md)."""
    core = getattr(node, "core", None)
    if core is not None and getattr(core, "keyed_migratable", False):
        return core
    if getattr(node, "keyed_migratable", False):
        return node
    return None


class FarmController:
    """Per-farm rescale coordinator (see module docstring).  Created by
    the :class:`~windflow_tpu_torch.control.controller.Controller` from the
    registry ``runtime/farm.py`` stamped on the Dataflow."""

    def __init__(self, df, handle: dict):
        self.df = df
        self.pattern = handle["pattern"]
        self.rule = handle["rule"]
        self.emitter = handle["emitter"]
        self.workers = list(handle["workers"])
        self.width = int(handle["width"])
        self.routing = self.pattern.routing
        self._mu = threading.Lock()
        self._pending = None          # requested target width
        self._seal_epoch = None       # epoch the in-flight rescale seals at
        self._sealed: set[int] = set()
        self._done = threading.Event()
        self._aborted = None
        self._moved = 0
        self._t0 = 0.0
        #: completed rescales, (from, to, epoch) — inspectable in tests
        self.history: list[tuple[int, int, int]] = []

    # ------------------------------------------------------------ wiring

    def validate(self):
        """Pre-run checks (Controller.attach): every worker must be
        supervised + journaling (the barrier protocol rides the
        recovery machinery) and its core must export/import per-key
        state (host window cores, keyed accumulators, and native cores
        with the state ABI; device cores and native cores on a
        pre-ABI .so decline — docs/CONTROL.md)."""
        name = self.pattern.name
        if self.emitter._recov is None:
            raise ValueError(f"Rescale {name!r}: the farm emitter is not "
                             f"supervised (recovery= must cover the graph)")
        for w in self.workers:
            rec = w._recov
            if rec is None or not rec.journaling:
                raise ValueError(
                    f"[WF210] Rescale {name!r}: worker {w.name!r} is not "
                    f"restorable under recovery= (recoverable opt-out?) "
                    f"— it cannot seal a migration cut")
            if _migration_target(w) is None:
                raise ValueError(
                    f"Rescale {name!r}: worker {w.name!r} "
                    f"({type(getattr(w, 'core', w)).__name__}) has no "
                    f"keyed-state migration hooks — host window cores, "
                    f"keyed accumulators, and native cores with the "
                    f"state ABI rescale; device cores and pre-ABI "
                    f"native libraries decline (docs/CONTROL.md)")

    def install_hooks(self):
        # the ANNOUNCE runs before the emitter's marker leaves (engine
        # _checkpoint_node), so a worker racing ahead on that marker can
        # never miss the seal; the post-checkpoint hook then parks the
        # emitter until the migration lands
        self.emitter._ctl_seal_hook = self._seal_announce
        self.emitter._ctl_epoch_hook = self._emitter_hook
        for w in self.workers:
            w._ctl_epoch_hook = (lambda epoch, _n=w:
                                 self._worker_hook(_n, epoch))

    # ----------------------------------------------------------- control

    @property
    def busy(self) -> bool:
        return self._pending is not None

    def request(self, width: int) -> bool:
        """Ask for a new active width; takes effect at the emitter's
        next epoch barrier.  False when already at that width or another
        rescale is in flight."""
        width = int(width)
        if not self.rule.min_workers <= width <= self.rule.max_workers:
            raise ValueError(
                f"Rescale {self.pattern.name!r}: width {width} outside "
                f"[{self.rule.min_workers}, {self.rule.max_workers}]")
        with self._mu:
            if self._pending is not None or width == self.width:
                return False
            self._pending = width
            return True

    # ------------------------------------------------------------- hooks

    def _await(self, ev):
        failed = self.df._failed
        while not ev.wait(0.05):
            if failed.is_set():
                raise _Cancelled()

    def _seal_announce(self, epoch: int):
        """Emitter pre-marker hook: publish the seal epoch of a pending
        rescale BEFORE the barrier marker leaves — workers racing ahead
        on the marker must always find it announced."""
        with self._mu:
            if self._pending is None or self._seal_epoch is not None \
                    or epoch <= 0:
                return
            self._seal_epoch = epoch
            self._sealed = set()
            self._aborted = None
            self._moved = 0
            # a FRESH event per seal, never clear(): a round-N waiter
            # descheduled between the round-N set() and a round-N+1
            # clear() would re-park on the recycled event and deadlock
            # the barrier (its own seal is needed to set it again)
            self._done = threading.Event()
            self._t0 = _monotonic()

    def _emitter_hook(self, epoch: int):
        with self._mu:
            if self._seal_epoch != epoch or self._pending is None:
                return
            target = self._pending
        # park until every worker sealed this epoch and the migration
        # landed; upstream backpressures on our bounded inbox meanwhile
        self._await(self._done)
        if self._aborted:
            raise RescaleError(self._aborted)
        old = self.width
        em = self.emitter
        try:
            em.n_active = target
            # the active width is routing state: re-commit so a crashed
            # emitter replays its journal tail at the width it now routes
            self._recommit_node(em, epoch)
        except Exception as e:
            # workers already hold the migrated placement: a supervised
            # restore of the emitter to its pre-flip snapshot would
            # route migrated-away keys back to neutralized owners — fail
            # the graph loudly instead (wf_no_restart)
            raise RescaleError(
                f"{self.pattern.name}: post-migration width flip to "
                f"{target} failed: {type(e).__name__}: {e}") from e
        with self._mu:
            self.width = target
            self._pending = None
            self._seal_epoch = None
        self.history.append((old, target, epoch))
        self._note_done(old, target, epoch)

    def _worker_hook(self, node, epoch: int):
        with self._mu:
            se = self._seal_epoch
            if se is None or epoch < se:
                return
            self._sealed.add(id(node))
            last = len(self._sealed) == len(self.workers)
            target = self._pending
        if not last:
            self._await(self._done)
            if self._aborted:
                raise RescaleError(self._aborted)
            return
        # last sealer: every sibling is parked (quiescent cores) — do the
        # migration on this thread, then wake everyone
        try:
            self._moved = self._migrate(target)
            self._recommit_workers(se)
        except BaseException as e:
            self._aborted = (f"{self.pattern.name}: migration to width "
                             f"{target} failed: {type(e).__name__}: {e}")
            self._done.set()
            raise RescaleError(self._aborted) from e
        self._done.set()

    # --------------------------------------------------------- migration

    def _targets(self):
        targets = [_migration_target(w) for w in self.workers]
        # sibling LazySlidingCores may have picked different backings
        # (each decides on its own first chunk): harmonize before any
        # fragment crosses — escalation per-key -> lanes is lossless,
        # the reverse is not, so vec wins when any sibling runs it
        from ..core.vecinc import LazySlidingCore
        lazies = [t for t in targets if isinstance(t, LazySlidingCore)]
        if lazies:
            vec = any(l.backing_is_vec for l in lazies)
            for l in lazies:
                l.ensure_backing(vec)
        return targets

    def _migrate(self, new_width: int) -> int:
        """Repartition per-key state onto the first ``new_width``
        workers under the farm's own routing fn.  Export-all before
        import-any: a key moving 0->2 must not clobber one moving
        2->0 mid-flight."""
        targets = self._targets()
        routing = self.routing
        exports = []
        moved = 0
        for i, t in enumerate(targets):
            keys = np.ascontiguousarray(t.keyed_state_keys(),
                                        dtype=np.int64)
            if len(keys) == 0:
                continue
            dest = np.asarray(routing(keys, new_width))
            mv = dest != i
            if not mv.any():
                continue
            mk, md = keys[mv], dest[mv]
            for d in np.unique(md):
                sel = mk[md == d]
                exports.append((int(d), t.keyed_state_export(sel)))
                moved += len(sel)
        for d, frag in exports:
            targets[d].keyed_state_import(frag)
        return moved

    def _recommit_node(self, node, epoch: int):
        rec = node._recov
        if rec is None or not rec.journaling \
                or rec.unrecoverable is not None:
            return
        state = node.state_snapshot()
        rec.commit(epoch, state)
        sup = self.df._supervisor
        if sup is not None:
            sup.enqueue_blob(rec, epoch, state)

    def _recommit_workers(self, epoch: int):
        """Post-migration snapshots at the seal epoch, shipped through
        the supervisor's writer thread: a crash after the rescale must restore
        the migrated key placement, not resurrect the old one."""
        for w in self.workers:
            self._recommit_node(w, epoch)

    # ------------------------------------------------------ observability

    def _note_done(self, old: int, new: int, epoch: int):
        df = self.df
        ms = round((_monotonic() - self._t0) * 1e3, 3)
        if df.events is not None:
            df.events.emit("rescale", dataflow=df.name,
                           farm=self.pattern.name, epoch=epoch,
                           width_from=old, width_to=new,
                           moved_keys=self._moved, ms=ms)
        m = df.metrics
        if m is not None:
            m.counter("ctl_rescale_up" if new > old
                      else "ctl_rescale_down").inc()
            m.gauge(f"ctl_width_{self.pattern.name}").set(new)
        tracer = getattr(df, "tracer", None)
        if tracer is not None:
            # control-plane span (obs/trace.py): the migration window on
            # the Perfetto timeline, next to the batches it stalled
            tracer.record_ctrl(self.pattern.name, "rescale", epoch,
                               ms / 1e3, width_from=old, width_to=new,
                               moved_keys=self._moved)
