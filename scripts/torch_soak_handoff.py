"""Twin of scripts/soak_handoff.py over the PyTorch/CUDA port
(windflow_tpu_torch): the same CLI, seeds, cases and output lines, with
every import taken from the port.

Seeded handoff-chaos soak: a supervised 2-worker row plane driven
through randomized :class:`~windflow_tpu_torch.parallel.faults.HandoffChaos`
schedules (a worker killed at a sealed epoch -> its peer adopts via the
replicated portable checkpoint, or rolled -> the same member restarts
against its own store with ``resume_epoch=``), optionally compounded
with per-sender wire :class:`~windflow_tpu_torch.parallel.faults.FaultPlan`
chaos (kill / torn / dup) on the feeder's journaling links.  Checked
*differentially*: the merged per-key outputs (sealed prefixes + adopted
or resumed tails) must be byte-identical to the uncrashed oracle —
no gaps, no duplicates (docs/ROBUSTNESS.md "Cross-host recovery").

Mirrors the soak_wire.py pattern: standalone, seeded, any failure is
reproducible in isolation:

    python scripts/torch_soak_handoff.py --n 30 --seed 11       # the soak
    python scripts/torch_soak_handoff.py --seed 11 --case 4     # one repro

The test suite runs a small slow-marked slice of this via
tests/test_torch_portable.py (tier-1 excludes it with -m 'not slow').
"""

import argparse
import os
import random
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _apply(rows, sums, sink):
    for r in rows:
        k, v = int(r["key"]), int(r["value"])
        sums[k] = sums.get(k, 0) + v
        sink.append([k, int(r["id"]), sums[k]])


class _Worker:
    """One in-process plane member: data receiver + per-epoch sealing
    store + portable spool + monitor endpoints, with the chaos hooks
    (hard death at a seal, or roll-in-place with ``resume_epoch=``)."""

    def __init__(self, pid, peer, root):
        from windflow_tpu_torch.obs.federation import (FederationPolicy,
                                                       FederationShipper,
                                                       TelemetryAggregator)
        from windflow_tpu_torch.parallel.channel import RowReceiver, WireResume
        from windflow_tpu_torch.recovery.portable import PortableSpool
        from windflow_tpu_torch.recovery.store import CheckpointStore
        self.pid, self.peer = pid, peer
        self.store = CheckpointStore(os.path.join(root, f"store{pid}"),
                                     retain=16)
        self.spool = PortableSpool(os.path.join(root, f"spool{pid}"))
        self.recv = RowReceiver(1, resume=WireResume(deadline=30.0),
                                ack_epochs=False, accept_timeout=30.0)
        self.port = self.recv.port
        # telemetry federation riding the same monitor links the
        # portable checkpoints use: each worker ships a per-seal
        # snapshot to its peer, whose aggregator spools the ring when
        # the plane declares this worker dead — the black box the soak
        # asserts after a kill (docs/OBSERVABILITY.md "Federation &
        # SLOs")
        fed_pol = FederationPolicy(host=str(pid), period=0.05)
        self.fed_spool = os.path.join(root, f"fedspool{pid}")
        self.agg = TelemetryAggregator(fed_pol, spool_dir=self.fed_spool)
        self.shipper = FederationShipper(fed_pol, host=str(pid),
                                         dataflow_name=f"w{pid}")
        # a short monitor-link resume deadline: after a peer death,
        # a replicate() that lost the mid-transmit race against the
        # ack reader's EOF detection stalls the survivor's seal loop
        # for at most this long (per-peer failures are swallowed and
        # the next seal re-ships — docs/ROBUSTNESS.md)
        self.mon_recv = RowReceiver(1, resume=WireResume(deadline=5.0),
                                    accept_timeout=30.0,
                                    ckpt_sink=self.spool,
                                    telemetry_sink=self.agg)
        self.mon_port = self.mon_recv.port
        self.mon_snd = None
        self.sup = None
        self.sealed_rows, self.adopted_rows = [], []
        self.fate, self.error = "clean", None
        self.adopt_done = threading.Event()
        self.adopt_done.set()   # cleared only when an adoption starts

    def supervise(self, workers, addresses):
        from windflow_tpu_torch.parallel.channel import (RowSender, WireConfig,
                                                         WireResume)
        from windflow_tpu_torch.parallel.plane import (PlanePolicy,
                                                       PlaneSupervisor)
        self.mon_snd = RowSender("127.0.0.1", workers[self.peer].mon_port,
                                 resume=WireResume(deadline=5.0),
                                 connect_deadline=10.0)
        policy = PlanePolicy(
            down_deadline=0.5, period=0.05, candidates={1, 2},
            wire=WireConfig(connect_deadline=10.0, heartbeat=2.0,
                            stall_timeout=30.0, resume=True,
                            recovery=False))
        self.shipper.bind({self.peer: self.mon_snd})
        self.sup = PlaneSupervisor(
            self.pid, addresses, {self.peer: self.mon_snd}, policy=policy,
            store=self.store, spool=self.spool, on_adopt=self._on_adopt,
            on_death=self.agg.on_death)
        self.sup.start()

    def _on_adopt(self, dead, epoch, st):
        from windflow_tpu_torch.recovery.epoch import EpochMarker
        self.adopt_done.clear()

        def run():
            try:
                sums = st.load(int(epoch), "sums") if st else {}
                tr = self.sup.takeover_receiver(dead, epoch, n_senders=1)
                pend = []
                for item in tr.batches(epoch_markers=True):
                    if isinstance(item, EpochMarker):
                        self.adopted_rows.extend(pend)
                        pend = []
                        tr.ack_epoch(int(item.epoch))
                        continue
                    _apply(item, sums, pend)
                tr.close()
            except Exception as e:              # noqa: BLE001
                self.error = self.error or e
            finally:
                self.adopt_done.set()

        threading.Thread(target=run, daemon=True).start()

    def run(self, chaos):
        """The seal loop; returns when the stream EOSes or the chaos
        plan kills this member."""
        from windflow_tpu_torch.parallel.channel import RowReceiver, WireResume
        from windflow_tpu_torch.recovery.epoch import EpochMarker
        sums, pending = {}, []
        try:
            while True:
                rolled_to = None
                for item in self.recv.batches(epoch_markers=True):
                    if not isinstance(item, EpochMarker):
                        _apply(item, sums, pending)
                        continue
                    e = int(item.epoch)
                    n = self.store.save_blob(e, "sums", dict(sums))
                    self.store.commit(e, {"sums": {"bytes": n}})
                    self.sealed_rows.extend(pending)
                    pending = []
                    self.sup.replicate(e)
                    # force-ship one telemetry snapshot per seal (no
                    # sampler runs here): the kill epoch's snapshot is
                    # the last thing the victim says, and the
                    # survivor's black box must hold it
                    self.shipper.ship({"t": time.time(), "seq": e,
                                       "dataflow": f"w{self.pid}",
                                       "nodes": [],
                                       "counters": {"sealed": e}})
                    self.recv.ack_epoch(e)
                    ev = chaos.event_at(self.pid, e)
                    if ev == "kill":
                        self.fate = "killed"
                        self._die()
                        return
                    if ev == "roll":
                        self.fate = "rolled"
                        rolled_to = e
                        break
                if rolled_to is None:
                    return   # clean EOS
                # roll-in-place: drop the link without EOS, rebind the
                # SAME port with resume_epoch= and restore our own store
                self.recv.close()
                self.recv = RowReceiver(
                    1, port=self.port, resume=WireResume(deadline=30.0),
                    resume_epoch=rolled_to, ack_epochs=False,
                    accept_timeout=30.0)
                sums = self.store.load(rolled_to, "sums")
                pending = []
        except Exception as e:                  # noqa: BLE001
            self.error = self.error or e

    def _die(self):
        """kill -9 equivalent: every socket drops without EOS."""
        for obj in (self.recv, self.mon_recv):
            try:
                obj.close()
            except Exception:                   # noqa: BLE001
                pass
        try:
            self.mon_snd._sock.close()
        except Exception:                       # noqa: BLE001
            pass
        self.sup.close()

    def teardown(self):
        if self.fate == "killed":
            return
        self.sup.close()
        try:
            self.mon_snd.abort()
        except Exception:                       # noqa: BLE001
            pass
        for obj in (self.recv, self.mon_recv):
            try:
                obj.close()
            except Exception:                   # noqa: BLE001
                pass


def run_case(seed: int, case: int, verbose: bool = False) -> dict:
    """One randomized handoff-chaos case over a live 2-worker plane;
    raises AssertionError with the repro command on any divergence."""
    from windflow_tpu_torch.core.tuples import Schema, batch_from_columns
    from windflow_tpu_torch.parallel.channel import RowSender, WireResume
    from windflow_tpu_torch.parallel.faults import FaultPlan, HandoffChaos

    rng = random.Random(seed * 1_000_003 + case)
    n_epochs = rng.randint(4, 8)
    bpe = rng.randint(1, 3)           # batches per epoch
    n_keys = rng.randint(4, 8)
    chaos = HandoffChaos.seeded(rng.randrange(2**31), pids=(1, 2),
                                last_epoch=n_epochs)
    plans = {}
    if rng.random() < 0.5:
        horizon = n_epochs * (bpe + 1)
        plans = {w: FaultPlan.seeded(rng.randrange(2**31),
                                     horizon=horizon,
                                     n_faults=rng.randint(1, 2),
                                     kinds=("kill", "torn", "dup"))
                 for w in (1, 2)}
    params = dict(n_epochs=n_epochs, bpe=bpe, n_keys=n_keys,
                  chaos=repr(chaos),
                  plans={w: repr(p) for w, p in plans.items()})
    repro = f"python scripts/torch_soak_handoff.py --seed {seed} --case {case}"
    if verbose:
        print(f"case {case}: {params}")

    schema = Schema(value=np.int64)
    with tempfile.TemporaryDirectory(prefix="soak_handoff_") as root:
        workers = {1: _Worker(1, 2, root), 2: _Worker(2, 1, root)}
        addresses = {w: ("127.0.0.1", workers[w].port) for w in (1, 2)}
        for w in workers.values():
            w.supervise(workers, addresses)
        threads = {w: threading.Thread(target=workers[w].run,
                                       args=(chaos,), daemon=True)
                   for w in (1, 2)}
        for t in threads.values():
            t.start()
        senders = {w: RowSender("127.0.0.1", workers[w].port,
                                resume=WireResume(deadline=30.0),
                                faults=plans.get(w),
                                connect_deadline=10.0)
                   for w in (1, 2)}
        bi = 0
        for e in range(1, n_epochs + 1):
            for _ in range(bpe):
                keys = np.arange(n_keys, dtype=np.int64)
                ids = np.full(n_keys, bi, dtype=np.int64)
                vals = 13 * ids + keys + 1
                for w, snd in senders.items():
                    m = (1 + keys % 2) == w
                    snd.send(batch_from_columns(
                        schema, key=keys[m], id=ids[m], ts=ids[m],
                        value=vals[m]))
                bi += 1
            for snd in senders.values():
                snd.send_epoch(e)
        # the feeder must outlive the chaos event: wait until it fired
        # and the journaling link to that worker noticed the drop, so
        # close() resume-cycles (reconnect + replay + EOS) instead of
        # writing EOS into a half-closed link nobody will ever read
        event_pid = next(iter({**chaos.kill, **chaos.roll}))
        t0 = time.monotonic()
        while workers[event_pid].fate == "clean":
            if time.monotonic() - t0 > 30.0:
                raise AssertionError(
                    f"{repro}: chaos event on worker {event_pid} "
                    f"never fired (params {params})")
            time.sleep(0.01)
        # a beat for EOF to reach the journaling link's ack reader;
        # close() then resume-cycles (reconnect + replay) if the link
        # is down, or EOSes cleanly if _deliver already resumed it
        time.sleep(0.3)
        try:
            for snd in senders.values():
                snd.close()
        except Exception as e:                  # noqa: BLE001
            states = {w.pid: dict(fate=w.fate, error=repr(w.error),
                                  dead=w.sup.dead())
                      for w in workers.values()}
            raise AssertionError(
                f"{repro}: feeder close failed: {e!r} (worker states "
                f"{states}, params {params})") from e

        for w, t in threads.items():
            t.join(timeout=60)
            assert not t.is_alive(), (
                f"{repro}: worker {w} hung (params {params})")
        for w in workers.values():
            assert w.adopt_done.wait(60), (
                f"{repro}: adoption on worker {w.pid} never finished "
                f"(params {params})")
        for w in workers.values():
            assert w.error is None, (
                f"{repro}: worker {w.pid} raised {w.error!r} "
                f"(params {params})")
        got = {}
        for w in workers.values():
            for k, rid, cum in (*w.sealed_rows, *w.adopted_rows):
                got.setdefault(k, []).append([rid, cum])
        for rows in got.values():
            rows.sort()
        # the black-box half of the handoff promise: after a kill, the
        # successor's federation spool must hold the victim's final
        # telemetry snapshots — including the seal the victim died at
        # (the aggregator's on_death spooled them when the plane
        # declared the death, before adoption)
        for victim, kill_epoch in chaos.kill.items():
            if workers[victim].fate != "killed":
                continue
            import glob as _glob
            survivor = workers[victim].peer
            files = _glob.glob(os.path.join(
                workers[survivor].fed_spool, f"blackbox-{victim}-*.json"))
            assert files, (
                f"{repro}: worker {victim} was killed at epoch "
                f"{kill_epoch} but the survivor's federation spool "
                f"holds no black box for it (params {params})")
            import json as _json
            with open(sorted(files)[-1]) as f:
                box = _json.load(f)
            seqs = [s.get("seq") for s in box.get("samples", ())]
            assert kill_epoch in seqs, (
                f"{repro}: the spooled black box for worker {victim} "
                f"misses its final snapshot (seal {kill_epoch}); got "
                f"seqs {seqs} (params {params})")
        for w in workers.values():
            w.teardown()

    want, sums = {}, {}
    for b in range(n_epochs * bpe):
        for k in range(n_keys):
            v = 13 * b + k + 1
            sums[k] = sums.get(k, 0) + v
            want.setdefault(k, []).append([b, sums[k]])
    assert got == want, (
        f"{repro}: merged outputs diverged from the uncrashed oracle "
        f"(params {params})")
    return params


def wf_check_pipelines():
    """Static-analysis entry (scripts/torch_wf_lint.py, docs/CHECKS.md): the
    soak's supervised feeder + 2-worker row plane, declared as a
    check.plane.PlaneSpec (WF22x cross-host lint) plus the per-process
    wire bundle the workers run."""
    from windflow_tpu_torch.check.plane import HostSpec, PlaneSpec
    from windflow_tpu_torch.parallel.channel import WireConfig
    from windflow_tpu_torch.parallel.plane import PlanePolicy

    wire = WireConfig(connect_deadline=30.0, heartbeat=2.0,
                      stall_timeout=10.0, resume=True, recovery=True)
    hosts = [
        # pid 0: the feeder — supervises the plane and federates its
        # telemetry; pids 1-2: the workers, each a portable-spool
        # replica target for its peer's takeover
        HostSpec(0, sends="row", resume=True,
                 plane=PlanePolicy(wire=wire), federate=True),
        HostSpec(1, sends="row", resume=True, ckpt_sink=True,
                 federate=True, aggregator=True),
        HostSpec(2, sends="row", resume=True, ckpt_sink=True,
                 federate=True),
    ]
    spec = PlaneSpec({0: ("127.0.0.1", 9100), 1: ("127.0.0.1", 9101),
                      2: ("127.0.0.1", 9102)}, hosts,
                     name="soak_handoff", wire=wire)
    return [spec, wire]


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=30, help="number of cases")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--case", type=int, default=None,
                    help="run exactly one case (repro mode)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args()
    if args.case is not None:
        run_case(args.seed, args.case, verbose=True)
        print("OK")
        return
    for case in range(args.n):
        run_case(args.seed, case, verbose=args.verbose)
        if (case + 1) % 10 == 0:
            print(f"{case + 1}/{args.n} cases OK")
    print(f"all {args.n} cases OK")


if __name__ == "__main__":
    main()
