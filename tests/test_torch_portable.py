"""Twins of tests/test_portable.py over the port's
recovery/portable.py, parallel/plane.py and CheckpointStore, the same
tests with the package name changed (tests/test_torch_interop_plane.py
ships a JAX sealed epoch into the port's spool).

Cross-host recovery unit tests (recovery/portable.py,
parallel/plane.py, the store's CRC fallback — docs/ROBUSTNESS.md
"Cross-host recovery"):

* CheckpointStore integrity: per-blob CRC in the manifest; a torn or
  bit-flipped ``.ckpt`` makes ``latest_complete()`` fall back to the
  previous sealed epoch, counted + evented;
* portable round-trip: a sealed epoch shipped over a real localhost
  RowSender/RowReceiver (the ``-7`` wire family) lands in a
  PortableSpool bit-identically and restores via the ordinary store
  recipe;
* refusals: version skew (PortableSkew), CRC mismatch in transit,
  the ``-7`` family on a receiver with no ``ckpt_sink``;
* PlaneSupervisor: membership down/dead transitions on the senders'
  link health, deterministic ring-successor election, adoption via the
  spool, rejoin, the WF216 construction-time warning;
* the knob contract: a plain resumable plane (no supervisor, no
  ckpt_sink) never imports parallel.plane or recovery.portable.
"""

import os
import socket
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from windflow_tpu_torch.core.tuples import Schema, batch_from_columns
from windflow_tpu_torch.obs import EventLog, MetricsRegistry
from windflow_tpu_torch.parallel.channel import (ChannelError, RowReceiver,
                                           RowSender, WireConfig)
from windflow_tpu_torch.parallel.plane import (PlanePolicy, PlaneSupervisor,
                                         open_supervised_plane)
from windflow_tpu_torch.recovery.portable import (PortableSkew, PortableSpool,
                                            blob_crc, export_header,
                                            iter_blobs, ship_checkpoint)
from windflow_tpu_torch.recovery.store import CheckpointStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEMA = Schema(value=np.int64)


def mk_batch(n=8, lo=0):
    ids = np.arange(lo, lo + n)
    return batch_from_columns(SCHEMA, key=np.zeros(n), id=ids, ts=ids,
                              value=ids)


def _mk_store(root, epochs=(3,), retain=4, metrics=None, events=None):
    """A store with one pickled blob per node per sealed epoch."""
    store = CheckpointStore(str(root), retain=retain, metrics=metrics,
                            events=events)
    for e in epochs:
        nodes = {}
        for node in ("df.0.win", "df.1.agg"):
            n = store.save_blob(e, node, {"epoch": e, "node": node,
                                          "v": list(range(50))})
            nodes[node] = {"bytes": n}
        store.commit(e, nodes)
    return store


# ------------------------------------------------- store CRC + fallback


def test_store_manifest_records_crc(tmp_path):
    store = _mk_store(tmp_path)
    epoch, manifest = store.latest_complete()
    assert epoch == 3
    for safe, meta in manifest["nodes"].items():
        with open(os.path.join(store._epoch_dir(3),
                               f"{safe}.ckpt"), "rb") as f:
            assert meta["crc"] == blob_crc(f.read())


def test_corrupt_blob_falls_back_to_previous_epoch(tmp_path):
    metrics, events = MetricsRegistry(), EventLog()
    store = _mk_store(tmp_path, epochs=(3, 4), metrics=metrics,
                      events=events)
    path = os.path.join(store._epoch_dir(4), "df.0.win.ckpt")
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF                     # bit flip, same size
    with open(path, "wb") as f:
        f.write(raw)
    epoch, manifest = store.latest_complete()
    assert epoch == 3
    assert metrics.snapshot()["counters"]["ckpt_fallbacks"] == 1
    [ev] = [e for e in events.recent
            if e["event"] == "checkpoint_fallback"]
    assert ev["epoch"] == 4 and "CRC32" in ev["reason"]
    # the surviving epoch still loads
    assert store.load(3, "df.1.agg")["epoch"] == 3


def test_torn_blob_falls_back(tmp_path):
    metrics = MetricsRegistry()
    store = _mk_store(tmp_path, epochs=(1, 2), metrics=metrics)
    path = os.path.join(store._epoch_dir(2), "df.1.agg.ckpt")
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[:len(raw) // 2])               # truncated write
    epoch, _ = store.latest_complete()
    assert epoch == 1
    assert metrics.snapshot()["counters"]["ckpt_fallbacks"] == 1


def test_all_epochs_corrupt_returns_none(tmp_path):
    store = _mk_store(tmp_path, epochs=(1,))
    os.remove(os.path.join(store._epoch_dir(1), "df.0.win.ckpt"))
    assert store.latest_complete() is None


# --------------------------------------------------- portable round-trip


def test_export_header_versioned_with_crcs(tmp_path):
    store = _mk_store(tmp_path)
    header = export_header(store, 3, origin=7)
    assert header["v"] == 1 and header["origin"] == 7
    assert header["epoch"] == 3
    blobs = list(iter_blobs(store, 3, header))
    assert len(blobs) == 2
    for meta, raw in blobs:
        assert meta["bytes"] == len(raw)
        assert meta["crc"] == blob_crc(raw)
        assert header["nodes"][meta["node"]]["crc"] == meta["crc"]


def test_ship_over_wire_lands_bit_identical(tmp_path):
    """The full -7 family over a real socket: OFFER + BLOBs + COMMIT
    land in the spool as a restorable CheckpointStore epoch; ordinary
    data batches interleave untouched."""
    store = _mk_store(tmp_path / "local", epochs=(5,))
    spool = PortableSpool(str(tmp_path / "spool"),
                          metrics=MetricsRegistry())
    recv = RowReceiver(n_senders=1, ckpt_sink=spool)
    snd = RowSender("127.0.0.1", recv.port)
    snd.send(mk_batch())
    shipped = ship_checkpoint(snd, store, 5, origin=0)
    assert shipped > 0
    snd.send(mk_batch(lo=100))
    snd.close()
    got = list(recv.batches())
    assert len(got) == 2
    recv.close()
    assert spool.peers() == ["0"]
    epoch, manifest = spool.latest(0)
    assert epoch == 5 and manifest["origin"] == 0
    peer_store = spool.store_for(0)
    for node in ("df.0.win", "df.1.agg"):
        assert peer_store.load(5, node) == store.load(5, node)
        with open(os.path.join(store._epoch_dir(5),
                               f"{node}.ckpt"), "rb") as f_local, \
                open(os.path.join(peer_store._epoch_dir(5),
                                  f"{node}.ckpt"), "rb") as f_spool:
            assert f_local.read() == f_spool.read()   # bit-identical
    snap = spool._metrics.snapshot()["counters"]
    assert snap["ckpt_spooled"] == 1
    # wire telemetry: shipped byte counters live on the sender registry
    # only when one is attached; the default wire has none — covered by
    # the soak/differential paths


def test_reship_is_idempotent(tmp_path):
    store = _mk_store(tmp_path / "l", epochs=(2,))
    spool = PortableSpool(str(tmp_path / "s"))
    recv = RowReceiver(n_senders=1, ckpt_sink=spool)
    snd = RowSender("127.0.0.1", recv.port)
    ship_checkpoint(snd, store, 2, origin=3)
    ship_checkpoint(snd, store, 2, origin=3)
    snd.close()
    list(recv.batches())
    recv.close()
    epoch, _ = spool.latest(3)
    assert epoch == 2
    assert spool.store_for(3).load(2, "df.0.win") == \
        store.load(2, "df.0.win")


def test_version_skew_refused(tmp_path):
    spool = PortableSpool(str(tmp_path))
    with pytest.raises(PortableSkew, match="v2"):
        spool.offer({"v": 2, "origin": 1, "epoch": 9, "nodes": {}})


def test_blob_crc_mismatch_refused(tmp_path):
    spool = PortableSpool(str(tmp_path))
    spool.offer({"v": 1, "origin": 1, "epoch": 9,
                 "nodes": {"n": {"bytes": 3, "crc": 0}}})
    with pytest.raises(ValueError, match="CRC32"):
        spool.blob({"origin": 1, "epoch": 9, "node": "n", "bytes": 3,
                    "crc": 12345}, b"abc")
    with pytest.raises(ValueError, match="bytes"):
        spool.blob({"origin": 1, "epoch": 9, "node": "n", "bytes": 5,
                    "crc": blob_crc(b"abc")}, b"abc")


def test_commit_without_offer_or_blob_refused(tmp_path):
    spool = PortableSpool(str(tmp_path))
    with pytest.raises(ValueError, match="OFFER"):
        spool.commit({"origin": 2, "epoch": 1})
    spool.offer({"v": 1, "origin": 2, "epoch": 1,
                 "nodes": {"n": {"bytes": 3,
                                 "crc": blob_crc(b"abc")}}})
    with pytest.raises(ValueError, match="never arrived"):
        spool.commit({"origin": 2, "epoch": 1})
    # an unsealed spool epoch is invisible to restore
    assert spool.latest(2) is None


def test_ckpt_family_without_sink_refused(tmp_path):
    """A receiver with no ckpt_sink= must refuse the -7 family loudly
    (classified error from batches()), never silently drop state."""
    store = _mk_store(tmp_path, epochs=(1,))
    recv = RowReceiver(n_senders=1)
    snd = RowSender("127.0.0.1", recv.port)
    try:
        ship_checkpoint(snd, store, 1, origin=0)
    except OSError:
        # the receiver can slam the connection at the first -7 frame
        # while the ship is still writing — that reset IS the refusal
        pass
    with pytest.raises((ChannelError, OSError)):
        list(recv.batches())
    recv.close()
    try:
        snd.abort()
    except OSError:
        pass


# ------------------------------------------------------ plane supervisor


class _FakeSender:
    """Just the health surface the supervisor polls."""

    def __init__(self):
        self._link_down = False
        self._hb_error = None


def _wait_until(fn, timeout=10.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if fn():
            return True
        time.sleep(0.01)
    return False


def test_supervisor_detects_death_elects_and_adopts(tmp_path):
    """kill -9 of peer 2 (modelled as its sender link going down past
    the deadline): pid 1 is the ring successor among candidates {1, 2},
    pulls the dead peer's spooled epoch, and fires on_adopt."""
    import pickle
    metrics, events = MetricsRegistry(), EventLog()
    spool = PortableSpool(str(tmp_path))
    # peer 2 replicated epoch 4 to us before dying
    raw = pickle.dumps({"x": 1})
    spool.offer({"v": 1, "origin": 2, "epoch": 4,
                 "nodes": {"n": {"bytes": len(raw),
                                 "crc": blob_crc(raw)}}})
    spool.blob({"origin": 2, "epoch": 4, "node": "n",
                "bytes": len(raw), "crc": blob_crc(raw)}, raw)
    spool.commit({"origin": 2, "epoch": 4})
    senders = {0: _FakeSender(), 2: _FakeSender()}
    adopted = []
    sup = PlaneSupervisor(
        1, {0: ("h", 1), 1: ("h", 2), 2: ("h", 3)}, senders,
        policy=PlanePolicy(down_deadline=0.15, period=0.02,
                           candidates={1, 2}),
        spool=spool, metrics=metrics, events=events,
        on_adopt=lambda pid, epoch, store: adopted.append(
            (pid, epoch, store)))
    sup.start()
    try:
        assert sup.live() == [0, 1, 2]
        senders[2]._link_down = True                   # the kill
        assert _wait_until(lambda: adopted)
        [(pid, epoch, store)] = adopted
        assert pid == 2 and epoch == 4
        assert store.load(4, "n") == {"x": 1}
        assert sup.dead() == [2]
        states = [(e["peer"], e["state"]) for e in events.recent
                  if e["event"] == "membership"]
        assert (2, "down") in states and (2, "dead") in states
        phases = [e["phase"] for e in events.recent
                  if e["event"] == "handoff"]
        assert phases == ["elected", "adopted"]
        snap = metrics.snapshot()
        assert snap["counters"]["plane_handoffs"] == 1
        assert _wait_until(lambda: metrics.snapshot()["gauges"]
                           ["plane_members"] == 2)
        # the restarted/taken-over peer answers again: rejoin
        senders[2]._link_down = False
        assert _wait_until(lambda: sup.live() == [0, 1, 2])
    finally:
        sup.close()


def test_supervisor_blip_shorter_than_deadline_recovers(tmp_path):
    events = EventLog()
    senders = {0: _FakeSender()}
    sup = PlaneSupervisor(
        1, {0: ("h", 1), 1: ("h", 2)}, senders,
        policy=PlanePolicy(down_deadline=5.0, period=0.02),
        events=events, on_adopt=lambda *a: pytest.fail("adopted a blip"))
    sup.start()
    try:
        senders[0]._link_down = True
        assert _wait_until(lambda: any(
            e["event"] == "membership" and e["state"] == "down"
            for e in events.recent))
        senders[0]._link_down = False
        assert _wait_until(lambda: any(
            e["event"] == "membership" and e["state"] == "up"
            for e in events.recent))
        assert sup.dead() == []
    finally:
        sup.close()


def test_successor_election_is_deterministic_ring():
    sup = PlaneSupervisor(
        1, {0: ("h", 1), 1: ("h", 2), 2: ("h", 3), 3: ("h", 4)}, {},
        policy=PlanePolicy(candidates={1, 2, 3}))
    assert sup.successor_for(2) == 3
    assert sup.successor_for(3) == 1          # wraps past 0 (no cand)
    sup._dead.add(3)
    assert sup.successor_for(2) == 1          # skips the dead
    sup2 = PlaneSupervisor(2, {0: ("h", 1), 1: ("h", 2), 2: ("h", 3)},
                           {}, policy=PlanePolicy(candidates={0}))
    sup2._dead.add(0)
    assert sup2.successor_for(0) is None      # no candidate survives


def test_plane_policy_validation_and_wf216_warning():
    with pytest.raises(ValueError, match="down_deadline"):
        PlanePolicy(down_deadline=0)
    with pytest.raises(ValueError, match="period"):
        PlanePolicy(period=-1)
    from windflow_tpu_torch.check.diagnostics import CheckWarning
    with pytest.warns(CheckWarning, match=r"\[WF216\]"):
        PlaneSupervisor(0, {0: ("h", 1)}, {},
                        policy=PlanePolicy(wire=WireConfig.hardened()))


# --------------------------------------------------------- knob contract


def test_plain_resume_plane_never_imports_new_modules():
    """The seed contract: a resumable plane with no supervisor and no
    ckpt_sink must not import parallel.plane or recovery.portable —
    the cross-host layer costs nothing until opted into."""
    code = textwrap.dedent("""
        import socket, sys, threading
        from windflow_tpu_torch.parallel.multihost import open_row_plane
        from windflow_tpu_torch.parallel.channel import WireConfig

        def port():
            s = socket.socket(); s.bind(("127.0.0.1", 0))
            p = s.getsockname()[1]; s.close(); return p

        addrs = {0: ("127.0.0.1", port()), 1: ("127.0.0.1", port())}
        wire = WireConfig(connect_deadline=30.0, resume=True,
                          recovery=True)
        planes = {}
        def boot(pid):
            planes[pid] = open_row_plane(pid, addrs, wire=wire)
        ts = [threading.Thread(target=boot, args=(p,)) for p in addrs]
        [t.start() for t in ts]; [t.join() for t in ts]
        for pid, (recv, senders) in planes.items():
            for snd in senders.values():
                snd.send_epoch(1)
                snd.close()
        for pid, (recv, senders) in planes.items():
            list(recv.batches())
            recv.close()
        assert 'windflow_tpu_torch.parallel.plane' not in sys.modules, \\
            "plane imported without a supervisor"
        assert 'windflow_tpu_torch.recovery.portable' not in sys.modules, \\
            "portable imported without a ckpt_sink"
        print("CONTRACT_OK")
    """)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert "CONTRACT_OK" in out.stdout


def test_open_supervised_plane_roundtrip(tmp_path):
    """Two supervised processes in one interpreter: both planes open,
    replicate() ships pid 0's sealed epoch into pid 1's spool."""
    def port():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        p = s.getsockname()[1]
        s.close()
        return p

    addrs = {0: ("127.0.0.1", port()), 1: ("127.0.0.1", port())}
    store0 = _mk_store(tmp_path / "store0", epochs=(7,))
    out = {}

    def boot(pid, **kw):
        out[pid] = open_supervised_plane(
            pid, addrs, spool_dir=str(tmp_path / f"spool{pid}"),
            policy=PlanePolicy(down_deadline=30.0, period=0.05), **kw)

    t = threading.Thread(target=boot, args=(1,))
    t.start()
    boot(0, store=store0)
    t.join()
    r0, s0, sup0 = out[0]
    r1, s1, sup1 = out[1]
    try:
        shipped = sup0.replicate(7)
        assert shipped > 0
        spool1 = sup1.spool
        assert _wait_until(lambda: spool1.latest(0) is not None)
        epoch, _ = spool1.latest(0)
        assert epoch == 7
        assert spool1.store_for(0).load(7, "df.0.win") == \
            store0.load(7, "df.0.win")
    finally:
        for sup in (sup0, sup1):
            sup.close()
        for snds in (s0, s1):
            for snd in snds.values():
                try:
                    snd.abort()
                except OSError:
                    pass
        r0.close()
        r1.close()


def _twin_script(name):
    """scripts/torch_<name>.py, the reference harness's twin over the
    port."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), os.pardir, "scripts",
                        f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.slow
def test_soak_handoff_slice():
    """Small in-suite slice of scripts/soak_handoff.py (the full soak is
    a standalone seeded harness, docs/ROBUSTNESS.md "Cross-host
    recovery"), its cases run over the port's plane by its twin,
    scripts/torch_soak_handoff.py."""
    mod = _twin_script("soak_handoff")
    for case in range(4):
        mod.run_case(seed=11, case=case)


def test_wf_top_renders_plane_line():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "wf_top", os.path.join(os.path.dirname(__file__), os.pardir,
                               "scripts", "wf_top.py"))
    wf_top = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(wf_top)
    sample = {
        "t": time.time(), "seq": 3, "dataflow": "job", "nodes": [],
        "dead_letters": 0,
        "counters": {"plane_handoffs": 1, "ckpt_shipped_bytes": 4096,
                     "ckpt_spooled": 2, "other": 1},
        "gauges": {"plane_members": 2.0, "plane_down": 1.0},
        "histograms": {},
    }
    frame = wf_top.render(sample, None)
    assert "plane: members=2  down=1" in frame
    assert "plane_handoffs=1" in frame
    assert "ckpt_shipped_bytes=4096" in frame
    # plane counters live on the plane line, not the counters line
    assert "counters: other=1" in frame
    # no supervised plane -> no plane line
    bare = dict(sample, counters={}, gauges={})
    assert "plane:" not in wf_top.render(bare, None)
