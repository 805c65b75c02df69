"""Twins of tests/test_multihost_2proc.py for the port: REAL processes
(fresh interpreters started with subprocess) run the port's multi-process
layout and row plane.  The two-process tests bootstrap a gloo group with
``windflow_tpu_torch.parallel.multihost.initialize`` over localhost, four
host devices a process standing in for its cards, build the SAME global
(kf, wf, sp) mesh from the exchanged device lists (no injected
process_of), split the keys with ``local_kf_groups`` / ``process_for_keys``
and run one kf-split windowed pipeline per process; the parent holds the
union of their integer results per key against the JAX package's
single-process ``WinSeqCore`` over the full stream.  The plane tests
(resume across a receiver restart, kill-and-adopt, rolling restart) run
the port's channel, plane supervisor and portable checkpoints in every
process, against the same oracles as the reference tests."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import json, sys
import numpy as np
from windflow_tpu_torch.parallel.multihost import initialize

port, pid, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
# a gloo group that only exchanges the device lists: four host devices a
# process stand in for its cards
initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
           process_id=pid)

from windflow_tpu_torch.core.tuples import Schema, batch_from_columns
from windflow_tpu_torch.core.windows import WinType
from windflow_tpu_torch.ops.functions import Reducer
from windflow_tpu_torch.parallel.mesh import KF_AXIS
from windflow_tpu_torch.parallel.multihost import (local_kf_groups,
                                             make_multihost_mesh,
                                             process_for_keys)
from windflow_tpu_torch.patterns.basic import Sink, Source
from windflow_tpu_torch.patterns.key_farm import KeyFarm
from windflow_tpu_torch.runtime.engine import Dataflow
from windflow_tpu_torch.runtime.farm import build_pipeline

mesh = make_multihost_mesh(n_sp=2, n_wf=1, devices=["cpu"] * 4)
assert mesh.processes.tolist() == [[[0, 0]], [[0, 0]], [[1, 1]], [[1, 1]]]
n_kf = int(mesh.shape[KF_AXIS])
mine = set(int(g) for g in local_kf_groups(mesh))

# the shared deterministic stream (both processes derive it identically);
# each process KEEPS ONLY the keys whose kf group it owns — the multihost
# source contract (no row ever crosses the DCN boundary)
schema = Schema(value=np.int64)
keys_all, n = 12, 96
batches = []
for lo in range(0, n, 24):
    m = min(24, n - lo)
    ids = np.repeat(np.arange(lo, lo + m), keys_all)
    ks = np.tile(np.arange(keys_all), m)
    vals = ids * 3 + ks
    b = batch_from_columns(schema, key=ks, id=ids, ts=ids, value=vals)
    owner = process_for_keys(b["key"], mesh)
    batches.append(b[owner == pid])

per_key = {}

def snk(rows):
    if rows is not None:
        for r in rows:
            per_key.setdefault(int(r["key"]), []).append(
                [int(r["id"]), int(r["value"])])

df = Dataflow()
build_pipeline(df, [Source(batches=iter(batches), schema=schema),
                    KeyFarm(Reducer("sum"), 16, 4, WinType.CB,
                            pardegree=2),
                    Sink(snk, vectorized=True)])
df.run_and_wait_end()

# every key this process produced must belong to a kf group it owns
from windflow_tpu_torch.runtime.emitters import default_routing
for k in per_key:
    assert int(default_routing(np.asarray([k]), n_kf)[0]) in mine, k

with open(out_path, "w") as f:
    json.dump({"pid": pid, "n_kf": n_kf, "mine": sorted(mine),
               "per_key": {str(k): v for k, v in per_key.items()}}, f)
import torch.distributed
torch.distributed.destroy_process_group()
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_kf_split_totals(tmp_path):
    port = _free_port()
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(__file__))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    procs, outs = [], []
    for pid in range(2):
        out = tmp_path / f"out{pid}.json"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(port), str(pid), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    results = []
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, stderr.decode()[-4000:]
    for out in outs:
        results.append(json.loads(out.read_text()))

    # the two processes partition the kf groups
    assert set(results[0]["mine"]).isdisjoint(results[1]["mine"])
    assert (sorted(results[0]["mine"] + results[1]["mine"])
            == list(range(results[0]["n_kf"])))
    merged = {}
    for r in results:
        for k, rows in r["per_key"].items():
            assert k not in merged, f"key {k} produced by both processes"
            merged[int(k)] = rows

    # single-process oracle over the full stream
    from windflow_tpu.core.tuples import Schema, batch_from_columns
    from windflow_tpu.core.windows import WindowSpec, WinType
    from windflow_tpu.core.winseq import WinSeqCore
    from windflow_tpu.ops.functions import Reducer
    keys_all, n = 12, 96
    want = {}
    core = WinSeqCore(WindowSpec(16, 4, WinType.CB), Reducer("sum"))
    schema = Schema(value=np.int64)
    for lo in range(0, n, 24):
        m = min(24, n - lo)
        ids = np.repeat(np.arange(lo, lo + m), keys_all)
        ks = np.tile(np.arange(keys_all), m)
        res = core.process(batch_from_columns(
            schema, key=ks, id=ids, ts=ids, value=ids * 3 + ks))
        for r in res:
            want.setdefault(int(r["key"]), []).append(
                [int(r["id"]), int(r["value"])])
    for r in core.flush():
        want.setdefault(int(r["key"]), []).append(
            [int(r["id"]), int(r["value"])])
    assert merged == want


_WORKER_DATAPLANE = r"""
import json, sys, time
import numpy as np
from windflow_tpu_torch.parallel.multihost import initialize

coord_port, pid, my_port, peer_port, out_path = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
    sys.argv[5])
initialize(coordinator_address=f"127.0.0.1:{coord_port}", num_processes=2,
           process_id=pid)

from windflow_tpu_torch.core.tuples import Schema, batch_from_columns
from windflow_tpu_torch.core.windows import WinType
from windflow_tpu_torch.ops.functions import Reducer
from windflow_tpu_torch.parallel.channel import (RowReceiver, RowSender,
                                           partition_and_ship)
from windflow_tpu_torch.parallel.multihost import (make_multihost_mesh,
                                             process_for_keys)
from windflow_tpu_torch.patterns.basic import Sink, Source
from windflow_tpu_torch.patterns.key_farm import KeyFarm
from windflow_tpu_torch.runtime.engine import Dataflow
from windflow_tpu_torch.runtime.farm import build_pipeline

mesh = make_multihost_mesh(n_sp=2, n_wf=1, devices=["cpu"] * 4)

# the NON-key-partitioned input: process p generates id range
# [p*n/2, (p+1)*n/2) for EVERY key and ships non-owned rows to the peer
# over the row channel (parallel/channel.py) — the data plane the
# key-local deployment model does not need, exercised for real
schema = Schema(value=np.int64)
keys_all, n = 12, 96
half = n // 2

recv = RowReceiver(n_senders=1, port=my_port)
snd = None
for _ in range(100):
    try:
        snd = RowSender("127.0.0.1", peer_port)
        break
    except OSError:
        time.sleep(0.1)
assert snd is not None, "peer receiver never came up"

def my_chunks():
    lo0 = pid * half
    for lo in range(lo0, lo0 + half, 24):
        m = min(24, lo0 + half - lo)
        ids = np.repeat(np.arange(lo, lo + m), keys_all)
        ks = np.tile(np.arange(keys_all), m)
        yield batch_from_columns(schema, key=ks, id=ids, ts=ids,
                                 value=ids * 3 + ks)

def feed():
    # origin order (p0's ids < p1's): keeps per-key arrival in id order
    def local_phase():
        for b in my_chunks():
            owners = process_for_keys(b["key"], mesh)
            yield partition_and_ship(b, owners, pid, {1 - pid: snd})
        snd.close()
    if pid == 0:
        yield from local_phase()
        yield from recv.batches()
    else:
        yield from recv.batches()
        yield from local_phase()

per_key = {}

def snk(rows):
    if rows is not None:
        for r in rows:
            per_key.setdefault(int(r["key"]), []).append(
                [int(r["id"]), int(r["value"])])

df = Dataflow()
build_pipeline(df, [Source(batches=feed(), schema=schema),
                    KeyFarm(Reducer("sum"), 16, 4, WinType.CB,
                            pardegree=2),
                    Sink(snk, vectorized=True)])
df.run_and_wait_end()

with open(out_path, "w") as f:
    json.dump({"pid": pid,
               "per_key": {str(k): v for k, v in per_key.items()}}, f)
import torch.distributed
torch.distributed.destroy_process_group()
"""


def test_two_process_row_channel_data_plane(tmp_path):
    """The cross-process row channel (parallel/channel.py): each process
    generates HALF the stream for every key and ships non-owned rows to
    the owner over TCP; the merged per-key results must equal the
    single-process oracle over the full stream — the multi-host data
    plane as a runtime capability."""
    coord = _free_port()
    ports = [_free_port(), _free_port()]
    worker = tmp_path / "worker_dp.py"
    worker.write_text(_WORKER_DATAPLANE)
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(__file__))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    procs, outs = [], []
    for pid in range(2):
        out = tmp_path / f"dp{pid}.json"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(coord), str(pid),
             str(ports[pid]), str(ports[1 - pid]), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    for p in procs:
        try:
            _stdout, stderr = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, stderr.decode()[-4000:]
    merged = {}
    for out in outs:
        r = json.loads(out.read_text())
        for k, rows in r["per_key"].items():
            assert k not in merged, f"key {k} produced by both processes"
            merged[int(k)] = rows

    # single-process oracle over the FULL stream
    from windflow_tpu.core.tuples import Schema, batch_from_columns
    from windflow_tpu.core.windows import WindowSpec, WinType
    from windflow_tpu.core.winseq import WinSeqCore
    from windflow_tpu.ops.functions import Reducer
    keys_all, n = 12, 96
    want = {}
    core = WinSeqCore(WindowSpec(16, 4, WinType.CB), Reducer("sum"))
    schema = Schema(value=np.int64)
    for lo in range(0, n, 24):
        m = min(24, n - lo)
        ids = np.repeat(np.arange(lo, lo + m), keys_all)
        ks = np.tile(np.arange(keys_all), m)
        res = core.process(batch_from_columns(
            schema, key=ks, id=ids, ts=ids, value=ids * 3 + ks))
        for r in res:
            want.setdefault(int(r["key"]), []).append(
                [int(r["id"]), int(r["value"])])
    for r in core.flush():
        want.setdefault(int(r["key"]), []).append(
            [int(r["id"]), int(r["value"])])
    assert merged == want


def test_row_channel_fails_fast_on_dead_peer():
    """A connection dying mid-stream must surface as an error from
    batches(), never as a silently truncated stream (wrong totals)."""
    import socket
    import threading
    import numpy as np
    from windflow_tpu_torch.core.tuples import Schema, batch_from_columns
    from windflow_tpu_torch.parallel.channel import RowReceiver, RowSender

    schema = Schema(value=np.int64)
    recv = RowReceiver(n_senders=1)

    def half_send():
        s = RowSender("127.0.0.1", recv.port)
        ids = np.arange(4)
        s.send(batch_from_columns(schema, key=np.zeros(4), id=ids, ts=ids,
                                  value=ids))
        # die without EOS: hard close mid-protocol
        s._sock.shutdown(socket.SHUT_RDWR)
        s._sock.close()

    t = threading.Thread(target=half_send)
    t.start()
    got, err = [], None
    try:
        for b in recv.batches():
            got.append(b)
    except (ConnectionError, OSError) as e:
        err = e
    t.join()
    assert err is not None, "dead peer was swallowed as EOS"


_RESUME_SENDER = r"""
import os, sys, time
import numpy as np
from windflow_tpu_torch.core.tuples import Schema, batch_from_columns
from windflow_tpu_torch.parallel.channel import RowSender, WireResume

port, flag_path = int(sys.argv[1]), sys.argv[2]
schema = Schema(value=np.int64)
snd = RowSender("127.0.0.1", port, resume=WireResume(deadline=30.0),
                connect_deadline=30.0)

def ship(lo, hi):
    for i in range(lo, hi):
        snd.send(batch_from_columns(schema, key=[0], id=[i], ts=[i],
                                    value=[i]))

ship(0, 8)
snd.send_epoch(1)
ship(8, 16)
snd.send_epoch(2)
# hold the last epoch until the parent signals the restarted receiver is
# up — keeps the sender alive across the peer's death
deadline = time.time() + 60
while not os.path.exists(flag_path):
    assert time.time() < deadline, "restart flag never appeared"
    time.sleep(0.05)
ship(16, 24)
snd.send_epoch(3)
snd.close()
print("SENDER_OK")
"""

_RESUME_RECV_A = r"""
import json, os, sys
import numpy as np
from windflow_tpu_torch.parallel.channel import RowReceiver, WireResume
from windflow_tpu_torch.recovery.epoch import EpochMarker

port, out_path = int(sys.argv[1]), sys.argv[2]
r = RowReceiver(1, port=port, resume=WireResume(deadline=30.0),
                ack_epochs=True, accept_timeout=60.0)
it = r.batches(epoch_markers=True)
sealed = []
for item in it:
    if isinstance(item, EpochMarker):
        break                      # epoch-1 barrier (auto-acked)
    sealed.append(int(item["value"][0]))
with open(out_path, "w") as f:
    json.dump({"sealed": sealed}, f)
    f.flush()
    os.fsync(f.fileno())
taken = 0
for item in it:                    # wander into epoch 2, then die hard
    if not isinstance(item, EpochMarker):
        taken += 1
        if taken >= 3:
            break
os._exit(1)
"""

_RESUME_RECV_B = r"""
import json, sys
import numpy as np
from windflow_tpu_torch.parallel.channel import RowReceiver, WireResume
from windflow_tpu_torch.recovery.epoch import EpochMarker

port, out_path = int(sys.argv[1]), sys.argv[2]
r = RowReceiver(1, port=port, resume=WireResume(deadline=30.0),
                resume_epoch=1, ack_epochs=True, accept_timeout=60.0)
got = []
for item in r.batches(epoch_markers=True):
    if not isinstance(item, EpochMarker):
        got.append(int(item["value"][0]))
r.close()
with open(out_path, "w") as f:
    json.dump({"got": got}, f)
print("RECV_B_OK")
"""


def test_receiver_process_restart_resumes_wire(tmp_path):
    """The resume handshake across REAL process boundaries (the
    in-process twins live in tests/test_channel_faults.py): receiver A
    acks the epoch-1 barrier and hard-exits mid-epoch-2; a fresh process
    B re-binds the same port with resume_epoch=1; the journaling sender
    replays epoch 2 from its journal and finishes — A saw exactly epoch
    1, B sees exactly epochs 2..3, no gaps and no duplicates."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(__file__))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    env.setdefault("JAX_PLATFORMS", "cpu")
    scripts = {}
    for name, src in (("sender", _RESUME_SENDER), ("recv_a", _RESUME_RECV_A),
                      ("recv_b", _RESUME_RECV_B)):
        p = tmp_path / f"{name}.py"
        p.write_text(src)
        scripts[name] = p
    out_a, out_b = tmp_path / "out_a.json", tmp_path / "out_b.json"
    flag = tmp_path / "restart.flag"

    procs = []
    try:
        recv_a = subprocess.Popen(
            [sys.executable, str(scripts["recv_a"]), str(port), str(out_a)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        procs.append(recv_a)
        sender = subprocess.Popen(
            [sys.executable, str(scripts["sender"]), str(port), str(flag)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        procs.append(sender)
        _out, err_a = recv_a.communicate(timeout=120)
        assert recv_a.returncode == 1, (recv_a.returncode,
                                        err_a.decode()[-4000:])
        recv_b = subprocess.Popen(
            [sys.executable, str(scripts["recv_b"]), str(port), str(out_b)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        procs.append(recv_b)
        flag.touch()
        _out, err_s = sender.communicate(timeout=120)
        assert sender.returncode == 0, err_s.decode()[-4000:]
        _out, err_b = recv_b.communicate(timeout=120)
        assert recv_b.returncode == 0, err_b.decode()[-4000:]
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
        raise

    assert json.loads(out_a.read_text())["sealed"] == list(range(8))
    assert json.loads(out_b.read_text())["got"] == list(range(8, 24))


def test_partition_and_ship_rejects_uncovered_owner():
    import numpy as np
    import pytest as _pytest
    from windflow_tpu_torch.core.tuples import Schema, batch_from_columns
    from windflow_tpu_torch.parallel.channel import partition_and_ship
    schema = Schema(value=np.int64)
    b = batch_from_columns(schema, key=np.arange(6), id=np.arange(6),
                           ts=np.arange(6), value=np.arange(6))
    owners = np.array([0, 1, 2, 0, 1, 2])
    with _pytest.raises(KeyError, match="no\\s+RowSender"):
        partition_and_ship(b, owners, 0, {1: object()})


# ---------------------------------------------------------------------------
# cross-host recovery (docs/ROBUSTNESS.md "Cross-host recovery"): a feeder
# (pid 0) journals a keyed stream to two stateful workers over the row
# plane; each worker seals per-epoch state into a CheckpointStore,
# replicates it to its peer as a portable checkpoint, and acks the sealed
# epoch so the feeder's journal trims.  The kill test hard-kills one worker
# and asserts the survivor's PlaneSupervisor adopts it (restore at the last
# sealed epoch + takeover receiver replaying the journal tail); the roll
# test restarts BOTH workers mid-stream while the feeder keeps emitting.
# In both, the merged outputs must be byte-identical to the uncrashed
# single-process oracle — no gaps, no duplicates.

_PLANE_FEEDER = r"""
import json, sys, time
import numpy as np
from windflow_tpu_torch.core.tuples import Schema, batch_from_columns
from windflow_tpu_torch.parallel.channel import RowSender, WireResume

d1, d2, n_epochs = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
out_path = sys.argv[4]
schema = Schema(value=np.int64)
senders = {w: RowSender("127.0.0.1", p, resume=WireResume(deadline=120.0),
                        connect_deadline=60.0)
           for w, p in ((1, d1), (2, d2))}
bi = 0
for epoch in range(1, n_epochs + 1):
    for _ in range(2):
        keys = np.arange(8, dtype=np.int64)
        ids = np.full(8, bi, dtype=np.int64)
        vals = 7 * ids + keys + 1
        for w in (1, 2):
            m = (1 + keys % 2) == w
            senders[w].send(batch_from_columns(
                schema, key=keys[m], id=ids[m], ts=ids[m], value=vals[m]))
        bi += 1
    for w in (1, 2):
        senders[w].send_epoch(epoch)
    time.sleep(0.1)   # keep emitting WHILE kills/rolls happen downstream
for w in (1, 2):
    senders[w].close()
with open(out_path, "w") as f:
    json.dump({"batches": bi}, f)
"""

_PLANE_WORKER = r"""
import json, os, sys, threading, time
from windflow_tpu_torch.parallel.channel import (RowReceiver, RowSender,
                                           WireConfig, WireResume)
from windflow_tpu_torch.parallel.plane import PlanePolicy, PlaneSupervisor
from windflow_tpu_torch.recovery.epoch import EpochMarker
from windflow_tpu_torch.recovery.portable import PortableSpool
from windflow_tpu_torch.recovery.store import CheckpointStore

w = int(sys.argv[1])
d1, d2, m1, m2 = (int(a) for a in sys.argv[2:6])
root, die_after, summary_path = sys.argv[6], int(sys.argv[7]), sys.argv[8]
peer = 3 - w
my_data, my_mon = (d1, m1) if w == 1 else (d2, m2)
peer_mon = m2 if w == 1 else m1

store = CheckpointStore(os.path.join(root, f"store{w}"), retain=8)
spool = PortableSpool(os.path.join(root, f"spool{w}"))

# data plane: the feeder's journaling sender; acks are manual, at SEAL
recv = RowReceiver(1, port=my_data, resume=WireResume(deadline=120.0),
                   ack_epochs=False, accept_timeout=60.0)
# monitor plane: peer liveness (its death = our link EOF) + the landing
# zone for the peer's replicated portable checkpoints
mon_recv = RowReceiver(1, port=my_mon, resume=WireResume(deadline=240.0),
                       accept_timeout=60.0, ckpt_sink=spool)
mon_snd = RowSender("127.0.0.1", peer_mon, resume=WireResume(deadline=240.0),
                    connect_deadline=60.0)

adopted_rows, alock = [], threading.Lock()
ctx = {}
adopt_started, adopt_done = threading.Event(), threading.Event()


def apply(rows, sums, sink):
    for r in rows:
        k, v = int(r["key"]), int(r["value"])
        sums[k] = sums.get(k, 0) + v
        sink.append([k, int(r["id"]), sums[k]])


def on_adopt(dead, epoch, st):
    ctx["adopted_from"] = [int(dead), int(epoch)]

    def run():
        try:
            sums2 = st.load(int(epoch), "sums")
            tr = ctx["sup"].takeover_receiver(dead, epoch, n_senders=1)
            pend = []
            for item in tr.batches(epoch_markers=True):
                if isinstance(item, EpochMarker):
                    with alock:
                        adopted_rows.extend(pend)
                    pend = []
                    tr.ack_epoch(int(item.epoch))
                    continue
                apply(item, sums2, pend)
            tr.close()
        except Exception as e:                      # noqa: BLE001
            ctx["adopt_error"] = repr(e)
        finally:
            adopt_done.set()

    threading.Thread(target=run, daemon=True).start()
    adopt_started.set()


policy = PlanePolicy(
    down_deadline=2.0, period=0.1, candidates={1, 2},
    wire=WireConfig(connect_deadline=60.0, heartbeat=2.0,
                    stall_timeout=30.0, resume=True, recovery=False))
sup = PlaneSupervisor(w, {1: ("127.0.0.1", d1), 2: ("127.0.0.1", d2)},
                      {peer: mon_snd}, policy=policy, store=store,
                      spool=spool, on_adopt=on_adopt)
ctx["sup"] = sup
sup.start()
# ready: both planes are connected and supervised; the test starts the
# feeder only then, so a peer never dies before its monitor link is up
open(os.path.join(root, f"ready{w}"), "w").close()

sums, pending = {}, []
out_f = open(os.path.join(root, f"out{w}.jsonl"), "a")
for item in recv.batches(epoch_markers=True):
    if isinstance(item, EpochMarker):
        e = int(item.epoch)
        n = store.save_blob(e, "sums", dict(sums))
        store.commit(e, {"sums": {"bytes": n}})
        for row in pending:
            out_f.write(json.dumps(row) + "\n")
        out_f.flush()
        os.fsync(out_f.fileno())
        pending = []
        sup.replicate(e)
        recv.ack_epoch(e)
        if die_after and e >= die_after:
            os._exit(1)   # kill -9: no EOS, no teardown, nothing flushed
        continue
    apply(item, sums, pending)

# a whole detection window (many down-deadlines), not the reference's
# 0.5 s: under host load the peer's death may be declared well after this
# worker's own stream ends
if adopt_started.wait(20.0):
    assert adopt_done.wait(120.0), "adopted tail never finished"
    assert "adopt_error" not in ctx, ctx["adopt_error"]

recv.close()
sup.close()
mon_snd.abort()
mon_recv.close()
with alock:
    rows = list(adopted_rows)
with open(summary_path, "w") as f:
    json.dump({"pid": w, "adopted_from": ctx.get("adopted_from"),
               "adopted_rows": rows}, f)
"""

_ROLL_WORKER = r"""
import json, os, sys
from windflow_tpu_torch.parallel.channel import RowReceiver, WireResume
from windflow_tpu_torch.recovery.epoch import EpochMarker
from windflow_tpu_torch.recovery.store import CheckpointStore

w = int(sys.argv[1])
port, root = int(sys.argv[2]), sys.argv[3]
stop_after, resume_from = int(sys.argv[4]), int(sys.argv[5])

store = CheckpointStore(os.path.join(root, f"store{w}"), retain=8)
sums = {}
if resume_from:
    latest = store.latest_complete()
    assert latest is not None and latest[0] == resume_from, latest
    sums = store.load(resume_from, "sums")

recv = RowReceiver(1, port=port, resume=WireResume(deadline=120.0),
                   resume_epoch=(resume_from or None), ack_epochs=False,
                   accept_timeout=60.0)
pending = []
out_f = open(os.path.join(root, f"out{w}.jsonl"), "a")
for item in recv.batches(epoch_markers=True):
    if isinstance(item, EpochMarker):
        e = int(item.epoch)
        n = store.save_blob(e, "sums", dict(sums))
        store.commit(e, {"sums": {"bytes": n}})
        for row in pending:
            out_f.write(json.dumps(row) + "\n")
        out_f.flush()
        os.fsync(out_f.fileno())
        pending = []
        recv.ack_epoch(e)
        if stop_after and e >= stop_after:
            os._exit(0)   # rolling restart: exit at the seal, no EOS —
            #               the feeder's journal bridges the gap
        continue
    for r in item:
        k, v = int(r["key"]), int(r["value"])
        sums[k] = sums.get(k, 0) + v
        pending.append([k, int(r["id"]), sums[k]])
recv.close()
"""


def _plane_oracle(n_epochs):
    """Uncrashed single-process oracle: per-key running sums over the
    deterministic feeder stream, as {key: [[id, cum], ...]}."""
    want, sums = {}, {}
    for bi in range(2 * n_epochs):
        for k in range(8):
            v = 7 * bi + k + 1
            sums[k] = sums.get(k, 0) + v
            want.setdefault(k, []).append([bi, sums[k]])
    return want


def _plane_rows(*paths):
    """Merge [key, id, cum] row files/lists into {key: rows-by-id}."""
    per_key = {}
    for rows in paths:
        for k, rid, cum in rows:
            per_key.setdefault(int(k), []).append([int(rid), int(cum)])
    for rows in per_key.values():
        rows.sort()
    return per_key


def _jsonl(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _wait_ready(tmp_path, workers, deadline=120.0):
    """Block until every worker has written its ready file (its planes
    connected, its supervisor running), failing if one exits first."""
    import time
    t_end = time.monotonic() + deadline
    for w, p in workers.items():
        while not (tmp_path / f"ready{w}").exists():
            if p.poll() is not None:
                raise AssertionError(
                    f"worker {w} exited ({p.returncode}) before it was "
                    f"ready: {p.stderr.read().decode()[-4000:]}")
            assert time.monotonic() < t_end, f"worker {w} never ready"
            time.sleep(0.05)


def test_three_process_kill_and_adopt(tmp_path):
    """Kill -9 one worker of a 3-process plane
    (feeder + 2 stateful workers).  The survivor's PlaneSupervisor must
    detect the death past the down-deadline, elect itself, restore the
    dead peer's state from its replicated portable checkpoint at the
    last SEALED epoch, and rebind the dead peer's address as a resume
    receiver — the feeder's journal replays exactly the unsealed tail.
    Merged outputs (survivor + dead worker's sealed prefix + adopted
    tail) must equal the uncrashed oracle: no gaps, no duplicates."""
    d1, d2, m1, m2 = (_free_port() for _ in range(4))
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(__file__))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    env.setdefault("JAX_PLATFORMS", "cpu")
    feeder_py = tmp_path / "feeder.py"
    feeder_py.write_text(_PLANE_FEEDER)
    worker_py = tmp_path / "worker.py"
    worker_py.write_text(_PLANE_WORKER)
    root = str(tmp_path)
    n_epochs = 6

    procs = []
    try:
        workers = {}
        for w, die_after in ((1, 0), (2, 2)):   # worker 2 dies at epoch 2
            workers[w] = subprocess.Popen(
                [sys.executable, str(worker_py), str(w), str(d1), str(d2),
                 str(m1), str(m2), root, str(die_after),
                 str(tmp_path / f"summary{w}.json")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            procs.append(workers[w])
        _wait_ready(tmp_path, workers)
        feeder = subprocess.Popen(
            [sys.executable, str(feeder_py), str(d1), str(d2),
             str(n_epochs), str(tmp_path / "feeder.json")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        procs.append(feeder)
        _out, err2 = workers[2].communicate(timeout=240)
        assert workers[2].returncode == 1, (workers[2].returncode,
                                            err2.decode()[-4000:])
        _out, err_f = feeder.communicate(timeout=240)
        assert feeder.returncode == 0, err_f.decode()[-4000:]
        _out, err1 = workers[1].communicate(timeout=240)
        assert workers[1].returncode == 0, err1.decode()[-4000:]
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
        raise

    summary = json.loads((tmp_path / "summary1.json").read_text())
    assert summary["adopted_from"] == [2, 2], summary["adopted_from"]
    merged = _plane_rows(_jsonl(os.path.join(root, "out1.jsonl")),
                         _jsonl(os.path.join(root, "out2.jsonl")),
                         summary["adopted_rows"])
    assert merged == _plane_oracle(n_epochs)


def test_rolling_restart_zero_loss(tmp_path):
    """Roll every stateful worker of the plane —
    each seals an epoch, exits without EOS, and restarts with
    ``resume_epoch=`` at its own sealed checkpoint — while the feeder
    keeps emitting the whole time (its journaling senders bridge each
    restart gap and replay the unsealed tail to the rebooted process).
    Merged outputs must equal the uncrashed oracle: zero record loss,
    zero duplication."""
    d1, d2 = _free_port(), _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(__file__))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    env.setdefault("JAX_PLATFORMS", "cpu")
    feeder_py = tmp_path / "feeder.py"
    feeder_py.write_text(_PLANE_FEEDER)
    worker_py = tmp_path / "roll_worker.py"
    worker_py.write_text(_ROLL_WORKER)
    root = str(tmp_path)
    n_epochs = 8
    rolls = {1: 2, 2: 5}   # worker -> epoch it restarts at

    procs = []

    def spawn_worker(w, port, stop_after, resume_from):
        p = subprocess.Popen(
            [sys.executable, str(worker_py), str(w), str(port), root,
             str(stop_after), str(resume_from)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        procs.append(p)
        return p

    try:
        phase_a = {w: spawn_worker(w, p, rolls[w], 0)
                   for w, p in ((1, d1), (2, d2))}
        feeder = subprocess.Popen(
            [sys.executable, str(feeder_py), str(d1), str(d2),
             str(n_epochs), str(tmp_path / "feeder.json")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        procs.append(feeder)
        phase_b = {}
        for w, port in ((1, d1), (2, d2)):      # roll in plane order
            _out, err = phase_a[w].communicate(timeout=240)
            assert phase_a[w].returncode == 0, err.decode()[-4000:]
            phase_b[w] = spawn_worker(w, port, 0, rolls[w])
        _out, err_f = feeder.communicate(timeout=240)
        assert feeder.returncode == 0, err_f.decode()[-4000:]
        for w in (1, 2):
            _out, err = phase_b[w].communicate(timeout=240)
            assert phase_b[w].returncode == 0, err.decode()[-4000:]
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
        raise

    merged = _plane_rows(_jsonl(os.path.join(root, "out1.jsonl")),
                         _jsonl(os.path.join(root, "out2.jsonl")))
    assert merged == _plane_oracle(n_epochs)
