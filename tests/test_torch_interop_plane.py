"""The row plane across the two packages, in one process over localhost:
a JAX ``RowSender`` feeds a port ``RowReceiver`` and the reverse, with
epoch markers and a resumed edge, and the rows arrive identical; the two
senders put the same bytes on the wire; and a JAX resident core's sealed
epoch, shipped by the JAX ``ship_checkpoint`` into a port
``PortableSpool``, restores into the port's core (``interop.py``) and
continues the stream as the JAX core does, per key in order."""

import socket
import threading

import numpy as np
import pytest

from windflow_tpu.core.tuples import Schema as JSchema
from windflow_tpu.core.tuples import batch_from_columns as jbatch
from windflow_tpu.core.windows import WindowSpec as JWindowSpec
from windflow_tpu.core.windows import WinType as JWinType
from windflow_tpu.ops.functions import Reducer as JReducer
from windflow_tpu.parallel import channel as jch
from windflow_tpu.recovery.epoch import EpochMarker as JMarker
from windflow_tpu.patterns import native_core as jn
from windflow_tpu.patterns import win_seq_tpu as jw
from windflow_tpu.recovery import portable as jport
from windflow_tpu.recovery import store as jstore
import windflow_tpu_torch as wt
from windflow_tpu_torch.core.windows import WindowSpec, WinType
from windflow_tpu_torch.interop import carry_resident_state
from windflow_tpu_torch.parallel import channel as tch
from windflow_tpu_torch.patterns import native_core as tn
from windflow_tpu_torch.patterns import win_seq_gpu as tw
from windflow_tpu_torch.recovery import portable as tport
from windflow_tpu_torch.recovery.epoch import EpochMarker as TMarker

#: (sender's channel module, receiver's channel module, receiver's marker)
DIRECTIONS = {"jax-to-port": (jch, tch, TMarker),
              "port-to-jax": (tch, jch, JMarker)}
SCHEMA = JSchema(value=np.int64, weight=np.float32)


def mk_batch(n=8, lo=0):
    """A two-field batch (int64 and float32 payloads) built by the JAX
    package; the port's batches are the same numpy structured arrays."""
    ids = np.arange(lo, lo + n)
    return jbatch(SCHEMA, key=ids % 3, id=ids, ts=ids * 10, value=ids * 7,
                  weight=(ids * 0.5).astype(np.float32))


def _rows(items, marker):
    """Received items as ('rows', bytes) / ('epoch', e) in arrival order."""
    return [("epoch", int(x.epoch)) if isinstance(x, marker)
            else ("rows", np.ascontiguousarray(x).tobytes()) for x in items]


def _values(items, marker):
    out = []
    for x in items:
        if not isinstance(x, marker):
            out += [int(v) for v in x["value"]]
    return out


@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
def test_rows_and_epoch_markers_cross_packages(direction):
    """Data frames and epoch barriers from one package's sender arrive at
    the other's receiver byte for byte, the markers where they were
    sent."""
    snd_mod, recv_mod, marker = DIRECTIONS[direction]
    recv = recv_mod.RowReceiver(n_senders=1)
    snd = snd_mod.RowSender("127.0.0.1", recv.port)
    sent = []
    for i in range(6):
        b = mk_batch(5 + i, lo=100 * i)
        snd.send(b)
        sent.append(("rows", np.ascontiguousarray(b).tobytes()))
        if i % 2 == 1:
            snd.send_epoch(i // 2 + 1)
            sent.append(("epoch", i // 2 + 1))
    snd.close()
    got = _rows(recv.batches(epoch_markers=True), marker)
    recv.close()
    assert got == sent


@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
def test_resumed_edge_crosses_packages(direction):
    """A resumable edge killed mid-epoch: the first receiver consumes the
    sealed epoch 1 and dies while epoch 2 is half on the wire; a second
    receiver on the same port with ``resume_epoch=1`` gets the sender's
    journal replayed from the epoch-1 barrier.  The sealed prefix plus the
    tail equals the unkilled stream: no gap, no duplicate."""
    snd_mod, recv_mod, marker = DIRECTIONS[direction]

    def drive(port, half_sent, proceed):
        snd = snd_mod.RowSender("127.0.0.1", port,
                                resume=snd_mod.WireResume(deadline=30.0),
                                connect_deadline=30.0)
        for i in range(4):
            snd.send(mk_batch(1, lo=i))
        snd.send_epoch(1)
        for i in range(4, 8):
            snd.send(mk_batch(1, lo=i))
        half_sent.set()
        assert proceed.wait(60)
        for i in range(8, 12):
            snd.send(mk_batch(1, lo=i))
        snd.send_epoch(2)
        snd.close()

    rs = recv_mod.WireResume(deadline=30.0)
    r1 = recv_mod.RowReceiver(n_senders=1, resume=rs)
    port = r1.port
    sealed, entered = [], threading.Event()

    def consume_epoch1():
        for x in r1.batches(epoch_markers=True):
            if isinstance(x, marker):
                break
            sealed.extend(int(v) for v in x["value"])
        entered.set()

    ct = threading.Thread(target=consume_epoch1, daemon=True)
    ct.start()
    half_sent, proceed = threading.Event(), threading.Event()
    st = threading.Thread(target=drive, args=(port, half_sent, proceed),
                          daemon=True)
    st.start()
    assert entered.wait(60), "epoch-1 barrier never completed"
    assert half_sent.wait(60)
    ct.join(timeout=30)
    r1.close()                               # mid-epoch-2 death
    r2 = recv_mod.RowReceiver(n_senders=1, port=port, resume=rs,
                              resume_epoch=1)
    proceed.set()
    tail = _values(r2.batches(epoch_markers=True), marker)
    st.join(timeout=60)
    assert not st.is_alive()
    r2.close()
    assert sealed + tail == [7 * i for i in range(12)]


def _capture(send_fn):
    """Every byte one sender writes, off a raw socket."""
    srv = socket.create_server(("127.0.0.1", 0))
    t = threading.Thread(target=send_fn, args=(srv.getsockname()[1],),
                         daemon=True)
    t.start()
    conn, _ = srv.accept()
    raw = bytearray()
    while True:
        chunk = conn.recv(65536)
        if not chunk:
            break
        raw.extend(chunk)
    t.join(timeout=30)
    conn.close()
    srv.close()
    return bytes(raw)


def test_senders_put_identical_bytes_on_the_wire():
    """The wire format is byte-identical: the same batches, barriers and
    EOS through each package's sender give the same byte stream."""
    def feed(mod):
        def run(port):
            s = mod.RowSender("127.0.0.1", port)
            s.send(mk_batch(4))
            s.send_epoch(1)
            s.send(mk_batch(9, lo=50))
            s.send_epoch(2)
            s.close()
        return run

    jax_bytes = _capture(feed(jch))
    assert len(jax_bytes) > 0
    assert _capture(feed(tch)) == jax_bytes


# ---------------------------------- a JAX sealed epoch continued on the port

def cb_stream(n_keys, per_key, chunk=31, seed=12):
    rng = np.random.default_rng(seed)
    schema = JSchema(value=np.int64)
    out = []
    for lo in range(0, per_key, chunk):
        m = min(chunk, per_key - lo)
        ids = np.repeat(np.arange(lo, lo + m), n_keys)
        out.append(jbatch(schema, key=np.tile(np.arange(n_keys), m), id=ids,
                          ts=ids, value=rng.integers(-50, 100, m * n_keys)))
    return out


def per_key(batches):
    d = {}
    for b in batches:
        for r in b:
            d.setdefault(int(r["key"]), []).append(
                (int(r["id"]), int(r["ts"]), int(r["value"])))
    return d


def _cores(kind):
    """(JAX core, port core) of one kind over the same CB 16/4 sum."""
    kw = dict(batch_len=24, flush_rows=80)
    jspec = JWindowSpec(16, 4, JWinType.CB)
    pspec = WindowSpec(16, 4, WinType.CB)
    if kind == "resident":
        return (jw.ResidentWinSeqCore(jspec, JReducer("sum"), **kw),
                tw.ResidentWinSeqCore(pspec, wt.Reducer("sum"),
                                      device="cpu", **kw))
    return (jn.NativeResidentCore(jspec, JReducer("sum"), **kw),
            tn.NativeResidentCore(pspec, wt.Reducer("sum"), device="cpu",
                                  **kw))


@pytest.mark.parametrize("kind", ["resident", "native"])
def test_jax_sealed_epoch_ships_and_continues_on_port(kind, tmp_path):
    """Half the stream through a JAX core, drained and sealed as epoch 3
    into the JAX CheckpointStore; the JAX ``ship_checkpoint`` streams it
    over a JAX RowSender into a port RowReceiver whose ``ckpt_sink`` is a
    port PortableSpool; the port loads the spooled blob, carries it into
    its own core and runs the rest of the stream.  The port's rows after
    the cut equal the JAX core's over the whole stream, per key in
    order."""
    if kind == "native":
        from windflow_tpu_torch.native import enabled
        assert enabled() is not None, "the native library did not build"
    batches = cb_stream(4, 400)
    half = len(batches) // 2

    ref, _ = _cores(kind)
    want = []
    for b in batches:
        want += ref.process_batches(b)
    want += ref.flush_batches()

    jcore, pcore = _cores(kind)
    got = []
    for b in batches[:half]:
        got += jcore.process_batches(b)
    got += jcore.checkpoint_drain_batches()
    store = jstore.CheckpointStore(str(tmp_path / "jax_store"))
    n = store.save_blob(3, "df.wtpu", jcore.state_snapshot())
    store.commit(3, {"df.wtpu": {"bytes": n}})

    spool = tport.PortableSpool(str(tmp_path / "port_spool"))
    recv = tch.RowReceiver(n_senders=1, ckpt_sink=spool)
    snd = jch.RowSender("127.0.0.1", recv.port)
    assert jport.ship_checkpoint(snd, store, 3, origin=7) > 0
    snd.close()
    assert list(recv.batches()) == []
    recv.close()
    epoch, manifest = spool.latest(7)
    assert epoch == 3 and manifest["origin"] == 7
    state = spool.store_for(7).load(3, "df.wtpu")
    if kind == "resident":
        state = carry_resident_state(state)
    else:
        assert state["kind"] == "native"
    pcore.state_restore(state)
    for b in batches[half:]:
        got += pcore.process_batches(b)
    got += pcore.flush_batches()
    assert per_key(got) == per_key(want)
