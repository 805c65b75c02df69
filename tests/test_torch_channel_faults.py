"""Twins of tests/test_channel_faults.py over the port's row channel
(windflow_tpu_torch/parallel/{channel,faults,multihost}.py), the same
tests with the package name changed; tests/test_torch_interop_plane.py
holds the wire against the JAX package's.

Channel fault-injection tests (parallel/channel.py hardening): every
failure mode must surface as a *fast, classified error* — bounded
wall-clock, never an indefinite hang, never a silent truncation passed
off as clean EOS.  The wall-clock bounds are generous (CI jitter) but
orders of magnitude below "hang"."""

import socket
import threading
import time

import numpy as np
import pytest

from windflow_tpu_torch.core.tuples import Schema, batch_from_columns
from windflow_tpu_torch.parallel.channel import (_LEN, ChannelError, PeerAbort,
                                           PeerStall, RowReceiver,
                                           RowSender, WireConfig,
                                           WireResume, _encode_dtype)

SCHEMA = Schema(value=np.int64)


def mk_batch(n=8, lo=0):
    ids = np.arange(lo, lo + n)
    return batch_from_columns(SCHEMA, key=np.zeros(n), id=ids, ts=ids,
                              value=ids)


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ------------------------------------------------------- connect retries

def test_connection_refused_without_deadline_fails_immediately():
    t0 = time.monotonic()
    with pytest.raises(OSError):
        RowSender("127.0.0.1", free_port())
    assert time.monotonic() - t0 < 5


def test_connection_refused_with_deadline_bounded():
    """Backoff retries stop at the total deadline with a clear error —
    not one attempt, not forever."""
    t0 = time.monotonic()
    with pytest.raises(ConnectionError, match="attempts"):
        RowSender("127.0.0.1", free_port(), connect_deadline=0.5)
    dt = time.monotonic() - t0
    assert 0.3 < dt < 10


def test_connect_retry_reaches_late_receiver():
    """Peers boot in any order: a sender started BEFORE its receiver
    connects once the receiver comes up (exponential backoff + jitter)."""
    port = free_port()
    out = {}

    def late_boot():
        time.sleep(0.4)
        out["recv"] = RowReceiver(n_senders=1, port=port)

    t = threading.Thread(target=late_boot)
    t.start()
    snd = RowSender("127.0.0.1", port, connect_deadline=30)
    t.join()
    snd.send(mk_batch())
    snd.close()
    got = list(out["recv"].batches())
    assert len(got) == 1 and got[0]["value"].sum() == 28


# ------------------------------------------------------------ peer death

def test_receiver_killed_mid_stream_fails_sender_fast():
    """A receiver that dies mid-stream surfaces as an OSError on the
    sender's send path within bounded time — not a hang, not silence."""
    recv = RowReceiver(n_senders=1)
    snd = RowSender("127.0.0.1", recv.port)
    snd.send(mk_batch())
    recv.close()
    t0 = time.monotonic()
    with pytest.raises(OSError):
        # TCP buffers the first post-mortem sends; the RST lands within
        # a few round trips
        for i in range(1000):
            snd.send(mk_batch(lo=i))
            time.sleep(0.001)
    assert time.monotonic() - t0 < 30


def test_sender_killed_mid_stream_fails_receiver():
    """Hard sender death without EOS is an error from batches(), never a
    clean (truncated) end of stream."""
    recv = RowReceiver(n_senders=1)

    def half_send():
        snd = RowSender("127.0.0.1", recv.port)
        snd.send(mk_batch())
        snd._sock.shutdown(socket.SHUT_RDWR)
        snd._sock.close()

    t = threading.Thread(target=half_send)
    t.start()
    with pytest.raises((ConnectionError, OSError)):
        list(recv.batches())
    t.join()


def test_close_on_dead_peer_is_flagged_not_clean():
    """RowSender.close() must SURFACE an undeliverable EOS (peer already
    dead) instead of reporting a clean shutdown."""
    recv = RowReceiver(n_senders=1)
    snd = RowSender("127.0.0.1", recv.port)
    snd.send(mk_batch())

    class DeadSock:
        def sendall(self, data):
            raise BrokenPipeError("peer gone")

        def close(self):
            pass

    snd._sock.close()
    snd._sock = DeadSock()
    assert snd.failed is None
    with pytest.raises(ChannelError, match="not delivered"):
        snd.close()
    assert isinstance(snd.failed, OSError)


def test_never_connected_sender_bounded_by_accept_timeout():
    """A peer that dies before EVER connecting must surface within the
    accept window — not hang batches() forever waiting for accept()."""
    recv = RowReceiver(n_senders=1, accept_timeout=0.5)
    t0 = time.monotonic()
    with pytest.raises(PeerStall, match="0/1 senders"):
        list(recv.batches())
    assert time.monotonic() - t0 < 10


def test_receiver_close_wakes_blocked_batches():
    """close() during the accept phase must wake a consumer blocked in
    batches() with a classified error, not leave it blocked forever."""
    recv = RowReceiver(n_senders=1)
    result = {}

    def consume():
        try:
            list(recv.batches())
            result["err"] = None
        except Exception as e:  # noqa: BLE001 — asserted below
            result["err"] = e

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    time.sleep(0.2)
    recv.close()
    t.join(timeout=10)
    assert not t.is_alive(), "batches() still blocked after close()"
    assert isinstance(result["err"], ChannelError)


def _blackhole_addr():
    """((host, port), holder): an address this host cannot complete a
    connect to.  10.255.255.1 drops SYNs silently on typical CI hosts,
    but some container networks NAT it to a real listener — probe first,
    and fall back to a bound-but-never-listening local socket (connects
    get RST: the refused path, still deadline-bounded)."""
    probe = socket.socket()
    probe.settimeout(0.25)
    try:
        probe.connect(("10.255.255.1", 9))
    except OSError:
        # timed out (genuine blackhole) or refused fast — either way the
        # address never yields a usable connection, so keep it
        probe.close()
        return ("10.255.255.1", 9), None
    probe.close()
    hold = socket.socket()
    hold.bind(("127.0.0.1", 0))      # bound, no listen(): RST on connect
    return hold.getsockname(), hold


def test_connect_deadline_clamps_attempt_timeout():
    """The per-attempt socket timeout is clamped to the remaining
    deadline, so a blackholed host cannot overshoot the bound by a whole
    attempt (attempt timeout 30s vs deadline 0.6s)."""
    (host, port), hold = _blackhole_addr()
    try:
        t0 = time.monotonic()
        with pytest.raises((ConnectionError, OSError)):
            RowSender(host, port, timeout=30.0, connect_deadline=0.6)
        assert time.monotonic() - t0 < 10
    finally:
        if hold is not None:
            hold.close()


# -------------------------------------------------------- frame protocol

def test_truncated_frame_is_an_error():
    """A frame header promising more bytes than ever arrive must raise,
    not hang or truncate."""
    recv = RowReceiver(n_senders=1)
    raw = socket.create_connection(("127.0.0.1", recv.port))
    d = _encode_dtype(mk_batch().dtype)
    raw.sendall(_LEN.pack(len(d)) + d)
    raw.sendall(_LEN.pack(100) + b"only ten b")
    raw.close()
    with pytest.raises(ConnectionError, match="mid-frame"):
        list(recv.batches())


def test_garbage_frame_length_is_an_error():
    recv = RowReceiver(n_senders=1)
    raw = socket.create_connection(("127.0.0.1", recv.port))
    raw.sendall(_LEN.pack(-99))   # below every known control family
    with pytest.raises(ChannelError, match="bad row-channel frame"):
        list(recv.batches())
    raw.close()


def test_ckpt_frame_with_garbage_subtype_is_an_error():
    """-7 is the portable-checkpoint family: a frame carrying an unknown
    subtype must raise, not hang waiting for a payload."""
    recv = RowReceiver(n_senders=1)
    raw = socket.create_connection(("127.0.0.1", recv.port))
    raw.sendall(_LEN.pack(-7) + _LEN.pack(99))
    with pytest.raises(ChannelError, match="ckpt subtype"):
        list(recv.batches())
    raw.close()


def test_abort_frame_distinguishable_from_eos():
    """abort() is the failure-path close: the receiver classifies it as
    PeerAbort (truncated prefix), NOT as a clean EOS."""
    recv = RowReceiver(n_senders=1)
    snd = RowSender("127.0.0.1", recv.port)
    snd.send(mk_batch())
    snd.abort()
    got = []
    with pytest.raises(PeerAbort, match="truncated"):
        for b in recv.batches():
            got.append(b)
    assert len(got) == 1    # data before the abort is delivered, flagged


# ------------------------------------------------------------ heartbeats

def test_heartbeat_stall_timeout_bounded():
    """A peer that goes silent mid-stream (no data, no heartbeat) trips
    the receiver's stall timeout within bounded wall-clock — the
    _read_exact-hangs-forever failure mode of the un-hardened channel."""
    recv = RowReceiver(n_senders=1, stall_timeout=0.5)
    raw = socket.create_connection(("127.0.0.1", recv.port))
    d = _encode_dtype(mk_batch().dtype)
    raw.sendall(_LEN.pack(len(d)) + d)
    t0 = time.monotonic()
    with pytest.raises(PeerStall, match="silent"):
        list(recv.batches())
    dt = time.monotonic() - t0
    assert dt < 10
    raw.close()


def test_heartbeats_keep_idle_link_alive():
    """An idle-but-alive sender (heartbeat < stall timeout) must NOT trip
    the stall timeout; the stream completes cleanly after the idle gap."""
    recv = RowReceiver(n_senders=1, stall_timeout=0.6)
    snd = RowSender("127.0.0.1", recv.port, heartbeat=0.1)
    err = []

    def feed():
        try:
            snd.send(mk_batch())
            time.sleep(1.3)         # > 2x stall timeout, bridged by beats
            snd.send(mk_batch(lo=100))
            snd.close()
        except Exception as e:  # noqa: BLE001 — surfaced via main thread
            err.append(e)

    t = threading.Thread(target=feed)
    t.start()
    got = list(recv.batches())
    t.join()
    assert not err
    assert len(got) == 2


def test_wire_config_defaults():
    w = WireConfig()
    assert (w.connect_deadline, w.heartbeat, w.stall_timeout) \
        == (None, None, None)       # bare = seed-identical protocol
    h = WireConfig.hardened()
    assert h.connect_deadline and h.heartbeat and h.stall_timeout
    assert h.stall_timeout >= 3 * h.heartbeat


# ----------------------------------------------- dataflow integration

def test_peer_death_surfaces_in_dataflow_errors():
    """The acceptance-criteria path: a multihost source feeding from a
    row channel whose peer stalls -> wait() raises within the stall
    timeout; the error lands in Dataflow._errors, no hang."""
    from windflow_tpu_torch.patterns.basic import Sink, Source
    from windflow_tpu_torch.runtime.engine import Dataflow
    from windflow_tpu_torch.runtime.farm import build_pipeline

    recv = RowReceiver(n_senders=1, stall_timeout=0.5)
    raw = socket.create_connection(("127.0.0.1", recv.port))
    d = _encode_dtype(mk_batch().dtype)
    raw.sendall(_LEN.pack(len(d)) + d)
    payload = np.ascontiguousarray(mk_batch()).tobytes()
    raw.sendall(_LEN.pack(len(payload)) + payload)
    # ... then the peer stalls mid-stream, forever

    df = Dataflow("wire", capacity=4)
    build_pipeline(df, [Source(batches=recv.batches(), schema=SCHEMA),
                        Sink(lambda rows: None, vectorized=True)])
    t0 = time.monotonic()
    with pytest.raises(PeerStall):
        df.run_and_wait_end()
    assert time.monotonic() - t0 < 10
    assert any(isinstance(e, PeerStall) for e in df._errors)
    raw.close()


def test_open_row_plane_two_ends():
    """multihost.open_row_plane builds a full hardened plane in any boot
    order; a clean run round-trips, and closing is clean."""
    from windflow_tpu_torch.parallel.multihost import open_row_plane

    addrs = {0: ("127.0.0.1", free_port()), 1: ("127.0.0.1", free_port())}
    wire = WireConfig(connect_deadline=30, heartbeat=0.2, stall_timeout=2.0)
    planes = {}

    def boot(pid):
        planes[pid] = open_row_plane(pid, addrs, wire=wire)

    threads = [threading.Thread(target=boot, args=(p,)) for p in (1, 0)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    r0, send0 = planes[0]
    r1, send1 = planes[1]
    send0[1].send(mk_batch())
    send0[1].close()
    send1[0].close()
    assert len(list(r1.batches())) == 1
    assert list(r0.batches()) == []


def test_open_row_plane_rejects_unknown_pid():
    with pytest.raises(KeyError, match="no entry"):
        from windflow_tpu_torch.parallel.multihost import open_row_plane
        open_row_plane(7, {0: ("127.0.0.1", 1)})


# ------------------------------------------------- wire epoch alignment

def test_wire_epoch_frames_align_across_senders():
    """RowSender.send_epoch / batches(epoch_markers=True): the receiver
    yields EpochMarker(e) only once EVERY sender shipped its epoch-e
    frame — after all rows of epochs <= e, before any later-epoch row
    (rows from senders that run ahead are held back)."""
    from windflow_tpu_torch.recovery.epoch import EpochMarker

    recv = RowReceiver(n_senders=2)
    s_a = RowSender("127.0.0.1", recv.port)
    s_b = RowSender("127.0.0.1", recv.port)
    # sender A runs two epochs ahead of sender B
    s_a.send(mk_batch(4, lo=0))        # epoch 1 content
    s_a.send_epoch(1)
    s_a.send(mk_batch(4, lo=100))      # epoch 2 content
    s_a.send_epoch(2)
    s_a.send(mk_batch(4, lo=200))      # tail content
    time.sleep(0.2)                    # let A's frames land first
    s_b.send(mk_batch(4, lo=1000))     # epoch 1 content
    s_b.send_epoch(1)
    s_b.send(mk_batch(4, lo=1100))     # epoch 2 content
    s_b.send_epoch(2)
    s_a.close()
    s_b.close()
    seq = list(recv.batches(epoch_markers=True))
    markers = [i for i, x in enumerate(seq) if isinstance(x, EpochMarker)]
    assert [seq[i].epoch for i in markers] == [1, 2]
    m1, m2 = markers
    lows = lambda idxs: {int(seq[i]["value"][0]) for i in idxs
                         if not isinstance(seq[i], EpochMarker)}
    # every epoch-1 row before marker 1; epoch-2 rows between the
    # markers; A's tail after marker 2
    assert {0, 1000} <= lows(range(m1))
    assert lows(range(m1)) & {100, 1100, 200} == set()
    assert lows(range(m1 + 1, m2)) == {100, 1100}
    assert lows(range(m2 + 1, len(seq))) == {200}
    # total content is conserved
    assert sum(len(x) for x in seq
               if not isinstance(x, EpochMarker)) == 20


def test_wire_epoch_frames_silent_without_optin():
    """Default batches() consumes epoch frames silently: same yielded
    rows as the un-epoched protocol."""
    recv = RowReceiver(n_senders=1)
    snd = RowSender("127.0.0.1", recv.port)
    snd.send(mk_batch(4))
    snd.send_epoch(1)
    snd.send(mk_batch(4, lo=50))
    snd.close()
    got = list(recv.batches())
    assert all(isinstance(b, np.ndarray) for b in got)
    assert sum(len(b) for b in got) == 8


def test_wire_epoch_eos_releases_held_rows():
    """A sender that closes while ahead of the barrier: EOS aligns it to
    every epoch, so held rows drain instead of truncating the stream."""
    recv = RowReceiver(n_senders=2)
    s_a = RowSender("127.0.0.1", recv.port)
    s_b = RowSender("127.0.0.1", recv.port)
    s_a.send(mk_batch(3))
    s_a.send_epoch(5)
    s_a.send(mk_batch(3, lo=10))   # beyond any epoch B will reach
    s_a.close()
    s_b.send(mk_batch(3, lo=20))
    s_b.close()                    # B never ships an epoch frame
    got = list(recv.batches(epoch_markers=True))
    rows = sum(len(x) for x in got if isinstance(x, np.ndarray))
    assert rows == 9               # nothing held forever, nothing lost


# ------------------------------------------------------------ wire resume
# docs/ROBUSTNESS.md "Wire resume": sender journals + -6 handshake +
# seq dedup make peer death on an established edge a bounded retry.
# Everything here is opt-in; the first tests pin the opt-OUT contract.

def _values(seq):
    """All row values, in arrival order, from a batches() iteration."""
    out = []
    for x in seq:
        if isinstance(x, np.ndarray):
            out.extend(int(v) for v in x["value"])
    return out


def test_wire_config_validate_called_from_constructors():
    """Satellite: a direct-constructed pair must reject an inconsistent
    WireConfig (WF205) at the constructor, not only via open_row_plane."""
    bad = WireConfig(heartbeat=5.0, stall_timeout=2.0)
    with pytest.raises(ValueError, match="WF205"):
        RowSender("127.0.0.1", 1, wire=bad)
    with pytest.raises(ValueError, match="WF205"):
        RowReceiver(n_senders=1, wire=bad)


def test_resume_unset_wire_is_byte_identical_to_seed():
    """resume= unset: the wire carries ONLY the seed grammar (dtype
    frame, data frames, -4 epochs, -1 EOS) — no -6 frames, no journal,
    no ack thread.  Captured off a raw socket so nothing in the channel
    implementation can vouch for itself."""
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]

    def feed():
        s = RowSender("127.0.0.1", port)
        s.send(mk_batch(4))
        s.send_epoch(1)
        s.send(mk_batch(4, lo=50))
        s.close()
        assert not hasattr(s, "_journal"), "journal built without resume="
        assert s._ack_thread is None if hasattr(s, "_ack_thread") else True

    t = threading.Thread(target=feed)
    t.start()
    conn, _ = srv.accept()
    raw = bytearray()
    while True:
        chunk = conn.recv(65536)
        if not chunk:
            break
        raw.extend(chunk)
    t.join()
    conn.close()
    srv.close()
    # parse the whole stream with the SEED grammar
    lens, off = [], 0
    while off < len(raw):
        (n,) = _LEN.unpack(bytes(raw[off:off + 8]))
        off += 8
        lens.append(n)
        if n > 0:
            off += n
        elif n == -4:
            off += 8
        else:
            assert n == -1, f"non-seed control frame {n} on the wire"
    assert off == len(raw)
    # dtype frame, data, epoch, data, EOS — and nothing else
    assert [n for n in lens if n < 0] == [-4, -1]
    assert sum(1 for n in lens if n > 0) == 3   # dtype + 2 payloads


def test_faults_module_never_imported_without_a_plan():
    """The chaos harness is dead weight unless threaded in: a plan-less
    roundtrip must not even import parallel.faults."""
    import subprocess
    import sys as _sys
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from windflow_tpu_torch.core.tuples import Schema, batch_from_columns\n"
        "from windflow_tpu_torch.parallel.channel import RowReceiver, RowSender\n"
        "r = RowReceiver(n_senders=1)\n"
        "s = RowSender('127.0.0.1', r.port)\n"
        "ids = np.arange(4)\n"
        "s.send(batch_from_columns(Schema(value=np.int64), key=ids*0,\n"
        "                          id=ids, ts=ids, value=ids))\n"
        "s.close()\n"
        "assert sum(len(b) for b in r.batches()) == 4\n"
        "assert 'windflow_tpu_torch.parallel.faults' not in sys.modules\n"
    )
    proc = subprocess.run([_sys.executable, "-c", code],
                          capture_output=True, timeout=120,
                          env={**__import__('os').environ,
                               "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]


def test_resume_roundtrip_preserves_order_and_markers():
    """A resumable edge with no faults yields exactly the seed
    sequence: rows in order, EpochMarker at the barrier."""
    from windflow_tpu_torch.recovery.epoch import EpochMarker
    rs = WireResume(deadline=10.0)
    recv = RowReceiver(n_senders=1, resume=rs)
    snd = RowSender("127.0.0.1", recv.port, resume=rs)
    snd.send(mk_batch(4))
    snd.send_epoch(1)
    snd.send(mk_batch(4, lo=50))
    snd.close()
    seq = list(recv.batches(epoch_markers=True))
    recv.close()
    markers = [i for i, x in enumerate(seq) if isinstance(x, EpochMarker)]
    assert len(markers) == 1 and seq[markers[0]].epoch == 1
    assert _values(seq) == list(range(4)) + list(range(50, 54))


def test_resume_receiver_restart_replays_tail():
    """Kill the receiver mid-stream; a restarted receiver on the same
    port gets the whole journaled tail replayed — nothing lost."""
    rs = WireResume(deadline=20.0)
    r1 = RowReceiver(n_senders=1, resume=rs)
    port = r1.port
    snd = RowSender("127.0.0.1", port, resume=rs, connect_deadline=10.0)
    for i in range(8):
        snd.send(mk_batch(1, lo=i))
    r1.close()                      # peer death, no EOS seen
    r2 = RowReceiver(n_senders=1, port=port, resume=rs)
    for i in range(8, 16):
        snd.send(mk_batch(1, lo=i))
    snd.close()
    vals = _values(r2.batches())
    r2.close()
    # r1 consumed nothing, so the fresh receiver sees the full stream
    assert sorted(set(vals)) == list(range(16))
    assert vals == sorted(vals), "replay broke arrival order"


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_resume_fault_plan_differential(seed):
    """Acceptance: >= 3 distinct seeded FaultPlans, output byte-identical
    (values, order) to the unfaulted oracle."""
    from windflow_tpu_torch.parallel.faults import FaultPlan
    plan = FaultPlan.seeded(seed, horizon=28, n_faults=3,
                            kinds=("kill", "torn", "dup"))
    rs = WireResume(deadline=15.0)
    recv = RowReceiver(n_senders=1, resume=rs)
    got, errs = [], []

    def consume():
        try:
            got.extend(_values(recv.batches(epoch_markers=True)))
        except Exception as e:
            errs.append(e)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    snd = RowSender("127.0.0.1", recv.port, resume=rs, faults=plan,
                    connect_deadline=10.0)
    for i in range(24):
        snd.send(mk_batch(1, lo=i))
        if (i + 1) % 6 == 0:
            snd.send_epoch((i + 1) // 6)
    snd.close()
    t.join(timeout=60)
    assert not t.is_alive() and not errs, (plan, errs)
    recv.close()
    assert got == list(range(24)), (plan, got)


def test_resume_dup_faults_dedup_by_seq():
    """Duplicated delivery (the at-least-once replay race) must be
    absorbed by seq dedup: exactly-once yield, exact order."""
    from windflow_tpu_torch.parallel.faults import FaultPlan
    rs = WireResume(deadline=10.0)
    recv = RowReceiver(n_senders=1, resume=rs)
    snd = RowSender("127.0.0.1", recv.port, resume=rs,
                    faults=FaultPlan(dup_at=(3, 6)))
    for i in range(8):
        snd.send(mk_batch(1, lo=i))
    snd.close()
    vals = _values(recv.batches())
    recv.close()
    assert vals == list(range(8))


def test_kill_peer_mid_epoch_restart_matches_oracle():
    """Acceptance: receiver killed and restarted mid-epoch with
    resume_epoch=K — sealed-epoch output from the dead receiver plus the
    restarted receiver's output equals the unkilled oracle, per-key
    byte-identical."""
    from windflow_tpu_torch.recovery.epoch import EpochMarker

    def drive(port, rs, half_sent, proceed):
        """Epoch 1, then HALF of epoch 2, then (gated) the rest — the
        gate keeps the sender alive across the receiver's death, so the
        kill really lands mid-epoch."""
        snd = RowSender("127.0.0.1", port, resume=rs,
                        connect_deadline=10.0)
        for i in range(4):
            snd.send(mk_batch(1, lo=i))
        snd.send_epoch(1)
        for i in range(4, 8):
            snd.send(mk_batch(1, lo=i))
        half_sent.set()
        assert proceed.wait(30)
        for i in range(8, 12):
            snd.send(mk_batch(1, lo=i))
        snd.send_epoch(2)
        snd.close()

    def events(pre_set=False):
        a, b = threading.Event(), threading.Event()
        if pre_set:
            b.set()
        return a, b

    # oracle: the same stream, nobody dies (gate pre-opened)
    rs = WireResume(deadline=20.0)
    r = RowReceiver(n_senders=1, resume=rs)
    t = threading.Thread(target=drive, args=(r.port, rs, *events(True)))
    t.start()
    oracle = _values(r.batches())
    t.join()
    r.close()

    # killed run: r1 consumes exactly the sealed epoch 1, then dies
    # while epoch 2 is half on the wire
    r1 = RowReceiver(n_senders=1, resume=rs)
    port = r1.port
    sealed, entered = [], threading.Event()

    def consume_epoch1():
        for x in r1.batches(epoch_markers=True):
            if isinstance(x, EpochMarker):
                break
            sealed.extend(int(v) for v in x["value"])
        entered.set()

    ct = threading.Thread(target=consume_epoch1, daemon=True)
    ct.start()
    half_sent, proceed = events()
    st = threading.Thread(target=drive, args=(port, rs, half_sent,
                                              proceed))
    st.start()
    assert entered.wait(30), "epoch-1 barrier never completed"
    assert half_sent.wait(30)
    ct.join(timeout=10)
    r1.close()                               # mid-epoch-2 death
    r2 = RowReceiver(n_senders=1, port=port, resume=rs, resume_epoch=1)
    proceed.set()
    tail = _values(r2.batches())
    st.join(timeout=30)
    r2.close()
    assert sealed + tail == oracle


def test_resume_journal_trims_on_epoch_ack():
    """ack_epochs (WireConfig recovery=): each completed barrier acks
    back and the sender journal trims to the unsealed tail — bounded by
    epoch width, the WF214 contract."""
    rs = WireResume(deadline=10.0)
    recv = RowReceiver(n_senders=1, resume=rs, ack_epochs=True)
    done = threading.Event()

    def consume():
        for _ in recv.batches(epoch_markers=True):
            pass
        done.set()

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    snd = RowSender("127.0.0.1", recv.port, resume=rs)
    for e in range(1, 4):
        for i in range(4):
            snd.send(mk_batch(1, lo=e * 10 + i))
        snd.send_epoch(e)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        with snd._journal_mu:
            depth = len(snd._journal)
        if depth == 0:
            break
        time.sleep(0.05)
    assert depth == 0, f"journal never trimmed (depth {depth})"
    snd.close()
    assert done.wait(10)
    recv.close()


def test_resume_journal_overflow_fails_loudly():
    """A journal past its cap evicts; a resume that would need the
    evicted prefix must raise ChannelError, never silently truncate."""
    rs = WireResume(deadline=3.0, journal_frames=4)
    r1 = RowReceiver(n_senders=1, resume=rs)
    port = r1.port
    snd = RowSender("127.0.0.1", port, resume=rs, connect_deadline=5.0)
    for i in range(10):                 # no acks: floor moves past 0
        snd.send(mk_batch(1, lo=i))
    r1.close()
    r2 = RowReceiver(n_senders=1, port=port, resume=rs)
    with pytest.raises(ChannelError):
        # the fresh receiver answers WELCOME{seq: 0} < journal floor
        for i in range(10, 40):
            snd.send(mk_batch(1, lo=i))
            time.sleep(0.05)
    snd.abort()
    r2.close()


def test_resume_counters_and_events():
    """Resume telemetry: wire_down/wire_resume events and the
    wire_resumes / wire_replayed_frames counters (docs/OBSERVABILITY.md)."""
    from windflow_tpu_torch.obs import EventLog, MetricsRegistry
    reg, log = MetricsRegistry(), EventLog()
    rs = WireResume(deadline=20.0)
    r1 = RowReceiver(n_senders=1, resume=rs, metrics=reg, events=log)
    port = r1.port
    snd = RowSender("127.0.0.1", port, resume=rs, connect_deadline=10.0,
                    metrics=reg, events=log)
    for i in range(4):
        snd.send(mk_batch(1, lo=i))
    r1.close()
    r2 = RowReceiver(n_senders=1, port=port, resume=rs,
                     metrics=reg, events=log)
    for i in range(4, 8):
        snd.send(mk_batch(1, lo=i))
    snd.close()
    assert _values(r2.batches()) == list(range(8))
    r2.close()
    assert reg.counter("wire_resumes").value >= 1
    assert reg.counter("wire_replayed_frames").value >= 1
    kinds = {e["event"] for e in log.recent}
    assert {"wire_down", "wire_resume"} <= kinds


def test_open_row_plane_resume_knob_plumbs_through():
    """open_row_plane(resume=...) hands the knob to both halves of the
    plane; unset leaves the raw seed channel objects."""
    from windflow_tpu_torch.parallel.multihost import open_row_plane
    p0, p1 = free_port(), free_port()
    addrs = {0: ("127.0.0.1", p0), 1: ("127.0.0.1", p1)}
    rs = WireResume(deadline=10.0)

    planes = {}

    def open_half(pid):
        planes[pid] = open_row_plane(pid, addrs, resume=rs)

    t = threading.Thread(target=open_half, args=(1,))
    t.start()
    open_half(0)
    t.join(timeout=30)
    recv0, senders0 = planes[0]
    recv1, senders1 = planes[1]
    try:
        assert recv0._resume is rs and recv1._resume is rs
        assert senders0[1]._resume is rs and senders1[0]._resume is rs
        senders0[1].send(mk_batch(3))
        senders0[1].close()
        senders1[0].close()
        assert sum(len(b) for b in recv1.batches()) == 3
        assert sum(len(b) for b in recv0.batches()) == 0
    finally:
        for r in (recv0, recv1):
            r.close()


def test_restarted_receiver_waits_for_its_old_address():
    """A receiver restarted on its old address (``resume_epoch=``: a roll
    in place, a takeover) retries a bind that finds the port still held
    (here by another listener, released after 0.3 s; in a roll in place,
    by the old receiver's listening socket until its accept thread leaves
    its poll); a fresh receiver on a taken port still fails at once.
    (Found by scripts/torch_soak_handoff.py's roll-in-place case on the
    card's host: EADDRINUSE at the rebind.)"""
    from windflow_tpu_torch.parallel.channel import RowReceiver, WireResume
    holder = socket.create_server(("127.0.0.1", 0))
    port = holder.getsockname()[1]
    with pytest.raises(OSError):
        RowReceiver(1, port=port)
    release = threading.Timer(0.3, holder.close)
    release.start()
    t0 = time.monotonic()
    recv = RowReceiver(1, port=port, resume=WireResume(deadline=5.0),
                       resume_epoch=3, accept_timeout=5.0)
    try:
        assert recv.port == port
        assert time.monotonic() - t0 >= 0.25
    finally:
        release.join()
        recv.close()


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
def test_soak_wire_slice():
    """Small in-suite slice of scripts/soak_wire.py (the full soak is a
    standalone seeded harness, docs/ROBUSTNESS.md "Wire resume"), its
    cases run over the port's channel by its twin,
    scripts/torch_soak_wire.py."""
    mod = _twin_script("soak_wire")
    for case in range(6):
        mod.run_case(seed=7, case=case)