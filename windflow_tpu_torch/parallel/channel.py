"""Cross-process row channels: the multi-host data plane.

The reference's "communication backend" is FastFlow shared-memory queues
between threads of ONE process (SURVEY.md §2.8 — no sockets, no MPI).
The multi-host deployment model (parallel/multihost.py) keeps key groups
process-local so the common case ships nothing — but a source whose input
is NOT naturally key-partitioned (a socket feed, a file) must be able to
forward rows to the process that owns their kf group.  This module is
that hop: a typed, length-framed, batched TCP channel carrying the same
SoA batches the in-process engine queues carry, so a remote stage slots
into a pipeline exactly like a local one.

Design notes (DCN-analog, deliberately boring):

* batches cross as raw structured-array bytes with an 8-byte length
  frame; the dtype travels once per connection as JSON of
  ``np.dtype(...).descr`` — a pure data encoding, so a hostile peer can
  at worst describe a weird dtype, never execute code (the channel
  trusts its cluster for data *integrity*, like NCCL/MPI transports do,
  but the wire format must not turn that trust into code execution);
* one receiver accepts any number of senders; per-connection reader
  threads feed one bounded queue, preserving per-sender batch order
  (cross-sender order is interleaved, as with any multi-producer edge —
  an OrderingNode downstream restores it where required);
* EOS is an empty frame per sender; ``batches()`` ends when every
  registered sender has closed — the FastFlow EOS cascade, one level up;
* hardening (all opt-in; with the knobs unset the bytes on the wire and
  the failure behavior are identical to the original protocol):

  - *connect retry*: ``RowSender(connect_deadline=...)`` retries a
    refused connection with exponential backoff + full jitter until the
    total deadline — peers may boot in any order;
  - *heartbeats*: ``RowSender(heartbeat=...)`` ships an empty control
    frame (length ``-2``) whenever the link has been idle for one
    interval, and passively probes the socket so a dead receiver
    surfaces at the *sender* within ~one interval too;
  - *stall timeout*: ``RowReceiver(stall_timeout=...)`` bounds how long
    ``_read_exact`` may sit on a silent socket — a peer that stalls
    mid-frame (or stops heartbeating) surfaces as :class:`PeerStall`
    instead of hanging the reader forever;
  - *abort vs EOS*: ``RowSender.abort()`` sends frame ``-3`` — the
    receiver raises :class:`PeerAbort` instead of counting a clean EOS,
    so a producer that died mid-stream can never silently truncate the
    stream;
  - *telemetry*: ``metrics=`` (an obs.MetricsRegistry) counts
    bytes/frames sent and received, connect retries and heartbeats
    sent/received/missed; ``events=`` (an obs.EventLog) records
    reconnect attempts, heartbeat misses and peer stalls/aborts
    (docs/OBSERVABILITY.md).  Both off (default) ⇒ the data path pays a
    single predictable branch per frame.
"""

from __future__ import annotations

import errno
import json
import queue
import random
import select
import socket
import struct
import threading
import time
from collections import deque

import numpy as np

_LEN = struct.Struct("<q")

#: control-frame codes carried in the length slot (negative = no
#: payload, except EPOCH — an 8-byte epoch follows — and TRACE — one
#: ordinary length-prefixed JSON payload describing the NEXT data
#: frame's span follows)
_EOS_FRAME = -1        # clean end-of-stream (original protocol)
_HEARTBEAT_FRAME = -2  # liveness beacon; carries no data
_ABORT_FRAME = -3      # sender died mid-stream: NOT a clean EOS
_EPOCH_FRAME = -4      # epoch barrier marker; 8-byte epoch payload follows
_TRACE_FRAME = -5      # span context for the next data frame (opt-in)
_RESUME_FRAME = -6     # resume protocol (docs/ROBUSTNESS.md "Wire
#                        resume"); an 8-byte subtype follows:
_RS_HELLO = 1          # sender->receiver on (re)connect: JSON
#                        {token, lo, hi} — identity + journal seq range
_RS_WELCOME = 2        # receiver->sender reply: JSON {"seq": S} (resume
#                        after the last contiguous seq delivered) or
#                        {"epoch": E} (a restarted receiver resuming from
#                        its last sealed checkpoint)
_RS_SEQ = 3            # sender->receiver: 8-byte seq tagging the NEXT
#                        data/epoch frame (the wire Tagged envelope)
_RS_ACK = 4            # receiver->sender: JSON {"epoch": E} | {"seq": S}
#                        — cumulative sealed ack; the sender trims its
#                        journal through it
_CKPT_FRAME = -7       # portable-checkpoint family (docs/ROBUSTNESS.md
#                        "Cross-host recovery"); an 8-byte subtype
#                        follows:
_CK_OFFER = 1          # sender->receiver: length-prefixed JSON portable
#                        header {v, origin, epoch, partial, nodes}
_CK_BLOB = 2           # sender->receiver: length-prefixed JSON envelope
#                        {origin, epoch, node, bytes, crc}, then the raw
#                        blob of exactly `bytes` bytes
_CK_COMMIT = 3         # sender->receiver: length-prefixed JSON {origin,
#                        epoch} — every blob shipped, the spool may seal
_TELEMETRY_FRAME = -8  # federated-telemetry snapshot
#                        (docs/OBSERVABILITY.md "Federation & SLOs"): one
#                        length-prefixed JSON snapshot follows — periodic,
#                        idempotent, never journaled (the next snapshot
#                        supersedes a lost one)


def _send_resume_frame(sock, sub: int, payload: dict):
    js = json.dumps(payload).encode("utf-8")
    sock.sendall(_LEN.pack(_RESUME_FRAME) + _LEN.pack(sub)
                 + _LEN.pack(len(js)) + js)


def _read_resume_json(sock) -> dict:
    n = _LEN.unpack(_read_exact(sock, _LEN.size))[0]
    if not 0 <= n <= (1 << 20):
        raise ChannelError(f"bad resume-frame payload length {n}")
    return json.loads(_read_exact(sock, n).decode("utf-8"))


class TracedRows(np.ndarray):
    """A received batch carrying its sender's span context: a plain
    ndarray view with one extra attribute, ``wf_trace`` (the dict the
    sender passed to ``send(..., trace=...)``, typically
    ``obs.trace.export()``), so consumers that don't care handle it
    exactly like any other batch — and a traced source node's emit
    *adopts* it automatically (obs/trace.py), stitching the remote trace
    onto the local graph.  Only produced by a
    ``RowReceiver(decode_trace=True)``; a default receiver consumes and
    discards trace frames (the field is *optional* on the wire)."""

    wf_trace = None

    def __array_finalize__(self, obj):
        if obj is not None:
            self.wf_trace = getattr(obj, "wf_trace", None)


class ChannelError(ConnectionError):
    """Protocol-level row-channel failure (bad frame, dead peer)."""


class PeerStall(ChannelError):
    """The peer went silent past the receiver's stall timeout — neither
    data nor heartbeat frames arrived (likely hung or partitioned)."""


class PeerAbort(ChannelError):
    """The peer closed with an ABORT frame: it failed mid-stream, so the
    data received so far is a truncated prefix, not a complete stream."""


class WireResume:
    """Knobs of the wire resume protocol (``WireConfig(resume=...)``,
    docs/ROBUSTNESS.md "Wire resume").  ``deadline`` bounds how long a
    broken edge may spend reconnecting before the failure turns fatal
    (the "bounded retry" promise); ``journal_frames`` caps the sender's
    replay journal — past it the oldest *unacked* record is evicted and
    any resume that would need it fails loudly instead of silently
    truncating the stream."""

    __slots__ = ("deadline", "journal_frames")

    def __init__(self, deadline: float = 30.0, journal_frames: int = 4096):
        self.deadline = float(deadline)
        self.journal_frames = int(journal_frames)

    def validate(self) -> "WireResume":
        if self.deadline <= 0:
            raise ValueError("WireResume: deadline must be positive "
                             "seconds (the bounded-retry window)")
        if self.journal_frames < 1:
            raise ValueError("WireResume: journal_frames must retain at "
                             "least 1 record")
        return self


def _as_resume(value):
    """Normalise the ``resume=`` knob: None/False = off, True = default
    :class:`WireResume`, an instance passes through."""
    if value is None or value is False:
        return None
    if value is True:
        return WireResume()
    if isinstance(value, WireResume):
        return value
    raise TypeError(f"resume= must be True/False/None or a WireResume, "
                    f"got {value!r}")


class WireConfig:
    """Bundle of the wire-hardening knobs, for APIs that build several
    channels at once (``multihost.open_row_plane``).  Defaults match the
    un-hardened seed protocol; ``WireConfig.hardened()`` gives the
    recommended production settings (docs/ROBUSTNESS.md).

    ``resume`` (True or a :class:`WireResume`) opts the edge into the
    resume protocol: the sender journals every record and a broken
    connection becomes a bounded reconnect-handshake-replay cycle
    instead of a fatal error.  ``recovery=True`` declares that the
    deployment acks sealed epochs back to the senders
    (``RowReceiver.ack_epoch`` — wired automatically by
    ``batches(epoch_markers=True)`` barriers when set), which is what
    bounds the journal by epoch width; ``resume`` without it is
    statically flagged as WF214.  ``faults`` (a
    ``parallel.faults.FaultPlan``) injects deterministic wire chaos on
    the senders — a test/soak knob, never imported unless set."""

    __slots__ = ("connect_timeout", "connect_deadline", "heartbeat",
                 "stall_timeout", "resume", "recovery", "faults")

    def __init__(self, connect_timeout: float = 30.0,
                 connect_deadline: float = None, heartbeat: float = None,
                 stall_timeout: float = None, resume=None,
                 recovery: bool = False, faults=None):
        self.connect_timeout = connect_timeout
        self.connect_deadline = connect_deadline
        self.heartbeat = heartbeat
        self.stall_timeout = stall_timeout
        self.resume = resume
        self.recovery = bool(recovery)
        self.faults = faults

    @classmethod
    def hardened(cls) -> "WireConfig":
        """Production defaults: 60 s connect deadline (peers boot in any
        order), 2 s heartbeats, 10 s stall timeout (= 5 missed beats)."""
        return cls(connect_deadline=60.0, heartbeat=2.0, stall_timeout=10.0)

    def validate(self) -> "WireConfig":
        """Reject internally inconsistent knob pairings (docs/CHECKS.md
        WF205): a heartbeat interval at or above the stall timeout makes
        every healthy-but-idle link stall out — the receiver gives up
        before the next beat can arrive.  Size ``stall_timeout`` to
        several heartbeat intervals (``hardened()`` uses 2 s / 10 s).
        Called by ``open_row_plane`` AND by the ``RowSender``/
        ``RowReceiver`` constructors; returns self so it chains."""
        if (self.heartbeat is not None and self.stall_timeout is not None
                and self.heartbeat >= self.stall_timeout):
            raise ValueError(
                f"[WF205] WireConfig: heartbeat ({self.heartbeat}s) must "
                f"be < stall_timeout ({self.stall_timeout}s) — the "
                f"receiver would declare PeerStall before a healthy "
                f"peer's next beat arrives")
        rs = _as_resume(self.resume)
        if rs is not None:
            rs.validate()
        if self.faults is not None and not callable(
                getattr(self.faults, "action_for", None)):
            raise TypeError("WireConfig: faults= must provide "
                            "action_for(n) (parallel.faults.FaultPlan)")
        return self


def _encode_dtype(dtype) -> bytes:
    """JSON-encode a dtype via numpy's ``.npy``-format codec
    (``np.lib.format.dtype_to_descr``) — the one descr form numpy
    guarantees round-trippable, covering nested structs, align padding,
    sub-arrays, and unstructured dtypes (plain format strings).  ``None``
    (the EOS-before-data placeholder) encodes as JSON ``null``."""
    if dtype is None:
        return b"null"
    return json.dumps(np.lib.format.dtype_to_descr(np.dtype(dtype))
                      ).encode("utf-8")


def _tuplify_descr(d):
    """JSON turns descr tuples into lists; ``descr_to_dtype`` wants the
    original shapes back, recursively: a descr is a list of field-entry
    *tuples* (possibly nested as a field's format), while sub-array
    shapes and (title, name) pairs are tuples of scalars."""
    if not isinstance(d, list):
        return d
    if d and all(isinstance(e, list) for e in d):
        # a (possibly nested) struct descr: keep the list, tuplify entries
        return [tuple(_tuplify_descr(x) for x in e) for e in d]
    # a sub-array shape or a (title, name) pair
    return tuple(_tuplify_descr(x) for x in d)


def _decode_dtype(raw: bytes):
    """Inverse of :func:`_encode_dtype`."""
    descr = json.loads(raw.decode("utf-8"))
    if descr is None:
        return None
    return np.lib.format.descr_to_dtype(_tuplify_descr(descr))


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("row channel peer closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


#: connect errnos worth retrying: the peer is not up YET (boot order) or
#: the path is transiently unreachable.  Config mistakes — unresolvable
#: hostname (gaierror), permission — fail immediately instead of burning
#: the whole deadline.
_TRANSIENT_CONNECT_ERRNOS = frozenset({
    errno.ECONNREFUSED, errno.ECONNRESET, errno.ECONNABORTED,
    errno.ETIMEDOUT, errno.EHOSTUNREACH, errno.EHOSTDOWN,
    errno.ENETUNREACH, errno.ENETDOWN, errno.EAGAIN, errno.EINTR,
})


class _WireTelemetry:
    """One sender's (or receiver's) view into the observability layer:
    pre-resolved counter handles plus the event log, so the data path
    pays one ``self._tm is not None`` branch when telemetry is off and
    plain counter increments when it is on (docs/OBSERVABILITY.md wire
    counters)."""

    __slots__ = ("events", "bytes_sent", "frames_sent", "bytes_recv",
                 "frames_recv", "connect_retries", "heartbeats_sent",
                 "heartbeats_recv", "heartbeat_misses", "traces_sent",
                 "traces_recv", "resumes", "replayed_frames", "acks_sent",
                 "acks_recv", "journal_depth", "ckpt_shipped_bytes",
                 "ckpt_fetched_bytes", "fed_shipped_bytes",
                 "fed_fetched_bytes")

    def __init__(self, metrics, events=None):
        self.events = events
        c = metrics.counter
        self.bytes_sent = c("wire_bytes_sent")
        self.frames_sent = c("wire_frames_sent")
        self.bytes_recv = c("wire_bytes_recv")
        self.frames_recv = c("wire_frames_recv")
        self.connect_retries = c("wire_connect_retries")
        self.heartbeats_sent = c("wire_heartbeats_sent")
        self.heartbeats_recv = c("wire_heartbeats_recv")
        self.heartbeat_misses = c("wire_heartbeat_misses")
        self.traces_sent = c("wire_traces_sent")
        self.traces_recv = c("wire_traces_recv")
        # resume protocol (docs/ROBUSTNESS.md "Wire resume")
        self.resumes = c("wire_resumes")
        self.replayed_frames = c("wire_replayed_frames")
        self.acks_sent = c("wire_acks_sent")
        self.acks_recv = c("wire_acks_recv")
        self.journal_depth = metrics.gauge("wire_journal_depth")
        # portable checkpoints (docs/ROBUSTNESS.md "Cross-host recovery")
        self.ckpt_shipped_bytes = c("ckpt_shipped_bytes")
        self.ckpt_fetched_bytes = c("ckpt_fetched_bytes")
        # federated telemetry (docs/OBSERVABILITY.md "Federation & SLOs")
        self.fed_shipped_bytes = c("fed_shipped_bytes")
        self.fed_fetched_bytes = c("fed_fetched_bytes")

    def emit(self, event: str, **fields):
        if self.events is not None:
            self.events.emit(event, **fields)


def _telemetry(metrics, events):
    """None when both knobs are off — the single-branch disabled path."""
    if metrics is None and events is None:
        return None
    if metrics is None:
        # events-only caller: counters land in a private throwaway
        # registry so the handles stay non-None (one code path)
        from ..obs.registry import MetricsRegistry
        metrics = MetricsRegistry()
    return _WireTelemetry(metrics, events)


def _connect_with_backoff(host: str, port: int, timeout: float,
                          deadline: float, tm=None) -> socket.socket:
    """Retry a refused/unreachable connect with exponential backoff and
    full jitter until `deadline` seconds have elapsed — the peer's
    receiver may simply not be up yet (hosts boot in any order)."""
    t_end = time.monotonic() + deadline
    attempt = 0
    last_err = None
    while True:
        try:
            # clamp the per-attempt timeout to the remaining deadline so
            # a blackholed host (SYN dropped, no RST) cannot overshoot
            # the promised bound by a whole attempt
            left = max(t_end - time.monotonic(), 0.001)
            return socket.create_connection((host, port),
                                            timeout=min(timeout, left))
        except socket.gaierror:
            raise   # unresolvable name: a config error, not boot order
        except socket.timeout as e:
            last_err = e    # per-attempt timeout: transient by definition
        except OSError as e:
            if e.errno not in _TRANSIENT_CONNECT_ERRNOS:
                raise
            last_err = e
        remaining = t_end - time.monotonic()
        if remaining <= 0:
            raise ConnectionError(
                f"row channel connect to {host}:{port} failed for "
                f"{deadline}s ({attempt + 1} attempts); last error: "
                f"{last_err}") from last_err
        if tm is not None:
            tm.connect_retries.inc()
            tm.emit("reconnect_attempt", host=host, port=port,
                    attempt=attempt + 1,
                    error=type(last_err).__name__)
        # full jitter over an exponentially growing window, capped
        backoff = random.uniform(0, min(2.0, 0.05 * (2 ** attempt)))
        time.sleep(min(backoff, remaining))
        attempt += 1


class RowSender:
    """Client end: ships structured-array batches to a RowReceiver.

    ``connect_deadline`` (seconds) opts into connect retry with backoff;
    ``heartbeat`` (seconds) opts into idle-link liveness frames.  Both
    default to off = the original single-attempt, silent-link protocol.

    ``resume`` (True / :class:`WireResume`) opts into the resume
    protocol (docs/ROBUSTNESS.md "Wire resume"): every data/epoch
    record is journaled with a monotone seq and tagged on the wire; a
    link failure on an established edge becomes a bounded
    reconnect-handshake-replay cycle (reusing the connect backoff
    machinery) instead of a fatal error, and sealed-epoch ACK frames
    from the receiver trim the journal.  ``faults`` (a
    ``parallel.faults.FaultPlan``) injects deterministic chaos into the
    transmit path — a test knob.  ``wire`` (a :class:`WireConfig`)
    supplies any knob not given explicitly and is validated here, so a
    direct-constructed sender can no longer carry an inconsistent
    bundle unchecked.
    """

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 connect_deadline: float = None, heartbeat: float = None,
                 metrics=None, events=None, resume=None, faults=None,
                 wire: WireConfig = None):
        if wire is not None:
            wire.validate()
            timeout = wire.connect_timeout
            if connect_deadline is None:
                connect_deadline = wire.connect_deadline
            if heartbeat is None:
                heartbeat = wire.heartbeat
            if resume is None:
                resume = wire.resume
            if faults is None:
                faults = wire.faults
        #: wire telemetry (obs registry counters + event log); None —
        #: the default — keeps every data-path hook to a single branch
        self._tm = _telemetry(metrics, events)
        self._host, self._port = host, port
        self._timeout = timeout
        self._resume = _as_resume(resume)
        self._faults = faults
        if connect_deadline is None:
            self._sock = socket.create_connection((host, port),
                                                  timeout=timeout)
        else:
            self._sock = _connect_with_backoff(host, port, timeout,
                                               float(connect_deadline),
                                               tm=self._tm)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._dtype_sent = None
        self._send_lock = threading.Lock()
        self._last_send = time.monotonic()
        #: set to the underlying OSError when close() could not deliver
        #: EOS (peer already dead) — the shutdown was NOT clean
        self.failed = None
        self._hb_error = None
        self._hb_stop = None
        self._hb_thread = None
        self._hb_interval = None if heartbeat is None else float(heartbeat)
        if self._resume is not None:
            #: the resume journal: (seq, kind, a, b) where kind "d" is a
            #: data record (a = trace bytes or None, b = payload bytes)
            #: and kind "e" an epoch record (a = epoch int).  Guarded by
            #: _journal_mu — the ACK reader thread trims concurrently.
            self._journal = deque()
            self._journal_mu = threading.Lock()
            self._next_seq = 1
            #: resume is impossible at or below this seq: records there
            #: were trimmed (acked — the receiver vouches for them) or
            #: evicted (journal_frames cap — loud failure if needed)
            self._floor = 0
            self._trimmed_epoch = None
            self._dtype = None
            self._fault_n = 0
            self._link_down = False
            self._closing = False
            self._token = "%016x" % random.getrandbits(64)
            self._ack_thread = None
            s = self._rs_handshake()
            self._rs_replay(s)      # no-op on a fresh journal
            self._start_ack_thread()
        if self._hb_interval is not None:
            self._start_heartbeat()

    # -- liveness ----------------------------------------------------------

    def _start_heartbeat(self):
        self._hb_stop = threading.Event()
        self._hb_thread = threading.Thread(
            target=self._hb_loop, args=(self._hb_interval,),
            daemon=True, name="wf-rowsend-hb")
        self._hb_thread.start()

    def _hb_loop(self, interval: float):
        while not self._hb_stop.wait(interval):
            try:
                # passive death probe: the receiver never sends data, so
                # any EOF/RST here means the peer is gone — surface it
                # now instead of at the next (possibly far-away) send.
                # (A plain recv would honor the socket timeout and block
                # the beat; select(0) keeps the probe non-blocking.)
                # With resume on, the ACK reader thread owns recv — the
                # probe would swallow ACK bytes, so death is its job.
                if self._resume is None:
                    try:
                        readable, _, _ = select.select([self._sock], [],
                                                       [], 0)
                    except ValueError:
                        # fd beyond select's FD_SETSIZE (huge-process
                        # case): skip the probe, the beat itself must
                        # still go out
                        readable = []
                    if readable and self._sock.recv(4096) == b"":
                        raise ConnectionError(
                            "row channel peer closed the connection")
                with self._send_lock:
                    if time.monotonic() - self._last_send >= interval:
                        self._sock.sendall(_LEN.pack(_HEARTBEAT_FRAME))
                        self._last_send = time.monotonic()
                        if self._tm is not None:
                            self._tm.heartbeats_sent.inc()
            except OSError as e:
                self._hb_error = e
                if self._tm is not None:
                    self._tm.heartbeat_misses.inc()
                    self._tm.emit("heartbeat_miss",
                                  error=type(e).__name__, message=str(e))
                return

    def _check_alive(self):
        if self._hb_error is not None:
            raise ChannelError(
                f"row channel peer dead (heartbeat): {self._hb_error}"
            ) from self._hb_error

    def _stop_heartbeat(self):
        if self._hb_stop is not None:
            self._hb_stop.set()
            self._hb_thread.join(timeout=5.0)

    # -- resume protocol (docs/ROBUSTNESS.md "Wire resume") ----------------

    def _rs_handshake(self) -> int:
        """HELLO/WELCOME on a fresh connection; returns the receiver's
        resume point S (journal records with seq > S get replayed).
        Raises :class:`ChannelError` when the journal can no longer
        cover the requested tail — a resume that would silently
        truncate the stream must fail loudly instead."""
        with self._journal_mu:
            lo = self._journal[0][0] if self._journal else self._next_seq
            hi = self._next_seq - 1
        _send_resume_frame(self._sock, _RS_HELLO,
                           {"token": self._token, "lo": lo, "hi": hi})
        n = _LEN.unpack(_read_exact(self._sock, _LEN.size))[0]
        sub = (_LEN.unpack(_read_exact(self._sock, _LEN.size))[0]
               if n == _RESUME_FRAME else None)
        if sub != _RS_WELCOME:
            raise ChannelError(
                f"resume handshake: expected WELCOME, peer sent frame "
                f"{n}/{sub} (is the receiver's resume= on?)")
        w = _read_resume_json(self._sock)
        with self._journal_mu:
            if "seq" in w:
                s = int(w["seq"])
            else:
                s = self._rs_seq_of_epoch(int(w["epoch"]))
            if s < self._floor:
                raise ChannelError(
                    f"[resume] receiver needs records from seq {s + 1}, "
                    f"but this journal no longer holds anything at or "
                    f"below seq {self._floor} (acked-and-trimmed or "
                    f"evicted past journal_frames="
                    f"{self._resume.journal_frames}) — replay would "
                    f"silently truncate the stream, failing loudly "
                    f"instead")
        return s

    def _rs_seq_of_epoch(self, epoch: int) -> int:
        """Map a WELCOME ``{"epoch": E}`` resume point to a seq: replay
        starts after epoch E's marker record.  Caller holds _journal_mu."""
        if epoch <= 0:
            return 0    # a fresh receiver: everything
        for seq, kind, a, _b in self._journal:
            if kind == "e" and a == epoch:
                return seq
        if epoch == self._trimmed_epoch:
            # trimmed/evicted exactly at this marker: the retained tail
            # is exactly the records after it
            return self._floor
        raise ChannelError(
            f"[resume] receiver resumes from epoch {epoch}, which this "
            f"sender's journal cannot locate (sealed acks ran ahead or "
            f"the epoch was never shipped) — cannot replay")

    def _rs_replay(self, s: int) -> int:
        """Re-transmit every journaled record with seq > ``s`` on the
        (fresh) connection; returns the replay count."""
        n = 0
        with self._journal_mu:
            todo = [rec for rec in self._journal if rec[0] > s]
        for rec in todo:
            self._transmit(rec)
            n += 1
        return n

    def _journal_push(self, rec):
        with self._journal_mu:
            self._journal.append(rec)
            if len(self._journal) > self._resume.journal_frames:
                old = self._journal.popleft()
                self._floor = max(self._floor, old[0])
                if old[1] == "e":
                    # evicting through a marker is equivalent to a trim
                    # at it: the retained tail still resumes that epoch
                    self._trimmed_epoch = old[2]
            if self._tm is not None:
                self._tm.journal_depth.set(len(self._journal))

    def _apply_ack(self, w: dict):
        """Trim the journal through a cumulative ACK (the reader
        thread's half of the seal contract)."""
        with self._journal_mu:
            if "epoch" in w:
                e = int(w["epoch"])
                t = None
                for seq, kind, a, _b in self._journal:
                    if kind == "e" and a == e:
                        t = seq
                        break
                if t is None:
                    return   # already trimmed past it: idempotent no-op
            else:
                t = int(w["seq"])
            while self._journal and self._journal[0][0] <= t:
                old = self._journal.popleft()
                if old[1] == "e":
                    self._trimmed_epoch = old[2]
            self._floor = max(self._floor, t)
            if self._tm is not None:
                self._tm.acks_recv.inc()
                self._tm.journal_depth.set(len(self._journal))

    def _start_ack_thread(self):
        t = threading.Thread(target=self._ack_loop, args=(self._sock,),
                             daemon=True, name="wf-rowsend-ack")
        t.start()
        self._ack_thread = t

    def _ack_loop(self, sock):
        """Owns recv on the resume connection: applies ACK frames and
        marks the link down on EOF/reset so the next send resumes
        proactively.  Exits silently when superseded by a reconnect
        (its socket is no longer ``self._sock``) or on close()."""
        try:
            while not self._closing:
                try:
                    r, _, _ = select.select([sock], [], [], 0.25)
                except (OSError, ValueError):
                    return
                if not r:
                    continue
                n = _LEN.unpack(_read_exact(sock, _LEN.size))[0]
                if n != _RESUME_FRAME:
                    raise ChannelError(
                        f"unexpected frame {n} from receiver on resume "
                        f"channel")
                sub = _LEN.unpack(_read_exact(sock, _LEN.size))[0]
                if sub != _RS_ACK:
                    raise ChannelError(
                        f"unexpected resume subtype {sub} from receiver")
                self._apply_ack(_read_resume_json(sock))
        except (OSError, ValueError):
            if not self._closing and sock is self._sock:
                self._link_down = True

    def _transmit(self, rec):
        """Write one journaled record's frames (SEQ tag + payload) on
        the current connection; the single place the fault plan hooks.
        Caller holds _send_lock."""
        seq, kind, a, b = rec
        act = None
        if self._faults is not None:
            self._fault_n += 1
            act = self._faults.action_for(self._fault_n)
        tm = self._tm
        if kind == "e":
            frame = (_LEN.pack(_RESUME_FRAME) + _LEN.pack(_RS_SEQ)
                     + _LEN.pack(seq)
                     + _LEN.pack(_EPOCH_FRAME) + _LEN.pack(a))
        else:
            if self._dtype_sent is None:
                # dtype travels once per CONNECTION (not per stream):
                # resent untagged after every reconnect
                d = _encode_dtype(self._dtype)
                self._sock.sendall(_LEN.pack(len(d)) + d)
                self._dtype_sent = self._dtype
                if tm is not None:
                    tm.frames_sent.inc()
                    tm.bytes_sent.inc(_LEN.size + len(d))
            frame = (_LEN.pack(_RESUME_FRAME) + _LEN.pack(_RS_SEQ)
                     + _LEN.pack(seq))
            if a is not None:
                frame += (_LEN.pack(_TRACE_FRAME) + _LEN.pack(len(a)) + a)
                if tm is not None:
                    tm.traces_sent.inc()
            frame += _LEN.pack(len(b)) + b
        if act == "kill":
            self._sock.close()
            raise ConnectionResetError(f"[fault] killed before record "
                                       f"{self._fault_n}")
        if act == "torn":
            self._sock.sendall(frame[:max(1, len(frame) // 2)])
            self._sock.close()
            raise ConnectionResetError(f"[fault] torn frame at record "
                                       f"{self._fault_n}")
        if act == "stall":
            stall_for = self._faults.stall_for
            time.sleep(stall_for)
            self._sock.close()
            raise ConnectionResetError(f"[fault] stalled {stall_for}s "
                                       f"then dropped at record "
                                       f"{self._fault_n}")
        self._sock.sendall(frame)
        if act == "dup":
            self._sock.sendall(frame)   # duplicated delivery: the
            #                             receiver must dedup by seq
        self._last_send = time.monotonic()
        if tm is not None:
            tm.frames_sent.inc()
            tm.bytes_sent.inc(len(frame) * (2 if act == "dup" else 1))

    def _deliver(self, rec):
        """Transmit one record, entering the bounded resume cycle on any
        link failure.  Caller holds _send_lock."""
        if not self._link_down and self._hb_error is None:
            try:
                self._transmit(rec)
                return
            except ChannelError:
                raise
            except OSError as e:
                err = e
        else:
            err = self._hb_error or ConnectionError(
                "row channel link marked down by the ack reader")
        self._resume_cycle(err)

    def _resume_cycle(self, err):
        """Reconnect + handshake + replay within the resume deadline
        (the journaled record that just failed replays too).  Caller
        holds _send_lock.  Raises :class:`ChannelError` once the
        deadline is spent — the bounded-retry promise."""
        rs = self._resume
        tm = self._tm
        if tm is not None:
            tm.emit("wire_down", role="sender", host=self._host,
                    port=self._port, error=type(err).__name__,
                    message=str(err))
        t_end = time.monotonic() + rs.deadline
        try:
            self._sock.close()
        except OSError:
            pass
        self._hb_error = None
        # the link IS down until the cycle completes: anything polling
        # the flag concurrently (plane supervisor membership, a
        # replicate() skip) must see the truth mid-cycle, or a peer
        # death is masked for the whole reconnect deadline
        self._link_down = True
        last = err
        while True:
            left = t_end - time.monotonic()
            if left <= 0:
                self._link_down = True
                raise ChannelError(
                    f"[resume] could not re-establish the row channel to "
                    f"{self._host}:{self._port} within {rs.deadline}s; "
                    f"last error: {last}") from last
            try:
                self._sock = _connect_with_backoff(
                    self._host, self._port, self._timeout, left, tm=tm)
                self._sock.setsockopt(socket.IPPROTO_TCP,
                                      socket.TCP_NODELAY, 1)
                self._dtype_sent = None
                s = self._rs_handshake()
                n = self._rs_replay(s)
            except ChannelError:
                raise   # protocol-fatal: journal cannot cover the tail
            except OSError as e:
                last = e
                try:
                    self._sock.close()
                except OSError:
                    pass
                continue
            break
        self._link_down = False
        if tm is not None:
            tm.resumes.inc()
            tm.replayed_frames.inc(n)
            tm.emit("wire_resume", role="sender", replayed=n, from_seq=s,
                    host=self._host, port=self._port)
        self._start_ack_thread()
        if (self._hb_interval is not None and self._hb_stop is not None
                and not self._hb_stop.is_set()
                and not self._hb_thread.is_alive()):
            # the beat thread died with the old link: revive it
            self._start_heartbeat()

    def _transmit_eos(self):
        """EOS on the current connection (resume path); preceded by the
        dtype placeholder when this connection never carried one, so
        the receiver's framing stays uniform.  Caller holds _send_lock."""
        if self._dtype_sent is None:
            d = _encode_dtype(self._dtype)
            self._sock.sendall(_LEN.pack(len(d)) + d)
            self._dtype_sent = self._dtype if self._dtype is not None \
                else True
        self._sock.sendall(_LEN.pack(_EOS_FRAME))

    # -- data path ---------------------------------------------------------

    def send(self, batch: np.ndarray, trace: dict = None):
        """Ship one batch.  ``trace`` (optional, a small JSON-able dict
        — typically ``obs.trace.export()``) rides ahead of the data as a
        TRACE control frame, so a span sampled on this host survives the
        row-plane hop (a ``decode_trace=True`` receiver reattaches it,
        any other receiver discards it).  ``trace=None`` — the default —
        keeps the bytes on the wire identical to the original
        protocol."""
        if len(batch) == 0:
            return
        if self._resume is not None:
            # resume path: journal the record, then deliver (any link
            # failure turns into the bounded reconnect/replay cycle)
            if self._dtype is None:
                self._dtype = batch.dtype
            elif batch.dtype != self._dtype:
                raise TypeError(
                    f"row channel dtype changed mid-stream: "
                    f"{self._dtype} -> {batch.dtype}")
            tp = (json.dumps(trace).encode("utf-8")
                  if trace is not None else None)
            payload = np.ascontiguousarray(batch).tobytes()
            with self._send_lock:
                rec = (self._next_seq, "d", tp, payload)
                self._next_seq += 1
                self._journal_push(rec)
                self._deliver(rec)
            return
        self._check_alive()
        with self._send_lock:
            if self._dtype_sent is None:
                d = _encode_dtype(batch.dtype)
                self._sock.sendall(_LEN.pack(len(d)) + d)
                self._dtype_sent = batch.dtype
                if self._tm is not None:
                    self._tm.frames_sent.inc()
                    self._tm.bytes_sent.inc(_LEN.size + len(d))
            elif batch.dtype != self._dtype_sent:
                raise TypeError(
                    f"row channel dtype changed mid-stream: "
                    f"{self._dtype_sent} -> {batch.dtype}")
            if trace is not None:
                tp = json.dumps(trace).encode("utf-8")
                self._sock.sendall(_LEN.pack(_TRACE_FRAME)
                                   + _LEN.pack(len(tp)) + tp)
                if self._tm is not None:
                    self._tm.traces_sent.inc()
                    self._tm.bytes_sent.inc(2 * _LEN.size + len(tp))
            payload = np.ascontiguousarray(batch).tobytes()
            self._sock.sendall(_LEN.pack(len(payload)) + payload)
            self._last_send = time.monotonic()
            if self._tm is not None:
                self._tm.frames_sent.inc()
                self._tm.bytes_sent.inc(_LEN.size + len(payload))

    def send_epoch(self, epoch: int):
        """Ship an epoch barrier control frame (recovery layer,
        docs/ROBUSTNESS.md "Recovery"): "every row of epochs <=
        ``epoch`` has been sent on this channel".  The receiver aligns
        markers across all its senders (``batches(epoch_markers=True)``)
        so multihost rows align on the same epochs as in-process edges.
        Like every hardening knob: never sent unless the application
        calls it, so the bytes on the wire stay seed-identical
        otherwise."""
        if self._resume is not None:
            with self._send_lock:
                rec = (self._next_seq, "e", int(epoch), None)
                self._next_seq += 1
                self._journal_push(rec)
                self._deliver(rec)
            return
        self._check_alive()
        with self._send_lock:
            self._sock.sendall(_LEN.pack(_EPOCH_FRAME)
                               + _LEN.pack(int(epoch)))
            self._last_send = time.monotonic()
            if self._tm is not None:
                self._tm.frames_sent.inc()
                self._tm.bytes_sent.inc(2 * _LEN.size)

    def send_ckpt(self, header: dict, blobs) -> int:
        """Stream one sealed epoch's portable checkpoint (``-7`` family,
        docs/ROBUSTNESS.md "Cross-host recovery"): OFFER header, one
        BLOB frame per ``(meta, raw)`` of ``blobs``, then COMMIT.  The
        receiving side must run a ``ckpt_sink=`` (typically a
        ``recovery.portable.PortableSpool``).

        Checkpoint frames are NOT journaled — shipping is idempotent
        (the spool seals per (origin, epoch), re-ships overwrite
        bit-identically), so on a resumable link a mid-ship failure
        gets one resume cycle (reconnect + data-journal replay) and a
        clean retransmit from the OFFER; past that — or on a plain
        link — the failure raises and the caller retries at its next
        seal.  Like every hardening knob: never sent unless the
        application calls it, so the bytes on the wire stay
        seed-identical otherwise."""
        blobs = list(blobs)
        with self._send_lock:
            if self._resume is not None:
                if self._link_down or self._hb_error is not None:
                    self._resume_cycle(self._hb_error or ConnectionError(
                        "row channel link marked down by the ack reader"))
                try:
                    return self._transmit_ckpt(header, blobs)
                except OSError as e:
                    self._resume_cycle(e)
                    return self._transmit_ckpt(header, blobs)
            self._check_alive()
            return self._transmit_ckpt(header, blobs)

    def _transmit_ckpt(self, header: dict, blobs) -> int:
        """Write the whole ``-7`` sequence on the current connection.
        Caller holds _send_lock."""
        tm = self._tm
        total = 0

        def _part(sub: int, payload: dict, raw: bytes = b""):
            js = json.dumps(payload).encode("utf-8")
            frame = (_LEN.pack(_CKPT_FRAME) + _LEN.pack(sub)
                     + _LEN.pack(len(js)) + js + raw)
            self._sock.sendall(frame)
            return len(frame)

        total += _part(_CK_OFFER, header)
        for meta, raw in blobs:
            total += _part(_CK_BLOB, meta, raw)
        total += _part(_CK_COMMIT, {"origin": header.get("origin"),
                                    "epoch": header["epoch"]})
        self._last_send = time.monotonic()
        if tm is not None:
            tm.frames_sent.inc(2 + len(blobs))
            tm.bytes_sent.inc(total)
            tm.ckpt_shipped_bytes.inc(total)
        return total

    def send_telemetry(self, snap: dict) -> int:
        """Ship one federated-telemetry snapshot (``-8`` family,
        docs/OBSERVABILITY.md "Federation & SLOs").  The receiving side
        must run a ``telemetry_sink=`` (typically an
        ``obs.federation.TelemetryAggregator``).

        Telemetry frames are NOT journaled — shipping is periodic and
        lossy-tolerant (the next snapshot supersedes a lost one), so on
        a resumable link a mid-ship failure gets one resume cycle and a
        clean retransmit; past that — or on a plain link — the failure
        raises and the shipper simply tries again at its next period.
        Like every hardening knob: never sent unless the application
        calls it, so the bytes on the wire stay seed-identical
        otherwise."""
        js = json.dumps(snap).encode("utf-8")
        with self._send_lock:
            if self._resume is not None:
                if self._link_down or self._hb_error is not None:
                    self._resume_cycle(self._hb_error or ConnectionError(
                        "row channel link marked down by the ack reader"))
                try:
                    return self._transmit_telemetry(js)
                except OSError as e:
                    self._resume_cycle(e)
                    return self._transmit_telemetry(js)
            self._check_alive()
            return self._transmit_telemetry(js)

    def _transmit_telemetry(self, js: bytes) -> int:
        """Write one ``-8`` frame on the current connection.  Caller
        holds _send_lock."""
        frame = _LEN.pack(_TELEMETRY_FRAME) + _LEN.pack(len(js)) + js
        self._sock.sendall(frame)
        self._last_send = time.monotonic()
        if self._tm is not None:
            self._tm.frames_sent.inc()
            self._tm.bytes_sent.inc(len(frame))
            self._tm.fed_shipped_bytes.inc(len(frame))
        return len(frame)

    def close(self):
        """Signal EOS (empty frame) and close the socket.  If the EOS
        frame cannot be delivered (peer already dead) the failure is
        SURFACED — ``self.failed`` is set and :class:`ChannelError`
        raised — never reported as a clean shutdown: the peer may have
        consumed a truncated stream.  With ``resume`` on, a dead link
        gets one full resume cycle (reconnect + replay) before the EOS
        is declared undeliverable."""
        self._stop_heartbeat()
        if self._resume is not None:
            err = None
            try:
                with self._send_lock:
                    try:
                        if self._link_down or self._hb_error is not None:
                            # a half-closed link accepts the EOS write
                            # into the void (peer FIN'd, no RST yet):
                            # resume FIRST, like _deliver, or a
                            # restarted peer never hears from us again
                            self._resume_cycle(
                                self._hb_error or ConnectionError(
                                    "row channel link marked down by "
                                    "the ack reader"))
                        self._transmit_eos()
                    except OSError as e:
                        self._resume_cycle(e)   # ChannelError past the
                        #                         deadline propagates
                        self._transmit_eos()
            except OSError as e:
                err = e
            self._closing = True
            self._sock.close()
            if err is not None:
                self.failed = err
                raise ChannelError(
                    f"RowSender.close: EOS frame not delivered — peer "
                    f"dead past the resume deadline (receiver may see a "
                    f"truncated stream): {err}") from err
            return
        err = self._hb_error
        try:
            if err is None:
                with self._send_lock:
                    if self._dtype_sent is None:
                        # dtype never sent: ship a placeholder so the
                        # receiver's framing stays uniform (empty dtype,
                        # then EOS)
                        d = _encode_dtype(None)
                        self._sock.sendall(_LEN.pack(len(d)) + d)
                    self._sock.sendall(_LEN.pack(_EOS_FRAME))
        except OSError as e:
            err = e
        finally:
            self._sock.close()
        if err is not None:
            self.failed = err
            raise ChannelError(
                f"RowSender.close: EOS frame not delivered — peer dead "
                f"before clean shutdown (receiver may see a truncated "
                f"stream): {err}") from err

    def abort(self):
        """Failure-path close: best-effort ABORT frame (length ``-3``) so
        the receiver fails fast with :class:`PeerAbort` instead of
        hanging or mistaking the death for a clean EOS.  Never raises —
        it is called from error paths that must not mask the original
        failure."""
        self._stop_heartbeat()
        if self._resume is not None:
            self._closing = True   # the ack reader exits silently
        if self._tm is not None:
            self._tm.emit("peer_abort", role="sender")
        try:
            with self._send_lock:
                self._sock.sendall(_LEN.pack(_ABORT_FRAME))
        except OSError:
            pass    # peer already gone: its reader fails on EOF instead
        finally:
            self._sock.close()


#: seconds a restarted receiver (``resume_epoch=``) retries binding its
#: old address when no ``accept_timeout`` bounds it
_REBIND_PATIENCE = 30.0


def _bind_server(host: str, port: int, backlog: int, patience: float):
    """``socket.create_server``, retried on EADDRINUSE for up to
    ``patience`` seconds.  A receiver restarted on its old address in the
    same process (a roll in place) can find the old listening socket not
    yet released: ``close()`` frees it only once the old receiver's
    accept thread leaves its poll (up to 0.5 s where ``shutdown()`` does
    not wake it), and until then the port is taken."""
    t_end = time.monotonic() + patience
    while True:
        try:
            return socket.create_server((host, port), backlog=backlog)
        except OSError as e:
            if e.errno != errno.EADDRINUSE or time.monotonic() >= t_end:
                raise
            time.sleep(0.01)


class RowReceiver:
    """Server end: accepts ``n_senders`` connections and yields their
    batches until every sender closes.

    ``stall_timeout`` (seconds) bounds how long a reader may wait on a
    silent socket: a peer that stalls mid-frame or stops heartbeating
    surfaces as :class:`PeerStall` from ``batches()`` instead of hanging
    the pipeline forever.  Size it to several sender heartbeat intervals
    (``WireConfig.hardened()`` uses 5x).  Default off = original
    wait-forever behavior."""

    def __init__(self, n_senders: int, host: str = "127.0.0.1",
                 port: int = 0, capacity: int = 64,
                 stall_timeout: float = None, accept_timeout: float = None,
                 metrics=None, events=None, decode_trace: bool = False,
                 resume=None, resume_epoch: int = None, ack_epochs=None,
                 ckpt_sink=None, telemetry_sink=None,
                 wire: WireConfig = None):
        if wire is not None:
            wire.validate()
            if stall_timeout is None:
                stall_timeout = wire.stall_timeout
            if accept_timeout is None:
                accept_timeout = wire.connect_deadline
            if resume is None:
                resume = wire.resume
            if ack_epochs is None:
                # recovery= declares the sealed-ack loop is wired: the
                # completed barriers of batches() ack automatically
                ack_epochs = wire.recovery
        self._tm = _telemetry(metrics, events)  # see RowSender
        #: opt-in span passthrough: True re-attaches sender trace frames
        #: to their batches as :class:`TracedRows` (``batch.wf_trace``);
        #: False (default) consumes and discards them, so a tracing
        #: sender is always safe to point at a non-tracing receiver
        self.decode_trace = bool(decode_trace)
        #: opt-in portable-checkpoint landing zone (``-7`` family): an
        #: object with offer(header)/blob(meta, raw)/commit(meta) —
        #: typically ``recovery.portable.PortableSpool``.  None (the
        #: default) REFUSES the family loudly: a peer shipping
        #: checkpoints at an unconfigured receiver is a deployment
        #: error, not a silent drop.
        self._ckpt_sink = ckpt_sink
        #: opt-in federated-telemetry landing zone (``-8`` family): an
        #: object with accept(snapshot_dict) — typically
        #: ``obs.federation.TelemetryAggregator``.  Same contract as
        #: ``ckpt_sink``: None (the default) REFUSES the family loudly.
        self._telemetry_sink = telemetry_sink
        self.n_senders = int(n_senders)
        self.stall_timeout = stall_timeout
        #: bound on the ACCEPT phase: how long to wait for all senders to
        #: connect at all.  Size it to the deployment's boot-order budget
        #: (the senders' connect_deadline), NOT to stall_timeout — hosts
        #: legitimately boot much slower than a live link may stall.
        self.accept_timeout = accept_timeout
        self._resume = _as_resume(resume)
        # acks only exist on the resume protocol: the flag is inert
        # (and batches() stays seed-identical) without it
        self._auto_ack = bool(ack_epochs) and self._resume is not None
        self._srv = _bind_server(
            host, port, self.n_senders,
            (accept_timeout or _REBIND_PATIENCE)
            if resume_epoch is not None and port else 0.0)
        self.host, self.port = self._srv.getsockname()[:2]
        self._q = queue.Queue(maxsize=capacity)
        self._conns: list[socket.socket] = []
        if self._resume is not None:
            #: restarted-receiver resume point: offered in WELCOME until
            #: the first record lands on a channel, after which the last
            #: contiguous seq takes over
            self._resume_epoch = (None if resume_epoch is None
                                  else int(resume_epoch))
            self._mu = threading.Lock()
            self._ack_mu = threading.Lock()
            self._tokens: dict[str, int] = {}    # sender token -> idx
            self._last_seq: dict[int, int] = {}  # idx -> last seq seen
            self._gen: dict[int, int] = {}       # idx -> connection gen
            self._conn_of: dict[int, socket.socket] = {}
            self._finished: set[int] = set()
            self._down: dict[int, threading.Timer] = {}
            self._closed = False
            target = self._accept_loop_resume
        else:
            target = self._accept_loop
        self._accept_thread = threading.Thread(target=target,
                                               daemon=True,
                                               name="wf-rowrecv-accept")
        self._accept_thread.start()

    def _accept_loop(self):
        readers = []
        accepted = 0
        failure = None
        accept_end = (time.monotonic() + float(self.accept_timeout)
                      if self.accept_timeout is not None else None)
        try:
            for _ in range(self.n_senders):
                if accept_end is not None:
                    # a TOTAL window over all senders: each accept gets
                    # the remaining budget, not a fresh per-peer clock
                    self._srv.settimeout(
                        max(accept_end - time.monotonic(), 0.001))
                conn, _addr = self._srv.accept()
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                if self.stall_timeout is not None:
                    conn.settimeout(float(self.stall_timeout))
                self._conns.append(conn)
                t = threading.Thread(target=self._read_loop,
                                     args=(conn, accepted),
                                     daemon=True, name="wf-rowrecv")
                t.start()
                readers.append(t)
                accepted += 1
        except socket.timeout:
            failure = PeerStall(
                f"only {accepted}/{self.n_senders} senders connected "
                f"within the {self.accept_timeout}s accept window")
        except OSError:
            # server closed while accepting (receiver torn down / failure
            # path): the senders that never connected must surface as an
            # error, not leave batches() blocked forever
            failure = ChannelError(
                f"row channel receiver closed with only {accepted}/"
                f"{self.n_senders} senders connected")
        finally:
            self._srv.close()
            if failure is not None:
                # one error + one done-marker per missing sender keeps
                # the batches() accounting exact and wakes it NOW
                for _ in range(self.n_senders - accepted):
                    self._q.put((None, failure))
                    self._q.put((None, None))

    # -- resume protocol (docs/ROBUSTNESS.md "Wire resume") ----------------

    def _accept_loop_resume(self):
        """Resume-mode accept: the server socket stays open for the
        receiver's whole life (reconnecting senders and late boots keep
        arriving); each connection handshakes and reads on its own
        thread.  The boot window (``accept_timeout``) still bounds how
        long the FIRST connection of every sender may take."""
        failure = None
        accept_end = (time.monotonic() + float(self.accept_timeout)
                      if self.accept_timeout is not None else None)
        try:
            while True:
                with self._mu:
                    if (self._closed
                            or len(self._finished) >= self.n_senders):
                        return
                    booting = len(self._tokens) < self.n_senders
                if booting and accept_end is not None:
                    left = accept_end - time.monotonic()
                    if left <= 0:
                        raise socket.timeout()
                    self._srv.settimeout(min(left, 0.5))
                else:
                    self._srv.settimeout(0.5)
                try:
                    conn, _addr = self._srv.accept()
                except socket.timeout:
                    continue
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                if self.stall_timeout is not None:
                    conn.settimeout(float(self.stall_timeout))
                self._conns.append(conn)
                threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True, name="wf-rowrecv").start()
        except socket.timeout:
            with self._mu:
                known = len(self._tokens)
            failure = PeerStall(
                f"only {known}/{self.n_senders} senders connected "
                f"within the {self.accept_timeout}s accept window")
        except OSError:
            with self._mu:
                known = len(self._tokens)
            failure = ChannelError(
                f"row channel receiver closed with only {known}/"
                f"{self.n_senders} senders connected")
        finally:
            self._srv.close()
            if failure is not None:
                for _ in range(self.n_senders - known):
                    self._q.put((None, failure))
                    self._q.put((None, None))

    def _serve_conn(self, conn: socket.socket):
        """HELLO -> idx assignment -> WELCOME -> read loop, one thread
        per accepted connection.  A known token re-connecting replaces
        its channel (generation bump) and resumes from the last
        contiguous seq this receiver delivered."""
        tm = self._tm
        try:
            n = _LEN.unpack(_read_exact(conn, _LEN.size))[0]
            sub = (_LEN.unpack(_read_exact(conn, _LEN.size))[0]
                   if n == _RESUME_FRAME else None)
            if sub != _RS_HELLO:
                raise ChannelError(
                    f"resume receiver: expected HELLO, peer sent frame "
                    f"{n}/{sub} (is the sender's resume= on?)")
            token = str(_read_resume_json(conn).get("token"))
            with self._mu:
                if self._closed:
                    conn.close()
                    return
                if token in self._tokens:
                    idx = self._tokens[token]
                    if idx in self._finished:
                        conn.close()   # re-connect after its clean EOS
                        return
                else:
                    if len(self._tokens) >= self.n_senders:
                        conn.close()   # over-subscribed plane
                        return
                    idx = len(self._tokens)
                    self._tokens[token] = idx
                self._gen[idx] = gen = self._gen.get(idx, 0) + 1
                self._conn_of[idx] = conn
                timer = self._down.pop(idx, None)
                last = self._last_seq.get(idx, 0)
            if timer is not None:
                timer.cancel()
            if last == 0 and self._resume_epoch is not None:
                welcome = {"epoch": self._resume_epoch}
            else:
                welcome = {"seq": last}
            _send_resume_frame(conn, _RS_WELCOME, welcome)
        except (OSError, ValueError):
            try:
                conn.close()
            except OSError:
                pass
            return
        if gen > 1 and tm is not None:
            tm.resumes.inc()
            tm.emit("wire_resume", role="receiver", sender=idx,
                    resume_point=welcome)
        self._read_loop_resume(conn, idx, gen)

    def _rs_fresh(self, idx: int, seq) -> bool:
        """Seq dedup, exactly the in-process ``_run_supervised`` rule:
        a record at or below the last seq seen on this channel is a
        replayed duplicate and drops."""
        if seq is None:
            return True   # an untagged peer (no resume): no dedup
        with self._mu:
            if seq <= self._last_seq.get(idx, 0):
                return False
            self._last_seq[idx] = seq
            return True

    def _rs_channel_down(self, idx: int, gen: int, err: Exception):
        """A resumable channel broke: instead of failing batches() now,
        arm the resume deadline — a reconnect cancels it; expiry
        surfaces the original error (the bounded-retry promise)."""
        with self._mu:
            if idx in self._finished or self._gen.get(idx) != gen:
                return   # superseded by a newer connection
            self._conn_of.pop(idx, None)
            if self._closed:
                # receiver torn down: no reconnect is coming — wake a
                # consumer still blocked in batches() with the error
                # now, like the non-resume reader does (puts outside
                # the lock: a full queue must not hold _mu hostage)
                self._finished.add(idx)
                closed = True
            else:
                closed = False
        if closed:
            self._q.put((idx, err))
            self._q.put((idx, None))
            return
        with self._mu:
            if idx in self._finished or self._gen.get(idx) != gen:
                return
            t = threading.Timer(self._resume.deadline, self._rs_expire,
                                args=(idx, gen, err))
            t.daemon = True
            self._down[idx] = t
            t.start()
        if self._tm is not None:
            self._tm.emit("wire_down", role="receiver", sender=idx,
                          error=type(err).__name__, message=str(err))

    def _rs_expire(self, idx: int, gen: int, err: Exception):
        with self._mu:
            if (self._closed or self._down.pop(idx, None) is None
                    or self._gen.get(idx) != gen):
                return
            self._finished.add(idx)
        self._q.put((idx, err))
        self._q.put((idx, None))

    def _next_frame_resume(self, conn: socket.socket, pending):
        """Resume-mode framing: like :meth:`_next_frame` but understands
        the ``-6`` family — returns ``(frame, trace, seq)`` where seq is
        the SEQ tag announced for this record (None for untagged)."""
        tm = self._tm
        trace = None
        while True:
            n = _LEN.unpack(_read_exact(conn, _LEN.size))[0]
            if n >= 0:
                raw = _read_exact(conn, n)
                if tm is not None:
                    tm.frames_recv.inc()
                    tm.bytes_recv.inc(_LEN.size + n)
                return raw, trace, pending
            if n == _EOS_FRAME:
                return None, None, None
            if n == _HEARTBEAT_FRAME:
                if tm is not None:
                    tm.heartbeats_recv.inc()
                continue
            if n == _EPOCH_FRAME:
                epoch = _LEN.unpack(_read_exact(conn, _LEN.size))[0]
                if tm is not None:
                    tm.frames_recv.inc()
                    tm.bytes_recv.inc(2 * _LEN.size)
                from ..recovery.epoch import EpochMarker
                return EpochMarker(epoch), None, pending
            if n == _TRACE_FRAME:
                tn = _LEN.unpack(_read_exact(conn, _LEN.size))[0]
                if not 0 <= tn <= (1 << 20):
                    raise ChannelError(
                        f"bad trace-frame payload length {tn}")
                tp = _read_exact(conn, tn)
                if tm is not None:
                    tm.traces_recv.inc()
                    tm.bytes_recv.inc(2 * _LEN.size + tn)
                if self.decode_trace:
                    trace = json.loads(tp.decode("utf-8"))
                continue
            if n == _RESUME_FRAME:
                sub = _LEN.unpack(_read_exact(conn, _LEN.size))[0]
                if sub != _RS_SEQ:
                    raise ChannelError(
                        f"unexpected resume subtype {sub} mid-stream")
                pending = _LEN.unpack(_read_exact(conn, _LEN.size))[0]
                continue
            if n == _CKPT_FRAME:
                self._ckpt_frame(conn)
                continue
            if n == _TELEMETRY_FRAME:
                self._telemetry_frame(conn)
                continue
            if n == _ABORT_FRAME:
                if tm is not None:
                    tm.emit("peer_abort", role="receiver")
                raise PeerAbort(
                    "row channel sender ABORTED mid-stream (its process "
                    "failed): data received so far is a truncated "
                    "prefix, not a complete stream")
            raise ChannelError(f"bad row-channel frame length {n}")

    def _read_loop_resume(self, conn: socket.socket, idx: int, gen: int):
        from ..recovery.epoch import EpochMarker
        try:
            dtype = None
            got_dtype = False
            pending = None
            while True:
                raw, trace, pending = self._next_frame_resume(conn,
                                                              pending)
                if raw is None:
                    break   # clean EOS
                if type(raw) is EpochMarker:
                    if self._rs_fresh(idx, pending):
                        self._q.put((idx, raw))
                    pending = None
                    continue
                if not got_dtype:
                    # first payload frame of a connection is its dtype
                    # (resent per connection, never SEQ-tagged)
                    dtype = _decode_dtype(raw)
                    got_dtype = True
                    continue
                fresh = self._rs_fresh(idx, pending)
                pending = None
                if not fresh:
                    continue   # duplicate delivery: drop (trace too)
                arr = np.frombuffer(raw, dtype=dtype).copy()
                if trace is not None:
                    arr = arr.view(TracedRows)
                    arr.wf_trace = trace
                self._q.put((idx, arr))
        except PeerAbort as e:
            # a deliberate mid-stream failure is NOT resumable: the
            # sender's process declared itself dead
            conn.close()
            with self._mu:
                self._finished.add(idx)
                self._conn_of.pop(idx, None)
            self._q.put((idx, e))
            self._q.put((idx, None))
            return
        except socket.timeout as e:
            stall = PeerStall(
                f"row channel peer silent for {self.stall_timeout}s "
                f"(no data or heartbeat): stalled mid-stream or "
                f"partitioned")
            stall.__cause__ = e
            if self._tm is not None:
                self._tm.emit("peer_stall",
                              stall_timeout=self.stall_timeout)
            conn.close()
            self._rs_channel_down(idx, gen, stall)
            return
        except Exception as e:  # noqa: BLE001 — any other reader failure
            # (EOF/RST mid-frame, torn frame, undecodable dtype) arms
            # the resume deadline: the sender gets that long to
            # reconnect and replay before the error surfaces
            conn.close()
            self._rs_channel_down(idx, gen, e)
            return
        conn.close()
        with self._mu:
            self._finished.add(idx)
            self._conn_of.pop(idx, None)
        self._q.put((idx, None))   # this sender is done

    def ack_epoch(self, epoch: int):
        """Cumulative sealed-epoch acknowledgement: tell every live
        sender that everything up to and including epoch ``epoch`` is
        durably incorporated on this side, so their journals trim
        through that marker (the journal-bound guarantee).  Call it when
        the epoch is SEALED (checkpoint committed — e.g. from
        ``Dataflow.on_epoch_sealed``); a receiver built with
        ``WireConfig(recovery=True)`` acks automatically as barriers
        complete in :meth:`batches`.  A link that is down simply keeps
        its journal — the next (cumulative) ack trims it."""
        if self._resume is None:
            raise RuntimeError("ack_epoch needs a resume= receiver")
        with self._mu:
            conns = list(self._conn_of.values())
        for conn in conns:
            try:
                with self._ack_mu:
                    _send_resume_frame(conn, _RS_ACK,
                                       {"epoch": int(epoch)})
                if self._tm is not None:
                    self._tm.acks_sent.inc()
            except OSError:
                pass

    def _ckpt_frame(self, conn: socket.socket):
        """Consume one portable-checkpoint frame (``-7`` family,
        docs/ROBUSTNESS.md "Cross-host recovery") and hand it to the
        configured ``ckpt_sink``.  Runs inline on the connection's read
        thread — a sink failure (CRC mismatch, version skew) surfaces
        exactly like a torn frame, through the read loop's error path."""
        sub = _LEN.unpack(_read_exact(conn, _LEN.size))[0]
        if sub not in (_CK_OFFER, _CK_BLOB, _CK_COMMIT):
            raise ChannelError(f"unexpected ckpt subtype {sub}")
        meta = _read_resume_json(conn)
        raw = b""
        if sub == _CK_BLOB:
            nb = int(meta.get("bytes", -1))
            if not 0 <= nb <= (1 << 31):
                raise ChannelError(f"bad ckpt blob length {nb}")
            raw = _read_exact(conn, nb)
        sink = self._ckpt_sink
        if sink is None:
            raise ChannelError(
                "portable-checkpoint frame received but this receiver "
                "has no ckpt_sink= (give it a recovery.portable."
                "PortableSpool, or stop the peer's checkpoint shipping)")
        if self._tm is not None:
            self._tm.frames_recv.inc()
            self._tm.ckpt_fetched_bytes.inc(3 * _LEN.size + len(raw))
        if sub == _CK_OFFER:
            sink.offer(meta)
        elif sub == _CK_BLOB:
            sink.blob(meta, raw)
        else:
            sink.commit(meta)

    def _telemetry_frame(self, conn: socket.socket):
        """Consume one federated-telemetry frame (``-8`` family,
        docs/OBSERVABILITY.md "Federation & SLOs") and hand the decoded
        snapshot to the configured ``telemetry_sink``.  Runs inline on
        the connection's read thread — a sink failure surfaces exactly
        like a torn frame, through the read loop's error path."""
        n = _LEN.unpack(_read_exact(conn, _LEN.size))[0]
        if not 0 <= n <= (1 << 20):
            raise ChannelError(f"bad telemetry-frame payload length {n}")
        raw = _read_exact(conn, n)
        sink = self._telemetry_sink
        if sink is None:
            raise ChannelError(
                "telemetry frame received but this receiver has no "
                "telemetry_sink= (give it an obs.federation."
                "TelemetryAggregator, or stop the peer's federation "
                "shipping)")
        if self._tm is not None:
            self._tm.frames_recv.inc()
            self._tm.fed_fetched_bytes.inc(2 * _LEN.size + len(raw))
        sink.accept(json.loads(raw.decode("utf-8")))

    def _next_frame(self, conn: socket.socket):
        """One payload frame as ``(frame, trace_or_None)`` — ``frame``
        is bytes, an :class:`EpochMarker`, or None on clean EOS.
        Heartbeat frames are consumed silently; a TRACE frame is held
        and attached to the data frame that follows it (or discarded
        when ``decode_trace`` is off); an ABORT frame raises."""
        tm = self._tm
        trace = None
        while True:
            n = _LEN.unpack(_read_exact(conn, _LEN.size))[0]
            if n >= 0:
                raw = _read_exact(conn, n)
                if tm is not None:
                    tm.frames_recv.inc()
                    tm.bytes_recv.inc(_LEN.size + n)
                return raw, trace
            if n == _EOS_FRAME:
                return None, None
            if n == _HEARTBEAT_FRAME:
                if tm is not None:
                    tm.heartbeats_recv.inc()
                continue
            if n == _EPOCH_FRAME:
                epoch = _LEN.unpack(_read_exact(conn, _LEN.size))[0]
                if tm is not None:
                    tm.frames_recv.inc()
                    tm.bytes_recv.inc(2 * _LEN.size)
                from ..recovery.epoch import EpochMarker
                return EpochMarker(epoch), None
            if n == _TRACE_FRAME:
                tn = _LEN.unpack(_read_exact(conn, _LEN.size))[0]
                if not 0 <= tn <= (1 << 20):
                    raise ChannelError(
                        f"bad trace-frame payload length {tn}")
                tp = _read_exact(conn, tn)
                if tm is not None:
                    tm.traces_recv.inc()
                    tm.bytes_recv.inc(2 * _LEN.size + tn)
                if self.decode_trace:
                    # an undecodable trace surfaces like any bad frame
                    # (version-mismatched peer), via _read_loop's
                    # catch-all -> batches() raise
                    trace = json.loads(tp.decode("utf-8"))
                continue
            if n == _CKPT_FRAME:
                self._ckpt_frame(conn)
                continue
            if n == _TELEMETRY_FRAME:
                self._telemetry_frame(conn)
                continue
            if n == _ABORT_FRAME:
                if tm is not None:
                    tm.emit("peer_abort", role="receiver")
                raise PeerAbort(
                    "row channel sender ABORTED mid-stream (its process "
                    "failed): data received so far is a truncated prefix, "
                    "not a complete stream")
            raise ChannelError(f"bad row-channel frame length {n}")

    def _read_loop(self, conn: socket.socket, idx: int):
        from ..recovery.epoch import EpochMarker
        try:
            dtype = None
            got_dtype = False
            while True:
                raw, trace = self._next_frame(conn)
                if raw is None:
                    break
                if type(raw) is EpochMarker:
                    self._q.put((idx, raw))
                    continue
                if not got_dtype:
                    # first payload frame of a connection is its dtype
                    dtype = _decode_dtype(raw)
                    got_dtype = True
                    continue
                arr = np.frombuffer(raw, dtype=dtype).copy()
                if trace is not None:
                    arr = arr.view(TracedRows)
                    arr.wf_trace = trace
                self._q.put((idx, arr))
        except socket.timeout as e:
            stall = PeerStall(
                f"row channel peer silent for {self.stall_timeout}s "
                f"(no data or heartbeat): stalled mid-stream or "
                f"partitioned")
            stall.__cause__ = e
            if self._tm is not None:
                self._tm.emit("peer_stall",
                              stall_timeout=self.stall_timeout)
            self._q.put((idx, stall))
        except Exception as e:  # noqa: BLE001 — ANY reader failure (IO,
            # undecodable dtype from a version-mismatched peer, bad frame)
            # must surface in batches(); the finally's None alone would
            # count this sender as a clean EOS and silently truncate the
            # stream — the exact failure the docstring promises to prevent
            self._q.put((idx, e))
        finally:
            conn.close()
            self._q.put((idx, None))   # this sender is done

    def batches(self, epoch_markers: bool = False):
        """Yield batches until every sender has sent EOS; raises if any
        connection died mid-stream (fail fast — a silently truncated
        stream would produce silently wrong window totals).  When the
        feeding source node of a Dataflow iterates this, a raised peer
        failure lands in ``Dataflow._errors`` and ``wait()`` re-raises
        it — remote death is a graph error, not a hang.

        ``epoch_markers=True`` opts into wire epoch alignment
        (docs/ROBUSTNESS.md "Recovery"): when every still-active sender
        has shipped its epoch-``e`` frame (``RowSender.send_epoch``), one
        :class:`~windflow_tpu_torch.recovery.epoch.EpochMarker` is yielded —
        after every row of epochs <= ``e`` from every sender, and before
        any row of later epochs (rows from senders that run ahead are
        held back until the barrier completes).  A recovery-enabled
        source that re-emits the marker hands the engine an epoch
        boundary consistent across hosts.  Alignment is tracked either
        way; with the default ``False`` the markers are consumed
        silently, preserving the original yield sequence."""
        done_idx: set = set()
        done = 0
        my_epoch = 0
        level: dict = {}   # sender idx -> highest epoch frame seen
        held: dict = {}    # sender idx -> [(level_at_dequeue, batch)]
        from ..recovery.epoch import EpochMarker

        def _min_level():
            lv = [level.get(i, 0) for i in range(self.n_senders)
                  if i not in done_idx]
            return min(lv) if lv else None

        while done < self.n_senders:
            idx, item = self._q.get()
            advanced = False
            if item is None:
                done += 1
                if idx is not None:
                    done_idx.add(idx)
                advanced = True     # a finished sender leaves the min
            elif isinstance(item, Exception):
                raise item
            elif type(item) is EpochMarker:
                if item.epoch > level.get(idx, 0):
                    level[idx] = item.epoch
                    advanced = True
            elif epoch_markers and level.get(idx, 0) > my_epoch:
                # sender is past the open epoch: hold its rows until the
                # stragglers align (content epoch = level + 1 at dequeue).
                # Without the opt-in, frames are consumed silently and
                # rows yield immediately — the original sequence, no
                # unbounded buffering behind a slow straggler.
                held.setdefault(idx, []).append((level[idx], item))
            else:
                yield item
            if not advanced:
                continue
            m = _min_level()
            if m is None or m <= my_epoch:
                continue
            # barrier(s) complete through epoch m.  A row held at level
            # L is content of epoch L+1: when the min jumps several
            # epochs at once (a sender skipping epochs after a coarse
            # restart), rows with L < m are content the marker claims
            # to cover and must precede it; rows at exactly L == m open
            # the next epoch and follow it.
            my_epoch = m
            if self._auto_ack:
                # WireConfig(recovery=True): a completed barrier is this
                # plane's seal point — ack it so sender journals trim
                self.ack_epoch(m)
            for i in sorted(held):
                keep = []
                for lvl, row in held[i]:
                    if lvl < m:
                        yield row
                    else:
                        keep.append((lvl, row))
                held[i] = keep
            if epoch_markers:
                yield EpochMarker(m)
            for i in sorted(held):
                keep = []
                for lvl, row in held[i]:
                    if lvl <= m:
                        yield row
                    else:
                        keep.append((lvl, row))
                held[i] = keep
        # stragglers: every sender closed, release anything still held
        for i in sorted(held):
            for _lvl, row in held[i]:
                yield row

    def close(self):
        """Tear the receiver down (failure path / tests): close the
        listening socket and every accepted connection.  Live senders
        see a reset on their next send, and a consumer blocked in
        batches() during the accept phase is woken with a classified
        error — fail fast, not hang."""
        if self._resume is not None:
            with self._mu:
                self._closed = True
                timers = list(self._down.values())
                self._down.clear()
            for t in timers:
                t.cancel()
        try:
            # closing an fd does NOT wake a thread blocked in accept();
            # shutdown() does (Linux: accept returns EINVAL)
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._srv.close()
        for conn in self._conns:
            try:
                # as with accept() above: close() alone neither wakes a
                # reader thread blocked in recv() nor reliably FINs the
                # peer while one is — shutdown() does both, so a
                # resumable sender's ack reader sees the EOF and marks
                # the link down promptly
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass


def partition_and_ship(batch: np.ndarray, owners: np.ndarray, my_pid: int,
                       senders: dict, trace: dict = None) -> np.ndarray:
    """Split one batch by owning process (``owners`` from
    ``multihost.process_for_keys``): rows owned here are returned for
    local processing; every other process's rows go out through its
    ``senders[pid]`` RowSender.  The one-call form of the multi-host
    source contract for non-key-partitioned inputs.  ``trace``
    (typically ``obs.trace.export()``) rides with every shipped part so
    a sampled batch's span survives the hop.

    With resumable senders (``open_row_plane(resume=...)``) each
    shipped part is journaled under a seq before it hits the wire, so a
    peer restart mid-call replays the missing parts transparently —
    callers need no try/except around the ship loop; a failure raised
    here means the resume deadline itself was exhausted."""
    mine = batch[owners == my_pid]
    covered = np.isin(owners, [my_pid, *senders])
    if not covered.all():
        # fail fast: a pid with rows but no sender would silently truncate
        # the stream (and so silently corrupt window totals downstream)
        missing = sorted(set(np.asarray(owners)[~covered].tolist()))
        raise KeyError(f"rows owned by process(es) {missing} but no "
                       "RowSender registered for them")
    for pid, snd in senders.items():
        if pid == my_pid:
            continue
        part = batch[owners == pid]
        if len(part):
            snd.send(part, trace=trace)
    return mine
