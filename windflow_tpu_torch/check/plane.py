"""Plane-topology linter (WF22x): cross-process validation of a
declared multi-host row plane.

The per-process checks (WF205/206/214/216, check/config.py) each see ONE
side of a wire: a ``WireConfig`` carries both the sender knobs
(``heartbeat``, ``resume``) and the receiver knobs (``stall_timeout``,
``recovery``) because in a single process they ride the same bundle.
Across processes they do not — host A's sender faces host B's receiver,
and a topology where A heartbeats into a B that never arms
``stall_timeout`` is invisible to both hosts' local lint runs.  This
module lints the *declared deployment*: a :class:`PlaneSpec` naming
every process's address, wire, dtype and role, mirroring the kwargs each
process passes to :func:`~windflow_tpu_torch.parallel.multihost.open_row_plane`.

A spec is plain declarative data — building one imports nothing from the
runtime (the ``check=``-unset contract: this package stays un-imported
unless lint runs), and ``scripts/wf_lint.py --plane my_spec.py`` drives
it from CI.  A spec module advertises its topology with a
``wf_plane_spec()`` callable returning one or more :class:`PlaneSpec`
objects, or with module-level instances.

The WF22x family (docs/CHECKS.md):

* **WF220** (error) — the topology itself is broken: a host ships to a
  pid with no spec/address, two hosts claim one ``(host, port)``, the
  address book and the host list disagree on the pid set.
* **WF221** (error) — dtype mismatch across an edge: the sender's row
  dtype is not what the receiver expects.
* **WF222** (error) — ``resume=`` on one end of an edge only: the
  resume handshake needs the sender journal AND the receiver epoch
  tracking; one-sided resume breaks reconnect.
* **WF223** (warning) — a PlaneSupervisor policy is declared but no
  host offers a ``ckpt_sink``/portable-spool replica target: a takeover
  has no portable checkpoint to restore from.
* **WF224** (error) — federation shipping misrouted: shippers with no
  aggregator, or two hosts claiming the aggregator role.

Plus the cross-host versions of the per-process pairings, reusing the
existing catalog ids: WF205 (sender heartbeat >= receiver stall
timeout), WF206 (heartbeat into a receiver with no stall timeout),
WF214 (sender journals but the receiver never acks sealed epochs),
WF216 (a supervised plane whose effective wire does not journal).
"""

from __future__ import annotations

import sys

from .diagnostics import Diagnostic


def _caller_anchor(depth: int = 2):
    """(filename, lineno) of the construction site, so WF22x
    diagnostics anchor at the spec line and ``# wf-lint: disable=``
    works on it."""
    try:
        frame = sys._getframe(depth)
    except ValueError:
        return None
    return (frame.f_code.co_filename, frame.f_lineno)


class HostSpec:
    """One process of the plane, mirroring its ``open_row_plane``
    call: ``pid`` and (via the owning :class:`PlaneSpec`) its address;
    ``wire`` the process's :class:`~windflow_tpu_torch.parallel.channel.
    WireConfig` (None = the spec-level default); ``sends`` the row
    dtype this host ships and ``expects`` the dtype it decodes inbound
    (default: its own ``sends``); ``sends_to`` the pids it ships rows
    to (default: every other pid); ``resume``/``resume_epoch`` the
    journal/handshake opt-in; ``ckpt_sink`` truthy when the host
    replicates portable checkpoints (a PortableSpool target);
    ``plane`` the host's PlanePolicy (supervision/rolling restart),
    ``federate`` truthy when it ships telemetry snapshots and
    ``aggregator`` True when it runs the plane's TelemetryAggregator.
    """

    __slots__ = ("pid", "wire", "sends", "expects", "sends_to",
                 "resume", "resume_epoch", "ckpt_sink", "plane",
                 "federate", "aggregator", "anchor")

    def __init__(self, pid: int, wire=None, sends=None, expects=None,
                 sends_to=None, resume=None, resume_epoch=None,
                 ckpt_sink=None, plane=None, federate=None,
                 aggregator: bool = False):
        self.pid = int(pid)
        self.wire = wire
        self.sends = sends
        self.expects = expects if expects is not None else sends
        self.sends_to = (None if sends_to is None
                         else tuple(int(p) for p in sends_to))
        self.resume = resume
        self.resume_epoch = resume_epoch
        self.ckpt_sink = ckpt_sink
        self.plane = plane
        self.federate = federate
        self.aggregator = bool(aggregator)
        self.anchor = _caller_anchor()

    def __repr__(self):
        return f"<HostSpec pid={self.pid}>"


class PlaneSpec:
    """A declared multi-host deployment: the shared ``addresses`` book
    (pid -> ``(host, port)``, the same dict every process passes to
    ``open_row_plane``) plus one :class:`HostSpec` per process.
    ``wire`` is the plane-wide default WireConfig for hosts that do not
    set their own (``open_row_plane`` defaults to
    ``WireConfig.hardened()`` — mirror that in the spec if that is what
    the deployment runs)."""

    __slots__ = ("name", "addresses", "hosts", "wire", "anchor")

    def __init__(self, addresses: dict, hosts, name: str = "plane",
                 wire=None):
        self.name = str(name)
        self.addresses = {int(p): tuple(a) for p, a in addresses.items()}
        self.hosts = list(hosts)
        self.wire = wire
        self.anchor = _caller_anchor()


def _wire_of(spec: PlaneSpec, host: HostSpec):
    return host.wire if host.wire is not None else spec.wire


def check_plane_spec(spec: PlaneSpec) -> list[Diagnostic]:
    """Every WF22x + cross-host WF205/206/214/216 finding of one
    declared plane."""
    diags: list[Diagnostic] = []
    name = spec.name

    def d(code, msg, anchor=None, node=None):
        diags.append(Diagnostic(code, msg, node=node or name,
                                anchor=anchor or spec.anchor))

    by_pid: dict[int, HostSpec] = {}
    for host in spec.hosts:
        if host.pid in by_pid:
            d("WF220",
              f"plane {name!r}: two HostSpecs claim pid {host.pid} — "
              f"the spec is ambiguous about which process runs there",
              anchor=host.anchor)
            continue
        by_pid[host.pid] = host

    # address book vs host list: the SAME dict must be handed to every
    # process, so a pid on one side only is a deployment that cannot
    # boot (open_row_plane KeyErrors) or a silent never-wired host
    addr_pids = set(spec.addresses)
    host_pids = set(by_pid)
    for pid in sorted(host_pids - addr_pids):
        d("WF220",
          f"plane {name!r}: host pid {pid} has no entry in addresses= "
          f"— its receiver has nowhere to bind and every peer's "
          f"open_row_plane({pid}) raises at boot",
          anchor=by_pid[pid].anchor)
    for pid in sorted(addr_pids - host_pids):
        d("WF220",
          f"plane {name!r}: addresses= lists pid {pid} but no HostSpec "
          f"describes it — peers will connect-retry against an address "
          f"nothing ever binds")

    # two hosts on one (host, port): the second bind fails at boot
    seen_addr: dict[tuple, int] = {}
    for pid in sorted(addr_pids):
        addr = spec.addresses[pid]
        if addr in seen_addr:
            d("WF220",
              f"plane {name!r}: pids {seen_addr[addr]} and {pid} both "
              f"claim address {addr!r} — the second receiver's bind "
              f"fails at boot")
        else:
            seen_addr[addr] = pid

    # ---- per-edge checks -------------------------------------------
    for pid in sorted(host_pids):
        src = by_pid[pid]
        dests = (src.sends_to if src.sends_to is not None
                 else tuple(p for p in sorted(host_pids) if p != pid))
        for dpid in dests:
            if dpid not in by_pid:
                d("WF220",
                  f"plane {name!r}: host {pid} ships rows to pid "
                  f"{dpid}, which no HostSpec/address describes",
                  anchor=src.anchor)
                continue
            dst = by_pid[dpid]
            edge = f"edge {pid}->{dpid}"

            # dtype pairing: the receiver decodes with ITS dtype — a
            # disagreement is garbage rows (same itemsize) or a decoder
            # reject (different itemsize), never a usable stream
            if (src.sends is not None and dst.expects is not None
                    and src.sends != dst.expects):
                d("WF221",
                  f"plane {name!r} {edge}: sender ships dtype "
                  f"{src.sends!r} but the receiver decodes "
                  f"{dst.expects!r} — every batch is misdecoded",
                  anchor=src.anchor)

            # resume on both ends or neither: the reconnect handshake
            # pairs the sender journal with receiver epoch tracking
            if bool(src.resume) != bool(dst.resume):
                one, other = ((pid, dpid) if src.resume
                              else (dpid, pid))
                d("WF222",
                  f"plane {name!r} {edge}: resume= is set on host "
                  f"{one} but not host {other} — the resume handshake "
                  f"needs the sender journal AND the receiver's sealed-"
                  f"epoch tracking, so a reconnect on this edge fails "
                  f"(set resume on both, or neither)",
                  anchor=src.anchor)

            swire, dwire = _wire_of(spec, src), _wire_of(spec, dst)
            hb = getattr(swire, "heartbeat", None)
            stall = getattr(dwire, "stall_timeout", None)
            if hb is not None and stall is not None and hb >= stall:
                d("WF205",
                  f"plane {name!r} {edge}: sender heartbeat ({hb}s) >= "
                  f"receiver stall_timeout ({stall}s) — host {dpid} "
                  f"declares PeerStall before host {pid}'s next beat "
                  f"can arrive",
                  anchor=src.anchor)
            elif hb is not None and stall is None:
                d("WF206",
                  f"plane {name!r} {edge}: host {pid} heartbeats but "
                  f"host {dpid} has no stall_timeout — the beats buy "
                  f"nothing and a dead peer still hangs the read "
                  f"forever",
                  anchor=src.anchor)

            if src.resume and not getattr(dwire, "recovery", False):
                d("WF214",
                  f"plane {name!r} {edge}: host {pid} journals "
                  f"(resume=) but host {dpid}'s wire has no recovery= "
                  f"— no sealed-epoch acks ever flow back and the "
                  f"sender journal fills to its cap, then evicts",
                  anchor=src.anchor)

    # ---- plane-wide roles ------------------------------------------
    supervised = [h for h in spec.hosts if h.plane is not None]
    for host in supervised:
        pwire = getattr(host.plane, "wire", None) or _wire_of(spec, host)
        if not (getattr(pwire, "resume", None) or host.resume):
            d("WF216",
              f"plane {name!r}: host {host.pid} declares a PlanePolicy "
              f"but neither its plane wire nor the host journals "
              f"(resume=) — every handoff silently drops the frames in "
              f"flight at the death",
              anchor=host.anchor)
    if supervised and not any(h.ckpt_sink for h in spec.hosts):
        d("WF223",
          f"plane {name!r}: a PlanePolicy supervises the plane but no "
          f"host offers a ckpt_sink (portable-spool replica target) — "
          f"a cross-host takeover has no portable checkpoint to "
          f"restore from and silently degrades to an empty restart "
          f"(docs/ROBUSTNESS.md \"Cross-host recovery\")",
          anchor=supervised[0].anchor)

    shippers = [h for h in spec.hosts if h.federate]
    aggregators = [h for h in spec.hosts if h.aggregator]
    if shippers and not aggregators:
        d("WF224",
          f"plane {name!r}: hosts "
          f"{[h.pid for h in shippers]} federate telemetry but no "
          f"host runs the aggregator — every snapshot is shipped into "
          f"the void (mark one HostSpec aggregator=True; "
          f"docs/OBSERVABILITY.md \"Federation & SLOs\")",
          anchor=shippers[0].anchor)
    elif len(aggregators) > 1:
        d("WF224",
          f"plane {name!r}: hosts {[h.pid for h in aggregators]} all "
          f"claim the aggregator role — the federated view is split "
          f"across disagreeing aggregators (keep exactly one)",
          anchor=aggregators[1].anchor)
    return diags
