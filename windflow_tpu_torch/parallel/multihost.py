"""Multi-process execution: process-spanning meshes with the kf axis split
along the process boundary — the port of
``windflow_tpu/parallel/multihost.py``.

The streaming mesh axes (kf × wf × sp, parallel/mesh.py) extend across
processes with the layout chosen so that

* ``kf`` (key groups — Key_Farm parallelism) is split OVER PROCESSES
  first: key groups exchange nothing, so the links between hosts carry no
  collective traffic at all;
* ``sp`` (within-window partition — the merged axis) stays INSIDE one
  process's devices, so its partials never leave a host.

Deployment model: one engine process per host (or several processes
sharing one card).  Host-side dataflow (sources, emitters, host operators)
runs per process over its own keys — ``process_for_keys`` gives the owner
of each key, and a source that generates (or receives) only its own key
range needs no cross-process hop at all; one that does not ships the rows
it does not own over the row plane (``open_row_plane``,
``channel.partition_and_ship``).

Where the JAX package has ``jax.distributed``, a coordination service,
the port has a ``torch.distributed`` process group (gloo by default) that
serves only to exchange each process's device list
(``all_gather_object``): the kf axis exchanges nothing between processes,
so no data collective runs over it.  A ``torch.device`` has no
``process_index``, and two processes on one card both hold ``cuda:0``, so
the multi-process mesh records the owner of every entry
(``DeviceMesh.processes``) and the default ``process_of`` reads that record.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import KF_AXIS, SP_AXIS, WF_AXIS, DeviceMesh


def _group():
    """``torch.distributed`` when a process group is up, else None."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist
    return None


def _rank() -> int:
    """This process's rank in the group, 0 without a group."""
    dist = _group()
    return dist.get_rank() if dist is not None else 0


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, backend: str = "gloo", **kw):
    """``torch.distributed.init_process_group`` for the device-list
    exchange.  A zero-arg call DELEGATES to ``env://`` (torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``), as JAX's
    delegates to its cluster detection — swallowing it would silently build
    single-process meshes with wrong kf ownership.  The only no-op is the
    EXPLICIT single-process job, ``num_processes=1`` with no coordinator:
    there is nothing to coordinate.  ``coordinator_address`` is
    ``"host:port"`` (the group's TCP rendezvous); ``backend`` is the
    group's backend, gloo by default: the group carries only the device
    lists, and NCCL refuses two ranks on one card."""
    if (num_processes == 1 and coordinator_address is None
            and process_id in (None, 0) and not kw):
        return
    import torch.distributed as dist
    init = (f"tcp://{coordinator_address}" if coordinator_address is not None
            else "env://")
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    dist.init_process_group(backend=backend, init_method=init, **kw)


def _local_devices():
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError(
            "no CUDA device: a multi-process mesh runs on the cards; pass "
            "devices=['cpu'] * n explicitly to run it on the host")
    return [torch.device(f"cuda:{i}")
            for i in range(torch.cuda.device_count())]


def _entries(devices, process_of):
    """``(process, device)`` for every entry of the job's device list.

    * ``process_of`` given: ``devices`` is the job's whole list and
      ``process_of`` names each entry's owner, either as a callable of the
      device (the JAX package's contract) or as a sequence of process ids
      by position (a list may repeat a device, so position is the only
      identity it has).
    * otherwise, with a process group up: ``devices`` (default: every
      visible CUDA device) are THIS process's devices, and the group
      exchanges every process's list.
    * otherwise the whole list belongs to this one process."""
    devices = [torch.device(d) for d in
               (devices if devices is not None else _local_devices())]
    if process_of is not None:
        if callable(process_of):
            pids = [int(process_of(d)) for d in devices]
        else:
            pids = [int(p) for p in process_of]
            if len(pids) != len(devices):
                raise ValueError(
                    f"process_of names {len(pids)} owners for "
                    f"{len(devices)} devices")
        return list(zip(pids, devices))
    dist = _group()
    if dist is None:
        return [(0, d) for d in devices]
    lists = [None] * dist.get_world_size()
    dist.all_gather_object(lists, [str(d) for d in devices])
    return [(p, torch.device(d)) for p, ds in enumerate(lists) for d in ds]


def make_multihost_mesh(n_kf=None, n_sp: int = 1, n_wf: int = 1,
                        devices=None, process_of=None) -> DeviceMesh:
    """A (kf, wf, sp) mesh over every process's devices with ``kf``
    outermost ALONG THE PROCESS BOUNDARY: the first ``n_processes``
    divisions of the kf axis are whole processes, so no kf index spans two
    processes and every sp/wf neighbour lives in the same process.

    ``devices`` and ``process_of`` as in :func:`_entries`.  ``n_kf``
    defaults to all remaining parallelism (n_devices // (n_sp * n_wf));
    passing it explicitly is validation only — it must equal exactly
    ``n_processes * per_process_share``.  Constraint: ``n_sp * n_wf`` must
    divide each process's device count.  The mesh records each entry's
    process (``mesh.processes``)."""
    groups = {}
    for pid, d in _entries(devices, process_of):
        groups.setdefault(pid, []).append(d)
    pids = sorted(groups)
    per_proc = [groups[p] for p in pids]
    n_local = len(per_proc[0])
    if any(len(g) != n_local for g in per_proc):
        raise ValueError(
            f"hosts disagree on device count: {[len(g) for g in per_proc]}")
    inner = n_sp * n_wf
    if n_local % inner:
        raise ValueError(
            f"sp*wf = {inner} must divide the per-host device count "
            f"{n_local} (sp partials must stay on one host)")
    kf_per_proc = n_local // inner
    total_kf = kf_per_proc * len(per_proc)
    if n_kf is None:
        n_kf = total_kf
    if n_kf != total_kf:
        raise ValueError(
            f"n_kf={n_kf} but the ({len(per_proc)} hosts x {n_local} "
            f"devices) / (sp*wf={inner}) layout gives kf={total_kf}")
    # grid[kf, wf, sp]: process-major kf, then each process's devices
    # reshaped into its local (kf_per_proc, wf, sp) block
    blocks, owners = [], []
    for p, g in zip(pids, per_proc):
        block = np.empty(n_local, dtype=object)
        block[:] = g
        blocks.append(block.reshape(kf_per_proc, n_wf, n_sp))
        owners.append(np.full((kf_per_proc, n_wf, n_sp), p, dtype=np.int64))
    return DeviceMesh(np.concatenate(blocks, axis=0),
                      processes=np.concatenate(owners, axis=0))


def _kf_owners(mesh: DeviceMesh, process_of) -> np.ndarray:
    """The owning process of each kf row: ``process_of`` of its first
    device where given, else the mesh's record (this process for a mesh
    that has none)."""
    n_kf = int(mesh.shape[KF_AXIS])
    if process_of is not None:
        return np.asarray([int(process_of(mesh.devices[g, 0, 0]))
                           for g in range(n_kf)], dtype=np.int64)
    if mesh.processes is not None:
        return np.asarray(mesh.processes[:, 0, 0], dtype=np.int64)
    return np.full(n_kf, _rank(), dtype=np.int64)


def process_for_keys(keys: np.ndarray, mesh: DeviceMesh, process_of=None,
                     routing=None) -> np.ndarray:
    """Owning process id per key: key -> kf group -> the process whose
    devices hold that kf row.  A multi-process source keeps only
    ``process_for_keys(k, mesh) == my_pid`` and never ships those rows.
    ``routing(keys, n_kf) -> groups`` must be the SAME function the
    deployment's emitters use (default: key % n, default_routing) — a
    mismatch would place rows on processes that don't own their kf
    group."""
    n_kf = int(mesh.shape[KF_AXIS])
    if routing is None:
        from ..runtime.emitters import default_routing as routing
    kf_owner = _kf_owners(mesh, process_of)
    return kf_owner[np.asarray(
        routing(np.asarray(keys, dtype=np.int64), n_kf), dtype=np.int64)]


def open_row_plane(my_pid: int, addresses: dict, capacity: int = 64,
                   wire=None, metrics=None, events=None,
                   decode_trace: bool = False, resume=None,
                   resume_epoch: int = None, ckpt_sink=None,
                   telemetry_sink=None):
    """Build the full cross-host row data plane for a process: one
    :class:`~windflow_tpu_torch.parallel.channel.RowReceiver` listening at
    ``addresses[my_pid]`` and one hardened
    :class:`~windflow_tpu_torch.parallel.channel.RowSender` per remote process,
    returned as ``(receiver, {pid: sender})`` — the handles
    ``partition_and_ship`` wants.

    ``addresses`` maps process id -> ``(host, port)`` for every process
    in the job (the deployment's static wiring, typically derived from
    the coordinator address + a port base).  ``wire`` is a
    :class:`~windflow_tpu_torch.parallel.channel.WireConfig`; the default is
    ``WireConfig.hardened()`` — unlike the raw channel classes (whose
    bare defaults stay seed-identical), a *plane* built through this
    helper gets retries, heartbeats and stall timeouts out of the box,
    because hosts boot in arbitrary order and a production job must
    degrade loudly, not hang, when a peer dies (docs/ROBUSTNESS.md).
    Connect order is safe in any boot order: the receiver is bound
    before any outbound connect, and connects retry with backoff until
    the wire deadline.

    ``metrics`` (an ``obs.MetricsRegistry``) and ``events`` (an
    ``obs.EventLog``) opt the whole plane into wire telemetry: every
    channel of this process shares the one registry, so
    ``wire_bytes_sent`` / ``wire_connect_retries`` / heartbeat counters
    aggregate across peers, and reconnect/stall/abort events carry per
    -peer detail (docs/OBSERVABILITY.md).  Pass the owning Dataflow's
    ``.metrics`` / ``.events`` to fold the wire into its sampler
    output; both None (default) = no telemetry, seed-identical wire.

    ``decode_trace=True`` re-attaches inbound span-trace frames
    (``send(..., trace=obs.trace.export())`` on the peer) to their
    batches as ``TracedRows`` so a traced source on this host adopts
    them and the multihost graph stitches one trace
    (docs/OBSERVABILITY.md §tracing); the default discards them.

    ``resume`` (``True`` or a tuned
    :class:`~windflow_tpu_torch.parallel.channel.WireResume`; default taken
    from ``wire.resume``) makes every edge of this plane *resumable*
    (docs/ROBUSTNESS.md "Wire resume"): senders journal outbound frames
    and replay the unacked tail over a fresh connection when a peer
    restarts, receivers dedup by seq — so peer death inside the resume
    deadline becomes a bounded retry instead of a graph error.  A
    RESTARTED process reopening its half of the plane passes
    ``resume_epoch=K`` (its last sealed checkpoint epoch): its receiver
    then asks each reconnecting sender to replay from the epoch-``K``
    barrier rather than from a seq it no longer remembers, which is
    exactly the wire tail the restored dataflow needs.  Unset (and
    unset on ``wire``) ⇒ the plane behaves byte-identically to before
    (no journal, no handshake).

    ``ckpt_sink`` (typically a ``recovery.portable.PortableSpool``)
    opts this process into RECEIVING peers' portable checkpoints (the
    ``-7`` wire family): each peer's sealed epochs land under the
    spool, which is what a :class:`~windflow_tpu_torch.parallel.plane.
    PlaneSupervisor` successor restores a dead peer from
    (docs/ROBUSTNESS.md "Cross-host recovery").  Unset ⇒ the family is
    refused on arrival and nothing new is imported — the seed
    contract.

    ``telemetry_sink`` (typically an ``obs.federation.
    TelemetryAggregator``) opts this process into RECEIVING peers'
    federated-telemetry snapshots (the ``-8`` wire family,
    docs/OBSERVABILITY.md "Federation & SLOs").  Same contract as
    ``ckpt_sink``: unset ⇒ the family is refused on arrival and nothing
    new is imported."""
    from .channel import RowReceiver, RowSender, WireConfig
    if my_pid not in addresses:
        raise KeyError(f"addresses has no entry for this process "
                       f"(pid {my_pid}): {sorted(addresses)}")
    if wire is None:
        wire = WireConfig.hardened()
    wire.validate()   # reject heartbeat >= stall_timeout (WF205)
    host, port = addresses[my_pid]
    receiver = RowReceiver(n_senders=len(addresses) - 1, host=host,
                           port=port, capacity=capacity,
                           # wire= supplies stall_timeout and the
                           # accept deadline (a peer that dies before
                           # ever connecting must surface within the
                           # boot-order budget, not hang batches())
                           metrics=metrics, events=events,
                           decode_trace=decode_trace,
                           resume=resume, resume_epoch=resume_epoch,
                           ckpt_sink=ckpt_sink,
                           telemetry_sink=telemetry_sink, wire=wire)
    senders = {}
    try:
        for pid in sorted(addresses):
            if pid == my_pid:
                continue
            peer_host, peer_port = addresses[pid]
            senders[pid] = RowSender(
                peer_host, peer_port,
                metrics=metrics, events=events,
                resume=resume, wire=wire)
    except Exception:
        for snd in senders.values():
            snd.abort()
        receiver.close()
        raise
    return receiver, senders


def ship_epoch(senders: dict, epoch: int, my_pid: int = None):
    """Broadcast an epoch barrier frame on every outbound row channel of
    this process's data plane (the multihost half of the recovery
    layer's epoch alignment, docs/ROBUSTNESS.md "Recovery"): a source
    that injects epoch ``e`` locally calls this so remote consumers'
    ``batches(epoch_markers=True)`` aligns on the same boundary.  Call
    it AFTER the epoch's last ``partition_and_ship`` — the frame
    promises every row of epochs <= ``e`` is already on the wire.

    On a resumable plane (``open_row_plane(resume=...)``) the epoch
    frame is also the journal's unit of truncation: once the remote
    receiver acks epoch ``e`` (automatic under ``WireConfig(recovery=
    True)``), every journaled frame up to and including this barrier is
    dropped — so calling ``ship_epoch`` at your checkpoint cadence is
    what keeps sender journals bounded by one epoch's width."""
    for pid, snd in senders.items():
        if my_pid is not None and pid == my_pid:
            continue
        snd.send_epoch(epoch)


def local_kf_groups(mesh: DeviceMesh, process_index=None,
                    process_of=None) -> np.ndarray:
    """The kf-group indices whose device rows live on this process
    (``process_index``: default the group's rank, 0 without a group)."""
    if process_index is None:
        process_index = _rank()
    owners = _kf_owners(mesh, process_of)
    return np.flatnonzero(owners == int(process_index))
