"""``dryrun_multichip(n)`` — the port's counterpart of the JAX package's
driver entry (``__graft_entry__.py`` ``dryrun_multichip``): build the
(kf, wf, sp) meshes over ``n`` devices, run the streaming step and a real
device pipeline on them against host oracles, and lay out the multi-process
mesh with an injected ``process_of``.

``devices=None`` takes the cards (``cuda:i`` round-robin over the visible
devices, so one card serves a mesh of any size) and raises without one;
``devices=["cpu"] * n`` runs every kernel's plain version on the host.

    python -m windflow_tpu_torch.dryrun [N]
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def _devices(n_devices: int, devices):
    if devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, got {len(devices)}")
        return [torch.device(d) for d in devices[:n_devices]]
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError(
            "no CUDA device: the dry run runs on the cards; pass "
            "devices=['cpu'] * n explicitly to run it on the host")
    return [torch.device(f"cuda:{i % count}") for i in range(n_devices)]


def _mesh_shape(n_devices: int):
    """The full 3D (kf, wf, sp) mesh when the count factors (8 -> 2x2x2),
    else (n/2, 1, 2), else (n, 1, 1) — the JAX entry's choice."""
    if n_devices % 8 == 0:
        return n_devices // 4, 2, 2
    if n_devices % 2 == 0:
        return n_devices // 2, 1, 2
    return n_devices, 1, 1


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run one mesh streaming step, a device farm spread over the devices,
    the mesh-resident cores and the multi-process layout over ``n_devices``
    devices; raise ``AssertionError`` on any disagreement with the host."""
    from .parallel.mesh import MeshStreamStep, make_mesh

    devs = _devices(n_devices, devices)
    n_kf, n_wf, n_sp = _mesh_shape(n_devices)
    mesh = make_mesh(n_kf, n_sp, devices=devs, n_wf=n_wf)

    rng = np.random.default_rng(1)
    N, B, MAXLEN = 64, 8, 16
    flat = rng.integers(-20, 20, size=(n_kf, N)).astype(np.int32)
    lens = rng.integers(1, MAXLEN + 1, size=(n_kf, B)).astype(np.int32)
    starts = rng.integers(0, N - MAXLEN, size=(n_kf, B)).astype(np.int32)
    step = MeshStreamStep(mesh, op="sum", map_fn=lambda v: v * 3,
                          filter_fn=lambda v: v > 0)
    got = np.asarray(step(flat, starts, lens))
    mapped = np.where(flat * 3 > 0, flat * 3, 0)
    want = np.stack([[mapped[k, s:s + l].sum()
                      for s, l in zip(starts[k], lens[k])]
                     for k in range(n_kf)])
    np.testing.assert_array_equal(got, want)

    _dryrun_streaming_pipeline(devs)
    _dryrun_mesh_resident(mesh)
    _dryrun_multihost_layout(devs, n_sp, n_wf)


def _keyed_batches(schema, keys, n, chunk, value):
    from .core.tuples import batch_from_columns
    out = []
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        ids = np.repeat(np.arange(lo, lo + m), keys)
        ks = np.tile(np.arange(keys), m)
        out.append(batch_from_columns(schema, key=ks, id=ids, ts=ids,
                                      **value(ids, ks)))
    return out


def _total(pattern, batches, schema, fields, map_stage=None):
    """Source -> [map] -> pattern -> Sink through a MultiPipe; the sum of
    ``fields`` over every result row."""
    from .api.multipipe import MultiPipe
    from .patterns.basic import Sink, Source
    total = [0]

    def snk(rows):
        if rows is not None and len(rows):
            total[0] += sum(int(rows[f].sum()) for f in fields)

    pipe = MultiPipe("dryrun").add_source(
        Source(batches=iter(batches), schema=schema))
    if map_stage is not None:
        pipe.add(map_stage)
    (pipe.add(pattern).add_sink(Sink(snk, vectorized=True))
     .run_and_wait_end())
    return total[0]


def _dryrun_streaming_pipeline(devs) -> None:
    """Source -> Map -> KeyFarmGPU (a worker a device) -> Sink against the
    host WinSeq: every device's ring must be placed and used."""
    from .core.tuples import Schema
    from .core.windows import WinType
    from .ops.functions import Reducer
    from .patterns.basic import Map
    from .patterns.win_seq import WinSeq
    from .patterns.win_seq_gpu import KeyFarmGPU

    schema = Schema(value=np.int64)
    batches = _keyed_batches(schema, 8, 96, 32,
                             lambda ids, ks: {"value": ids * 3 + ks})

    def double(rows):
        rows = rows.copy()
        rows["value"] = rows["value"] * 2
        return rows

    farm = KeyFarmGPU(Reducer("sum", value_range=(0, 1000)), 16, 4,
                      WinType.CB, pardegree=len(devs), batch_len=16,
                      device=list(devs))
    placed = set()
    for i in range(len(devs)):
        core = farm._make_core(farm._seq_template, i)
        for ex in [getattr(core, "executor", None),
                   *getattr(core, "executors", [])]:
            if ex is not None:
                placed.add(str(ex.device))
    if placed != {str(d) for d in devs}:
        raise AssertionError(f"KeyFarmGPU(pardegree={len(devs)}) placed "
                             f"rings on {sorted(placed)}, not on "
                             f"{sorted({str(d) for d in devs})}")
    want = _total(WinSeq(Reducer("sum"), 16, 4, WinType.CB), batches,
                  schema, ["value"], Map(double, vectorized=True))
    got = _total(farm, batches, schema, ["value"],
                 Map(double, vectorized=True))
    if got != want:
        raise AssertionError(f"device farm total {got} != host {want}")


def _dryrun_mesh_resident(mesh) -> None:
    """WinSeqGPU over the mesh: the single ring, several stats over one
    ring, and per-field rings, each against the host WinSeq."""
    from .core.tuples import Schema
    from .core.windows import WinType
    from .ops.functions import MultiReducer, Reducer
    from .patterns.win_seq import WinSeq
    from .patterns.win_seq_gpu import WinSeqGPU

    schema = Schema(value=np.int64)
    batches = _keyed_batches(schema, 8, 80, 20,
                             lambda ids, ks: {"value": ids + 7 * ks})
    schema2 = Schema(a=np.int64, b=np.int64)
    batches2 = _keyed_batches(schema2, 8, 80, 20, lambda ids, ks: {
        "a": ids + 7 * ks, "b": (ids * 3 + ks) % 50})
    cases = [
        (Reducer("sum", value_range=(0, 1000)), Reducer("sum"), batches,
         schema, ["value"]),
        (MultiReducer(Reducer("count", out_field="cnt"),
                      Reducer("sum", "value", "sm", value_range=(0, 200)),
                      Reducer("max", "value", "mx", value_range=(0, 200))),
         None, batches, schema, ["cnt", "sm", "mx"]),
        (MultiReducer(Reducer("sum", "a", "sa", value_range=(0, 200)),
                      Reducer("max", "b", "mb", value_range=(0, 50))),
         None, batches2, schema2, ["sa", "mb"]),
    ]
    for dev_fn, host_fn, bs, sch, fields in cases:
        want = _total(WinSeq(host_fn or dev_fn, 12, 4, WinType.CB), bs, sch,
                      fields)
        got = _total(WinSeqGPU(dev_fn, 12, 4, WinType.CB, batch_len=16,
                               mesh=mesh), bs, sch, fields)
        if got != want:
            raise AssertionError(
                f"mesh WinSeqGPU({fields}) total {got} != host {want}")


def _dryrun_multihost_layout(devs, n_sp: int, n_wf: int) -> None:
    """The multi-process layout over the same devices, split into two
    simulated processes by position: kf rows are process-major, no kf row
    spans two processes, and key ownership follows the kf rows."""
    from .parallel.mesh import KF_AXIS
    from .parallel.multihost import (local_kf_groups, make_multihost_mesh,
                                     process_for_keys)
    from .runtime.emitters import default_routing

    n_proc = 2 if len(devs) % (2 * n_sp * n_wf) == 0 else 1
    owners = [i * n_proc // len(devs) for i in range(len(devs))]
    mesh = make_multihost_mesh(n_sp=n_sp, n_wf=n_wf, devices=devs,
                               process_of=owners)
    n_kf = int(mesh.shape[KF_AXIS])
    for g in range(n_kf):
        if len(set(mesh.processes[g].flat)) != 1:
            raise AssertionError(f"kf row {g} spans processes "
                                 f"{sorted(set(mesh.processes[g].flat))}")
    keys = np.arange(4 * n_kf)
    owner = process_for_keys(keys, mesh)
    groups = default_routing(keys, n_kf)
    for p in range(n_proc):
        mine = local_kf_groups(mesh, process_index=p)
        if not np.array_equal(np.flatnonzero(owner == p),
                              np.flatnonzero(np.isin(groups, mine))):
            raise AssertionError(f"process {p}: key owners disagree with "
                                 f"its kf groups {mine.tolist()}")


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    dryrun_multichip(n)
    print(f"dryrun_multichip({n}) ok")
