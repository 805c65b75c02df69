"""Twins of tests/test_multihost.py for the port's multi-process layout
(windflow_tpu_torch/parallel/multihost.py): kf splits along the process
boundary, so key groups never span processes and sp/wf neighbours share a
process.  Two processes of four devices each are simulated on
``["cpu"] * 8`` with ``process_of`` injected BY POSITION (the list repeats
one device, so position is its only identity); the JAX package's layout
over its 8 virtual CPU devices, with its ``process_of`` by ``id(d)``, is
the reference each result is held against."""

import numpy as np
import pytest
import torch

import jax

from windflow_tpu.parallel import multihost as jmh
from windflow_tpu_torch.parallel import multihost as tmh
from windflow_tpu_torch.parallel.mesh import KF_AXIS, SP_AXIS, WF_AXIS

JDEVS = jax.devices()[:8]
#: 2 hosts x 4 devices, by position (the port) and by id (JAX)
PIDS = [i // 4 for i in range(8)]
J_PID = {id(d): p for d, p in zip(JDEVS, PIDS)}


def j_pid(d):
    return J_PID[id(d)]


def jax_mesh(**kw):
    return jmh.make_multihost_mesh(devices=JDEVS, process_of=j_pid, **kw)


def jax_index_grid(mesh):
    """Each JAX mesh entry as its position in JDEVS."""
    pos = {id(d): i for i, d in enumerate(JDEVS)}
    return np.vectorize(lambda d: pos[id(d)], otypes=[int])(mesh.devices)


def test_kf_splits_along_host_boundary():
    mesh = tmh.make_multihost_mesh(n_sp=2, n_wf=1, devices=["cpu"] * 8,
                                   process_of=PIDS)
    assert dict(mesh.shape) == {KF_AXIS: 4, WF_AXIS: 1, SP_AXIS: 2}
    # every kf row lives on ONE process; kf rows are process-major
    assert [set(mesh.processes[g].flat) for g in range(4)] == [
        {0}, {0}, {1}, {1}]
    # the same grid as JAX's, entry for entry: devices told apart by index
    indexed = tmh.make_multihost_mesh(
        n_sp=2, n_wf=1, devices=[f"cpu:{i}" for i in range(8)],
        process_of=PIDS)
    want = jax_index_grid(jax_mesh(n_sp=2, n_wf=1))
    got = np.vectorize(lambda d: d.index, otypes=[int])(indexed.devices)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(indexed.processes,
                                  np.asarray(PIDS)[want])


def test_sp_cannot_span_hosts():
    with pytest.raises(ValueError, match="ICI"):
        jax_mesh(n_sp=8)
    with pytest.raises(ValueError, match="one host"):
        tmh.make_multihost_mesh(n_sp=8, devices=["cpu"] * 8,
                                process_of=PIDS)


def test_uneven_hosts_rejected():
    uneven = [0 if i < 3 else 1 for i in range(8)]
    with pytest.raises(ValueError, match="disagree"):
        jmh.make_multihost_mesh(
            n_sp=1, devices=JDEVS,
            process_of=lambda d: uneven[JDEVS.index(d)])
    with pytest.raises(ValueError, match="disagree"):
        tmh.make_multihost_mesh(n_sp=1, devices=["cpu"] * 8,
                                process_of=uneven)
    with pytest.raises(ValueError, match="names 3 owners"):
        tmh.make_multihost_mesh(n_sp=1, devices=["cpu"] * 8,
                                process_of=[0, 0, 1])


def test_process_for_keys_matches_kf_rows():
    mesh = tmh.make_multihost_mesh(n_sp=2, devices=["cpu"] * 8,
                                   process_of=PIDS)
    keys = np.arange(40)
    # the default process_of reads the mesh's record of each entry
    owner = tmh.process_for_keys(keys, mesh)
    want = jmh.process_for_keys(keys, jax_mesh(n_sp=2), process_of=j_pid)
    np.testing.assert_array_equal(owner, want)
    np.testing.assert_array_equal(owner, np.where(keys % 4 < 2, 0, 1))
    for p in (0, 1):
        np.testing.assert_array_equal(
            tmh.local_kf_groups(mesh, process_index=p),
            jmh.local_kf_groups(jax_mesh(n_sp=2), process_index=p,
                                process_of=j_pid))
    # without a process group this process is rank 0
    np.testing.assert_array_equal(tmh.local_kf_groups(mesh), [0, 1])
    # an injected callable process_of keeps the JAX package's contract
    np.testing.assert_array_equal(
        tmh.process_for_keys(keys, mesh, process_of=lambda d: 5),
        np.full(40, 5))


def test_single_process_degenerates_to_plain_mesh():
    mesh = tmh.make_multihost_mesh(n_sp=2, n_wf=2, devices=["cpu"] * 8,
                                   process_of=lambda d: 0)
    assert dict(mesh.shape) == {KF_AXIS: 2, WF_AXIS: 2, SP_AXIS: 2}
    # no group and no process_of: the whole list is this process's
    plain = tmh.make_multihost_mesh(n_sp=2, n_wf=2, devices=["cpu"] * 8)
    assert dict(plain.shape) == dict(mesh.shape)
    assert not plain.processes.any()
    # and the sharded streaming step runs on it end-to-end, as JAX's
    from windflow_tpu.parallel.mesh import MeshStreamStep as JStep
    from windflow_tpu_torch.parallel.mesh import MeshStreamStep
    rng = np.random.default_rng(0)
    N, B, L = 32, 4, 8
    flat = rng.integers(-9, 9, size=(2, N)).astype(np.int32)
    lens = rng.integers(1, L + 1, size=(2, B)).astype(np.int32)
    starts = rng.integers(0, N - L, size=(2, B)).astype(np.int32)
    got = np.asarray(MeshStreamStep(mesh, op="sum")(flat, starts, lens))
    want = np.asarray(JStep(jax_mesh(n_sp=2, n_wf=2), op="sum")(
        flat, starts, lens))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.stack(
        [[flat[k, s:s + l].sum() for s, l in zip(starts[k], lens[k])]
         for k in range(2)]))


def test_initialize_noop_only_for_explicit_single_process(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: calls.append(kw))
    # the explicit single-process job has nothing to coordinate
    tmh.initialize(num_processes=1)
    assert calls == []
    # a zero-arg call must DELEGATE to env:// (torchrun's variables), as
    # JAX's delegates to cluster auto-detection, never be swallowed
    tmh.initialize()
    assert calls == [{"backend": "gloo", "init_method": "env://"}]
    tmh.initialize(coordinator_address="host:1234", num_processes=2,
                   process_id=1)
    assert calls[-1] == {"backend": "gloo",
                         "init_method": "tcp://host:1234",
                         "world_size": 2, "rank": 1}
    # the backend is an argument, never switched silently
    tmh.initialize(coordinator_address="host:1", num_processes=2,
                   process_id=0, backend="nccl")
    assert calls[-1]["backend"] == "nccl"


def test_custom_routing_changes_key_owners():
    mesh = tmh.make_multihost_mesh(n_sp=2, devices=["cpu"] * 8,
                                   process_of=PIDS)
    keys = np.arange(8)
    routing = lambda k, n: (k + 2) % n  # noqa: E731
    flipped = tmh.process_for_keys(keys, mesh, routing=routing)
    np.testing.assert_array_equal(
        flipped, jmh.process_for_keys(keys, jax_mesh(n_sp=2),
                                      process_of=j_pid, routing=routing))
    np.testing.assert_array_equal(
        flipped, np.where((keys + 2) % 4 < 2, 0, 1))


def test_dryrun_multichip_on_cpu_devices():
    """The port's counterpart of the JAX package's dry run
    (``__graft_entry__.dryrun_multichip``) over the host: meshes of 8, 2
    and 3 devices, the device farm, the mesh cores and the layout."""
    from windflow_tpu_torch.dryrun import dryrun_multichip
    for n in (8, 2, 3):
        dryrun_multichip(n, devices=["cpu"] * n)
    with pytest.raises(ValueError, match="need 4 devices"):
        dryrun_multichip(4, devices=["cpu"] * 2)
