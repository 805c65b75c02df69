"""Window evaluation over a device mesh — the port of
``windflow_tpu/parallel/mesh.py``.  The streaming parallelism strategies
become the axes of a (kf, wf, sp) mesh of CUDA devices:

* ``kf`` axis — **group parallelism**: disjoint key groups (Key_Farm,
  kf_nodes.hpp:38-82) land on different devices.  The host routes rows;
  on the devices the groups exchange nothing.
* ``wf`` axis — **window parallelism** (Win_Farm, wf_nodes.hpp:158-173):
  the fired windows split over the ``wf`` shards, each evaluating its own
  over the group's rows.  No exchange either.
* ``sp`` axis — **window-partition parallelism** (Win_MapReduce,
  win_mapreduce.hpp:147-183): each window's rows split over the ``sp``
  shards; every shard reduces its slice (the MAP stage, the
  ``sp_window_partial`` kernel) and one launch on the group's first sp
  device folds the partials (the REDUCE stage, the ``sp_merge`` kernel),
  after copying any partial that lives on another device there.

A :class:`DeviceMesh` is an ``(n_kf, n_wf, n_sp)`` array of
``torch.device``.  Unlike a ``jax.sharding.Mesh`` its device list may
repeat a device (e.g. ``["cpu"] * 8`` in the tests, or four times
``cuda:0`` on a one-card host): every shard still has its own tensors
and its own launches, as each card of a real mesh would.  The mesh
executors of ops/resident.py (``MeshResidentExecutor``,
``MeshMultiFieldResidentExecutor``) read ``mesh.shape[axis]`` and
``mesh.devices`` as JAX's read the jax mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.device import _bucket
from ..ops.mesh_reduce import find_long_windows, sp_merge, sp_window_partial
from ..ops.monoid import OPS as _OPS

KF_AXIS = "kf"   # key/group parallelism (no exchange; Key_Farm axis)
WF_AXIS = "wf"   # window parallelism (no exchange; Win_Farm axis)
SP_AXIS = "sp"   # within-window partition parallelism (partials merged)

__all__ = ["KF_AXIS", "WF_AXIS", "SP_AXIS", "DeviceMesh", "make_mesh",
           "MeshWindowedReduce", "MeshStreamStep", "partition_stream_by_key"]


class DeviceMesh:
    """A (kf, wf, sp) grid of torch devices: ``devices`` is the
    ``(n_kf, n_wf, n_sp)`` object array, ``shape`` the dict from axis name
    to size in that order, ``axis_names`` the names."""

    def __init__(self, devices: np.ndarray,
                 axis_names=(KF_AXIS, WF_AXIS, SP_AXIS)):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def __repr__(self):
        return (f"DeviceMesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def make_mesh(n_kf: int = 1, n_sp: int = 1, devices=None,
              n_wf: int = 1) -> DeviceMesh:
    """A 3D (kf, wf, sp) device mesh.  ``n_kf * n_wf * n_sp`` must not
    exceed the devices given; ``devices=None`` takes every visible CUDA
    device and raises ``RuntimeError`` without one (it never falls back to
    the CPU: pass ``devices=["cpu"] * n`` for the kernels' plain
    versions).  An explicit list may repeat a device."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "no CUDA device: a mesh runs on the cards; pass "
                "devices=['cpu'] * n explicitly to run it on the host")
        devices = [torch.device(f"cuda:{i}") for i in range(n)]
    devices = [torch.device(d) for d in devices]
    need = n_kf * n_wf * n_sp
    if need > len(devices):
        raise ValueError(f"mesh ({n_kf}x{n_wf}x{n_sp}) needs {need} "
                         f"devices, have {len(devices)}")
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    return DeviceMesh(grid.reshape(n_kf, n_wf, n_sp))


def _torch_dtype(dtype) -> torch.dtype:
    """int32 or float32 as a torch dtype, from a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        out = dtype
    else:
        out = {np.dtype(np.int32): torch.int32,
               np.dtype(np.float32): torch.float32}.get(np.dtype(dtype))
    if out not in (torch.int32, torch.float32):
        raise TypeError(f"the mesh reduction runs in int32 or float32, got "
                        f"{dtype}")
    return out


def _canonical(a: np.ndarray) -> np.ndarray:
    """64-bit values as their 32-bit kind (JAX's default canonicalisation
    without x64, which the reference's rows go through)."""
    if a.dtype.itemsize > 4 and a.dtype.kind in "iu":
        return a.astype(np.int32)
    if a.dtype.itemsize > 4 and a.dtype.kind == "f":
        return a.astype(np.float32)
    return a


class MeshWindowedReduce:
    """Sharded batched window reduction: the multi-device form of the
    windowed reduction for the built-in monoid ops (``monoid.OPS``).

    Global layout (KF = kf shards, each owning B windows over N rows), as
    the JAX package shards it:

    * ``flat`` (KF, N): each sp shard holds a contiguous ``Ns`` row slice
      of its group, ``Ns = bucket(ceil(N / n_sp))``, rows from N to
      ``Ns * n_sp`` zero; every wf shard of the group holds its own copy;
    * ``starts``/``lens`` (KF, B): the windows, padded to ``bucket(B)``
      rounded up to a multiple of n_wf, split over wf in order;
    * result (KF, B): every window's reduction.

    Optional fused elementwise stages run on each shard's device before
    the partial (the device-side analog of MultiPipe chaining):
    ``map_fn(values) -> values`` transforms rows (a torch function of the
    shard's slice), ``filter_fn(values) -> bool`` *removes* rows from the
    aggregation: dropped rows do not count toward count/mean and do not
    contribute to any reduction, like a chained Filter upstream of the
    window operator.  Both see the padded slice: a window that runs past
    N reads (mapped) zeros and counts them, as in JAX.

    ``collective`` is "auto"/"psum" (shards folded 0, 1, ..., n_sp - 1) or
    "ring" (0, n_sp - 1, ..., 1: the order in which JAX's ppermute ring
    accumulates on sp shard 0); ``mean`` returns float32.
    """

    def __init__(self, mesh: DeviceMesh, op: str = "sum",
                 dtype=torch.int32, map_fn=None, filter_fn=None,
                 collective: str = "auto"):
        if op not in _OPS:
            raise ValueError(f"unsupported op {op!r}")
        if collective not in ("auto", "psum", "ring"):
            raise ValueError(f"unknown collective {collective!r}")
        self.mesh = mesh
        self.op = op
        self.dtype = _torch_dtype(dtype)
        self.map_fn = map_fn
        self.filter_fn = filter_fn
        self.collective = collective
        self.n_kf = mesh.shape[KF_AXIS]
        self.n_wf = mesh.shape.get(WF_AXIS, 1)
        self.n_sp = mesh.shape[SP_AXIS]

    def _shard_partial(self, dev, rows: np.ndarray, starts, lens, base):
        """One (kf, wf, sp) shard: its slice to `dev`, map and filter
        there, then the partial kernel over its windows (the long ones
        listed from the host's starts and lens)."""
        v = torch.from_numpy(rows).to(dev)
        if self.map_fn is not None:
            v = self.map_fn(v)
        keep = None
        if self.filter_fn is not None:
            keep = self.filter_fn(v).to(torch.bool).contiguous()
        vals = v.to(self.dtype).contiguous()
        st = torch.from_numpy(starts).to(dev)
        ln = torch.from_numpy(lens).to(dev)
        return sp_window_partial(
            vals, keep, st, ln, base, self.op,
            long_windows=find_long_windows(starts, lens, base, len(rows)))

    def __call__(self, flat: np.ndarray, starts: np.ndarray,
                 lens: np.ndarray) -> np.ndarray:
        """Evaluate all windows. ``flat`` is (KF, N) group rows; ``starts``
        and ``lens`` are (KF, B) window descriptors (row offsets within the
        group's flat segment). Returns (KF, B) reductions."""
        flat = _canonical(np.asarray(flat))
        starts = np.asarray(starts)
        lens = np.asarray(lens)
        KF, N = flat.shape
        if KF != self.n_kf:
            raise ValueError(f"flat has {KF} groups, mesh kf={self.n_kf}")
        B = starts.shape[1]
        Bb = _bucket(B)
        if Bb % self.n_wf:  # the window axis shards B over wf
            Bb = ((Bb + self.n_wf - 1) // self.n_wf) * self.n_wf
        Bw = Bb // self.n_wf
        Ns = _bucket(max((N + self.n_sp - 1) // self.n_sp, 1))
        gflat = np.zeros((KF, Ns * self.n_sp), dtype=flat.dtype)
        gflat[:, :N] = flat
        ring = self.collective == "ring" and self.n_sp > 1
        devs = self.mesh.devices
        merged = []
        for g in range(KF):
            for w in range(self.n_wf):
                a, b = w * Bw, min((w + 1) * Bw, B)
                if a >= b:     # padding only: this wf shard launches nothing
                    continue
                st = np.ascontiguousarray(starts[g, a:b], dtype=np.int32)
                ln = np.ascontiguousarray(lens[g, a:b], dtype=np.int32)
                parts, cnts = [], []
                for s in range(self.n_sp):
                    p, c = self._shard_partial(
                        devs[g, w, s], gflat[g, s * Ns:(s + 1) * Ns], st,
                        ln, s * Ns)
                    parts.append(p)
                    cnts.append(c)
                merged.append((g, a, b, sp_merge(
                    parts, cnts if cnts[0] is not None else None, self.op,
                    ring=ring, device=devs[g, w, 0])))
        out_dt = np.float32 if self.op == "mean" else (
            np.int32 if self.dtype == torch.int32 else np.float32)
        out = np.zeros((KF, B), dtype=out_dt)
        for g, a, b, res in merged:
            out[g, a:b] = res.cpu().numpy()
        return out


#: One full streaming step over the mesh: MeshWindowedReduce already fuses
#: the elementwise Map and Filter stages into the partitioned windowed
#: reduction; this name marks the whole-step usage.
MeshStreamStep = MeshWindowedReduce


def partition_stream_by_key(batch_keys: np.ndarray, n_groups: int,
                            routing=None) -> np.ndarray:
    """Host-side key→group routing for the kf axis (the mesh form of
    KF_Emitter's ``routing(key, n)``, kf_nodes.hpp:73). Returns the group
    index per row; default is ``key % n`` (builders.hpp:190)."""
    if routing is not None:
        return np.asarray(routing(batch_keys, n_groups))
    return batch_keys % n_groups
