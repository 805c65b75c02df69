"""The sp-partitioned windowed reduction of a device mesh: the hand-written
CUDA kernels (csrc/mesh_reduce.cu), their plain PyTorch versions, CPU twins
of their combine order, and the loader that builds them on first use.

This ports the body of ``MeshWindowedReduce._build.local`` in
``windflow_tpu/parallel/mesh.py:141`` and its sp collectives (psum, pmin,
pmax, the all_gather fold of prod, :167-186; the ring of ppermute hops,
:129-139), in two entries:

* :func:`sp_window_partial` — one (kf, wf, sp) shard's partial of each of
  its windows.  The shard's ``(Ns,)`` value slice holds rows ``[base, base
  + Ns)`` of its group (after the user's ``map_fn``, in the reduction's
  dtype, int32 or float32); ``keep`` is ``None`` or the ``(Ns,)`` bool
  output of the user's ``filter_fn``.  Window ``w`` is clipped to the
  slice, ``lo = clip(starts[w] - base, 0, Ns)``, ``hi = clip(starts[w] +
  lens[w] - base, 0, Ns)``, and its kept rows are reduced; count and mean
  also give the kept-row count (int32).  ``count`` returns that count in
  the dtype, ``mean`` the sum (the merge divides).  Windows longer than
  :data:`SPLIT` cells are cut into chunks of :data:`CHUNK` cells, a
  block a window (:func:`find_long_windows` lists them; the caller that
  holds the windows on the host passes the list).
* :func:`sp_merge` — folds the ``n_sp`` partials of every window, shard
  0, 1, ..., n-1 (``ring=False``: psum/pmin/pmax, prod's gather fold) or
  0, n-1, ..., 1 (``ring=True``: the order in which sp shard 0 accumulates
  its ``n_sp - 1`` ppermute hops, whose value JAX returns), in one launch
  on the merging device, reading each partial where it lies.  Partials on
  another device are copied there first.  ``mean`` returns float32 ``sum
  / max(count, 1)``, also for an int32 dtype (JAX's ``/`` of int32 gives
  float32).

A CUDA tensor launches the kernel on the current stream (asynchronous,
counted in ``<wrapper>.launches``; one launch a call); a CPU tensor runs
the plain version.
There is no fallback from one to the other.  :func:`partial_order_twin`
and :func:`merge_order_twin` are plain torch that reproduce the kernels'
combine order (no path of the port calls them): on the card the kernels
equal them bit for bit.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import _nvcc
from .monoid import identity
from .windowed_reduce import GROUP, _combine, _wrap32, chunked_fold

#: op codes of the C launchers (enum Op in the .cu source)
_OPS = {"sum": 0, "count": 1, "min": 2, "max": 3, "prod": 4, "mean": 5}
#: value dtypes the kernels are instantiated for (enum Dtype)
_DTYPES = {torch.int32: 0, torch.float32: 1}
# sp_window_partial's geometry (csrc/mesh_reduce.cu; partial_order_twin
# follows it): a window of at most SPLIT cells is reduced by one team of
# 8 lanes, a longer one by a block, in chunks of CHUNK cells (a multiple
# of 32: 8 lanes x 4 cells) whose partials fold in chunk order.  On an
# H100 the block path wins from 2,048 cells (at 1,032 windows) to 4,096
# (at 2^24 window cells): scripts/torch_mesh_kernels.py, PERF.md.
SPLIT = 2048
CHUNK = 512
#: cells a window's lanes gather a step in the plain version, at most
_PLAIN_CELLS = 1 << 24

_lock = threading.Lock()
_lib = None


def build() -> str:
    """Compile csrc/mesh_reduce.cu if this source has not been built yet;
    returns the path of the shared library (ops/_nvcc.py)."""
    return _nvcc.build("mesh_reduce.cu")


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            c_int, c_ll, c_p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
            lib.wf_sp_window_partial.argtypes = [
                c_p, c_p, c_ll, c_p, c_p, c_int, c_ll, c_int, c_int,
                ctypes.c_uint, c_p, c_int, c_int, c_int, c_p, c_p, c_p]
            lib.wf_sp_window_partial.restype = c_int
            lib.wf_sp_merge.argtypes = [c_p, c_p, c_p, c_int, c_int, c_int,
                                        c_int, c_p, c_p]
            lib.wf_sp_merge.restype = c_int
            _lib = lib
        return _lib


def needs_count(op: str) -> bool:
    """Whether the partial of `op` carries the kept-row count."""
    return op in ("count", "mean")


def _check_op(op: str, dtype: torch.dtype):
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}; expected one of {tuple(_OPS)}")
    if dtype not in _DTYPES:
        raise TypeError(f"the mesh reduction runs in int32 or float32, got "
                        f"{dtype}")


def _ident(op: str, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(identity(op, dtype).item(), dtype=dtype)


def _ident_bits(op: str, dtype: torch.dtype) -> int:
    np_dt = np.int32 if dtype == torch.int32 else np.float32
    return int(np.array(identity(op, np_dt), dtype=np_dt).view(np.uint32))


def _bounds(starts, lens, base: int, Ns: int):
    """The windows clipped to the shard's slice: (lo, hi) as int64."""
    s = starts.long()
    lo = (s - int(base)).clamp(0, int(Ns))
    hi = (s + lens.long() - int(base)).clamp(0, int(Ns))
    return lo, hi


# ------------------------------------------------------------------ partial

def sp_window_partial_reference(vals, keep, starts, lens, base: int,
                                op: str):
    """Plain version, JAX's formulation: a ``(B, pad)`` gather at
    ``min(lo + iota, Ns - 1)``, the mask ``iota < hi - lo`` and the keep
    mask at the gathered rows, the identity in masked lanes, a reduction
    over axis 1.  Windows are taken in order of length, in runs of at most
    ``_PLAIN_CELLS`` gathered cells.  Returns (partial, count or None)."""
    dtype = vals.dtype
    _check_op(op, dtype)
    device = vals.device
    B, Ns = starts.numel(), vals.numel()
    part = torch.empty(B, dtype=dtype, device=device)
    cnt = torch.zeros(B, dtype=torch.int32, device=device)
    lo, hi = _bounds(starts, lens, base, Ns)
    n = (hi - lo).clamp(min=0)
    ident = _ident(op if op != "count" else "sum", dtype).to(device)
    if Ns == 0 or B == 0:
        part[:] = ident
        return part, (cnt if needs_count(op) else None)
    order = torch.argsort(n)
    ns = n[order].cpu().numpy()
    i = 0
    while i < B:
        # a run [i, j) of windows sorted by length: its pad is the length
        # of its last window, and j - i windows of it gather at most
        # _PLAIN_CELLS cells (or the run is one window)
        j = min(B, i + max(1, _PLAIN_CELLS // max(int(ns[i]), 1)))
        while j > i + 1 and (j - i) * max(int(ns[j - 1]), 1) > _PLAIN_CELLS:
            j = i + max(1, _PLAIN_CELLS // max(int(ns[j - 1]), 1))
        pad = max(int(ns[j - 1]), 1)
        sel = order[i:j]
        iota = torch.arange(pad, device=device)
        idx = (lo[sel][:, None] + iota[None, :]).clamp(max=Ns - 1)
        mask = iota[None, :] < n[sel][:, None]
        if keep is not None:
            mask = mask & keep[idx]
        c = mask.sum(dim=1)
        cnt[sel] = c.to(torch.int32)
        if op == "count":
            part[sel] = c.to(dtype)
        else:
            v = torch.where(mask, vals[idx], ident)
            if dtype == torch.int32 and op in ("sum", "mean", "prod"):
                wide = v.long()
                red = wide.prod(dim=1) if op == "prod" else wide.sum(dim=1)
                part[sel] = _wrap32(red).to(torch.int32)
            elif op in ("sum", "mean"):
                part[sel] = v.sum(dim=1)
            elif op == "prod":
                part[sel] = v.prod(dim=1)
            else:
                part[sel] = v.amin(dim=1) if op == "min" else v.amax(dim=1)
        i = j
    return part, (cnt if needs_count(op) else None)


def find_long_windows(starts, lens, base: int, Ns: int,
                      split: int = SPLIT) -> np.ndarray:
    """The windows (int32 indices, ascending) whose length clipped to the
    slice ``[base, base + Ns)`` exceeds `split`: those sp_window_partial
    gives a block each.  Takes the host's numpy (or CPU) starts and lens;
    the caller that holds them passes the result to sp_window_partial as
    ``long_windows``."""
    s = np.asarray(starts, dtype=np.int64)
    lo = np.clip(s - int(base), 0, int(Ns))
    hi = np.clip(s + np.asarray(lens, dtype=np.int64) - int(base), 0,
                 int(Ns))
    return np.flatnonzero(hi - lo > split).astype(np.int32)


def partial_order_twin(vals, keep, starts, lens, base: int, op: str,
                       split: int = SPLIT, chunk: int = CHUNK):
    """Plain torch that reproduces sp_window_partial's combine order
    (csrc/mesh_reduce.cu, "Order"); no path of the port calls it.  With a
    = lo mod 4, cell j of a window lies in its group (a + j) // 4.  A window
    of at most `split` cells is one team's (windowed_reduce.team_fold over
    all its groups); a longer one is cut into chunks of `chunk` cells
    (``chunk // 4`` groups from the window's first aligned group), each
    chunk reduced in the team's order, and the chunk partials are folded in
    chunk order starting from the identity.  Filtered cells are skipped and
    not counted.  Returns (partial, count or None)."""
    dtype = vals.dtype
    _check_op(op, dtype)
    device = vals.device
    Ns = vals.numel()
    lo, hi = _bounds(starts, lens, base, Ns)
    n = (hi - lo).clamp(min=0)
    is_int = dtype == torch.int32
    work = torch.int64 if is_int else dtype
    red = "sum" if op in ("count", "mean") else op
    ident = _ident(red, dtype).to(work).to(device)

    def cells(win, j):
        if Ns == 0:
            return None, False
        idx = (lo[win][:, None] + j).clamp(0, Ns - 1)
        v = vals[idx].to(work) if op != "count" else None
        return v, (keep[idx] if keep is not None else True)

    acc, cnt = chunked_fold(red, is_int, ident, lo % GROUP, n, split, chunk,
                            cells)
    part = cnt.to(dtype) if op == "count" else acc.to(dtype)
    return part, (cnt.to(torch.int32) if needs_count(op) else None)


def _check_partial(vals, keep, starts, lens):
    if vals.dim() != 1:
        raise ValueError("vals must be the shard's 1-D row slice")
    device = vals.device
    if keep is not None and (keep.dtype != torch.bool
                             or keep.shape != vals.shape
                             or keep.device != device):
        raise TypeError(f"keep must be a bool tensor of vals' shape "
                        f"{tuple(vals.shape)} on {device}, got {keep.dtype} "
                        f"{tuple(keep.shape)} on {keep.device}")
    B = starts.numel()
    for name, t in (("starts", starts), ("lens", lens)):
        if (t.dtype != torch.int32 or t.dim() != 1 or t.numel() != B
                or t.device != device):
            raise TypeError(f"{name} must be a ({B},) int32 tensor on "
                            f"{device}, got {t.dtype} {tuple(t.shape)} on "
                            f"{t.device}")
    return device


def sp_window_partial(vals, keep, starts, lens, base: int, op: str,
                      long_windows=None):
    """The partial of each window ``(starts[w], lens[w])`` over the shard's
    ``(Ns,)`` slice `vals` of rows ``[base, base + Ns)``, kept rows only
    (`keep` a bool mask or None); returns ``(partial, count)``, the (B,)
    partial in ``vals.dtype`` and, for count and mean, the (B,) int32
    kept-row count (else None).

    A CUDA `vals` launches the kernel once; a CPU one runs the plain
    version.  `long_windows` is :func:`find_long_windows` of these windows
    (a numpy array, or an int32 tensor on vals' device); without it the
    wrapper computes it from the windows, which waits for the device."""
    _check_op(op, vals.dtype)
    device = _check_partial(vals, keep, starts, lens)
    if device.type == "cpu":
        return sp_window_partial_reference(vals, keep, starts, lens, base,
                                           op)
    if device.type != "cuda":
        raise ValueError(f"sp_window_partial runs on cuda or cpu tensors, "
                         f"got {device}")
    if not all(t.is_contiguous() for t in (vals, starts, lens)) or (
            keep is not None and not keep.is_contiguous()):
        raise ValueError("sp_window_partial takes contiguous tensors")
    B = starts.numel()
    part = torch.empty(B, dtype=vals.dtype, device=device)
    cnt = (torch.empty(B, dtype=torch.int32, device=device)
           if needs_count(op) else None)
    if B == 0:
        return part, cnt
    if long_windows is None:
        long_windows = find_long_windows(starts.cpu().numpy(),
                                         lens.cpu().numpy(), base,
                                         vals.numel())
    if isinstance(long_windows, np.ndarray):
        long_windows = torch.from_numpy(
            np.ascontiguousarray(long_windows, dtype=np.int32)).to(device)
    if (long_windows.dtype != torch.int32 or long_windows.dim() != 1
            or long_windows.device != device
            or not long_windows.is_contiguous()):
        raise TypeError(f"long_windows must be a contiguous 1-D int32 "
                        f"tensor on {device}, got {long_windows.dtype} "
                        f"{tuple(long_windows.shape)} on "
                        f"{long_windows.device}")
    n_long = long_windows.numel()
    lib = _load()
    with torch.cuda.device(device):
        rc = lib.wf_sp_window_partial(
            vals.data_ptr(), keep.data_ptr() if keep is not None else None,
            vals.numel(), starts.data_ptr(), lens.data_ptr(), B, int(base),
            _OPS[op], _DTYPES[vals.dtype],
            _ident_bits("sum" if op == "count" else op, vals.dtype),
            long_windows.data_ptr() if n_long else None, n_long, SPLIT,
            CHUNK, part.data_ptr(),
            cnt.data_ptr() if cnt is not None else None,
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sp_window_partial kernel launch failed: CUDA "
                           f"error {rc}")
    sp_window_partial.launches += 1
    return part, cnt


#: kernel launches since the count was last reset
sp_window_partial.launches = 0


# -------------------------------------------------------------------- merge

def _merge_out(op, dtype):
    return torch.float32 if op == "mean" else dtype


def _mean(s, c):
    """JAX's ``s / max(c, 1)``: float32 for an int32 or float32 sum."""
    return s.to(torch.float32) / c.clamp(min=1).to(torch.float32)


def sp_merge_reference(parts, cnts, op: str, ring: bool = False):
    """Plain version: one torch reduction over the shard axis of the
    ``(n, B)`` partials (int32 sums and products in int64, wrapped); the
    order of a float fold is torch's.  ``ring`` selects only the order,
    which the plain version does not fix."""
    _check_op(op, parts.dtype)
    is_int = parts.dtype == torch.int32
    if op in ("sum", "count", "mean", "prod"):
        wide = parts.long() if is_int else parts
        red = wide.prod(dim=0) if op == "prod" else wide.sum(dim=0)
        s = _wrap32(red).to(torch.int32) if is_int else red
    elif op == "min":
        s = parts.amin(dim=0)
    else:
        s = parts.amax(dim=0)
    if op == "mean":
        return _mean(s, cnts.long().sum(dim=0))
    return s


def fold_order(n: int, ring: bool) -> list:
    """The shards in the order sp_merge folds them."""
    return [0] + (list(range(n - 1, 0, -1)) if ring else list(range(1, n)))


def merge_order_twin(parts, cnts, op: str, ring: bool = False):
    """Plain torch that folds the ``(n, B)`` partials in sp_merge's order
    (:func:`fold_order`), one shard at a time; no path of the port calls
    it."""
    _check_op(op, parts.dtype)
    is_int = parts.dtype == torch.int32
    work = torch.int64 if is_int else parts.dtype
    order = fold_order(parts.shape[0], ring)
    red = "sum" if op in ("count", "mean") else op
    acc = parts[order[0]].to(work)
    c = cnts[order[0]].long() if cnts is not None else None
    for k in order[1:]:
        acc = _combine(red, acc, parts[k].to(work), is_int)
        if c is not None:
            c = c + cnts[k].long()
    if op == "mean":
        return _mean(acc.to(parts.dtype), c)
    return acc.to(parts.dtype)


#: partials whose pointers travel in the merge kernel's parameters
#: (kInline); more go through a device array of pointers
MERGE_INLINE = 16


def _on_device(ts, name, want, B, device):
    """The n (B,) tensors of `ts` (a sequence, or the rows of an (n, B)
    tensor) as contiguous tensors on `device`: a tensor already there is
    taken as it is, rows of an (n, B) tensor as views; others are
    copied."""
    if isinstance(ts, torch.Tensor) and ts.dim() == 2:
        ts = list(ts)
    out = []
    for t in ts:
        if t.dtype != want or t.dim() != 1 or t.numel() != B:
            raise TypeError(f"{name} must be (B,) {want} tensors, got "
                            f"{t.dtype} {tuple(t.shape)}")
        out.append(t.to(device).contiguous())
    return out


def sp_merge(partials, counts, op: str, ring: bool = False, device=None):
    """Fold the sp partials of every window: `partials` is a sequence of
    ``n`` (B,) tensors (one a shard, in sp order, on any devices) or an
    ``(n, B)`` tensor, `counts` the same of int32 counts or None (needed
    for mean).  One launch on the merging `device` (default: the first
    partial's) reads every partial that lies there in place; one on
    another device is copied there first.  Returns the (B,) result in
    their dtype, float32 for mean."""
    first = partials[0]
    dtype = first.dtype
    _check_op(op, dtype)
    device = torch.device(device) if device is not None else first.device
    B = first.numel()
    parts = _on_device(partials, "partials", dtype, B, device)
    cnts = (_on_device(counts, "counts", torch.int32, B, device)
            if counts is not None else None)
    if op == "mean" and cnts is None:
        raise ValueError("sp_merge of mean needs the partial counts")
    if cnts is not None and len(cnts) != len(parts):
        raise ValueError(f"{len(parts)} partials but {len(cnts)} counts")
    if device.type == "cpu":
        return sp_merge_reference(
            torch.stack(parts), torch.stack(cnts) if cnts else None, op,
            ring)
    if device.type != "cuda":
        raise ValueError(f"sp_merge runs on cuda or cpu tensors, got "
                         f"{device}")
    n = len(parts)
    out = torch.empty(B, dtype=_merge_out(op, dtype), device=device)
    if B == 0:
        return out
    order = fold_order(n, ring)
    pp = [parts[k].data_ptr() for k in order]
    cp = ([cnts[k].data_ptr() for k in order] if op == "mean"
          else [0] * n)
    far = None
    if n > MERGE_INLINE:     # the pointers as a device array
        far = torch.tensor(pp + cp, dtype=torch.int64).to(device)
    lib = _load()
    with torch.cuda.device(device):
        rc = lib.wf_sp_merge(
            (ctypes.c_void_p * n)(*pp),
            (ctypes.c_void_p * n)(*cp) if op == "mean" else None,
            far.data_ptr() if far is not None else None, n, B, _OPS[op],
            _DTYPES[dtype], out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sp_merge kernel launch failed: CUDA error {rc}")
    sp_merge.launches += 1
    return out


#: kernel launches since the count was last reset
sp_merge.launches = 0
