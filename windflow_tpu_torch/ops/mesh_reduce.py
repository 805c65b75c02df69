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
  the dtype, ``mean`` the sum (the merge divides).
* :func:`sp_merge` — folds the ``n_sp`` partials of every window, shard
  0, 1, ..., n-1 (``ring=False``: psum/pmin/pmax, prod's gather fold) or
  0, n-1, ..., 1 (``ring=True``: the order in which sp shard 0 accumulates
  its ``n_sp - 1`` ppermute hops, whose value JAX returns), in one launch
  on the merging device.  Partials on another device are copied there
  first.  ``mean`` returns float32 ``sum / max(count, 1)``, also for an
  int32 dtype (JAX's ``/`` of int32 gives float32).

A CUDA tensor launches the kernel on the current stream (asynchronous,
counted in ``<wrapper>.launches``); a CPU tensor runs the plain version.
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

#: op codes of the C launchers (enum Op in the .cu source)
_OPS = {"sum": 0, "count": 1, "min": 2, "max": 3, "prod": 4, "mean": 5}
#: value dtypes the kernels are instantiated for (enum Dtype)
_DTYPES = {torch.int32: 0, torch.float32: 1}
#: lanes that reduce one window in sp_window_partial (a warp)
LANES = 32
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
                ctypes.c_uint, c_p, c_p, c_p]
            lib.wf_sp_window_partial.restype = c_int
            lib.wf_sp_merge.argtypes = [c_p, c_p, c_int, c_int, c_int, c_int,
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


def _wrap32(x):
    """int64 values reduced modulo 2**32 into the int32 range."""
    return torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31


def _combine(op, a, b, is_int):
    """The kernels' combine(a, b): a + b and a * b (int32 wrapping), and for
    min/max ``a`` where a is NaN or wins, else ``b``."""
    if op in ("sum", "mean", "count"):
        return _wrap32(a + b) if is_int else a + b
    if op == "prod":
        return _wrap32(a * b) if is_int else a * b
    first = a < b if op == "min" else a > b
    if not is_int:
        first = first | torch.isnan(a)
    return torch.where(first, a, b)


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


def partial_order_twin(vals, keep, starts, lens, base: int, op: str):
    """Plain torch that reproduces sp_window_partial's combine order
    (csrc/mesh_reduce.cu, "Order"); no path of the port calls it.  Lane l of
    a window combines its kept cells ``lo + l + 32 t`` in ascending t from
    the identity; then a butterfly over 16, 8, 4, 2, 1, each lane combining
    its own value with its partner's, own first; lane 0's value is the
    result.  int32 sums and products run in int64 reduced modulo 2**32
    after every step.  Returns (partial, count or None)."""
    dtype = vals.dtype
    _check_op(op, dtype)
    device = vals.device
    B, Ns = starts.numel(), vals.numel()
    lo, hi = _bounds(starts, lens, base, Ns)
    n = (hi - lo).clamp(min=0)
    is_int = dtype == torch.int32
    work = torch.int64 if is_int else dtype
    red_op = "sum" if op == "count" else op
    lanes = _ident(red_op, dtype).to(work).to(device).expand(B, LANES).clone()
    counts = torch.zeros((B, LANES), dtype=torch.int64, device=device)
    lane = torch.arange(LANES, device=device)
    trips = (n + LANES - 1) // LANES
    order = torch.argsort(trips, descending=True)
    lo_o, hi_o = lo[order], hi[order]
    acc, cacc = lanes[order], counts[order]
    tr = trips[order]
    for t in range(int(tr.max()) if B else 0):
        m = int((tr > t).sum())          # windows that still have a trip
        c = lo_o[:m, None] + t * LANES + lane[None, :]
        live = c < hi_o[:m, None]
        cc = c.clamp(max=max(Ns - 1, 0))
        if keep is not None:
            live = live & keep[cc]
        cacc[:m] += live.long()
        if op != "count":
            v = vals[cc].to(work)
            acc[:m] = torch.where(live, _combine(op, acc[:m], v, is_int),
                                  acc[:m])
    off = LANES // 2
    while off:
        if op != "count":
            acc = _combine(op, acc, acc[:, lane ^ off], is_int)
        cacc = cacc + cacc[:, lane ^ off]
        off //= 2
    part = torch.empty(B, dtype=dtype, device=device)
    cnt = torch.empty(B, dtype=torch.int32, device=device)
    part[order] = (cacc[:, 0].to(dtype) if op == "count"
                   else acc[:, 0].to(dtype))
    cnt[order] = cacc[:, 0].to(torch.int32)
    return part, (cnt if needs_count(op) else None)


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


def sp_window_partial(vals, keep, starts, lens, base: int, op: str):
    """The partial of each window ``(starts[w], lens[w])`` over the shard's
    ``(Ns,)`` slice `vals` of rows ``[base, base + Ns)``, kept rows only
    (`keep` a bool mask or None); returns ``(partial, count)``, the (B,)
    partial in ``vals.dtype`` and, for count and mean, the (B,) int32
    kept-row count (else None).  A CUDA `vals` launches the kernel once;
    a CPU one runs the plain version."""
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
    lib = _load()
    with torch.cuda.device(device):
        rc = lib.wf_sp_window_partial(
            vals.data_ptr(), keep.data_ptr() if keep is not None else None,
            vals.numel(), starts.data_ptr(), lens.data_ptr(), B, int(base),
            _OPS[op], _DTYPES[vals.dtype],
            _ident_bits("sum" if op == "count" else op, vals.dtype),
            part.data_ptr(), cnt.data_ptr() if cnt is not None else None,
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
    acc = parts[order[0]].to(work)
    c = cnts[order[0]].long() if cnts is not None else None
    for k in order[1:]:
        acc = _combine(op, acc, parts[k].to(work), is_int)
        if c is not None:
            c = c + cnts[k].long()
    if op == "mean":
        return _mean(acc.to(parts.dtype), c)
    return acc.to(parts.dtype)


def sp_merge(partials, counts, op: str, ring: bool = False, device=None):
    """Fold the sp partials of every window: `partials` is a sequence of
    ``n`` (B,) tensors (one a shard, in sp order, on any devices) or an
    ``(n, B)`` tensor, `counts` the same of int32 counts or None (needed
    for mean).  Partials off the merging `device` (default: the first
    partial's) are copied there, then one launch folds them; returns the
    (B,) result in their dtype, float32 for mean."""
    first = partials[0]
    dtype = first.dtype
    _check_op(op, dtype)
    device = torch.device(device) if device is not None else first.device

    def stack(ts, name, want):
        if isinstance(ts, torch.Tensor) and ts.dim() == 2:
            ts = list(ts)
        for t in ts:
            if t.dtype != want or t.dim() != 1 or t.numel() != first.numel():
                raise TypeError(f"{name} must be (B,) {want} tensors, got "
                                f"{t.dtype} {tuple(t.shape)}")
        return torch.stack([t.to(device) for t in ts])

    parts = stack(partials, "partials", dtype)
    cnts = (stack(counts, "counts", torch.int32)
            if counts is not None else None)
    if op == "mean" and cnts is None:
        raise ValueError("sp_merge of mean needs the partial counts")
    if device.type == "cpu":
        return sp_merge_reference(parts, cnts, op, ring)
    if device.type != "cuda":
        raise ValueError(f"sp_merge runs on cuda or cpu tensors, got "
                         f"{device}")
    n, B = parts.shape
    out = torch.empty(B, dtype=_merge_out(op, dtype), device=device)
    if B == 0:
        return out
    lib = _load()
    with torch.cuda.device(device):
        rc = lib.wf_sp_merge(
            parts.data_ptr(),
            cnts.data_ptr() if (cnts is not None and op == "mean") else None,
            n, B, _OPS[op], _DTYPES[dtype], int(bool(ring)), out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sp_merge kernel launch failed: CUDA error {rc}")
    sp_merge.launches += 1
    return out


#: kernel launches since the count was last reset
sp_merge.launches = 0
