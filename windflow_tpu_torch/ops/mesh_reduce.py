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
  dtype: one of :data:`DTYPES`); ``keep`` is ``None`` or the ``(Ns,)`` bool
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
  another device are copied there first.  ``mean`` returns ``sum /
  max(count, 1)`` in float32 for a 4-byte dtype and in float64 for an
  8-byte one, also for an integer dtype (JAX's ``/`` of int32 or uint32
  gives float32, of int64 or uint64 under x64 float64).

Integer sums and products wrap at the dtype's width, uint32 and uint64
compare unsigned (windowed_reduce.Work: the plain versions and twins
compute in it, torch having few ops for the unsigned dtypes).

The 1- and 2-byte dtypes give JAX's result dtypes (:func:`merge_out`).
int8, int16, uint8 and uint16 are reduced in the 4-byte integer of their
kind: the wrappers widen the values (a copy a call) and reduce from the
dtype's own identity; a sum or product partial stays int32 or uint32
(``jnp.sum`` and ``jnp.prod`` promote them), a min, max or count partial
is cast back (a count wraps, as JAX's ``astype`` does, and so does its
merge); mean divides by ``max(count, 1)`` wrapped into the dtype, as JAX's
``jnp.maximum(c, 1).astype(dtype)`` does (a uint8 window of 256 kept rows
divides by 0).  float16 is reduced in float32 and a partial rounded to
float16 once (XLA's reduction); the merge rounds to float16 after every
combine where JAX's collective combines float16 values (sum, count and
mean; prod with ``ring=True``) and once for prod's gather fold; a float16
mean is the float16 quotient of the float16 sum and count.

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
from .windowed_reduce import (DTYPE_CODES, GROUP, Work, _combine, _names,
                              chunked_fold, signed_view)

#: op codes of the C launchers (enum Op in csrc/cells.cuh)
_OPS = {"sum": 0, "count": 1, "min": 2, "max": 3, "prod": 4, "mean": 5}
#: the reduction dtypes the wrappers take: the kernels' value dtypes (their
#: codes: enum Dtype) and the 1- and 2-byte integers (held in 4 bytes)
DTYPES = (torch.int32, torch.float32, torch.uint32, torch.int64,
          torch.uint64, torch.float64, torch.float16, torch.int8,
          torch.int16, torch.uint8, torch.uint16)
#: the 4-byte integer that holds each 1- or 2-byte one in the kernels
_HELD = {torch.int8: torch.int32, torch.int16: torch.int32,
         torch.uint8: torch.uint32, torch.uint16: torch.uint32}
#: sp_merge's codes of those dtypes (enum NarrowDtype): the kernel takes
#: their partials in 4 bytes, and mean's divisor wraps into them
_NARROW_CODES = {torch.int8: 7, torch.int16: 8, torch.uint8: 9,
                 torch.uint16: 10}
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
                ctypes.c_ulonglong, c_p, c_int, c_int, c_int, c_p, c_p, c_p]
            lib.wf_sp_window_partial.restype = c_int
            lib.wf_sp_merge.argtypes = [c_p, c_p, c_p, c_int, c_int, c_int,
                                        c_int, c_int, c_p, c_p]
            lib.wf_sp_merge.restype = c_int
            _lib = lib
        return _lib


def needs_count(op: str) -> bool:
    """Whether the partial of `op` carries the kept-row count."""
    return op in ("count", "mean")


def _check_op(op: str, dtype: torch.dtype):
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}; expected one of {tuple(_OPS)}")
    if dtype not in DTYPES:
        raise TypeError(f"the mesh reduction runs in {_names(DTYPES)}, got "
                        f"{dtype}")


def _ident_bits(op: str, dtype: torch.dtype) -> int:
    """The identity of `op` over `dtype` as the bits of the kernels' work
    type, an unsigned 64-bit int: float32 for float16, the 4-byte holder
    of a 1- or 2-byte integer (its own identity: an int8 min from 127)."""
    np_dt = torch.empty(0, dtype=dtype).numpy().dtype
    work = (np.float32 if dtype == torch.float16 else
            torch.empty(0, dtype=_HELD.get(dtype, dtype)).numpy().dtype)
    a = np.array(identity(op, np_dt)).astype(work)
    return int(a.view(np.uint32 if a.itemsize == 4 else np.uint64))


def partial_dtype(op: str, dtype: torch.dtype) -> torch.dtype:
    """The dtype of a partial of `op` over values of `dtype`: int32 or
    uint32 for a sum, product or mean's sum of 1- or 2-byte integers
    (JAX's ``jnp.sum`` and ``jnp.prod`` promote them), else `dtype`."""
    if dtype in _HELD and op in ("sum", "prod", "mean"):
        return _HELD[dtype]
    return dtype


def _widened(vals: torch.Tensor) -> torch.Tensor:
    """1- or 2-byte integer values in their 4-byte holder (a copy; an
    unsigned one zero-extended)."""
    held = _HELD[vals.dtype]
    out = vals.to(torch.int32)
    return out if held == torch.int32 else out.view(held)


def _cast_back(part: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A held partial or result as `dtype` (its low bits)."""
    return Work(dtype).store(Work(part.dtype).load(part))


def _held_partial(fn, vals, keep, starts, lens, base, op, **kw):
    """`fn` (a partial: the kernel's wrapper, the plain version or the
    twin) over 1- or 2-byte integer values: widened to their holder,
    reduced from `vals.dtype`'s identity, a min, max or count cast back."""
    dtype = vals.dtype
    part, cnt = fn(_widened(vals), keep, starts, lens, base, op,
                   dtype=dtype, **kw)
    if op in ("count", "min", "max"):
        part = _cast_back(part, dtype)
    return part, cnt


def _ident_held(work, red: str, dtype: torch.dtype, device):
    """The identity of `red` over `dtype`, held as `work` holds values
    (of `dtype` or of its 4-byte holder)."""
    if work.dtype == dtype:
        return work.ident(red, device)
    return torch.tensor(int(identity(red, dtype)), dtype=torch.int64,
                        device=device)


def _bounds(starts, lens, base: int, Ns: int):
    """The windows clipped to the shard's slice: (lo, hi) as int64."""
    s = starts.long()
    lo = (s - int(base)).clamp(0, int(Ns))
    hi = (s + lens.long() - int(base)).clamp(0, int(Ns))
    return lo, hi


# ------------------------------------------------------------------ partial

def sp_window_partial_reference(vals, keep, starts, lens, base: int,
                                op: str, dtype=None):
    """Plain version, JAX's formulation: a ``(B, pad)`` gather at
    ``min(lo + iota, Ns - 1)``, the mask ``iota < hi - lo`` and the keep
    mask at the gathered rows, the identity in masked lanes, a reduction
    over axis 1.  Windows are taken in order of length, in runs of at most
    ``_PLAIN_CELLS`` gathered cells.  Returns (partial, count or None).
    (`dtype`: the reduction's, where `vals` holds a 1- or 2-byte integer
    widened.)"""
    _check_op(op, vals.dtype)
    if vals.dtype in _HELD:
        return _held_partial(sp_window_partial_reference, vals, keep,
                             starts, lens, base, op)
    reduction = dtype or vals.dtype
    dtype = vals.dtype
    device = vals.device
    work = Work(dtype)
    vals = signed_view(vals)
    B, Ns = starts.numel(), vals.numel()
    part = torch.empty(B, dtype=vals.dtype, device=device)   # signed view
    cnt = torch.zeros(B, dtype=torch.int32, device=device)
    lo, hi = _bounds(starts, lens, base, Ns)
    n = (hi - lo).clamp(min=0)
    red = "sum" if op in ("count", "mean") else op
    ident = _ident_held(work, red, reduction, device)
    if Ns == 0 or B == 0:
        part[:] = signed_view(work.store(ident))
        return part.view(dtype), (cnt if needs_count(op) else None)
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
            part[sel] = signed_view(work.store(c))
        else:
            v = torch.where(mask, work.load(vals[idx]), ident)
            part[sel] = signed_view(work.store(work.reduce(red, v, 1)))
        i = j
    return part.view(dtype), (cnt if needs_count(op) else None)


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
                       split: int = SPLIT, chunk: int = CHUNK, dtype=None):
    """Plain torch that reproduces sp_window_partial's combine order
    (csrc/mesh_reduce.cu, "Order"); no path of the port calls it.  With a
    = lo mod 4, cell j of a window lies in its group (a + j) // 4.  A window
    of at most `split` cells is one team's (windowed_reduce.team_fold over
    all its groups); a longer one is cut into chunks of `chunk` cells
    (``chunk // 4`` groups from the window's first aligned group), each
    chunk reduced in the team's order, and the chunk partials are folded in
    chunk order starting from the identity.  Filtered cells are skipped and
    not counted.  Returns (partial, count or None).  1- and 2-byte integers
    as the kernel's wrapper takes them (widened; `dtype`: the reduction's
    where `vals` holds one widened)."""
    _check_op(op, vals.dtype)
    if vals.dtype in _HELD:
        return _held_partial(partial_order_twin, vals, keep, starts, lens,
                             base, op, split=split, chunk=chunk)
    reduction = dtype or vals.dtype
    dtype = vals.dtype
    device = vals.device
    work = Work(dtype)
    vals = signed_view(vals)
    Ns = vals.numel()
    lo, hi = _bounds(starts, lens, base, Ns)
    n = (hi - lo).clamp(min=0)
    red = "sum" if op in ("count", "mean") else op

    def cells(win, j):
        if Ns == 0:
            return None, False
        idx = (lo[win][:, None] + j).clamp(0, Ns - 1)
        v = work.load(vals[idx]) if op != "count" else None
        return v, (keep[idx] if keep is not None else True)

    acc, cnt = chunked_fold(red, work, _ident_held(work, red, reduction,
                                                   device),
                            lo % GROUP, n, split, chunk, cells)
    part = work.store(cnt if op == "count" else acc)
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
                      long_windows=None, dtype=None):
    """The partial of each window ``(starts[w], lens[w])`` over the shard's
    ``(Ns,)`` slice `vals` of rows ``[base, base + Ns)``, kept rows only
    (`keep` a bool mask or None); returns ``(partial, count)``, the (B,)
    partial in ``vals.dtype`` and, for count and mean, the (B,) int32
    kept-row count (else None).

    A CUDA `vals` launches the kernel once; a CPU one runs the plain
    version.  `long_windows` is :func:`find_long_windows` of these windows
    (a numpy array, or an int32 tensor on vals' device); without it the
    wrapper computes it from the windows, which waits for the device.
    1- and 2-byte integer `vals` are widened first (a copy) and the
    partial is in :func:`partial_dtype` (`dtype` is the reduction's where
    `vals` holds one widened)."""
    _check_op(op, vals.dtype)
    device = _check_partial(vals, keep, starts, lens)
    if vals.dtype in _HELD:
        return _held_partial(sp_window_partial, vals, keep, starts, lens,
                             base, op, long_windows=long_windows)
    if device.type == "cpu":
        return sp_window_partial_reference(vals, keep, starts, lens, base,
                                           op, dtype=dtype)
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
            _OPS[op], DTYPE_CODES[vals.dtype],
            _ident_bits("sum" if op == "count" else op, dtype or vals.dtype),
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

def merge_out(op, dtype):
    """sp_merge's result dtype for a reduction in `dtype` (JAX's): the
    partials' (:func:`partial_dtype`), or for mean float16 for float16,
    float64 for an 8-byte dtype and float32 for any other."""
    if op != "mean":
        return partial_dtype(op, dtype)
    if dtype == torch.float16:
        return torch.float16
    return torch.float64 if Work(dtype).itemsize == 8 else torch.float32


def _rounds_each_step(op: str, ring: bool) -> bool:
    """Whether JAX's collective for `op` combines float16 values (psum,
    the ring's hops), rounding after every combine, rather than folding a
    gather in float32 (prod's all_gather) and rounding once."""
    return op != "prod" or ring


def _mean(s, c, work, dtype):
    """JAX's ``s / max(c, 1).astype(dtype)`` over a held sum `s`: the
    count wrapped into a 1- or 2-byte integer dtype, both converted to
    :func:`merge_out`'s float first; for float16 a float16 quotient."""
    d = c.clamp(min=1)
    if dtype in _HELD:
        d = Work(dtype).load(Work(dtype).store(d))
    if dtype == torch.float16:
        return (s / d.to(torch.float16).float()).to(torch.float16)
    f = merge_out("mean", dtype)
    return work.to_float(s, f) / d.to(f)


def _held_merge(fn, parts, cnts, op, ring, dtype):
    """`fn` (the plain merge or its twin) over `parts` of the reduction
    `dtype` (default: theirs): 1- or 2-byte integer partials (a min, max
    or count) widened to their holder and the result cast back."""
    dtype = dtype or parts.dtype
    _check_merge(parts.dtype, op, dtype)
    if parts.dtype not in _HELD:
        return fn(parts, cnts, op, ring, dtype)
    return _cast_back(fn(_widened(parts), cnts, op, ring, dtype), dtype)


def _check_merge(pdtype, op, dtype):
    _check_op(op, dtype)
    if pdtype != partial_dtype(op, dtype):
        raise TypeError(f"partials of {op} over {dtype} are "
                        f"{partial_dtype(op, dtype)}, got {pdtype}")


def sp_merge_reference(parts, cnts, op: str, ring: bool = False,
                       dtype=None):
    """Plain version: one torch reduction over the shard axis of the
    ``(n, B)`` partials, in the dtype's work type (integer sums and
    products wrapped at its width); the order of a float fold is torch's.
    ``ring`` selects only the order, which the plain version does not fix,
    except for float16 partials that JAX's collective rounds after every
    combine (:func:`merge_order_twin`'s fold).  `dtype` is the reduction's
    (default: the partials')."""
    return _held_merge(_merge_plain, parts, cnts, op, ring, dtype)


def _merge_plain(parts, cnts, op, ring, dtype):
    if parts.dtype == torch.float16 and _rounds_each_step(op, ring):
        return _merge_ordered(parts, cnts, op, ring, dtype)
    work = Work(parts.dtype)
    red = "sum" if op in ("count", "mean") else op
    s = work.reduce(red, work.load(parts), 0)
    if op == "mean":
        return _mean(s, cnts.long().sum(dim=0), work, dtype)
    return work.store(s)


def fold_order(n: int, ring: bool) -> list:
    """The shards in the order sp_merge folds them."""
    return [0] + (list(range(n - 1, 0, -1)) if ring else list(range(1, n)))


def merge_order_twin(parts, cnts, op: str, ring: bool = False, dtype=None):
    """Plain torch that folds the ``(n, B)`` partials in sp_merge's order
    (:func:`fold_order`), one shard at a time, float16 rounded after each
    combine where JAX's collective rounds; no path of the port calls
    it."""
    return _held_merge(_merge_ordered, parts, cnts, op, ring, dtype)


def _merge_ordered(parts, cnts, op, ring, dtype):
    work = Work(parts.dtype)
    order = fold_order(parts.shape[0], ring)
    red = "sum" if op in ("count", "mean") else op
    step = parts.dtype == torch.float16 and _rounds_each_step(op, ring)
    acc = work.load(parts[order[0]])
    c = cnts[order[0]].long() if cnts is not None else None
    for k in order[1:]:
        acc = _combine(red, acc, work.load(parts[k]), work)
        if step:
            acc = acc.to(torch.float16).float()
        if c is not None:
            c = c + cnts[k].long()
    if op == "mean":
        return _mean(acc, c, work, dtype)
    return work.store(acc)


#: partials whose pointers travel in the merge kernel's parameters
#: (kInline; 8 for 8-byte partials); more go through a device array of
#: pointers
MERGE_INLINE = 16


def merge_inline(dtype: torch.dtype) -> int:
    return MERGE_INLINE // 2 if Work(dtype).itemsize == 8 else MERGE_INLINE


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


def sp_merge(partials, counts, op: str, ring: bool = False, device=None,
             dtype=None):
    """Fold the sp partials of every window: `partials` is a sequence of
    ``n`` (B,) tensors (one a shard, in sp order, on any devices) or an
    ``(n, B)`` tensor, `counts` the same of int32 counts or None (needed
    for mean).  One launch on the merging `device` (default: the first
    partial's) reads every partial that lies there in place; one on
    another device is copied there first, and 1- or 2-byte integer
    partials (a min, max or count) are widened to their holder (a copy).
    `dtype` is the reduction's (default: the partials'; a mean over a 1-
    or 2-byte integer dtype needs it, its partials being int32 or
    uint32).  Returns the (B,) result in :func:`merge_out`'s dtype."""
    first = partials[0]
    pdtype = first.dtype
    dtype = dtype or pdtype
    _check_merge(pdtype, op, dtype)
    device = torch.device(device) if device is not None else first.device
    B = first.numel()
    parts = _on_device(partials, "partials", pdtype, B, device)
    cnts = (_on_device(counts, "counts", torch.int32, B, device)
            if counts is not None else None)
    if op == "mean" and cnts is None:
        raise ValueError("sp_merge of mean needs the partial counts")
    if cnts is not None and len(cnts) != len(parts):
        raise ValueError(f"{len(parts)} partials but {len(cnts)} counts")
    if device.type == "cpu":
        return sp_merge_reference(
            torch.stack(parts), torch.stack(cnts) if cnts else None, op,
            ring, dtype)
    if device.type != "cuda":
        raise ValueError(f"sp_merge runs on cuda or cpu tensors, got "
                         f"{device}")
    if pdtype in _HELD:
        parts = [_widened(p) for p in parts]
    held = parts[0].dtype
    n = len(parts)
    out = torch.empty(B, dtype=merge_out(op, dtype if op == "mean"
                                         else held), device=device)
    if B == 0:
        return _cast_back(out, pdtype) if pdtype in _HELD else out
    order = fold_order(n, ring)
    pp = [parts[k].data_ptr() for k in order]
    cp = ([cnts[k].data_ptr() for k in order] if op == "mean"
          else [0] * n)
    far = None
    if n > merge_inline(held):     # the pointers as a device array
        far = torch.tensor(pp + cp, dtype=torch.int64).to(device)
    lib = _load()
    with torch.cuda.device(device):
        rc = lib.wf_sp_merge(
            (ctypes.c_void_p * n)(*pp),
            (ctypes.c_void_p * n)(*cp) if op == "mean" else None,
            far.data_ptr() if far is not None else None, n, B, _OPS[op],
            _NARROW_CODES.get(dtype, DTYPE_CODES[held]),
            int(_rounds_each_step(op, ring)), out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sp_merge kernel launch failed: CUDA error {rc}")
    sp_merge.launches += 1
    return _cast_back(out, pdtype) if pdtype in _HELD else out


#: kernel launches since the count was last reset
sp_merge.launches = 0
