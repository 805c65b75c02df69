"""Kernels of the device-resident ring archive: the hand-written CUDA
kernels of csrc/resident.cuh (their entry points in csrc/resident.cu),
their plain PyTorch versions, and the loader that builds them on first
use.

These port the XLA-jitted device bodies of ``windflow_tpu/ops/resident.py``:

* :func:`ring_append` — the vmapped ``dynamic_update_slice`` + ``astype``
  of ``_ring_append``: row ``r`` of a (KP, Rb) rectangle, widened from its
  wire dtype to the ring's accumulate dtype, is written at column
  ``offs[r]`` of a (KP, cap) ring.  The ring is updated in place.  On the
  card it is the kernel below with no window.
* :func:`ring_append_regular_sum` — the whole of ``_regular_body`` in one
  launch: the same append, then the (KP, C) regular window sums of the
  ring after it, window ``i`` of row ``r`` covering ``ring[r, s:e]`` with
  ``s = clip(rstart0[r] + i*slide, 0, cap)`` and
  ``e = clip(s + rlen[r], 0, cap)``.  Integer sums wrap modulo 2**bits
  of the ring dtype, as XLA's cumsum difference does.  With an empty
  ``(KP, 0)`` rectangle it computes those window sums alone.

* :func:`ring_append_eval` — the whole of ``_append_eval`` in one launch:
  the same append, then every op of the dispatch (sum, count, min, max,
  prod; up to :data:`EVALS_PER_LAUNCH`) over the ``(row, start, len)``
  windows of the ring after it, window ``w`` covering columns
  ``min(max(starts[w], 0) + j, cap - 1)`` for ``j < min(lens[w], pad)``.
  A window longer than :data:`LONG_SPLIT` cells is cut into chunks of
  :data:`LONG_CHUNK` cells spread over the card (:class:`LongWindows` lists
  them; the caller that holds the windows on the host builds it).
  :func:`append_eval_order_twin` reproduces its combine order.

* :func:`ring_append_multi_eval` — the whole of ``_make_multi_step``'s
  step in one launch: a ring a field (more than
  :data:`FIELDS_PER_LAUNCH` take a launch a group of them), every field's
  rectangle appended at the shared offsets, every ``(field, op)`` stat
  over the windows of the rings after it (as :func:`ring_append_eval`
  evaluates; more than :data:`EVALS_PER_LAUNCH` take further launches
  with no append), and the masked ``(B, pad)`` tiles
  of a window function's fields (``window_gather``'s function) with their
  mask.  :func:`multi_append_eval_order_twin` reproduces its combine
  order.

:func:`ring_eval_reference` is a plain transcription of ``_ring_eval``.

Dtypes: a ring holds int8, int16, int32, int64, uint8, uint16, uint32,
uint64, float16, float32 or float64 cells (:data:`RING_DTYPES`) and takes
the wires the JAX package's narrowing ladder gives it (:func:`wires_of`;
the ladder ships signed wires only): int8/int16/int32/float32 into a ring
of 1-4 byte cells, int8/int16/int32/int64/float64 into an 8-byte one.  A
wire wider than the ring, or a signed wire into an unsigned ring, wraps;
a float wire into an integer ring truncates toward zero, saturating at
the ring's range, NaN to 0; any wire into a float16 ring rounds to
nearest even (XLA's conversions).  An op's result is in the ring dtype
except a product over int8 or int16 cells, which is int32, and one over
uint8 or uint16 cells, which is uint32 (:func:`out_dtype`; ``jnp.prod``
promotes them to the default int of their kind without x64).  Unsigned
rings compare unsigned; a float16 ring is reduced in float32 and each
result rounded to float16 once (a window sum is summed directly, where
JAX takes a difference of two float16 prefix sums: ROADMAP, "Recorded
divergences").  bfloat16, and any other ring dtype or pair, raises, on
the card and off it.

A CUDA tensor launches the kernel on the current stream (asynchronous,
counted in ``<wrapper>.launches``); a CPU tensor runs the plain version.
There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading

import numpy as np
import torch

from . import _nvcc
from .gather import FIELDS_PER_LAUNCH, window_gather_reference
from .monoid import identity
from .windowed_reduce import (GROUP, _OPS, _UNSIGNED, Work, _check_op,
                              chunked_fold, out_dtype, signed_view,
                              windowed_reduce_many_reference)

#: wire dtypes of the rectangle (enum Wire in csrc/resident.cuh)
_WIRES = {torch.int8: 0, torch.int16: 1, torch.int32: 2, torch.float32: 3,
          torch.int64: 4, torch.float64: 5}
#: accumulate dtypes of the ring (enum Acc)
_ACCS = {torch.int32: 0, torch.float32: 1, torch.int8: 2, torch.int16: 3,
         torch.int64: 4, torch.float64: 5, torch.uint8: 6, torch.uint16: 7,
         torch.uint32: 8, torch.uint64: 9, torch.float16: 10}
#: the ring dtypes the kernels take
RING_DTYPES = tuple(_ACCS)
_NARROW_WIRES = (torch.int8, torch.int16, torch.int32, torch.float32)
_WIDE_WIRES = (torch.int8, torch.int16, torch.int32, torch.int64,
               torch.float64)

# the kernels' geometry (constants of csrc/resident.cuh; the tests' CPU twin
# of their index arithmetic reads them here)
#: cells a thread appends (a warp: 32 * CHUNK)
CHUNK = 16
#: consecutive windows of one row a warp of ring_append_regular_sum sums
WIN_PER_WARP = 2
#: ops ring_append_eval evaluates in one launch (kMaxEvals)
EVALS_PER_LAUNCH = 8
#: ring_append_eval: a window of at most LONG_SPLIT cells is reduced by a
#: team of 8 lanes, a longer one in chunks of LONG_CHUNK cells (a multiple
#: of 32) spread over the card and folded in chunk order (PERF.md: chosen
#: on the H100)
LONG_SPLIT = 512
LONG_CHUNK = 512

_lock = threading.Lock()
_lib = None


#: the library's translation units, built in parallel (one unit of all 47
#: wire/ring pairs would build them in turn): the entry points and the
#: per-field kernel of int32 and float32 rings; the per-field kernel of any
#: ring dtype; the single-ring kernels and that kernel's evaluations once
#: for each ring dtype, the evaluations in its register budget
UNITS = (("resident.cu", ()), ("resident_multi.cu", ()),
         *(("resident_ring.cu", (f"-DWF_RING_ACC={code}",))
           for code in sorted(_ACCS.values())),
         *(("resident_field.cu", (f"-DWF_RING_ACC={code}",
                                  "-maxrregcount=64"))
           for code in sorted(_ACCS.values())))


def build() -> str:
    """Compile the csrc/resident*.cu units if these sources have not been
    built yet; returns the path of the shared library (ops/_nvcc.py)."""
    return _nvcc.build_units("resident", UNITS, headers=("resident.cuh",))


def wires_of(ring_dtype: torch.dtype) -> tuple:
    """The wire dtypes a ring of `ring_dtype` takes: the JAX package's
    narrowing ladder (``ResidentWindowExecutor.narrow``) with floats in
    the ring's precision."""
    return _WIDE_WIRES if ring_dtype.itemsize == 8 else _NARROW_WIRES


def _work_np(op: str, ring_dtype: torch.dtype):
    """numpy dtype of the kernels' working type for `op` (its identity's
    bits, a long window's partials): integer sums and products in uint32
    or uint64, min and max in int32 or int64 (uint32 or uint64 for an
    unsigned ring), floats in the ring's (float32 for float16)."""
    wide = ring_dtype.itemsize == 8
    if ring_dtype.is_floating_point:
        return np.float64 if wide else np.float32
    if op in ("min", "max") and ring_dtype.is_signed:
        return np.int64 if wide else np.int32
    return np.uint64 if wide else np.uint32


def _ident_word(op: str, ring_dtype: torch.dtype) -> int:
    """The identity of `op` over a ring of `ring_dtype` as the bits of the
    working type (kernel argument, zero-extended to 64 bits)."""
    work = np.dtype(_work_np(op, ring_dtype))
    value = np.array(identity(op, ring_dtype)).astype(work)
    bits = np.uint64 if work.itemsize == 8 else np.uint32
    return int(value.view(bits))


def _widen(blk: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`blk` in the ring's dtype as XLA's ``astype`` gives it: integers
    wrap (a signed wire into an unsigned ring too), any wire into a float
    ring rounds to nearest even, floats into an integer dtype truncate
    toward zero, saturating at the dtype's range, NaN to 0 (a plain ``to``
    leaves those out of range undefined).  An unsigned result of 2 bytes
    or more is built as its signed view (torch converts few ops into
    those dtypes)."""
    signed = _UNSIGNED.get(dtype)
    if dtype.is_floating_point:
        return blk.to(dtype)
    if not blk.is_floating_point():
        return blk.to(signed).view(dtype) if signed else blk.to(dtype)
    bits = 8 * torch.empty(0, dtype=dtype).element_size()
    lo, hi = ((0.0, 2.0 ** bits) if not dtype.is_signed
              else (-2.0 ** (bits - 1), 2.0 ** (bits - 1)))
    x = torch.nan_to_num(blk.double(), nan=0.0, posinf=np.inf,
                         neginf=-np.inf)
    high, low = x >= hi, x < lo
    x = torch.where(high | low, 0.0, x).trunc()
    if signed is None:
        out = x.to(dtype)
        out[high] = torch.iinfo(dtype).max
        out[low] = torch.iinfo(dtype).min
        return out
    # unsigned of 2-8 bytes: the value as int64 bits (a uint64 past 2**63
    # as its bits), saturated, then its low bytes
    top = x >= 2.0 ** 63
    out = torch.where(top, x - 2.0 ** 63, x).to(torch.int64)
    out = torch.where(top, out | (-2 ** 63), out)
    out[high] = -1 if bits == 64 else (1 << bits) - 1
    out[low] = 0
    return out.to(signed).view(dtype)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            c_int, c_ll, c_p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
            lib.wf_ring_append.argtypes = [c_p, c_p, c_p, c_int, c_ll, c_int,
                                           c_int, c_int, c_p]
            lib.wf_ring_append.restype = c_int
            lib.wf_ring_append_regular_sum.argtypes = [
                c_p, c_p, c_p, c_p, c_p, c_p, c_int, c_ll, c_int, c_int,
                c_int, c_int, c_int, c_p]
            lib.wf_ring_append_regular_sum.restype = c_int
            lib.wf_ring_append_eval.argtypes = (
                [c_p, c_p, c_p, c_int, c_ll, c_int, c_int, c_int, c_p, c_p,
                 c_p, c_p, c_int, c_p, c_p, c_p, c_int, c_int, c_p, c_p,
                 c_p] + [c_int] * 4 + [c_p])
            lib.wf_ring_append_eval.restype = c_int
            lib.wf_ring_append_multi_eval.argtypes = (
                [c_p] * 4 + [c_int, c_p, c_int, c_ll, c_int] + [c_p] * 5
                + [c_int, c_p, c_p, c_int] + [c_p] * 4 + [c_int, c_int]
                + [c_p] * 3 + [c_int] * 4 + [c_p])
            lib.wf_ring_append_multi_eval.restype = c_int
            _lib = lib
        return _lib


def _check_ring(ring: torch.Tensor):
    if ring.dtype not in _ACCS or ring.dim() != 2:
        raise TypeError(f"the ring must be a 2-D tensor of one of "
                        f"{[str(d) for d in RING_DTYPES]}, got {ring.dtype} "
                        f"{tuple(ring.shape)}")


def _check_vec(name, t, rows, device):
    if (t.dtype != torch.int32 or t.dim() != 1 or t.numel() != rows
            or t.device != device):
        raise TypeError(f"{name} must be a ({rows},) int32 tensor on "
                        f"{device}, got {t.dtype} {tuple(t.shape)} on "
                        f"{t.device}")


def _check_append(ring, blk, offs):
    _check_ring(ring)
    KP = ring.shape[0]
    wires = wires_of(ring.dtype)
    if blk.dtype not in wires or blk.dim() != 2 or blk.shape[0] != KP:
        raise TypeError(f"blk must be a ({KP}, Rb) tensor of one of "
                        f"{[str(d) for d in wires]} (a {ring.dtype} ring's "
                        f"wires), got {blk.dtype} {tuple(blk.shape)}")
    _check_vec("offs", offs, KP, ring.device)
    if blk.device != ring.device:
        raise TypeError(f"blk lies on {blk.device}, the ring on "
                        f"{ring.device}")


def _check_windows(ring, rstart0, rlen):
    _check_ring(ring)
    _check_vec("rstart0", rstart0, ring.shape[0], ring.device)
    _check_vec("rlen", rlen, ring.shape[0], ring.device)


def _on_card(name, *tensors) -> bool:
    """False for CPU tensors (the plain version runs); True for contiguous
    CUDA tensors (the kernel launches); raises on anything else."""
    device = tensors[0].device
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    return True


def _stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ------------------------------------------------------------------ append

def ring_append_reference(ring: torch.Tensor, blk: torch.Tensor,
                          offs: torch.Tensor) -> torch.Tensor:
    """Plain version of the append: a scatter of the widened rectangle at
    per-row column offsets, in place.  Raises on a column past the ring
    (``scatter_`` checks its indices; the JAX body would clamp)."""
    Rb = blk.shape[1]
    idx = offs.long()[:, None] + torch.arange(Rb, device=ring.device)[None, :]
    signed_view(ring).scatter_(1, idx, signed_view(_widen(blk, ring.dtype)))
    return ring


def ring_append(ring: torch.Tensor, blk: torch.Tensor,
                offs: torch.Tensor) -> torch.Tensor:
    """Write row ``r`` of the (KP, Rb) rectangle `blk` at column ``offs[r]``
    of the (KP, cap) `ring`, widened to the ring's dtype; returns `ring`,
    updated in place."""
    _check_append(ring, blk, offs)
    if not _on_card("ring_append", ring, blk, offs):
        return ring_append_reference(ring, blk, offs)
    KP, cap = ring.shape
    Rb = blk.shape[1]
    if KP == 0 or Rb == 0:
        return ring
    lib = _load()
    with torch.cuda.device(ring.device):
        rc = lib.wf_ring_append(ring.data_ptr(), blk.data_ptr(),
                                offs.data_ptr(), KP, cap, Rb,
                                _WIRES[blk.dtype], _ACCS[ring.dtype],
                                _stream_of(ring))
    if rc != 0:
        raise RuntimeError(f"ring_append kernel launch failed: CUDA error "
                           f"{rc}")
    ring_append.launches += 1
    return ring


#: kernel launches since the count was last reset
ring_append.launches = 0


# ------------------------------------------------------- regular windows

def regular_window_sum_reference(ring: torch.Tensor, rstart0: torch.Tensor,
                                 rlen: torch.Tensor, C: int,
                                 slide: int) -> torch.Tensor:
    """Plain version: an exclusive prefix sum of every ring row, in int64
    (integer rings) or float64 (float rings), and a two-point difference
    at the clipped window bounds, cast back to the ring's dtype — the low
    bits of the int64 difference are the wrapped integer sum."""
    KP, cap = ring.shape
    cs = _prefix_sums(ring)
    i = torch.arange(C, dtype=torch.int64, device=ring.device)
    s = (rstart0.long()[:, None] + i[None, :] * int(slide)).clamp(0, cap)
    e = (s + rlen.long()[:, None]).clamp(0, cap)
    return Work(ring.dtype).store(cs.gather(1, e) - cs.gather(1, s))


def _prefix_sums(ring: torch.Tensor) -> torch.Tensor:
    """The (KP, cap + 1) exclusive prefix sums of the ring's rows, in
    float64 for a float ring, else in int64 over the held values
    (windowed_reduce.Work: an unsigned cell zero-extended)."""
    KP, cap = ring.shape
    float_ring = ring.is_floating_point()
    wide = torch.float64 if float_ring else torch.int64
    cs = torch.zeros((KP, cap + 1), dtype=wide, device=ring.device)
    vals = ring if float_ring else Work(ring.dtype).load(signed_view(ring))
    torch.cumsum(vals, dim=1, dtype=wide, out=cs[:, 1:])
    return cs



def ring_append_regular_sum_reference(ring: torch.Tensor, blk: torch.Tensor,
                                      offs: torch.Tensor,
                                      rstart0: torch.Tensor,
                                      rlen: torch.Tensor, C: int,
                                      slide: int) -> torch.Tensor:
    """Plain version of the fused kernel: the plain append, then the plain
    window sums of the ring after it."""
    return regular_window_sum_reference(
        ring_append_reference(ring, blk, offs), rstart0, rlen, C, slide)


def regular_sum_order_twin(ring: torch.Tensor, blk: torch.Tensor,
                           offs: torch.Tensor, rstart0: torch.Tensor,
                           rlen: torch.Tensor, C: int,
                           slide: int) -> torch.Tensor:
    """Plain torch that reproduces ring_append_regular_sum's combine order
    (csrc/resident.cuh, "The regular window sums"), so that the kernel can
    be held to it bit for bit; no path of the port calls it.  The plain
    append, then for each window lane l of its warp adds cells s + l, s +
    l + 32, ... in turn in the working type (float32 for a float16 ring),
    a butterfly over 16, 8, 4, 2, 1 combines the 32 lanes, and the sum is
    rounded to the ring dtype once.  An integer ring's sums wrap, the same
    in any order: the plain version's."""
    ring_append_reference(ring, blk, offs)
    if not ring.is_floating_point():
        return regular_window_sum_reference(ring, rstart0, rlen, C, slide)
    KP, cap = ring.shape
    device = ring.device
    work = Work(ring.dtype)
    i = torch.arange(C, dtype=torch.int64, device=device)
    s = (rstart0.long()[:, None] + i[None, :] * int(slide)).clamp(0, cap)
    n = ((s + rlen.long()[:, None]).clamp(0, cap) - s).reshape(-1)
    s = s.reshape(-1)
    rows = torch.arange(KP, device=device).repeat_interleave(C)
    lane = torch.arange(32, device=device)
    lanes = torch.zeros((KP * C, 32), dtype=work.held, device=device)
    for t in range(-(-int(n.max()) // 32) if n.numel() else 0):
        j = 32 * t + lane
        col = (s[:, None] + j[None, :]).clamp(max=cap - 1)
        v = work.load(ring[rows[:, None], col])
        lanes = torch.where(j[None, :] < n[:, None], lanes + v, lanes)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, lane ^ off]
    return work.store(lanes[:, 0]).reshape(KP, C)


def ring_append_regular_sum(ring: torch.Tensor, blk: torch.Tensor,
                            offs: torch.Tensor, rstart0: torch.Tensor,
                            rlen: torch.Tensor, C: int,
                            slide: int) -> torch.Tensor:
    """:func:`ring_append` of `blk` at `offs`, then the (KP, C) sums of the
    regular windows of the ring after it (window ``i`` of row ``r`` starts
    at ``rstart0[r] + i*slide`` with length ``rlen[r]`` >= 0, both clipped
    to ``[0, cap]``), in one kernel launch; `ring` is updated in place.  A
    ``(KP, 0)`` rectangle gives the window sums alone.  Nothing is
    launched or counted when there is no cell to write."""
    _check_append(ring, blk, offs)
    _check_windows(ring, rstart0, rlen)
    if not _on_card("ring_append_regular_sum", ring, blk, offs, rstart0,
                    rlen):
        return ring_append_regular_sum_reference(ring, blk, offs, rstart0,
                                                 rlen, C, slide)
    KP, cap = ring.shape
    if cap > 2 ** 30:
        raise ValueError(f"ring rows of {cap} cells: the window-sum kernel "
                         "takes rows of at most 2**30 cells")
    out = torch.empty((KP, C), dtype=ring.dtype, device=ring.device)
    Rb = blk.shape[1]
    if KP == 0 or (C == 0 and Rb == 0):
        return out
    lib = _load()
    with torch.cuda.device(ring.device):
        rc = lib.wf_ring_append_regular_sum(
            ring.data_ptr(), blk.data_ptr(), offs.data_ptr(),
            rstart0.data_ptr(), rlen.data_ptr(), out.data_ptr(), KP, cap, Rb,
            int(C), int(slide), _WIRES[blk.dtype], _ACCS[ring.dtype],
            _stream_of(ring))
    if rc != 0:
        raise RuntimeError(f"ring_append_regular_sum kernel launch failed: "
                           f"CUDA error {rc}")
    ring_append_regular_sum.launches += 1
    return out


#: kernel launches since the count was last reset
ring_append_regular_sum.launches = 0


# ------------------------------------------------------ irregular windows

def ring_eval_reference(op: str, ring: torch.Tensor, rows: torch.Tensor,
                        starts: torch.Tensor, lens: torch.Tensor,
                        pad: int) -> torch.Tensor:
    """Plain transcription of the JAX ``_ring_eval``: a cumsum two-point
    gather for sum (in int64/float64, cast back), a masked (B, pad) gather
    with the column clamped to ``cap - 1`` and the monoid identity in the
    masked lanes for min/max/prod, reduced over the held values
    (windowed_reduce.Work).  Windows lie in their row (``starts + lens <=
    cap``).  A product over int8 or int16 cells is int32, over uint8 or
    uint16 cells uint32 (:func:`out_dtype`)."""
    cap = ring.shape[1]
    rows, starts, lens = rows.long(), starts.long(), lens.long()
    if op == "sum":
        cs = _prefix_sums(ring)
        return Work(ring.dtype).store(cs[rows, starts + lens]
                                      - cs[rows, starts])
    work = Work(ring.dtype)
    lane = torch.arange(pad, device=ring.device)
    idx = (starts[:, None] + lane[None, :]).clamp(max=cap - 1)
    vals = work.load(signed_view(ring)[rows[:, None], idx])
    vals = torch.where(lane[None, :] < lens[:, None], vals,
                       work.ident(op, ring.device))
    return work.store(work.reduce(op, vals, 1), out_dtype(op, ring.dtype))


# ------------------------------------------------------ irregular dispatch

@dataclasses.dataclass(frozen=True)
class LongWindows:
    """The windows of one :func:`ring_append_eval` launch longer than
    `split` cells, in the layout the kernel reads: ``vec`` (int32) holds
    the ``n`` long windows' indices, ascending, then each one's first
    chunk and, last, the number of chunks (``n + 1`` entries).  A window's
    chunks hold `chunk` cells each from its first 4-cell group of the
    ring.  ``dev`` is the same vector where the caller has put it on the
    ring's device (None: the wrapper copies ``vec`` there)."""

    vec: np.ndarray
    n: int
    chunks: int
    split: int = LONG_SPLIT
    chunk: int = LONG_CHUNK
    dev: torch.Tensor | None = None

    def on(self, dev: torch.Tensor) -> "LongWindows":
        """This list with its copy on the device."""
        return dataclasses.replace(self, dev=dev)


def long_windows(rows, starts, lens, pad: int, cap: int, split: int = LONG_SPLIT,
                 chunk: int = LONG_CHUNK) -> LongWindows:
    """The :class:`LongWindows` of windows ``(rows, starts, lens)`` (host
    arrays) over a ring of `cap` columns: a window of ``min(lens, pad)``
    cells from ``max(starts, 0)`` is long past `split` cells, and with a
    = the flat index of its first cell mod 4 its chunks are ``ceil(ceil((a
    + len) / 4) / (chunk / 4))``."""
    if chunk <= 0 or chunk % (GROUP * 8) or split < 0:
        raise ValueError(f"chunk must be a positive multiple of 32 and "
                         f"split >= 0, got chunk={chunk}, split={split}")
    rows = np.asarray(rows, dtype=np.int64)
    s = np.maximum(np.asarray(starts, dtype=np.int64), 0)
    n = np.clip(np.asarray(lens, dtype=np.int64), 0, int(pad))
    idx = np.flatnonzero(n > split)
    a = (rows[idx] * int(cap) + s[idx]) % GROUP
    cg = chunk // GROUP
    nch = ((a + n[idx] + GROUP - 1) // GROUP + cg - 1) // cg
    first = np.zeros(len(idx) + 1, dtype=np.int64)
    np.cumsum(nch, out=first[1:])
    return LongWindows(np.concatenate([idx, first]).astype(np.int32),
                       len(idx), int(first[-1]), int(split), int(chunk))


_NO_LONG = LongWindows(np.zeros(1, dtype=np.int32), 0, 0)

#: per (device, stream): the long windows' counters, int32 zeros that
#: every launch leaves at zero (launches on one stream run in order)
_counters = {}


def _long_counters(device: torch.device, stream: int, n: int):
    with _lock:
        key = (device.index, stream)
        t = _counters.get(key)
        if t is None or t.numel() < n:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("ring_append_eval under graph capture "
                                   "takes its counters= from the caller")
            t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
            _counters[key] = t
        return t


def _long_plan(long: LongWindows, device, stream: int, counters):
    """(the device addresses of `long`'s window list and of its first
    chunks, the counters, the list's device tensor) for a launch on
    `stream` (call in `device`'s context): the list is copied to the
    device where the caller has not, and the stream's own counters are
    taken where the caller gives none.  Without a long window the kernels
    read neither: (None, None, counters, None)."""
    if not long.n:
        return None, None, counters, None
    plan = long.dev
    if plan is None:
        plan = torch.from_numpy(long.vec).to(device)
    if (plan.dtype != torch.int32 or plan.numel() != 2 * long.n + 1
            or plan.device != device or not plan.is_contiguous()):
        raise TypeError(f"long.dev must be a contiguous ({2 * long.n + 1},) "
                        f"int32 tensor on {device}")
    if counters is None:
        counters = _long_counters(device, stream, long.n)
    if (counters.dtype != torch.int32 or counters.numel() < long.n
            or counters.device != device):
        raise TypeError(f"counters must be an int32 tensor of at least "
                        f"{long.n} zeros on {device}")
    at = plan.data_ptr()
    return at, at + 4 * long.n, counters, plan


def _eval_buffers(specs, B: int, chunks: int, device):
    """Outputs and partials of a launch's evaluations, in one byte buffer
    (each segment 16-byte aligned): for every ``(op, ring dtype)`` of
    `specs` a (B,) output in :func:`out_dtype` and room for `chunks`
    partials in the working type.  Returns (outputs, partials' byte
    views)."""
    sizes = []
    for op, dt in specs:
        wide = 8 if dt.itemsize == 8 else 4
        sizes.append((B * out_dtype(op, dt).itemsize, chunks * wide))
    total = sum(-(-a // 16) * 16 + -(-b // 16) * 16 for a, b in sizes)
    buf = torch.empty(max(total, 16), dtype=torch.uint8, device=device)
    outs, parts, at = [], [], 0
    for (op, dt), (a, b) in zip(specs, sizes):
        outs.append(buf[at:at + a].view(out_dtype(op, dt)))
        at += -(-a // 16) * 16
        parts.append(buf[at:at + b])
        at += -(-b // 16) * 16
    return outs, parts


def ring_append_eval_reference(ring: torch.Tensor, blk: torch.Tensor,
                               offs: torch.Tensor, evals, rows: torch.Tensor,
                               starts: torch.Tensor, lens: torch.Tensor,
                               pad: int) -> list:
    """Plain version of the kernel: the plain append, then the plain
    windowed reduction of every op over the ring after it."""
    ring_append_reference(ring, blk, offs)
    return windowed_reduce_many_reference([(ring, op) for op in evals], rows,
                                          starts, lens, pad)


def append_eval_order_twin(ring: torch.Tensor, blk: torch.Tensor,
                           offs: torch.Tensor, evals, rows: torch.Tensor,
                           starts: torch.Tensor, lens: torch.Tensor,
                           pad: int, split: int = LONG_SPLIT,
                           chunk: int = LONG_CHUNK) -> list:
    """Plain torch that reproduces the kernel's combine order
    (csrc/resident.cuh, "Order"), so that the kernel can be held to it bit
    for bit; no path of the port calls it.  The plain append, then for
    each op: with n = min(lens, pad) cells from s = max(starts, 0) and a =
    (rows * cap + s) mod 4, cell j lies in group (a + j) // 4; a window of
    at most `split` cells is one team's (windowed_reduce.team_fold over
    all its groups), a longer one is cut into chunks of ``chunk // 4``
    groups, each reduced in the team's order, and the chunk partials are
    folded in chunk order from the identity
    (windowed_reduce.chunked_fold)."""
    ring_append_reference(ring, blk, offs)
    return [_ordered(ring, op, rows, starts, lens, pad, split, chunk)
            for op in evals]


def _ordered(ring, op, rows, starts, lens, pad, split, chunk):
    """One op over the windows of `ring` in the kernels' order (see
    append_eval_order_twin)."""
    _check_op(op)
    if op == "count":
        return lens.to(ring.dtype)
    cap = ring.shape[1]
    r = rows.long()
    s = starts.long().clamp(min=0)
    n = lens.long().clamp(0, int(pad))
    # integers in int64: reduced modulo 2**32 after every step for cells
    # of 1-4 bytes (the kernels' uint32), int64's own wrap for 8
    work = Work(ring.dtype)

    cells_of = signed_view(ring)

    def cells(win, j):
        col = (s[win][:, None] + j).clamp(0, cap - 1)
        return work.load(cells_of[r[win][:, None], col]), True

    acc, _ = chunked_fold(op, work, work.ident(op, ring.device),
                          (r * cap + s) % GROUP, n, split, chunk, cells)
    return work.store(acc, out_dtype(op, ring.dtype))


def _check_eval(ring, evals, rows, starts, lens, pad):
    evals = list(evals)
    if len(evals) > EVALS_PER_LAUNCH:
        raise ValueError(f"ring_append_eval takes at most "
                         f"{EVALS_PER_LAUNCH} ops a launch, got "
                         f"{len(evals)}")
    for op in evals:
        _check_op(op)
    B = starts.numel()
    for name, t in (("rows", rows), ("starts", starts), ("lens", lens)):
        _check_vec(name, t, B, ring.device)
    if int(pad) < 0:
        raise ValueError(f"pad must be >= 0, got {pad}")
    return evals


def ring_append_eval(ring: torch.Tensor, blk: torch.Tensor,
                     offs: torch.Tensor, evals, rows: torch.Tensor,
                     starts: torch.Tensor, lens: torch.Tensor, pad: int,
                     long: LongWindows | None = None,
                     counters: torch.Tensor | None = None) -> list:
    """:func:`ring_append` of `blk` at `offs`, then every op of `evals`
    (sum, count, min, max, prod; at most :data:`EVALS_PER_LAUNCH`) over the
    B windows ``(rows[w], starts[w], min(lens[w], pad))`` of the ring after
    it, a column past the row's end reading its last cell; returns one (B,)
    tensor an op in :func:`out_dtype` (count: ``lens``), and `ring` is
    updated in place.  One kernel launch on a CUDA ring (none when there
    is no cell to write and no window); the plain version on a CPU one.

    `long` is :func:`long_windows` of these windows, which the caller that
    holds them on the host passes (without it the wrapper reads the
    windows back, which waits for the device).  `counters` is an int32
    tensor of at least ``long.n`` zeros on the ring's device that the
    launch leaves at zero (None: the wrapper's own for the current
    stream).  The outputs are views of one buffer that also holds the
    long windows' chunk partials: keep them alive while the launch runs."""
    _check_append(ring, blk, offs)
    evals = _check_eval(ring, evals, rows, starts, lens, pad)
    if not _on_card("ring_append_eval", ring, blk, offs, rows, starts,
                    lens):
        return ring_append_eval_reference(ring, blk, offs, evals, rows,
                                          starts, lens, pad)
    KP, cap = ring.shape
    Rb, B, n = blk.shape[1], starts.numel(), len(evals)
    if not B or all(op == "count" for op in evals):
        long = _NO_LONG
    elif long is None:
        long = long_windows(rows.cpu().numpy(), starts.cpu().numpy(),
                            lens.cpu().numpy(), pad, cap)
    outs, parts = _eval_buffers([(op, ring.dtype) for op in evals], B,
                                long.chunks, ring.device)
    if KP * Rb == 0 and (B == 0 or n == 0):
        return outs
    lib = _load()
    with torch.cuda.device(ring.device):
        stream = _stream_of(ring)
        win_at, first_at, counters, _plan = _long_plan(
            long, ring.device, stream, counters)
        ops = (ctypes.c_int * max(n, 1))(*(_OPS[op] for op in evals))
        ids = (ctypes.c_ulonglong * max(n, 1))(*(
            _ident_word("sum" if op == "count" else op, ring.dtype)
            for op in evals))
        ptrs = (ctypes.c_void_p * max(n, 1))(*(o.data_ptr() for o in outs))
        pparts = (ctypes.c_void_p * max(n, 1))(*(t.data_ptr()
                                                 for t in parts))
        rc = lib.wf_ring_append_eval(
            ring.data_ptr(), blk.data_ptr() if Rb else None,
            offs.data_ptr() if KP else None, KP, cap, Rb, _WIRES[blk.dtype],
            _ACCS[ring.dtype], ops, ids, ptrs, pparts, n,
            rows.data_ptr() if B else None, starts.data_ptr() if B else None,
            lens.data_ptr() if B else None, B, int(pad), win_at, first_at,
            counters.data_ptr() if counters is not None else None, long.n,
            long.chunks, long.split, long.chunk, stream)
    if rc != 0:
        raise RuntimeError(f"ring_append_eval kernel launch failed: CUDA "
                           f"error {rc}")
    ring_append_eval.launches += 1
    return outs


#: kernel launches since the count was last reset
ring_append_eval.launches = 0


# ------------------------------------------------------- per-field dispatch

def ring_append_multi_eval_reference(rings, blks, offs: torch.Tensor, evals,
                                     rows: torch.Tensor, starts: torch.Tensor,
                                     lens: torch.Tensor, pad: int,
                                     tile_fields=()):
    """Plain version of the kernel: the plain append of every field, the
    plain windowed reduction of every ``(field, op)`` over the rings after
    it, then the plain gather of the tile fields.  Returns ``(outs, tiles,
    mask)`` as :func:`ring_append_multi_eval` does."""
    for ring, blk in zip(rings, blks):
        ring_append_reference(ring, blk, offs)
    outs = (windowed_reduce_many_reference(
        [(rings[f], op) for f, op in evals], rows, starts, lens, pad)
        if evals else [])
    if not tile_fields:
        return outs, (), None
    tiles, mask = window_gather_reference([rings[f] for f in tile_fields],
                                          rows, starts, lens, pad)
    return outs, tiles, mask


def multi_append_eval_order_twin(rings, blks, offs: torch.Tensor, evals,
                                 rows: torch.Tensor, starts: torch.Tensor,
                                 lens: torch.Tensor, pad: int,
                                 tile_fields=(), split: int = LONG_SPLIT,
                                 chunk: int = LONG_CHUNK):
    """Plain torch that reproduces the kernel's combine order, so that the
    kernel can be held to it bit for bit; no path of the port calls it.
    The plain append of every field, then each ``(field, op)`` in
    :func:`append_eval_order_twin`'s order over its field's ring (the
    rings share their shape, so a window's groups and chunks are the same
    in every field), and the plain tiles (a copy: no order)."""
    for ring, blk in zip(rings, blks):
        ring_append_reference(ring, blk, offs)
    outs = [_ordered(rings[f], op, rows, starts, lens, pad, split, chunk)
            for f, op in evals]
    if not tile_fields:
        return outs, (), None
    tiles, mask = window_gather_reference([rings[f] for f in tile_fields],
                                          rows, starts, lens, pad)
    return outs, tiles, mask


def _check_multi(rings, blks, offs, evals, tile_fields):
    rings, blks = tuple(rings), tuple(blks)
    if not rings:
        raise ValueError("ring_append_multi_eval takes at least one field")
    if len(blks) != len(rings):
        raise ValueError(f"{len(rings)} rings and {len(blks)} rectangles")
    shape, device = rings[0].shape, rings[0].device
    Rb = blks[0].shape[1] if blks[0].dim() == 2 else -1
    for ring, blk in zip(rings, blks):
        _check_append(ring, blk, offs)
        if ring.shape != shape or ring.device != device:
            raise TypeError(f"the rings must share one shape and device, "
                            f"got {tuple(ring.shape)} on {ring.device} and "
                            f"{tuple(shape)} on {device}")
        if blk.shape[1] != Rb:
            raise TypeError(f"the rectangles must share their width, got "
                            f"{blk.shape[1]} and {Rb}")
    evals = [(int(f), op) for f, op in evals]
    tile_fields = tuple(int(f) for f in tile_fields)
    for f in [f for f, _op in evals] + list(tile_fields):
        if not 0 <= f < len(rings):
            raise ValueError(f"field {f} of a launch of {len(rings)} fields")
    return rings, blks, evals, tile_fields


def ring_append_multi_eval(rings, blks, offs: torch.Tensor, evals,
                           rows: torch.Tensor, starts: torch.Tensor,
                           lens: torch.Tensor, pad: int, tile_fields=(),
                           long: LongWindows | None = None,
                           counters: torch.Tensor | None = None):
    """The per-field resident step: :func:`ring_append` of ``blks[f]``
    into ``rings[f]`` for every field (the rings share one ``(KP, cap)``
    shape, each of its own ring dtype, and the
    rectangles one ``(KP, Rb)`` shape, each in a wire dtype of its ring) at
    the
    shared `offs`; then every ``(field, op)`` of `evals` over the B windows
    ``(rows[w], starts[w], min(lens[w], pad))`` of the field's ring after
    it, as :func:`ring_append_eval` evaluates; and for each field of
    `tile_fields` the ``(B, pad)`` tile whose lane j of window w is
    ``ring[rows[w], clip(starts[w] + j, 0, cap - 1)]`` where ``j <
    lens[w]``, else 0, with the ``(B, pad)`` bool mask ``j < lens[w]``.

    Returns ``(outs, tiles, mask)``: one (B,) tensor a stat in
    :func:`out_dtype` of its op and ring, one tile a tile field in its
    ring's dtype, the mask (None
    without a tile field); the rings are updated in place.  On CUDA rings
    one kernel launch for every :data:`FIELDS_PER_LAUNCH` fields, which
    appends them and evaluates their first :data:`EVALS_PER_LAUNCH` stats
    and their tiles, and one more for every further EVALS_PER_LAUNCH of
    their stats (none when there is nothing to do); on CPU rings the
    plain version.  `long` and `counters` are
    :func:`ring_append_eval`'s, for these windows (shared by every stat).
    The outputs are views of buffers that also hold the long windows'
    chunk partials: keep them alive while the launch runs."""
    rings, blks, evals, tile_fields = _check_multi(rings, blks, offs, evals,
                                                   tile_fields)
    for _f, op in evals:
        _check_op(op)
    _check_eval(rings[0], [], rows, starts, lens, pad)
    if not _on_card("ring_append_multi_eval", *rings, *blks, offs, rows,
                    starts, lens):
        return ring_append_multi_eval_reference(rings, blks, offs, evals,
                                                rows, starts, lens, pad,
                                                tile_fields)
    device = rings[0].device
    KP, cap = rings[0].shape
    Rb, B, n, pad = blks[0].shape[1], starts.numel(), len(evals), int(pad)
    if not B or all(op == "count" for _f, op in evals):
        long = _NO_LONG
    elif long is None:
        long = long_windows(rows.cpu().numpy(), starts.cpu().numpy(),
                            lens.cpu().numpy(), pad, cap)
    outs, parts = _eval_buffers([(op, rings[f].dtype) for f, op in evals],
                                B, long.chunks, device)
    tiles = tuple(torch.empty((B, pad), dtype=rings[f].dtype, device=device)
                  for f in tile_fields)
    mask = (torch.empty((B, pad), dtype=torch.bool, device=device)
            if tile_fields else None)
    if KP * Rb == 0 and (B == 0 or (n == 0 and (not tile_fields
                                                or pad == 0))):
        return outs, tiles, mask
    lib = _load()
    with torch.cuda.device(device):
        stream = _stream_of(rings[0])
        win_at, first_at, counters, _plan = _long_plan(long, device,
                                                       stream, counters)
        desc = [t.data_ptr() if B else None for t in (rows, starts, lens)]
        tail = (B, pad, win_at, first_at,
                counters.data_ptr() if counters is not None else None,
                long.n, long.chunks, long.split, long.chunk, stream)
        # a launch takes FIELDS_PER_LAUNCH fields: each group of them has
        # its own launches, the first appending the group's rectangles and
        # writing its tiles (and the mask), then one for every
        # EVALS_PER_LAUNCH of its stats past the first over the rings
        # after it (Rb = 0), in stream order
        for g0 in range(0, len(rings), FIELDS_PER_LAUNCH):
            nf = min(FIELDS_PER_LAUNCH, len(rings) - g0)
            grp = range(g0, g0 + nf)
            ring_ps = (ctypes.c_void_p * nf)(*(rings[f].data_ptr()
                                               for f in grp))
            blk_ps = (ctypes.c_void_p * nf)(*(blks[f].data_ptr() if Rb
                                              else None for f in grp))
            wires = (ctypes.c_int * nf)(*(_WIRES[blks[f].dtype]
                                          for f in grp))
            accs = (ctypes.c_int * nf)(*(_ACCS[rings[f].dtype]
                                         for f in grp))
            es = [e for e, (f, _op) in enumerate(evals) if f in grp]
            ts = ([t for t, f in enumerate(tile_fields) if f in grp]
                  if B and pad else [])
            tsrc = (ctypes.c_int * max(len(ts), 1))(*(tile_fields[t] - g0
                                                      for t in ts))
            tptr = (ctypes.c_void_p * max(len(ts), 1))(*(tiles[t].data_ptr()
                                                         for t in ts))
            for i in range(0, max(len(es), 1) if B else 1,
                           EVALS_PER_LAUNCH):
                group = es[i:i + EVALS_PER_LAUNCH]
                m, first = len(group), i == 0
                nt = len(ts) if first else 0
                e_ops = (ctypes.c_int * max(m, 1))(*(_OPS[evals[e][1]]
                                                     for e in group))
                e_src = (ctypes.c_int * max(m, 1))(*(evals[e][0] - g0
                                                     for e in group))
                e_ids = (ctypes.c_ulonglong * max(m, 1))(*(
                    _ident_word("sum" if evals[e][1] == "count"
                                else evals[e][1], rings[evals[e][0]].dtype)
                    for e in group))
                e_out = (ctypes.c_void_p * max(m, 1))(*(outs[e].data_ptr()
                                                        for e in group))
                e_part = (ctypes.c_void_p * max(m, 1))(*(
                    parts[e].data_ptr() for e in group))
                rb = Rb if first else 0
                rc = lib.wf_ring_append_multi_eval(
                    ring_ps, blk_ps, wires, accs, nf,
                    offs.data_ptr() if KP and rb else None, KP, cap, rb,
                    e_ops, e_src, e_ids, e_out, e_part, m, tsrc, tptr, nt,
                    mask.data_ptr() if nt else None, *desc, *tail)
                if rc != 0:
                    raise RuntimeError(f"ring_append_multi_eval kernel "
                                       f"launch failed: CUDA error {rc}")
                if (KP and rb) or (B and (m or nt)):
                    ring_append_multi_eval.launches += 1
    return outs, tiles, mask


#: kernel launches since the count was last reset
ring_append_multi_eval.launches = 0
