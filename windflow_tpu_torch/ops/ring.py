"""Kernels of the device-resident ring archive: the hand-written CUDA
kernels of csrc/resident.cu, their plain PyTorch versions, and the loader
that builds them on first use.

These port the XLA-jitted device bodies of ``windflow_tpu/ops/resident.py``:

* :func:`ring_append` — the vmapped ``dynamic_update_slice`` + ``astype``
  of ``_regular_body`` and ``_ring_append``: row ``r`` of a (KP, Rb)
  rectangle, widened from its wire dtype (int8/int16/int32/float32) to the
  ring's accumulate dtype (int32/float32), is written at column ``offs[r]``
  of a (KP, cap) ring.  The ring is updated in place.
* :func:`regular_window_sum` — the cumsum + two-point gather of
  ``_regular_body``: window ``i`` of row ``r`` covers
  ``ring[r, s:e]`` with ``s = clip(rstart0[r] + i*slide, 0, cap)`` and
  ``e = clip(s + rlen[r], 0, cap)``; returns the (KP, C) sums.  int32 sums
  wrap modulo 2**32, as XLA's int32 cumsum difference does.

The irregular evaluation (``_ring_eval``) is the windowed-reduce kernel on
the ring's flat view (ops/resident.py); :func:`ring_eval_reference` is a
plain transcription of ``_ring_eval`` that it is held against.

A CUDA tensor launches the kernel on the current stream (asynchronous,
counted in ``<wrapper>.launches``); a CPU tensor runs the plain version.
There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _nvcc
from .monoid import identity

#: wire dtypes of the rectangle (enum Wire in the .cu source)
_WIRES = {torch.int8: 0, torch.int16: 1, torch.int32: 2, torch.float32: 3}
#: accumulate dtypes of the ring (enum Acc)
_ACCS = {torch.int32: 0, torch.float32: 1}

_lock = threading.Lock()
_lib = None


def build() -> str:
    """Compile csrc/resident.cu if this source has not been built yet;
    returns the path of the shared library (ops/_nvcc.py)."""
    return _nvcc.build("resident.cu")


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            c_int, c_ll, c_p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
            lib.wf_ring_append.argtypes = [c_p, c_p, c_p, c_int, c_ll, c_int,
                                           c_int, c_int, c_p]
            lib.wf_ring_append.restype = c_int
            lib.wf_regular_window_sum.argtypes = [c_p, c_p, c_p, c_p, c_int,
                                                  c_ll, c_int, c_int, c_int,
                                                  c_p]
            lib.wf_regular_window_sum.restype = c_int
            _lib = lib
        return _lib


def _check_ring(ring: torch.Tensor):
    if ring.dtype not in _ACCS or ring.dim() != 2:
        raise TypeError(f"the ring must be a 2-D int32 or float32 tensor, "
                        f"got {ring.dtype} {tuple(ring.shape)}")


def _check_vec(name, t, rows, device):
    if (t.dtype != torch.int32 or t.dim() != 1 or t.numel() != rows
            or t.device != device):
        raise TypeError(f"{name} must be a ({rows},) int32 tensor on "
                        f"{device}, got {t.dtype} {tuple(t.shape)} on "
                        f"{t.device}")


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
    ring.scatter_(1, idx, blk.to(ring.dtype))
    return ring


def ring_append(ring: torch.Tensor, blk: torch.Tensor,
                offs: torch.Tensor) -> torch.Tensor:
    """Write row ``r`` of the (KP, Rb) rectangle `blk` at column ``offs[r]``
    of the (KP, cap) `ring`, widened to the ring's dtype; returns `ring`,
    updated in place."""
    _check_ring(ring)
    KP, cap = ring.shape
    if blk.dtype not in _WIRES or blk.dim() != 2 or blk.shape[0] != KP:
        raise TypeError(f"blk must be a ({KP}, Rb) int8/int16/int32/float32 "
                        f"tensor, got {blk.dtype} {tuple(blk.shape)}")
    _check_vec("offs", offs, KP, ring.device)
    if blk.device != ring.device:
        raise TypeError(f"blk lies on {blk.device}, the ring on "
                        f"{ring.device}")
    if ring.device.type == "cpu":
        return ring_append_reference(ring, blk, offs)
    if ring.device.type != "cuda":
        raise ValueError(f"ring_append runs on cuda or cpu tensors, got "
                         f"{ring.device}")
    if not (ring.is_contiguous() and blk.is_contiguous()
            and offs.is_contiguous()):
        raise ValueError("ring_append takes contiguous tensors")
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
    (int32 rings) or float64 (float32 rings), and a two-point difference at
    the clipped window bounds, cast back to the ring's dtype — the low 32
    bits of the int64 difference are the wrapped int32 sum."""
    KP, cap = ring.shape
    wide = torch.int64 if ring.dtype == torch.int32 else torch.float64
    cs = torch.zeros((KP, cap + 1), dtype=wide, device=ring.device)
    torch.cumsum(ring, dim=1, dtype=wide, out=cs[:, 1:])
    i = torch.arange(C, dtype=torch.int64, device=ring.device)
    s = (rstart0.long()[:, None] + i[None, :] * int(slide)).clamp(0, cap)
    e = (s + rlen.long()[:, None]).clamp(0, cap)
    return (cs.gather(1, e) - cs.gather(1, s)).to(ring.dtype)


def regular_window_sum(ring: torch.Tensor, rstart0: torch.Tensor,
                       rlen: torch.Tensor, C: int,
                       slide: int) -> torch.Tensor:
    """(KP, C) sums of the regular windows of every ring row: window ``i``
    of row ``r`` starts at ``rstart0[r] + i*slide`` with length ``rlen[r]``
    (>= 0), both clipped to ``[0, cap]``."""
    _check_ring(ring)
    KP, cap = ring.shape
    _check_vec("rstart0", rstart0, KP, ring.device)
    _check_vec("rlen", rlen, KP, ring.device)
    if ring.device.type == "cpu":
        return regular_window_sum_reference(ring, rstart0, rlen, C, slide)
    if ring.device.type != "cuda":
        raise ValueError(f"regular_window_sum runs on cuda or cpu tensors, "
                         f"got {ring.device}")
    if not (ring.is_contiguous() and rstart0.is_contiguous()
            and rlen.is_contiguous()):
        raise ValueError("regular_window_sum takes contiguous tensors")
    out = torch.empty((KP, C), dtype=ring.dtype, device=ring.device)
    if KP == 0 or C == 0:
        return out
    lib = _load()
    with torch.cuda.device(ring.device):
        rc = lib.wf_regular_window_sum(
            ring.data_ptr(), rstart0.data_ptr(), rlen.data_ptr(),
            out.data_ptr(), KP, cap, int(C), int(slide), _ACCS[ring.dtype],
            _stream_of(ring))
    if rc != 0:
        raise RuntimeError(f"regular_window_sum kernel launch failed: CUDA "
                           f"error {rc}")
    regular_window_sum.launches += 1
    return out


#: kernel launches since the count was last reset
regular_window_sum.launches = 0


# ------------------------------------------------------ irregular windows

def ring_eval_reference(op: str, ring: torch.Tensor, rows: torch.Tensor,
                        starts: torch.Tensor, lens: torch.Tensor,
                        pad: int) -> torch.Tensor:
    """Plain transcription of the JAX ``_ring_eval``: a cumsum two-point
    gather for sum (in int64/float64, cast back), a masked (B, pad) gather
    with the column clamped to ``cap - 1`` and the monoid identity in the
    masked lanes for min/max/prod.  Windows lie in their row
    (``starts + lens <= cap``)."""
    KP, cap = ring.shape
    rows, starts, lens = rows.long(), starts.long(), lens.long()
    if op == "sum":
        wide = torch.int64 if ring.dtype == torch.int32 else torch.float64
        cs = torch.zeros((KP, cap + 1), dtype=wide, device=ring.device)
        torch.cumsum(ring, dim=1, dtype=wide, out=cs[:, 1:])
        return (cs[rows, starts + lens] - cs[rows, starts]).to(ring.dtype)
    lane = torch.arange(pad, device=ring.device)
    idx = (starts[:, None] + lane[None, :]).clamp(max=cap - 1)
    vals = ring[rows[:, None], idx]
    ident = torch.tensor(identity(op, ring.dtype).item(), dtype=ring.dtype,
                         device=ring.device)
    vals = torch.where(lane[None, :] < lens[:, None], vals, ident)
    if op == "prod":
        if ring.dtype == torch.int32:
            return vals.long().prod(dim=1).to(torch.int32)
        return vals.prod(dim=1)
    return vals.amin(dim=1) if op == "min" else vals.amax(dim=1)
