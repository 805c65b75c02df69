"""Kernels of the device-resident ring archive: the hand-written CUDA
kernels of csrc/resident.cu, their plain PyTorch versions, and the loader
that builds them on first use.

These port the XLA-jitted device bodies of ``windflow_tpu/ops/resident.py``:

* :func:`ring_append` — the vmapped ``dynamic_update_slice`` + ``astype``
  of ``_ring_append``: row ``r`` of a (KP, Rb) rectangle, widened from its
  wire dtype (int8/int16/int32/float32) to the ring's accumulate dtype
  (int32/float32), is written at column ``offs[r]`` of a (KP, cap) ring.
  The ring is updated in place.  On the card it is the kernel below with
  no window.
* :func:`ring_append_regular_sum` — the whole of ``_regular_body`` in one
  launch: the same append, then the (KP, C) regular window sums of the
  ring after it, window ``i`` of row ``r`` covering ``ring[r, s:e]`` with
  ``s = clip(rstart0[r] + i*slide, 0, cap)`` and
  ``e = clip(s + rlen[r], 0, cap)``.  int32 sums wrap modulo 2**32, as
  XLA's int32 cumsum difference does.  With an empty ``(KP, 0)``
  rectangle it computes those window sums alone.

The irregular evaluation (``_ring_eval``) is the windowed-reduce kernel
over (row, start, len) descriptors (ops/windowed_reduce.py,
ops/resident.py); :func:`ring_eval_reference` is a plain transcription of
``_ring_eval`` that it is held against.

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

# the kernels' geometry (constants of csrc/resident.cu; the tests' CPU twin
# of their index arithmetic reads them here)
#: cells a thread appends (a warp: 32 * CHUNK)
CHUNK = 16
#: consecutive windows of one row a warp of ring_append_regular_sum sums
WIN_PER_WARP = 2

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
            lib.wf_ring_append_regular_sum.argtypes = [
                c_p, c_p, c_p, c_p, c_p, c_p, c_int, c_ll, c_int, c_int,
                c_int, c_int, c_int, c_p]
            lib.wf_ring_append_regular_sum.restype = c_int
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


def _check_append(ring, blk, offs):
    _check_ring(ring)
    KP = ring.shape[0]
    if blk.dtype not in _WIRES or blk.dim() != 2 or blk.shape[0] != KP:
        raise TypeError(f"blk must be a ({KP}, Rb) int8/int16/int32/float32 "
                        f"tensor, got {blk.dtype} {tuple(blk.shape)}")
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
    ring.scatter_(1, idx, blk.to(ring.dtype))
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


def ring_append_regular_sum_reference(ring: torch.Tensor, blk: torch.Tensor,
                                      offs: torch.Tensor,
                                      rstart0: torch.Tensor,
                                      rlen: torch.Tensor, C: int,
                                      slide: int) -> torch.Tensor:
    """Plain version of the fused kernel: the plain append, then the plain
    window sums of the ring after it."""
    return regular_window_sum_reference(
        ring_append_reference(ring, blk, offs), rstart0, rlen, C, slide)


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
