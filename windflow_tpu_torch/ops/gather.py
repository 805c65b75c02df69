"""The masked window gather that feeds a user window function: the
hand-written CUDA kernel (csrc/gather.cu), its plain PyTorch version, and
the loader that builds the kernel on first use.

This ports the gather of two XLA-jitted device bodies of the JAX package:
``windflow_tpu/ops/device.py:156-161`` (the restaging executor's ``run``,
over a flat buffer) and ``windflow_tpu/ops/resident.py:618-625``
(``_make_multi_step.step``, over a ``(KP, cap)`` resident ring).  For every
window ``b`` and lane ``j < pad`` of an ``(R, ncols)`` buffer::

    out[b, j]  = buf[rows[b], min(starts[b] + j, ncols - 1)]  if j < lens[b]
                 0                                             otherwise
    mask[b, j] = j < lens[b]

``rows=None`` reads row 0 (the restaging buffer is one row).  The
resident per-field step cuts the same tiles inside its own kernel
(``ring.ring_append_multi_eval``), so this kernel serves the restaging
path.  Values are
int32 or float32.  :func:`window_gather` takes one buffer or a sequence of
buffers of one shape (the fields of one window batch) and returns their
``(B, pad)`` tiles with the bool mask.

The kernel (csrc/gather.cu) writes up to :data:`FIELDS_PER_LAUNCH`
buffers' tiles and the mask in one launch: one block per window and run of
1,024 lanes, the window's descriptors loaded once, each thread storing 4
lanes of every field with one 16-byte store and 4 mask lanes with one
4-byte store (lane by lane only where a row of an odd ``pad`` straddles a
16-byte edge).  Values move as 32-bit words, so int32 and float32 buffers
share a launch.

A CUDA tensor launches the kernel on the current stream, once for every
:data:`FIELDS_PER_LAUNCH` buffers (asynchronous, counted in
``window_gather.launches``; the first launch also writes the mask); a CPU
tensor runs the plain version.  There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _nvcc

_DTYPES = (torch.int32, torch.float32)
#: buffers one kernel launch gathers (csrc/gather.cu kMaxFields)
FIELDS_PER_LAUNCH = 8

_lock = threading.Lock()
_lib = None


def build() -> str:
    """Compile csrc/gather.cu if this source has not been built yet; returns
    the path of the shared library (ops/_nvcc.py)."""
    return _nvcc.build("gather.cu")


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            c_int, c_ll, c_p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
            lib.wf_window_gather.argtypes = [c_p, c_p, c_int, c_ll, c_p, c_p,
                                             c_p, c_int, c_int, c_p, c_p]
            lib.wf_window_gather.restype = c_int
            _lib = lib
        return _lib


def _as_tuple(bufs):
    single = isinstance(bufs, torch.Tensor)
    return single, ((bufs,) if single else tuple(bufs))


def window_gather_reference(bufs, rows, starts, lens, pad: int):
    """Plain version: a clamped advanced-index gather per buffer and a
    ``torch.where`` over the lane mask."""
    single, bufs = _as_tuple(bufs)
    device = starts.device
    lane = torch.arange(int(pad), device=device)
    mask = lane[None, :] < lens.long()[:, None]
    tiles = []
    for buf in bufs:
        ncols = buf.shape[1]
        if ncols == 0 or len(starts) == 0:
            tiles.append(torch.zeros((len(starts), int(pad)), dtype=buf.dtype,
                                     device=device))
            continue
        idx = (starts.long()[:, None] + lane[None, :]).clamp(0, ncols - 1)
        vals = (buf[rows.long()[:, None], idx] if rows is not None
                else buf[0][idx])
        tiles.append(torch.where(mask, vals, torch.zeros((), dtype=buf.dtype,
                                                         device=device)))
    return (tiles[0] if single else tuple(tiles)), mask


def _check(bufs, rows, starts, lens):
    if not bufs:
        raise ValueError("window_gather needs at least one buffer")
    shape, device = bufs[0].shape, bufs[0].device
    for buf in bufs:
        if (buf.dtype not in _DTYPES or buf.dim() != 2 or buf.shape != shape
                or buf.device != device):
            raise TypeError(f"window_gather takes 2-D int32/float32 buffers of "
                            f"one shape on one device, got {buf.dtype} "
                            f"{tuple(buf.shape)} on {buf.device}")
    B = starts.numel()
    for name, t in (("rows", rows), ("starts", starts), ("lens", lens)):
        if t is None:
            continue
        if (t.dtype != torch.int32 or t.dim() != 1 or t.numel() != B
                or t.device != device):
            raise TypeError(f"{name} must be a ({B},) int32 tensor on "
                            f"{device}, got {t.dtype} {tuple(t.shape)} on "
                            f"{t.device}")
    return device


def window_gather(bufs, rows, starts, lens, pad: int):
    """``(B, pad)`` tiles of the windows ``(rows[b], starts[b], lens[b])``
    of each ``(R, ncols)`` buffer in `bufs` (a tensor or a sequence of
    tensors), with lanes past ``lens[b]`` zero, and the ``(B, pad)`` bool
    mask; returns ``(tiles, mask)``, `tiles` a tensor when `bufs` is one."""
    single, bufs = _as_tuple(bufs)
    device = _check(bufs, rows, starts, lens)
    if device.type == "cpu":
        tiles, mask = window_gather_reference(bufs, rows, starts, lens, pad)
        return (tiles[0] if single else tiles), mask
    if device.type != "cuda":
        raise ValueError(f"window_gather runs on cuda or cpu tensors, got "
                         f"{device}")
    if not all(t.is_contiguous() for t in (*bufs, starts, lens)
               if t is not None) or (rows is not None
                                     and not rows.is_contiguous()):
        raise ValueError("window_gather takes contiguous tensors")
    B, pad = starts.numel(), int(pad)
    mask = torch.empty((B, pad), dtype=torch.bool, device=device)
    tiles = tuple(torch.empty((B, pad), dtype=b.dtype, device=device)
                  for b in bufs)
    if B == 0 or pad == 0:
        return (tiles[0] if single else tiles), mask
    lib = _load()
    ncols = bufs[0].shape[1]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for i in range(0, len(bufs), FIELDS_PER_LAUNCH):
            group = range(i, min(i + FIELDS_PER_LAUNCH, len(bufs)))
            srcs = (ctypes.c_void_p * len(group))(
                *(bufs[k].data_ptr() for k in group))
            dsts = (ctypes.c_void_p * len(group))(
                *(tiles[k].data_ptr() for k in group))
            rc = lib.wf_window_gather(
                srcs, dsts, len(group), ncols,
                rows.data_ptr() if rows is not None else None,
                starts.data_ptr(), lens.data_ptr(), B, pad,
                mask.data_ptr() if i == 0 else None, stream)
            if rc != 0:
                raise RuntimeError(f"window_gather kernel launch failed: CUDA "
                                   f"error {rc}")
            window_gather.launches += 1
    return (tiles[0] if single else tiles), mask


#: kernel launches since the count was last reset
window_gather.launches = 0
