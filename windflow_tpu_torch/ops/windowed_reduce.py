"""Windowed monoid reduction over a flat staged buffer: the hand-written CUDA
kernel (csrc/windowed_reduce.cu), its plain PyTorch version, and the loader
that builds the kernel on first use.

This is the port of the Pallas TPU kernel
``windflow_tpu/ops/pallas_kernels.py:windowed_reduce_pallas``.  Window ``i``
is ``flat[starts[i] : starts[i] + lens[i]]`` with ``lens[i] <= pad``; it is
reduced with ``op`` in ``flat``'s dtype (int32 or float32).  ``count``
returns the lengths converted to that dtype.  The TPU kernel also accepted
``op="mean"`` and returned the window *sum* for it (its reducer table maps
mean to sum); no Reducer reaches it, and this port refuses it.

:func:`windowed_reduce` takes the kernel for a CUDA tensor and the plain
version for a CPU tensor; there is no fallback from one to the other.  The
kernel is compiled with ``nvcc`` (ops/_nvcc.py) the first time it is
launched and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import _nvcc
from .monoid import identity

#: op codes of the C launcher (enum Op in the .cu source)
_OPS = {"sum": 0, "count": 1, "min": 2, "max": 3, "prod": 4}
#: value dtypes the kernel is instantiated for (enum Dtype)
_DTYPES = {torch.int32: 0, torch.float32: 1}

_lock = threading.Lock()
_lib = None


def build() -> str:
    """Compile the kernel library if this source has not been built yet;
    returns the path of the shared library (ops/_nvcc.py)."""
    return _nvcc.build("windowed_reduce.cu")


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.wf_windowed_reduce
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
                ctypes.c_uint, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check_op(op: str):
    if op == "mean":
        raise ValueError(
            "windowed_reduce has no 'mean': the TPU kernel returned the "
            "window sum for it; divide a sum by a count instead")
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}; expected one of {tuple(_OPS)}")


def _ident_bits(op: str, dtype: torch.dtype) -> int:
    """32-bit pattern of the monoid identity in `dtype` (kernel argument)."""
    np_dt = np.int32 if dtype == torch.int32 else np.float32
    return int(np.array(identity(op, np_dt), dtype=np_dt).view(np.uint32))


def windowed_reduce_reference(flat: torch.Tensor, starts: torch.Tensor,
                              lens: torch.Tensor, pad: int,
                              op: str) -> torch.Tensor:
    """Plain PyTorch version of the kernel: a clamped index gather into a
    (B, pad) tile, the masked lanes set to the identity, a reduction over
    axis 1.  int32 sums and products wrap modulo 2**32 like the kernel's."""
    _check_op(op)
    starts = starts.long()
    lens = lens.long()
    if op == "count":
        return lens.to(flat.dtype)
    ident = torch.tensor(identity(op, flat.dtype).item(), dtype=flat.dtype,
                         device=flat.device)
    lane = torch.arange(pad, device=flat.device)
    mask = lane[None, :] < lens[:, None]
    n = flat.numel()
    if n == 0:
        vals = ident.expand(len(starts), pad)
    else:
        idx = (starts[:, None] + lane[None, :]).clamp(max=n - 1)
        vals = torch.where(mask, flat[idx], ident)
    if op in ("sum", "prod") and flat.dtype == torch.int32:
        # accumulate in int64 and truncate: the low 32 bits are the wrapped
        # int32 result (torch.sum of int32 would otherwise widen)
        red = vals.long().sum(dim=1) if op == "sum" else vals.long().prod(dim=1)
        return red.to(torch.int32)
    if op == "sum":
        return vals.sum(dim=1)
    if op == "prod":
        return vals.prod(dim=1)
    return vals.amin(dim=1) if op == "min" else vals.amax(dim=1)


def windowed_reduce(flat: torch.Tensor, starts: torch.Tensor,
                    lens: torch.Tensor, pad: int, op: str) -> torch.Tensor:
    """Reduce B windows ``flat[starts[i] : starts[i]+lens[i]]`` (lens <=
    pad) with the monoid `op`; returns a (B,) tensor in ``flat.dtype``.

    A CUDA `flat` launches the kernel on the current stream (asynchronous,
    counted in ``windowed_reduce.launches``); a CPU `flat` runs the plain
    version.  The kernel takes int32 or float32 values and int32
    starts/lens, all contiguous and on one device."""
    _check_op(op)
    if flat.dtype not in _DTYPES:
        raise TypeError(f"windowed_reduce takes int32 or float32 values, "
                        f"got {flat.dtype}")
    if flat.device.type == "cpu":
        return windowed_reduce_reference(flat, starts, lens, pad, op)
    if flat.device.type != "cuda":
        raise ValueError(f"windowed_reduce runs on cuda or cpu tensors, got "
                         f"{flat.device}")
    for name, t in (("starts", starts), ("lens", lens)):
        if t.dtype != torch.int32 or t.device != flat.device or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor on "
                            f"{flat.device}, got {t.dtype} {tuple(t.shape)} "
                            f"on {t.device}")
    if starts.numel() != lens.numel():
        raise ValueError("starts and lens differ in length")
    if flat.dim() != 1:
        raise ValueError("flat must be 1-D")
    flat, starts, lens = flat.contiguous(), starts.contiguous(), lens.contiguous()
    B = starts.numel()
    out = torch.empty(B, dtype=flat.dtype, device=flat.device)
    if B == 0:
        return out
    lib = _load()
    # the launch goes to the current CUDA device: make it flat's, so that a
    # worker placed on cuda:i launches on cuda:i's stream
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        rc = lib.wf_windowed_reduce(
            flat.data_ptr(), starts.data_ptr(), lens.data_ptr(),
            out.data_ptr(), B, int(pad), _OPS[op], _DTYPES[flat.dtype],
            _ident_bits(op, flat.dtype), stream)
    if rc != 0:
        raise RuntimeError(f"windowed_reduce kernel launch failed: CUDA "
                           f"error {rc}")
    windowed_reduce.launches += 1
    return out


#: kernel launches since the count was last reset (chip_smoke.py resets it
#: before the main path and reads it after)
windowed_reduce.launches = 0
