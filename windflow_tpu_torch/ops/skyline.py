"""The 2-D skyline (pareto frontier, minimisation) of every window of a
batch: the hand-written CUDA kernel (csrc/skyline.cu), its plain PyTorch
version, and the loader that builds the kernel on first use.

This ports ``windflow_tpu/apps/spatial.py:device_skyline``'s ``fn`` (:143),
the masked ``(B, pad, pad)`` float32 dominance test.  Lane ``i`` of window
``b`` survives when it is real (``mask[b, i]``) and no real ``j`` has
``x_j <= x_i``, ``y_j <= y_i`` and (``x_j < x_i`` or ``y_j < y_i``);
:func:`skyline_windows` returns ``(size, checksum)``: the survivor count
(int32) and the float32 sum of the survivors' ``x + y``, per window.

The kernel (csrc/skyline.cu, whose header note has the details) filters,
then verifies, one block per window: the window is staged once into
shared memory; 64 candidates (each the point of least ``x + y`` among the
lanes of 8 threads), less those another candidate dominates, filter every
lane; and the few lanes that pass are verified against each other only
(dominance is transitive, so a lane's dominator passes the filter whenever
the lane does).  Survival is a flag
per lane and one fixed-order pass sums it, so results are identical from
run to run.  A window too wide for shared memory (``pad`` above ~17,500
on an H100) takes the same kernel over device memory, with worklist and
flags in scratch that the wrapper allocates.

A CUDA tensor launches the kernel on the current stream (asynchronous,
counted in ``skyline_windows.launches``); a CPU tensor runs the plain
version.  There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _nvcc

#: pair cells (window x i x j) the plain version materialises at once: the
#: full spatial shape (256 x 4096 x 4096 booleans, ~4.3 GB per temporary)
#: is cut into chunks of windows, and of points i where one window is
#: already larger
PLAIN_CHUNK_CELLS = 1 << 26

_lock = threading.Lock()
_lib = None


def build() -> str:
    """Compile csrc/skyline.cu if this source has not been built yet;
    returns the path of the shared library (ops/_nvcc.py)."""
    return _nvcc.build("skyline.cu")


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            c_int, c_p = ctypes.c_int, ctypes.c_void_p
            lib.wf_skyline_windows.argtypes = [c_p, c_p, c_p, c_int, c_int,
                                               c_p, c_p, c_p, c_p, c_p]
            lib.wf_skyline_windows.restype = c_int
            lib.wf_skyline_staged.argtypes = [c_int]
            lib.wf_skyline_staged.restype = c_int
            _lib = lib
        return _lib


def skyline_alive_reference(x: torch.Tensor, y: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """The (B, pad) survivor mask, by the fn's own broadcast comparisons,
    in chunks of at most PLAIN_CHUNK_CELLS pair cells."""
    B, pad = x.shape
    alive = mask.clone()
    if B == 0 or pad == 0:
        return alive
    di = max(1, min(pad, PLAIN_CHUNK_CELLS // pad))
    db = max(1, PLAIN_CHUNK_CELLS // (di * pad))
    for b0 in range(0, B, db):
        xb, yb, mb = x[b0:b0 + db], y[b0:b0 + db], mask[b0:b0 + db]
        xj, yj, mj = xb[:, None, :], yb[:, None, :], mb[:, None, :]
        for i0 in range(0, pad, di):
            xi = xb[:, i0:i0 + di, None]
            yi = yb[:, i0:i0 + di, None]
            dom = (((xj <= xi) & (yj <= yi)) & ((xj < xi) | (yj < yi))
                   & mj)
            alive[b0:b0 + db, i0:i0 + di] &= ~dom.any(dim=2)
    return alive


def skyline_windows_reference(x: torch.Tensor, y: torch.Tensor,
                              mask: torch.Tensor):
    """Plain version: (size int32, checksum float32) from
    :func:`skyline_alive_reference`."""
    alive = skyline_alive_reference(x, y, mask)
    size = alive.sum(dim=1, dtype=torch.int32)
    checksum = torch.where(alive, x + y, torch.zeros((), dtype=x.dtype,
                                                     device=x.device)
                           ).sum(dim=1)
    return size, checksum


def skyline_windows(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor):
    """Skyline size (int32, (B,)) and x+y checksum (float32, (B,)) of every
    window of the (B, pad) float32 tiles `x`, `y` under the bool `mask`."""
    if (x.dtype != torch.float32 or y.dtype != torch.float32
            or mask.dtype != torch.bool or x.dim() != 2
            or x.shape != y.shape or x.shape != mask.shape
            or not (x.device == y.device == mask.device)):
        raise TypeError(
            f"skyline_windows takes (B, pad) float32 x and y and a bool mask "
            f"of one shape on one device, got {x.dtype} {tuple(x.shape)}, "
            f"{y.dtype} {tuple(y.shape)}, {mask.dtype} {tuple(mask.shape)}")
    if x.device.type == "cpu":
        return skyline_windows_reference(x, y, mask)
    if x.device.type != "cuda":
        raise ValueError(f"skyline_windows runs on cuda or cpu tensors, got "
                         f"{x.device}")
    x, y, mask = x.contiguous(), y.contiguous(), mask.contiguous()
    B, pad = x.shape
    if B == 0 or pad == 0:
        return (torch.zeros(B, dtype=torch.int32, device=x.device),
                torch.zeros(B, dtype=torch.float32, device=x.device))
    # the kernel writes every window
    size = torch.empty(B, dtype=torch.int32, device=x.device)
    checksum = torch.empty(B, dtype=torch.float32, device=x.device)
    lib = _load()
    with torch.cuda.device(x.device):
        staged = lib.wf_skyline_staged(pad)
        if staged < 0:
            raise RuntimeError("skyline_windows: CUDA error querying the "
                               "device's shared memory")
        # above the shared-memory budget: worklist and flags in scratch
        work = alive = None
        if not staged:
            work = torch.empty((B, pad), dtype=torch.int32, device=x.device)
            alive = torch.empty((B, pad), dtype=torch.uint8, device=x.device)
        rc = lib.wf_skyline_windows(
            x.data_ptr(), y.data_ptr(), mask.data_ptr(), B, pad,
            None if work is None else work.data_ptr(),
            None if alive is None else alive.data_ptr(),
            size.data_ptr(), checksum.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"skyline_windows kernel launch failed: CUDA "
                           f"error {rc}")
    skyline_windows.launches += 1
    return size, checksum


#: kernel launches since the count was last reset
skyline_windows.launches = 0
