"""Windowed monoid reductions: the hand-written CUDA kernel
(csrc/windowed_reduce.cu), its plain PyTorch version, and the loader that
builds the kernel on first use.

This is the port of the Pallas TPU kernel
``windflow_tpu/ops/pallas_kernels.py:windowed_reduce_pallas`` and of the
XLA device bodies that evaluate windows over a resident ring
(``_ring_eval`` through ``_append_eval`` and ``_make_multi_step``'s stats,
``windflow_tpu/ops/resident.py:243, :260, :599``).  An *evaluation* is a
``(buf, op)`` pair: ``buf`` an ``(R, ncols)`` tensor (or a 1-D
``(ncols,)`` one, a single row) of int32, float32, uint32, int64, uint64,
float16 or float64 (:data:`DTYPE_CODES`), ``op`` one of sum, count, min,
max and prod.  Window ``w`` is ``buf[rows[w], starts[w] : starts[w] +
min(lens[w], pad)]`` (``rows=None`` reads row 0), a column past the row's
end reading its last cell as the JAX gathers clamp; it is reduced in the
buffer's dtype: integer sums and products wrap at its width, uint32 and
uint64 compare unsigned, and float16 is reduced in float32 and rounded to
float16 once (:class:`Work`).  ``count`` returns the lengths converted to
that dtype.
The TPU kernel also accepted ``op="mean"`` and returned the window *sum*
for it (its reducer table maps mean to sum); no Reducer reaches it, and
this port refuses it.

:func:`windowed_reduce_many` evaluates up to :data:`EVALS_PER_LAUNCH`
evaluations over one set of descriptors in one launch (more take
``ceil(n / EVALS_PER_LAUNCH)`` launches); :func:`windowed_reduce` is its
one-evaluation, one-row form.  A CUDA tensor launches the kernel on the
current stream (asynchronous, counted in ``windowed_reduce.launches``); a
CPU tensor runs the plain version.  There is no fallback from one to the
other.  The kernel is compiled with ``nvcc`` (ops/_nvcc.py) the first time
it is launched and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import _nvcc
from .monoid import identity

#: op codes of the C launcher (enum Op in csrc/cells.cuh)
_OPS = {"sum": 0, "count": 1, "min": 2, "max": 3, "prod": 4}
#: dtype codes of the C launchers (enum Dtype in csrc/cells.cuh), shared
#: by the mesh kernels (ops/mesh_reduce.py)
DTYPE_CODES = {torch.int32: 0, torch.float32: 1, torch.uint32: 2,
               torch.int64: 3, torch.uint64: 4, torch.float16: 5,
               torch.float64: 6}
#: the dtypes that share a launch (the kernel's <int32_t, float>
#: instantiation); every other dtype launches on its own
_INT32_CLASS = (torch.int32, torch.float32)

# the kernel's geometry (constants of csrc/windowed_reduce.cu; the
# lane-order twin follows them, the tests and chip_smoke.py build their
# cases from them)
#: evaluations one launch takes (kMaxEvals)
EVALS_PER_LAUNCH = 8
#: lanes that reduce one window (kLanes) and cells of a group, one vector
#: load at every width (kGroup): cell j of a window whose first cell has flat index f0 (row *
#: ncols + start) is combined by lane ((f0 % GROUP + j) // GROUP) % LANES
LANES = 8
GROUP = 4

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
            c_int, c_ll, c_p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
            fn = lib.wf_windowed_reduce
            fn.argtypes = [c_p] * 5 + [c_int, c_ll] + [c_p] * 3 + [
                c_int, c_int, c_p]
            fn.restype = c_int
            lib.wf_empty.argtypes = [c_p]
            lib.wf_empty.restype = c_int
            _lib = lib
        return _lib


def _check_op(op: str):
    if op == "mean":
        raise ValueError(
            "windowed_reduce has no 'mean': the TPU kernel returned the "
            "window sum for it; divide a sum by a count instead")
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}; expected one of {tuple(_OPS)}")


_UNSIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
             torch.uint64: torch.int64}


def signed_view(t: torch.Tensor) -> torch.Tensor:
    """An unsigned tensor as the signed integers of its width (the same
    bits): torch has few ops for uint16, uint32 and uint64, but gathers,
    scatters and copies of the signed view are the same words."""
    return t.view(_UNSIGNED[t.dtype]) if t.dtype in _UNSIGNED else t


class Work:
    """How the plain versions and the CPU twins compute over values of one
    dtype, as the kernels do in their work type (csrc/cells.cuh, Work).

    Values are held as int64 for every integer dtype (uint64 as its bits,
    uint8, uint16 and uint32 zero-extended), as float32 for float16, else
    in the dtype itself.  A sum or product of integers of 1-4 bytes is
    reduced modulo 2**32 after every step (into the int32 range for a
    signed dtype, [0, 2**32) for an unsigned one); 64-bit integers wrap by
    themselves.  min and max order uint64 values by their bits with the
    sign bit flipped (an unsigned compare); every other held value
    compares as it is."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        self.is_float = dtype.is_floating_point
        self.held = (torch.float32 if dtype == torch.float16
                     else dtype if self.is_float else torch.int64)
        self.itemsize = torch.empty(0, dtype=dtype).element_size()

    def load(self, x: torch.Tensor) -> torch.Tensor:
        """Values stored in the dtype (or its signed view) as held."""
        if self.dtype in (torch.uint16, torch.uint32):
            bits = 8 * self.itemsize
            return (x.view(_UNSIGNED[self.dtype]).long()
                    & ((1 << bits) - 1))
        if self.dtype == torch.uint64:
            return x.view(torch.int64)
        return x.to(self.held)

    def store(self, x: torch.Tensor, dtype: torch.dtype = None):
        """Held values as `dtype` (default: the dtype): an integer keeps
        its low bits, float16 is rounded once."""
        dtype = dtype or self.dtype
        if dtype == torch.uint32:
            return _wrap32(x).to(torch.int32).view(torch.uint32)
        if dtype == torch.uint64:
            return x.view(torch.uint64)
        if dtype == torch.uint16:
            return x.to(torch.int16).view(torch.uint16)
        return x.to(dtype)

    def wrap(self, x: torch.Tensor) -> torch.Tensor:
        """A held sum or product reduced to the kernel's width."""
        if self.is_float or self.itemsize == 8:
            return x
        if not self.dtype.is_signed:
            return x & 0xFFFFFFFF
        return _wrap32(x)

    def key(self, x: torch.Tensor) -> torch.Tensor:
        """Held values in the order min and max compare them (an
        involution: key(key(x)) is x)."""
        return x ^ (-2 ** 63) if self.dtype == torch.uint64 else x

    def ident(self, op: str, device=None) -> torch.Tensor:
        """The identity of `op` over the dtype, held (a 0-d tensor)."""
        np_dt = np.dtype(torch.empty(0, dtype=self.dtype).numpy().dtype)
        arr = np.array([identity(op, np_dt)], dtype=np_dt)
        return self.load(torch.from_numpy(arr))[0].to(device)

    def reduce(self, op: str, x: torch.Tensor, dim: int) -> torch.Tensor:
        """`op` over held values along `dim`, in torch's order."""
        if op in ("sum", "count", "mean"):
            return self.wrap(x.sum(dim=dim))
        if op == "prod":
            return self.wrap(x.prod(dim=dim))
        k = self.key(x)
        return self.key(k.amin(dim=dim) if op == "min" else k.amax(dim=dim))

    def to_float(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Held values as the float `dtype`, rounded once (a uint64 as its
        unsigned value)."""
        if self.dtype != torch.uint64:
            return x.to(dtype)
        hi = ((x >> 32) & 0xFFFFFFFF).to(torch.float64) * 2.0 ** 32
        return (hi + (x & 0xFFFFFFFF).to(torch.float64)).to(dtype)


def _ident_bits(op: str, dtype: torch.dtype) -> int:
    """Bit pattern of the monoid identity in the kernels' work type for
    values of `dtype` (float32 for float16), as an unsigned 64-bit int
    (kernel argument; a 4-byte pattern in the low bytes)."""
    np_dt = (np.dtype(np.float32) if dtype == torch.float16
             else torch.empty(0, dtype=dtype).numpy().dtype)
    a = np.array(identity(op, np_dt), dtype=np_dt)
    return int(a.view(np.uint32 if a.itemsize == 4 else np.uint64))


def _as_rows(buf: torch.Tensor) -> torch.Tensor:
    """`buf` as an (R, ncols) tensor: a 1-D buffer is one row."""
    return buf.reshape(1, -1) if buf.dim() == 1 else buf


def out_dtype(op: str, dtype: torch.dtype) -> torch.dtype:
    """Dtype of `op`'s result over values of `dtype` (what ``_ring_eval``
    returns without x64 for cells of 1-4 bytes, with x64 for 8): the
    values', except int32 for a product of int8 or int16 values and
    uint32 for one of uint8 or uint16 values (``jnp.prod`` promotes them
    to the default int of their kind)."""
    if op == "prod" and dtype in (torch.int8, torch.int16):
        return torch.int32
    if op == "prod" and dtype in (torch.uint8, torch.uint16):
        return torch.uint32
    return dtype


def _reference_one(buf, rows, starts, lens, pad, op):
    work = Work(buf.dtype)
    if op == "count":
        return work.store(lens.long())
    buf = signed_view(_as_rows(buf))
    device = buf.device
    ident = work.ident(op, device)
    ncols = buf.shape[1]
    if ncols == 0:
        return work.store(ident.expand(len(starts)).clone(),
                          out_dtype(op, work.dtype))
    lane = torch.arange(int(pad), device=device)
    mask = lane[None, :] < lens.long()[:, None]
    idx = (starts.long()[:, None] + lane[None, :]).clamp(0, ncols - 1)
    vals = buf[rows.long()[:, None], idx] if rows is not None else buf[0][idx]
    # integers held in int64 (their sums and products wrapped to the
    # dtype's width), float16 in float32: torch.sum of int32 would widen
    vals = torch.where(mask, work.load(vals), ident)
    return work.store(work.reduce(op, vals, 1), out_dtype(op, work.dtype))


def windowed_reduce_many_reference(evals, rows, starts, lens,
                                   pad: int) -> list:
    """Plain PyTorch version of the kernel: per evaluation a gather
    ``buf[rows, clamp(starts + lane, 0, ncols - 1)]`` into a (B, pad) tile,
    the lanes past each length set to the identity, a reduction over axis
    1, in the dtype's work type (:class:`Work`).  Integer sums and
    products wrap like the kernels' (at the dtype's width; the ring
    kernels' int8 and int16 as :func:`out_dtype` says)."""
    out = []
    for buf, op in evals:
        _check_op(op)
        out.append(_reference_one(buf, rows, starts, lens, pad, op))
    return out


def windowed_reduce_reference(flat: torch.Tensor, starts: torch.Tensor,
                              lens: torch.Tensor, pad: int,
                              op: str) -> torch.Tensor:
    """Plain version of :func:`windowed_reduce` (one evaluation over one
    flat row)."""
    return windowed_reduce_many_reference([(flat, op)], None, starts, lens,
                                          pad)[0]


def _wrap32(x):
    """int64 values reduced modulo 2**32 into the int32 range."""
    return torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31


def _combine(op, a, b, work):
    """The kernel's combine(a, b) over held values (`work` a
    :class:`Work`): a + b and a * b (wrapped to the dtype's width), and for
    min/max ``a`` where a is NaN or wins, else ``b``."""
    if op == "sum":
        return work.wrap(a + b)
    if op == "prod":
        return work.wrap(a * b)
    ka, kb = work.key(a), work.key(b)
    first = ka < kb if op == "min" else ka > kb
    if work.is_float:
        first = first | torch.isnan(a)
    return torch.where(first, a, b)


def team_fold(op, work, ident, gb, ge, a, n, cells):
    """The order of a team of LANES lanes, shared by the CPU twins of the
    kernels that reduce in it (csrc/windowed_reduce.cu, csrc/mesh_reduce.cu).

    For S spans, each the groups [gb, ge) of a window of n cells whose cell
    j lies in 4-cell group (a + j) // GROUP: lane q combines the groups g
    = gb + q + LANES * t in ascending t, and in each its cells j = GROUP *
    g + k - a (k = 0 .. GROUP - 1) inside [0, n) in ascending k, starting
    from the identity `ident` (a 0-d tensor, held as `work` says: a
    :class:`Work`); ``cells(j)`` gives the (S, LANES) held values of cells
    j (None: count only) and a mask of the cells that count (True for
    all).  Then a butterfly over LANES/2, ..., 2, 1 in which every lane
    combines its own value with its partner's, own first.  Returns lane
    0's (S,) value and the (S,) number of cells combined."""
    S = gb.numel()
    lane = torch.arange(LANES, device=gb.device)
    acc = ident.expand(S, LANES).clone()
    cnt = torch.zeros((S, LANES), dtype=torch.int64, device=gb.device)
    span = int((ge - gb).max()) if S else 0
    for t in range(-(-span // LANES)):
        g = gb[:, None] + lane[None, :] + LANES * t
        for k in range(GROUP):
            j = GROUP * g + k - a[:, None]
            v, kept = cells(j)
            live = (g < ge[:, None]) & (j >= 0) & (j < n[:, None]) & kept
            cnt += live
            if v is not None:
                acc = torch.where(live, _combine(op, acc, v, work), acc)
    off = LANES // 2
    while off:
        acc = _combine(op, acc, acc[:, lane ^ off], work)
        cnt = cnt + cnt[:, lane ^ off]
        off //= 2
    return acc[:, 0], cnt[:, 0]


def chunked_fold(op, work, ident, a, n, split, chunk, cells):
    """The order of the kernels that cut long windows into chunks
    (csrc/mesh_reduce.cu sp_window_partial, csrc/resident.cuh
    ring_append_eval), shared by their CPU twins.

    For B windows of n cells whose cell j lies in 4-cell group (a + j) //
    GROUP: a window of at most `split` cells is one team's
    (:func:`team_fold` over all its groups); a longer one is cut into
    chunks of ``chunk // GROUP`` groups from its first group, each reduced
    in the team's order, and the chunk partials are folded in chunk order
    from the identity.  ``cells(win, j)`` gives what team_fold's `cells`
    gives for spans of the windows `win`.  Returns the (B,) values and
    the (B,) numbers of cells combined."""
    device, B = n.device, n.numel()
    groups = (a + n + GROUP - 1) // GROUP
    cg = chunk // GROUP
    long = n > split
    # the spans a team reduces: a short window's groups, or one chunk
    nch = torch.where(long, (groups + cg - 1) // cg, torch.ones_like(n))
    win = torch.repeat_interleave(torch.arange(B, device=device), nch)
    ch = (torch.arange(win.numel(), device=device)
          - (torch.cumsum(nch, 0) - nch)[win])
    span_long = long[win]
    gb = torch.where(span_long, ch * cg, torch.zeros_like(ch))
    ge = torch.where(span_long, torch.minimum(gb + cg, groups[win]),
                     groups[win])
    sv, sc = team_fold(op, work, ident, gb, ge, a[win], n[win],
                       lambda j: cells(win, j))
    acc = ident.expand(B).clone()
    cnt = torch.zeros(B, dtype=torch.int64, device=device)
    one = ~span_long
    acc[win[one]] = sv[one]
    cnt[win[one]] = sc[one]
    if bool(long.any()):
        # the chunk partials of the L long windows as an (L, chunks) grid,
        # folded column by column in chunk order from the identity
        lw = torch.nonzero(long).flatten()
        rank = torch.zeros(B, dtype=torch.long, device=device)
        rank[lw] = torch.arange(lw.numel(), device=device)
        chunks = nch[lw]
        grid = ident.expand(lw.numel(), int(chunks.max())).clone()
        gcnt = torch.zeros_like(grid, dtype=torch.int64)
        at = (rank[win[span_long]], ch[span_long])
        grid[at] = sv[span_long]
        gcnt[at] = sc[span_long]
        tot = ident.expand(lw.numel()).clone()
        for c in range(grid.shape[1]):
            tot = torch.where(c < chunks,
                              _combine(op, tot, grid[:, c], work), tot)
        acc[lw] = tot
        cnt[lw] = gcnt.sum(dim=1)
    return acc, cnt


def lane_order_twin(evals, rows, starts, lens, pad: int) -> list:
    """Plain torch that reproduces the kernel's ownership of cells and its
    combine order (csrc/windowed_reduce.cu, "Order"), so that the kernel
    can be held to it bit for bit; no path of the port calls it.

    With len = min(lens[w], pad), s = max(starts[w], 0) and a = (rows[w] *
    ncols + s) mod 4, cell j of window w is column min(s + j, ncols - 1) of
    row rows[w] and lies in the window's 4-cell group (a + j) // 4, which
    belongs to lane group mod LANES; the lanes combine as
    :func:`team_fold` says, over all of the window's groups, in the
    dtype's work type (:class:`Work`; float16 rounded once at the end)."""
    outs = []
    for buf, op in evals:
        _check_op(op)
        work = Work(buf.dtype)
        if op == "count":
            outs.append(work.store(lens.long()))
            continue
        buf2 = signed_view(_as_rows(buf))
        ncols = buf2.shape[1]
        ident = work.ident(op, buf.device)
        s = starts.long().clamp(min=0)
        n = (lens.long().clamp(0, int(pad)) if ncols
             else torch.zeros_like(s))
        r = rows.long() if rows is not None else torch.zeros_like(s)
        a = (r * ncols + s) % GROUP

        def cells(j, buf2=buf2, ncols=ncols, work=work, r=r, s=s):
            if not ncols:
                return None, True
            col = (s[:, None] + j).clamp(0, ncols - 1)
            return work.load(buf2[r[:, None], col]), True

        got, _ = team_fold(op, work, ident, torch.zeros_like(s),
                           (a + n + GROUP - 1) // GROUP, a, n, cells)
        outs.append(work.store(got))
    return outs


def _names(dtypes) -> str:
    return ", ".join(str(d).replace("torch.", "") for d in dtypes)


def _check_many(evals, rows, starts, lens):
    if not evals:
        raise ValueError("windowed_reduce_many needs at least one evaluation")
    shape, device = evals[0][0].shape, evals[0][0].device
    for buf, op in evals:
        _check_op(op)
        if buf.dtype not in DTYPE_CODES:
            raise TypeError(f"windowed_reduce takes values of "
                            f"{_names(DTYPE_CODES)}, got {buf.dtype}")
        if (buf.dim() not in (1, 2) or buf.shape != shape
                or buf.device != device):
            raise TypeError(f"windowed_reduce_many takes 1-D or 2-D buffers "
                            f"of one shape on one device, got "
                            f"{tuple(buf.shape)} on {buf.device}")
    if len(shape) == 1 and rows is not None:
        raise ValueError("1-D buffers are one row: pass rows=None")
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


def windowed_reduce_many(evals, rows, starts, lens, pad: int) -> list:
    """Reduce the B windows ``(rows[w], starts[w], min(lens[w], pad))`` of
    every evaluation ``(buf, op)`` in `evals`; returns one (B,) tensor an
    evaluation, in the buffer's dtype.

    All buffers share one shape (their dtypes may differ) and lie on one
    device with the int32 descriptors; ``rows=None`` reads row 0.  A CUDA
    buffer launches the kernel, once for every :data:`EVALS_PER_LAUNCH`
    evaluations of one launch class (int32 and float32 together; every
    other dtype apart), none for B = 0; a CPU buffer runs the plain
    version."""
    evals = [(buf, op) for buf, op in evals]
    device = _check_many(evals, rows, starts, lens)
    if device.type == "cpu":
        return windowed_reduce_many_reference(evals, rows, starts, lens, pad)
    if device.type != "cuda":
        raise ValueError(f"windowed_reduce runs on cuda or cpu tensors, got "
                         f"{device}")
    if not all(t.is_contiguous() for t in (*(b for b, _ in evals), starts,
                                           lens)) or (
            rows is not None and not rows.is_contiguous()):
        raise ValueError("windowed_reduce takes contiguous tensors")
    B, pad = starts.numel(), int(pad)
    outs = [torch.empty(B, dtype=buf.dtype, device=device)
            for buf, _ in evals]
    if B == 0:
        return outs
    lib = _load()
    ncols = evals[0][0].shape[-1]
    classes = {}       # launch class -> its evaluations, in order
    for k, (buf, _op) in enumerate(evals):
        cls = "int32" if buf.dtype in _INT32_CLASS else buf.dtype
        classes.setdefault(cls, []).append(k)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for members, i in ((m, i) for m in classes.values()
                           for i in range(0, len(m), EVALS_PER_LAUNCH)):
            group = members[i:i + EVALS_PER_LAUNCH]
            n = len(group)
            bufs = (ctypes.c_void_p * n)(*(evals[k][0].data_ptr()
                                           for k in group))
            dsts = (ctypes.c_void_p * n)(*(outs[k].data_ptr()
                                           for k in group))
            ops = (ctypes.c_int * n)(*(_OPS[evals[k][1]] for k in group))
            dts = (ctypes.c_int * n)(*(DTYPE_CODES[evals[k][0].dtype]
                                       for k in group))
            ids = (ctypes.c_ulonglong * n)(*(_ident_bits(evals[k][1],
                                                         evals[k][0].dtype)
                                             for k in group))
            rc = lib.wf_windowed_reduce(
                bufs, dsts, ops, dts, ids, n, ncols,
                rows.data_ptr() if rows is not None else None,
                starts.data_ptr(), lens.data_ptr(), B, pad, stream)
            if rc != 0:
                raise RuntimeError(f"windowed_reduce kernel launch failed: "
                                   f"CUDA error {rc}")
            windowed_reduce.launches += 1
    return outs


def windowed_reduce(flat: torch.Tensor, starts: torch.Tensor,
                    lens: torch.Tensor, pad: int, op: str) -> torch.Tensor:
    """Reduce B windows ``flat[starts[i] : starts[i]+lens[i]]`` (lens <=
    pad) with the monoid `op`; returns a (B,) tensor in ``flat.dtype``.

    The one-evaluation, one-row form of :func:`windowed_reduce_many`: a
    CUDA `flat` launches the kernel on the current stream (asynchronous,
    counted in ``windowed_reduce.launches``); a CPU `flat` runs the plain
    version.  The kernel takes values of :data:`DTYPE_CODES`' dtypes and
    int32 starts/lens, all on one device."""
    _check_op(op)
    if flat.dtype not in DTYPE_CODES:
        raise TypeError(f"windowed_reduce takes values of {_names(DTYPE_CODES)}, "
                        f"got {flat.dtype}")
    if flat.dim() != 1:
        raise ValueError("flat must be 1-D")
    if flat.device.type == "cuda":
        flat, starts, lens = (flat.contiguous(), starts.contiguous(),
                              lens.contiguous())
    return windowed_reduce_many([(flat, op)], None, starts, lens, pad)[0]


#: kernel launches since the count was last reset (chip_smoke.py resets it
#: before the main path and reads it after)
windowed_reduce.launches = 0


def empty_launch():
    """Launch the library's empty kernel (one block, no work) on the
    current stream: the floor of a launch, which chip_smoke.py times
    beside every kernel.  No path of the port calls it."""
    lib = _load()
    rc = lib.wf_empty(torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {rc}")
