"""Chip smoke test of the PyTorch/CUDA port (windflow_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing JSON lines (any failure exits non-zero; no phase
catches its own failure):

1. environment: torch version and the card's name and power limit;
2. build: compiles every kernel source of windflow_tpu_torch/ops/csrc/ with
   nvcc (one nvcc per source) and the native host library with make, all
   at once, and reports each build time;
3. kernel: the windowed-reduce kernel against its plain PyTorch version and,
   bit for bit, against its lane-order twin (plain torch, run on the card),
   for sum/count/min/max/prod over int32 and float32, at the
   restaging path's shape (32768 windows of 256 rows over a ~2.1M-row flat
   buffer), with CUDA-graph timings beside the least time the card could
   take: hot (one input set) and cold (inputs cycled through three times
   the L2), and the empty-launch floor; then at edge cases (lengths 0 and
   pad, B = 1, 7, 8, int32 wrap, NaN), windows that straddle blocks, every
   start offset mod 4, windows that end at the last row's end of a 16 MiB
   buffer (the last trip of 32 cells holding one 16-byte group of the
   window or seven), and many evaluations in one launch (sum of an int32
   ring, max of a float32 ring and count over sliding windows of one row
   and unsorted windows on several rows; nine evaluations in two
   launches);
4. ring_kernel: the fused ring_append_regular_sum (one launch a flush) and
   ring_append against their plain versions at the resident path's shape
   (a 64 x 262144 int32 ring, a 64 x 8192 int8 rectangle, 128 windows of
   256 rows per key, slide 64) and at edge cases (every wire x accumulate
   dtype, keys fewer than ring rows, rows without windows, zero lengths,
   starts clipped at 0 and at cap, an int32 wrap, offsets at cap - Rb and
   at every residue mod 4, Rb not a multiple of 16, C not a multiple of a
   warp's 2 windows, windows 600 apart, windows of 5,000 cells; two
   launches bitwise equal; the window sums alone, an empty (KP, 0)
   rectangle, equal too), with timings of the fused kernel and of
   ring_append at this shape; and the windowed-reduce kernel over the
   ring's (row, start, len) descriptors (the irregular evaluation)
   against the plain transcription of the JAX package's _ring_eval and the
   twin;
4b. big_ring: a ring of 16 x 2^28 int32 cells (2^32 cells, 16 GiB) through
   ResidentWindowExecutor.launch: two appends at the ends of its rows, then
   sum, max and min of windows on its last row, whose cells lie past flat
   offset 2^32 (some ending at the ring's last cell), in one windowed-reduce
   launch, held against the plain
   version on that row (the int32 flat starts of the kernel before could
   not reach them);
5. end_to_end (restaging): sum_test (Source -> WinSeqGPU(Reducer("sum"),
   256, 64, CB, use_reduce_kernel=True) -> Sink) over 16M tuples of 64 keys,
   held against a numpy oracle, with the kernel's launch count read around
   that run, and a 1M-tuple prefix held against the port's host core;
6. end_to_end_resident: the same pipeline through the default route,
   WinSeqGPU(Reducer("sum", value_range=(0, 100)), 256, 64, CB,
   batch_len=32768, flush_rows=2**19, depth=48, shards=1) — the C++
   NativeResidentCore feeding the ring kernels — over 16M tuples against
   the oracle, with the ring kernels' launch counts read around that run:
   one fused launch a regular flush, ring_append only with the irregular
   windowed_reduce launches, one each (a 1M-tuple prefix is first held
   against the host core);
7. irregular_and_python_core: Reducer("max") on the native core (irregular
   launches: the windowed-reduce kernel on the ring) and Reducer("sum") on
   the Python ResidentWinSeqCore, 1M tuples each, byte for byte against
   the host core;
8. gather_kernel: window_gather against its plain version at the spatial
   shape (256 windows, pad 4096, two float32 rings of 8 x 4M cells, the
   rings the spatial run allocates: one launch) and on int32 rings, at
   pad 4093 (rows not 16-byte aligned), with 9 fields of mixed int32 and
   float32 (two launches), and at edge cases (length 0, starts whose
   start + pad passes the ring's end, B = 1, the restaging one-row form,
   odd pads); with timings;
9. skyline_kernel: skyline_windows against its plain version at 256
   windows of ~4,000 points (pad 4096) on the 1/256 grid (sizes and
   checksums exact, two launches bitwise equal), and at edge cases (all
   lanes masked, n = 1, duplicate points, ties on one axis, a mask with
   holes, an odd pad, NaN and +-inf coordinates, pads 16384 and 32768
   (the second above the shared-memory budget), unquantised coordinates:
   sizes exact, checksums within rtol 1e-5); with timings;
10. spatial_resident: the spatial skyline (spatial_test wf-gpu's shape:
   TB window 4,000 points, slide 1,000, one key, pardegree 2, batch_len
   256) over a deterministic 640,000-point stream through
   WinFarmGPU(device_skyline(), ..., use_resident=True): every window's
   (size, checksum) against a numpy sort-and-sweep oracle, a prefix of the
   windows byte for byte against the port's host WinSeq(SkylineWindow()),
   and the launch counts in that run: exactly 8 ring_append (2 rings x 2
   launches x 2 workers), 4 window_gather (both fields in one) and 4
   skyline_windows; then ring_append against its plain version on the
   inputs of each of those 8 launches (their rectangles and offsets,
   float32 into 8 x 2^22 float32 rings), timed on the largest (the
   kernels line's ring_append row);
11. spatial_restaging: the same stream through the restaging route
   (WinFarmGPU without use_resident), against the same oracle;
12. spatial_app: apps.spatial.run("wf-gpu") at its defaults (8 s at
   80,000 points/s, TB 50/12.5 ms, pardegree 2, chunk 2048);
13. multi_field_native: MultiReducer(sum(a), max(b), count) over CB 256/64
   and 64 keys, 4M tuples, through the native core's per-field rings
   (NativeResidentCore._multi -> MultiFieldResidentExecutor), byte for
   byte against the port's host core, with one windowed-reduce launch for
   each of the executor's launches that evaluates windows.

Then it prints the kernels' JSON line (each kernel with the empty-launch
floor beside its times), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  It exits non-zero without printing a
result when no CUDA device is visible or when the package is missing.
"""

import contextlib
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# sum_test shape (the JAX package's bench.py workload)
N_KEYS = 64
N_TUPLES = 16_000_000
WIN, SLIDE = 256, 64
BATCH_LEN = 1 << 15
CHUNK = 1 << 20
PREFIX_TUPLES = 1 << 20
DEVICE = "cuda:0"   # one card
# the resident path's settings (the JAX package's bench.py)
FLUSH_ROWS = 1 << 19
DEPTH = 48
# the ring geometry of its steady-state launches: wf_native.cpp provisions
# cap = bucket(2*8192 + 18*8192) on the first row-triggered flush
KP, CAP, RB, C_WINDOWS = 64, 262144, 8192, 128

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32 (non-tensor
# core) operations/s; the kernel does one 32-bit combine per element
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
FLOAT_RTOL = 1e-5
WIRES = (torch.int8, torch.int16, torch.int32, torch.float32)
ACCS = (torch.int32, torch.float32)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _event_ms(run, per):
    """Median over 5 tries of run()'s time on the card / per, by events."""
    times = []
    for _ in range(5):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        run()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / per)
    return statistics.median(times)


def kernel_ms(fn, reps=50):
    """Device time of one fn() call: `reps` calls captured in a CUDA graph
    and replayed between two events, so the wrapper's host work (checks,
    the ctypes call, ~tens of µs) is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    return _event_ms(graph.replay, reps)


def call_ms(fn, reps=10):
    """Time of one fn() call as a caller sees it on the card: `reps` calls
    back to back between two events (host work included where it exceeds
    the device work)."""
    fn()

    def run():
        for _ in range(reps):
            fn()
    return _event_ms(run, reps)


def bench_layout(dev):
    """Starts and lengths as DeviceWinSeqCore lays out one sum_test launch:
    each key's archive segment follows the last, and its 512 windows start
    SLIDE rows apart within it."""
    per_key = BATCH_LEN // N_KEYS
    seg = (per_key - 1) * SLIDE + WIN
    starts = (np.arange(N_KEYS)[:, None] * seg
              + np.arange(per_key)[None, :] * SLIDE).ravel()
    lens = np.full(BATCH_LEN, WIN)
    return (torch.from_numpy(starts.astype(np.int32)).to(dev),
            torch.from_numpy(lens.astype(np.int32)).to(dev), N_KEYS * seg)


def bound(op, n, B, lens):
    """(ms, 'bytes'|'operations'): the least time for the function on these
    inputs — flat read once (not for count), starts and lens read once, the
    output written once; one combine per element of every window."""
    nbytes = 8 * B if op == "count" else 4 * n + 12 * B
    ops = 0 if op == "count" else int(lens.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def compare(got, want, flat, starts, lens, op, rows=None):
    """Max abs error of got vs want; raises on a disagreement.  Integers and
    float min/max/count exactly; float sums within FLOAT_RTOL of the sum of
    |x| over the window (reduction order differs); float prod within
    FLOAT_RTOL of |want|.  `flat` is the buffer the windows read: one flat
    row, or with `rows` a 2-D one."""
    same = got == want
    if got.is_floating_point():
        same |= torch.isnan(got) & torch.isnan(want)
    if flat.dtype == torch.int32 or op in ("count", "min", "max"):
        if not bool(same.all()):
            bad = int((~same).nonzero()[0])
            raise AssertionError(f"{op}/{flat.dtype}: window {bad} gives "
                                 f"{got[bad].item()} != {want[bad].item()}")
        return 0.0
    err = torch.where(same, 0.0, (got.double() - want.double()).abs())
    if op == "sum":
        buf = flat.reshape(1, -1) if rows is None else flat
        r = (torch.zeros_like(starts) if rows is None else rows).long()
        idx = (starts.long()[:, None]
               + torch.arange(int(lens.max()), device=flat.device)[None, :])
        mask = idx < (starts.long() + lens.long())[:, None]
        vals = buf[r[:, None], idx.clamp(max=buf.shape[1] - 1)].double().abs()
        scale = torch.where(mask, vals, 0).sum(dim=1)
    else:
        scale = want.double().abs()
    if not bool((same | (err <= FLOAT_RTOL * scale)).all()):
        raise AssertionError(f"{op}/{flat.dtype}: max error {err.max()} "
                             f"beyond rtol {FLOAT_RTOL}")
    return float(err.max())


def check_reduce(wr, evals, rows, starts, lens, pad, name):
    """The kernel against the plain version (compare) and bit for bit
    against the lane-order twin.  Returns the largest error against the
    plain version."""
    got = wr.windowed_reduce_many(evals, rows, starts, lens, pad)
    plain = wr.windowed_reduce_many_reference(evals, rows, starts, lens, pad)
    twin = wr.lane_order_twin(evals, rows, starts, lens, pad)
    torch.cuda.synchronize()
    err = 0.0
    for (buf, op), g, p, t in zip(evals, got, plain, twin):
        if not torch.equal(g.view(torch.int32), t.view(torch.int32)):
            bad = int((g.view(torch.int32) != t.view(torch.int32))
                      .nonzero()[0])
            raise AssertionError(
                f"windowed_reduce {name} {op}/{buf.dtype}: window {bad} "
                f"gives {g[bad].item()}, the twin {t[bad].item()}")
        err = max(err, compare(g, p, buf, starts, lens, op, rows))
    return err


def cold_copies(dev, tensors):
    """Copies of `tensors` whose sum is three times the card's L2 (the
    first is `tensors` itself): a timed call that cycles through them finds
    its inputs in device memory, not in L2."""
    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size",
                 50 << 20)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = -(-3 * l2 // nbytes)
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors)
                               for _ in range(n - 1)]


def cycled(copies, fn):
    """fn over the next of `copies` at each call (cold inputs)."""
    turn = itertools.cycle(copies)
    return lambda: fn(*next(turn))


def kernel_phase(wr, dev):
    """Kernel against its plain version and its twin at the main path's
    shape and at edge cases; returns the main-path row of the kernels line
    (op sum, int32)."""
    gen = np.random.default_rng(0)
    starts, lens, n = bench_layout(dev)
    max_err = 0.0
    rows = {}
    for dtype in (torch.int32, torch.float32):
        for op in ("sum", "count", "min", "max", "prod"):
            if op == "prod" and dtype == torch.float32:
                # values 0..99 overflow a float32 product to inf, and
                # inf * 0 orders into NaN differently per reduction order
                host = gen.uniform(0.99, 1.01, size=n)
            else:
                host = gen.integers(0, 100, size=n)
            flat = torch.from_numpy(host).to(dev, dtype)
            err = check_reduce(wr, [(flat, op)], None, starts, lens, WIN,
                               f"bench_shape {op}/{dtype}")
            max_err = max(max_err, err)
            b_ms, b_by = bound(op, n, BATCH_LEN, lens)

            def kernel():
                wr.windowed_reduce_many([(flat, op)], None, starts, lens, WIN)

            k_ms = kernel_ms(kernel)
            c_ms = call_ms(kernel)
            p_ms = call_ms(lambda: wr.windowed_reduce_reference(
                flat, starts, lens, WIN, op))
            rows[(op, dtype)] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                     bound_by=b_by)
            emit("kernel", case="bench_shape", op=op, dtype=str(dtype),
                 B=BATCH_LEN, pad=WIN, n=n, max_abs_err=err,
                 twin_bitwise=True, kernel_ms=k_ms,
                 kernel_call_ms=c_ms, plain_ms=p_ms, bound_ms=b_ms,
                 bound_by=b_by, library_ms=None)
    # the main-path row: sum over int32, hot and cold, beside the bound and
    # the empty-launch floor
    flat = torch.from_numpy(gen.integers(0, 100, size=n)).to(dev,
                                                             torch.int32)
    copies = cold_copies(dev, (flat, starts, lens))
    hot = kernel_ms(lambda: wr.windowed_reduce_many(
        [(flat, "sum")], None, starts, lens, WIN))
    cold = kernel_ms(cycled(copies, lambda f, st, ln: wr.windowed_reduce_many(
        [(f, "sum")], None, st, ln, WIN)), reps=10 * len(copies))
    floor = kernel_ms(wr.empty_launch)
    b_ms, b_by = bound("sum", n, BATCH_LEN, lens)
    emit("kernel", case="bench_shape_hot_cold", op="sum",
         dtype="torch.int32", B=BATCH_LEN, pad=WIN, n=n,
         cold_copies=len(copies), hot_ms=hot, cold_ms=cold, floor_ms=floor,
         bound_ms=b_ms, bound_by=b_by, bound_bytes=4 * n + 12 * BATCH_LEN)
    del copies
    emit("kernel", case="edges_and_many_evaluations",
         max_abs_err=edge_cases(wr, dev, gen), ok=True)
    torch.cuda.synchronize()
    row = dict(rows[("sum", torch.int32)])
    row["ms"] = hot
    return dict(max_abs_err=max_err, cold_ms=cold, floor_ms=floor, **row)


def edge_cases(wr, dev, gen):
    """The kernel against its plain version and its twin at its edges; returns the largest error against the plain version (float
    products of up to 300 values near 1 included, so it can be large in
    absolute terms and still within FLOAT_RTOL of |want|)."""
    as32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                     device=dev)
    err = 0.0

    def check(name, flat, starts, lens, pad, ops):
        nonlocal err
        flat = flat.to(dev)
        err = max(err, check_reduce(wr, [(flat, op) for op in ops], None,
                                    as32(starts), as32(lens), pad, name))
        emit("kernel", case=name, ops=list(ops), dtype=str(flat.dtype),
             ok=True)

    all_ops = ("sum", "count", "min", "max", "prod")
    for dtype in (torch.int32, torch.float32):
        # float values near 1 keep products finite in every order
        def values(n):
            return (gen.integers(0, 100, size=n) if dtype == torch.int32
                    else gen.uniform(0.5, 1.5, size=n))
        for B in (1, 7, 8):
            flat = torch.from_numpy(values(64)).to(dtype)
            starts = gen.integers(0, 32, size=B)
            lens = gen.integers(0, 33, size=B)
            lens[0] = 0 if B > 1 else 32
            check(f"B={B}", flat, starts, lens, 32, all_ops)
        flat = torch.from_numpy(values(600)).to(dtype)
        check("len0_and_len_pad", flat, [0, 5, 300, 44], [0, 256, 256, 0],
              256, all_ops)
        # sliding windows that straddle the kernel's blocks (B not a
        # multiple of 64), lengths 0..300 at pad 300
        flat = torch.from_numpy(values(12000)).to(dtype)
        B = 64 * 5 + 37
        lens = gen.integers(0, 301, size=B)
        lens[::9] = 300
        check("straddle_blocks", flat, np.arange(B) * 29, lens, 300, all_ops)
        # every start offset mod 4 (the 16-byte groups' head), and windows
        # that end at the buffer's last cell (n not a multiple of 4)
        for m in range(4):
            flat = torch.from_numpy(values(4001)).to(dtype)
            starts = 4 * gen.integers(0, 900, size=200) + m
            lens = gen.integers(0, 257, size=200)
            starts[:4] = 4001 - lens[:4]
            check(f"start_mod4={m}", flat, np.sort(starts), lens, 256,
                  all_ops)
    wrap = torch.full((16,), 2 ** 30, dtype=torch.int32)
    check("int32_wrap_sum", wrap, [0, 0, 4], [4, 3, 8], 8, ("sum",))
    wrap16 = torch.full((16,), 2 ** 16, dtype=torch.int32)
    check("int32_wrap_prod", wrap16, [0, 0, 4], [2, 1, 8], 8, ("prod",))
    nan = torch.arange(64, dtype=torch.float32)
    nan[5] = float("nan")
    check("nan_min_max", nan, [0, 4, 8, 6, 40], [8, 4, 8, 0, 16], 16,
          ("min", "max", "sum"))
    # windows that end at their row's end, the last row's included, on a
    # 16 MiB buffer (its own allocation): the last trip of 32 cells holds
    # one 16-byte group of the window or seven, so a lane that loaded every
    # trip's group would read past the buffer
    R, ncols = 64, 65536
    for tail in (4, 28):
        lens = np.array([k for k in range(1, 300)
                         if ((-k) % 4 + k) % 32 == tail] + [300, 255, 33])
        rows = np.arange(len(lens)) % R
        rows[::2] = R - 1
        d = [as32(a) for a in (rows, ncols - lens, lens)]
        for dtype in (torch.int32, torch.float32):
            ring = torch.from_numpy(
                gen.integers(-1000, 1000, size=(R, ncols))
                if dtype == torch.int32
                else gen.uniform(0.5, 1.5, size=(R, ncols))).to(dev, dtype)
            err = max(err, check_reduce(wr, [(ring, op) for op in all_ops],
                                        *d, 300, f"row_end_tail{tail}"))
            del ring
        emit("kernel", case=f"row_end_tail{tail}", ring=[R, ncols],
             windows=len(lens), ok=True)
    # many evaluations in one launch: sum of an int32 ring, max of a
    # float32 ring and count, over sliding windows of one row then
    # unsorted windows on several rows; then nine evaluations (two
    # launches)
    R, ncols, B = 8, 20000, 64 * 6 + 21
    ri = torch.from_numpy(gen.integers(-1000, 1000, size=(R, ncols))).to(
        dev, torch.int32)
    rf = torch.from_numpy(gen.uniform(-100, 100, size=(R, ncols))).to(
        dev, torch.float32)
    rows = gen.integers(0, R, size=B)
    starts = gen.integers(0, ncols - 300, size=B)
    rows[:192] = 3
    starts[:192] = 100 + np.arange(192) * 64
    lens = gen.integers(0, 300, size=B)
    lens[:192] = 256
    d = [as32(a) for a in (rows, starts, lens)]
    evals = [(ri, "sum"), (rf, "max"), (ri, "count")]
    before = wr.windowed_reduce.launches
    err = max(err, check_reduce(wr, evals, *d, 300, "many_evaluations"))
    if wr.windowed_reduce.launches - before != 1:
        raise AssertionError("three evaluations took more than one launch")
    evals9 = evals + [(rf, "min"), (ri, "prod"), (rf, "sum"), (ri, "max"),
                      (rf, "count"), (ri, "min")]
    before = wr.windowed_reduce.launches
    err = max(err, check_reduce(wr, evals9, *d, 300, "nine_evaluations"))
    if wr.windowed_reduce.launches - before != 2:
        raise AssertionError("nine evaluations did not take two launches")
    emit("kernel", case="many_evaluations", evals=[op for _, op in evals9],
         rows=R, B=B, ok=True)
    return err


def build_all():
    """nvcc for each kernel source and make for the native host library,
    all started together; returns {name: (result, seconds)}.  A failed
    build raises."""
    from concurrent.futures import ThreadPoolExecutor

    from windflow_tpu_torch import native
    from windflow_tpu_torch.ops import gather, skyline
    from windflow_tpu_torch.ops import ring as rk
    from windflow_tpu_torch.ops import windowed_reduce as wr

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    jobs = {"windowed_reduce.cu": wr.build, "resident.cu": rk.build,
            "gather.cu": gather.build, "skyline.cu": skyline.build,
            "libwfnative.so": native.load}
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {name: pool.submit(timed, fn) for name, fn in jobs.items()}
        done = {name: f.result() for name, f in futs.items()}
    if done["libwfnative.so"][0] is None:
        raise RuntimeError("the native host library did not build "
                           "(make -C native): the resident main path needs "
                           "it")
    return done


def ring_case(gen, dev, wire, acc, edge, K=KP, cap=CAP, Rb=RB, C=C_WINDOWS,
              slide=SLIDE, rlen=WIN, offs_mod=None):
    """Inputs of one append + regular evaluation: a ring with earlier
    contents, a rectangle whose rows >= K and tail columns are zero (as the
    executor stages it), per-row offsets (with `offs_mod`, each row's flat
    start r*cap + offs[r] is that residue mod 4) and regular window
    descriptors."""
    KP_ = KP if cap == CAP else 8
    if edge == "keys_lt_rows":
        K = KP_ - 3
    K = min(K, KP_)
    ring = (torch.from_numpy(gen.integers(-1000, 1000, size=(KP_, cap)))
            .to(acc))
    if acc == torch.float32:
        ring = torch.from_numpy(gen.uniform(-100, 100, size=(KP_, cap))).to(
            acc)
    blk = torch.zeros((KP_, Rb), dtype=wire)
    counts = gen.integers(Rb // 2, Rb + 1, size=K)
    for r in range(K):
        if wire == torch.float32:
            vals = torch.from_numpy(gen.uniform(-100, 100, size=counts[r]))
        elif edge == "int32_wrap":
            vals = torch.full((int(counts[r]),), 2 ** 30 if wire ==
                              torch.int32 else 100)
        else:
            vals = torch.from_numpy(gen.integers(0, 100, size=counts[r]))
        blk[r, :counts[r]] = vals.to(wire)
    offs = torch.zeros(KP_, dtype=torch.int32)
    offs[:K] = torch.from_numpy(gen.integers(Rb, cap - Rb + 1, size=K))
    if edge == "offs_at_end":
        offs[:K] = cap - Rb
    if offs_mod is not None:
        rows = torch.arange(K)
        offs[:K] -= (offs[:K] + rows * cap - offs_mod) % 4
    rstart0 = torch.zeros(KP_, dtype=torch.int32)
    rlens = torch.zeros(KP_, dtype=torch.int32)
    rstart0[:K] = (offs[:K] - (rlen - slide)).clamp(min=0)
    rlens[:K] = rlen
    if edge == "rows_without_windows":
        rlens[1:K:2] = 0
    if edge == "zero_length":
        rlens[:K] = 0
    if edge == "clip_low":
        rstart0[:K] = -torch.from_numpy(gen.integers(1, 4 * slide, size=K)
                                        ).to(torch.int32)
    if edge == "clip_high":
        rstart0[:K] = cap - torch.from_numpy(
            gen.integers(-slide, 2 * slide, size=K)).to(torch.int32)
    if edge == "int32_wrap" and acc == torch.int32:
        ring[:] = 2 ** 30
    return dict(ring=ring.to(dev), blk=blk.to(dev), offs=offs.to(dev),
                rstart0=rstart0.to(dev), rlen=rlens.to(dev), C=C,
                slide=slide)


def run_two_launches(rk, case):
    """ring_append, then the window sums alone (the fused kernel with an
    empty (KP, 0) rectangle)."""
    ring = rk.ring_append(case["ring"].clone(), case["blk"], case["offs"])
    KP = ring.shape[0]
    empty = torch.zeros((KP, 0), dtype=torch.int8, device=ring.device)
    return ring, rk.ring_append_regular_sum(
        ring, empty, torch.zeros_like(case["offs"]), case["rstart0"],
        case["rlen"], case["C"], case["slide"])


def run_fused(rk, case, plain):
    ring = case["ring"].clone()
    out = (rk.ring_append_regular_sum_reference if plain
           else rk.ring_append_regular_sum)(
        ring, case["blk"], case["offs"], case["rstart0"], case["rlen"],
        case["C"], case["slide"])
    return ring, out


def window_abs_sums(ring, rstart0, rlen, C, slide):
    """Σ|x| over each clipped regular window (float64, on the card)."""
    cap = ring.shape[1]
    cs = torch.zeros((ring.shape[0], cap + 1), dtype=torch.float64,
                     device=ring.device)
    torch.cumsum(ring.double().abs(), dim=1, out=cs[:, 1:])
    i = torch.arange(C, device=ring.device)
    s = (rstart0.long()[:, None] + i[None, :] * slide).clamp(0, cap)
    e = (s + rlen.long()[:, None]).clamp(0, cap)
    return cs.gather(1, e) - cs.gather(1, s)


def check_ring(rk, case, name):
    """The fused kernel (launched twice) and the two-launch sequence
    against the plain version on one case.  Rings must be identical; int32
    sums exact, float32
    sums within FLOAT_RTOL of Σ|x| over the window; the two fused launches
    bitwise equal.  Returns the window sums' largest error (the rings
    are identical or it raises)."""
    fused = [run_fused(rk, case, plain=False) for _ in range(2)]
    two = run_two_launches(rk, case)
    ring_p, out_p = run_fused(rk, case, plain=True)
    torch.cuda.synchronize()
    if not torch.equal(fused[0][1].view(torch.int32),
                       fused[1][1].view(torch.int32)):
        raise AssertionError(f"ring_append_regular_sum {name}: two launches "
                             "differ")
    scale = window_abs_sums(ring_p, case["rstart0"], case["rlen"],
                            case["C"], case["slide"])
    err = 0.0
    for label, (ring_k, out_k) in (("ring_append_regular_sum", fused[0]),
                                   ("ring_append + window sums alone",
                                    two)):
        if not torch.equal(ring_k, ring_p):
            raise AssertionError(f"{label} {name}: rings differ")
        if out_k.dtype == torch.int32:
            if not torch.equal(out_k, out_p):
                raise AssertionError(f"{label} {name}: sums differ")
            continue
        e = (out_k.double() - out_p.double()).abs()
        if not bool((e <= FLOAT_RTOL * scale).all()):
            raise AssertionError(f"{label} {name}: error {float(e.max())} "
                                 f"beyond rtol {FLOAT_RTOL}")
        err = max(err, float(e.max()))
    return err


def fused_bound(case):
    """(ms, by, bytes) of the fused kernel on these inputs: blk read once,
    the rectangle's cells inside the ring written once, the ring cells the
    windows cover outside the rectangle read once, the 3*KP descriptors
    and the (KP, C) sums; one add per window cell."""
    ring, blk, offs = case["ring"], case["blk"], case["offs"]
    KP, cap = ring.shape
    Rb, C, dev = blk.shape[1], case["C"], ring.device
    i = torch.arange(C, device=dev)
    s = (case["rstart0"].long()[:, None] + i[None, :] * case["slide"]).clamp(
        0, cap)
    e = (s + case["rlen"].long()[:, None]).clamp(0, cap)
    edges = torch.zeros((KP, cap + 1), dtype=torch.int32, device=dev)
    one = torch.ones_like(s, dtype=torch.int32)
    edges.scatter_add_(1, s, one)
    edges.scatter_add_(1, e, -one)
    cov = edges.cumsum(dim=1)[:, :cap] > 0
    col = torch.arange(cap, device=dev)[None, :]
    rect = (col >= offs.long()[:, None]) & (col < offs.long()[:, None] + Rb)
    nbytes = (blk.numel() * blk.element_size() + 4 * int(rect.sum())
              + 4 * int((cov & ~rect).sum()) + 12 * KP + 4 * KP * C)
    return (*bytes_bound(nbytes, int((e - s).sum())), nbytes)


def covered(starts, lens, rows=None):
    """Buffer cells the windows cover, each counted once."""
    rows = np.zeros(len(starts), np.int64) if rows is None else rows
    n = 0
    for r in np.unique(rows):
        sel = rows == r
        s, e = starts[sel], starts[sel] + lens[sel]
        order = np.argsort(s)
        end = -1
        for a, b in zip(s[order], e[order]):
            if b > max(a, end):
                n += b - max(a, end)
                end = b
    return int(n)


def bytes_bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ring_kernel_phase(dev):
    """The ring kernels against their plain versions at the resident main
    path's shape and at edge cases; the irregular evaluation against the
    _ring_eval transcription.  Returns the kernels-line rows."""
    from windflow_tpu_torch.ops import ring as rk
    from windflow_tpu_torch.ops import windowed_reduce as wr
    gen = np.random.default_rng(1)
    rows = {}

    # -- main-path shape: int8 wire into an int32 ring
    case = ring_case(gen, dev, torch.int8, torch.int32, "main")
    sum_err = check_ring(rk, case, "main_shape")
    ring = case["ring"].clone()
    blk, offs = case["blk"], case["offs"]
    rs0, rln = case["rstart0"], case["rlen"]
    f_ms = kernel_ms(lambda: rk.ring_append_regular_sum(
        ring, blk, offs, rs0, rln, C_WINDOWS, SLIDE))
    f_plain = call_ms(lambda: rk.ring_append_regular_sum_reference(
        ring, blk, offs, rs0, rln, C_WINDOWS, SLIDE))

    f_bound = fused_bound(case)
    a_ms = kernel_ms(lambda: rk.ring_append(ring, blk, offs))
    a_plain = call_ms(lambda: rk.ring_append_reference(ring, blk, offs))
    idx = offs.long()[:, None] + torch.arange(RB, device=dev)[None, :]
    a_lib = call_ms(lambda: ring.scatter_(1, idx, blk.to(torch.int32)))
    a_bound = bytes_bound(blk.numel() * (1 + 4) + 4 * KP, blk.numel())
    emit("ring_kernel", kernel="ring_append_regular_sum", case="main_shape",
         KP=KP, cap=CAP, Rb=RB, wire="int8", acc="int32", C=C_WINDOWS,
         slide=SLIDE, rlen=WIN, max_abs_err=sum_err, kernel_ms=f_ms,
         plain_ms=f_plain, library_ms=None,
         library_none_because="no single torch call appends and sums "
                              "clipped overlapping windows",
         bound_bytes=f_bound[2], bound_ms=f_bound[0], bound_by=f_bound[1])
    # ring_append at the regular-flush shape (its kernels-line row is timed
    # at the shape of its main-path launches, ring_append_phase)
    emit("ring_kernel", kernel="ring_append", case="regular_flush_shape",
         KP=KP, cap=CAP, Rb=RB, wire="int8", acc="int32", kernel_ms=a_ms,
         plain_ms=a_plain, library_ms=a_lib,
         library="ring.scatter_(1, idx, blk.to(int32))",
         bound_ms=a_bound[0], bound_by=a_bound[1])
    rows["ring_append_flush_shape"] = dict(
        ms=a_ms, plain_ms=a_plain, bound_ms=a_bound[0], library_ms=a_lib)
    rows["ring_append_regular_sum"] = dict(
        max_abs_err=sum_err, ms=f_ms, plain_ms=f_plain, bound_ms=f_bound[0],
        bound_by=f_bound[1], library_ms=None)

    # -- edge cases, every wire x accumulate dtype, at a small ring
    edges = ("plain", "keys_lt_rows", "rows_without_windows", "zero_length",
             "clip_low", "clip_high", "int32_wrap", "offs_at_end")
    for wire in WIRES:
        for acc in ACCS:
            for edge in edges:
                case = ring_case(gen, dev, wire, acc, edge, cap=4096, Rb=512,
                                 C=16, slide=24, rlen=40)
                b = check_ring(rk, case, f"{wire}->{acc} {edge}")
                rows["ring_append_regular_sum"]["max_abs_err"] = max(
                    rows["ring_append_regular_sum"]["max_abs_err"], b)
            emit("ring_kernel", case="edges", wire=str(wire), acc=str(acc),
                 edges=list(edges), ok=True)
    # the fused kernel's own edges: offsets at every residue mod 4 (the
    # append's head and tail peels), Rb not a multiple of 16 (the per-cell
    # path), C not a multiple of a warp's 2 windows, windows far apart,
    # windows of 5,000 cells across several append chunks
    shapes = {"rb40": dict(Rb=40), "rb8": dict(Rb=8, slide=4, rlen=12),
              "c37": dict(C=37),
              "wide_slide": dict(cap=16384, Rb=2048, C=20, slide=600,
                                 rlen=1000),
              "long_window": dict(cap=16384, Rb=4096, C=5, slide=2000,
                                  rlen=5000)}
    for acc in ACCS:
        for wire in (torch.int8, torch.float32):
            for label, kw in shapes.items():
                for offs_mod in range(4):
                    args = dict(cap=4096, Rb=512, C=16, slide=24, rlen=40)
                    args.update(kw)
                    case = ring_case(gen, dev, wire, acc, "plain",
                                     offs_mod=offs_mod, **args)
                    b = check_ring(rk, case, f"{wire}->{acc} {label} "
                                   f"offs%4={offs_mod}")
                    rows["ring_append_regular_sum"]["max_abs_err"] = max(
                        rows["ring_append_regular_sum"]["max_abs_err"], b)
        emit("ring_kernel", case="fused_edges", acc=str(acc),
             wires=["torch.int8", "torch.float32"], shapes=list(shapes),
             offs_mod=[0, 1, 2, 3], two_launches_bitwise_equal=True,
             ok=True)

    # -- the irregular evaluation: windowed_reduce over the ring's (row,
    # start, len) descriptors, every op in one launch
    for acc in ACCS:
        ring = (torch.from_numpy(gen.integers(0, 100, size=(KP, CAP)))
                .to(dev, acc))
        ring_p = (torch.from_numpy(gen.uniform(0.99, 1.01, size=(KP, CAP)))
                  .to(dev, acc) if acc == torch.float32
                  else torch.from_numpy(gen.integers(-2, 3, size=(KP, CAP)))
                  .to(dev, acc))
        B = BATCH_LEN
        rows_ = torch.from_numpy(gen.integers(0, KP, size=B)).to(dev,
                                                                 torch.int32)
        lens = torch.from_numpy(gen.integers(0, WIN + 1, size=B)).to(
            dev, torch.int32)
        starts = torch.from_numpy(gen.integers(0, CAP - WIN, size=B)).to(
            dev, torch.int32)
        evals = [(ring, "sum"), (ring, "min"), (ring, "max"),
                 (ring_p, "prod")]
        err = check_reduce(wr, evals, rows_, starts, lens, WIN,
                           f"ring_2d/{acc}")
        got = wr.windowed_reduce_many(evals, rows_, starts, lens, WIN)
        for (r, op), g in zip(evals, got):
            want = rk.ring_eval_reference(op, r, rows_, starts, lens, WIN)
            err = max(err, compare(g, want, r, starts, lens, op, rows_))
        emit("ring_kernel", kernel="windowed_reduce", case="ring_2d",
             ops=[op for _, op in evals], acc=str(acc), ring=[KP, CAP], B=B,
             pad=WIN, max_abs_err=err, twin_bitwise=True,
             kernel_ms=kernel_ms(lambda: wr.windowed_reduce_many(
                 evals, rows_, starts, lens, WIN)))
        del ring, ring_p
    return rows


# a ring of 2^32 int32 cells (16 GiB): the last row's cells lie past flat
# offset 2^32, out of reach of int32 flat starts
BIG_KEYS, BIG_CAP = 16, 1 << 28


def big_ring_phase(wr):
    """Windows on the last row of a ring of BIG_KEYS x BIG_CAP int32 cells,
    through ResidentWindowExecutor.launch: an append at each row's end
    minus 8192, then one at its end minus 4096 with windows over both,
    sum, max and min in one windowed_reduce launch, held against the plain
    version on that row (and the appended cells against the rectangles)."""
    from windflow_tpu_torch.ops.resident import ResidentWindowExecutor
    gen = np.random.default_rng(17)
    ex = ResidentWindowExecutor(("sum", "max", "min"), device=DEVICE)
    ex.reset(BIG_KEYS, BIG_CAP)
    if (ex.KP, ex.cap) != (BIG_KEYS, BIG_CAP):
        raise AssertionError(f"ring geometry {(ex.KP, ex.cap)}")
    R = 4096
    blks = [gen.integers(-30000, 30000, size=(BIG_KEYS, R)).astype(np.int16)
            for _ in range(2)]
    offs = [np.full(BIG_KEYS, BIG_CAP - 2 * R, np.int64),
            np.full(BIG_KEYS, BIG_CAP - R, np.int64)]
    B = 1000
    lens = gen.integers(0, 513, size=B).astype(np.int32)
    lens[:3] = (512, 0, 1)
    starts = (BIG_CAP - 2 * R + gen.integers(0, 2 * R - 512, size=B)).astype(
        np.int32)
    starts[0] = BIG_CAP - 512          # a window that ends at the row's end
    # ... and windows that end there whose last trip of 32 cells holds one
    # 16-byte group of the window or seven (the ring's last cells)
    lens[3:7] = (4, 28, 1, 25)
    starts[3:7] = BIG_CAP - lens[3:7]
    rows = np.full(B, BIG_KEYS - 1, np.int32)
    empty = np.zeros(0, np.int32)
    before = wr.windowed_reduce.launches
    ex.launch("fill", blks[0], offs[0], empty, empty, empty)
    ex.launch("eval", blks[1], offs[1], rows, starts, lens)
    ready = ex.drain()
    launches = wr.windowed_reduce.launches - before
    if [m for m, _ in ready] != ["fill", "eval"] or launches != 1:
        raise AssertionError(f"big ring: {[m for m, _ in ready]}, "
                             f"{launches} windowed_reduce launches")
    ring = ex._ring
    last = ring[BIG_KEYS - 1:BIG_KEYS]
    tail = last[0, BIG_CAP - 2 * R:].cpu().numpy()
    if not (np.array_equal(tail[:R], blks[0][-1])
            and np.array_equal(tail[R:], blks[1][-1])):
        raise AssertionError("big ring: the last row's appended cells "
                             "differ from the rectangles")
    d = [torch.from_numpy(a).to(DEVICE) for a in (starts, lens)]
    zero = torch.zeros(B, dtype=torch.int32, device=DEVICE)
    want = wr.windowed_reduce_many_reference(
        [(last, op) for op in ex.ops], zero, d[0], d[1], 512)
    for op, got, w in zip(ex.ops, ready[1][1], want):
        if not np.array_equal(got, w.cpu().numpy()):
            raise AssertionError(f"big ring: {op} differs from the plain "
                                 "version on the last row")
    emit("big_ring", ring=[BIG_KEYS, BIG_CAP], cells=BIG_KEYS * BIG_CAP,
         last_row_flat_offset=(BIG_KEYS - 1) * BIG_CAP, windows=B,
         ops=list(ex.ops), windowed_reduce_launches=launches, identical=True)
    del ex, ring, last
    torch.cuda.empty_cache()


@contextlib.contextmanager
def recorded_appends():
    """Records every ring_append call the resident executors make while
    active (the ring's shape and dtype, copies of the rectangle and the
    offsets); each call goes on to the wrapper unchanged."""
    from windflow_tpu_torch.ops import resident
    orig, calls = resident.ring_append, []

    def recording(ring, blk, offs):
        calls.append(dict(shape=tuple(ring.shape), dtype=ring.dtype,
                          blk=blk.clone(), offs=offs.clone()))
        return orig(ring, blk, offs)

    resident.ring_append = recording
    try:
        yield calls
    finally:
        resident.ring_append = orig


def ring_append_phase(dev, calls):
    """ring_append against its plain version on the inputs of every call in
    `calls` (the recorded rectangles and offsets into a ring of the
    recorded shape and dtype with seeded contents: rings identical), timed
    on the largest.  Its rectangle and the cells it writes fit in the
    card's L2, so a replay of the same inputs would find them there: the
    timed calls cycle through copies of the inputs whose sum is three
    times the L2 (at most 16 copies), each call on cold cells (the same inputs back to back
    are reported beside, as hot_l2_ms).  Returns the kernels-line row."""
    from windflow_tpu_torch.ops import ring as rk
    gen = torch.Generator(device=dev).manual_seed(5)
    rings = {}
    for c in calls:
        key = (c["shape"], c["dtype"])
        if key not in rings:
            rings[key] = (torch.rand(c["shape"], generator=gen, device=dev)
                          * 200 - 100).to(c["dtype"])
        got = rk.ring_append(rings[key].clone(), c["blk"], c["offs"])
        want = rk.ring_append_reference(rings[key].clone(), c["blk"],
                                        c["offs"])
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"ring_append {c['blk'].dtype} -> "
                                 f"{c['dtype']} {c['shape']}: rings differ")
        del got, want
    big = max(calls, key=lambda c: c["blk"].numel())
    ring = rings.pop((big["shape"], big["dtype"]))
    rings.clear()
    blk, offs = big["blk"], big["offs"]
    nbytes = (blk.numel() * (blk.element_size() + ring.element_size())
              + 4 * offs.numel())
    hot = kernel_ms(lambda: rk.ring_append(ring, blk, offs))
    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size",
                 50 << 20)
    copies = [(ring, blk)] + [(ring.clone(), blk.clone()) for _ in range(
        min(-(-3 * l2 // nbytes), 16) - 1)]
    idx = (offs.long()[:, None]
           + torch.arange(blk.shape[1], device=dev)[None, :])

    ms = kernel_ms(cycled(copies, lambda r, b: rk.ring_append(r, b, offs)),
                   reps=10 * len(copies))
    plain = call_ms(cycled(copies, lambda r, b: rk.ring_append_reference(
        r, b, offs)), reps=2 * len(copies))
    lib = call_ms(cycled(copies, lambda r, b: r.scatter_(
        1, idx, b.to(r.dtype))), reps=2 * len(copies))
    b = bytes_bound(nbytes, blk.numel())
    row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b[0],
               bound_by=b[1], library_ms=lib)
    emit("ring_kernel", kernel="ring_append", case="spatial_resident_calls",
         calls_checked=len(calls),
         shapes=sorted({(c["shape"], tuple(c["blk"].shape),
                         str(c["blk"].dtype), str(c["dtype"]))
                        for c in calls}, key=str),
         timed=dict(ring=list(big["shape"]), blk=list(blk.shape),
                    wire=str(blk.dtype), acc=str(big["dtype"])),
         copies=len(copies), l2_bytes=l2, kernel_ms=ms, hot_l2_ms=hot,
         plain_ms=plain, library_ms=lib,
         library="ring.scatter_(1, idx, blk.to(ring.dtype))",
         bound_bytes=nbytes, bound_ms=b[0], bound_by=b[1])
    return row


def stage_with_core(make_stage, cores):
    """A pattern whose make_core() also records the core it built."""
    stage = make_stage()
    orig = stage.make_core

    def recording():
        core = orig()
        cores.append(core)
        return core
    stage.make_core = recording
    return stage


def make_stream(schema, n_tuples):
    """Deterministic per-key-ordered integer stream (bench.py:make_stream)."""
    from windflow_tpu_torch import batch_from_columns
    per_key = n_tuples // N_KEYS
    batches = []
    rng = np.random.default_rng(7)
    for lo in range(0, per_key, CHUNK // N_KEYS):
        m = min(CHUNK // N_KEYS, per_key - lo)
        ids = np.repeat(np.arange(lo, lo + m), N_KEYS)
        keys = np.tile(np.arange(N_KEYS), m)
        vals = rng.integers(0, 100, size=m * N_KEYS).astype(np.int64)
        batches.append(batch_from_columns(
            schema, key=keys, id=ids, ts=ids, value=vals))
    return batches


def expected_total(batches) -> int:
    """Numpy oracle (bench.py:expected_total): the sum of every opened
    window's sum, complete windows and the partial ones flushed at EOS."""
    vals = np.concatenate([b["value"] for b in batches])
    keys = np.concatenate([b["key"] for b in batches])
    total = 0
    for k in range(N_KEYS):
        v = vals[keys == k]
        if not len(v):
            continue
        c = np.concatenate([[0], np.cumsum(v)])
        n_wins = (len(v) - 1) // SLIDE + 1
        starts = np.arange(n_wins) * SLIDE
        total += int(np.sum(c[np.minimum(starts + WIN, len(v))] - c[starts]))
    return total


def run_pipeline(stage, batches, schema, keep=False):
    """Source -> stage -> Sink; returns (seconds, windows, total, rows)."""
    import windflow_tpu_torch as wt
    n_out, total, kept = [0], [0], []

    def consume(rows):
        if rows is not None and len(rows):
            n_out[0] += len(rows)
            total[0] += int(rows["value"].sum())
            if keep:
                kept.append(rows.copy())

    df = wt.Dataflow()
    wt.build_pipeline(df, [wt.Source(batches=batches, schema=schema), stage,
                           wt.Sink(consume, vectorized=True)])
    t0 = time.perf_counter()
    df.run_and_wait_end()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, n_out[0], total[0], kept


def by_key(chunks):
    rows = np.concatenate(chunks)
    return {int(k): rows[rows["key"] == k].tobytes()
            for k in np.unique(rows["key"])}


def end_to_end(wr):
    import windflow_tpu_torch as wt
    schema = wt.Schema(value=np.int64)

    def gpu_stage():
        return wt.WinSeqGPU(wt.Reducer("sum"), WIN, SLIDE, wt.WinType.CB,
                            batch_len=BATCH_LEN, use_reduce_kernel=True,
                            device=DEVICE)

    # warm-up on a 1M-tuple prefix, held byte for byte against the host core
    prefix = make_stream(schema, PREFIX_TUPLES)
    _, n_dev, _, dev_rows = run_pipeline(gpu_stage(), prefix, schema, True)
    host = wt.WinSeq(wt.Reducer("sum"), WIN, SLIDE, wt.WinType.CB)
    _, n_host, _, host_rows = run_pipeline(host, prefix, schema, True)
    if n_dev != n_host or by_key(dev_rows) != by_key(host_rows):
        raise AssertionError("1M-tuple prefix: the device path differs "
                             "from the host core")
    emit("prefix_vs_host_core", tuples=PREFIX_TUPLES, windows=n_dev,
         identical=True)

    batches = make_stream(schema, N_TUPLES)
    want = expected_total(batches)
    torch.cuda.reset_peak_memory_stats()
    wr.windowed_reduce.launches = 0
    dt, n_windows, total, _ = run_pipeline(gpu_stage(), batches, schema)
    launches = wr.windowed_reduce.launches
    if total != want:
        raise AssertionError(f"windowed-sum total {total} != oracle {want}")
    if launches == 0:
        raise AssertionError("the main path launched no windowed_reduce "
                             "kernel")
    emit("end_to_end", workload="sum_test CB win=256 slide=64 keys=64",
         tuples=N_TUPLES, seconds=dt, tuples_per_s=N_TUPLES / dt,
         windows=n_windows, total=total, oracle=want, launches=launches,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    return launches


def resident_stage(wt, reducer=None):
    """The JAX package's bench.py stage, through the port's entry point:
    the default route of a builtin sum is the resident path."""
    return wt.WinSeqGPU(reducer or wt.Reducer("sum", value_range=(0, 100)),
                        WIN, SLIDE, wt.WinType.CB, batch_len=BATCH_LEN,
                        flush_rows=FLUSH_ROWS, depth=DEPTH, shards=1,
                        device=DEVICE)


def host_rows(wt, reducer, batches, schema):
    host = wt.WinSeq(reducer, WIN, SLIDE, wt.WinType.CB)
    return run_pipeline(host, batches, schema, keep=True)


def end_to_end_resident(wr, rk):
    """sum_test, 16M tuples, through NativeResidentCore and the ring
    kernels; returns the ring kernels' launch counts in that run: one
    fused launch a regular flush, ring_append only with an irregular
    launch's windowed_reduce."""
    import windflow_tpu_torch as wt
    from windflow_tpu_torch.ops import resident
    from windflow_tpu_torch.patterns.native_core import NativeResidentCore
    schema = wt.Schema(value=np.int64)

    # warm-up on a 1M-tuple prefix, held byte for byte against the host core
    prefix = make_stream(schema, PREFIX_TUPLES)
    _, n_dev, _, dev_rows = run_pipeline(resident_stage(wt), prefix, schema,
                                         True)
    _, n_host, _, want_rows = host_rows(wt, wt.Reducer("sum"), prefix,
                                        schema)
    if n_dev != n_host or by_key(dev_rows) != by_key(want_rows):
        raise AssertionError("1M-tuple prefix: the resident path differs "
                             "from the host core")
    emit("resident_prefix_vs_host_core", tuples=PREFIX_TUPLES,
         windows=n_dev, identical=True)

    batches = make_stream(schema, N_TUPLES)
    want = expected_total(batches)
    cores = []
    stage = stage_with_core(lambda: resident_stage(wt), cores)
    torch.cuda.reset_peak_memory_stats()
    resident.stats_snapshot(reset=True)
    counters = (rk.ring_append_regular_sum, rk.ring_append,
                wr.windowed_reduce)
    for c in counters:
        c.launches = 0
    dt, n_windows, total, _ = run_pipeline(stage, batches, schema)
    launches = {c.__name__: c.launches for c in counters}
    stats = resident.stats_snapshot(reset=True)
    if not (len(cores) == 1 and isinstance(cores[0], NativeResidentCore)):
        raise AssertionError(f"the stage's core is {cores}, not the port's "
                             "NativeResidentCore")
    if cores[0]._delegate is not None:
        raise AssertionError("NativeResidentCore fell back to the Python "
                             "core")
    if total != want:
        raise AssertionError(f"windowed-sum total {total} != oracle {want}")
    # every dispatch is one regular flush (one fused launch) or one
    # irregular launch (ring_append + windowed_reduce for the one op)
    if not (launches["ring_append_regular_sum"] > 0
            and launches["ring_append"] == launches["windowed_reduce"]
            and stats["dispatches"] == launches["ring_append_regular_sum"]
            + launches["ring_append"]):
        raise AssertionError(f"the resident path launched {launches}, "
                             f"dispatches {stats['dispatches']}")
    emit("end_to_end_resident",
         workload="sum_test CB win=256 slide=64 keys=64 resident",
         tuples=N_TUPLES, seconds=dt, tuples_per_s=N_TUPLES / dt,
         windows=n_windows, total=total, oracle=want, launches=launches,
         stats=stats, max_memory_allocated=torch.cuda.max_memory_allocated())
    return launches


def irregular_and_python_core(wr, rk):
    """Reducer("max") on the native core (irregular launches: the
    windowed-reduce kernel on the ring) and Reducer("sum") on the Python
    resident core, each byte for byte against the host core."""
    import windflow_tpu_torch as wt
    from windflow_tpu_torch.core.windows import WindowSpec
    from windflow_tpu_torch.patterns.native_core import NativeResidentCore
    from windflow_tpu_torch.patterns.win_seq_gpu import ResidentWinSeqCore
    schema = wt.Schema(value=np.int64)
    prefix = make_stream(schema, PREFIX_TUPLES)
    spec = WindowSpec(WIN, SLIDE, wt.WinType.CB)

    def python_core_stage():
        stage = resident_stage(wt)
        stage.make_core = lambda: ResidentWinSeqCore(
            spec, wt.Reducer("sum", value_range=(0, 100)),
            batch_len=BATCH_LEN, flush_rows=FLUSH_ROWS, device=DEVICE,
            depth=DEPTH)
        return stage

    runs = (("max", "native", lambda: resident_stage(
                 wt, wt.Reducer("max", value_range=(0, 100))),
             NativeResidentCore),
            ("sum", "python", python_core_stage, ResidentWinSeqCore))
    for op, name, make, cls in runs:
        cores = []
        stage = stage_with_core(make, cores)
        counters = (wr.windowed_reduce, rk.ring_append,
                    rk.ring_append_regular_sum)
        counts = [c.launches for c in counters]
        _, n_dev, _, dev_rows = run_pipeline(stage, prefix, schema, True)
        counts = [c.launches - a for c, a in zip(counters, counts)]
        if not (len(cores) == 1 and type(cores[0]) is cls
                and getattr(cores[0], "_delegate", None) is None):
            raise AssertionError(f"{op}/{name}: the stage's core is {cores}")
        if counts[0] == 0 or counts[1] == 0:
            raise AssertionError(f"{op}/{name}: launches {counts}")
        _, n_host, _, want_rows = host_rows(wt, wt.Reducer(op), prefix,
                                            schema)
        if n_dev != n_host or by_key(dev_rows) != by_key(want_rows):
            raise AssertionError(f"{op}/{name}: the resident path differs "
                                 "from the host core")
        emit("irregular_and_python_core", op=op, core=cls.__name__,
             tuples=PREFIX_TUPLES, windows=n_dev, identical=True,
             launches={"windowed_reduce": counts[0],
                       "ring_append": counts[1],
                       "ring_append_regular_sum": counts[2]})


# spatial_test wf-gpu's shape (apps/spatial.py defaults: 80,000 points/s
# for 8 s, TB window 50 ms, slide 12.5 ms, pardegree 2, batch_len 256,
# chunk 2048, one key): the deterministic stream stamps point v with
# ts = v in units of 1/80,000 s, so a window spans 4,000 points and a
# slide 1,000
SP_POINTS = 640_000
SP_WIN, SP_SLIDE = 4000, 1000
SP_CHUNK = 2048
SP_PARDEGREE = 2
SP_BATCH = 256
# one launch of the spatial run: 256 windows in (B, pad) tiles, over the
# per-field float32 rings its core allocates (8 rows, cap 2**22: the
# rebase sizes cap for 2 * flush_rows of slack)
SP_B, SP_PAD = 256, 4096
SP_KP, SP_CAP = 8, 1 << 22
SP_PREFIX_WINDOWS = 16
GRID = 256            # coordinates on a 1/256 grid: float32 compute exact
MULTI_TUPLES = 4_000_000


def check_gather(g, bufs, rows, starts, lens, pad, name):
    """Kernel against plain version: tiles and mask bit for bit, in
    ceil(fields / FIELDS_PER_LAUNCH) launches."""
    before = g.window_gather.launches
    tiles, mask = g.window_gather(bufs, rows, starts, lens, pad)
    launched = g.window_gather.launches - before
    want, want_mask = g.window_gather_reference(bufs, rows, starts, lens,
                                                pad)
    torch.cuda.synchronize()
    if len(starts) and launched != -(-len(bufs) // g.FIELDS_PER_LAUNCH):
        raise AssertionError(f"window_gather {name}: {launched} launches "
                             f"for {len(bufs)} fields")
    if not torch.equal(mask, want_mask):
        raise AssertionError(f"window_gather {name}: masks differ")
    for t, w in zip(tiles, want):
        if not torch.equal(t, w):
            raise AssertionError(f"window_gather {name}: tiles differ")


def gather_phase(dev):
    """window_gather at the spatial launch's shape and at edge cases;
    returns the kernels-line row."""
    from windflow_tpu_torch.ops import gather as g
    gen = np.random.default_rng(3)
    tgen = torch.Generator(device=dev).manual_seed(3)
    rx = torch.rand((SP_KP, SP_CAP), generator=tgen, device=dev) * 100
    ry = torch.rand((SP_KP, SP_CAP), generator=tgen, device=dev) * 100
    starts_np = SP_CAP // 40 + np.arange(SP_B) * SP_SLIDE
    lens_np = np.full(SP_B, SP_WIN)
    lens_np[-4:] = (3500, 2001, 1, 0)
    rows = torch.zeros(SP_B, dtype=torch.int32, device=dev)
    starts = torch.from_numpy(starts_np).to(dev, torch.int32)
    lens = torch.from_numpy(lens_np).to(dev, torch.int32)
    check_gather(g, (rx, ry), rows, starts, lens, SP_PAD, "main_shape")
    ri = (rx * 1000).to(torch.int32)
    check_gather(g, (ri,), rows, starts, lens, SP_PAD, "main_shape_int32")
    # rows of an odd pad straddle 16-byte edges; mixed dtypes in one launch
    check_gather(g, (rx, ri, ry), rows, starts, lens, SP_PAD - 3,
                 "main_shape_pad4093_mixed")
    del ri

    def kernel():
        g.window_gather((rx, ry), rows, starts, lens, SP_PAD)

    k_ms = kernel_ms(kernel)
    p_ms = call_ms(lambda: g.window_gather_reference(
        (rx, ry), rows, starts, lens, SP_PAD))
    lane = torch.arange(SP_PAD, device=dev)
    idx = (rows.long()[:, None] * SP_CAP
           + (starts.long()[:, None] + lane[None, :]).clamp(max=SP_CAP - 1))
    live = lane[None, :] < lens.long()[:, None]
    zero = torch.zeros((), device=dev)
    l_ms = call_ms(lambda: [torch.where(live, torch.take(r, idx), zero)
                            for r in (rx, ry)])
    cells = covered(starts_np, lens_np)
    b_ms, b_by = bytes_bound(SP_B * SP_PAD * (2 * 4 + 1) + 2 * 4 * cells
                             + 12 * SP_B, 0)
    emit("gather_kernel", case="main_shape", B=SP_B, pad=SP_PAD,
         ring=[SP_KP, SP_CAP], fields=2, covered_cells=cells,
         max_abs_err=0.0, kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
         library="torch.where(mask, torch.take(ring, idx), 0) per field, "
                 "idx and mask precomputed",
         bound_ms=b_ms, bound_by=b_by)
    del rx, ry

    # edge cases on small buffers, int32 and float32
    for dtype in (torch.int32, torch.float32):
        cap = 256
        buf = torch.from_numpy(gen.integers(-1000, 1000, size=(4, cap))).to(
            dev, dtype)
        cases = {
            "len0": ([1, 2, 3], [0, 10, 250], [0, 7, 0]),
            "past_end_clamp": ([0, 3, 2, 1], [cap - 10, cap - 3, 200, 255],
                               [10, 3, 56, 1]),
            "len_past_ncols": ([0, 1], [cap - 5, 250], [20, 64]),
            "B1": ([2], [17], [64]),
        }
        for name, (r, st, ln) in cases.items():
            as32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
            check_gather(g, (buf, buf * 2), as32(r), as32(st), as32(ln), 64,
                         f"{name}/{dtype}")
        flat = buf.reshape(1, -1)       # the restaging one-row form
        st = gen.integers(0, flat.shape[1] - 40, size=37)
        ln = gen.integers(0, 41, size=37)
        ln[::6] = 0
        check_gather(g, (flat,), None,
                     torch.from_numpy(st).to(dev, torch.int32),
                     torch.from_numpy(ln).to(dev, torch.int32), 64,
                     f"one_row/{dtype}")
        for pad in (61, 62, 63, 1023):
            check_gather(g, (flat,), None,
                         torch.from_numpy(st).to(dev, torch.int32),
                         torch.from_numpy(ln).to(dev, torch.int32), pad,
                         f"one_row_pad{pad}/{dtype}")
        empty = torch.zeros((1, 0), dtype=dtype, device=dev)
        z = torch.zeros(3, dtype=torch.int32, device=dev)
        check_gather(g, (empty,), None, z, z, 8, f"empty_buffer/{dtype}")
        emit("gather_kernel", case="edges", dtype=str(dtype),
             edges=list(cases) + ["one_row", "one_row_odd_pads",
                                  "empty_buffer"], ok=True)
    # 9 and 16 fields of mixed dtypes: two launches, the mask from the first
    cap = 2048
    fields = [torch.from_numpy(gen.integers(-1000, 1000, size=(4, cap))).to(
        dev, torch.int32 if k % 2 else torch.float32) for k in range(16)]
    B = 300
    r = torch.from_numpy(gen.integers(0, 4, size=B)).to(dev, torch.int32)
    st = torch.from_numpy(gen.integers(0, cap, size=B)).to(dev, torch.int32)
    ln = torch.from_numpy(gen.integers(0, 514, size=B)).to(dev, torch.int32)
    for nf in (9, 16):
        for pad in (512, 515):
            check_gather(g, fields[:nf], r, st, ln, pad,
                         f"fields{nf}_pad{pad}")
    emit("gather_kernel", case="many_fields", fields=[9, 16],
         pads=[512, 515], dtypes="int32 and float32 alternating", ok=True)
    return dict(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=l_ms)


def skyline_oracle(x, y):
    """(size, checksum) of the 2-D min/min skyline of the points (x, y) by
    a sort and sweep, O(n log n): within a run of equal x only the
    smallest y can survive (with its duplicates), and it survives when
    every smaller x has a larger y."""
    if len(x) == 0:
        return 0, 0.0
    order = np.lexsort((y, x))
    xs, ys = x[order], y[order]
    first = np.flatnonzero(np.r_[True, xs[1:] != xs[:-1]])
    ends = np.r_[first[1:], len(xs)]
    gy = ys[first]
    before = np.r_[np.inf, np.minimum.accumulate(gy)[:-1]]
    size, total = 0, 0.0
    for k in np.flatnonzero(gy < before):
        a, b = first[k], ends[k]
        n = int(np.searchsorted(ys[a:b], gy[k], side="right"))
        size += n
        total += n * float(np.float32(xs[a]) + np.float32(ys[a]))
    return size, total


def pair_tests_needed(x, y, mask):
    """Pair tests the skyline of these windows needs: each real point's
    tests in lane order up to its first dominator, every lane below
    hi (1 + the last real lane) for a survivor."""
    B, pad = x.shape
    lane = torch.arange(pad, device=x.device)
    hi = torch.where(mask, lane + 1, 0).amax(dim=1)
    total = 0
    for b0 in range(0, B, 4):
        xb, yb, mb = x[b0:b0 + 4], y[b0:b0 + 4], mask[b0:b0 + 4]
        xi, yi = xb[:, :, None], yb[:, :, None]
        xj, yj = xb[:, None, :], yb[:, None, :]
        dom = (((xj <= xi) & (yj <= yi)) & ((xj < xi) | (yj < yi))
               & mb[:, None, :])
        first = dom.to(torch.int8).argmax(dim=2) + 1
        tests = torch.where(dom.any(dim=2), first, hi[b0:b0 + 4, None])
        total += int(torch.where(mb, tests, 0).sum())
    return total


def check_skyline(sk, x, y, mask, name, exact=True, oracle=True):
    """Kernel against plain version and (with `oracle`) the numpy oracle:
    sizes exact; checksums exact on the grid (NaN where the plain version
    has NaN), else within FLOAT_RTOL of the checksum (a sum of positive
    terms).  Returns the max abs checksum error."""
    size, cs = sk.skyline_windows(x, y, mask)
    want_size, want_cs = sk.skyline_windows_reference(x, y, mask)
    torch.cuda.synchronize()
    if not torch.equal(size, want_size):
        raise AssertionError(f"skyline_windows {name}: sizes differ")
    same = (cs == want_cs) | (torch.isnan(cs) & torch.isnan(want_cs))
    diff = torch.where(same, 0.0, (cs.double() - want_cs.double()).abs())
    err = float(diff.max()) if len(cs) else 0.0
    if exact and not bool(same.all()):
        raise AssertionError(f"skyline_windows {name}: checksums differ")
    if not exact and not bool((diff <= FLOAT_RTOL
                               * want_cs.double().abs()).all()):
        raise AssertionError(f"skyline_windows {name}: checksum error "
                             f"{err} beyond rtol {FLOAT_RTOL}")
    if not oracle:
        return err
    xs, ys, ms = x.cpu().numpy(), y.cpu().numpy(), mask.cpu().numpy()
    for b in range(len(xs)):
        n, total = skyline_oracle(xs[b][ms[b]], ys[b][ms[b]])
        if n != int(size[b]) or (exact and total != float(cs[b])):
            raise AssertionError(f"skyline_windows {name}: window {b} gives "
                                 f"({int(size[b])}, {float(cs[b])}), the "
                                 f"oracle ({n}, {total})")
    return err


def grid_points(gen, shape):
    return np.round(gen.uniform(0, 100, size=shape) * GRID) / GRID


def skyline_phase(dev):
    """skyline_windows at the spatial launch's shape and at edge cases;
    returns the kernels-line row."""
    from windflow_tpu_torch.ops import skyline as sk
    gen = np.random.default_rng(5)
    lens = np.full(SP_B, SP_WIN)
    lens[-4:] = (3500, 2001, 1, 0)
    live = np.arange(SP_PAD)[None, :] < lens[:, None]
    x = torch.from_numpy(np.where(live, grid_points(gen, (SP_B, SP_PAD)), 0)
                         ).to(dev, torch.float32)
    y = torch.from_numpy(np.where(live, grid_points(gen, (SP_B, SP_PAD)), 0)
                         ).to(dev, torch.float32)
    mask = torch.from_numpy(live).to(dev)
    check_skyline(sk, x, y, mask, "main_shape")
    # determinism: two launches on the same inputs agree bit for bit
    (s1, c1), (s2, c2) = (sk.skyline_windows(x, y, mask) for _ in range(2))
    torch.cuda.synchronize()
    if not (torch.equal(s1, s2) and torch.equal(c1.view(torch.int32),
                                                c2.view(torch.int32))):
        raise AssertionError("skyline_windows: two launches differ")
    k_ms = kernel_ms(lambda: sk.skyline_windows(x, y, mask), reps=10)
    p_ms = call_ms(lambda: sk.skyline_windows_reference(x, y, mask), reps=2)
    tests = pair_tests_needed(x, y, mask)
    b_ms, b_by = bytes_bound(SP_B * SP_PAD * 9 + 8 * SP_B, 4 * tests)
    emit("skyline_kernel", case="main_shape", B=SP_B, pad=SP_PAD,
         points=int(lens.sum()), pair_tests=tests, max_abs_err=0.0,
         kernel_ms=k_ms, plain_ms=p_ms, library_ms=None,
         library_none_because="no single torch call computes a skyline",
         bound_ms=b_ms, bound_by=b_by)

    def small(B, pad, n, coords):
        m = np.arange(pad)[None, :] < np.asarray(n)[:, None]
        xs, ys = coords(gen, (B, pad))
        return (torch.from_numpy(np.where(m, xs, 0)).to(dev, torch.float32),
                torch.from_numpy(np.where(m, ys, 0)).to(dev, torch.float32),
                torch.from_numpy(m).to(dev))

    grid = lambda g, shp: (grid_points(g, shp), grid_points(g, shp))
    err = 0.0
    x, y, m = small(3, 64, [0, 0, 0], grid)
    check_skyline(sk, x, y, m, "all_masked")
    x, y, m = small(4, 64, [1, 1, 64, 2], grid)
    check_skyline(sk, x, y, m, "n1")
    x, y, m = small(6, 128, [128, 100, 37, 128, 5, 90], grid)
    x[:, 1::2] = x[:, 0::2]            # every point twice
    y[:, 1::2] = y[:, 0::2]
    check_skyline(sk, x, y, m, "duplicates")
    x, y, m = small(6, 128, [128, 120, 64, 33, 128, 7], grid)
    x = torch.floor(x / 25) * 25       # four distinct x values
    y[3:] = torch.floor(y[3:] / 50) * 50
    check_skyline(sk, x, y, m, "ties")
    x, y, m = small(5, 2048, [2048, 1500, 1025, 1024, 3000], grid)
    m &= torch.from_numpy(gen.random((5, 2048)) < 0.7).to(dev)
    check_skyline(sk, x, y, m, "mask_holes_and_tiles")
    x, y, m = small(5, 1023, [1023, 1000, 517, 31, 1], grid)
    check_skyline(sk, x, y, m, "odd_pad")
    # NaN and +-inf coordinates in real lanes (the fn's comparisons decide;
    # the sort-and-sweep oracle does not model NaN)
    x, y, m = small(6, 256, [256, 200, 256, 64, 256, 3], grid)
    special = torch.tensor([float("nan"), float("inf"), float("-inf")],
                           device=dev)
    for t in (x, y):
        pick = torch.from_numpy(gen.random((6, 256)) < 0.05).to(dev)
        kind = torch.from_numpy(gen.integers(0, 3, size=(6, 256))).to(dev)
        t[pick & m] = special[kind[pick & m]]
    x[2], y[2] = float("inf"), float("inf")       # every point (inf, inf)
    x[3, :32], y[3, :32] = float("nan"), 1.0      # NaN sums in a whole chunk
    x[4, ::2] = float("-inf")
    check_skyline(sk, x, y, m, "nan_inf", oracle=False)
    # pads whose window takes all of a block's shared memory (16384), and
    # above that budget (32768: the same kernel over device memory)
    for pad, n in ((16384, [16384, 9000]), (32768, [32768, 20000, 0])):
        x, y, m = small(len(n), pad, n, grid)
        check_skyline(sk, x, y, m, f"pad{pad}")
    uniform = lambda g, shp: (g.uniform(0, 100, size=shp),
                              g.uniform(0, 100, size=shp))
    x, y, m = small(16, 4096, [4000] * 15 + [4096], uniform)
    err = max(err, check_skyline(sk, x, y, m, "unquantised", exact=False))
    emit("skyline_kernel", case="edges",
         edges=["all_masked", "n1", "duplicates", "ties",
                "mask_holes_and_tiles", "odd_pad", "nan_inf", "pad16384",
                "pad32768", "unquantised"],
         deterministic=True, unquantised_max_abs_err=err, ok=True)
    return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def spatial_stream(seed=11):
    """Deterministic spatial_test stream: SP_POINTS points of one key,
    uniform on the 1/256 grid, ts = point index."""
    import windflow_tpu_torch as wt
    from windflow_tpu_torch.apps.spatial import POINT_SCHEMA
    rng = np.random.default_rng(seed)
    out = []
    for lo in range(0, SP_POINTS, SP_CHUNK):
        m = min(SP_CHUNK, SP_POINTS - lo)
        ids = np.arange(lo, lo + m)
        out.append(wt.batch_from_columns(
            POINT_SCHEMA, key=np.zeros(m, np.int64), id=ids, ts=ids,
            x=grid_points(rng, m), y=grid_points(rng, m)))
    return out


def run_rows(stage, batches, schema):
    """Source -> stage -> Sink; returns (seconds, result rows by id)."""
    import windflow_tpu_torch as wt
    rows = []

    def consume(r):
        if r is not None and len(r):
            rows.append(r.copy())

    df = wt.Dataflow()
    wt.build_pipeline(df, [wt.Source(batches=batches, schema=schema), stage,
                           wt.Sink(consume, vectorized=True)])
    t0 = time.perf_counter()
    df.run_and_wait_end()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rows = np.concatenate(rows)
    return dt, rows[np.argsort(rows["id"], kind="stable")]


def check_spatial_oracle(rows, batches, name):
    """Every window's (size, checksum) against the sort-and-sweep oracle:
    window w holds the points with w*slide <= ts < w*slide + win."""
    x = np.concatenate([b["x"] for b in batches]).astype(np.float32)
    y = np.concatenate([b["y"] for b in batches]).astype(np.float32)
    ts = np.concatenate([b["ts"] for b in batches])
    if len(np.unique(rows["id"])) != len(rows):
        raise AssertionError(f"{name}: duplicate window ids")
    for r in rows:
        lo = int(r["id"]) * SP_SLIDE
        a, b = np.searchsorted(ts, [lo, lo + SP_WIN])
        n, total = skyline_oracle(x[a:b], y[a:b])
        if n != int(r["size"]) or total != float(r["checksum"]):
            raise AssertionError(
                f"{name}: window {int(r['id'])} gives ({int(r['size'])}, "
                f"{float(r['checksum'])}), the oracle ({n}, {total})")


def spatial_phases(wr, rk):
    """The spatial skyline, resident and restaging routes, against the
    oracle and the host core; returns the main path's launch counts and
    its ring_append calls (recorded_appends)."""
    import windflow_tpu_torch as wt
    from windflow_tpu_torch.apps.spatial import (POINT_SCHEMA,
                                                 SkylineWindow,
                                                 device_skyline)
    from windflow_tpu_torch.ops import gather as g
    from windflow_tpu_torch.ops import skyline as sk
    batches = spatial_stream()

    def farm(**kw):
        return wt.WinFarmGPU(device_skyline(), SP_WIN, SP_SLIDE,
                             wt.WinType.TB, pardegree=SP_PARDEGREE,
                             batch_len=SP_BATCH, device=DEVICE, **kw)

    counters = (rk.ring_append, g.window_gather, sk.skyline_windows,
                wr.windowed_reduce)
    runs = {}
    for name, kw in (("spatial_resident", dict(use_resident=True)),
                     ("spatial_restaging", {})):
        for c in counters:
            c.launches = 0
        with recorded_appends() as calls:
            dt, rows = run_rows(farm(**kw), batches, POINT_SCHEMA)
        launches = {c.__name__: c.launches for c in counters}
        check_spatial_oracle(rows, batches, name)
        # one gather launch per fn launch (both fields in one); the
        # resident run: 2 workers x (a full batch + EOS), 2 rings each
        if name == "spatial_resident":
            ok = (launches["window_gather"] == 4
                  and launches["skyline_windows"] == 4
                  and launches["ring_append"] == 8)
        else:
            ok = (launches["window_gather"] == launches["skyline_windows"]
                  > 0 and launches["ring_append"] == 0)
        if not ok:
            raise AssertionError(f"{name}: launches {launches}")
        runs[name] = (rows, launches, calls)
        emit(name, workload="spatial_test wf-gpu TB win=4000 slide=1000 "
             "points, pardegree 2, batch_len 256", points=SP_POINTS,
             windows=len(rows), seconds=dt, windows_per_s=len(rows) / dt,
             points_per_s=SP_POINTS / dt,
             skyline_points=int(rows["size"].sum()), oracle_match=True,
             launches=launches)
    if runs["spatial_resident"][0].tobytes() != \
            runs["spatial_restaging"][0].tobytes():
        raise AssertionError("the resident and restaging routes differ")

    # a prefix of the windows against the port's host core
    n_prefix = (SP_PREFIX_WINDOWS - 1) * SP_SLIDE + SP_WIN
    prefix = [b[b["ts"] < n_prefix] for b in batches[:n_prefix // SP_CHUNK
                                                         + 1]]
    _, host = run_rows(wt.WinSeq(SkylineWindow(), SP_WIN, SP_SLIDE,
                                 wt.WinType.TB), prefix, POINT_SCHEMA)
    dev = runs["spatial_resident"][0]
    host = host[host["id"] < SP_PREFIX_WINDOWS]
    dev = dev[dev["id"] < SP_PREFIX_WINDOWS]
    if (host.dtype != dev.dtype or len(host) != SP_PREFIX_WINDOWS
            or host.tobytes() != dev.tobytes()):
        raise AssertionError("spatial prefix: the device windows differ "
                             "from the host core's")
    emit("spatial_prefix_vs_host_core", windows=SP_PREFIX_WINDOWS,
         identical=True)
    return runs["spatial_resident"][1:]


def spatial_app():
    """apps.spatial.run("wf-gpu") at its defaults, rate-paced."""
    from windflow_tpu_torch.apps import spatial
    out = spatial.run("wf-gpu", device=DEVICE)
    if not out.get("windows"):
        raise AssertionError(f"spatial wf-gpu delivered no window: {out}")
    emit("spatial_app", **out)


@contextlib.contextmanager
def counted_launches(cls):
    """Counts the calls of ``cls.launch`` while active: all of them, and
    those that evaluate windows (B > 0); each call goes on unchanged."""
    orig, seen = cls.launch, {"calls": 0, "with_windows": 0}

    def counting(self, meta, blks, offs, wrows, wstarts, *args, **kw):
        seen["calls"] += 1
        seen["with_windows"] += int(len(wstarts) > 0)
        return orig(self, meta, blks, offs, wrows, wstarts, *args, **kw)

    cls.launch = counting
    try:
        yield seen
    finally:
        cls.launch = orig


def multi_field_native(wr, rk):
    """sum(a) + max(b) + count over CB 256/64, 64 keys, 4M tuples: the
    native core's per-field rings against the port's host core."""
    import windflow_tpu_torch as wt
    schema = wt.Schema(a=np.int64, b=np.int64)
    per_key = MULTI_TUPLES // N_KEYS
    rng = np.random.default_rng(13)
    batches = []
    for lo in range(0, per_key, CHUNK // N_KEYS):
        m = min(CHUNK // N_KEYS, per_key - lo)
        ids = np.repeat(np.arange(lo, lo + m), N_KEYS)
        batches.append(wt.batch_from_columns(
            schema, key=np.tile(np.arange(N_KEYS), m), id=ids, ts=ids,
            a=rng.integers(0, 100, size=m * N_KEYS),
            b=rng.integers(-30000, 30000, size=m * N_KEYS)))

    def agg():
        return wt.MultiReducer(("sum", "a", "sa"), ("max", "b", "mb"),
                               ("count", None, "n"))

    from windflow_tpu_torch.ops.resident import MultiFieldResidentExecutor
    cores = []
    stage = stage_with_core(lambda: wt.WinSeqGPU(
        agg(), WIN, SLIDE, wt.WinType.CB, batch_len=BATCH_LEN,
        flush_rows=FLUSH_ROWS, depth=DEPTH, device=DEVICE), cores)
    counts = (wr.windowed_reduce.launches, rk.ring_append.launches)
    with counted_launches(MultiFieldResidentExecutor) as dispatches:
        dt, rows = run_rows(stage, batches, schema)
    counts = {"windowed_reduce": wr.windowed_reduce.launches - counts[0],
              "ring_append": rk.ring_append.launches - counts[1]}
    if not (len(cores) == 1 and getattr(cores[0], "_multi", False)
            and cores[0]._delegate is None):
        raise AssertionError(f"multi_field_native: the core is {cores}")
    # every stat of a dispatch in one windowed_reduce launch (the JAX
    # step evaluates them in one jitted step)
    if (counts["ring_append"] == 0 or counts["windowed_reduce"] == 0
            or counts["windowed_reduce"] != dispatches["with_windows"]):
        raise AssertionError(f"multi_field_native: launches {counts}, "
                             f"dispatches {dispatches}")
    _, host = run_rows(wt.WinSeq(agg(), WIN, SLIDE, wt.WinType.CB), batches,
                       schema)
    if by_key([rows]) != by_key([host]):
        raise AssertionError("multi_field_native: the per-field rings "
                             "differ from the host core")
    emit("multi_field_native", workload="MultiReducer(sum(a), max(b), "
         "count) CB win=256 slide=64 keys=64", tuples=MULTI_TUPLES,
         seconds=dt, tuples_per_s=MULTI_TUPLES / dt, windows=len(rows),
         fields=list(cores[0]._ship_fields), identical=True,
         launches=counts, dispatches=dispatches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run",
              file=sys.stderr)
        return 2
    from windflow_tpu_torch.ops import ring as rk
    from windflow_tpu_torch.ops import windowed_reduce as wr

    smi = nvidia_smi_line()
    emit("environment", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    for name, (out, sec) in build_all().items():
        emit("build", source=name, seconds=sec,
             library=out if isinstance(out, str) else out._name)

    dev = torch.device(DEVICE)
    row = kernel_phase(wr, dev)
    rows = ring_kernel_phase(dev)
    big_ring_phase(wr)
    restaging_launches = end_to_end(wr)
    resident_launches = end_to_end_resident(wr, rk)
    irregular_and_python_core(wr, rk)
    gather_row = gather_phase(dev)
    skyline_row = skyline_phase(dev)
    spatial_launches, spatial_appends = spatial_phases(wr, rk)
    rows["ring_append"] = ring_append_phase(dev, spatial_appends)
    spatial_app()
    multi_field_native(wr, rk)

    kernels = [dict(
        name="windowed_reduce", route="cuda",
        source="windflow_tpu_torch/ops/csrc/windowed_reduce.cu",
        replaces="windflow_tpu/ops/pallas_kernels.py:49",
        launches=restaging_launches, max_abs_err=row["max_abs_err"],
        ms=row["ms"], cold_ms=row["cold_ms"], plain_ms=row["plain_ms"],
        bound_ms=row["bound_ms"], bound_by=row["bound_by"],
        library_ms=None)]
    # ring_append's row: the spatial resident run's launches (the per-field
    # rings append every launch), checked and timed at their own inputs; in
    # sum_test it runs only with the irregular launches, the regular
    # flushes append inside the fused kernel
    for name, replaces, launches in (
            ("ring_append", "windflow_tpu/ops/resident.py:234",
             spatial_launches["ring_append"]),
            ("ring_append_regular_sum", "windflow_tpu/ops/resident.py:183",
             resident_launches["ring_append_regular_sum"])):
        kernels.append(dict(
            name=name, route="cuda",
            source="windflow_tpu_torch/ops/csrc/resident.cu",
            replaces=replaces, launches=launches, **rows[name]))
    kernels.append(dict(
        name="window_gather", route="cuda",
        source="windflow_tpu_torch/ops/csrc/gather.cu",
        replaces="windflow_tpu/ops/resident.py:618, "
                 "windflow_tpu/ops/device.py:156",
        launches=spatial_launches["window_gather"], **gather_row))
    kernels.append(dict(
        name="skyline_windows", route="cuda",
        source="windflow_tpu_torch/ops/csrc/skyline.cu",
        replaces="windflow_tpu/apps/spatial.py:143",
        launches=spatial_launches["skyline_windows"], **skyline_row))
    for k in kernels:     # the empty-launch floor beside every kernel
        k["floor_ms"] = row["floor_ms"]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
