"""Chip smoke test of the PyTorch/CUDA port (windflow_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing JSON lines (any failure exits non-zero; no phase
catches its own failure):

1. environment: torch version and the card's name and power limit;
2. build: compiles every kernel source of windflow_tpu_torch/ops/csrc/ with
   nvcc (one nvcc per source) and the native host library with make, all
   at once, and reports each build time;
3. kernel: the windowed-reduce kernel against its plain PyTorch version on
   the card, for sum/count/min/max/prod over int32 and float32, at the
   restaging path's shape (32768 windows of 256 rows over a ~2.1M-row flat
   buffer) and at edge cases, with CUDA-graph timings beside the least time
   the card could take;
4. ring_kernel: ring_append and regular_window_sum against their plain
   versions at the resident path's shape (a 64 x 262144 int32 ring, a
   64 x 8192 int8 rectangle, 128 windows of 256 rows per key, slide 64) and
   at edge cases (every wire x accumulate dtype, keys fewer than ring rows,
   rows without windows, zero lengths, starts clipped at 0 and at cap, an
   int32 wrap, offsets at cap - Rb), with timings; and the windowed-reduce
   kernel on the ring's flat view (the irregular evaluation) against the
   plain transcription of the JAX package's _ring_eval;
5. end_to_end (restaging): sum_test (Source -> WinSeqGPU(Reducer("sum"),
   256, 64, CB, use_reduce_kernel=True) -> Sink) over 16M tuples of 64 keys,
   held against a numpy oracle, with the kernel's launch count read around
   that run, and a 1M-tuple prefix held against the port's host core;
6. end_to_end_resident: the same pipeline through the default route,
   WinSeqGPU(Reducer("sum", value_range=(0, 100)), 256, 64, CB,
   batch_len=32768, flush_rows=2**19, depth=48, shards=1) — the C++
   NativeResidentCore feeding the ring kernels — over 16M tuples against
   the oracle, with the ring kernels' launch counts read around that run
   (a 1M-tuple prefix is first held against the host core);
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
   skyline_windows;
11. spatial_restaging: the same stream through the restaging route
   (WinFarmGPU without use_resident), against the same oracle;
12. spatial_app: apps.spatial.run("wf-gpu") at its defaults (8 s at
   80,000 points/s, TB 50/12.5 ms, pardegree 2, chunk 2048);
13. multi_field_native: MultiReducer(sum(a), max(b), count) over CB 256/64
   and 64 keys, 4M tuples, through the native core's per-field rings
   (NativeResidentCore._multi -> MultiFieldResidentExecutor), byte for
   byte against the port's host core.

Then it prints the kernels' JSON line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  It exits non-zero without printing a
result when no CUDA device is visible or when the package is missing.
"""

import json
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


def compare(got, want, flat, starts, lens, op):
    """Max abs error of got vs want; raises on a disagreement.  Integers and
    float min/max/count exactly; float sums within FLOAT_RTOL of the sum of
    |x| over the window (reduction order differs); float prod within
    FLOAT_RTOL of |want|."""
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
        idx = (starts.long()[:, None]
               + torch.arange(int(lens.max()), device=flat.device)[None, :])
        mask = idx < (starts.long() + lens.long())[:, None]
        vals = flat[idx.clamp(max=flat.numel() - 1)].double().abs()
        scale = torch.where(mask, vals, 0).sum(dim=1)
    else:
        scale = want.double().abs()
    if not bool((same | (err <= FLOAT_RTOL * scale)).all()):
        raise AssertionError(f"{op}/{flat.dtype}: max error {err.max()} "
                             f"beyond rtol {FLOAT_RTOL}")
    return float(err.max())


def kernel_phase(wr, dev):
    """Kernel against its plain version at the main path's shape and at edge
    cases; returns the main-path row of the kernels line (op sum, int32)."""
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
            got = wr.windowed_reduce(flat, starts, lens, WIN, op)
            want = wr.windowed_reduce_reference(flat, starts, lens, WIN, op)
            torch.cuda.synchronize()
            err = compare(got, want, flat, starts, lens, op)
            max_err = max(max_err, err)
            b_ms, b_by = bound(op, n, BATCH_LEN, lens)
            def kernel():
                wr.windowed_reduce(flat, starts, lens, WIN, op)

            k_ms = kernel_ms(kernel)
            c_ms = call_ms(kernel)
            p_ms = call_ms(lambda: wr.windowed_reduce_reference(
                flat, starts, lens, WIN, op))
            rows[(op, dtype)] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                     bound_by=b_by)
            emit("kernel", case="bench_shape", op=op, dtype=str(dtype),
                 B=BATCH_LEN, pad=WIN, n=n, max_abs_err=err, kernel_ms=k_ms,
                 kernel_call_ms=c_ms, plain_ms=p_ms, bound_ms=b_ms,
                 bound_by=b_by, library_ms=None)
    edge_cases(wr, dev, gen)
    torch.cuda.synchronize()
    return dict(max_abs_err=max_err, **rows[("sum", torch.int32)])


def edge_cases(wr, dev, gen):
    def check(name, flat, starts, lens, pad, ops):
        flat = flat.to(dev)
        starts = torch.as_tensor(starts, dtype=torch.int32, device=dev)
        lens = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        for op in ops:
            got = wr.windowed_reduce(flat, starts, lens, pad, op)
            want = wr.windowed_reduce_reference(flat, starts, lens, pad, op)
            torch.cuda.synchronize()
            compare(got, want, flat, starts, lens, op)
            emit("kernel", case=name, op=op, dtype=str(flat.dtype), ok=True)

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
    wrap = torch.full((16,), 2 ** 30, dtype=torch.int32)
    check("int32_wrap_sum", wrap, [0, 0, 4], [4, 3, 8], 8, ("sum",))
    wrap16 = torch.full((16,), 2 ** 16, dtype=torch.int32)
    check("int32_wrap_prod", wrap16, [0, 0, 4], [2, 1, 8], 8, ("prod",))
    nan = torch.arange(64, dtype=torch.float32)
    nan[5] = float("nan")
    check("nan_min_max", nan, [0, 4, 8, 6, 40], [8, 4, 8, 0, 16], 16,
          ("min", "max", "sum"))


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
              slide=SLIDE, rlen=WIN):
    """Inputs of one append + regular evaluation: a ring with earlier
    contents, a rectangle whose rows >= K and tail columns are zero (as the
    executor stages it), per-row offsets and regular window descriptors."""
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


def run_ring(rk, case, plain):
    ring = case["ring"].clone()
    (rk.ring_append_reference if plain else rk.ring_append)(
        ring, case["blk"], case["offs"])
    out = (rk.regular_window_sum_reference if plain
           else rk.regular_window_sum)(ring, case["rstart0"], case["rlen"],
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
    """Kernel against plain version on one case; returns (append error,
    window-sum error).  Rings must be identical; int32 sums exact, float32
    sums within FLOAT_RTOL of Σ|x| over the window."""
    ring_k, out_k = run_ring(rk, case, plain=False)
    ring_p, out_p = run_ring(rk, case, plain=True)
    torch.cuda.synchronize()
    if not torch.equal(ring_k, ring_p):
        raise AssertionError(f"ring_append {name}: rings differ")
    if out_k.dtype == torch.int32:
        if not torch.equal(out_k, out_p):
            raise AssertionError(f"regular_window_sum {name}: sums differ")
        return 0.0, 0.0
    err = (out_k.double() - out_p.double()).abs()
    scale = window_abs_sums(ring_p, case["rstart0"], case["rlen"],
                            case["C"], case["slide"])
    if not bool((err <= FLOAT_RTOL * scale).all()):
        raise AssertionError(f"regular_window_sum {name}: error "
                             f"{float(err.max())} beyond rtol {FLOAT_RTOL}")
    return 0.0, float(err.max())


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


def covered_cells(rstart0, rlen, C, slide, cap):
    """Ring cells the regular windows cover, each counted once."""
    s = np.clip(rstart0.numpy()[:, None] + np.arange(C)[None, :] * slide, 0,
                cap)
    e = np.clip(s + rlen.numpy()[:, None], 0, cap)
    rows = np.repeat(np.arange(len(s)), C)
    return covered(s.ravel(), (e - s).ravel(), rows)


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
    app_err, sum_err = check_ring(rk, case, "main_shape")
    ring = case["ring"].clone()
    blk, offs = case["blk"], case["offs"]
    rs0, rln = case["rstart0"], case["rlen"]
    a_ms = kernel_ms(lambda: rk.ring_append(ring, blk, offs))
    a_plain = call_ms(lambda: rk.ring_append_reference(ring, blk, offs))
    idx = offs.long()[:, None] + torch.arange(RB, device=dev)[None, :]
    a_lib = call_ms(lambda: ring.scatter_(1, idx, blk.to(torch.int32)))
    a_bound = bytes_bound(blk.numel() * (1 + 4) + 4 * KP, blk.numel())
    s_ms = kernel_ms(lambda: rk.regular_window_sum(ring, rs0, rln,
                                                   C_WINDOWS, SLIDE))
    s_plain = call_ms(lambda: rk.regular_window_sum_reference(
        ring, rs0, rln, C_WINDOWS, SLIDE))

    def jax_design():
        cs = torch.nn.functional.pad(
            torch.cumsum(ring, dim=1, dtype=torch.int32), (1, 0))
        i = torch.arange(C_WINDOWS, device=dev)
        st = (rs0.long()[:, None] + i[None, :] * SLIDE).clamp(0, CAP)
        en = (st + rln.long()[:, None]).clamp(0, CAP)
        return cs.gather(1, en) - cs.gather(1, st)

    s_jax = call_ms(jax_design)
    cells = covered_cells(rs0.cpu(), rln.cpu(), C_WINDOWS, SLIDE, CAP)
    s_bound = bytes_bound(4 * cells + 8 * KP + 4 * KP * C_WINDOWS,
                          int(rln.long().sum()) * C_WINDOWS)
    emit("ring_kernel", kernel="ring_append", case="main_shape", KP=KP,
         cap=CAP, Rb=RB, wire="int8", acc="int32", max_abs_err=app_err,
         kernel_ms=a_ms, plain_ms=a_plain, library_ms=a_lib,
         library="ring.scatter_(1, idx, blk.to(int32))",
         bound_ms=a_bound[0], bound_by=a_bound[1])
    emit("ring_kernel", kernel="regular_window_sum", case="main_shape",
         KP=KP, cap=CAP, C=C_WINDOWS, slide=SLIDE, rlen=WIN,
         covered_cells=cells, max_abs_err=sum_err, kernel_ms=s_ms,
         plain_ms=s_plain, library_ms=None,
         library_none_because="no single torch call sums clipped "
                              "overlapping windows",
         jax_design_ms=s_jax, bound_ms=s_bound[0], bound_by=s_bound[1])
    rows["ring_append"] = dict(max_abs_err=app_err, ms=a_ms,
                               plain_ms=a_plain, bound_ms=a_bound[0],
                               bound_by=a_bound[1], library_ms=a_lib)
    rows["regular_window_sum"] = dict(max_abs_err=sum_err, ms=s_ms,
                                      plain_ms=s_plain, bound_ms=s_bound[0],
                                      bound_by=s_bound[1], library_ms=None)

    # -- edge cases, every wire x accumulate dtype, at a small ring
    edges = ("plain", "keys_lt_rows", "rows_without_windows", "zero_length",
             "clip_low", "clip_high", "int32_wrap", "offs_at_end")
    for wire in WIRES:
        for acc in ACCS:
            for edge in edges:
                case = ring_case(gen, dev, wire, acc, edge, cap=4096, Rb=512,
                                 C=16, slide=24, rlen=40)
                a, b = check_ring(rk, case, f"{wire}->{acc} {edge}")
                rows["ring_append"]["max_abs_err"] = max(
                    rows["ring_append"]["max_abs_err"], a)
                rows["regular_window_sum"]["max_abs_err"] = max(
                    rows["regular_window_sum"]["max_abs_err"], b)
            emit("ring_kernel", case="edges", wire=str(wire), acc=str(acc),
                 edges=list(edges), ok=True)

    # -- the irregular evaluation: windowed_reduce on the ring's flat view
    for acc in ACCS:
        ring = (torch.from_numpy(gen.integers(0, 100, size=(KP, CAP)))
                .to(dev, acc))
        B = BATCH_LEN
        rows_ = torch.from_numpy(gen.integers(0, KP, size=B)).to(dev,
                                                                 torch.int32)
        lens = torch.from_numpy(gen.integers(0, WIN + 1, size=B)).to(
            dev, torch.int32)
        starts = torch.from_numpy(gen.integers(0, CAP - WIN, size=B)).to(
            dev, torch.int32)
        flat_starts = (rows_.long() * CAP + starts).to(torch.int32)
        for op in ("sum", "min", "max", "prod"):
            r = ring
            if op == "prod":
                r = (torch.from_numpy(gen.uniform(0.99, 1.01, size=(KP, CAP)))
                     .to(dev, acc) if acc == torch.float32
                     else torch.from_numpy(gen.integers(-2, 3, size=(KP, CAP)))
                     .to(dev, acc))
            got = wr.windowed_reduce(r.view(-1), flat_starts, lens, WIN, op)
            want = rk.ring_eval_reference(op, r, rows_, starts, lens, WIN)
            torch.cuda.synchronize()
            err = compare(got, want, r.view(-1), flat_starts, lens, op)
            emit("ring_kernel", kernel="windowed_reduce",
                 case="ring_flat_view", op=op, acc=str(acc), B=B, pad=WIN, max_abs_err=err,
                 kernel_ms=kernel_ms(lambda: wr.windowed_reduce(
                     r.view(-1), flat_starts, lens, WIN, op)))
    return rows


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
    kernels; returns the ring kernels' launch counts in that run."""
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
    wr.windowed_reduce.launches = 0
    rk.ring_append.launches = 0
    rk.regular_window_sum.launches = 0
    dt, n_windows, total, _ = run_pipeline(stage, batches, schema)
    launches = {"ring_append": rk.ring_append.launches,
                "regular_window_sum": rk.regular_window_sum.launches,
                "windowed_reduce": wr.windowed_reduce.launches}
    stats = resident.stats_snapshot(reset=True)
    if not (len(cores) == 1 and isinstance(cores[0], NativeResidentCore)):
        raise AssertionError(f"the stage's core is {cores}, not the port's "
                             "NativeResidentCore")
    if cores[0]._delegate is not None:
        raise AssertionError("NativeResidentCore fell back to the Python "
                             "core")
    if total != want:
        raise AssertionError(f"windowed-sum total {total} != oracle {want}")
    if not (launches["ring_append"] > 0
            and launches["regular_window_sum"] > 0):
        raise AssertionError(f"the resident path launched {launches}")
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
        counts = (wr.windowed_reduce.launches, rk.ring_append.launches,
                  rk.regular_window_sum.launches)
        _, n_dev, _, dev_rows = run_pipeline(stage, prefix, schema, True)
        counts = [b - a for a, b in zip(counts, (
            wr.windowed_reduce.launches, rk.ring_append.launches,
            rk.regular_window_sum.launches))]
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
                       "regular_window_sum": counts[2]})


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
    oracle and the host core; returns the main path's launch counts."""
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
        runs[name] = (rows, launches)
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
    return runs["spatial_resident"][1]


def spatial_app():
    """apps.spatial.run("wf-gpu") at its defaults, rate-paced."""
    from windflow_tpu_torch.apps import spatial
    out = spatial.run("wf-gpu", device=DEVICE)
    if not out.get("windows"):
        raise AssertionError(f"spatial wf-gpu delivered no window: {out}")
    emit("spatial_app", **out)


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

    cores = []
    stage = stage_with_core(lambda: wt.WinSeqGPU(
        agg(), WIN, SLIDE, wt.WinType.CB, batch_len=BATCH_LEN,
        flush_rows=FLUSH_ROWS, depth=DEPTH, device=DEVICE), cores)
    counts = (wr.windowed_reduce.launches, rk.ring_append.launches)
    dt, rows = run_rows(stage, batches, schema)
    counts = {"windowed_reduce": wr.windowed_reduce.launches - counts[0],
              "ring_append": rk.ring_append.launches - counts[1]}
    if not (len(cores) == 1 and getattr(cores[0], "_multi", False)
            and cores[0]._delegate is None):
        raise AssertionError(f"multi_field_native: the core is {cores}")
    if counts["windowed_reduce"] == 0 or counts["ring_append"] == 0:
        raise AssertionError(f"multi_field_native: launches {counts}")
    _, host = run_rows(wt.WinSeq(agg(), WIN, SLIDE, wt.WinType.CB), batches,
                       schema)
    if by_key([rows]) != by_key([host]):
        raise AssertionError("multi_field_native: the per-field rings "
                             "differ from the host core")
    emit("multi_field_native", workload="MultiReducer(sum(a), max(b), "
         "count) CB win=256 slide=64 keys=64", tuples=MULTI_TUPLES,
         seconds=dt, tuples_per_s=MULTI_TUPLES / dt, windows=len(rows),
         fields=list(cores[0]._ship_fields), identical=True,
         launches=counts)


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
    restaging_launches = end_to_end(wr)
    resident_launches = end_to_end_resident(wr, rk)
    irregular_and_python_core(wr, rk)
    gather_row = gather_phase(dev)
    skyline_row = skyline_phase(dev)
    spatial_launches = spatial_phases(wr, rk)
    spatial_app()
    multi_field_native(wr, rk)

    kernels = [dict(
        name="windowed_reduce", route="cuda",
        source="windflow_tpu_torch/ops/csrc/windowed_reduce.cu",
        replaces="windflow_tpu/ops/pallas_kernels.py:49",
        launches=restaging_launches, max_abs_err=row["max_abs_err"],
        ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=None)]
    for name, replaces in (("ring_append", "windflow_tpu/ops/resident.py:234"),
                           ("regular_window_sum",
                            "windflow_tpu/ops/resident.py:183")):
        kernels.append(dict(
            name=name, route="cuda",
            source="windflow_tpu_torch/ops/csrc/resident.cu",
            replaces=replaces, launches=resident_launches[name],
            **rows[name]))
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
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
