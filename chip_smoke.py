"""Chip smoke test of the PyTorch/CUDA port (windflow_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. environment: torch version and the card's name and power limit;
2. build: compiles the hand-written windowed-reduce kernel with nvcc from
   windflow_tpu_torch/ops/csrc/ and reports the build time;
3. kernel: the kernel against its plain PyTorch version on the card, for
   sum/count/min/max/prod over int32 and float32, at the shape the main path
   gives it (32768 windows of 256 rows over a ~2.1M-row flat buffer) and at
   edge cases (B of 1/7/8, empty and full windows, int32 wrap, NaN), with
   CUDA-event timings beside the least time the card could take;
4. end to end: the sum_test pipeline (Source -> WinSeqGPU(Reducer("sum"),
   256, 64, CB, use_reduce_kernel=True) -> Sink) over 16M tuples of 64 keys,
   held against a numpy oracle, with the kernel's launch count read around
   that run, and a 1M-tuple prefix held against the port's host core.

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

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32 (non-tensor
# core) operations/s; the kernel does one 32-bit combine per element
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
FLOAT_RTOL = 1e-5


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run",
              file=sys.stderr)
        return 2
    from windflow_tpu_torch.ops import windowed_reduce as wr

    smi = nvidia_smi_line()
    emit("environment", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    t0 = time.perf_counter()
    so = wr.build()
    emit("build", library=so, seconds=time.perf_counter() - t0)

    row = kernel_phase(wr, torch.device(DEVICE))
    launches = end_to_end(wr)

    print(json.dumps({"kernels": [{
        "name": "windowed_reduce", "route": "cuda",
        "source": "windflow_tpu_torch/ops/csrc/windowed_reduce.cu",
        "replaces": "windflow_tpu/ops/pallas_kernels.py:49",
        "launches": launches, "max_abs_err": row["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
