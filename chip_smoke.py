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
   offset 2^32 (some ending at the ring's last cell, four longer than the
   split), in one ring_append_eval launch, held against the plain version
   and, bit for bit, against the twin on that row (the int32 flat starts
   of the kernel before could not reach them);
4c. append_eval: ring_append_eval (the append and every op of an
   irregular dispatch in one launch) against its plain version and, bit
   for bit, against append_eval_order_twin (plain torch on the card), two
   launches equal and the long-window counters left at zero, at YSB 10 s's
   shape (25 windows of ~325k cells on a 32 x 2^19 ring), the
   deterministic YSB shape (50 windows of ~16.6k cells), sum_test's max
   prefix (8,192 windows of 256 cells), 1,024 windows of 1k-8k cells, and
   48 soak-sized odd cases (tiny rings, odd rectangles with zero rows and
   columns, offsets at every residue mod 4, windows past the row's end,
   B = 0, count, every wire x accumulate dtype, small splits and chunks);
   each main shape timed cold and hot beside its bytes bound, the empty
   launch and the old ring_append + windowed_reduce pair;
4d. multi_append_eval: ring_append_multi_eval (the per-field step in one
   launch: every field's append, every stat, a window function's tiles
   and mask) against its plain version and, bit for bit, against
   multi_append_eval_order_twin, two launches equal and the counters left
   at zero, at a spatial resident launch (2 float32 fields, tiles at pad
   4096, 256 windows, 8 x 2^22 rings, a 2^19-column rectangle), a
   MultiReducer launch (int8 and int16 wires into int32 rings, sum and
   max of 8,192 windows), 1,024 windows of 1k-8k cells over 3 fields of
   int32 and float32 rings (all five ops and two fields' tiles), and 48
   odd cases (1-5 fields of every wire x accumulate dtype, offsets at
   every residue mod 4, Rb not a multiple of 16, windows across the
   rectangle's edges, B = 0, a field with neither stat nor tile, 9-12
   stats in two launches, small splits and chunks); each main shape timed
   cold and hot beside its bytes bound, the empty launch and the old
   composition (ring_append a field, windowed_reduce_many, window_gather);
5. end_to_end (restaging): sum_test (Source -> WinSeqGPU(Reducer("sum"),
   256, 64, CB, use_reduce_kernel=True) -> Sink) over 16M tuples of 64 keys,
   held against a numpy oracle, with the kernel's launch count read around
   that run, and a 1M-tuple prefix held against the port's host core;
6. end_to_end_resident: the same pipeline through the default route,
   WinSeqGPU(Reducer("sum", value_range=(0, 100)), 256, 64, CB,
   batch_len=32768, flush_rows=2**19, depth=48, shards=1) — the C++
   NativeResidentCore feeding the ring kernels — over 16M tuples against
   the oracle, with the ring kernels' launch counts read around that run:
   one fused launch a regular flush, one ring_append_eval an irregular
   launch, never ring_append or windowed_reduce (a 1M-tuple prefix is
   first held against the host core);
7. irregular_and_python_core: Reducer("max") on the native core (irregular
   launches: ring_append_eval) and Reducer("sum") on the Python
   ResidentWinSeqCore, 1M tuples each, byte for byte against the host
   core, every ring_append_eval call against its plain version and twin;
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
   and the launch counts in that run: exactly 4 ring_append_multi_eval
   (2 launches x 2 workers, both rings' appends and both fields' tiles in
   each) and 4 skyline_windows, no ring_append and no window_gather; then
   ring_append_multi_eval against its plain version and its twin at the
   inputs of each of those 4 launches, timed on the largest beside the
   old composition (the kernels line's ring_append_multi_eval row), and
   ring_append against its plain version at their 8 rectangles (float32
   into 8 x 2^22 float32 rings), timed on the largest (the kernels line's
   ring_append row: ring_append has no main-path launch since the
   per-field step was fused);
11. spatial_restaging: the same stream through the restaging route
   (WinFarmGPU without use_resident), against the same oracle;
12. spatial_app: apps.spatial.run("wf-gpu") at its defaults (8 s at
   80,000 points/s, TB 50/12.5 ms, pardegree 2, chunk 2048);
13. multi_field_native: MultiReducer(sum(a), max(b), count) over CB 256/64
   and 64 keys, 4M tuples, through the native core's per-field rings
   (NativeResidentCore._multi -> MultiFieldResidentExecutor), byte for
   byte against the port's host core, with one ring_append_multi_eval
   launch for each of the executor's launches (no ring_append, no
   windowed_reduce), each call against its plain version and twin;
14. ysb_deterministic: the Yahoo Streaming Benchmark (apps/ysb.py) at its
   published shape (100 campaigns x 10 ads, TB tumbling windows of 10 s,
   COUNT + MAX(ts) + SUM(revenue) per campaign, pardegree2 4, chunks of
   262,144 events) over 16M deterministic events whose ts steps 2 us an
   event: kf-gpu (KeyFarmGPU, the revenue ring on the native core) and
   wmr-gpu (WinMapReduceGPU, the MAP stage on the card), every window's
   (count, lastUpdate, revenue) against a numpy bincount oracle, a 1M-event
   prefix of each row for row against the port's host kf, and each run's
   kernel launches (one ring_append_eval a dispatch, never the old
   pair); then ring_append_eval against its plain version and its twin at
   the inputs of every call of the run (YSB's long TB windows), timed on
   the largest beside its bound and the old pair (ysb_append_eval);
15. ysb_timed: apps.ysb.run("kf-gpu") and run("wmr-gpu") at the app's
   defaults (a warm-up, then 10 s of full-speed generation): events/s,
   ingest events/s, p95/p99 latency, the launch diagnostics
   (stats_snapshot) and the kernel launches (one ring_append_eval a
   dispatch), every ring_append_eval call checked and the largest timed
   as in 14 (kf-gpu's: the kernels line's ring_append_eval row);
16. pipe_test: apps.pipe.run (pipe_test_gpu: Source -> Map -> Filter ->
   WinFarmGPU(sum, CB 256/64, 64 keys, pardegree 2) -> Sink): a warm-up,
   then one timed run of 8M tuples whose total and window count must equal
   expected(); tuples/s, p95 latency, and the kernel launches (fused
   ring_append_regular_sum launched);
17. two_stage: the 9 device compositions of the test_all mirror (WinSeqGPU,
   WinFarmGPU, KeyFarmGPU, PaneFarmGPU with the PLQ or the WLQ on the card,
   WinMapReduceGPU with the MAP or the REDUCE stage on the card,
   KeyFarmOf(PaneFarmGPU), WinFarmOf(WinMapReduceGPU)) at sum_test's shape
   over 1M tuples, each total equal to the host WinSeq's, with each one's
   kernel launches;
18. layers: sum_test's 16M tuples through MultiPipe(check="error",
   trace=, recovery= (one epoch a source batch), control=) over
   KeyFarmGPU(sum, pardegree 2, flush_rows 2^19, depth 48) on the native
   core, rescaled 2 -> 4 -> 2 by the controller mid-stream (the source
   waits for each request, so the first seals with all but a batch or two
   to go and the second at the middle), against the same stream through a
   fixed-width KeyFarmGPU with no layers in the same call: the total
   against the oracle, every key's results in order, the history (2, 4),
   (4, 2), the ctl_width_kf gauge at 2, the four workers' native cores on
   the card with the state ABI, the fused kernel launched by each of them
   (launches per kernel and per worker, layers_launches), every ring
   kernel call of the run against its plain version, the trace read back
   by scripts/wf_trace.py (hops of the source, the workers and the sink, a
   dispatch launch span under a worker's hop, one rescale ctrl span a
   seal), the profile recorder uninstalled after; then a max_delay_ms
   KeyFarmGPU under recovery= and check="error" must raise CheckError
   (WF202) before any thread starts (layers_wf202);
19. mesh: the single-process device mesh on the one card, its device
   repeated (parallel/mesh.py make_mesh(devices=["cuda:0"] * n)): (a)
   sum_test's 16M tuples through WinSeqGPU(Reducer("sum", value_range=(0,
   100)), ..., mesh=make_mesh(n_kf=4)) — the C++ core feeding
   MeshResidentExecutor.launch_regular, one fused ring_append_regular_sum
   launch on each of the 4 shards a regular flush, one ring_append_eval on
   each an irregular one — against the oracle, its 1M-tuple prefix per
   key against the un-meshed resident route; (b) a 1M-tuple
   Reducer("max") prefix on the mesh (irregular launches: one
   ring_append_eval a shard a dispatch, with or without windows); (c) the
   two-field
   MultiReducer's 4M tuples on the mesh (the native _multi branch over
   MeshMultiFieldResidentExecutor: one ring_append_multi_eval on every
   shard a dispatch, no ring_append, windowed_reduce or window_gather);
   (b) and (c) per key against the
   un-meshed route; each run's launches per shard (from the shards'
   streams) and every ring kernel call against its plain version; (d)
   MeshStreamStep at pipe_test's chain (map 3v+1, filter v % 5 != 0) over
   a (kf, wf, sp) = (2, 2, 2) mesh and a (2, 2^24) int32 buffer: 262,144
   CB 256/64 windows a group, 1,024 long windows across the sp boundary
   and 8 past N, ops sum, count, min, max, prod and mean in int32 and sum
   and mean in float32, each with the psum and the ring fold, against a
   numpy oracle; every sp_window_partial and sp_merge call against its
   plain version (float32 partials and every merge bit for bit against
   the CPU twin of its order, run on the card), the partial launches per
   (kf, wf, sp) shard, one launch a call of each kernel, the windows that
   took the partial's block path (longer than mr.SPLIT rows), and both
   kernels timed at the run's largest call beside their bound (the merge
   over the partials in place and stacked, beside torch.sum over them,
   each a CUDA-graph replay; torch.sum also as a caller sees it).

20. recover: sum_test's 16M tuples through the native resident route
   (as phase 6) under recovery= (a barrier every 2 source batches), the
   window node killed once at its 9th batch: one restart, the fused
   kernel launched after the restore, every key's results in order equal
   to the uncrashed run's in the same call and the total to the oracle;
   then 1M-tuple prefixes (in batches of 2^18) crashed and restored on
   the Python resident core, with and without snapshot_rings, and on the
   restaging route (use_reduce_kernel=True), each equal to its uncrashed
   run;
21. plane: child processes started with subprocess (fresh interpreters,
   never a fork after CUDA starts) that load the kernels phase 2 built.
   (a) two processes, each in a gloo group (parallel/multihost.py
   initialize) with make_multihost_mesh(n_sp=1) (kf = 2: one cuda:0 a
   process), a hardened row plane (open_row_plane), its half of
   sum_test's 16M tuples partitioned by key owner (partition_and_ship,
   origin order) into WinSeqGPU's resident route under metrics= and
   federate=, process 1's shipper bound to process 0, whose receiver
   holds the TelemetryAggregator: the merged results per key in order
   against the single-process resident run and the total against the
   oracle, each process's keys in its own kf groups, the fused kernel
   launched in each, the aggregator holding process 1's fresh snapshots
   (seq >= 2); each process's tuples/s and the wall time.  (b) a feeder
   and two workers (4M tuples, 64 keys, 16 epochs): each worker feeds a
   NativeResidentCore on the card from its RowReceiver and, at every
   wire epoch, drains, seals its state into a CheckpointStore, writes the
   epoch's rows, replicates the epoch (PlaneSupervisor.replicate) and
   acks; worker 1 exits after epoch 8 and worker 2's PlaneSupervisor
   adopts it (the native state blob into a fresh core on the card, the
   journal's tail through takeover_receiver): the merged rows per key in
   order against the uncrashed single-process run and the total against
   the oracle; the adoption epoch, the handoff seconds and
   ckpt_shipped_bytes;
22. soak: scripts/torch_soak_crash.py's native cases 0-23 of seed 11 in
   this process on cuda:0 (WinSeqGPU(Reducer("sum", "value"), ...) of
   windows of 2-15 rows, batch_len 16/32/64, 1-2 shards, CB or TB,
   killed 1-2 times and restored from the native state blob): each equal
   to its uncrashed run row for row (the script's check), the uncrashed
   run to a numpy oracle of per-window sums; per case its params, rows,
   restarts and launches (soak_case), ring_append_regular_sum and
   ring_append_eval each launched across the cases; then
   host cases of the crash (8), rescale, wire and handoff (4 each)
   twins;
23. lint: scripts/torch_wf_lint.py --error --json in a fresh interpreter
   over the four apps and the six twins with a wf_check_pipelines()
   hook: exit 0, no diagnostic;
24. roll: scripts/torch_wf_roll.py's sequencer (drain -> seal -> hand-off
   -> restart with resume_epoch=) over a Drain-controlled feeder in this
   process and two worker processes, each a NativeResidentCore on the
   card at sum_test's width (plane (b)'s stream: 4M tuples, 64 keys, 16
   epochs), rolled at epochs 5 and 11: at the seal the worker drains its
   core, writes the epoch's rows, saves the native blob in its
   CheckpointStore and only then acks; the restarted process restores
   the blob into a fresh core; the merged rows per key in order against
   the uncrashed single-process run, the total against the oracle, the
   fused kernel launched by each restarted process; the wall time, each
   roll's restart gap and fused launches before and after; then the
   script's host differential (run_roll, 8 epochs);
25. ring_dtypes: rings of the dtypes beyond int32 and float32 through the
   three fused ring kernels: (a) sum_test's 16M tuples through the
   resident route with compute_dtype=int64 and values from 2**26 (window
   sums past 2**31), every window and the total against a numpy int64
   oracle, one fused ring_append_regular_sum a regular flush; (b) the 1M
   Reducer("max") prefix (irregular: ring_append_eval) on an int64 ring
   and on an int8 ring fed an int16 wire that wraps, against a numpy
   oracle (of the wrapped values); (c) a
   MultiFieldResidentExecutor over int16, int64 and float64 rings, 7
   stats over 3 fields in one ring_append_multi_eval launch a dispatch,
   every window against a numpy oracle; every recorded call of the three
   kernels against its plain version and its order twin (ints bit for
   bit, float64 sums within FLOAT64_RTOL of Σ|x|); each kernel timed at
   its largest call beside the same inputs over int32 (and float32)
   rings, with the bytes bounds (ring_dtypes_rows, which also carries the
   cold build's seconds of the ring kernels' library);
26. column_dtypes: the JAX package's column dtypes on the restaging route
   and in the mesh reduction (column_dtypes_phase's docstring);
27. ring_dtypes_u: unsigned and float16 rings through the four ring
   kernels and the mesh reduction at its 1- and 2-byte and float16
   dtypes: (a) sum_test's 16M tuples on a uint32 ring, values 2**31 - 50
   + i % 100 shipped as a wrapping int32 wire, every window against a
   numpy oracle of the sums modulo 2**32; (b) the 1M Reducer("max")
   prefix on uint32 (values across 2**31), uint8 (an int16 wire that
   wraps) and uint16 rings and on a uint32 ring over make_mesh(n_kf=4);
   (c) float16 rings: max and a use_resident=True float sum (the Python
   core: ring_append_eval), an integer sum on the native core
   (ring_append_regular_sum), each float16 sum within one float16 ulp of
   the float64 sum of the ring's cells; (d) uint8, uint16, uint32, uint64
   and float16 fields of one MultiFieldResidentExecutor, 8 stats, one
   ring_append_multi_eval launch a dispatch; (e) MeshStreamStep at
   pipe_test's chain on (2, 2, 2) at int8, int16, uint8, uint16 and
   float16, every op, both orders, 2^20 rows a group; every call of the
   six kernels against its plain version and twin (integers bit for bit,
   float16 bit for bit against the twins), each kernel timed at its
   largest call beside the same inputs at int32 or float32
   (ring_dtypes_u_rows).

The new paths' launch counts are printed together (new_path_launches), and
each of ring_append_eval and ring_append_regular_sum must have been
launched on one of them; the mesh runs' launches follow (mesh_launches),
then ring_dtypes' (ring_dtypes_launches), where each of the three fused
ring kernels must have been launched, then column_dtypes' and
ring_dtypes_u's, where each kernel of the phase must have been launched
at a new dtype.
Then it prints the kernels' JSON line (nine kernels, each with the
empty-launch floor beside its times), the nvidia-smi line,
and last
``{"ok": true, "device": {...}}``.  It exits non-zero without printing a
result when no CUDA device is visible or when the package is missing.
"""

import collections
import contextlib
import dataclasses
import inspect
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings

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
# float64 sums: within 1e-12 of the sum of |x| (XLA's cumsum difference and
# the plain version's round at the row prefix's magnitude, the kernels at
# the window's)
FLOAT64_RTOL = 1e-12
# float16: each result rounded once from a float32 sum, in another order
# than the plain version's: two float16 ulps of the window's sum of |x|
F16_RTOL = 2.0 ** -9
WIRES = (torch.int8, torch.int16, torch.int32, torch.float32)
ACCS = (torch.int32, torch.float32)
_SAME_SIZE_INT = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                  8: torch.int64}


def bits(t):
    """`t` viewed as integers of its element size: equal bits, equal
    values (NaN included)."""
    return t.view(_SAME_SIZE_INT[t.element_size()])


def rtol_of(t):
    """The stated sum tolerance of a float dtype (of |x| summed)."""
    return {torch.float64: FLOAT64_RTOL, torch.float16: F16_RTOL}.get(
        t.dtype, FLOAT_RTOL)


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
    from windflow_tpu_torch.ops import gather, mesh_reduce, skyline
    from windflow_tpu_torch.ops import ring as rk
    from windflow_tpu_torch.ops import windowed_reduce as wr

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    jobs = {"windowed_reduce.cu": wr.build, "resident.cu": rk.build,
            "gather.cu": gather.build, "skyline.cu": skyline.build,
            "mesh_reduce.cu": mesh_reduce.build,
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


def window_abs_sums(ring, rstart0, rlen, C, slide, prefix=False):
    """Σ|x| over each clipped regular window (float64, on the card); with
    `prefix`, over the row up to each window's end."""
    cap = ring.shape[1]
    cs = torch.zeros((ring.shape[0], cap + 1), dtype=torch.float64,
                     device=ring.device)
    torch.cumsum(ring.double().abs(), dim=1, out=cs[:, 1:])
    i = torch.arange(C, device=ring.device)
    s = (rstart0.long()[:, None] + i[None, :] * slide).clamp(0, cap)
    e = (s + rlen.long()[:, None]).clamp(0, cap)
    return cs.gather(1, e) - (0 if prefix else cs.gather(1, s))


def check_ring(rk, case, name):
    """The fused kernel (launched twice) and the two-launch sequence
    against the plain version on one case.  Rings must be identical;
    integer sums exact, float32 sums within FLOAT_RTOL of Σ|x| over the
    window, float64 within FLOAT64_RTOL of Σ|x| over the row up to the
    window's end (the plain version's cumsum difference rounds there); the
    two fused launches bitwise equal.  Returns the window sums' largest
    error (the rings are identical or it raises)."""
    fused = [run_fused(rk, case, plain=False) for _ in range(2)]
    two = run_two_launches(rk, case)
    ring_p, out_p = run_fused(rk, case, plain=True)
    torch.cuda.synchronize()
    if not torch.equal(bits(fused[0][1]), bits(fused[1][1])):
        raise AssertionError(f"ring_append_regular_sum {name}: two launches "
                             "differ")
    scale = window_abs_sums(ring_p, case["rstart0"], case["rlen"],
                            case["C"], case["slide"],
                            prefix=ring_p.dtype == torch.float64)
    err = 0.0
    if out_p.dtype == torch.float16:
        # float16 sums bit for bit against the kernel's order too
        twin = rk.regular_sum_order_twin(
            case["ring"].clone(), case["blk"], case["offs"], case["rstart0"],
            case["rlen"], case["C"], case["slide"])
        if not torch.equal(bits(fused[0][1]), bits(twin)):
            raise AssertionError(f"ring_append_regular_sum {name}: float16 "
                                 "sums differ from the order twin")
    for label, (ring_k, out_k) in (("ring_append_regular_sum", fused[0]),
                                   ("ring_append + window sums alone",
                                    two)):
        if not torch.equal(bits(ring_k), bits(ring_p)):
            raise AssertionError(f"{label} {name}: rings differ")
        if not out_k.is_floating_point():
            if not torch.equal(bits(out_k), bits(out_p)):
                raise AssertionError(f"{label} {name}: sums differ")
            continue
        e = (out_k.double() - out_p.double()).abs()
        if not bool((e <= rtol_of(out_k) * scale).all()):
            raise AssertionError(f"{label} {name}: error {float(e.max())} "
                                 f"beyond rtol {rtol_of(out_k)}")
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
    size = ring.element_size()
    nbytes = (blk.numel() * blk.element_size() + size * int(rect.sum())
              + size * int((cov & ~rect).sum()) + 12 * KP + size * KP * C)
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
        # the bound (PERF.md table row 4, _ring_eval): the cells the
        # windows cover read once from each of the two rings, the (row,
        # start, len) descriptors, one result a window and op; an op a cell
        cells = covered(starts.cpu().numpy().astype(np.int64),
                        lens.cpu().numpy().astype(np.int64),
                        rows_.cpu().numpy())
        nbytes = 2 * cells * ring.element_size() + 12 * B + 4 * 4 * B
        bound = bytes_bound(nbytes, 4 * int(lens.sum()))
        emit("ring_kernel", kernel="windowed_reduce", case="ring_2d",
             ops=[op for _, op in evals], acc=str(acc), ring=[KP, CAP], B=B,
             pad=WIN, max_abs_err=err, twin_bitwise=True,
             kernel_ms=kernel_ms(lambda: wr.windowed_reduce_many(
                 evals, rows_, starts, lens, WIN)),
             bound_bytes=nbytes, bound_ms=bound[0], bound_by=bound[1])
        del ring, ring_p
    return rows


# a ring of 2^32 int32 cells (16 GiB): the last row's cells lie past flat
# offset 2^32, out of reach of int32 flat starts
BIG_KEYS, BIG_CAP = 16, 1 << 28


def big_ring_phase(wr):
    """Windows on the last row of a ring of BIG_KEYS x BIG_CAP int32 cells,
    through ResidentWindowExecutor.launch: an append at each row's end
    minus 8192, then one at its end minus 4096 with windows over both
    (a few of them longer than the split, so the long-window chunks run
    there too), sum, max and min, each launch one ring_append_eval; held
    against the plain version and, bit for bit, against the twin on that
    row (and the appended cells against the rectangles)."""
    from windflow_tpu_torch.ops import ring as rk
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
    # long windows (past the split): across both appends, and to the end
    lens[7:11] = (2 * R, 6001, 2049, 4099)
    starts[7:11] = BIG_CAP - lens[7:11] - np.array([0, 3, 1001, 0])
    rows = np.full(B, BIG_KEYS - 1, np.int32)
    empty = np.zeros(0, np.int32)
    ex.launch("fill", blks[0], offs[0], empty, empty, empty)
    ex.drain()
    # the last row as the eval launch finds it, for the twin
    last_before = ex._ring[BIG_KEYS - 1:BIG_KEYS].clone()
    counts = {k: w.launches for k, w in kernel_wrappers().items()}
    ex.launch("eval", blks[1], offs[1], rows, starts, lens)
    ready = ex.drain()
    counts = {k: w.launches - counts[k]
              for k, w in kernel_wrappers().items()}
    if [m for m, _ in ready] != ["eval"] or counts["ring_append_eval"] != 1 \
            or counts["ring_append"] or counts["windowed_reduce"]:
        raise AssertionError(f"big ring: {[m for m, _ in ready]}, "
                             f"launches {counts}")
    ring = ex._ring
    last = ring[BIG_KEYS - 1:BIG_KEYS]
    tail = last[0, BIG_CAP - 2 * R:].cpu().numpy()
    if not (np.array_equal(tail[:R], blks[0][-1])
            and np.array_equal(tail[R:], blks[1][-1])):
        raise AssertionError("big ring: the last row's appended cells "
                             "differ from the rectangles")
    d = [torch.from_numpy(a).to(DEVICE) for a in (starts, lens)]
    zero = torch.zeros(B, dtype=torch.int32, device=DEVICE)
    pad = 1 << 13
    want = wr.windowed_reduce_many_reference(
        [(last, op) for op in ex.ops], zero, d[0], d[1], pad)
    # the twin on the last row alone: its flat offsets mod 4 are those of
    # the whole ring's last row (BIG_CAP is a multiple of 4)
    twin = rk.append_eval_order_twin(
        last_before, torch.from_numpy(blks[1][-1:]).to(DEVICE),
        torch.from_numpy(offs[1][-1:].astype(np.int32)).to(DEVICE), ex.ops,
        zero, d[0], d[1], pad)
    for op, got, w, t in zip(ex.ops, ready[0][1], want, twin):
        if not (np.array_equal(got, w.cpu().numpy())
                and np.array_equal(got, t.cpu().numpy())):
            raise AssertionError(f"big ring: {op} differs from the plain "
                                 "version or the twin on the last row")
    emit("big_ring", ring=[BIG_KEYS, BIG_CAP], cells=BIG_KEYS * BIG_CAP,
         last_row_flat_offset=(BIG_KEYS - 1) * BIG_CAP, windows=B,
         long_windows=int((lens > rk.LONG_SPLIT).sum()), ops=list(ex.ops),
         launches=counts, identical=True, twin_bitwise=True)
    del ex, ring, last, last_before
    torch.cuda.empty_cache()


# ring_append_eval (phase 4c): the irregular resident dispatch in one
# launch.  Each case: (KP, cap, Rb) ring and rectangle, K rows and R
# columns of real data (the rest zero, as the executor pads), the wire and
# accumulate dtypes, the ops, and the windows.
AE_FLOAT_PROD_BOUND = 2.0 ** -23     # 2 (n - 1) 2^-24 of |x|, n cells


def ae_values(gen, shape, dtype, prod):
    """Seeded values for a ring or a rectangle: 1..97 (YSB's revenue) or,
    for a product, values whose products stay finite (floats near 1, ints
    in {-1, 1, 2}); an unsigned ring's anywhere in its range (past 2**31
    for uint32)."""
    if not dtype.is_signed and not prod:
        np_dt = torch.empty(0, dtype=dtype).numpy().dtype
        host = gen.integers(0, np.iinfo(np_dt).max, size=shape,
                            dtype=np.uint64, endpoint=True).astype(np_dt)
        return torch.from_numpy(host)
    if dtype.is_floating_point:
        host = (gen.uniform(0.999, 1.001, size=shape) if prod
                else gen.uniform(-100, 100, size=shape))
    elif prod:
        host = gen.choice(np.array([-1, 1, 1, 2]), size=shape)
    else:
        host = gen.integers(1, 98, size=shape)
    return torch.from_numpy(np.asarray(host)).to(dtype)


def ae_case(gen, dev, KP, cap, Rb, K, R, wire, acc, ops, rows, starts,
            lens, offs, pad=None, split=None, chunk=None):
    """One ring_append_eval case on `dev` (windows from host arrays)."""
    from windflow_tpu_torch.ops import ring as rk
    prod = "prod" in ops
    ring = ae_values(gen, (KP, cap), acc, prod).to(dev)
    blk = torch.zeros((KP, Rb), dtype=wire)
    blk[:K, :R] = ae_values(gen, (K, R), wire, prod)
    as32 = lambda a: torch.from_numpy(                       # noqa: E731
        np.ascontiguousarray(a, dtype=np.int32)).to(dev)
    pad = int(pad if pad is not None else max(1, int(np.max(lens, initial=1))))
    long = rk.long_windows(rows, starts, lens, pad, cap,
                           split if split is not None else rk.LONG_SPLIT,
                           chunk if chunk is not None else rk.LONG_CHUNK)
    return dict(ring=ring, blk=blk.to(dev), offs=as32(offs), ops=list(ops),
                rows=as32(rows), starts=as32(starts), lens=as32(lens),
                pad=pad, long=long)


def ae_compare(got, want, scale, n, op, name):
    """Max abs error of the kernel's (got) against the plain version's
    (want); raises beyond the tolerance: ints, counts, min and max exact
    (NaN equal to NaN), float32 sums within FLOAT_RTOL of the window's sum
    of |x| (`scale`), float32 products within max(FLOAT_RTOL, 2 (n - 1)
    2^-24) of |want| for a window of n cells; float64 alike with
    FLOAT64_RTOL and 2 (n - 1) 2^-53."""
    same = bits(got) == bits(want)
    if got.is_floating_point():
        same |= (got == want) | (torch.isnan(got) & torch.isnan(want))
    if not got.is_floating_point() or op in ("count", "min", "max"):
        if not bool(same.all()):
            bad = int((~same).nonzero()[0])
            raise AssertionError(f"{name} {op}: window {bad} gives "
                                 f"{bits(got)[bad].item()} != "
                                 f"{bits(want)[bad].item()} (bits)")
        return 0.0
    err = torch.where(same, 0.0, (got.double() - want.double()).abs())
    wide = got.dtype == torch.float64
    if op == "sum":
        tol = rtol_of(got) * scale.double()
    else:
        rel = torch.clamp((2.0 ** -52 if wide else AE_FLOAT_PROD_BOUND)
                          * (n.double() - 1), min=rtol_of(got))
        tol = rel * want.double().abs()
    if not bool((same | (err <= tol)).all()):
        raise AssertionError(f"{name} {op}: max error {err.max()} beyond "
                             "the stated tolerance")
    return float(err.max()) if err.numel() else 0.0


def check_append_eval(case, name, counters=None):
    """ring_append_eval on a copy of the case's ring, twice, against the
    plain version and, bit for bit, against append_eval_order_twin (both
    on the card): the rings identical, the two launches' outputs equal,
    the counters left at zero.  Returns the largest error against the
    plain version."""
    from windflow_tpu_torch.ops import ring as rk
    from windflow_tpu_torch.ops import windowed_reduce as wr
    c = case
    args = (c["blk"], c["offs"], c["ops"], c["rows"], c["starts"],
            c["lens"], c["pad"])
    dev = c["ring"].device
    if counters is None:
        counters = torch.zeros(c["long"].n + 1, dtype=torch.int32,
                               device=dev)
    rings = [c["ring"].clone() for _ in range(3)]
    got = rk.ring_append_eval(rings[0], *args, long=c["long"],
                              counters=counters)
    again = rk.ring_append_eval(rings[0], *args, long=c["long"],
                                counters=counters)
    plain = rk.ring_append_eval_reference(rings[1], *args)
    twin = rk.append_eval_order_twin(rings[2], *args, split=c["long"].split,
                                     chunk=c["long"].chunk)
    _sync(dev)
    if not (torch.equal(bits(rings[0]), bits(rings[1]))
            and torch.equal(bits(rings[0]), bits(rings[2]))):
        raise AssertionError(f"ring_append_eval {name}: the rings differ "
                             "from the plain append")
    if c["long"].n and bool(counters.any()):
        raise AssertionError(f"ring_append_eval {name}: counters left at "
                             f"{counters.nonzero().flatten().tolist()}")
    n = c["lens"].long().clamp(0, c["pad"])
    scale = wr.windowed_reduce_many_reference(
        [(rings[1].abs(), "sum")], c["rows"], c["starts"], c["lens"],
        c["pad"])[0] if rings[1].is_floating_point() else None
    err = 0.0
    for op, g, a, p, t in zip(c["ops"], got, again, plain, twin):
        for other, what in ((t, "the twin"), (a, "a second launch")):
            if not torch.equal(bits(g), bits(other)):
                bad = int((bits(g) != bits(other)).nonzero()[0])
                raise AssertionError(
                    f"ring_append_eval {name} {op}: window {bad} gives "
                    f"{bits(g)[bad].item()}, {what} "
                    f"{bits(other)[bad].item()} (bits)")
        err = max(err, ae_compare(g, p, scale, n, op,
                                  f"ring_append_eval {name}"))
    return err


def covered_outside(rows, starts, lens, pad, cap, offs, Rb):
    """Ring cells the windows read outside the rectangle, each counted
    once (a column past the row's end reads its last cell)."""
    rows = np.asarray(rows, np.int64)
    s = np.maximum(np.asarray(starts, np.int64), 0)
    n = np.clip(np.asarray(lens, np.int64), 0, int(pad))
    lo = np.minimum(s, cap - 1)
    hi = np.where(n > 0, np.maximum(np.minimum(s + n, cap), lo + 1), lo)
    offs = np.asarray(offs, np.int64)
    total = 0
    for r in np.unique(rows[n > 0]):
        sel = (rows == r) & (n > 0)
        a, b = lo[sel], hi[sel]
        order = np.argsort(a)
        o0, o1 = max(int(offs[r]), 0), min(int(offs[r]) + Rb, cap)
        end = -1
        for x, y in zip(a[order], b[order]):
            x = max(int(x), end)
            if y > x:
                # [x, y) minus the rectangle [o0, o1)
                total += (y - x) - max(0, min(y, o1) - max(x, o0))
                end = int(y)
    return int(total)


def append_eval_bound(case):
    """(ms, 'bytes'|'operations', bytes): blk read once, the rectangle
    written once, the ring cells the windows read outside it once, the
    offsets and the (row, start, len) descriptors, one output a window and
    op; one combine a cell and value op."""
    c = case
    ring, blk = c["ring"], c["blk"]
    KP, cap = ring.shape
    Rb, B = blk.shape[1], c["starts"].numel()
    cells = covered_outside(c["rows"].cpu().numpy(), c["starts"].cpu().numpy(),
                            c["lens"].cpu().numpy(), c["pad"], cap,
                            c["offs"].cpu().numpy(), Rb)
    size = ring.element_size()
    nbytes = (blk.numel() * (blk.element_size() + size) + 4 * KP
              + size * cells + 12 * B + size * B * len(c["ops"]))
    n_ops = (sum(op != "count" for op in c["ops"])
             * int(c["lens"].long().clamp(0, c["pad"]).sum()))
    b = bytes_bound(int(nbytes), n_ops)
    return float(b[0]), b[1], int(nbytes)


def time_append_eval(case):
    """The kernel (a CUDA-graph replay, long-window list already on the
    card) hot and cold (rings cycled through three times the L2), the old
    pair ring_append + windowed_reduce_many alike, the plain version, the
    empty launch, and the bound, at one case."""
    from windflow_tpu_torch.ops import ring as rk
    from windflow_tpu_torch.ops import windowed_reduce as wr
    c = case
    dev = c["ring"].device
    long = c["long"].on(torch.from_numpy(c["long"].vec).to(dev))
    counters = torch.zeros(long.n + 1, dtype=torch.int32, device=dev)
    args = (c["blk"], c["offs"], c["ops"], c["rows"], c["starts"],
            c["lens"], c["pad"])
    d = (c["rows"], c["starts"], c["lens"], c["pad"])

    def kernel(r):
        rk.ring_append_eval(r, *args, long=long, counters=counters)

    def pair(r):
        rk.ring_append(r, c["blk"], c["offs"])
        wr.windowed_reduce_many([(r, op) for op in c["ops"]], *d)

    ring = c["ring"].clone()
    copies = cold_copies(dev, (ring,))
    row = dict(
        ms=kernel_ms(cycled(copies, kernel), reps=10 * len(copies)),
        hot_ms=kernel_ms(lambda: kernel(ring)),
        pair_ms=kernel_ms(cycled(copies, pair), reps=10 * len(copies)),
        pair_hot_ms=kernel_ms(lambda: pair(ring)),
        plain_ms=call_ms(lambda: rk.ring_append_eval_reference(ring, *args),
                         reps=2),
        floor_ms=kernel_ms(wr.empty_launch), cold_copies=len(copies))
    if bool(counters.any()):
        raise AssertionError("ring_append_eval: timed launches left a "
                             "counter set")
    b = append_eval_bound(c)
    row.update(bound_ms=b[0], bound_by=b[1], bound_bytes=b[2],
               library_ms=None)
    del copies
    return row


def ae_shapes(gen, dev):
    """The main-path shapes: {label: case}."""
    i8, i32 = torch.int8, torch.int32
    out = {}
    # YSB 10 s (kf-gpu, one of 4 workers): 25 campaigns on a 32-row ring,
    # one window a campaign of ~330k cells that ends at the appended
    # span's end (so it straddles it)
    KP, cap, Rb, K, R = 32, 1 << 19, 8192, 25, 6000
    offs = np.zeros(KP, np.int64)
    offs[:K] = 330_000 - R + gen.integers(0, 4, size=K)
    lens = gen.integers(320_000, 330_000, size=K)
    rows = np.arange(K)
    out["ysb_10s"] = ae_case(gen, dev, KP, cap, Rb, K, R, i8, i32, ("sum",),
                             rows, offs[:K] + R - lens, lens, offs,
                             pad=1 << 19)
    # YSB deterministic (16M events 2 us apart): 2 tumbling windows of
    # ~16.7k cells a campaign, the second straddling the appended span
    KP, cap, Rb, K, R = 32, 1 << 16, 4096, 25, 3000
    offs = np.zeros(KP, np.int64)
    offs[:K] = 33_500 - R + gen.integers(0, 4, size=K)
    n1 = gen.integers(16_500, 16_800, size=K)
    n2 = gen.integers(16_500, 16_800, size=K)
    s2 = offs[:K] + R - n2
    out["ysb_deterministic"] = ae_case(
        gen, dev, KP, cap, Rb, K, R, i8, i32, ("sum",),
        np.concatenate([rows[:K], rows[:K]]),
        np.concatenate([s2 - n1, s2]), np.concatenate([n1, n2]), offs,
        pad=1 << 15)
    # sum_test's Reducer("max") prefix on the native core: 64 keys, CB
    # 256/64, 128 windows a key ending at the appended span's end
    KP, cap, Rb = 64, 262144, 8192
    offs = np.full(KP, 100_000, np.int64) + np.arange(KP) % 4
    i = np.arange(C_WINDOWS)
    starts = (offs[:, None] + Rb - WIN - SLIDE * i[None, ::-1]).ravel()
    out["max_prefix"] = ae_case(
        gen, dev, KP, cap, Rb, KP, Rb, i8, i32, ("max",),
        np.repeat(np.arange(KP), C_WINDOWS), starts,
        np.full(KP * C_WINDOWS, WIN), offs, pad=WIN)
    # windows of 1k-8k cells (the split's range): 1,024 windows, sum/max
    KP, cap, Rb = 64, 1 << 17, 2048
    offs = gen.integers(60_000, 70_000, size=KP)
    B = 1024
    lens = gen.integers(1000, 8000, size=B)
    rows = gen.integers(0, KP, size=B)
    out["mid_windows"] = ae_case(
        gen, dev, KP, cap, Rb, KP, Rb, torch.int16, i32, ("sum", "max"),
        rows, offs[rows] + Rb - lens + gen.integers(-500, 500, size=B),
        lens, offs, pad=8192)
    return out


def ae_odd_cases(gen, dev, n=48):
    """Soak-sized and edge cases: tiny and odd rings and rectangles (KP 1
    to 8, Rb 1 to 48, rows >= K and columns >= R zero), offsets at every
    residue mod 4, windows into the zero columns, past the row's end and
    starting past it, empty, B = 0, ops with count, every wire x
    accumulate dtype, and small split/chunk so the long-window path runs
    at these sizes."""
    out = {}
    for i in range(n):
        wire = WIRES[i % 4]
        acc = ACCS[(i // 4) % 2]
        KP = int(gen.choice([1, 2, 4, 8]))
        cap = int(gen.choice([16, 64, 128, 1040]))
        Rb = int(min(gen.choice([1, 3, 16, 40, 48]), cap))
        K, R = int(gen.integers(1, KP + 1)), int(gen.integers(1, Rb + 1))
        offs = gen.integers(0, cap - Rb + 1, size=KP)
        offs[:4] = np.minimum(cap - Rb, 4 * (offs[:4] // 4) + np.arange(
            min(KP, 4)))
        B = int(gen.choice([0, 1, 7, 13, 64, 65, 200]))
        lens = gen.integers(0, cap + 24, size=B)
        starts = gen.integers(0, cap + 8, size=B)
        rows = gen.integers(0, KP, size=B)
        if B >= 4:     # into the zero columns, straddling the append
            starts[0], lens[0] = offs[rows[0]] + R, Rb - R + 2
            starts[1], lens[1] = max(0, offs[rows[1]] - 5), Rb + 10
            lens[2] = -3 if i % 2 else 0
            starts[3], lens[3] = cap - 1, 9
        ops = [op for op in ("sum", "count", "min", "max", "prod")
               if gen.random() < 0.5] or ["sum"]
        if "prod" in ops:
            ops = ["prod"] + (["count"] if "count" in ops else [])
        split, chunk = [(0, 32), (8, 32), (40, 64), (2048, 512)][i % 4]
        pad = int(gen.choice([max(1, int(lens.max(initial=1))), 5, cap + 30]))
        out[f"odd{i}"] = ae_case(gen, dev, KP, cap, Rb, K, R, wire, acc, ops,
                                 rows, starts, lens, offs, pad=pad,
                                 split=split, chunk=chunk)
    return out


def append_eval_phase(dev, timed=True, n_odd=48):
    """Phase 4c: ring_append_eval against its plain version and, bit for
    bit, its twin at the main-path shapes (YSB 10 s, YSB deterministic,
    the max prefix, 1k-8k windows) and the odd cases; then each main-path
    shape timed beside its bound, the empty launch and the old pair.
    Returns {label: timing row}."""
    gen = np.random.default_rng(23)
    shapes = ae_shapes(gen, dev)
    err = 0.0
    for label, case in {**shapes, **ae_odd_cases(gen, dev, n_odd)}.items():
        err = max(err, check_append_eval(case, label))
        if label.startswith("odd"):
            continue
        c = case
        emit("append_eval", case=label, ring=list(c["ring"].shape),
             Rb=c["blk"].shape[1], wire=str(c["blk"].dtype),
             acc=str(c["ring"].dtype), ops=c["ops"],
             B=c["starts"].numel(), pad=c["pad"],
             cells=int(c["lens"].long().clamp(0, c["pad"]).sum()),
             long_windows=c["long"].n, chunks=c["long"].chunks,
             max_abs_err=err, twin_bitwise=True)
    emit("append_eval", case="odd", cases=n_odd, max_abs_err=err,
         twin_bitwise=True, ok=True)
    rows = {}
    if timed:
        for label, case in shapes.items():
            rows[label] = dict(max_abs_err=err, **time_append_eval(case))
            emit("append_eval_timed", case=label, **rows[label])
    del shapes
    torch.cuda.empty_cache() if torch.cuda.is_available() else None
    return rows


# ring_append_multi_eval (phase 4d): the per-field resident step in one
# launch.  Each case: a (KP, cap) ring a field, their (KP, Rb) rectangles
# (K rows and R columns of data, the rest zero), the shared offsets, the
# (field, op) stats, the tile fields and the windows.

def mae_case(gen, dev, KP, cap, Rb, K, R, fields, evals, tile_fields, rows,
             starts, lens, offs, pad=None, split=None, chunk=None):
    """One ring_append_multi_eval case on `dev`: `fields` is a (wire, acc)
    pair a field (windows from host arrays)."""
    from windflow_tpu_torch.ops import ring as rk
    rings, blks = [], []
    for f, (wire, acc) in enumerate(fields):
        prod = any(g == f and op == "prod" for g, op in evals)
        rings.append(ae_values(gen, (KP, cap), acc, prod).to(dev))
        blk = torch.zeros((KP, Rb), dtype=wire)
        blk[:K, :R] = ae_values(gen, (K, R), wire, prod)
        blks.append(blk.to(dev))
    as32 = lambda a: torch.from_numpy(                       # noqa: E731
        np.ascontiguousarray(a, dtype=np.int32)).to(dev)
    pad = int(pad if pad is not None else max(1, int(np.max(lens, initial=1))))
    long = rk.long_windows(rows, starts, lens, pad, cap,
                           split if split is not None else rk.LONG_SPLIT,
                           chunk if chunk is not None else rk.LONG_CHUNK)
    return dict(rings=rings, blks=blks, offs=as32(offs), evals=list(evals),
                tile_fields=tuple(tile_fields), rows=as32(rows),
                starts=as32(starts), lens=as32(lens), pad=pad, long=long)


def check_multi_append_eval(case, name):
    """ring_append_multi_eval on copies of the case's rings, twice, against
    the plain version and, bit for bit, against
    multi_append_eval_order_twin (both on the card): every ring identical,
    the two launches' outputs equal, the tiles and the mask bit for bit
    equal to the plain gather's, the counters left at zero.  Returns the
    largest error of a stat against the plain version."""
    from windflow_tpu_torch.ops import ring as rk
    from windflow_tpu_torch.ops import windowed_reduce as wr
    c = case
    args = (c["blks"], c["offs"], c["evals"], c["rows"], c["starts"],
            c["lens"], c["pad"])
    dev = c["offs"].device
    counters = torch.zeros(c["long"].n + 1, dtype=torch.int32, device=dev)
    rings = [[r.clone() for r in c["rings"]] for _ in range(3)]
    got = rk.ring_append_multi_eval(rings[0], *args, c["tile_fields"],
                                    long=c["long"], counters=counters)
    again = rk.ring_append_multi_eval(rings[0], *args, c["tile_fields"],
                                      long=c["long"], counters=counters)
    plain = rk.ring_append_multi_eval_reference(rings[1], *args,
                                                c["tile_fields"])
    twin = rk.multi_append_eval_order_twin(
        rings[2], *args, c["tile_fields"], split=c["long"].split,
        chunk=c["long"].chunk)
    _sync(dev)
    for f in range(len(c["rings"])):
        if not (torch.equal(bits(rings[0][f]), bits(rings[1][f]))
                and torch.equal(bits(rings[0][f]), bits(rings[2][f]))):
            raise AssertionError(f"ring_append_multi_eval {name}: field "
                                 f"{f}'s ring differs from the plain append")
    if c["long"].n and bool(counters.any()):
        raise AssertionError(f"ring_append_multi_eval {name}: counters left "
                             f"at {counters.nonzero().flatten().tolist()}")
    for what, other in (("the plain gather", plain), ("a second launch",
                                                        again)):
        for t, (g, o) in enumerate(zip(got[1], other[1])):
            if not torch.equal(bits(g), bits(o)):
                raise AssertionError(f"ring_append_multi_eval {name}: tile "
                                     f"{t} differs from {what}'s")
        if (got[2] is None) != (other[2] is None) or (
                got[2] is not None and not torch.equal(got[2], other[2])):
            raise AssertionError(f"ring_append_multi_eval {name}: the mask "
                                 f"differs from {what}'s")
    n = c["lens"].long().clamp(0, c["pad"])
    err = 0.0
    for e, (f, op) in enumerate(c["evals"]):
        g, a, p, t = got[0][e], again[0][e], plain[0][e], twin[0][e]
        for other, what in ((t, "the twin"), (a, "a second launch")):
            if not torch.equal(bits(g), bits(other)):
                bad = int((bits(g) != bits(other)).nonzero()[0])
                raise AssertionError(
                    f"ring_append_multi_eval {name} {op} of field {f}: "
                    f"window {bad} gives {bits(g)[bad].item()}, {what} "
                    f"{bits(other)[bad].item()} (bits)")
        ring = rings[1][f]
        scale = wr.windowed_reduce_many_reference(
            [(ring.abs(), "sum")], c["rows"], c["starts"], c["lens"],
            c["pad"])[0] if ring.is_floating_point() else None
        err = max(err, ae_compare(g, p, scale, n, op,
                                  f"ring_append_multi_eval {name}"))
    return err


def multi_append_eval_bound(case):
    """(ms, 'bytes'|'operations', bytes): every field's blk read once and
    its rectangle written once; for each field a stat or a tile reads, the
    ring cells the windows cover outside the rectangle once; the offsets
    and the (row, start, len) descriptors; one output a window and stat,
    every tile and the mask written once; one combine a cell a value
    stat."""
    c = case
    KP, cap = c["rings"][0].shape
    Rb, B, pad = c["blks"][0].shape[1], c["starts"].numel(), c["pad"]
    cells = covered_outside(c["rows"].cpu().numpy(), c["starts"].cpu().numpy(),
                            c["lens"].cpu().numpy(), pad, cap,
                            c["offs"].cpu().numpy(), Rb)
    read = {f for f, _op in c["evals"]} | set(c["tile_fields"])
    size = [r.element_size() for r in c["rings"]]
    nbytes = (sum(b.numel() * (b.element_size() + r.element_size())
                  for r, b in zip(c["rings"], c["blks"])) + 4 * KP
              + cells * sum(size[f] for f in read) + 12 * B
              + B * sum(size[f] for f, _op in c["evals"])
              + (B * pad * (sum(size[f] for f in c["tile_fields"]) + 1)
                 if c["tile_fields"] else 0))
    n_ops = (sum(op != "count" for _f, op in c["evals"])
             * int(c["lens"].long().clamp(0, pad).sum()))
    b = bytes_bound(int(nbytes), n_ops)
    return float(b[0]), b[1], int(nbytes)


def time_multi_append_eval(case):
    """The kernel (a CUDA-graph replay) cold (its rings cycled through
    three times the L2) and hot, the old composition (ring_append a field,
    windowed_reduce_many, window_gather) alike, the plain version, the
    empty launch and the bound, at one case."""
    from windflow_tpu_torch.ops import gather
    from windflow_tpu_torch.ops import ring as rk
    from windflow_tpu_torch.ops import windowed_reduce as wr
    c = case
    dev = c["offs"].device
    long = c["long"].on(torch.from_numpy(c["long"].vec).to(dev))
    counters = torch.zeros(long.n + 1, dtype=torch.int32, device=dev)
    d = (c["rows"], c["starts"], c["lens"], c["pad"])

    def kernel(*rings):
        rk.ring_append_multi_eval(rings, c["blks"], c["offs"], c["evals"],
                                  *d, c["tile_fields"], long=long,
                                  counters=counters)

    def old(*rings):
        for r, b in zip(rings, c["blks"]):
            rk.ring_append(r, b, c["offs"])
        if c["evals"]:
            wr.windowed_reduce_many([(rings[f], op) for f, op in c["evals"]],
                                    *d)
        if c["tile_fields"]:
            gather.window_gather([rings[f] for f in c["tile_fields"]], *d)

    rings = [r.clone() for r in c["rings"]]
    copies = cold_copies(dev, rings)
    row = dict(
        ms=kernel_ms(cycled(copies, kernel), reps=10 * len(copies)),
        hot_ms=kernel_ms(lambda: kernel(*rings)),
        old_ms=kernel_ms(cycled(copies, old), reps=10 * len(copies)),
        old_hot_ms=kernel_ms(lambda: old(*rings)),
        plain_ms=call_ms(lambda: rk.ring_append_multi_eval_reference(
            rings, c["blks"], c["offs"], c["evals"], *d, c["tile_fields"]),
            reps=2),
        floor_ms=kernel_ms(wr.empty_launch), cold_copies=len(copies))
    if bool(counters.any()):
        raise AssertionError("ring_append_multi_eval: timed launches left a "
                             "counter set")
    b = multi_append_eval_bound(c)
    row.update(bound_ms=b[0], bound_by=b[1], bound_bytes=b[2],
               library_ms=None)
    del copies
    return row


def mae_shapes(gen, dev):
    """The main-path shapes: {label: case}."""
    f32, i8, i16, i32 = torch.float32, torch.int8, torch.int16, torch.int32
    out = {}
    # (a) a spatial resident launch: one key's 2^19-column float32
    # rectangle of x and y into 8 x 2^22 float32 rings, SP_B windows of
    # ~SP_WIN points SP_SLIDE apart (some straddling the appended span's
    # start), tiles of both fields at SP_PAD, no stat
    o = 1_000_000
    offs = np.zeros(SP_KP, np.int64)
    offs[0] = o
    starts = o - 20 * SP_SLIDE + SP_SLIDE * np.arange(SP_B)
    lens = SP_WIN - gen.integers(0, 50, size=SP_B)
    out["spatial"] = mae_case(
        gen, dev, SP_KP, SP_CAP, 1 << 19, 1, SP_B * SP_SLIDE,
        [(f32, f32), (f32, f32)], [], (0, 1), np.zeros(SP_B, np.int64),
        starts, lens, offs, pad=SP_PAD)
    # (b) a MultiReducer launch (sum(a) + max(b), CB 256/64, 64 keys): a
    # flush of 8,192 rows a key, a in int8 and b in int16 wires into int32
    # rings, 128 windows a key ending at the appended span's end
    KP, cap, Rb = N_KEYS, 262144, FLUSH_ROWS // N_KEYS
    offs = np.full(KP, 100_000, np.int64) + np.arange(KP) % 4
    i = np.arange(C_WINDOWS)
    starts = (offs[:, None] + Rb - WIN - SLIDE * i[None, ::-1]).ravel()
    out["multi_reducer"] = mae_case(
        gen, dev, KP, cap, Rb, KP, Rb, [(i8, i32), (i16, i32)],
        [(0, "sum"), (1, "max")], (), np.repeat(np.arange(KP), C_WINDOWS),
        starts, np.full(KP * C_WINDOWS, WIN), offs, pad=WIN)
    # (c) 1,024 windows of 1k-8k cells (past the split) over 3 fields,
    # int32 and float32 rings, all five ops and a function's tiles
    KP, cap, Rb = 64, 1 << 17, 2048
    offs = gen.integers(60_000, 70_000, size=KP)
    B = 1024
    lens = gen.integers(1000, 8000, size=B)
    rows = gen.integers(0, KP, size=B)
    out["long_windows"] = mae_case(
        gen, dev, KP, cap, Rb, KP, Rb, [(i16, i32), (f32, f32), (i8, i32)],
        [(0, "sum"), (1, "min"), (1, "max"), (0, "count"), (2, "prod"),
         (1, "sum")], (0, 1), rows,
        offs[rows] + Rb - lens + gen.integers(-500, 500, size=B), lens, offs,
        pad=8192)
    return out


def mae_odd_cases(gen, dev, n=48):
    """Soak-sized and edge cases: 1-5 fields of every wire x accumulate
    dtype (9 and 10 in the last two: a launch a group of 8), tiny and odd
    rings and rectangles (Rb 1 to 48, rows >= K and columns >= R zero),
    offsets at every residue mod 4, windows into the zero columns, across the rectangle's edges, past the row's end and
    starting past it, empty, B = 0, a field with neither stat nor tile,
    0-12 stats (9-12 in two launches), tiles at odd pads, small split and
    chunk so the long-window path runs at these sizes."""
    out = {}
    ops = ("sum", "count", "min", "max")
    for i in range(n):
        nf = 1 + i % 5 if i < n - 2 else 11 - (n - i)
        fields = [(WIRES[(i + f) % 4], ACCS[(i // 4 + f) % 2])
                  for f in range(nf)]
        KP = int(gen.choice([1, 2, 4, 8]))
        cap = int(gen.choice([16, 64, 128, 1040]))
        Rb = int(min(gen.choice([1, 3, 16, 40, 48]), cap))
        K, R = int(gen.integers(1, KP + 1)), int(gen.integers(1, Rb + 1))
        offs = gen.integers(0, cap - Rb + 1, size=KP)
        offs[:4] = np.minimum(cap - Rb, 4 * (offs[:4] // 4) + np.arange(
            min(KP, 4)))
        B = int(gen.choice([0, 1, 7, 13, 64, 65, 200]))
        lens = gen.integers(0, cap + 24, size=B)
        starts = gen.integers(0, cap + 8, size=B)
        rows = gen.integers(0, KP, size=B)
        if B >= 4:     # into the zero columns, straddling the append
            starts[0], lens[0] = offs[rows[0]] + R, Rb - R + 2
            starts[1], lens[1] = max(0, offs[rows[1]] - 5), Rb + 10
            lens[2] = -3 if i % 2 else 0
            starts[3], lens[3] = cap - 1, 9
        # the last field of a multi-field case has neither stat nor tile;
        # a field of products takes prod and count only (its values keep
        # products finite)
        live = nf - 1 if nf > 1 else 1
        prods = gen.random(live) < 0.3
        evals = []
        for _ in range([0, 1, 3, 8, 9, 12][i % 6]):
            f = int(gen.integers(0, live))
            evals.append((f, str(gen.choice(("prod", "count") if prods[f]
                                            else ops))))
        tiles = [f for f in range(live) if gen.random() < 0.6]
        split, chunk = [(0, 32), (8, 32), (40, 64), (2048, 512)][i % 4]
        pad = int(gen.choice([max(1, int(lens.max(initial=1))), 5, cap + 30]))
        out[f"odd{i}"] = mae_case(gen, dev, KP, cap, Rb, K, R, fields, evals,
                                  tiles, rows, starts, lens, offs, pad=pad,
                                  split=split, chunk=chunk)
    return out


def multi_append_eval_phase(dev, timed=True, n_odd=48):
    """Phase 4d: ring_append_multi_eval against its plain version and, bit
    for bit, its twin at the main-path shapes (a spatial launch, a
    MultiReducer launch, long windows over 3 fields) and the odd cases;
    then each main-path shape timed beside its bound, the empty launch and
    the old composition.  Returns {label: timing row}."""
    gen = np.random.default_rng(29)
    shapes = mae_shapes(gen, dev)
    err = 0.0
    for label, case in {**shapes, **mae_odd_cases(gen, dev, n_odd)}.items():
        err = max(err, check_multi_append_eval(case, label))
        if label.startswith("odd"):
            continue
        c = case
        emit("multi_append_eval", case=label, ring=list(c["rings"][0].shape),
             Rb=c["blks"][0].shape[1],
             fields=[[str(b.dtype), str(r.dtype)]
                     for r, b in zip(c["rings"], c["blks"])],
             evals=c["evals"], tile_fields=list(c["tile_fields"]),
             B=c["starts"].numel(), pad=c["pad"],
             cells=int(c["lens"].long().clamp(0, c["pad"]).sum()),
             long_windows=c["long"].n, chunks=c["long"].chunks,
             max_abs_err=err, twin_bitwise=True)
    emit("multi_append_eval", case="odd", cases=n_odd, max_abs_err=err,
         twin_bitwise=True, ok=True)
    rows = {}
    if timed:
        for label, case in shapes.items():
            rows[label] = dict(max_abs_err=err,
                               **time_multi_append_eval(case))
            emit("multi_append_eval_timed", case=label, **rows[label])
    del shapes
    torch.cuda.empty_cache() if torch.cuda.is_available() else None
    return rows


@contextlib.contextmanager
def recorded(name, record):
    """Records every call the resident executors make to the kernel wrapper
    `name` (as ops/resident.py imports it) while active: the yielded list
    gets record(*args) of each call, which goes on to the wrapper
    unchanged."""
    from windflow_tpu_torch.ops import resident
    orig, calls = getattr(resident, name), []

    def recording(*args, **kw):
        calls.append(record(*args, **kw))
        return orig(*args, **kw)

    setattr(resident, name, recording)
    try:
        yield calls
    finally:
        setattr(resident, name, orig)


def recorded_multi_evals():
    """Records every ring_append_multi_eval call (the rings' shape and
    dtypes, copies of the rectangles, offsets and window descriptors, the
    stats, the tile fields, the pad and the long-window list)."""
    def record(rings, blks, offs, evals, rows, starts, lens, pad,
               tile_fields=(), long=None, counters=None):
        return dict(shape=tuple(rings[0].shape),
                    dtypes=[r.dtype for r in rings],
                    blks=[b.clone() for b in blks], offs=offs.clone(),
                    evals=list(evals), tile_fields=tuple(tile_fields),
                    rows=rows.clone(), starts=starts.clone(),
                    lens=lens.clone(), pad=int(pad),
                    long=dataclasses.replace(long, dev=None)
                    if long is not None else None)
    return recorded("ring_append_multi_eval", record)


def multi_eval_call_case(c, gen):
    """A recorded ring_append_multi_eval call as a case over seeded rings
    of its shape and dtypes (values 1..97; a field of products near 1)."""
    from windflow_tpu_torch.ops import ring as rk
    long = c["long"] or rk.long_windows(
        c["rows"].cpu().numpy(), c["starts"].cpu().numpy(),
        c["lens"].cpu().numpy(), c["pad"], c["shape"][1])
    dev = c["offs"].device
    rings = [ae_values(gen, c["shape"], dt,
                       any(g == f and op == "prod" for g, op in c["evals"])
                       ).to(dev) for f, dt in enumerate(c["dtypes"])]
    return dict(rings=rings, long=long,
                **{k: c[k] for k in ("blks", "offs", "evals", "tile_fields",
                                     "rows", "starts", "lens", "pad")})


def check_multi_evals(calls, name, seed=7):
    """ring_append_multi_eval against its plain version and its twin
    (check_multi_append_eval) on the inputs of every call in `calls`, each
    over seeded rings of the recorded shape and dtypes.  Returns (calls
    checked, the largest error)."""
    gen = np.random.default_rng(seed)
    err = 0.0
    for i, c in enumerate(calls):
        err = max(err, check_multi_append_eval(multi_eval_call_case(c, gen),
                                               f"{name} call {i}"))
    return len(calls), err


def multi_eval_row(calls, name):
    """Every call checked (check_multi_evals), the largest (by its
    rectangles' cells) timed at its own inputs (time_multi_append_eval);
    returns its row (the spatial run's is the kernels line's)."""
    n, err = check_multi_evals(calls, name)
    big = max(calls, key=lambda c: (sum(b.numel() for b in c["blks"]),
                                    c["starts"].numel()))
    case = multi_eval_call_case(big, np.random.default_rng(8))
    row = dict(max_abs_err=err, **time_multi_append_eval(case))
    emit("multi_append_eval_calls", run=name, calls_checked=n,
         timed=dict(rings=[list(big["shape"])] * len(big["dtypes"]),
                    Rb=big["blks"][0].shape[1],
                    fields=[[str(b.dtype), str(dt)] for b, dt in
                            zip(big["blks"], big["dtypes"])],
                    evals=big["evals"],
                    tile_fields=list(big["tile_fields"]),
                    B=big["starts"].numel(), pad=big["pad"]), **row)
    del case
    return row


def rectangles_of(calls):
    """Each field's (rectangle, offsets) of the recorded
    ring_append_multi_eval calls, as ring_append calls (ring_append_phase
    checks and times ring_append at them)."""
    return [dict(shape=c["shape"], dtype=dt, blk=b, offs=c["offs"])
            for c in calls for dt, b in zip(c["dtypes"], c["blks"])]


def recorded_fused():
    """Records every ring_append_regular_sum call (the ring's shape and
    dtype, copies of the rectangle, offsets and window descriptors, C and
    the slide)."""
    return recorded("ring_append_regular_sum", lambda ring, blk, offs, rstart0,
                    rlen, C, slide: dict(
                        shape=tuple(ring.shape), dtype=ring.dtype,
                        blk=blk.clone(), offs=offs.clone(),
                        rstart0=rstart0.clone(), rlen=rlen.clone(), C=int(C),
                        slide=int(slide)))


def recorded_append_evals():
    """Records every ring_append_eval call (the ring's shape and dtype,
    copies of the rectangle, offsets and window descriptors, the ops, the
    pad and the long-window list)."""
    def record(ring, blk, offs, evals, rows, starts, lens, pad, long=None,
               counters=None):
        return dict(shape=tuple(ring.shape), dtype=ring.dtype,
                    blk=blk.clone(), offs=offs.clone(), ops=list(evals),
                    rows=rows.clone(), starts=starts.clone(),
                    lens=lens.clone(), pad=int(pad),
                    long=dataclasses.replace(long, dev=None)
                    if long is not None else None)
    return recorded("ring_append_eval", record)


def append_eval_call_case(c, gen):
    """A recorded ring_append_eval call as a case over a seeded ring of
    its shape and dtype (values 1..97)."""
    from windflow_tpu_torch.ops import ring as rk
    long = c["long"] or rk.long_windows(
        c["rows"].cpu().numpy(), c["starts"].cpu().numpy(),
        c["lens"].cpu().numpy(), c["pad"], c["shape"][1])
    return dict(ring=ae_values(gen, c["shape"], c["dtype"],
                               "prod" in c["ops"]).to(c["blk"].device),
                long=long, **{k: c[k] for k in ("blk", "offs", "ops", "rows",
                                                "starts", "lens", "pad")})


def check_append_evals(calls, name, seed=7):
    """ring_append_eval against its plain version and its twin
    (check_append_eval) on the inputs of every call in `calls`, each over
    a seeded ring of the recorded shape and dtype.  Returns (calls
    checked, the largest error)."""
    gen = np.random.default_rng(seed)
    err = 0.0
    for i, c in enumerate(calls):
        err = max(err, check_append_eval(append_eval_call_case(c, gen),
                                         f"{name} call {i}"))
    return len(calls), err


def seeded_ring(gen, shape, dtype):
    """A ring of `shape` and `dtype` on the card with seeded contents in
    [-100, 100)."""
    return (torch.rand(shape, generator=gen, device=gen.device) * 200
            - 100).to(dtype)


def check_appends(calls, name):
    """ring_append against its plain version on the inputs of every call
    in `calls` (the recorded rectangles and offsets into a seeded ring of
    the recorded shape and dtype): the rings must be identical.  Returns
    the number of calls checked."""
    from windflow_tpu_torch.ops import ring as rk
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    rings = {}
    for c in calls:
        key = (c["shape"], c["dtype"])
        if key not in rings:
            rings[key] = seeded_ring(gen, *key)
        got = rk.ring_append(rings[key].clone(), c["blk"], c["offs"])
        want = rk.ring_append_reference(rings[key].clone(), c["blk"],
                                        c["offs"])
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: ring_append {c['blk'].dtype} -> "
                                 f"{c['dtype']} {c['shape']}: rings differ")
        del got, want
    return len(calls)


def check_fused(calls, name):
    """ring_append_regular_sum against its plain version (check_ring: the
    rings identical, int32 sums exact, float32 sums within FLOAT_RTOL of
    the window's sum of |x|) on the inputs of every call in `calls`, each
    over a seeded ring of the recorded shape and dtype.  Returns (calls
    checked, the sums' largest error)."""
    from windflow_tpu_torch.ops import ring as rk
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    err = 0.0
    for i, c in enumerate(calls):
        case = dict(ring=seeded_ring(gen, c["shape"], c["dtype"]),
                    **{k: c[k] for k in ("blk", "offs", "rstart0", "rlen",
                                         "C", "slide")})
        err = max(err, check_ring(rk, case, f"{name} call {i}"))
    return len(calls), err


def ring_append_phase(dev, calls):
    """ring_append against its plain version on the inputs of every call in
    `calls` (check_appends: the spatial run's rectangles, which its fused
    launches append), timed on the largest.  Its rectangle and the
    cells it writes fit in the card's L2, so a replay of the same inputs
    would find them there: the timed calls cycle through copies of the
    inputs whose sum is three times the L2 (at most 16 copies), each call
    on cold cells (the same inputs back to back are reported beside, as
    hot_l2_ms).  Returns the kernels-line row."""
    from windflow_tpu_torch.ops import ring as rk
    check_appends(calls, "spatial resident run's rectangles")
    big = max(calls, key=lambda c: c["blk"].numel())
    ring = seeded_ring(torch.Generator(device=dev).manual_seed(5),
                       big["shape"], big["dtype"])
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
    if torch.cuda.is_available():
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


def resident_stage(wt, reducer=None, device=DEVICE, **kw):
    """The JAX package's bench.py stage, through the port's entry point:
    the default route of a builtin sum is the resident path."""
    return wt.WinSeqGPU(reducer or wt.Reducer("sum", value_range=(0, 100)),
                        WIN, SLIDE, wt.WinType.CB, batch_len=BATCH_LEN,
                        flush_rows=FLUSH_ROWS, depth=DEPTH, shards=1,
                        device=device, **kw)


def host_rows(wt, reducer, batches, schema):
    host = wt.WinSeq(reducer, WIN, SLIDE, wt.WinType.CB)
    return run_pipeline(host, batches, schema, keep=True)


def end_to_end_resident(wr, rk):
    """sum_test, 16M tuples, through NativeResidentCore and the ring
    kernels; returns the ring kernels' launch counts in that run: one
    fused launch a regular flush, one ring_append_eval an irregular
    launch."""
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
    counters = (rk.ring_append_regular_sum, rk.ring_append_eval,
                rk.ring_append, wr.windowed_reduce)
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
    # irregular launch (one ring_append_eval: the append and the one op),
    # never the ring_append + windowed_reduce pair
    if not (launches["ring_append_regular_sum"] > 0
            and launches["ring_append"] == launches["windowed_reduce"] == 0
            and stats["dispatches"] == launches["ring_append_regular_sum"]
            + launches["ring_append_eval"]):
        raise AssertionError(f"the resident path launched {launches}, "
                             f"dispatches {stats['dispatches']}")
    emit("end_to_end_resident",
         workload="sum_test CB win=256 slide=64 keys=64 resident",
         tuples=N_TUPLES, seconds=dt, tuples_per_s=N_TUPLES / dt,
         windows=n_windows, total=total, oracle=want, launches=launches,
         stats=stats, max_memory_allocated=torch.cuda.max_memory_allocated())
    return launches


def irregular_and_python_core(wr, rk):
    """Reducer("max") on the native core (irregular launches: one
    ring_append_eval each) and Reducer("sum") on the Python resident core,
    each byte for byte against the host core, and every ring_append_eval
    call against its plain version and its twin."""
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
                    rk.ring_append_regular_sum, rk.ring_append_eval)
        counts = [c.launches for c in counters]
        with recorded_append_evals() as calls:
            _, n_dev, _, dev_rows = run_pipeline(stage, prefix, schema,
                                                 True)
        counts = [c.launches - a for c, a in zip(counters, counts)]
        if not (len(cores) == 1 and type(cores[0]) is cls
                and getattr(cores[0], "_delegate", None) is None):
            raise AssertionError(f"{op}/{name}: the stage's core is {cores}")
        if counts[3] == 0 or counts[0] or counts[1]:
            raise AssertionError(f"{op}/{name}: launches {counts}")
        n_calls, err = check_append_evals(calls, f"{op}/{name}")
        _, n_host, _, want_rows = host_rows(wt, wt.Reducer(op), prefix,
                                            schema)
        if n_dev != n_host or by_key(dev_rows) != by_key(want_rows):
            raise AssertionError(f"{op}/{name}: the resident path differs "
                                 "from the host core")
        emit("irregular_and_python_core", op=op, core=cls.__name__,
             tuples=PREFIX_TUPLES, windows=n_dev, identical=True,
             launches={"windowed_reduce": counts[0],
                       "ring_append": counts[1],
                       "ring_append_regular_sum": counts[2],
                       "ring_append_eval": counts[3]},
             append_eval_calls_checked=n_calls, append_eval_max_abs_err=err)


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
    oracle and the host core; returns each route's launch counts and the
    resident route's ring_append_multi_eval calls
    (recorded_multi_evals)."""
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

    counters = (rk.ring_append, rk.ring_append_multi_eval, g.window_gather,
                sk.skyline_windows, wr.windowed_reduce)
    runs = {}
    for name, kw in (("spatial_resident", dict(use_resident=True)),
                     ("spatial_restaging", {})):
        for c in counters:
            c.launches = 0
        with recorded_multi_evals() as calls:
            dt, rows = run_rows(farm(**kw), batches, POINT_SCHEMA)
        launches = {c.__name__: c.launches for c in counters}
        check_spatial_oracle(rows, batches, name)
        # the resident run: 2 workers x (a full batch + EOS), one fused
        # launch each (both rings' appends and both fields' tiles), one
        # skyline launch each; the restaging run: one gather launch per
        # fn launch (both fields in one)
        if name == "spatial_resident":
            ok = (launches["ring_append_multi_eval"] == 4
                  and launches["skyline_windows"] == 4
                  and launches["ring_append"] == 0
                  and launches["window_gather"] == 0)
        else:
            ok = (launches["window_gather"] == launches["skyline_windows"]
                  > 0 and launches["ring_append"] == 0
                  and launches["ring_append_multi_eval"] == 0)
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
    return (runs["spatial_resident"][1], runs["spatial_restaging"][1],
            runs["spatial_resident"][2])


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


def multi_stream(wt):
    """(schema, batches) of the two-field stream: MULTI_TUPLES tuples of
    N_KEYS keys, a in [0, 100), b in [-30000, 30000)."""
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
    return schema, batches


def multi_agg(wt):
    return wt.MultiReducer(("sum", "a", "sa"), ("max", "b", "mb"),
                           ("count", None, "n"))


def multi_field_native(wr, rk):
    """sum(a) + max(b) + count over CB 256/64, 64 keys, 4M tuples: the
    native core's per-field rings against the port's host core, one
    ring_append_multi_eval launch a dispatch (never ring_append or
    windowed_reduce), every call against its plain version and twin.
    Returns the fused kernel's launches in the run."""
    import windflow_tpu_torch as wt
    schema, batches = multi_stream(wt)

    def agg():
        return multi_agg(wt)

    from windflow_tpu_torch.ops.resident import MultiFieldResidentExecutor
    cores = []
    stage = stage_with_core(lambda: wt.WinSeqGPU(
        agg(), WIN, SLIDE, wt.WinType.CB, batch_len=BATCH_LEN,
        flush_rows=FLUSH_ROWS, depth=DEPTH, device=DEVICE), cores)
    wrappers = (wr.windowed_reduce, rk.ring_append, rk.ring_append_multi_eval)
    for w in wrappers:
        w.launches = 0
    with counted_launches(MultiFieldResidentExecutor) as dispatches, \
            recorded_multi_evals() as calls:
        dt, rows = run_rows(stage, batches, schema)
    counts = {w.__name__: w.launches for w in wrappers}
    if not (len(cores) == 1 and getattr(cores[0], "_multi", False)
            and cores[0]._delegate is None):
        raise AssertionError(f"multi_field_native: the core is {cores}")
    # one fused launch a dispatch: both rings' appends and both stats (the
    # JAX step is one jitted program a dispatch)
    if not (counts["ring_append_multi_eval"] == dispatches["calls"] > 0
            and dispatches["with_windows"] > 0
            and counts["ring_append"] == counts["windowed_reduce"] == 0):
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
         launches=counts, dispatches=dispatches,
         multi_eval=multi_eval_row(calls, "multi_field_native"))
    return counts["ring_append_multi_eval"]


# the Yahoo Streaming Benchmark at its published shape (apps/ysb.py, the
# reference's src/yahoo_test_cpu, -DN_CAMPAIGNS=100): 100 campaigns x 10
# ads, TB tumbling windows of 10 s, COUNT + MAX(ts) + SUM(revenue) per
# campaign, 4 window workers, chunks of 262,144 events; the deterministic
# stream steps ts 2 us an event (16M events = 32 s of event time, ~16.7k
# kept events a campaign a full window)
YSB_EVENTS = 16_000_000
YSB_PREFIX = 1 << 20
YSB_CHUNK = 262_144
YSB_TS_STEP_US = 2
YSB_WIN_SEC = 10.0
YSB_PARDEGREE2 = 4
YSB_TIMED_SEC = 10.0
PIPE_TUPLES = 8_000_000
TWO_STAGE_TUPLES = 1 << 20


def kernel_wrappers():
    """Every kernel wrapper of the port, by kernel name."""
    from windflow_tpu_torch.ops import gather, skyline
    from windflow_tpu_torch.ops import mesh_reduce as mr
    from windflow_tpu_torch.ops import ring as rk
    from windflow_tpu_torch.ops import windowed_reduce as wr
    return {"windowed_reduce": wr.windowed_reduce,
            "ring_append": rk.ring_append,
            "ring_append_regular_sum": rk.ring_append_regular_sum,
            "ring_append_eval": rk.ring_append_eval,
            "ring_append_multi_eval": rk.ring_append_multi_eval,
            "window_gather": gather.window_gather,
            "skyline_windows": skyline.skyline_windows,
            "sp_window_partial": mr.sp_window_partial,
            "sp_merge": mr.sp_merge}


@contextlib.contextmanager
def kernel_launches():
    """Sets every kernel's launch count to 0; on exit the yielded dict
    holds each kernel's launches inside the block."""
    wrappers, counts = kernel_wrappers(), {}
    for w in wrappers.values():
        w.launches = 0
    yield counts
    counts.update({name: w.launches for name, w in wrappers.items()})


def require_launches(phase, counts, names, every=True):
    """Fail unless every one of the kernels `names` (with every=False: one
    of them) was launched."""
    launched = [counts[n] > 0 for n in names]
    if not (all(launched) if every else any(launched)):
        raise AssertionError(f"{phase}: launches {counts}, wanted "
                             f"{'each' if every else 'one'} of {names}")


def ysb_batches(n_events):
    """The deterministic YSB stream (tests/test_ysb.py's fixed_batches at
    YSB_TS_STEP_US an event): the reference's ad / event-type recurrences,
    revenue 1..97."""
    from windflow_tpu_torch import batch_from_columns
    from windflow_tpu_torch.apps import ysb
    n_ads = ysb.CampaignGenerator().n_ads
    out = []
    for lo in range(0, n_events, YSB_CHUNK):
        v = np.arange(lo, min(lo + YSB_CHUNK, n_events), dtype=np.int64)
        vm = v % 100000
        out.append(batch_from_columns(
            ysb.EVENT_SCHEMA, key=np.zeros(len(v), dtype=np.int64), id=v,
            ts=v * YSB_TS_STEP_US, ad_id=vm % n_ads,
            event_type=(vm % 3).astype(np.int8), revenue=(vm % 97) + 1))
    return out


def ysb_oracle(n_events):
    """{campaign: [(count, lastUpdate, revenue), ...]} over the non-empty
    windows in window order, by bincount over (campaign, window)."""
    from windflow_tpu_torch.apps import ysb
    camp = ysb.CampaignGenerator()
    v = np.arange(n_events, dtype=np.int64)
    vm = v % 100000
    keep = vm % 3 == 0
    cmp_ids = camp.ad_to_cmp[(vm % camp.n_ads)[keep]]
    ts = v[keep] * YSB_TS_STEP_US
    rev = ((vm % 97) + 1)[keep]
    wins = ts // int(YSB_WIN_SEC * 1e6)
    n_w = int(wins.max()) + 1
    g = cmp_ids * n_w + wins
    size = camp.n_campaigns * n_w
    count = np.bincount(g, minlength=size)
    revenue = np.bincount(g, weights=rev, minlength=size)   # exact < 2**53
    last = np.full(size, -1, dtype=np.int64)
    np.maximum.at(last, g, ts)
    out = {}
    for c in range(camp.n_campaigns):
        out[c] = [(int(count[i]), int(last[i]), int(revenue[i]))
                  for i in range(c * n_w, (c + 1) * n_w) if count[i]]
    return out


def run_ysb(variant, batches, full_rows=False):
    """One deterministic YSB run through apps.ysb.build_pipeline; returns
    (seconds, {campaign: rows in arrival order}): (count, lastUpdate,
    revenue), or with full_rows every result column."""
    from windflow_tpu_torch.apps import ysb
    by_key, fields = {}, ("count", "lastUpdate", "revenue")

    def collect(live):
        for r in live:
            by_key.setdefault(int(r["key"]), []).append(
                r.tobytes() if full_rows else tuple(int(r[f])
                                                    for f in fields))

    pipe, sink, sent = ysb.build_pipeline(
        variant, 0, 1, YSB_PARDEGREE2, YSB_WIN_SEC, YSB_CHUNK,
        batches=batches, on_result=collect,
        device=DEVICE if variant.endswith("-gpu") else None)
    t0 = time.perf_counter()
    pipe.run_and_wait_end()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if sent[0] != sum(len(b) for b in batches):
        raise AssertionError(f"ysb {variant}: sent {sent[0]}")
    return dt, by_key


def ysb_append_eval_phase(calls, variant):
    """ring_append_eval against its plain version and its twin on the
    inputs of every call in `calls` (YSB's long TB windows, over a seeded
    ring of the recorded shape), timed on the call with the most cells
    beside its bound, the empty launch and the old ring_append +
    windowed_reduce pair.  Returns the timing row."""
    n, err = check_append_evals(calls, f"ysb {variant}")
    big = max(calls, key=lambda c: int(c["lens"].long().clamp(
        0, c["pad"]).sum()))
    case = append_eval_call_case(big, np.random.default_rng(9))
    row = dict(max_abs_err=err, **time_append_eval(case))
    emit("ysb_append_eval", variant=variant, calls_checked=n,
         ring=list(big["shape"]), Rb=big["blk"].shape[1],
         wire=str(big["blk"].dtype), ops=big["ops"],
         B=big["starts"].numel(), pad=big["pad"],
         cells=int(big["lens"].long().clamp(0, big["pad"]).sum()),
         long_windows=case["long"].n, chunks=case["long"].chunks, **row)
    return row


def ysb_deterministic():
    """kf-gpu and wmr-gpu over 16M deterministic events, every window's
    (count, lastUpdate, revenue) against the bincount oracle, and a
    1M-event prefix row for row against the port's host kf; every
    ring_append_eval call of the runs against its plain version and its
    twin, timed at the largest; returns each variant's kernel
    launches."""
    from windflow_tpu_torch.ops.resident import ResidentWindowExecutor
    prefix = ysb_batches(YSB_PREFIX)
    _, host = run_ysb("kf", prefix, full_rows=True)
    for variant in ("kf-gpu", "wmr-gpu"):
        _, dev = run_ysb(variant, prefix, full_rows=True)
        if dev != host or not host:
            raise AssertionError(f"ysb {variant}: the 1M-event prefix "
                                 "differs from the host kf")
    emit("ysb_prefix_vs_host_kf", events=YSB_PREFIX,
         windows=sum(len(v) for v in host.values()), identical=True)

    batches = ysb_batches(YSB_EVENTS)
    want = ysb_oracle(YSB_EVENTS)
    out = {}
    for variant in ("kf-gpu", "wmr-gpu"):
        with kernel_launches() as counts, \
                recorded_append_evals() as calls, \
                counted_launches(ResidentWindowExecutor) as dispatches:
            dt, got = run_ysb(variant, batches)
        if got != want:
            bad = [c for c in want if got.get(c) != want[c]]
            raise AssertionError(
                f"ysb {variant}: campaigns {bad[:5]} differ from the oracle "
                f"(first: {got.get(bad[0])} != {want[bad[0]]})")
        # the revenue ring: one ring_append_eval a dispatch (TB windows
        # are irregular), never the ring_append + windowed_reduce pair
        require_launches(f"ysb {variant}", counts, ("ring_append_eval",))
        if (counts["ring_append_eval"] != dispatches["calls"]
                or counts["ring_append"] or counts["windowed_reduce"]):
            raise AssertionError(f"ysb {variant}: launches {counts}, "
                                 f"dispatches {dispatches}")
        out[variant] = counts
        emit("ysb_deterministic", variant=variant,
             workload="YSB 100 campaigns x 10 ads, TB tumbling 10 s, "
             "COUNT + MAX(ts) + SUM(revenue), pardegree2 4",
             events=YSB_EVENTS, seconds=dt, events_per_s=YSB_EVENTS / dt,
             windows=sum(len(v) for v in got.values()),
             kept_events=sum(r[0] for v in got.values() for r in v),
             oracle_match=True, launches=counts, dispatches=dispatches)
        ysb_append_eval_phase(calls, variant)
    return out


def ysb_timed(length=YSB_TIMED_SEC, around=contextlib.nullcontext,
              timing=None):
    """apps.ysb.run for kf-gpu and wmr-gpu, `length` seconds of full-speed
    generation each, after a warm-up (ysb.warmup) outside the counts; the
    timed run alone is counted and runs inside `around()` (a context
    manager whose yielded dict, if any, is added to the phase line); one
    ring_append_eval a dispatch, and every call of it checked against its
    plain version and its twin, timed at the largest call (the row goes
    into `timing`, a dict, under the variant).  At YSB_TIMED_SEC every
    campaign has one window, which closes at the end of the stream.
    Returns each variant's launches."""
    from windflow_tpu_torch.ops.resident import ResidentWindowExecutor
    from windflow_tpu_torch.apps import ysb
    out = {}
    for variant in ("kf-gpu", "wmr-gpu"):
        ysb.warmup(variant, 1, YSB_PARDEGREE2, YSB_WIN_SEC, YSB_CHUNK,
                   device=DEVICE)
        with around() as extra, kernel_launches() as counts, \
                recorded_append_evals() as calls, \
                counted_launches(ResidentWindowExecutor) as dispatches:
            m = ysb.run(variant, length, pardegree2=YSB_PARDEGREE2,
                        win_sec=YSB_WIN_SEC, chunk=YSB_CHUNK, warm=False,
                        device=DEVICE)
        if not (m["generated"] > 0 and m["results"] > 0):
            raise AssertionError(f"ysb {variant} timed run: {m}")
        require_launches(f"ysb timed {variant}", counts,
                         ("ring_append_eval",))
        if (counts["ring_append_eval"] != dispatches["calls"]
                or counts["ring_append"] or counts["windowed_reduce"]):
            raise AssertionError(f"ysb timed {variant}: launches {counts}, "
                                 f"dispatches {dispatches}")
        out[variant] = counts
        emit("ysb_timed", variant=variant, length_sec=length,
             windows_per_campaign=math.ceil(length / YSB_WIN_SEC),
             launches=counts, executor_launches=dispatches, **m,
             **(extra or {}))
        row = ysb_append_eval_phase(calls, f"{variant} timed")
        if timing is not None:
            timing[variant] = row
    return out


def pipe_test(around=contextlib.nullcontext):
    """apps.pipe at its defaults (8M tuples): a warm-up run outside the
    counts, then one timed run, counted and inside `around()` (as in
    ysb_timed), whose total and window count must equal expected(); every
    ring_append_regular_sum call of it is checked against its plain
    version.  Returns its launches."""
    from windflow_tpu_torch.apps import pipe
    kw = {k: p.default for k, p in inspect.signature(pipe.run).parameters
          .items() if k in ("pardegree", "flush_rows", "depth", "capacity",
                            "chunk")}
    chunks = pipe.make_values(PIPE_TUPLES, kw.pop("chunk"))
    want = pipe.expected(chunks)
    pipe.run_once(chunks, **kw, device=DEVICE)        # the warm-up
    with around() as extra, kernel_launches() as counts, \
            recorded_fused() as fused:
        dt, state, diag = pipe.run_once(chunks, **kw, device=DEVICE)
    if (state["total"], state["rcv"]) != want:
        raise AssertionError(f"pipe_test: total and windows "
                             f"{(state['total'], state['rcv'])} != {want}")
    # a regular flush is one fused ring_append_regular_sum launch
    require_launches("pipe_test", counts, ("ring_append_regular_sum",))
    n, err = check_fused(fused, "pipe_test")
    emit("pipe_test", tuples=PIPE_TUPLES, seconds=dt,
         tuples_per_s=PIPE_TUPLES / dt, total=state["total"],
         windows=state["rcv"], expected=want, launches=counts,
         fused_calls_checked=n, fused_max_abs_err=err,
         **pipe.latency_stats(state), **diag, **(extra or {}))
    return counts


def two_stage():
    """The 9 device compositions of the sum_test_gpu test_all mirror on
    the card at sum_test's shape (CB 256/64, 64 keys, 1M tuples), each
    total equal to the host WinSeq's, every ring_append and
    ring_append_regular_sum call against its plain version; returns the
    launches summed."""
    import windflow_tpu_torch as wt
    schema = wt.Schema(value=np.int64)
    batches = make_stream(schema, TWO_STAGE_TUPLES)
    _, want_n, want, _ = run_pipeline(
        wt.WinSeq(wt.Reducer("sum"), WIN, SLIDE, wt.WinType.CB), batches,
        schema)
    s = lambda: wt.Reducer("sum")
    cb = wt.WinType.CB
    dev = dict(device=DEVICE, batch_len=BATCH_LEN, flush_rows=FLUSH_ROWS)
    comps = {
        "seq": lambda: wt.WinSeqGPU(s(), WIN, SLIDE, cb, **dev),
        "wf": lambda: wt.WinFarmGPU(s(), WIN, SLIDE, cb, pardegree=2, **dev),
        "kf": lambda: wt.KeyFarmGPU(s(), WIN, SLIDE, cb, pardegree=2, **dev),
        "pf_plq": lambda: wt.PaneFarmGPU(s(), s(), WIN, SLIDE, cb,
                                         plq_degree=2, wlq_degree=2,
                                         wlq_on_device=False, **dev),
        "pf_wlq": lambda: wt.PaneFarmGPU(s(), s(), WIN, SLIDE, cb,
                                         plq_degree=2, wlq_degree=2,
                                         plq_on_device=False, **dev),
        "wmr_map": lambda: wt.WinMapReduceGPU(s(), s(), WIN, SLIDE, cb,
                                              map_degree=2, **dev),
        "wmr_red": lambda: wt.WinMapReduceGPU(s(), s(), WIN, SLIDE, cb,
                                              map_degree=2,
                                              map_on_device=False,
                                              reduce_on_device=True, **dev),
        "kf+pf": lambda: wt.KeyFarmOf(wt.PaneFarmGPU(
            s(), s(), WIN, SLIDE, cb, plq_degree=2, wlq_degree=2,
            wlq_on_device=False, **dev), pardegree=2),
        "wf+wmr": lambda: wt.WinFarmOf(wt.WinMapReduceGPU(
            s(), s(), WIN, SLIDE, cb, map_degree=2, reduce_on_device=False,
            **dev), pardegree=2),
    }
    total_counts = dict.fromkeys(kernel_wrappers(), 0)
    for name, make in comps.items():
        with kernel_launches() as counts, recorded_fused() as fused, \
                recorded_append_evals() as evals:
            dt, n, total, _ = run_pipeline(make(), batches, schema)
        if total != want:
            raise AssertionError(f"two_stage {name}: total {total} != the "
                                 f"host WinSeq's {want}")
        require_launches(f"two_stage {name}", counts, tuple(counts),
                         every=False)
        for k, v in counts.items():
            total_counts[k] += v
        n_fused, err = check_fused(fused, f"two_stage {name}")
        n_evals, eval_err = check_append_evals(evals, f"two_stage {name}")
        emit("two_stage", composition=name, tuples=TWO_STAGE_TUPLES,
             seconds=dt, tuples_per_s=TWO_STAGE_TUPLES / dt, windows=n,
             host_windows=want_n, total=total, host_total=want,
             launches=counts, fused_calls_checked=n_fused, fused_max_abs_err=err,
             append_eval_calls_checked=n_evals,
             append_eval_max_abs_err=eval_err)
    return total_counts


# the layered sum_test (phase 18): sum_test's stream through a KeyFarmGPU
# rescaled 2 -> 4 -> 2 under check=, trace=, recovery= and control=; one
# epoch a source batch (16), 1 source batch in 4 traced (0.05 would trace
# one of the 16, whose worker services may launch nothing)
LAYERS_PARDEGREE = 2
LAYERS_MAX_WORKERS = 4
LAYERS_EPOCH_BATCHES = 1
LAYERS_SAMPLE_RATE = 0.25
LAYERS_CAPACITY = 4


@contextlib.contextmanager
def calls_by_thread():
    """Counts the resident executors' kernel calls by the thread that made
    them: on exit the yielded dict maps each kernel to {thread name:
    calls}.  Under recovery= a native core launches in its worker's node
    thread, named "<dataflow>/<node>"."""
    names = {"ring_append_regular_sum": "ring_append_regular_sum",
             "ring_append_eval": "ring_append_eval",
             "ring_append_multi_eval": "ring_append_multi_eval"}
    counts = {}
    with contextlib.ExitStack() as stack:
        seen = {kernel: stack.enter_context(recorded(
            name, lambda *a, **k: threading.current_thread().name))
            for name, kernel in names.items()}
        yield counts
    counts.update({k: dict(collections.Counter(v)) for k, v in seen.items()})


def layered_pipe(wt, schema, batches, trace_dir, asked):
    """The layered sum_test pipe.  ``asked`` holds three events: its
    source waits for the first (the 2 -> 4 request) before its second
    batch, sets the second on reaching the middle batch, and waits for the
    third (the 4 -> 2 request) before the batch after it: the first
    rescale seals with all but a batch or two of the stream to go, the
    second with half of it, and each finds a barrier to seal at."""
    from windflow_tpu_torch.control import ControlPolicy, Rescale
    from windflow_tpu_torch.obs.trace import TracePolicy
    mid = len(batches) // 2

    def gated(_replica):
        for i, b in enumerate(batches):
            if i == mid:
                asked[1].set()
            gate = {1: asked[0], mid + 1: asked[2]}.get(i)
            if gate is not None and not gate.wait(300):
                raise AssertionError(f"layers: no rescale request before "
                                     f"source batch {i}")
            yield b

    rows = []

    def consume(r):
        if r is not None and len(r):
            rows.append(r.copy())

    pipe = wt.MultiPipe(
        "layers", capacity=LAYERS_CAPACITY, metrics=True, check="error",
        trace=TracePolicy(sample_rate=LAYERS_SAMPLE_RATE),
        trace_dir=trace_dir,
        recovery=wt.RecoveryPolicy(epoch_batches=LAYERS_EPOCH_BATCHES),
        control=ControlPolicy([Rescale(
            "kf", max_workers=LAYERS_MAX_WORKERS, min_workers=1,
            up_depth=10 ** 9, down_depth=-1, cooldown=10 ** 9)]))
    pipe.add_source(wt.Source(batches=gated, schema=schema, name="src"))
    pipe.add(layers_farm(wt))
    pipe.add_sink(wt.Sink(consume, vectorized=True, name="sink"))
    return pipe, rows


def layers_farm(wt, **kw):
    return wt.KeyFarmGPU(wt.Reducer("sum", value_range=(0, 100)), WIN,
                         SLIDE, wt.WinType.CB, pardegree=LAYERS_PARDEGREE,
                         batch_len=BATCH_LEN, flush_rows=FLUSH_ROWS,
                         depth=DEPTH, name="kf", device=DEVICE, **kw)


def read_trace(trace_dir):
    """scripts/wf_trace.py's --json summary of trace_dir (in a
    subprocess), and the records of its trace.jsonl."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "scripts", "wf_trace.py")
    out = subprocess.run([sys.executable, script, trace_dir, "--json"],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    with open(os.path.join(trace_dir, "trace.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return json.loads(out.stdout), records


def check_layers_trace(summary, records):
    """Hop spans of the source, the kf workers and the sink; a dispatch
    launch span under a kf worker's hop; one rescale ctrl span a seal.
    Returns the epochs the checkpoint spans name."""
    def stage(node):                    # "layers_03_kf.1" -> "kf.1"
        return node.split("_", 2)[2]
    hops = {stage(s["node"]) for s in summary["stages"]}
    workers = {h for h in hops if h.startswith("kf.") and h[3:].isdigit()}
    if not ({"src.0", "sink.0"} <= hops and workers):
        raise AssertionError(f"layers trace: hops of {sorted(hops)}")
    spans = {r["span"]: r for r in records}
    under_kf = [r for r in records if r["kind"] == "launch"
                and r["phase"] == "dispatch"
                and stage(spans.get(r["parent"], {}).get("node", "x_x_x"))
                in workers]
    if not under_kf:
        raise AssertionError("layers trace: no dispatch launch span under "
                             f"a kf worker hop ({summary['launch_phases']})")
    ctrl = summary.get("ctrl", {})
    if ctrl.get("rescale", {}).get("n") != 2:
        raise AssertionError(f"layers trace: ctrl spans {ctrl}")
    epochs = sorted({r["epoch"] for r in records if r["kind"] == "ctrl"
                     and r["name"] == "checkpoint"})
    return sorted(workers), len(under_kf), epochs


def layers(around=contextlib.nullcontext):
    """sum_test's 16M tuples through KeyFarmGPU(sum, pardegree 2) under
    MultiPipe(check="error", trace=, recovery=, control=), rescaled 2 -> 4
    -> 2 by the controller mid-stream, against the same stream through a
    fixed-width KeyFarmGPU with no layers (per key in order, and the
    total against the oracle); the four workers' native cores with the
    state ABI on the card, the fused kernel launched on each of them, every
    ring kernel call of the run against its plain version, the trace read
    back by scripts/wf_trace.py, the controller's width gauge, the profile
    recorder uninstalled after; then a max_delay_ms KeyFarmGPU under
    recovery= and check="error" raising CheckError (WF202) before any
    thread.  The layered run is counted and runs inside `around()` (as in
    ysb_timed).  Returns its launches."""
    import windflow_tpu_torch as wt
    from windflow_tpu_torch.check import CheckError, CheckWarning
    from windflow_tpu_torch.native import enabled
    from windflow_tpu_torch.obs import trace as tr
    from windflow_tpu_torch.patterns.native_core import NativeResidentCore
    from windflow_tpu_torch.utils import profile

    lib = enabled()
    if lib is None or not getattr(lib, "wf_has_state_abi", False):
        raise AssertionError("layers: the native library lacks the state "
                             "ABI (keyed migration)")
    schema = wt.Schema(value=np.int64)
    batches = make_stream(schema, N_TUPLES)
    want = expected_total(batches)
    dt0, n0, total0, fixed_rows = run_pipeline(layers_farm(wt), batches,
                                               schema, keep=True)
    if total0 != want:
        raise AssertionError(f"layers fixed width: total {total0} != "
                             f"oracle {want}")

    trace_dir = tempfile.mkdtemp(prefix="wf_layers_")
    try:
        asked = (threading.Event(), threading.Event(), threading.Event())
        pipe, rows = layered_pipe(wt, schema, batches, trace_dir, asked)
        df = pipe._build()
        workers = [n for n in df.nodes if n.name.startswith("kf.")
                   and n.name[3:].isdigit()]
        if not (len(workers) == LAYERS_MAX_WORKERS and all(
                isinstance(w.core, NativeResidentCore)
                and w.core.has_state_abi and w.core.keyed_migratable
                and {str(e.device) for e in w.core.executors} == {DEVICE}
                for w in workers)):
            raise AssertionError(f"layers: workers {workers}")
        with around() as extra, kernel_launches() as counts, \
                calls_by_thread() as threads, recorded_fused() as fused, \
                recorded_append_evals() as evals, \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            pipe.run()
            ctl = pipe.controller
            for i, width in enumerate((LAYERS_MAX_WORKERS, LAYERS_PARDEGREE)):
                if i and not asked[1].wait(300):
                    raise AssertionError("layers: the source never reached "
                                         "the middle of the stream")
                if not ctl.request_rescale("kf", width):
                    raise AssertionError(f"layers: rescale to {width} "
                                         "refused")
                asked[2 * i].set()
                t_ask = time.monotonic()
                while ctl.width_of("kf") != width:
                    if time.monotonic() - t_ask > 300:
                        raise AssertionError(f"layers: rescale to {width} "
                                             "did not land")
                    time.sleep(0.005)
            pipe.wait(timeout=600)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        history = [h for fc in ctl.farms for h in fc.history]
        if [h[:2] for h in history] != [(2, 4), (4, 2)]:
            raise AssertionError(f"layers: rescale history {history}")
        total = int(sum(int(r["value"].sum()) for r in rows))
        if total != want or by_key(rows) != by_key(fixed_rows):
            raise AssertionError(f"layers: total {total} (oracle {want}) "
                                 "or the per-key results differ from the "
                                 "fixed-width run")
        gauge = pipe.metrics.snapshot()["gauges"].get("ctl_width_kf")
        if gauge != LAYERS_PARDEGREE:
            raise AssertionError(f"layers: ctl_width_kf ends at {gauge}")
        names = [f"layers/{w.name}" for w in workers]
        fused_by = threads["ring_append_regular_sum"]
        if not all(fused_by.get(n, 0) > 0 for n in names):
            raise AssertionError(f"layers: fused launches by worker "
                                 f"{fused_by}")
        n_fused, fused_err = check_fused(fused, "layers")
        n_evals, eval_err = check_append_evals(evals, "layers")
        summary, records = read_trace(trace_dir)
        traced_workers, dispatch_spans, epochs = check_layers_trace(
            summary, records)
        if tr._RECORDER_REFS != 0 or profile._RECORDER is not None:
            raise AssertionError("layers: the profile recorder is still "
                                 "installed after the traced run closed")
        emit("layers_launches", launches=counts, by_worker=threads)
        emit("layers", workload="sum_test CB win=256 slide=64 keys=64 "
             "KeyFarmGPU 2->4->2 check+trace+recovery+control",
             tuples=N_TUPLES, seconds=dt, tuples_per_s=N_TUPLES / dt,
             fixed_width_seconds=dt0, fixed_width_tuples_per_s=N_TUPLES / dt0,
             windows=sum(len(r) for r in rows), fixed_width_windows=n0,
             total=total, oracle=want, per_key_identical=True,
             rescales=[list(h) for h in history], ctl_width_kf=gauge,
             epochs_sealed=len(epochs), spans=pipe._df.tracer.spans,
             spans_written=pipe._df.tracer.written,
             spans_dropped=pipe._df.tracer.dropped,
             traced_workers=traced_workers,
             dispatch_spans_under_kf=dispatch_spans,
             trace_summary={k: summary[k] for k in (
                 "n_spans", "n_traces", "launch_phases", "ctrl")},
             check_warnings=sorted({str(w.message).split()[0]
                                    for w in caught
                                    if issubclass(w.category, CheckWarning)}),
             fused_calls_checked=n_fused, fused_max_abs_err=fused_err,
             append_eval_calls_checked=n_evals,
             append_eval_max_abs_err=eval_err,
             recorder_uninstalled=True, nvidia_smi=nvidia_smi_line(),
             **(extra or {}))
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)

    bad = wt.MultiPipe("layers_wf202", check="error",
                       recovery=wt.RecoveryPolicy(epoch_batches=1))
    bad.add_source(wt.Source(batches=batches[:1], schema=schema,
                             name="src"))
    bad.add(layers_farm(wt, max_delay_ms=5.0))
    bad.add_sink(wt.Sink(lambda r: None, vectorized=True, name="sink"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the WF204 sink warning
        try:
            bad.run()
        except CheckError as e:
            err, report = str(e), e.report
        else:
            raise AssertionError("layers_wf202: run() raised no CheckError")
    if "WF202" not in err or bad._df._threads or bad._df._sampler:
        raise AssertionError(f"layers_wf202: {err!r}, threads "
                             f"{bad._df._threads}")
    emit("layers_wf202", raised="CheckError", codes=sorted(
        {d.code for d in report.diagnostics}), threads_started=0)
    return counts


# the mesh phase (19): the single-process device mesh on one card, its
# device repeated: kf = 4 shards for the resident executors, a (kf, wf,
# sp) = (2, 2, 2) mesh for MeshStreamStep at pipe_test's chain
MESH_KF = 4
MESH_STEP_SHAPE = (2, 2, 2)            # (n_kf, n_wf, n_sp)
MESH_STEP_ROWS = 1 << 24               # a group's rows: (2, 2^24) int32
MESH_LONG_WINDOWS = 1024               # windows across the sp boundary
MESH_PAST_N = 8                        # windows that run past N
MESH_STEP_RUNS = (("sum", "int32"), ("count", "int32"), ("min", "int32"),
                  ("max", "int32"), ("prod", "int32"), ("mean", "int32"),
                  ("sum", "float32"), ("mean", "float32"))


def _stream_of(first, *_args, **_kw):
    """The current CUDA stream of a kernel call whose first argument is
    the ring (or, for windowed_reduce_many, its evaluations; for
    ring_append_multi_eval, its rings)."""
    t = first
    while not isinstance(t, torch.Tensor):
        t = t[0]
    return torch.cuda.current_stream(t.device).cuda_stream


def per_shard(streams, executors):
    """Launches per mesh shard: the recorded calls' streams mapped to the
    shard whose stream each is (a list, shard order)."""
    shard_of = {st.cuda_stream: s for ex in executors
                for s, st in enumerate(ex._streams)}
    counts = [0] * MESH_KF
    for st in streams:
        counts[shard_of[st]] += 1
    return counts


def mesh_stage(wt, mesh, reducer):
    return wt.WinSeqGPU(reducer, WIN, SLIDE, wt.WinType.CB,
                        batch_len=BATCH_LEN, flush_rows=FLUSH_ROWS,
                        depth=DEPTH, shards=1, mesh=mesh)


def mesh_core_of(cores, cls, name):
    """The one native core of a mesh run, with its mesh executors."""
    from windflow_tpu_torch.patterns.native_core import NativeResidentCore
    if not (len(cores) == 1 and isinstance(cores[0], NativeResidentCore)
            and cores[0]._delegate is None
            and all(isinstance(ex, cls) for ex in cores[0].executors)):
        raise AssertionError(f"{name}: the stage's core is {cores}")
    return cores[0]


def mesh_resident(mesh):
    """(a) sum_test 16M on the kf mesh (the fused kernel on every shard a
    regular flush), (b) a 1M-tuple Reducer("max") prefix (irregular
    launches), (c) the two-field MultiReducer 4M (per-field rings); each
    against the un-meshed resident route per key in order (and (a)'s
    total against the oracle), every ring kernel call against its plain
    version.  Returns {run: launches}."""
    import windflow_tpu_torch as wt
    from windflow_tpu_torch.ops import resident
    from windflow_tpu_torch.ops.resident import (
        MeshMultiFieldResidentExecutor, MeshResidentExecutor)
    schema = wt.Schema(value=np.int64)
    sum_r = lambda: wt.Reducer("sum", value_range=(0, 100))    # noqa: E731
    max_r = lambda: wt.Reducer("max", value_range=(0, 100))    # noqa: E731
    launches = {}

    # (a) a 1M-tuple prefix (the warm-up) per key against the un-meshed
    # resident route, then the 16M run counted
    prefix = make_stream(schema, PREFIX_TUPLES)
    _, n_mesh, _, rows = run_pipeline(mesh_stage(wt, mesh, sum_r()), prefix,
                                      schema, True)
    _, n_flat, _, flat = run_pipeline(resident_stage(wt), prefix, schema,
                                      True)
    if n_mesh != n_flat or by_key(rows) != by_key(flat):
        raise AssertionError("mesh sum_test prefix differs from the "
                             "un-meshed resident route")
    emit("mesh_prefix_vs_resident", tuples=PREFIX_TUPLES, windows=n_mesh,
         identical=True)
    batches = make_stream(schema, N_TUPLES)
    want = expected_total(batches)
    cores = []
    stage = stage_with_core(lambda: mesh_stage(wt, mesh, sum_r()), cores)
    resident.stats_snapshot(reset=True)
    with kernel_launches() as counts, recorded_fused() as fused, \
            recorded("ring_append_regular_sum", _stream_of) as fstreams, \
            recorded_append_evals() as evals, \
            recorded("ring_append_eval", _stream_of) as estreams:
        dt, n_windows, total, _ = run_pipeline(stage, batches, schema)
    stats = resident.stats_snapshot(reset=True)
    core = mesh_core_of(cores, MeshResidentExecutor, "mesh sum_test")
    if total != want:
        raise AssertionError(f"mesh sum_test total {total} != oracle {want}")
    shards = {"ring_append_regular_sum": per_shard(fstreams, core.executors),
              "ring_append_eval": per_shard(estreams, core.executors)}
    # a dispatch launches on every shard: the fused kernel for a regular
    # flush, one ring_append_eval for an irregular one (the append, and
    # the shard's windows where it has some), never the old pair
    if not (min(shards["ring_append_regular_sum"]) > 0
            and len(set(shards["ring_append_regular_sum"])) == 1
            and len(set(shards["ring_append_eval"])) == 1
            and counts["ring_append"] == counts["windowed_reduce"] == 0
            and stats["dispatches"] * MESH_KF
            == counts["ring_append_regular_sum"]
            + counts["ring_append_eval"]):
        raise AssertionError(f"mesh sum_test: launches {counts}, per shard "
                             f"{shards}, dispatches {stats['dispatches']}")
    n_fused, err = check_fused(fused, "mesh sum_test")
    emit("mesh_sum_test", workload="sum_test CB win=256 slide=64 keys=64 "
         f"resident, kf mesh of {MESH_KF} x {DEVICE}", tuples=N_TUPLES,
         seconds=dt, tuples_per_s=N_TUPLES / dt, windows=n_windows,
         total=total, oracle=want, launches=counts,
         launches_per_shard=shards, dispatches=stats["dispatches"],
         fused_calls_checked=n_fused, fused_max_abs_err=err,
         append_eval_calls=check_append_evals(evals, "mesh sum_test"))
    launches["sum_test"] = counts

    # (b) irregular launches: Reducer("max"), a 1M-tuple prefix
    cores = []
    stage = stage_with_core(lambda: mesh_stage(wt, mesh, max_r()), cores)
    with kernel_launches() as counts, recorded_append_evals() as evals, \
            recorded("ring_append_eval", _stream_of) as estreams:
        _, n_mesh, _, rows = run_pipeline(stage, prefix, schema, True)
    core = mesh_core_of(cores, MeshResidentExecutor, "mesh max")
    _, n_flat, _, flat = run_pipeline(resident_stage(wt, max_r()), prefix,
                                      schema, True)
    if n_mesh != n_flat or by_key(rows) != by_key(flat):
        raise AssertionError("mesh max prefix differs from the un-meshed "
                             "resident route")
    require_launches("mesh max", counts, ("ring_append_eval",))
    # one ring_append_eval a dispatch on every shard, never the old pair
    shards = {"ring_append_eval": per_shard(estreams, core.executors)}
    if not (len(set(shards["ring_append_eval"])) == 1
            and counts["ring_append"] == counts["windowed_reduce"] == 0):
        raise AssertionError(f"mesh max: launches {counts}, per shard "
                             f"{shards}")
    emit("mesh_irregular", op="max", tuples=PREFIX_TUPLES, windows=n_mesh,
         identical=True, launches=counts, launches_per_shard=shards,
         append_eval_calls=check_append_evals(evals, "mesh max"))
    launches["irregular_max"] = counts

    # (c) the two-field MultiReducer: the native _multi branch over
    # MeshMultiFieldResidentExecutor
    mschema, mbatches = multi_stream(wt)
    cores = []
    stage = stage_with_core(lambda: mesh_stage(wt, mesh, multi_agg(wt)),
                            cores)
    with kernel_launches() as counts, recorded_multi_evals() as calls, \
            recorded("ring_append_multi_eval", _stream_of) as mstreams, \
            counted_launches(MeshMultiFieldResidentExecutor) as dispatches:
        dt, rows = run_rows(stage, mbatches, mschema)
    core = mesh_core_of(cores, MeshMultiFieldResidentExecutor, "mesh multi")
    if not core._multi:
        raise AssertionError("mesh multi: not the native _multi branch")
    _, flat = run_rows(wt.WinSeqGPU(
        multi_agg(wt), WIN, SLIDE, wt.WinType.CB, batch_len=BATCH_LEN,
        flush_rows=FLUSH_ROWS, depth=DEPTH, device=DEVICE), mbatches, mschema)
    if by_key([rows]) != by_key([flat]):
        raise AssertionError("mesh multi differs from the un-meshed "
                             "resident route")
    require_launches("mesh multi", counts, ("ring_append_multi_eval",))
    # one fused launch a shard a dispatch (every field's append and the
    # shard's stats), never the old composition
    shards = {"ring_append_multi_eval": per_shard(mstreams, core.executors)}
    if not (set(shards["ring_append_multi_eval"]) == {dispatches["calls"]}
            and counts["ring_append"] == counts["windowed_reduce"]
            == counts["window_gather"] == 0):
        raise AssertionError(f"mesh multi: launches {counts}, per shard "
                             f"{shards}, dispatches {dispatches}")
    emit("mesh_multi_field", workload="MultiReducer(sum(a), max(b), count) "
         "CB win=256 slide=64 keys=64", tuples=MULTI_TUPLES, seconds=dt,
         tuples_per_s=MULTI_TUPLES / dt, windows=len(rows), identical=True,
         launches=counts, launches_per_shard=shards, dispatches=dispatches,
         multi_eval=multi_eval_row(calls, "mesh multi"))
    launches["multi_field"] = counts
    return launches


def mesh_step_inputs(seed=21):
    """(flat, starts, lens) of the stream step: (2, 2^24) int32 rows in
    [-1000, 1000); per group pipe_test's CB 256/64 windows (262,144), then
    MESH_LONG_WINDOWS windows of N/1024 to N/128 rows (16k-128k) across
    the sp boundary and
    MESH_PAST_N windows that run past N."""
    rng = np.random.default_rng(seed)
    kf, N = MESH_STEP_SHAPE[0], MESH_STEP_ROWS
    half = N // MESH_STEP_SHAPE[2]
    flat = rng.integers(-1000, 1000, size=(kf, N)).astype(np.int32)
    starts, lens = [], []
    for _ in range(kf):
        cb = np.arange(N // SLIDE) * SLIDE
        long_lens = rng.integers(N >> 10, N >> 7, MESH_LONG_WINDOWS)
        long_starts = half - rng.integers(1, long_lens)
        past = N - rng.integers(1, 200, MESH_PAST_N)
        starts.append(np.concatenate([cb, long_starts, past]))
        lens.append(np.concatenate([np.full(len(cb), WIN), long_lens,
                                    rng.integers(300, 5000, MESH_PAST_N)]))
    return (flat, np.stack(starts).astype(np.int32),
            np.stack(lens).astype(np.int32))


def _wrap32(x):
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int64)


def mesh_step_groups(flat, starts, lens, rows):
    """Per group, what the oracle reads: the rows padded with zeros to
    `rows` (Ns * n_sp), mapped (3v+1) and filtered (v % 5 != 0), the
    windows clipped to them, and prefix sums of the kept values, their
    absolute values and the kept count."""
    groups = []
    for g in range(starts.shape[0]):
        v = np.zeros(rows, dtype=np.int64)
        v[:flat.shape[1]] = flat[g]
        v = 3 * v + 1
        kept = v % 5 != 0
        s = np.clip(starts[g].astype(np.int64), 0, rows)
        e = np.clip(starts[g].astype(np.int64) + lens[g], 0, rows)
        groups.append(dict(
            v=v, kept=kept, s=s, e=e,
            csv=np.concatenate([[0], np.cumsum(np.where(kept, v, 0))]),
            csa=np.concatenate([[0], np.cumsum(np.where(kept, np.abs(v),
                                                        0))]),
            csc=np.concatenate([[0], np.cumsum(kept)])))
    return groups


def mesh_step_oracle(groups, op, dtype):
    """numpy, over mesh_step_groups: sums exact (the int32 ones wrapped by
    the caller), an int32 mean the float32 quotient of the wrapped sum,
    int32 products wrapped.  Also returns the float tolerance's scale: the
    sum of |x| over each window's kept rows (over its count for a mean).
    A CB window (SLIDE-aligned, WIN long) folds its WIN / SLIDE blocks of
    SLIDE rows; any other window is folded alone."""
    ident = {"min": np.iinfo(np.int32).max, "max": np.iinfo(np.int32).min,
             "prod": 1}
    outs, scales = [], []
    for gr in groups:
        s, e, kept, v = gr["s"], gr["e"], gr["kept"], gr["v"]
        cnt = gr["csc"][e] - gr["csc"][s]
        scales.append((gr["csa"][e] - gr["csa"][s])
                      / (np.maximum(cnt, 1) if op == "mean" else 1))
        tot = gr["csv"][e] - gr["csv"][s]
        if op == "count":
            outs.append(cnt.astype(np.float64))
        elif op == "sum" or (op == "mean" and dtype == "float32"):
            outs.append(tot.astype(np.float64) if op == "sum"
                        else tot / np.maximum(cnt, 1))
        elif op == "mean":
            outs.append((_wrap32(tot).astype(np.float32)
                         / np.maximum(cnt, 1).astype(np.float32))
                        .astype(np.float64))
        else:
            ufunc = {"min": np.minimum, "max": np.maximum,
                     "prod": np.multiply}[op]
            masked = np.where(kept, v, ident[op])
            pad = -len(masked) % SLIDE
            blocks = ufunc.reduce(np.concatenate(
                [masked, np.full(pad, ident[op])]).reshape(-1, SLIDE),
                axis=1)
            res = np.full(len(s), ident[op], dtype=np.int64)
            full = (e - s == WIN) & (s % SLIDE == 0)
            first = s[full] // SLIDE
            acc = blocks[first]
            for k in range(1, WIN // SLIDE):
                acc = ufunc(acc, blocks[first + k])
            res[full] = acc
            for i in np.nonzero(~full & (e > s))[0]:
                res[i] = ufunc.reduce(masked[s[i]:e[i]])
            # an int64 product modulo 2^64 has the int32 product's low
            # bits: wrap it before the float64 result rounds it
            outs.append((_wrap32(res) if op == "prod" else res)
                        .astype(np.float64))
    return np.stack(outs), np.stack(scales)


def _check_step_result(got, want, scale, op, dtype, name):
    """The step's result against the oracle: int32 results (and int mean)
    exact; float32 sums and means within FLOAT_RTOL of the sum of |x| (over
    the count for a mean).  Returns the largest error."""
    if dtype == "int32" and op in ("sum", "prod"):
        want = _wrap32(want.astype(np.int64))
    err = np.abs(got.astype(np.float64) - want)
    if dtype == "int32":
        if err.max() > 0:
            bad = np.unravel_index(int(err.argmax()), err.shape)
            raise AssertionError(f"{name}: window {bad} gives {got[bad]}, "
                                 f"the oracle {want[bad]}")
        return 0.0
    if not bool((err <= FLOAT_RTOL * scale).all()):
        raise AssertionError(f"{name}: error {err.max()} beyond rtol "
                             f"{FLOAT_RTOL}")
    return float(err.max())


@contextlib.contextmanager
def checked_mesh_kernels():
    """While active, every sp_window_partial and sp_merge call of the mesh
    step is held against its plain version on the same inputs (ints,
    counts, min and max equal; float32 sums and means within FLOAT_RTOL of
    the sum of |x|) and, for float32 and for every merge, bit for bit
    against the CPU twin of its order run on the card; the yielded dict
    counts the checks, keeps the largest errors, counts partial launches
    per (kf, wf, sp) shard in the mesh's order and the launches each call
    made, and keeps the inputs of the largest partial and merge (for the
    timings: the partial with its long-window list, the merge as the step
    passed its partials, in place)."""
    from windflow_tpu_torch.ops import mesh_reduce as mr
    from windflow_tpu_torch.parallel import mesh as pm
    orig_p, orig_m = pm.sp_window_partial, pm.sp_merge
    n_shards = int(np.prod(MESH_STEP_SHAPE))
    seen = dict(partials=0, merges=0, partial_err=0.0, merge_err=0.0,
                twins=0, per_shard=[0] * n_shards, big_partial=None,
                long_partial=None, big_merge=None,
                partial_launches_per_call=collections.Counter(),
                merge_launches_per_call=collections.Counter(),
                long_windows=collections.Counter(),
                # the largest call (and the partial with the longest
                # windows) of each dtype other than int32 and float32
                # (phase 26's rows)
                partial_by_dtype={}, partial_long_by_dtype={},
                merge_by_dtype={})

    def same(a, b):
        return a.dtype == b.dtype and torch.equal(bits(a), bits(b))

    def partial(vals, keep, starts, lens, base, op, long_windows=None):
        before = mr.sp_window_partial.launches
        got = orig_p(vals, keep, starts, lens, base, op,
                     long_windows=long_windows)
        seen["partial_launches_per_call"][
            mr.sp_window_partial.launches - before] += 1
        seen["long_windows"][len(long_windows)] += 1
        seen["per_shard"][seen["partials"] % n_shards] += 1
        seen["partials"] += 1
        want = mr.sp_window_partial_reference(vals, keep, starts, lens,
                                              base, op)
        if (got[1] is None) != (want[1] is None) or (
                got[1] is not None and not torch.equal(got[1], want[1])):
            raise AssertionError(f"sp_window_partial {op}: counts differ")
        if not vals.is_floating_point() or op in ("count", "min", "max"):
            if not same(got[0], want[0]):
                raise AssertionError(f"sp_window_partial {op}/{vals.dtype}:"
                                     " the kernel differs from the plain "
                                     "version")
        else:
            twin = mr.partial_order_twin(vals, keep, starts, lens, base, op)
            seen["twins"] += 1
            if not same(got[0], twin[0]):
                raise AssertionError(f"sp_window_partial {op}/{vals.dtype}:"
                                     " the kernel differs from its twin")
            scale = mr.sp_window_partial_reference(
                vals.abs(), keep, starts, lens, base, "sum")[0].double()
            e = (got[0].double() - want[0].double()).abs()
            if op == "prod":      # the fold orders differ: relative
                scale = want[0].double().abs() * lens.double()
                e = torch.where(got[0] == want[0], 0.0, e)
            if not bool((e <= rtol_of(vals) * scale).all()):
                raise AssertionError(f"sp_window_partial {op}: error "
                                     f"{float(e.max())} beyond rtol")
            seen["partial_err"] = max(seen["partial_err"], float(e.max()))
        call = (vals, keep, starts, lens, base, op,
                torch.from_numpy(np.ascontiguousarray(
                    long_windows, dtype=np.int32)).to(vals.device))
        if (seen["big_partial"] is None or starts.numel()
                > seen["big_partial"][2].numel()):
            seen["big_partial"] = call
        if (seen["long_partial"] is None or int(lens.max())
                > int(seen["long_partial"][3].max())):
            seen["long_partial"] = call
        if vals.dtype not in (torch.int32, torch.float32):
            by = seen["partial_by_dtype"]
            if (vals.dtype not in by
                    or starts.numel() > by[vals.dtype][2].numel()):
                by[vals.dtype] = call
            by = seen["partial_long_by_dtype"]
            if (vals.dtype not in by
                    or int(lens.max()) > int(by[vals.dtype][3].max())):
                by[vals.dtype] = call
        return got

    def merge(partials, counts, op, ring=False, device=None, dtype=None):
        before = mr.sp_merge.launches
        got = orig_m(partials, counts, op, ring=ring, device=device,
                     dtype=dtype)
        seen["merge_launches_per_call"][mr.sp_merge.launches - before] += 1
        seen["merges"] += 1
        # stacked as integers of their width: the same words (torch has
        # few ops for uint32 and uint64)
        parts = torch.stack([bits(p.to(got.device))
                             for p in partials]).view(partials[0].dtype)
        cnts = (torch.stack([c.to(got.device) for c in counts])
                if counts is not None else None)
        twin = mr.merge_order_twin(parts, cnts, op, ring, dtype)
        want = mr.sp_merge_reference(parts, cnts, op, ring, dtype)
        if not same(got, twin):
            raise AssertionError(f"sp_merge {op}/{parts.dtype} ring={ring}: "
                                 "the kernel differs from its twin")
        if not parts.is_floating_point() or op in ("count", "min", "max"):
            if not same(got, want):
                raise AssertionError(f"sp_merge {op}/{parts.dtype}: the "
                                     "kernel differs from the plain version")
        else:
            e = (got.double() - want.double()).abs()
            scale = (parts.double().abs().sum(dim=0) if op != "mean" else
                     parts.double().abs().sum(dim=0)
                     / cnts.long().sum(dim=0).clamp(min=1))
            if op == "prod":      # the fold orders differ: relative
                scale = want.double().abs() * parts.shape[0]
                e = torch.where(got == want, 0.0, e)
            if not bool((e <= rtol_of(parts) * scale).all()):
                raise AssertionError(f"sp_merge {op}/{parts.dtype}: error "
                                     f"{float(e.max())} against the plain "
                                     "version")
            seen["merge_err"] = max(seen["merge_err"], float(e.max()))
        reduction = dtype or parts.dtype
        call = (list(partials), parts, list(counts) if counts is not None
                else None, cnts, op, ring, reduction)
        if (seen["big_merge"] is None
                or parts.shape[1] > seen["big_merge"][1].shape[1]):
            seen["big_merge"] = call
        if reduction not in (torch.int32, torch.float32):
            by = seen["merge_by_dtype"]
            if (reduction not in by
                    or parts.shape[1] > by[reduction][1].shape[1]):
                by[reduction] = call
        return got

    pm.sp_window_partial, pm.sp_merge = partial, merge
    try:
        yield seen
    finally:
        pm.sp_window_partial, pm.sp_merge = orig_p, orig_m


def mesh_step_rows(seen):
    """The kernels-line rows of sp_window_partial and sp_merge: each timed
    at the largest call of the step's run (the partial cold, its inputs
    cycled through three times the L2, and hot; the merge hot: it reads
    partials just written), beside its bound, its plain version and, for
    the merge, torch.sum over the partials (a graph replay, as the kernel
    is timed; and as a caller sees it).  The partial is also timed at the
    call with the longest windows (few windows of many cells, the block
    path beyond mr.SPLIT cells), the merge also over the stacked (n, B)
    tensor."""
    from windflow_tpu_torch.ops import mesh_reduce as mr
    timed = {}
    for case in ("big_partial", "long_partial"):
        vals, keep, starts, lens, base, op, longw = seen[case]
        Ns, B = vals.numel(), starts.numel()
        s = np.clip(starts.cpu().numpy().astype(np.int64) - base, 0, Ns)
        e = np.clip(starts.cpu().numpy().astype(np.int64)
                    + lens.cpu().numpy() - base, 0, Ns)
        cells = covered(s, np.maximum(e - s, 0))
        nbytes = (cells * (vals.element_size() + 1) + 8 * B
                  + (8 if mr.needs_count(op) else 4) * B)
        pb = bytes_bound(nbytes, int(np.maximum(e - s, 0).sum()))
        copies = cold_copies(vals.device, (vals, keep))
        cold = kernel_ms(cycled(copies, lambda v, k: mr.sp_window_partial(
            v, k, starts, lens, base, op, long_windows=longw)),
            reps=2 * len(copies))
        hot = kernel_ms(lambda: mr.sp_window_partial(
            vals, keep, starts, lens, base, op, long_windows=longw),
            reps=10)
        before = mr.sp_window_partial.launches
        mr.sp_window_partial(vals, keep, starts, lens, base, op,
                             long_windows=longw)
        per_call = mr.sp_window_partial.launches - before
        plain = call_ms(lambda: mr.sp_window_partial_reference(
            vals, keep, starts, lens, base, op), reps=2)
        emit("mesh_step_kernel", kernel="sp_window_partial", case=case,
             op=op, dtype=str(vals.dtype), Ns=Ns, B=B, base=base,
             cells=cells, window_cells=int(np.maximum(e - s, 0).sum()),
             split=mr.SPLIT, chunk=mr.CHUNK, long_windows=longw.numel(),
             launches_per_call=per_call, kernel_ms=cold, hot_l2_ms=hot,
             plain_ms=plain, bound_bytes=nbytes, bound_ms=pb[0],
             bound_by=pb[1])
        timed[case] = (cold, hot, plain, pb)
    cold, hot, plain, pb = timed["big_partial"]
    rows = {"sp_window_partial": dict(
        max_abs_err=seen["partial_err"], ms=cold, hot_ms=hot,
        plain_ms=plain, bound_ms=pb[0], bound_by=pb[1], library_ms=None,
        long_windows_ms=timed["long_partial"][0],
        long_windows_bound_ms=timed["long_partial"][3][0],
        split=mr.SPLIT, chunk=mr.CHUNK)}
    plist, parts, clist, cnts, op, ring, _dtype = seen["big_merge"]
    n, B = parts.shape
    nbytes = 4 * n * B + 4 * B + (4 * n * B if op == "mean" else 0)
    mb = bytes_bound(nbytes, (n - 1) * B)
    ms = kernel_ms(lambda: mr.sp_merge(plist, clist, op, ring=ring))
    stacked = kernel_ms(lambda: mr.sp_merge(parts, cnts, op, ring=ring))
    before = mr.sp_merge.launches
    mr.sp_merge(plist, clist, op, ring=ring)
    per_call = mr.sp_merge.launches - before
    plain = call_ms(lambda: mr.sp_merge_reference(parts, cnts, op, ring))
    lib = kernel_ms(lambda: torch.sum(parts, dim=0))
    lib_call = call_ms(lambda: torch.sum(parts, dim=0))
    emit("mesh_step_kernel", kernel="sp_merge", op=op,
         dtype=str(parts.dtype), ring=ring, n_sp=n, B=B, kernel_ms=ms,
         stacked_ms=stacked, launches_per_call=per_call, plain_ms=plain,
         library_ms=lib, library_call_ms=lib_call,
         library="torch.sum(parts, dim=0)", bound_bytes=nbytes,
         bound_ms=mb[0], bound_by=mb[1])
    rows["sp_merge"] = dict(max_abs_err=seen["merge_err"], ms=ms,
                            stacked_ms=stacked, plain_ms=plain,
                            bound_ms=mb[0], bound_by=mb[1], library_ms=lib,
                            library_call_ms=lib_call)
    return rows


def mesh_step():
    """(d) MeshStreamStep at pipe_test's chain (map 3v+1, filter v % 5 !=
    0) over a (2, 2, 2) mesh on one card: every op with both orders of the
    merge, int32 and float32, against the numpy oracle; every kernel call
    against its plain version (and twin).  Returns (launches, kernel
    rows)."""
    from windflow_tpu_torch.parallel import MeshStreamStep, make_mesh
    kf, wf, sp = MESH_STEP_SHAPE
    mesh = make_mesh(kf, sp, devices=[DEVICE] * (kf * wf * sp), n_wf=wf)
    flat, starts, lens = mesh_step_inputs()
    Ns = MESH_STEP_ROWS // sp
    t0 = time.perf_counter()
    with kernel_launches() as counts, checked_mesh_kernels() as seen:
        results = {}
        for op, dtype in MESH_STEP_RUNS:
            for collective in ("psum", "ring"):
                step = MeshStreamStep(
                    mesh, op=op, dtype=getattr(torch, dtype),
                    map_fn=lambda v: 3 * v + 1,
                    filter_fn=lambda v: v % 5 != 0, collective=collective)
                results[(op, dtype, collective)] = step(flat, starts, lens)
    dt = time.perf_counter() - t0
    errs = {}
    groups = mesh_step_groups(flat, starts, lens, Ns * sp)
    oracle = {}
    for (op, dtype, collective), got in results.items():
        if (op, dtype) not in oracle:
            oracle[op, dtype] = mesh_step_oracle(groups, op, dtype)
        want, scale = oracle[op, dtype]
        name = f"mesh_step {op}/{dtype}/{collective}"
        errs[f"{op}/{dtype}/{collective}"] = _check_step_result(
            got, want, scale, op, dtype, name)
    require_launches("mesh_step", counts, ("sp_window_partial", "sp_merge"))
    for name in ("partial_launches_per_call", "merge_launches_per_call"):
        if set(seen[name]) != {1}:
            raise AssertionError(f"mesh_step: {name} {dict(seen[name])}, "
                                 "wanted one launch a call")
    if not any(k > 0 for k in seen["long_windows"]):
        raise AssertionError("mesh_step: no call took the long-window path")
    rows = mesh_step_rows(seen)
    emit("mesh_step", workload="MeshStreamStep map 3v+1, filter v%5!=0, "
         f"(kf, wf, sp) = {MESH_STEP_SHAPE} x {DEVICE}",
         rows=list(flat.shape), windows=int(starts.shape[1]),
         runs=[f"{op}/{d}/{c}" for op, d in MESH_STEP_RUNS
               for c in ("psum", "ring")], seconds=dt,
         oracle_max_abs_err=errs, launches=counts,
         partial_launches_per_shard=seen["per_shard"],
         partial_launches_per_call=dict(seen["partial_launches_per_call"]),
         merge_launches_per_call=dict(seen["merge_launches_per_call"]),
         long_windows_per_call=dict(seen["long_windows"]),
         partial_calls_checked=seen["partials"],
         merge_calls_checked=seen["merges"], partial_twin_checks=seen["twins"])
    return counts, rows


def mesh_phase():
    """Phase 19: (a)-(c) on a kf mesh of MESH_KF shards, (d) the stream
    step; returns ({run: launches}, the two new kernels' rows)."""
    from windflow_tpu_torch.parallel import make_mesh
    mesh = make_mesh(n_kf=MESH_KF, devices=[DEVICE] * MESH_KF)
    t0 = time.perf_counter()
    launches = mesh_resident(mesh)
    launches["stream_step"], rows = mesh_step()
    emit("mesh_launches", seconds=time.perf_counter() - t0, **launches)
    return launches, rows


# the recover phase (20): sum_test through the native resident route
# under recovery=, its window node killed once mid-stream; then 1M-tuple
# prefixes of the other device cores, crashed the same way
RECOVER_EPOCH_BATCHES = 2            # a barrier every 2 source batches
RECOVER_KILL_AT = 9                  # the window node's 9th batch (of 16)
RECOVER_PREFIX_KILL_AT = 3           # of a prefix's 4 batches
RECOVER_PREFIX_CHUNK = 1 << 18       # 4 batches a 1M-tuple prefix


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def recovered_run(stage, batches, schema, kill_at=None, epoch_batches=None,
                  device=DEVICE, **policy):
    """Source -> stage -> Sink, under recovery= when ``epoch_batches`` is
    set; with ``kill_at`` the stage's node raises once on its kill_at-th
    batch (the transient-fault model: the replayed batch succeeds).
    Returns (seconds, rows, restarts, fused launches made after the
    restore)."""
    import windflow_tpu_torch as wt
    from windflow_tpu_torch.ops import ring as rk
    rows = []

    def consume(r):
        if r is not None and len(r):
            rows.append(r.copy())

    recovery = (None if epoch_batches is None else wt.RecoveryPolicy(
        epoch_batches=epoch_batches, restart_backoff=0.01, **policy))
    df = wt.Dataflow("recover", recovery=recovery)
    wt.build_pipeline(df, [wt.Source(batches=batches, schema=schema,
                                     name="src"), stage,
                           wt.Sink(consume, vectorized=True, name="sink")])
    node = [n for n in df.nodes if n.name.startswith(stage.name)][0]
    at_restore = []
    if kill_at is not None:
        svc, restore, fired = node.svc, node.state_restore, [0]

        def killing(batch, channel=0):
            fired[0] += 1
            if fired[0] == kill_at:
                raise RuntimeError(f"injected crash at batch {kill_at}")
            return svc(batch, channel)

        def restoring(snap):
            at_restore.append(rk.ring_append_regular_sum.launches)
            return restore(snap)
        node.svc, node.state_restore = killing, restoring
    t0 = time.perf_counter()
    df.run_and_wait_end(timeout=900)
    _sync(device)
    dt = time.perf_counter() - t0
    restarts = sum(n._recov.restarts_used for n in df.nodes
                   if n._recov is not None)
    after = (rk.ring_append_regular_sum.launches - at_restore[0]
             if at_restore else None)
    return dt, rows, restarts, after


def recover_phase(device=DEVICE, n_tuples=N_TUPLES,
                  prefix_tuples=PREFIX_TUPLES):
    """Phase 20: sum_test's stream through WinSeqGPU's native resident
    route under recovery= (a barrier every RECOVER_EPOCH_BATCHES source
    batches), the window node killed once at RECOVER_KILL_AT, against the
    uncrashed run per key in order and the total against the oracle:
    one restart, the fused kernel launched after the restore.  Then
    1M-tuple prefixes crashed and restored on the Python resident core
    (with and without snapshot_rings) and on the restaging route, each
    against its own uncrashed run.  Returns the crashed run's
    launches."""
    import windflow_tpu_torch as wt
    from windflow_tpu_torch.patterns.native_core import NativeResidentCore
    schema = wt.Schema(value=np.int64)
    batches = make_stream(schema, n_tuples)
    want = expected_total(batches)
    on_card = torch.device(device).type == "cuda"

    def stage(**kw):
        return resident_stage(wt, device=device, name="wgpu", **kw)

    dt0, clean, _, _ = recovered_run(stage(), batches, schema,
                                     device=device)
    cores = []
    with kernel_launches() as counts:
        dt, rows, restarts, after = recovered_run(
            stage_with_core(stage, cores), batches, schema,
            kill_at=RECOVER_KILL_AT, epoch_batches=RECOVER_EPOCH_BATCHES,
            device=device)
    total = int(sum(int(r["value"].sum()) for r in rows))
    if not (len(cores) == 1 and isinstance(cores[0], NativeResidentCore)
            and cores[0]._delegate is None and cores[0].has_state_abi):
        raise AssertionError(f"recover: the stage's core is {cores}")
    if restarts != 1:
        raise AssertionError(f"recover: {restarts} restarts, wanted 1")
    if total != want or by_key(rows) != by_key(clean):
        raise AssertionError(f"recover: total {total} (oracle {want}) or "
                             "the per-key results differ from the "
                             "uncrashed run")
    if on_card and not after:
        raise AssertionError(f"recover: {after} fused launches after the "
                             "restore")
    if on_card:
        require_launches("recover", counts, ["ring_append_regular_sum"])
    emit("recover", workload="sum_test CB win=256 slide=64 keys=64 "
         "resident, killed once", tuples=n_tuples, seconds=dt,
         tuples_per_s=n_tuples / dt, uncrashed_seconds=dt0,
         uncrashed_tuples_per_s=n_tuples / dt0,
         epoch_batches=RECOVER_EPOCH_BATCHES, kill_at=RECOVER_KILL_AT,
         restarts=restarts, fused_launches_after_restore=after,
         launches=counts, windows=sum(len(r) for r in rows), total=total,
         oracle=want, per_key_identical=True, nvidia_smi=nvidia_smi_line()
         if on_card else None)

    # 1M-tuple prefixes in smaller batches: the Python resident core (its
    # ring captured in a RingSnapshot, or rebased from the host archives)
    # and the restaging route, each crashed and restored
    per_key = prefix_tuples // N_KEYS
    prefix = [p for b in make_stream(schema, prefix_tuples)
              for p in np.array_split(
        b, max(1, len(b) // RECOVER_PREFIX_CHUNK))]
    cases = (("python_resident", {"snapshot_rings": True}, {}),
             ("python_resident_no_ring", {"snapshot_rings": False}, {}),
             ("restaging", {}, {"use_reduce_kernel": True}))
    for name, policy, kw in cases:
        pin = name.startswith("python")
        old = os.environ.get("WF_NO_NATIVE_CORE")
        if pin:
            os.environ["WF_NO_NATIVE_CORE"] = "1"
        try:
            _, base, _, _ = recovered_run(stage(**kw), prefix, schema,
                                          device=device)
            cores = []
            dt, got, restarts, _ = recovered_run(
                stage_with_core(lambda: stage(**kw), cores), prefix, schema,
                kill_at=RECOVER_PREFIX_KILL_AT, epoch_batches=1,
                device=device, **policy)
        finally:
            if pin:
                if old is None:
                    os.environ.pop("WF_NO_NATIVE_CORE", None)
                else:
                    os.environ["WF_NO_NATIVE_CORE"] = old
        kind = type(cores[0]).__name__
        if kind != ("ResidentWinSeqCore" if pin else "DeviceWinSeqCore"):
            raise AssertionError(f"recover_{name}: the core is {kind}")
        if restarts != 1 or by_key(got) != by_key(base):
            raise AssertionError(f"recover_{name}: {restarts} restarts, or "
                                 "the rows differ from the uncrashed run")
        emit("recover_prefix", case=name, core=kind, tuples=per_key * N_KEYS,
             batches=len(prefix), seconds=dt, restarts=restarts,
             windows=sum(len(r) for r in got), identical=True)
    return counts


# the plane phase (21): child processes (fresh interpreters started with
# subprocess, never forked after CUDA starts) that load the kernels phase
# 2 built; (a) a two-process keyed plane over a gloo group, (b) a feeder
# and two workers whose native state on the card is adopted after a kill
PLANE_FED_PERIOD = 0.1               # federation ship period, s
PLANE_TUPLES = N_TUPLES              # (a): half generated by each process
ADOPT_TUPLES = 4_000_000             # (b): 64 keys, 16 epochs
ADOPT_EPOCHS = 16
ADOPT_KILL_EPOCH = 8
ADOPT_DOWN_DEADLINE = 2.0            # s a peer stays down before "dead"
CHILD_TIMEOUT = 300.0


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(logs, role, *args):
    """This script as a child process (``--child role args``), from the
    repository root with the repository on its path, its output in a log
    file under ``logs``."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    log = os.path.join(logs, f"{role}-{'-'.join(map(str, args[:1]))}.log")
    with open(log, "w") as f:
        p = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", role,
             *map(str, args)], cwd=root, env=env, stdout=f,
            stderr=subprocess.STDOUT)
    p.log = log
    return p


def _tail(p):
    with open(p.log) as f:
        return f.read()[-6000:]


def _reap(procs, timeout=CHILD_TIMEOUT, expect=None):
    """Wait for every child (killing all on a timeout or when one fails);
    a child whose exit code is not ``expect.get(name, 0)`` fails the
    phase with its output."""
    expect = expect or {}
    t_end = time.monotonic() + timeout
    try:
        for name, p in procs.items():
            p.wait(timeout=max(1.0, t_end - time.monotonic()))
            if p.returncode != expect.get(name, 0):
                raise AssertionError(
                    f"child {name} exited {p.returncode}:\n{_tail(p)}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def _wait_files(paths, procs, timeout=CHILD_TIMEOUT):
    t_end = time.monotonic() + timeout
    for path in paths:
        while not os.path.exists(path):
            for name, p in procs.items():
                if p.poll() is not None:
                    raise AssertionError(
                        f"child {name} exited {p.returncode} before "
                        f"{os.path.basename(path)}:\n{_tail(p)}")
            if time.monotonic() > t_end:
                raise AssertionError(f"{path} never appeared")
            time.sleep(0.05)


def _fsync_save(path, rows):
    with open(path, "wb") as f:
        np.save(f, rows)
        f.flush()
        os.fsync(f.fileno())


def _concat(rows, schema_dtype):
    return (np.concatenate(rows) if rows
            else np.zeros(0, dtype=schema_dtype))


def plane_child(pid, coord_port, port0, port1, out_dir, n_tuples, device):
    """(a), one process: a gloo group, the multi-process mesh (one card a
    process), the hardened row plane, the process's half of sum_test's
    stream partitioned by key owner, WinSeqGPU's resident route under
    federate= and metrics=; process 0's receiver holds the telemetry
    aggregator that process 1's shipper ships to."""
    import windflow_tpu_torch as wt
    from windflow_tpu_torch.obs.federation import (FederationPolicy,
                                                   TelemetryAggregator)
    from windflow_tpu_torch.parallel.channel import partition_and_ship
    from windflow_tpu_torch.parallel.multihost import (
        initialize, local_kf_groups, make_multihost_mesh, open_row_plane,
        process_for_keys)
    from windflow_tpu_torch.runtime.emitters import default_routing
    import torch.distributed as dist
    pid, n_tuples = int(pid), int(n_tuples)
    initialize(coordinator_address=f"127.0.0.1:{coord_port}",
               num_processes=2, process_id=pid)
    # one card a process: the default device list is the visible cards
    mesh = make_multihost_mesh(
        n_sp=1, devices=None if device.startswith("cuda") else [device])
    owners = mesh.processes[:, 0, 0].tolist()
    if dict(mesh.shape) != {"kf": 2, "wf": 1, "sp": 1} or owners != [0, 1]:
        raise AssertionError(f"mesh {mesh}, owners {owners}")
    mine = local_kf_groups(mesh)
    fed = FederationPolicy(host=f"p{pid}", period=PLANE_FED_PERIOD,
                           stale_after=CHILD_TIMEOUT)
    agg = TelemetryAggregator(fed) if pid == 0 else None
    addresses = {0: ("127.0.0.1", int(port0)), 1: ("127.0.0.1", int(port1))}
    recv, senders = open_row_plane(pid, addresses, telemetry_sink=agg)
    schema = wt.Schema(value=np.int64)
    batches = make_stream(schema, n_tuples)
    half = len(batches) // 2
    local = batches[:half] if pid == 0 else batches[half:]
    peer = 1 - pid
    df = wt.Dataflow(f"plane{pid}", metrics=True, federate=fed)
    seen = [0]

    def local_phase():
        for b in local:
            part = partition_and_ship(b, process_for_keys(b["key"], mesh),
                                      pid, senders)
            seen[0] += len(part)
            yield part
        df.federation.bind({})        # no telemetry on a closed sender
        senders[peer].close()

    def feed():
        if pid == 1:
            df.federation.bind({0: senders[0]})
        # origin order (process 0's ids first) keeps every key's rows in
        # id order: process 0 ships, then reads; process 1 the reverse
        if pid == 0:
            yield from local_phase()
        for b in recv.batches():
            seen[0] += len(b)
            yield b
        if pid == 1:
            yield from local_phase()

    rows = []
    wt.build_pipeline(df, [
        wt.Source(batches=feed(), schema=schema, name="src"),
        resident_stage(wt, device=device),
        wt.Sink(lambda r: rows.append(r.copy())
                if r is not None and len(r) else None, vectorized=True)])
    with kernel_launches() as counts:
        t0 = time.perf_counter()
        df.run_and_wait_end(timeout=CHILD_TIMEOUT)
        _sync(device)
        dt = time.perf_counter() - t0
    recv.close()
    got = _concat(rows, schema.dtype())
    groups = set(default_routing(np.unique(got["key"]), 2).tolist())
    if not groups <= set(mine.tolist()):
        raise AssertionError(f"process {pid}: keys of kf groups {groups} "
                             f"outside its own {mine.tolist()}")
    telemetry = None
    if agg is not None:
        agg.poll()
        telemetry = agg.hosts()
    np.save(os.path.join(out_dir, f"plane{pid}.npy"), got)
    with open(os.path.join(out_dir, f"plane{pid}.json"), "w") as f:
        json.dump({"pid": pid, "kf_groups": mine.tolist(),
                   "tuples": seen[0], "seconds": dt,
                   "tuples_per_s": seen[0] / dt, "windows": len(got),
                   "launches": counts, "telemetry": telemetry,
                   "snapshots_shipped": df.metrics.snapshot()["counters"]
                   .get("fed_snapshots_shipped", 0)}, f)
    dist.destroy_process_group()
    return 0


def adopt_stream(schema, n_tuples=ADOPT_TUPLES, epochs=ADOPT_EPOCHS):
    """(b)'s stream: n_tuples of N_KEYS keys (values 0..99, per-key dense
    ids), two batches an epoch."""
    import windflow_tpu_torch as wt
    per_key = n_tuples // N_KEYS
    rng = np.random.default_rng(17)
    out = []
    for ids in np.array_split(np.arange(per_key), 2 * epochs):
        m = len(ids)
        out.append(wt.batch_from_columns(
            schema, key=np.tile(np.arange(N_KEYS), m),
            id=np.repeat(ids, N_KEYS), ts=np.repeat(ids, N_KEYS),
            value=rng.integers(0, 100, size=m * N_KEYS)))
    return out


def feeder_child(d1, d2, root, n_tuples):
    """(b)'s feeder: journaling senders to the two workers (key parity
    picks the worker), an epoch barrier every two batches."""
    import windflow_tpu_torch as wt
    from windflow_tpu_torch.parallel.channel import RowSender, WireResume
    schema = wt.Schema(value=np.int64)
    batches = adopt_stream(schema, int(n_tuples))
    senders = {w: RowSender("127.0.0.1", int(p),
                            resume=WireResume(deadline=CHILD_TIMEOUT),
                            connect_deadline=60.0)
               for w, p in ((1, d1), (2, d2))}
    for e in range(1, ADOPT_EPOCHS + 1):
        for b in batches[2 * (e - 1):2 * e]:
            for w in (1, 2):
                senders[w].send(b[(1 + b["key"] % 2) == w])
        for w in (1, 2):
            senders[w].send_epoch(e)
        time.sleep(0.1)     # keep emitting while the kill happens
    for w in (1, 2):
        senders[w].close()
    return 0


def _worker_core(device):
    import windflow_tpu_torch as wt
    from windflow_tpu_torch.patterns.native_core import NativeResidentCore
    core = resident_stage(wt, device=device).make_core()
    if not (isinstance(core, NativeResidentCore) and core.has_state_abi):
        raise AssertionError(f"worker core {core}")
    return core


def worker_child(w, d1, d2, m1, m2, root, die_after, device):
    """(b)'s worker ``w``: a NativeResidentCore on the card fed from its
    RowReceiver; at each wire epoch it drains, seals the core's state into
    its CheckpointStore, writes the epoch's rows, replicates the epoch to
    its peer (portable checkpoint) and acks.  ``die_after`` > 0: os._exit
    after that epoch (kill -9).  The survivor's PlaneSupervisor adopts a
    dead peer: the peer's newest spooled state into a fresh core on the
    card, and the journal's tail through takeover_receiver."""
    from windflow_tpu_torch.obs import MetricsRegistry
    from windflow_tpu_torch.ops import ring as rk
    from windflow_tpu_torch.parallel.channel import (RowReceiver, RowSender,
                                                     WireConfig, WireResume)
    from windflow_tpu_torch.parallel.plane import PlanePolicy, PlaneSupervisor
    from windflow_tpu_torch.recovery.epoch import EpochMarker
    from windflow_tpu_torch.recovery.portable import PortableSpool
    from windflow_tpu_torch.recovery.store import CheckpointStore
    w, die_after = int(w), int(die_after)
    d1, d2, m1, m2 = (int(a) for a in (d1, d2, m1, m2))
    peer = 3 - w
    my_data, my_mon = (d1, m1) if w == 1 else (d2, m2)
    peer_mon = m2 if w == 1 else m1
    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0
    store = CheckpointStore(os.path.join(root, f"store{w}"), retain=4)
    spool = PortableSpool(os.path.join(root, f"spool{w}"))
    recv = RowReceiver(1, port=my_data,
                       resume=WireResume(deadline=CHILD_TIMEOUT),
                       ack_epochs=False, accept_timeout=60.0)
    mon_recv = RowReceiver(1, port=my_mon,
                           resume=WireResume(deadline=2 * CHILD_TIMEOUT),
                           accept_timeout=60.0, ckpt_sink=spool)
    wire_metrics = MetricsRegistry()
    mon_snd = RowSender("127.0.0.1", peer_mon,
                        resume=WireResume(deadline=2 * CHILD_TIMEOUT),
                        connect_deadline=60.0, metrics=wire_metrics)
    ctx, adopt_started, adopt_done = {}, threading.Event(), threading.Event()

    def seal(core, e, pending, who):
        pending += core.checkpoint_drain_batches()
        _fsync_save(os.path.join(root, f"out{who}_{e:07d}.npy"),
                    _concat(pending, core_dtype[0]))
        pending.clear()

    core_dtype = [None]

    def on_adopt(dead, epoch, st):
        ctx["adopted_from"] = [int(dead), int(epoch)]
        ctx["t_elected"] = time.time()

        def run():
            try:
                core2 = _worker_core(device)
                core2.state_restore(st.load(int(epoch), "core"))
                tr = ctx["sup"].takeover_receiver(dead, epoch, n_senders=1)
                ctx["t_ready"] = time.time()
                fused0, pend = rk.ring_append_regular_sum.launches, []
                for item in tr.batches(epoch_markers=True):
                    if isinstance(item, EpochMarker):
                        seal(core2, int(item.epoch), pend, dead)
                        tr.ack_epoch(int(item.epoch))
                        continue
                    core_dtype[0] = item.dtype
                    pend += core2.process_batches(item)
                pend += core2.flush_batches()
                _fsync_save(os.path.join(root, f"out{dead}_eos.npy"),
                            _concat(pend, core_dtype[0]))
                tr.close()
                ctx["t_done"] = time.time()
                ctx["fused_during_adoption"] = (
                    rk.ring_append_regular_sum.launches - fused0)
            except Exception as e:                      # noqa: BLE001
                ctx["adopt_error"] = repr(e)
            finally:
                adopt_done.set()

        threading.Thread(target=run, daemon=True).start()
        adopt_started.set()

    policy = PlanePolicy(
        down_deadline=ADOPT_DOWN_DEADLINE, period=0.1, candidates={1, 2},
        wire=WireConfig(connect_deadline=60.0, heartbeat=2.0,
                        stall_timeout=30.0, resume=True, recovery=False))
    sup = PlaneSupervisor(w, {1: ("127.0.0.1", d1), 2: ("127.0.0.1", d2)},
                          {peer: mon_snd}, policy=policy, store=store,
                          spool=spool, on_adopt=on_adopt)
    ctx["sup"] = sup
    sup.start()
    core = _worker_core(device)
    open(os.path.join(root, f"ready{w}"), "w").close()
    pending, tuples = [], 0
    t0 = time.perf_counter()
    for item in recv.batches(epoch_markers=True):
        if isinstance(item, EpochMarker):
            e = int(item.epoch)
            seal(core, e, pending, w)
            n = store.save_blob(e, "core", core.state_snapshot())
            store.commit(e, {"core": {"bytes": n}})
            sup.replicate(e)
            recv.ack_epoch(e)
            if die_after and e >= die_after:
                with open(os.path.join(root, f"killed{w}.json"), "w") as f:
                    json.dump({"t": time.time(), "epoch": e,
                               "ckpt_shipped_bytes": wire_metrics.snapshot()
                               ["counters"].get("ckpt_shipped_bytes", 0)},
                              f)
                os._exit(1)     # kill -9: no EOS, no teardown
            continue
        core_dtype[0] = item.dtype
        tuples += len(item)
        pending += core.process_batches(item)
    pending += core.flush_batches()
    _fsync_save(os.path.join(root, f"out{w}_eos.npy"),
                _concat(pending, core_dtype[0]))
    _sync(device)
    dt = time.perf_counter() - t0
    # a whole detection window (many down-deadlines) for the adoption to
    # start: the peer's death may be declared after this stream ends
    if adopt_started.wait(20 * ADOPT_DOWN_DEADLINE):
        if not adopt_done.wait(CHILD_TIMEOUT):
            raise AssertionError("the adopted tail never finished")
        if "adopt_error" in ctx:
            raise AssertionError(ctx["adopt_error"])
    recv.close()
    sup.close()
    mon_snd.abort()
    mon_recv.close()
    with open(os.path.join(root, f"summary{w}.json"), "w") as f:
        json.dump({"worker": w, "tuples": tuples, "seconds": dt,
                   "launches": {n: wr.launches for n, wr
                                in kernel_wrappers().items()},
                   **{k: v for k, v in ctx.items() if k != "sup"}}, f)
    return 0


def plane_phase(device=DEVICE, n_tuples=PLANE_TUPLES,
                adopt_tuples=ADOPT_TUPLES):
    """Phase 21: (a) the two-process keyed plane, merged per key against
    the single-process resident run (and the total against the oracle),
    the aggregator holding process 1's fresh snapshots (seq >= 2), each
    process's keys in its own kf groups, the fused kernel launched in
    each; (b) kill and adopt: worker 1 exits after epoch
    ADOPT_KILL_EPOCH, worker 2 adopts its state into a fresh core on the
    card and replays the journal's tail; the merged rows equal the
    uncrashed single-process run per key in order.  Returns the launches
    of (a)'s two processes and (b)'s survivor, summed."""
    import windflow_tpu_torch as wt
    schema = wt.Schema(value=np.int64)
    on_card = torch.device(device).type == "cuda"
    root = tempfile.mkdtemp(prefix="wf_plane_")
    try:
        # (a) the two-process keyed plane
        coord, p0, p1 = _free_port(), _free_port(), _free_port()
        t0 = time.perf_counter()
        _reap({f"plane{pid}": _spawn(root, "plane", pid, coord, p0, p1,
                                     root, n_tuples, device)
               for pid in (0, 1)})
        wall = time.perf_counter() - t0
        res = []
        for pid in (0, 1):
            with open(os.path.join(root, f"plane{pid}.json")) as f:
                res.append(json.load(f))
        got = [np.load(os.path.join(root, f"plane{pid}.npy"))
               for pid in (0, 1)]
        keys = [set(np.unique(g["key"]).tolist()) for g in got]
        if keys[0] & keys[1]:
            raise AssertionError(f"plane: keys {keys[0] & keys[1]} "
                                 "produced by both processes")
        batches = make_stream(schema, n_tuples)
        want = expected_total(batches)
        _, _, _, single = run_pipeline(resident_stage(wt, device=device),
                                       batches, schema, keep=True)
        total = int(sum(int(g["value"].sum()) for g in got))
        if total != want or by_key(got) != by_key(single):
            raise AssertionError(f"plane: total {total} (oracle {want}) or "
                                 "the merged per-key results differ from "
                                 "the single-process run")
        remote = (res[0]["telemetry"] or {}).get("p1")
        if not (remote and remote["fresh"] and remote["seq"] >= 2):
            raise AssertionError(f"plane: the aggregator holds {remote} "
                                 "for process 1")
        if on_card:
            for r in res:
                require_launches(f"plane{r['pid']}", r["launches"],
                                 ["ring_append_regular_sum"])
        emit("plane", workload="sum_test CB win=256 slide=64 keys=64, "
             "2 processes, kf=2 on one card each, hardened row plane, "
             "federate=", tuples=n_tuples, wall_seconds=wall,
             processes=[{k: r[k] for k in ("pid", "kf_groups", "tuples",
                                           "seconds", "tuples_per_s",
                                           "windows", "launches",
                                           "snapshots_shipped")}
                        for r in res],
             remote_telemetry=remote, total=total, oracle=want,
             per_key_identical=True,
             nvidia_smi=nvidia_smi_line() if on_card else None)

        # (b) kill and adopt, the state on the card
        d1, d2, m1, m2 = (_free_port() for _ in range(4))
        t0 = time.perf_counter()
        procs = {f"worker{w}": _spawn(
            root, "worker", w, d1, d2, m1, m2, root,
            ADOPT_KILL_EPOCH if w == 1 else 0, device) for w in (1, 2)}
        _wait_files([os.path.join(root, f"ready{w}") for w in (1, 2)],
                    procs)
        procs["feeder"] = _spawn(root, "feeder", d1, d2, root, adopt_tuples)
        _reap(procs, expect={"worker1": 1})
        wall = time.perf_counter() - t0
        with open(os.path.join(root, "summary2.json")) as f:
            surv = json.load(f)
        with open(os.path.join(root, "killed1.json")) as f:
            killed = json.load(f)
        if surv.get("adopted_from") != [1, ADOPT_KILL_EPOCH]:
            raise AssertionError(f"adopt: adopted {surv.get('adopted_from')}")
        files = sorted(f for f in os.listdir(root) if f.startswith("out"))
        merged = [np.load(os.path.join(root, f)) for f in files]
        merged = [m for m in merged if len(m)]
        batches = adopt_stream(schema, adopt_tuples)
        _, _, _, single = run_pipeline(resident_stage(wt, device=device),
                                       batches, schema, keep=True)
        total, want = int(sum(int(m["value"].sum()) for m in merged)), \
            expected_total(batches)
        if total != want or by_key(merged) != by_key(single):
            raise AssertionError(f"adopt: total {total} (oracle {want}) or "
                                 "the merged rows differ from the "
                                 "uncrashed single-process run")
        if on_card and not surv.get("fused_during_adoption"):
            raise AssertionError(f"adopt: the adopted core launched "
                                 f"{surv.get('fused_during_adoption')} "
                                 "fused kernels")
        emit("plane_adopt", workload=f"{adopt_tuples} tuples 64 keys CB "
             f"win=256 slide=64, feeder + 2 workers, worker 1 killed after "
             f"epoch {ADOPT_KILL_EPOCH} of {ADOPT_EPOCHS}",
             wall_seconds=wall, adopted_from=surv["adopted_from"],
             adoption_epoch=surv["adopted_from"][1],
             detect_seconds=surv["t_elected"] - killed["t"],
             handoff_seconds=surv["t_ready"] - killed["t"],
             adopted_tail_seconds=surv["t_done"] - surv["t_ready"],
             ckpt_shipped_bytes=killed["ckpt_shipped_bytes"],
             survivor_launches=surv["launches"],
             fused_during_adoption=surv.get("fused_during_adoption"),
             windows=sum(len(m) for m in merged), total=total, oracle=want,
             per_key_identical=True,
             nvidia_smi=nvidia_smi_line() if on_card else None)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {name: sum(r["launches"][name] for r in res)
            + surv["launches"][name] for name in surv["launches"]}


# the operator phases (22-24): the port's twins of the repo's soak, lint
# and roll scripts (scripts/torch_*.py), loaded by path
SOAK_SEED = 11
SOAK_NATIVE_CASES = 24
SOAK_HOST_CASES = 8
SOAK_OTHER_CASES = 4                 # of the rescale, wire and handoff twins
RESIDENT_KERNELS = ("ring_append_regular_sum", "ring_append_eval")
ROLL_HOST_EPOCHS = 8
LINT_APPS = ("ysb", "pipe", "spatial", "micro")
LINT_TWINS = ("torch_soak_overload", "torch_soak_crash", "torch_soak_rescale",
              "torch_soak_wire", "torch_soak_handoff", "torch_wf_roll")


def load_script(name):
    """scripts/<name>.py as a module."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def soak_oracle(batches, win, slide):
    """{key: [(window id, sum), ...]} of a soak case's stream: the sums of
    each key's values in id order over windows every ``slide`` rows from
    row 0, the partial ones at EOS included (ts = id, so a TB window
    covers the same rows as a CB one)."""
    rows = np.concatenate(batches)
    out = {}
    for k in np.unique(rows["key"]):
        v = rows["value"][rows["key"] == k]
        c = np.concatenate([[0], np.cumsum(v)])
        starts = np.arange((len(v) - 1) // slide + 1) * slide
        out[int(k)] = list(enumerate(
            (c[np.minimum(starts + win, len(v))] - c[starts]).tolist()))
    return out


def soak_phase(device=DEVICE, n_native=SOAK_NATIVE_CASES,
               n_host=SOAK_HOST_CASES, n_other=SOAK_OTHER_CASES):
    """Phase 22: scripts/torch_soak_crash.py's native cases on ``device``
    (each crashed run equal to its uncrashed run, checked by the script,
    and the uncrashed run to soak_oracle), with every case's launches and
    the three resident kernels each launched across them; then host
    cases of the crash, rescale, wire and handoff twins.  Returns the
    native cases' launches."""
    sc = load_script("torch_soak_crash")
    on_card = torch.device(device).type == "cuda"
    wrappers, kinds = kernel_wrappers(), set()
    t0 = time.perf_counter()
    with kernel_launches() as counts:
        for c in range(n_native):
            before = {n: wrappers[n].launches for n in RESIDENT_KERNELS}
            report = {}
            params = sc.run_case_native(SOAK_SEED, c, device=device,
                                        report=report)
            got = {}
            for k, i, v in report["oracle"]:
                got.setdefault(k, []).append((i, v))
            if got != soak_oracle(report["batches"], params["win"],
                                  params["slide"]):
                raise AssertionError(
                    f"soak case {c}: the uncrashed run differs from the "
                    f"numpy oracle (params {params})")
            kinds |= {params["win_type"], f"shards={params['shards']}"}
            emit("soak_case", case=c, params=params,
                 rows=len(report["got"]), restarts=report["restarts"],
                 launches={n: wrappers[n].launches - before[n]
                           for n in RESIDENT_KERNELS})
        _sync(device)
    native_s = time.perf_counter() - t0
    if not {"CB", "TB", "shards=2"} <= kinds:
        raise AssertionError(f"soak: the cases drew only {sorted(kinds)}")
    if on_card:
        require_launches("soak", counts, RESIDENT_KERNELS)
    t0, host = time.perf_counter(), {}
    for name, seed, n in (("torch_soak_crash", SOAK_SEED, n_host),
                          ("torch_soak_rescale", 23, n_other),
                          ("torch_soak_wire", 7, n_other),
                          ("torch_soak_handoff", SOAK_SEED, n_other)):
        mod = sc if name == "torch_soak_crash" else load_script(name)
        t1 = time.perf_counter()
        for c in range(n):
            mod.run_case(seed, c)
        host[name] = {"seed": seed, "cases": n,
                      "seconds": time.perf_counter() - t1}
    emit("soak", seed=SOAK_SEED, native_cases=n_native,
         native_seconds=native_s, kinds=sorted(kinds), launches=counts,
         host_cases=host, host_seconds=time.perf_counter() - t0,
         nvidia_smi=nvidia_smi_line() if on_card else None)
    return counts


def lint_phase():
    """Phase 23: scripts/torch_wf_lint.py, in a fresh interpreter, over
    the port's apps and every twin with a wf_check_pipelines() hook:
    exit 0 under --error, no diagnostic."""
    root = os.path.dirname(os.path.abspath(__file__))
    targets = ([f"windflow_tpu_torch.apps.{a}" for a in LINT_APPS]
               + [os.path.join("scripts", f"{s}.py") for s in LINT_TWINS])
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("WF_LOG_DIR", "WF_SAMPLE_PERIOD"):
        env.pop(k, None)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable,
                        os.path.join(root, "scripts", "torch_wf_lint.py"),
                        "--error", "--json", *targets],
                       cwd=root, env=env, capture_output=True, text=True,
                       timeout=CHILD_TIMEOUT)
    if r.returncode != 0:
        raise AssertionError(f"lint: exit {r.returncode}\n{r.stdout}"
                             f"\n{r.stderr[-4000:]}")
    doc = json.loads(r.stdout)
    if doc["diagnostics"] or doc["targets"] < len(targets):
        raise AssertionError(f"lint: {doc}")
    emit("lint", modules=targets, targets=doc["targets"], diagnostics=0,
         exit_code=r.returncode, seconds=time.perf_counter() - t0)


def roll_phase(device=DEVICE, n_tuples=ADOPT_TUPLES):
    """Phase 24: scripts/torch_wf_roll.py's sequencer over two worker
    processes, each a NativeResidentCore on ``device`` at sum_test's
    width (adopt_stream: n_tuples, 64 keys, two batches an epoch), rolled
    at the script's ROLL_AT (drain -> seal: the core drained, the epoch's
    rows written, the native blob saved, then the ack -> hand-off ->
    restart restoring the blob into a fresh core with resume_epoch=); the
    merged rows equal the uncrashed single-process run per key, in order,
    and the oracle's total, and each restarted process launched the fused
    kernel (both checked by the script).  Then the script's host differential,
    run_roll.  Returns every worker process's launches, summed."""
    roll = load_script("torch_wf_roll")
    on_card = torch.device(device).type == "cuda"
    root = tempfile.mkdtemp(prefix="wf_roll_")
    try:
        native_root, host_root = (os.path.join(root, d)
                                  for d in ("native", "host"))
        os.makedirs(native_root)
        os.makedirs(host_root)
        out = roll.run_native_roll(native_root, device=device,
                                   n_tuples=n_tuples, n_epochs=ADOPT_EPOCHS)
        if on_card:
            require_launches("roll", out["launches"],
                             ("ring_append_regular_sum",))
        emit("roll", workload=f"{n_tuples} tuples 64 keys CB win=256 "
             f"slide=64, {ADOPT_EPOCHS} epochs, feeder + 2 native workers, "
             f"rolled at epochs {list(roll.ROLL_AT)}", **out,
             nvidia_smi=nvidia_smi_line() if on_card else None)
        t0 = time.perf_counter()
        host = roll.run_roll(host_root, n_epochs=ROLL_HOST_EPOCHS)
        emit("roll_host", epochs=ROLL_HOST_EPOCHS, **host,
             seconds=time.perf_counter() - t0)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out["launches"]


# ------------------------------------------------------------ ring dtypes

RD_BASE = 1 << 26          # sum_test values from 2**26: a window of 256 of
#                            them sums past 2**31
RD_INT16_LO, RD_INT16_HI = 200, 30_000   # an int16 wire that wraps in int8
RD_MULTI_TUPLES = 2_000_000
RD_MULTI_FLUSH = FLUSH_ROWS // N_KEYS     # rows a key a dispatch


def rd_stream(schema, n_tuples, lo, hi, seed):
    """sum_test's stream (make_stream's keys and ids) with values in
    [lo, hi)."""
    from windflow_tpu_torch import batch_from_columns
    per_key = n_tuples // N_KEYS
    rng = np.random.default_rng(seed)
    batches = []
    for at in range(0, per_key, CHUNK // N_KEYS):
        m = min(CHUNK // N_KEYS, per_key - at)
        ids = np.repeat(np.arange(at, at + m), N_KEYS)
        batches.append(batch_from_columns(
            schema, key=np.tile(np.arange(N_KEYS), m), id=ids, ts=ids,
            value=rng.integers(lo, hi, size=m * N_KEYS)))
    return batches


def rd_windows(vals, op):
    """Every CB WIN/SLIDE window of one key's values (`op` "sum" or
    "max"), the partial ones at the end included (the pipeline's EOS
    flush), in int64."""
    n = len(vals)
    s = np.arange(0, n, SLIDE)
    e = np.minimum(s + WIN, n)
    if op == "sum":
        c = np.concatenate([[0], np.cumsum(vals, dtype=np.int64)])
        return c[e] - c[s]
    return np.array([vals[a:b].max() for a, b in zip(s, e)], np.int64)


def rd_oracle_rows(batches, op, cast=None):
    """{key: windows' values in id order} (rd_windows), the values first
    cast through the dtypes of `cast` (a wire and ring that wrap)."""
    vals = np.concatenate([b["value"] for b in batches])
    keys = np.concatenate([b["key"] for b in batches])
    order = np.argsort(keys, kind="stable")
    vals, keys = vals[order], keys[order]
    for dt in cast or ():
        vals = vals.astype(dt)
    bounds = np.searchsorted(keys, np.arange(N_KEYS + 1))
    return {k: rd_windows(vals[bounds[k]:bounds[k + 1]], op)
            for k in range(N_KEYS)}


def rd_check_rows(rows, want, name):
    """The pipeline's rows per key, in id order, against the oracle."""
    rows = np.concatenate(rows)
    for k, w in want.items():
        mine = rows[rows["key"] == k]
        if not (np.array_equal(mine["id"], np.arange(len(w)))
                and np.array_equal(mine["value"], w)):
            raise AssertionError(f"ring_dtypes {name}: key {k}'s windows "
                                 "differ from the numpy int64 oracle")
    return len(rows)


def rd_cold(dev, fn, tensors):
    """fn's cold time (cycling through copies of `tensors` three times the
    L2, a CUDA-graph replay)."""
    copies = cold_copies(dev, tensors)
    ms = kernel_ms(cycled(copies, fn), reps=10 * len(copies))
    del copies
    return ms


def rd_fused_row(call):
    """The fused kernel, and ring_append, at a recorded call's inputs over
    a seeded ring of its dtype and over an int32 ring (the same rectangle;
    hot: the kernels line's fused row is hot), each beside its bytes
    bound."""
    from windflow_tpu_torch.ops import ring as rk
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    row = {}
    for label, dtype in (("new", call["dtype"]), ("int32", torch.int32)):
        case = dict(ring=seeded_ring(gen, call["shape"], dtype),
                    **{k: call[k] for k in ("blk", "offs", "rstart0", "rlen",
                                            "C", "slide")})
        ring = case["ring"]
        args = (case["blk"], case["offs"], case["rstart0"], case["rlen"],
                case["C"], case["slide"])
        b = fused_bound(case)
        blk, offs = case["blk"], case["offs"]
        row[label] = dict(
            acc=str(dtype), ms=kernel_ms(
                lambda ring=ring, args=args: rk.ring_append_regular_sum(
                    ring, *args)),
            bound_ms=b[0], bound_by=b[1], bound_bytes=b[2],
            # ring_append (no main-path launch) at the same rectangle
            append_ms=kernel_ms(lambda ring=ring: rk.ring_append(
                ring, blk, offs)),
            append_bound_ms=bytes_bound(
                blk.numel() * (blk.element_size() + ring.element_size())
                + 4 * offs.numel(), blk.numel())[0])
        del case, ring
    return row


def rd_eval_row(call):
    """ring_append_eval at a recorded call's inputs over a seeded ring of
    its dtype and over an int32 ring (cold), each beside its bound."""
    from windflow_tpu_torch.ops import ring as rk
    gen = np.random.default_rng(8)
    row = {}
    for label, dtype in (("new", call["dtype"]), ("int32", torch.int32)):
        case = append_eval_call_case(dict(call, dtype=dtype), gen)
        dev = case["ring"].device
        long = case["long"].on(torch.from_numpy(case["long"].vec).to(dev))
        counters = torch.zeros(long.n + 1, dtype=torch.int32, device=dev)
        args = (case["blk"], case["offs"], case["ops"], case["rows"],
                case["starts"], case["lens"], case["pad"])
        b = append_eval_bound(case)
        row[label] = dict(
            acc=str(dtype), ms=rd_cold(dev, lambda r: rk.ring_append_eval(
                r, *args, long=long, counters=counters),
                [case["ring"].clone()]),
            bound_ms=b[0], bound_by=b[1], bound_bytes=b[2])
        del case
    return row


def rd_multi_row(case, int32_case):
    """ring_append_multi_eval (cold) at a case and at the same shape over
    int32 and float32 rings, each beside its bound."""
    from windflow_tpu_torch.ops import ring as rk
    row = {}
    for label, c in (("new", case), ("int32", int32_case)):
        dev = c["offs"].device
        long = c["long"].on(torch.from_numpy(c["long"].vec).to(dev))
        counters = torch.zeros(long.n + 1, dtype=torch.int32, device=dev)
        d = (c["rows"], c["starts"], c["lens"], c["pad"])

        def kernel(*rings, c=c, d=d, long=long, counters=counters):
            rk.ring_append_multi_eval(rings, c["blks"], c["offs"],
                                      c["evals"], *d, c["tile_fields"],
                                      long=long, counters=counters)
        b = multi_append_eval_bound(c)
        row[label] = dict(
            accs=[str(r.dtype) for r in c["rings"]],
            ms=rd_cold(dev, kernel, [r.clone() for r in c["rings"]]),
            bound_ms=b[0], bound_by=b[1], bound_bytes=b[2])
    return row


def rd_sum_test(wr, rk, wt):
    """(a) sum_test's 16M tuples through the resident route on an int64
    ring: every window and the total against the numpy int64 oracle, one
    fused launch a regular flush, every fused call checked."""
    from windflow_tpu_torch.ops import resident
    from windflow_tpu_torch.patterns.native_core import NativeResidentCore
    schema = wt.Schema(value=np.int64)
    t0 = time.perf_counter()
    batches = rd_stream(schema, N_TUPLES, RD_BASE, RD_BASE + 100, seed=9)
    want = rd_oracle_rows(batches, "sum")
    cores = []
    stage = stage_with_core(lambda: resident_stage(
        wt, wt.Reducer("sum"), device=DEVICE, compute_dtype=np.int64), cores)
    resident.stats_snapshot(reset=True)
    counters = (rk.ring_append_regular_sum, rk.ring_append_eval,
                rk.ring_append, wr.windowed_reduce)
    for c in counters:
        c.launches = 0
    with recorded_fused() as calls:
        dt, n_windows, total, rows = run_pipeline(stage, batches, schema,
                                                  keep=True)
    launches = {c.__name__: c.launches for c in counters}
    stats = resident.stats_snapshot(reset=True)
    core = cores[0] if len(cores) == 1 else None
    if not (isinstance(core, NativeResidentCore) and core._delegate is None
            and core.executor.acc_dtype == np.int64):
        raise AssertionError(f"ring_dtypes sum_test: the core is {cores}")
    windows = rd_check_rows(rows, want, "sum_test int64")
    oracle = int(sum(int(w.sum()) for w in want.values()))
    peak = max(int(w.max()) for w in want.values())
    if total != oracle or peak <= 2 ** 31:
        raise AssertionError(f"ring_dtypes sum_test: total {total}, oracle "
                             f"{oracle}, largest window {peak}")
    if not (launches["ring_append_regular_sum"] > 0
            and launches["ring_append"] == launches["windowed_reduce"] == 0
            and stats["dispatches"] == launches["ring_append_regular_sum"]
            + launches["ring_append_eval"]):
        raise AssertionError(f"ring_dtypes sum_test: launches {launches}, "
                             f"dispatches {stats['dispatches']}")
    n, err = check_fused(calls, "ring_dtypes sum_test int64")
    big = max(calls, key=lambda c: c["blk"].numel() * c["C"])
    row = dict(calls_checked=n, max_abs_err=err,
               wire=str(big["blk"].dtype), **rd_fused_row(big))
    emit("ring_dtypes", case="sum_test_int64",
         workload="sum_test CB win=256 slide=64 keys=64 resident, "
                  "compute_dtype=int64, values 2**26..2**26+99",
         tuples=N_TUPLES, seconds=dt, tuples_per_s=N_TUPLES / dt,
         windows=windows, total=total, oracle=oracle, largest_window=peak,
         launches=launches, dispatches=stats["dispatches"],
         ring_append_regular_sum=row,
         phase_seconds=time.perf_counter() - t0)
    return launches, row


def rd_max_prefixes(wr, rk, wt):
    """(b) the 1M-tuple Reducer("max") prefix (irregular launches) on an
    int64 ring and on an int8 ring fed an int16 wire that wraps, each
    against a numpy oracle (of the wrapped values), every
    ring_append_eval call checked."""
    schema = wt.Schema(value=np.int64)
    out, rows_out = {}, {}
    runs = (("int64", np.int64, RD_BASE, RD_BASE + 100),
            ("int8", np.int8, RD_INT16_LO, RD_INT16_HI))
    for label, acc, lo, hi in runs:
        t0 = time.perf_counter()
        batches = rd_stream(schema, PREFIX_TUPLES, lo, hi, seed=10)
        counters = (rk.ring_append_eval, rk.ring_append_regular_sum,
                    rk.ring_append, wr.windowed_reduce)
        for c in counters:
            c.launches = 0
        with recorded_append_evals() as calls:
            _, n_dev, _, rows = run_pipeline(resident_stage(
                wt, wt.Reducer("max"), device=DEVICE, compute_dtype=acc),
                batches, schema, keep=True)
        launches = {c.__name__: c.launches for c in counters}
        if not (launches["ring_append_eval"] > 0
                and launches["ring_append"] == launches["windowed_reduce"]
                == 0):
            raise AssertionError(f"ring_dtypes max {label}: launches "
                                 f"{launches}")
        rd_check_rows(rows, rd_oracle_rows(
            batches, "max", (np.int16, np.int8) if acc == np.int8 else ()),
            f"max {label}")
        wires = {c["blk"].dtype for c in calls}
        if (torch.int16 if acc == np.int8 else torch.int32) not in wires:
            raise AssertionError(f"ring_dtypes max {label}: wires {wires}")
        n, err = check_append_evals(calls, f"ring_dtypes max {label}")
        big = max(calls, key=lambda c: (c["blk"].numel(),
                                        c["starts"].numel()))
        out[label] = dict(calls_checked=n, max_abs_err=err,
                          wire=str(big["blk"].dtype), **rd_eval_row(big))
        rows_out[label] = launches
        emit("ring_dtypes", case=f"max_prefix_{label}",
             workload=f"Reducer('max') CB win=256 slide=64 keys=64, "
                      f"compute_dtype={label}, values {lo}..{hi - 1}",
             tuples=PREFIX_TUPLES, windows=n_dev, launches=launches,
             ring_append_eval=out[label],
             phase_seconds=time.perf_counter() - t0)
    return rows_out, out


def rd_multi_fields(rk):
    """(c) sum(a) + max(a), sum(b) + min(b) + prod(b), sum(c) + max(c)
    (the MultiReducer's stats over three fields) on a
    MultiFieldResidentExecutor whose rings are int16, int64 and float64,
    over RD_MULTI_TUPLES tuples of 64 keys: a dispatch appends
    RD_MULTI_FLUSH rows a key and evaluates the CB 256/64 windows they
    complete, one ring_append_multi_eval launch each; every window against
    a numpy oracle (int16 sums wrap), every call checked."""
    from windflow_tpu_torch.ops.resident import MultiFieldResidentExecutor
    t0 = time.perf_counter()
    rng = np.random.default_rng(14)
    per_key = RD_MULTI_TUPLES // N_KEYS
    cols = {"a": rng.integers(-100, 100, size=(N_KEYS, per_key)),
            "b": rng.integers(1, 98, size=(N_KEYS, per_key)) * (1 << 30),
            "c": rng.uniform(0.999, 1.001, size=(N_KEYS, per_key))}
    accs = {"a": np.int16, "b": np.int64, "c": np.float64}
    stats = (("sum", "a"), ("max", "a"), ("sum", "b"), ("min", "b"),
             ("prod", "b"), ("sum", "c"), ("max", "c"))
    ex = MultiFieldResidentExecutor(("a", "b", "c"), stats,
                                    acc_dtypes=accs, device=DEVICE)
    cap = 1 << (per_key - 1).bit_length()
    ex.reset(N_KEYS, cap)
    rk.ring_append_multi_eval.launches = 0
    done, first, dispatches, metas = 0, 0, 0, []
    with recorded_multi_evals() as calls:
        for end in range(RD_MULTI_FLUSH, per_key + 1, RD_MULTI_FLUSH):
            last = (end - WIN) // SLIDE          # windows ending by `end`
            idx = np.arange(first, last + 1)
            first = last + 1
            rows = np.repeat(np.arange(N_KEYS), len(idx))
            starts = np.tile(idx * SLIDE, N_KEYS)
            blks = {f: cols[f][:, done:end] for f in cols}
            for f in ("a", "b"):                 # the narrowest wire
                blks[f] = blks[f].astype(ex.narrow_for(f, blks[f].ravel()))
            ex.launch((rows, starts), blks, np.full(N_KEYS, done), rows,
                      starts, np.full(len(rows), WIN))
            metas.append(len(rows))
            dispatches += 1
            done = end
        ready = ex.drain()
    launches = rk.ring_append_multi_eval.launches
    if launches != dispatches:
        raise AssertionError(f"ring_dtypes multi: {launches} launches for "
                             f"{dispatches} dispatches")
    ops = {"sum": np.sum, "max": np.max, "min": np.min, "prod": np.prod}
    err = 0.0
    for (rows, starts), outs in ready:
        for (op, f), got in zip(stats, outs):
            cells = cols[f][rows[:, None], starts[:, None]
                            + np.arange(WIN)[None, :]]
            if f == "a":
                cells = cells.astype(np.int16)
            want = ops[op](cells, axis=1).astype(got.dtype)
            if f != "c" or op == "max":
                if not np.array_equal(got, want):
                    raise AssertionError(f"ring_dtypes multi {op}({f}) "
                                         "differs from the numpy oracle")
                continue
            tol = (FLOAT64_RTOL * np.abs(cells).sum(axis=1) if op == "sum"
                   else 2 * WIN * 2.0 ** -53 * np.abs(want))
            e = np.abs(got - want)
            if not bool((e <= tol).all()):
                raise AssertionError(f"ring_dtypes multi {op}({f}): error "
                                     f"{e.max()} beyond the bound")
            err = max(err, float(e.max()))
    n, cerr = check_multi_evals(calls, "ring_dtypes multi")
    big = max(calls, key=lambda c: c["starts"].numel())
    case = multi_eval_call_case(big, np.random.default_rng(8))
    as32 = dict(case, rings=[r.to(torch.float32 if r.is_floating_point()
                                  else torch.int32) for r in case["rings"]],
                blks=[b.to(torch.float32) if b.is_floating_point()
                      else b.to(torch.int32) if b.dtype == torch.int64
                      else b for b in case["blks"]])
    row = dict(calls_checked=n, max_abs_err=max(err, cerr),
               wires=[str(b.dtype) for b in big["blks"]],
               **rd_multi_row(case, as32))
    emit("ring_dtypes", case="multi_fields",
         workload="sum/max(a int16), sum/min/prod(b int64), sum/max(c "
                  "float64) CB win=256 slide=64 keys=64, one "
                  "MultiFieldResidentExecutor",
         tuples=RD_MULTI_TUPLES, dispatches=dispatches,
         windows=int(sum(metas)), launches=launches,
         ring_append_multi_eval=row,
         phase_seconds=time.perf_counter() - t0)
    del case, as32
    return launches, row


def ring_dtypes_phase(wr, rk, builds):
    """Phase 25: int8, int16, int64 and float64 rings through the three
    fused ring kernels on their main paths ((a) sum_test on an int64 ring,
    (b) the max prefix on int64 and int8 rings, (c) three fields of int16,
    int64 and float64 rings in one launch), every recorded call against
    its plain version and twin, each kernel timed at the new dtype beside
    the same shape over int32 rings; and the cold build of the ring
    kernels' library.  Returns the launches of each run."""
    import windflow_tpu_torch as wt
    from windflow_tpu_torch.ops import _nvcc
    sum_launches, fused = rd_sum_test(wr, rk, wt)
    max_launches, evals = rd_max_prefixes(wr, rk, wt)
    multi_launches, multi = rd_multi_fields(rk)
    emit("ring_dtypes_rows", build_s=builds["resident.cu"][1],
         build_units_s=_nvcc.UNIT_SECONDS.get("resident"),
         ring_append_regular_sum=fused, ring_append_eval=evals,
         ring_append_multi_eval=multi)
    return {"sum_test_int64": sum_launches, **{
        f"max_{k}": v for k, v in max_launches.items()},
        "multi_fields": {"ring_append_multi_eval": multi_launches}}


# ---------------------------------------------------------- column dtypes

CD_U32_BASE = 2 ** 31 - 50       # (a): uint32 values 2**31 - 50 + i % 100
CD_F64_BASE = 1e9                # (b): 1e9 + u, u in [0, 1)
CD_F16_HI = 200                  # (c): float16 values in [0, 200)
CD_U64_HIGH = 5 << 32            # (c): uint64 values 5 * 2**32 + uint32's
CD_FN_BASE = 1 << 33             # (d): int64 values from 2**33
CD_MESH_ROWS = 1 << 20           # (e): a group's rows (phase 19: 2**24)
CD_MESH_LONG = 64                # (e): windows of N/64..N/8 rows
CD_MESH_DTYPES = (torch.uint32, torch.int64, torch.uint64, torch.float64)
CD_MESH_OPS = ("sum", "count", "min", "max", "prod", "mean")
#: the dtypes phase 26 adds to the four kernels
CD_NEW = (torch.uint32, torch.int64, torch.uint64, torch.float16,
          torch.float64)


def cd_stream(schema, n_tuples, values):
    """sum_test's keys and ids (make_stream's layout) with value
    ``values(i)`` for the i-th tuple of the stream (i = id * N_KEYS +
    key)."""
    from windflow_tpu_torch import batch_from_columns
    per_key = n_tuples // N_KEYS
    batches = []
    for at in range(0, per_key, CHUNK // N_KEYS):
        m = min(CHUNK // N_KEYS, per_key - at)
        ids = np.repeat(np.arange(at, at + m), N_KEYS)
        batches.append(batch_from_columns(
            schema, key=np.tile(np.arange(N_KEYS), m), id=ids, ts=ids,
            value=values(np.arange(at * N_KEYS, (at + m) * N_KEYS))))
    return batches


def cd_windows(v, ufunc, ident):
    """Every CB WIN/SLIDE window of one key's values `v` (the partial
    ones at the end included), folded by `ufunc` in v's dtype over blocks
    of SLIDE rows (a float sum: a block's pairwise sum, then WIN / SLIDE
    blocks)."""
    nb = -(-len(v) // SLIDE)
    padded = np.full(nb * SLIDE, ident, dtype=v.dtype)
    padded[:len(v)] = v
    blocks = ufunc.reduce(padded.reshape(nb, SLIDE), axis=1, dtype=v.dtype)
    ext = np.concatenate([blocks, np.full(WIN // SLIDE - 1, ident,
                                          dtype=v.dtype)])
    out = ext[:nb].copy()
    for k in range(1, WIN // SLIDE):
        out = ufunc(out, ext[k:k + nb])
    return out


def cd_oracle(batches, op, dtype):
    """{key: its windows' values}: the stream's values cast to `dtype`
    (as the device stages them), folded per key by cd_windows; with the
    windows' sums of |x| for a float sum."""
    vals = np.concatenate([b["value"] for b in batches]).astype(dtype)
    per_key = vals.reshape(-1, N_KEYS)
    ufunc = {"sum": np.add, "max": np.maximum}[op]
    dt = np.dtype(dtype)
    ident = (0 if op == "sum" else -np.inf if dt.kind == "f"
             else np.iinfo(dt).min)
    want = {k: cd_windows(per_key[:, k], ufunc, ident)
            for k in range(N_KEYS)}
    scale = ({k: cd_windows(np.abs(per_key[:, k].astype(np.float64)),
                            np.add, 0.0) for k in range(N_KEYS)}
             if dt.kind == "f" and op == "sum" else None)
    return want, scale


def cd_by_key(rows):
    """{key: its rows in id order} of a pipeline's row chunks."""
    rows = np.concatenate(rows)
    return {int(k): (lambda m: m[np.argsort(m["id"], kind="stable")])(
        rows[rows["key"] == k]) for k in np.unique(rows["key"])}


def cd_check_rows(rows, want, name, scale=None, rtol=0.0, f16=False):
    """The pipeline's rows per key in id order against the oracle: equal,
    or within rtol of the window's sum of |x| (`scale`), or (f16) within
    one float16 ulp of the oracle.  Returns the windows and the largest
    error."""
    keyed = cd_by_key(rows)
    err = 0.0
    for k, w in want.items():
        mine = keyed.get(k, np.zeros(0, rows[0].dtype))
        if not np.array_equal(mine["id"], np.arange(len(w))):
            raise AssertionError(f"column_dtypes {name}: key {k}'s ids")
        got = mine["value"]
        if scale is None and not f16:
            if not np.array_equal(got, w.astype(got.dtype)):
                bad = int(np.nonzero(got != w.astype(got.dtype))[0][0])
                raise AssertionError(
                    f"column_dtypes {name}: key {k} window {bad} gives "
                    f"{got[bad]}, the oracle {w[bad]}")
            continue
        e = np.abs(got.astype(np.float64) - w.astype(np.float64))
        tol = (np.spacing(np.abs(w).astype(np.float16)).astype(np.float64)
               if f16 else rtol * scale[k])
        if not bool((e <= tol).all()):
            raise AssertionError(f"column_dtypes {name}: key {k} error "
                                 f"{e.max()} beyond the bound")
        err = max(err, float(e.max()))
    return sum(len(m) for m in keyed.values()), err


@contextlib.contextmanager
def cd_recorded():
    """While active, every windowed_reduce and window_gather call of the
    restaging executor is kept (its device inputs), with the launches
    each made; the yielded dict holds them."""
    from windflow_tpu_torch.ops import device as dv
    seen = {"reduce": [], "gather": []}
    orig_r, orig_g = dv.windowed_reduce, dv.window_gather

    def reduce(flat, starts, lens, pad, op):
        out = orig_r(flat, starts, lens, pad, op)
        seen["reduce"].append(dict(flat=flat, starts=starts, lens=lens,
                                   pad=int(pad), op=op))
        return out

    def gather(bufs, rows, starts, lens, pad):
        out = orig_g(bufs, rows, starts, lens, pad)
        seen["gather"].append(dict(bufs=list(bufs), starts=starts,
                                   lens=lens, pad=int(pad)))
        return out

    dv.windowed_reduce, dv.window_gather = reduce, gather
    try:
        yield seen
    finally:
        dv.windowed_reduce, dv.window_gather = orig_r, orig_g


def cd_check_reduce(wr, c):
    """One recorded windowed_reduce call: the kernel again, bit for bit
    against its lane-order twin, and against the plain version (integers,
    count, min and max bit for bit; float16 within one float16 ulp;
    float64 sums within FLOAT64_RTOL of the window's sum of |x|).
    Returns the largest error against the plain version."""
    ev = [(c["flat"], c["op"])]
    d = (None, c["starts"], c["lens"], c["pad"])
    got = wr.windowed_reduce_many(ev, *d)[0]
    plain = wr.windowed_reduce_many_reference(ev, *d)[0]
    twin = wr.lane_order_twin(ev, *d)[0]
    torch.cuda.synchronize()
    name = f"windowed_reduce {c['op']}/{c['flat'].dtype}"
    if not torch.equal(bits(got), bits(twin)):
        raise AssertionError(f"{name}: the kernel differs from its twin")
    if not got.is_floating_point() or c["op"] in ("count", "min", "max"):
        if not torch.equal(bits(got), bits(plain)):
            raise AssertionError(f"{name}: the kernel differs from the "
                                 "plain version")
        return 0.0
    e = (got.double() - plain.double()).abs()
    if got.dtype == torch.float16:
        tol = torch.from_numpy(np.spacing(np.abs(
            plain.cpu().numpy()))).double().to(e.device)
    else:
        tol = FLOAT64_RTOL * wr.windowed_reduce_many_reference(
            [(c["flat"].double().abs(), "sum")], *d)[0]
    if not bool((e <= tol).all()):
        raise AssertionError(f"{name}: error {float(e.max())} beyond the "
                             "bound")
    return float(e.max())


def cd_as32(t):
    """`t` as the 4-byte dtype of its kind (the int32/float32
    instantiations the new ones are timed beside): uint32 as its int32
    words, other integers converted to int32, floats to float32."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32)
    if t.dtype == torch.uint64:
        return t.view(torch.int64).to(torch.int32)
    return t.to(torch.float32 if t.is_floating_point() else torch.int32)


def cd_timed(dev, fn, tensors):
    """(hot, cold) device ms of fn(*tensors): hot a graph replay on the
    same inputs, cold cycling through copies three times the L2."""
    hot = kernel_ms(lambda: fn(*tensors))
    copies = cold_copies(dev, tensors)
    cold = kernel_ms(cycled(copies, fn), reps=2 * len(copies))
    del copies
    return hot, cold


def cd_reduce_row(wr, c):
    """windowed_reduce at a recorded call (hot and cold) beside the same
    windows over the buffer as int32/float32 (cd_as32), each with its
    bytes bound."""
    dev = c["flat"].device
    st, ln, pad, op = c["starts"], c["lens"], c["pad"], c["op"]
    s, n = st.cpu().numpy().astype(np.int64), ln.cpu().numpy()
    cells = covered(s, np.minimum(n, pad))
    row = {}
    for label, flat in (("new", c["flat"]), ("as32", cd_as32(c["flat"]))):
        size = flat.element_size()
        nbytes = ((0 if op == "count" else cells * size) + 8 * len(s)
                  + size * len(s))
        b = bytes_bound(nbytes, 0 if op == "count" else int(n.sum()))
        hot, cold = cd_timed(dev, lambda f: wr.windowed_reduce(
            f, st, ln, pad, op), [flat])
        row[label] = dict(dtype=str(flat.dtype), ms=cold, hot_ms=hot,
                          bound_ms=b[0], bound_by=b[1], bound_bytes=nbytes)
    row["plain_ms"] = call_ms(lambda: wr.windowed_reduce_reference(
        c["flat"], st, ln, pad, op), reps=2)
    row.update(op=op, windows=len(s), pad=pad, cells=cells)
    return row


def cd_restaging(wr, wt):
    """(a)-(d): the restaging route at the new column dtypes, every
    window against a numpy oracle, every recorded kernel call against its
    plain version and twin.  Returns (launches by run, the largest
    windowed_reduce call of each new dtype, the largest gather call)."""
    from windflow_tpu_torch.ops import gather
    runs, big, gathers = {}, {}, []
    u32 = wt.Schema(value=np.uint32)

    def run(name, schema, batches, stage, tuples):
        t0 = time.perf_counter()
        wr.windowed_reduce.launches = 0
        gather.window_gather.launches = 0
        with cd_recorded() as seen:
            dt, n, _, rows = run_pipeline(stage, batches, schema, keep=True)
        runs[name] = {"windowed_reduce": wr.windowed_reduce.launches,
                      "window_gather": gather.window_gather.launches}
        new = [c for c in seen["reduce"] if c["flat"].dtype in CD_NEW]
        if len(new) != len(seen["reduce"]):
            raise AssertionError(f"column_dtypes {name}: a launch at "
                                 f"{[c['flat'].dtype for c in seen['reduce']]}")
        err = max([cd_check_reduce(wr, c) for c in new], default=0.0)
        for c in new:
            key = str(c["flat"].dtype)
            if key not in big or (c["flat"].numel() * c["starts"].numel()
                                  > big[key]["flat"].numel()
                                  * big[key]["starts"].numel()):
                big[key] = c
        gathers.extend(seen["gather"])
        runs[name].update(seconds=dt, tuples=tuples, calls_checked=len(new),
                          max_abs_err=err, wall_s=time.perf_counter() - t0)
        return rows

    def stage(reducer, **kw):
        return wt.WinSeqGPU(reducer, WIN, SLIDE, wt.WinType.CB,
                            batch_len=BATCH_LEN, device=DEVICE, **kw)

    # (a) uint32 at 2**31 +- 50: max (the Queue 3 fault) and the wrapping sum
    batches = cd_stream(u32, N_TUPLES,
                        lambda i: (CD_U32_BASE + i % 100).astype(np.uint32))
    for op in ("max", "sum"):
        rows = run(f"a_uint32_{op}", u32, batches, stage(
            wt.Reducer(op, dtype=np.int64), use_reduce_kernel=True),
            N_TUPLES)
        want, _ = cd_oracle(batches, op, np.uint32)
        runs[f"a_uint32_{op}"]["windows"], _ = cd_check_rows(
            rows, want, f"a uint32 {op}")
        if op == "max" and max(int(w.max()) for w in want.values()) < 2 ** 31:
            raise AssertionError("column_dtypes (a): no value past 2**31")
    del batches, rows
    # (b) a float sum's default route at float64: 1e9 + u
    f64 = wt.Schema(value=np.float64)
    rng = np.random.default_rng(26)
    u = rng.uniform(0, 1, N_TUPLES)
    batches = cd_stream(f64, N_TUPLES, lambda i: CD_F64_BASE + u[i])
    rows = run("b_float64_sum", f64, batches, stage(
        wt.Reducer("sum", dtype=np.float64), compute_dtype=np.float64),
        N_TUPLES)
    want, scale = cd_oracle(batches, "sum", np.float64)
    n, err = cd_check_rows(rows, want, "b float64 sum", scale, FLOAT64_RTOL)
    # the same stream staged in float32 lands far outside the bound
    narrow, _ = cd_oracle(batches, "sum", np.float32)
    off = max(float(np.abs(m["value"] - narrow[k]).max())
              for k, m in cd_by_key(rows).items())
    if off <= FLOAT64_RTOL * max(float(s.max()) for s in scale.values()):
        raise AssertionError("column_dtypes (b): the results equal a "
                             "float32 staging")
    runs["b_float64_sum"].update(windows=n, oracle_max_abs_err=err,
                                 float32_staging_max_abs_diff=off)
    del batches, rows, u
    # (c) 1M-tuple prefixes: int64 compute_dtype sums past 2**31, a
    # float16 column's sum and max, a uint64 column (narrowed to uint32)
    i64 = wt.Schema(value=np.int64)
    batches = cd_stream(i64, PREFIX_TUPLES,
                        lambda i: RD_BASE + (i * 7919) % 1000)
    rows = run("c_int64_sum", i64, batches, stage(
        wt.Reducer("sum"), use_reduce_kernel=True, compute_dtype=np.int64),
        PREFIX_TUPLES)
    want, _ = cd_oracle(batches, "sum", np.int64)
    runs["c_int64_sum"]["windows"], _ = cd_check_rows(rows, want,
                                                     "c int64 sum")
    if max(int(w.max()) for w in want.values()) <= 2 ** 31:
        raise AssertionError("column_dtypes (c): no int64 sum past 2**31")
    f16 = wt.Schema(value=np.float16)
    vals16 = rng.uniform(0, CD_F16_HI, PREFIX_TUPLES).astype(np.float16)
    batches = cd_stream(f16, PREFIX_TUPLES, lambda i: vals16[i])
    for op in ("sum", "max"):
        rows = run(f"c_float16_{op}", f16, batches, stage(
            wt.Reducer(op, dtype=np.float32), use_reduce_kernel=True),
            PREFIX_TUPLES)
        # the oracle: float32 window values, rounded to float16 once
        want, _ = cd_oracle(batches, op, np.float32)
        want = {k: w.astype(np.float16) for k, w in want.items()}
        runs[f"c_float16_{op}"]["windows"], e = cd_check_rows(
            rows, want, f"c float16 {op}", f16=op == "sum")
        runs[f"c_float16_{op}"]["oracle_max_abs_err"] = e
    u64 = wt.Schema(value=np.uint64)
    batches = cd_stream(u64, PREFIX_TUPLES, lambda i: (
        CD_U64_HIGH + CD_U32_BASE + i % 100).astype(np.uint64))
    rows = run("c_uint64_max", u64, batches, stage(
        wt.Reducer("max", dtype=np.int64), use_reduce_kernel=True),
        PREFIX_TUPLES)
    want, _ = cd_oracle(batches, "max", np.uint32)
    runs["c_uint64_max"]["windows"], _ = cd_check_rows(rows, want,
                                                      "c uint64 max")
    # (d) a user window function over an int64 compute_dtype column:
    # 8-byte tiles through window_gather
    tiles = []

    def fn(keys, gwids, cols, mask):
        tiles.append(cols["value"].dtype)
        return cols["value"].sum(dim=1)

    batches = cd_stream(i64, PREFIX_TUPLES,
                        lambda i: CD_FN_BASE + (i * 7919) % 1000)
    rows = run("d_fn_int64", i64, batches, stage(
        wt.TorchWindowFunction(fn, result_fields={"value": np.int64}),
        compute_dtype=np.int64), PREFIX_TUPLES)
    want, _ = cd_oracle(batches, "sum", np.int64)
    runs["d_fn_int64"]["windows"], _ = cd_check_rows(rows, want,
                                                    "d fn int64")
    if set(tiles) != {torch.int64} or not gathers:
        raise AssertionError(f"column_dtypes (d): tiles {set(tiles)}, "
                             f"{len(gathers)} gathers")
    for c in gathers:      # every gather call against its plain version
        got, mask = gather.window_gather(c["bufs"], None, c["starts"],
                                         c["lens"], c["pad"])
        want, wmask = gather.window_gather_reference(
            c["bufs"], None, c["starts"], c["lens"], c["pad"])
        if not (torch.equal(mask, wmask) and all(
                torch.equal(bits(a), bits(b)) for a, b in zip(got, want))):
            raise AssertionError("column_dtypes (d): window_gather differs "
                                 "from the plain version")
    runs["d_fn_int64"]["gather_calls_checked"] = len(gathers)
    return runs, big, max(gathers, key=lambda c: c["starts"].numel()
                          * c["pad"])


def cd_gather_row(c):
    """window_gather at the largest (d) call (hot and cold) beside the
    same windows over the buffer as int32, each with its bytes bound."""
    from windflow_tpu_torch.ops import gather
    st, ln, pad = c["starts"], c["lens"], c["pad"]
    B = st.numel()
    s, n = st.cpu().numpy().astype(np.int64), ln.cpu().numpy()
    cells = covered(s, np.minimum(n, pad))
    row = {}
    for label, buf in (("new", c["bufs"][0]), ("as32", cd_as32(
            c["bufs"][0]))):
        size = buf.element_size()
        nbytes = B * pad * (size + 1) + cells * size + 12 * B
        b = bytes_bound(nbytes, 0)
        hot, cold = cd_timed(buf.device, lambda x: gather.window_gather(
            [x], None, st, ln, pad), [buf])
        row[label] = dict(dtype=str(buf.dtype), ms=cold, hot_ms=hot,
                          bound_ms=b[0], bound_by=b[1], bound_bytes=nbytes)
    row["plain_ms"] = call_ms(lambda: gather.window_gather_reference(
        c["bufs"], None, st, ln, pad), reps=2)
    row.update(windows=B, pad=pad, cells=cells)
    return row


def cd_mesh_inputs(dtype, seed=27):
    """(flat, starts, lens) of (e): per group CD_MESH_ROWS rows (int32 in
    [-1000, 1000) for uint32, whose mapped negatives pass 2**31; int64 in
    [-2**40, 2**40) for the 64-bit dtypes, whose mapped negatives pass
    2**63 as uint64), pipe_test's CB windows, CD_MESH_LONG long windows
    across the sp boundary and MESH_PAST_N past N."""
    rng = np.random.default_rng(seed)
    kf, N = MESH_STEP_SHAPE[0], CD_MESH_ROWS
    half = N // MESH_STEP_SHAPE[2]
    if dtype == torch.uint32:
        flat = rng.integers(-1000, 1000, size=(kf, N)).astype(np.int32)
    else:
        flat = rng.integers(-2 ** 40, 2 ** 40, size=(kf, N))
    starts, lens = [], []
    for _ in range(kf):
        cb = np.arange(N // SLIDE) * SLIDE
        long_lens = rng.integers(N >> 6, N >> 3, CD_MESH_LONG)
        long_starts = half - rng.integers(1, long_lens)
        past = N - rng.integers(1, 200, MESH_PAST_N)
        starts.append(np.concatenate([cb, long_starts, past]))
        lens.append(np.concatenate([np.full(len(cb), WIN), long_lens,
                                    rng.integers(300, 5000, MESH_PAST_N)]))
    return (flat, np.stack(starts).astype(np.int32),
            np.stack(lens).astype(np.int32))


def cd_mesh_oracle(flat, starts, lens, rows, op, dtype):
    """numpy: per group the rows padded with zeros to `rows`, mapped
    (3v+1), filtered (v % 5 != 0) and cast to `dtype` (integers keep
    their low bits), each window's kept rows folded in that dtype (sums
    and products wrap); a CB window by its WIN / SLIDE blocks of SLIDE
    rows, any other alone; mean is the sum over max(count, 1) in float32
    (uint32) or float64.  Returns (values, the float tolerance's scale:
    the window's sum of |x| over its kept rows)."""
    np_dt = torch.empty(0, dtype=dtype).numpy().dtype
    with np.errstate(over="ignore", invalid="ignore"):
        return _cd_mesh_oracle(flat, starts, lens, rows, op, np_dt)


def _cd_mesh_oracle(flat, starts, lens, rows, op, np_dt):
    outs, scales = [], []
    for g in range(starts.shape[0]):
        v = np.zeros(rows, dtype=np.int64)
        v[:flat.shape[1]] = flat[g]
        v = 3 * v + 1
        kept = v % 5 != 0
        x = v.astype(np.float64) if np_dt.kind == "f" else v.astype(np_dt)
        s = np.clip(starts[g].astype(np.int64), 0, rows)
        e = np.clip(starts[g].astype(np.int64) + lens[g], 0, rows)
        csc = np.concatenate([[0], np.cumsum(kept)])
        cnt = csc[e] - csc[s]
        csa = np.concatenate([[0], np.cumsum(np.where(kept, np.abs(
            v.astype(np.float64)), 0))])
        scales.append(csa[e] - csa[s])
        if op == "count":
            outs.append(cnt.astype(np_dt))
            continue
        red = "sum" if op == "mean" else op
        ufunc = {"sum": np.add, "min": np.minimum, "max": np.maximum,
                 "prod": np.multiply}[red]
        ident = {"sum": 0, "prod": 1}.get(red)
        if ident is None:
            lim = (np.inf if np_dt.kind == "f" else
                   np.iinfo(np_dt).max if red == "min"
                   else np.iinfo(np_dt).min)
            ident = lim if red == "min" or np_dt.kind != "f" else -np.inf
        masked = np.where(kept, x, np.array(ident, dtype=x.dtype))
        pad = -len(masked) % SLIDE
        blocks = ufunc.reduce(np.concatenate(
            [masked, np.full(pad, ident, dtype=x.dtype)]).reshape(
                -1, SLIDE), axis=1, dtype=x.dtype)
        res = np.full(len(s), ident, dtype=x.dtype)
        full = (e - s == WIN) & (s % SLIDE == 0)
        first = s[full] // SLIDE
        acc = blocks[first]
        for k in range(1, WIN // SLIDE):
            acc = ufunc(acc, blocks[first + k])
        res[full] = acc
        for i in np.nonzero(~full & (e > s))[0]:
            res[i] = ufunc.reduce(masked[s[i]:e[i]], dtype=x.dtype)
        if op == "mean":
            f = np.float32 if np_dt.itemsize == 4 else np.float64
            res = res.astype(f) / np.maximum(cnt, 1).astype(f)
        outs.append(res)
    return np.stack(outs), np.stack(scales)


def cd_mesh():
    """(e) MeshStreamStep at pipe_test's chain over a (2, 2, 2) mesh of
    one card, at uint32, int64, uint64 and float64: every op, psum and
    ring, windows past mr.SPLIT, against the numpy oracle (integers,
    count, min and max bit for bit; float64 sums and means within
    FLOAT64_RTOL of the sum of |x|), every partial and merge call against
    its plain version and twin (checked_mesh_kernels).  Returns
    (launches, errors, the largest call of each dtype)."""
    from windflow_tpu_torch.parallel import MeshStreamStep, make_mesh
    kf, wf, sp = MESH_STEP_SHAPE
    mesh = make_mesh(kf, sp, devices=[DEVICE] * (kf * wf * sp), n_wf=wf)
    Ns = CD_MESH_ROWS // sp
    errs = {}
    with kernel_launches() as counts, checked_mesh_kernels() as seen:
        for dtype in CD_MESH_DTYPES:
            flat, starts, lens = cd_mesh_inputs(dtype)
            for op in CD_MESH_OPS:
                want, scale = cd_mesh_oracle(flat, starts, lens, Ns * sp,
                                             op, dtype)
                for collective in ("psum", "ring"):
                    got = MeshStreamStep(
                        mesh, op=op, dtype=dtype,
                        map_fn=lambda v: 3 * v + 1,
                        filter_fn=lambda v: v % 5 != 0,
                        collective=collective)(flat, starts, lens)
                    name = f"{op}/{str(dtype)[6:]}/{collective}"
                    if got.dtype != want.dtype:
                        raise AssertionError(f"column_dtypes mesh {name}: "
                                             f"dtype {got.dtype}")
                    if got.dtype.kind != "f" or op in ("count", "min",
                                                       "max"):
                        if not np.array_equal(got, want):
                            raise AssertionError(f"column_dtypes mesh "
                                                 f"{name}: differs from "
                                                 "the oracle")
                        errs[name] = 0.0
                        continue
                    with np.errstate(invalid="ignore"):
                        e = np.abs(got.astype(np.float64)
                                   - want.astype(np.float64))
                    e[got == want] = 0.0
                    tol = (FLOAT_RTOL if got.dtype == np.float32
                           else FLOAT64_RTOL) * (
                        scale / np.maximum(lens, 1) if op == "mean"
                        else np.abs(want) * lens if op == "prod"
                        else scale)
                    if not bool((e <= tol).all()):
                        raise AssertionError(f"column_dtypes mesh {name}: "
                                             f"error {e.max()}")
                    errs[name] = float(e.max())
    require_launches("column_dtypes mesh", counts,
                     ("sp_window_partial", "sp_merge"))
    if not any(k > 0 for k in seen["long_windows"]):
        raise AssertionError("column_dtypes mesh: no long-window call")
    return counts, errs, seen


def cd_mesh_rows(seen):
    """sp_window_partial and sp_merge at the largest call of each new
    dtype (the partial cold and hot, the merge hot, as phase 19 times
    them) beside the same inputs as int32/float32 (cd_as32), each with
    its bytes bound."""
    from windflow_tpu_torch.ops import mesh_reduce as mr
    rows = {"sp_window_partial": {}, "sp_merge": {}}
    for case, dtype, call in [
            (case, d, c) for case in ("partial_by_dtype",
                                      "partial_long_by_dtype")
            for d, c in seen[case].items()]:
        vals, keep, starts, lens, base, op, longw = call
        Ns, B = vals.numel(), starts.numel()
        s = np.clip(starts.cpu().numpy().astype(np.int64) - base, 0, Ns)
        e = np.clip(starts.cpu().numpy().astype(np.int64)
                    + lens.cpu().numpy() - base, 0, Ns)
        cells = covered(s, np.maximum(e - s, 0))
        row = {}
        for label, v in (("new", vals), ("as32", cd_as32(vals))):
            nbytes = (cells * (v.element_size() + 1) + 8 * B
                      + (v.element_size() + 4 * mr.needs_count(op)) * B)
            b = bytes_bound(nbytes, int(np.maximum(e - s, 0).sum()))
            hot, cold = cd_timed(v.device, lambda x, k: mr.sp_window_partial(
                x, k, starts, lens, base, op, long_windows=longw),
                [v, keep])
            row[label] = dict(dtype=str(v.dtype), ms=cold, hot_ms=hot,
                              bound_ms=b[0], bound_by=b[1],
                              bound_bytes=nbytes)
        row["plain_ms"] = call_ms(lambda: mr.sp_window_partial_reference(
            vals, keep, starts, lens, base, op), reps=2)
        row.update(op=op, Ns=Ns, windows=B, cells=cells,
                   long_windows=longw.numel())
        rows["sp_window_partial"][str(dtype) + (
            " long" if case == "partial_long_by_dtype" else "")] = row
    for dtype, call in seen["merge_by_dtype"].items():
        plist, parts, clist, cnts, op, ring, reduction = call
        n, B = parts.shape
        row = {}
        for label, p in (("new", parts), ("as32", cd_as32(parts))):
            size = p.element_size()
            nbytes = (size * n * B + (8 if op == "mean" and size == 8
                                      else size) * B
                      + (4 * n * B if op == "mean" else 0))
            b = bytes_bound(nbytes, (n - 1) * B)
            ps = list(p)
            row[label] = dict(dtype=str(p.dtype), ms=kernel_ms(
                lambda ps=ps: mr.sp_merge(ps, clist, op, ring=ring)),
                bound_ms=b[0], bound_by=b[1], bound_bytes=nbytes)
        row["plain_ms"] = call_ms(lambda: mr.sp_merge_reference(
            parts, cnts, op, ring))
        row.update(op=op, ring=ring, n_sp=n, windows=B)
        rows["sp_merge"][str(dtype)] = row
    return rows


def column_dtypes_phase(wr, builds):
    """Phase 26: the JAX package's column dtypes on the restaging route
    ((a) sum_test's 16M tuples as uint32 around 2**31 through max and
    sum, (b) 16M float64 1e9 + u through a float sum's default route,
    (c) 1M-tuple prefixes at int64, float16 and uint64, (d) a user
    function's 8-byte tiles) and in the mesh reduction ((e) the stream
    step at uint32, int64, uint64 and float64): every window against a
    numpy oracle, every recorded call of the four kernels against its
    plain version and twin, each kernel timed at its largest new-dtype
    call beside the same inputs at 4 bytes.  Returns the launches of each
    kernel at a new dtype."""
    import windflow_tpu_torch as wt
    t0 = time.perf_counter()
    runs, big, gather_call = cd_restaging(wr, wt)
    for name, run in runs.items():
        emit("column_dtypes", case=name, **run)
    mesh_counts, mesh_errs, seen = cd_mesh()
    emit("column_dtypes", case="e_mesh_step",
         workload="MeshStreamStep map 3v+1, filter v%5!=0, (kf, wf, sp) "
                  f"= {MESH_STEP_SHAPE} x {DEVICE}, {CD_MESH_ROWS} rows a "
                  "group", dtypes=[str(d) for d in CD_MESH_DTYPES],
         ops=list(CD_MESH_OPS), launches=mesh_counts,
         oracle_max_abs_err=mesh_errs,
         partial_calls_checked=seen["partials"],
         merge_calls_checked=seen["merges"],
         partial_twin_checks=seen["twins"],
         long_windows_per_call=dict(seen["long_windows"]))
    launches = {
        "windowed_reduce": sum(r["windowed_reduce"] for r in runs.values()),
        "window_gather": sum(r["window_gather"] for r in runs.values()),
        "sp_window_partial": mesh_counts["sp_window_partial"],
        "sp_merge": mesh_counts["sp_merge"]}
    rows = {"windowed_reduce": {k: cd_reduce_row(wr, c)
                                for k, c in big.items()},
            "window_gather": cd_gather_row(gather_call),
            **cd_mesh_rows(seen)}
    del big, gather_call, seen
    emit("column_dtypes_rows",
         build_s={k: builds[k][1] for k in ("windowed_reduce.cu",
                                             "gather.cu", "mesh_reduce.cu")},
         phase_seconds=time.perf_counter() - t0, **rows)
    return launches


# ------------------------------------------ unsigned and float16 rings

RU_U32_BASE = 2 ** 31 - 50       # (a): uint32 values 2**31 - 50 + i % 100
#: (b): (label, ring dtype, values lo..hi-1, the dtypes a value passes
#: through: the wire the ladder picks, then the ring)
RU_MAX_RUNS = (("uint32", np.uint32, 2 ** 31 - 1000, 2 ** 31 + 1000,
                (np.uint32,)),
               ("uint8", np.uint8, 200, 30_000, (np.int16, np.uint8)),
               ("uint16", np.uint16, 0, 100_000, (np.int32, np.uint16)))
RU_F16_HI = 4.0                  # (c): float32 values in [0, 4)
RU_MULTI_TUPLES = 1 << 20        # (d)
RU_MULTI_FLUSH = FLUSH_ROWS // N_KEYS
#: (d): the five fields' ring dtypes and value ranges
RU_MULTI = {"a": (np.uint8, 0, 300), "b": (np.uint16, 1, 4),
            "c": (np.uint32, 2 ** 31 - 1000, 2 ** 31 + 1000),
            "d": (np.uint64, 2 ** 63 - 1000, 2 ** 63 + 1000),
            "e": (np.float16, 0.0, RU_F16_HI)}
RU_MULTI_STATS = (("sum", "a"), ("max", "a"), ("min", "b"), ("prod", "b"),
                  ("sum", "c"), ("max", "c"), ("max", "d"), ("sum", "e"))
RU_MESH_DTYPES = (torch.int8, torch.int16, torch.uint8, torch.uint16,
                  torch.float16)
RU_MESH_ROWS = CD_MESH_ROWS      # (e): a group's rows, as phase 26


def ru_stream(schema, n_tuples, base):
    """sum_test's keys and ids with values base + i % 100, i the tuple's
    index in the stream."""
    from windflow_tpu_torch import batch_from_columns
    per_key = n_tuples // N_KEYS
    batches = []
    for at in range(0, per_key, CHUNK // N_KEYS):
        m = min(CHUNK // N_KEYS, per_key - at)
        ids = np.repeat(np.arange(at, at + m), N_KEYS)
        i = at * N_KEYS + np.arange(m * N_KEYS)
        batches.append(batch_from_columns(
            schema, key=np.tile(np.arange(N_KEYS), m), id=ids, ts=ids,
            value=base + i % 100))
    return batches


def ru_float_stream(schema, n_tuples, seed):
    """sum_test's keys and ids with float32 values in [0, RU_F16_HI)."""
    from windflow_tpu_torch import batch_from_columns
    rng = np.random.default_rng(seed)
    per_key = n_tuples // N_KEYS
    batches = []
    for at in range(0, per_key, CHUNK // N_KEYS):
        m = min(CHUNK // N_KEYS, per_key - at)
        ids = np.repeat(np.arange(at, at + m), N_KEYS)
        batches.append(batch_from_columns(
            schema, key=np.tile(np.arange(N_KEYS), m), id=ids, ts=ids,
            value=rng.uniform(0, RU_F16_HI, m * N_KEYS).astype(np.float32)))
    return batches


def ru_keyed(batches):
    """{key: its values in id order} of a stream."""
    vals = np.concatenate([b["value"] for b in batches])
    keys = np.concatenate([b["key"] for b in batches])
    order = np.argsort(keys, kind="stable")
    vals, keys = vals[order], keys[order]
    bounds = np.searchsorted(keys, np.arange(N_KEYS + 1))
    return {k: vals[bounds[k]:bounds[k + 1]] for k in range(N_KEYS)}


def ru_check_fused(calls, name):
    """ring_append_regular_sum against its plain version on every
    recorded call (check_ring: rings and integer sums bit for bit, float16
    sums bit for bit against the order twin and within F16_RTOL of the
    plain version), each over a seeded ring of its shape and dtype.
    Returns (calls checked, the largest error)."""
    from windflow_tpu_torch.ops import ring as rk
    gen = np.random.default_rng(6)
    err = 0.0
    for i, c in enumerate(calls):
        case = dict(ring=ae_values(gen, c["shape"], c["dtype"],
                                   False).to(c["blk"].device),
                    **{k: c[k] for k in ("blk", "offs", "rstart0", "rlen",
                                         "C", "slide")})
        if c["dtype"] == torch.float16:
            case["ring"] = (case["ring"].float() / 100).to(torch.float16)
        err = max(err, check_ring(rk, case, f"{name} call {i}"))
        del case
    return len(calls), err


def ru_as(dtype):
    """The 4-byte dtype a new ring dtype is timed beside: float32 for
    float16, else int32."""
    return torch.float32 if dtype.is_floating_point else torch.int32


def ru_fused_row(call):
    """ring_append_regular_sum (cold and hot) and ring_append (hot) at a
    recorded call's inputs over a seeded ring of its dtype and over one of
    ru_as(dtype), each beside its bytes bound."""
    from windflow_tpu_torch.ops import ring as rk
    gen = np.random.default_rng(6)
    row = {}
    dev = call["blk"].device
    for label, dtype in (("new", call["dtype"]),
                         ("as32", ru_as(call["dtype"]))):
        ring = ae_values(gen, call["shape"], dtype, False).to(dev)
        case = dict(ring=ring, **{k: call[k] for k in (
            "blk", "offs", "rstart0", "rlen", "C", "slide")})
        args = (case["blk"], case["offs"], case["rstart0"], case["rlen"],
                case["C"], case["slide"])
        b = fused_bound(case)
        blk, offs = case["blk"], case["offs"]
        row[label] = dict(
            acc=str(dtype),
            ms=rd_cold(dev, lambda r, args=args: rk.ring_append_regular_sum(
                r, *args), [ring]),
            hot_ms=kernel_ms(lambda ring=ring, args=args:
                             rk.ring_append_regular_sum(ring, *args)),
            bound_ms=b[0], bound_by=b[1], bound_bytes=b[2],
            append_ms=kernel_ms(lambda ring=ring: rk.ring_append(
                ring, blk, offs)),
            append_bound_ms=bytes_bound(
                blk.numel() * (blk.element_size() + ring.element_size())
                + 4 * offs.numel(), blk.numel())[0])
        del case, ring
    ring = ae_values(gen, call["shape"], call["dtype"], False).to(dev)
    row["plain_ms"] = call_ms(lambda: rk.ring_append_regular_sum_reference(
        ring, call["blk"], call["offs"], call["rstart0"], call["rlen"],
        call["C"], call["slide"]), reps=2)
    return row


def ru_eval_row(call):
    """ring_append_eval (cold) at a recorded call's inputs over a seeded
    ring of its dtype and of ru_as(dtype), each beside its bound."""
    from windflow_tpu_torch.ops import ring as rk
    gen = np.random.default_rng(8)
    row = {}
    for label, dtype in (("new", call["dtype"]),
                         ("as32", ru_as(call["dtype"]))):
        case = append_eval_call_case(dict(call, dtype=dtype), gen)
        dev = case["ring"].device
        long = case["long"].on(torch.from_numpy(case["long"].vec).to(dev))
        counters = torch.zeros(long.n + 1, dtype=torch.int32, device=dev)
        args = (case["blk"], case["offs"], case["ops"], case["rows"],
                case["starts"], case["lens"], case["pad"])
        b = append_eval_bound(case)
        row[label] = dict(
            acc=str(dtype), ms=rd_cold(dev, lambda r: rk.ring_append_eval(
                r, *args, long=long, counters=counters),
                [case["ring"].clone()]),
            bound_ms=b[0], bound_by=b[1], bound_bytes=b[2])
        if label == "new":
            row["plain_ms"] = call_ms(
                lambda: rk.ring_append_eval_reference(case["ring"], *args),
                reps=2)
        del case
    return row


def ru_sum_test(rk, wt):
    """(a) sum_test's 16M tuples through the resident route on a uint32
    ring, values 2**31 - 50 + i % 100 (shipped as an int32 wire that wraps;
    the ring wraps them back): every window against a numpy oracle of the
    sums modulo 2**32, the total, one fused launch a regular flush, every
    fused call checked; the fused kernel and ring_append timed at the
    largest call beside int32."""
    from windflow_tpu_torch.ops import resident
    from windflow_tpu_torch.patterns.native_core import NativeResidentCore
    schema = wt.Schema(value=np.int64)
    t0 = time.perf_counter()
    batches = ru_stream(schema, N_TUPLES, RU_U32_BASE)
    exact = rd_oracle_rows(batches, "sum")
    want = {k: w % 2 ** 32 for k, w in exact.items()}
    cores = []
    stage = stage_with_core(lambda: resident_stage(
        wt, wt.Reducer("sum"), device=DEVICE, compute_dtype=np.uint32),
        cores)
    resident.stats_snapshot(reset=True)
    with kernel_launches() as counts, recorded_fused() as calls:
        dt, n_windows, total, rows = run_pipeline(stage, batches, schema,
                                                  keep=True)
    stats = resident.stats_snapshot(reset=True)
    core = cores[0] if len(cores) == 1 else None
    if not (isinstance(core, NativeResidentCore) and core._delegate is None
            and core.executor.acc_dtype == np.uint32):
        raise AssertionError(f"ring_dtypes_u sum_test: the core is {cores}")
    windows = rd_check_rows(rows, want, "sum_test uint32")
    oracle = int(sum(int(w.sum()) for w in want.values()))
    wrapped = sum(int((w >= 2 ** 32).sum()) for w in exact.values())
    if total != oracle or not wrapped:
        raise AssertionError(f"ring_dtypes_u sum_test: total {total}, "
                             f"oracle {oracle}, wrapped windows {wrapped}")
    if not (counts["ring_append_regular_sum"] > 0
            and counts["ring_append"] == counts["windowed_reduce"] == 0
            and stats["dispatches"] == counts["ring_append_regular_sum"]
            + counts["ring_append_eval"]):
        raise AssertionError(f"ring_dtypes_u sum_test: launches {counts}, "
                             f"dispatches {stats['dispatches']}")
    wires = sorted({str(c["blk"].dtype) for c in calls})
    if "torch.int32" not in wires:
        raise AssertionError(f"ring_dtypes_u sum_test: wires {wires}")
    n, err = ru_check_fused(calls, "ring_dtypes_u sum_test uint32")
    big = max(calls, key=lambda c: c["blk"].numel() * c["C"])
    row = dict(calls_checked=n, max_abs_err=err, wire=str(big["blk"].dtype),
               **ru_fused_row(big))
    emit("ring_dtypes_u", case="a_sum_test_uint32",
         workload="sum_test CB win=256 slide=64 keys=64 resident, "
                  "compute_dtype=uint32, values 2**31-50 + i%100",
         tuples=N_TUPLES, seconds=dt, tuples_per_s=N_TUPLES / dt,
         windows=windows, total=total, oracle=oracle,
         wrapped_windows=wrapped, wires=wires, launches=counts,
         dispatches=stats["dispatches"], ring_append_regular_sum=row,
         phase_seconds=time.perf_counter() - t0)
    return counts, row


def ru_max_run(label, stage, batches, schema, cast, wire, rk):
    """One max prefix: the run's launches (irregular: ring_append_eval
    only), every window against the numpy oracle of the cast values, the
    wire shipped, every ring_append_eval call checked."""
    with kernel_launches() as counts, recorded_append_evals() as calls:
        _, n_dev, _, rows = run_pipeline(stage, batches, schema, keep=True)
    if not (counts["ring_append_eval"] > 0
            and counts["ring_append"] == counts["windowed_reduce"] == 0):
        raise AssertionError(f"ring_dtypes_u max {label}: launches {counts}")
    rd_check_rows(rows, rd_oracle_rows(batches, "max", cast), f"max {label}")
    wires = {c["blk"].dtype for c in calls}
    if wire not in wires:
        raise AssertionError(f"ring_dtypes_u max {label}: wires {wires}")
    n, err = check_append_evals(calls, f"ring_dtypes_u max {label}")
    return counts, calls, n_dev, dict(calls_checked=n, max_abs_err=err,
                                      wires=sorted(map(str, wires)))


def ru_max_prefixes(rk, wt):
    """(b) the 1M-tuple Reducer("max") prefix on uint32 (values that
    straddle 2**31: a signed compare would pick the smaller), uint8 (an
    int16 wire that wraps) and uint16 rings (an int32 wire that wraps),
    and on a uint32 ring over make_mesh(n_kf=4) of this card, each against
    a numpy oracle, every ring_append_eval call checked; the largest call
    of each ring timed beside int32."""
    from windflow_tpu_torch.parallel import make_mesh
    schema = wt.Schema(value=np.int64)
    out, launches = {}, {}
    for label, acc, lo, hi, cast in RU_MAX_RUNS:
        t0 = time.perf_counter()
        batches = rd_stream(schema, PREFIX_TUPLES, lo, hi, seed=10)
        wire = torch.int16 if acc == np.uint8 else torch.int32
        counts, calls, n_dev, row = ru_max_run(
            label, resident_stage(wt, wt.Reducer("max"), device=DEVICE,
                                  compute_dtype=acc),
            batches, schema, cast, wire, rk)
        big = max(calls, key=lambda c: (c["blk"].numel(),
                                        c["starts"].numel()))
        out[label] = dict(row, **ru_eval_row(big))
        launches[label] = counts
        emit("ring_dtypes_u", case=f"b_max_prefix_{label}",
             workload=f"Reducer('max') CB win=256 slide=64 keys=64, "
                      f"compute_dtype={label}, values {lo}..{hi - 1}",
             tuples=PREFIX_TUPLES, windows=n_dev, launches=counts,
             ring_append_eval=out[label],
             phase_seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    label, acc, lo, hi, cast = RU_MAX_RUNS[0]
    batches = rd_stream(schema, PREFIX_TUPLES, lo, hi, seed=11)
    mesh = make_mesh(MESH_KF, devices=[DEVICE] * MESH_KF)
    stage = wt.WinSeqGPU(wt.Reducer("max"), WIN, SLIDE, wt.WinType.CB,
                         batch_len=BATCH_LEN, flush_rows=FLUSH_ROWS,
                         depth=DEPTH, shards=1, mesh=mesh,
                         compute_dtype=acc)
    counts, calls, n_dev, row = ru_max_run("uint32 mesh", stage, batches,
                                           schema, cast, torch.int32, rk)
    if counts["ring_append_eval"] < MESH_KF:
        raise AssertionError(f"ring_dtypes_u max uint32 mesh: launches "
                             f"{counts}")
    launches["uint32_mesh"] = counts
    emit("ring_dtypes_u", case="b_max_prefix_uint32_mesh",
         workload=f"Reducer('max') CB win=256 slide=64 keys=64, "
                  f"compute_dtype=uint32, make_mesh(n_kf={MESH_KF}) of "
                  f"{DEVICE}", tuples=PREFIX_TUPLES, windows=n_dev,
         launches=counts, ring_append_eval=row,
         phase_seconds=time.perf_counter() - t0)
    return launches, out


def ru_float16(rk, wt):
    """(c) float16 rings: the 1M-tuple Reducer("max") prefix and a float
    sum opted onto the resident route (use_resident=True; JAX's routing
    keeps float sums off it by default), float32 values in [0, 4) rounded
    into the ring, on the Python resident core (ring_append_eval, as the
    native core ships int64 columns only); and an integer sum of values
    0..3 on the native core (int8 wires into the float16 ring, regular
    flushes: ring_append_regular_sum), whose window sums are exact.  max
    exact; every float sum within one float16 ulp of the float64 sum of
    the ring's cells (the stated rule); every call checked (float16 bit
    for bit against the order twins); the largest call of each kernel
    timed beside float32."""
    fschema = wt.Schema(value=np.float32)
    fbatches = ru_float_stream(fschema, PREFIX_TUPLES, seed=12)
    ischema = wt.Schema(value=np.int64)
    ibatches = rd_stream(ischema, PREFIX_TUPLES, 0, 4, seed=13)
    out, launches = {}, {}
    runs = (("max", np.float32, fschema, fbatches, recorded_append_evals,
             "ring_append_eval", dict(use_resident=True)),
            ("sum", np.float32, fschema, fbatches, recorded_append_evals,
             "ring_append_eval", dict(use_resident=True)),
            ("sum", np.int64, ischema, ibatches, recorded_fused,
             "ring_append_regular_sum", {}))
    for op, col, schema, batches, record, kernel, kw in runs:
        label = f"{op}_{np.dtype(col).name}"
        t0 = time.perf_counter()
        cells = {k: v.astype(np.float16).astype(np.float64)
                 for k, v in ru_keyed(batches).items()}
        stage = resident_stage(wt, wt.Reducer(op, dtype=col), device=DEVICE,
                               compute_dtype=np.float16, **kw)
        with kernel_launches() as counts, record() as calls:
            _, n_dev, _, rows = run_pipeline(stage, batches, schema,
                                             keep=True)
        if not counts[kernel] or any(
                counts[k] for k in ("ring_append", "windowed_reduce")):
            raise AssertionError(f"ring_dtypes_u float16 {label}: launches "
                                 f"{counts}")
        rows = np.concatenate(rows)
        worst = 0.0
        for k, v in cells.items():
            mine = rows[rows["key"] == k]
            s = np.arange(0, len(v), SLIDE)
            e = np.minimum(s + WIN, len(v))
            if not np.array_equal(mine["id"], np.arange(len(s))):
                raise AssertionError(f"ring_dtypes_u float16 {label}: key "
                                     f"{k}'s windows")
            if op == "max":
                want = np.array([v[a:b].max() for a, b in zip(s, e)])
            else:
                c = np.concatenate([[0.0], np.cumsum(v)])
                want = c[e] - c[s]
            ulp = np.spacing(np.abs(want.astype(np.float16))).astype(
                np.float64)
            d = np.abs(mine["value"].astype(np.float64) - want)
            exact = op == "max" or col == np.int64
            if not bool((d == 0).all() if exact else (d <= ulp).all()):
                raise AssertionError(f"ring_dtypes_u float16 {label}: key "
                                     f"{k} off by {d.max()}")
            worst = max(worst, float((d / ulp).max()))
        if kernel == "ring_append_eval":
            n, err = check_append_evals(calls,
                                        f"ring_dtypes_u float16 {label}")
            big = max(calls, key=lambda c: (c["blk"].numel(),
                                            c["starts"].numel()))
            row = dict(calls_checked=n, max_abs_err=err,
                       oracle_max_ulps=worst, **ru_eval_row(big))
        else:
            n, err = ru_check_fused(calls, f"ring_dtypes_u float16 {label}")
            big = max(calls, key=lambda c: c["blk"].numel() * c["C"])
            row = dict(calls_checked=n, max_abs_err=err,
                       oracle_max_ulps=worst, wire=str(big["blk"].dtype),
                       **ru_fused_row(big))
        out[label] = row
        launches[label] = counts
        emit("ring_dtypes_u", case=f"c_float16_{label}",
             workload=f"Reducer('{op}', {np.dtype(col).name}) CB win=256 "
                      f"slide=64 keys=64, compute_dtype=float16"
                      + (", use_resident=True, values in [0, 4)"
                         if kw else ", values 0..3"),
             tuples=PREFIX_TUPLES, windows=n_dev, launches=counts,
             **{kernel: row}, phase_seconds=time.perf_counter() - t0)
    return launches, out


def ru_multi_fields(rk):
    """(d) the five new ring dtypes as the fields of one
    MultiFieldResidentExecutor (uint8 fed an int16 wire that wraps,
    uint16, uint32 and uint64 values past 2**31 and 2**63 on signed wires
    that wrap, float16 from float32): 8 stats, one ring_append_multi_eval
    launch (multi_eval_kernel<true>) a dispatch over RU_MULTI_TUPLES
    tuples of 64 keys, every window against a numpy oracle (integer sums
    and products wrap in the ring or product dtype; the float16 sum
    within one float16 ulp of the float64 sum of the ring's cells), every
    call checked; the largest call timed beside the same shape over int32
    and float32 rings."""
    from windflow_tpu_torch.ops.resident import MultiFieldResidentExecutor
    t0 = time.perf_counter()
    rng = np.random.default_rng(15)
    per_key = RU_MULTI_TUPLES // N_KEYS
    cols = {}
    for f, (acc, lo, hi) in RU_MULTI.items():
        if np.dtype(acc).kind == "f":
            cols[f] = rng.uniform(lo, hi, (N_KEYS, per_key)).astype(
                np.float32)
        else:
            cols[f] = rng.integers(lo, hi, (N_KEYS, per_key),
                                   dtype=np.uint64).astype(
                np.uint64 if acc == np.uint64 else np.int64)
    accs = {f: acc for f, (acc, _lo, _hi) in RU_MULTI.items()}
    ex = MultiFieldResidentExecutor(tuple(RU_MULTI), RU_MULTI_STATS,
                                    acc_dtypes=accs, device=DEVICE)
    cap = 1 << (per_key - 1).bit_length()
    ex.reset(N_KEYS, cap)
    rk.ring_append_multi_eval.launches = 0
    done, first, dispatches, metas = 0, 0, 0, []
    with recorded_multi_evals() as calls:
        for end in range(RU_MULTI_FLUSH, per_key + 1, RU_MULTI_FLUSH):
            last = (end - WIN) // SLIDE
            idx = np.arange(first, last + 1)
            first = last + 1
            rows = np.repeat(np.arange(N_KEYS), len(idx))
            starts = np.tile(idx * SLIDE, N_KEYS)
            blks = {}
            for f in cols:
                blk = cols[f][:, done:end]
                blks[f] = blk.astype(ex.narrow_for(f, blk.ravel()))
            ex.launch((rows, starts), blks, np.full(N_KEYS, done), rows,
                      starts, np.full(len(rows), WIN))
            metas.append(len(rows))
            dispatches += 1
            done = end
        ready = ex.drain()
    launches = rk.ring_append_multi_eval.launches
    if launches != dispatches:
        raise AssertionError(f"ring_dtypes_u multi: {launches} launches for "
                             f"{dispatches} dispatches")
    wires = {str(b.dtype) for c in calls for b in c["blks"]}
    worst = 0.0
    for (rows, starts), outs in ready:
        for (op, f), got in zip(RU_MULTI_STATS, outs):
            cells = cols[f][rows[:, None], starts[:, None]
                            + np.arange(WIN)[None, :]]
            if f == "e":
                v = cells.astype(np.float16).astype(np.float64)
                exact = v.sum(axis=1)
                ulp = np.spacing(np.abs(exact.astype(np.float16))).astype(
                    np.float64)
                d = np.abs(got.astype(np.float64) - exact)
                if not bool((d <= ulp).all()):
                    raise AssertionError(f"ring_dtypes_u multi sum(e): off "
                                         f"by {d.max()}")
                worst = max(worst, float((d / ulp).max()))
                continue
            acc = accs[f]
            cells = cells.astype(acc)
            with np.errstate(over="ignore"):
                want = {"sum": lambda x: x.sum(axis=1, dtype=acc),
                        "max": lambda x: x.max(axis=1),
                        "min": lambda x: x.min(axis=1),
                        "prod": lambda x: x.prod(axis=1, dtype=np.uint32)
                        }[op](cells)
            if not (got.dtype == want.dtype and np.array_equal(got, want)):
                raise AssertionError(f"ring_dtypes_u multi {op}({f}) "
                                     "differs from the numpy oracle")
    n, cerr = check_multi_evals(calls, "ring_dtypes_u multi")
    big = max(calls, key=lambda c: c["starts"].numel())
    case = multi_eval_call_case(big, np.random.default_rng(8))

    def as32(r):
        if r.dtype == torch.float16:
            return r.float()
        return r.view(_SAME_SIZE_INT[r.element_size()]).to(torch.int32)
    as32_case = dict(case, rings=[as32(r) for r in case["rings"]],
                     blks=[b.to(torch.int32) if b.dtype == torch.int64
                           else b for b in case["blks"]])
    row = dict(calls_checked=n, max_abs_err=cerr, oracle_max_ulps=worst,
               wires=sorted(wires), **rd_multi_row(case, as32_case))
    row["plain_ms"] = call_ms(lambda: rk.ring_append_multi_eval_reference(
        [r.clone() for r in case["rings"]], case["blks"], case["offs"],
        case["evals"], case["rows"], case["starts"], case["lens"],
        case["pad"], case["tile_fields"]), reps=2)
    emit("ring_dtypes_u", case="d_multi_fields",
         workload="sum/max(a uint8), min/prod(b uint16), sum/max(c "
                  "uint32), max(d uint64), sum(e float16) CB win=256 "
                  "slide=64 keys=64, one MultiFieldResidentExecutor",
         tuples=RU_MULTI_TUPLES, dispatches=dispatches,
         windows=int(sum(metas)), launches=launches,
         ring_append_multi_eval=row, phase_seconds=time.perf_counter() - t0)
    del case, as32_case
    return launches, row


def ru_mesh_inputs(dtype, seed=29):
    """(flat, starts, lens) of (e): per group RU_MESH_ROWS rows (int32 in
    [-100000, 100000) for the integers, which wrap in the cast; float32 in
    [-0.6, 0) for float16, so that 3v+1 stays in (-0.8, 1] and products
    shrink), pipe_test's CB windows, CD_MESH_LONG long windows across the
    sp boundary and MESH_PAST_N past N (phase 26's windows)."""
    flat, starts, lens = cd_mesh_inputs(torch.uint32, seed)
    rng = np.random.default_rng(seed)
    if dtype == torch.float16:
        flat = rng.uniform(-0.6, 0.0, flat.shape).astype(np.float32)
    else:
        flat = rng.integers(-100_000, 100_000, flat.shape).astype(np.int32)
    return flat, starts, lens


def ru_mesh_oracle(flat, starts, lens, rows, op, dtype):
    """numpy, JAX's semantics of the stream step at `dtype`: per group the
    rows padded with zeros to `rows`, mapped (3v+1, in int32 or float32),
    filtered (v % 5 != 0) and cast to the dtype (integers wrap, floats
    round to float16); a sum or product of 1- or 2-byte integers folds in
    int32 or uint32, min and max in the dtype, count converted to it;
    mean is the float32 sum over max(count, 1) wrapped into the dtype.
    float16 in float64 (the checks allow the float16 rounding), but for
    count, whose float16 shard counts and psum the oracle rounds as JAX
    does (at 2 sp shards).  Returns
    (values, the windows' sum of |x| over their kept rows)."""
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        return _ru_mesh_oracle(flat, starts, lens, rows, op, dtype)


def _ru_mesh_oracle(flat, starts, lens, rows, op, dtype):
    np_dt = np.dtype(torch.empty(0, dtype=dtype).numpy().dtype)
    half = np_dt == np.float16
    held = {np.dtype(np.int8): np.int32, np.dtype(np.int16): np.int32,
            np.dtype(np.uint8): np.uint32,
            np.dtype(np.uint16): np.uint32}.get(np_dt, np.float64)
    outs, scales = [], []
    for g in range(starts.shape[0]):
        v = np.zeros(rows, dtype=np.float32 if half else np.int32)
        v[:flat.shape[1]] = flat[g]
        v = (3 * v + 1).astype(v.dtype)
        kept = v % 5 != 0
        x = (v.astype(np.float16).astype(np.float64) if half
             else v.astype(np_dt))
        s = np.clip(starts[g].astype(np.int64), 0, rows)
        e = np.clip(starts[g].astype(np.int64) + lens[g], 0, rows)
        csc = np.concatenate([[0], np.cumsum(kept)])
        cnt = csc[e] - csc[s]
        csa = np.concatenate([[0.0], np.cumsum(np.where(
            kept, np.abs(x.astype(np.float64)), 0.0))])
        scales.append(csa[e] - csa[s])
        if op == "count" and half:
            # each sp shard's count rounded to float16, then JAX's psum of
            # float16 values in shard order (the ring's is the same at 2)
            n_sp = MESH_STEP_SHAPE[2]
            Ns = rows // n_sp
            acc = None
            for sh in range(n_sp):
                lo = np.clip(s, sh * Ns, (sh + 1) * Ns)
                hi = np.clip(e, sh * Ns, (sh + 1) * Ns)
                c = (csc[hi] - csc[lo]).astype(np.float16)
                acc = c if acc is None else (
                    acc.astype(np.float32) + c.astype(np.float32)).astype(
                        np.float16)
            outs.append(acc)
            continue
        if op == "count":
            outs.append(cnt.astype(np_dt))
            continue
        red = "sum" if op == "mean" else op
        fold = (np.float64 if half else
                held if red in ("sum", "prod") else np_dt)
        xf = x.astype(fold)
        ufunc = {"sum": np.add, "min": np.minimum, "max": np.maximum,
                 "prod": np.multiply}[red]
        if red in ("sum", "prod"):
            ident = 0 if red == "sum" else 1
        elif half:
            ident = np.inf if red == "min" else -np.inf
        else:
            ident = (np.iinfo(np_dt).max if red == "min"
                     else np.iinfo(np_dt).min)
        masked = np.where(kept, xf, np.array(ident, dtype=fold))
        res = np.full(len(s), ident, dtype=fold)
        pad = -len(masked) % SLIDE
        blocks = ufunc.reduce(np.concatenate(
            [masked, np.full(pad, ident, dtype=fold)]).reshape(
                -1, SLIDE), axis=1, dtype=fold)
        full = (e - s == WIN) & (s % SLIDE == 0)
        first = s[full] // SLIDE
        acc = blocks[first]
        for k in range(1, WIN // SLIDE):
            acc = ufunc(acc, blocks[first + k])
        res[full] = acc
        for i in np.nonzero(~full & (e > s))[0]:
            res[i] = ufunc.reduce(masked[s[i]:e[i]], dtype=fold)
        if op == "mean":
            d = np.maximum(cnt, 1)
            if half:
                res = res / d.astype(np.float16).astype(np.float64)
            else:
                res = (res.astype(np.float32)
                       / d.astype(np_dt).astype(np.float32))
        elif not half and red in ("min", "max"):
            res = res.astype(np_dt)
        outs.append(res)
    return np.stack(outs), np.stack(scales)


def ru_mesh():
    """(e) MeshStreamStep at pipe_test's chain over a (2, 2, 2) mesh of
    one card at int8, int16, uint8, uint16 and float16: every op, psum and
    ring, windows past mr.SPLIT, against the numpy oracle (integers,
    counts, min and max bit for bit, JAX's dtypes; float16 sums, means
    and products within two float16 ulps plus 2**-12 of the window's sum
    of |x|), every partial and merge call against its plain version and
    twin (checked_mesh_kernels).  Returns (launches, errors, the largest
    call of each dtype)."""
    from windflow_tpu_torch.ops import mesh_reduce as mr
    from windflow_tpu_torch.parallel import MeshStreamStep, make_mesh
    kf, wf, sp = MESH_STEP_SHAPE
    mesh = make_mesh(kf, sp, devices=[DEVICE] * (kf * wf * sp), n_wf=wf)
    Ns = RU_MESH_ROWS // sp
    errs = {}
    with kernel_launches() as counts, checked_mesh_kernels() as seen:
        for dtype in RU_MESH_DTYPES:
            flat, starts, lens = ru_mesh_inputs(dtype)
            for op in CD_MESH_OPS:
                want, scale = ru_mesh_oracle(flat, starts, lens, Ns * sp,
                                             op, dtype)
                for collective in ("psum", "ring"):
                    got = MeshStreamStep(
                        mesh, op=op, dtype=dtype,
                        map_fn=lambda v: 3 * v + 1,
                        filter_fn=lambda v: v % 5 != 0,
                        collective=collective)(flat, starts, lens)
                    name = f"{op}/{str(dtype)[6:]}/{collective}"
                    out = mr.merge_out(op, dtype)
                    if got.dtype != torch.empty(0, dtype=out).numpy().dtype:
                        raise AssertionError(f"ring_dtypes_u mesh {name}: "
                                             f"dtype {got.dtype}")
                    if dtype != torch.float16 or op in ("count", "min",
                                                        "max"):
                        same = got == want.astype(got.dtype)
                        if got.dtype.kind == "f":
                            same |= np.isnan(got) & np.isnan(
                                want.astype(got.dtype))
                        if not bool(same.all()):
                            raise AssertionError(f"ring_dtypes_u mesh "
                                                 f"{name}: differs from "
                                                 "the oracle")
                        errs[name] = 0.0
                        continue
                    g = got.astype(np.float64)
                    with np.errstate(invalid="ignore", over="ignore"):
                        w16 = want.astype(np.float16)
                        ulp = np.spacing(np.abs(w16)).astype(np.float64)
                        e = np.abs(g - want)
                        e[(g == w16) | (np.isnan(g) & np.isnan(want))] = 0.0
                        tol = 2 * ulp + 2.0 ** -12 * (
                            scale / np.maximum(lens, 1) if op == "mean"
                            else np.abs(want) * lens if op == "prod"
                            else scale)
                    if not bool((e <= tol).all()):
                        raise AssertionError(f"ring_dtypes_u mesh {name}: "
                                             f"error {e.max()}")
                    errs[name] = float(e.max())
    require_launches("ring_dtypes_u mesh", counts,
                     ("sp_window_partial", "sp_merge"))
    if not any(k > 0 for k in seen["long_windows"]):
        raise AssertionError("ring_dtypes_u mesh: no long-window call")
    return counts, errs, seen


def ru_mesh_rows(seen):
    """sp_window_partial (cold and hot; a 1- or 2-byte integer through
    the wrapper, its widening copy included, and that copy alone) and
    sp_merge (hot) at the largest call of each new dtype, beside the same
    inputs as int32 or float32 (cd_as32), each with its bytes bound."""
    from windflow_tpu_torch.ops import mesh_reduce as mr
    rows = {"sp_window_partial": {}, "sp_merge": {}}
    for dtype, call in seen["partial_by_dtype"].items():
        if dtype not in RU_MESH_DTYPES:
            continue
        vals, keep, starts, lens, base, op, longw = call
        Ns, B = vals.numel(), starts.numel()
        s = np.clip(starts.cpu().numpy().astype(np.int64) - base, 0, Ns)
        e = np.clip(starts.cpu().numpy().astype(np.int64)
                    + lens.cpu().numpy() - base, 0, Ns)
        cells = covered(s, np.maximum(e - s, 0))
        row = {}
        for label, v in (("new", vals), ("as32", cd_as32(vals))):
            out = mr.partial_dtype(op, v.dtype)
            nbytes = (cells * (v.element_size() + 1) + 8 * B
                      + (torch.empty(0, dtype=out).element_size()
                         + 4 * mr.needs_count(op)) * B)
            b = bytes_bound(nbytes, int(np.maximum(e - s, 0).sum()))
            hot, cold = cd_timed(v.device, lambda x, k: mr.sp_window_partial(
                x, k, starts, lens, base, op, long_windows=longw),
                [v, keep])
            row[label] = dict(dtype=str(v.dtype), ms=cold, hot_ms=hot,
                              bound_ms=b[0], bound_by=b[1],
                              bound_bytes=nbytes)
        if vals.dtype in mr._HELD:
            row["widen_copy_ms"] = kernel_ms(lambda: mr._widened(vals))
        row["plain_ms"] = call_ms(lambda: mr.sp_window_partial_reference(
            vals, keep, starts, lens, base, op), reps=2)
        row.update(op=op, Ns=Ns, windows=B, cells=cells,
                   long_windows=longw.numel())
        rows["sp_window_partial"][str(dtype)] = row
    for dtype, call in seen["merge_by_dtype"].items():
        if dtype not in RU_MESH_DTYPES:
            continue
        plist, parts, clist, cnts, op, ring, reduction = call
        n, B = parts.shape
        row = {}
        for label, p, d in (("new", parts, reduction),
                            ("as32", cd_as32(parts), None)):
            size = p.element_size()
            nbytes = (size * n * B + size * B
                      + (4 * n * B if op == "mean" else 0))
            b = bytes_bound(nbytes, (n - 1) * B)
            ps = list(p)
            row[label] = dict(dtype=str(p.dtype), ms=kernel_ms(
                lambda ps=ps, d=d: mr.sp_merge(ps, clist, op, ring=ring,
                                               dtype=d)),
                bound_ms=b[0], bound_by=b[1], bound_bytes=nbytes)
        if dtype in mr._HELD:
            # a max merge: the 1- or 2-byte partials widened, merged, cast
            # back (sum's partials are int32 already), beside int32's
            narrow = [mr._cast_back(p, dtype) for p in parts]
            wide = list(cd_as32(parts))
            row["max_ms"] = kernel_ms(lambda: mr.sp_merge(
                narrow, None, "max", ring=ring, dtype=dtype))
            row["max_as32_ms"] = kernel_ms(lambda: mr.sp_merge(
                wide, None, "max", ring=ring))
        row["plain_ms"] = call_ms(lambda: mr.sp_merge_reference(
            parts, cnts, op, ring, reduction))
        row.update(op=op, ring=ring, n_sp=n, windows=B)
        rows["sp_merge"][str(dtype)] = row
    return rows


def ring_dtypes_u_phase(rk, builds):
    """Phase 27: unsigned and float16 rings through the four ring kernels
    ((a) sum_test's 16M tuples on a uint32 ring, (b) the max prefix on
    uint32, uint8 and uint16 rings and on a uint32 kf mesh, (c) float16
    max and sum, (d) five fields of the five new ring dtypes in one
    per-field launch a dispatch) and the mesh reduction at int8, int16,
    uint8, uint16 and float16 ((e) the stream step): every window against
    a numpy oracle, every recorded call of the six kernels against its
    plain version and twin, each kernel timed at the new dtype beside the
    same inputs at int32 or float32.  Returns each kernel's launches at
    the new dtypes."""
    import windflow_tpu_torch as wt
    from windflow_tpu_torch.ops import _nvcc
    t0 = time.perf_counter()
    sum_counts, fused = ru_sum_test(rk, wt)
    max_counts, evals = ru_max_prefixes(rk, wt)
    f16_counts, f16 = ru_float16(rk, wt)
    multi_launches, multi = ru_multi_fields(rk)
    mesh_counts, mesh_errs, seen = ru_mesh()
    emit("ring_dtypes_u", case="e_mesh_step",
         workload="MeshStreamStep map 3v+1, filter v%5!=0, (kf, wf, sp) "
                  f"= {MESH_STEP_SHAPE} x {DEVICE}, {RU_MESH_ROWS} rows a "
                  "group", dtypes=[str(d) for d in RU_MESH_DTYPES],
         ops=list(CD_MESH_OPS), launches=mesh_counts,
         oracle_max_abs_err=mesh_errs,
         partial_calls_checked=seen["partials"],
         merge_calls_checked=seen["merges"],
         partial_twin_checks=seen["twins"],
         long_windows_per_call=dict(seen["long_windows"]))
    launches = {
        "ring_append_regular_sum": sum_counts["ring_append_regular_sum"]
        + f16_counts["sum_int64"]["ring_append_regular_sum"],
        "ring_append_eval": sum(c["ring_append_eval"]
                                for c in (*max_counts.values(),
                                          f16_counts["max_float32"],
                                          f16_counts["sum_float32"])),
        "ring_append_multi_eval": multi_launches,
        "sp_window_partial": mesh_counts["sp_window_partial"],
        "sp_merge": mesh_counts["sp_merge"]}
    rows = dict(ring_append_regular_sum={"uint32": fused,
                                         "float16": f16["sum_int64"]},
                ring_append_eval={**evals,
                                  "float16 max": f16["max_float32"],
                                  "float16 sum": f16["sum_float32"]},
                ring_append_multi_eval=multi, **ru_mesh_rows(seen))
    del seen
    emit("ring_dtypes_u_rows", build_s=builds["resident.cu"][1],
         build_units_s=_nvcc.UNIT_SECONDS.get("resident"),
         mesh_build_s=builds["mesh_reduce.cu"][1],
         phase_seconds=time.perf_counter() - t0, **rows)
    return launches


def child_main(argv) -> int:
    """Entry of the plane phase's child processes."""
    role, args = argv[0], argv[1:]
    return {"plane": plane_child, "feeder": feeder_child,
            "worker": worker_child}[role](*args)


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
    from windflow_tpu_torch.ops import _nvcc
    builds = build_all()
    for name, (out, sec) in builds.items():
        emit("build", source=name, seconds=sec,
             library=out if isinstance(out, str) else out._name,
             units=_nvcc.UNIT_SECONDS.get("resident")
             if name == "resident.cu" else None)

    dev = torch.device(DEVICE)
    row = kernel_phase(wr, dev)
    rows = ring_kernel_phase(dev)
    big_ring_phase(wr)
    ae_rows = append_eval_phase(dev)
    mae_rows = multi_append_eval_phase(dev)
    restaging_launches = end_to_end(wr)
    resident_launches = end_to_end_resident(wr, rk)
    irregular_and_python_core(wr, rk)
    gather_row = gather_phase(dev)
    skyline_row = skyline_phase(dev)
    spatial_launches, sp_restaging, spatial_calls = spatial_phases(wr, rk)
    rows["ring_append"] = ring_append_phase(dev, rectangles_of(spatial_calls))
    mae_row = multi_eval_row(spatial_calls, "spatial_resident")
    del spatial_calls
    spatial_app()
    multi_launches = multi_field_native(wr, rk)

    # the new paths: each kernel's launches on them, and each of the two
    # resident kernels these paths run launched at least once
    ysb_rows = {}
    new_paths = {"ysb_deterministic": ysb_deterministic(),
                 "ysb_timed": ysb_timed(timing=ysb_rows),
                 "pipe_test": pipe_test(),
                 "two_stage": two_stage(), "layers": layers()}
    mesh_launches, mesh_rows = mesh_phase()
    new_paths["recover"] = recover_phase()
    new_paths["plane"] = plane_phase()
    new_paths["soak"] = soak_phase()
    lint_phase()
    new_paths["roll"] = roll_phase()
    emit("new_path_launches", **new_paths)
    dtype_launches = ring_dtypes_phase(wr, rk, builds)
    emit("ring_dtypes_launches", **dtype_launches)
    for name, run in (("ring_append_regular_sum", "sum_test_int64"),
                      ("ring_append_eval", "max_int64"),
                      ("ring_append_eval", "max_int8"),
                      ("ring_append_multi_eval", "multi_fields")):
        if not dtype_launches[run][name]:
            raise AssertionError(f"ring_dtypes {run} launched no {name}")
    column_launches = column_dtypes_phase(wr, builds)
    emit("column_dtypes_launches", **column_launches)
    for name, n in column_launches.items():
        if not n:
            raise AssertionError(f"column_dtypes launched no {name} at a "
                                 "new dtype")
    unsigned_launches = ring_dtypes_u_phase(rk, builds)
    emit("ring_dtypes_u_launches", **unsigned_launches)
    for name, n in unsigned_launches.items():
        if not n:
            raise AssertionError(f"ring_dtypes_u launched no {name} at a "
                                 "new dtype")
    runs = [c for path in new_paths.values()
            for c in (path.values() if "kf-gpu" in path else [path])]
    for name in ("ring_append_eval", "ring_append_regular_sum"):
        if not any(c[name] for c in runs):
            raise AssertionError(f"no new path launched {name}")

    kernels = [dict(
        name="windowed_reduce", route="cuda",
        source="windflow_tpu_torch/ops/csrc/windowed_reduce.cu",
        replaces="windflow_tpu/ops/pallas_kernels.py:49",
        launches=restaging_launches, max_abs_err=row["max_abs_err"],
        ms=row["ms"], cold_ms=row["cold_ms"], plain_ms=row["plain_ms"],
        bound_ms=row["bound_ms"], bound_by=row["bound_by"],
        library_ms=None)]
    # ring_append's row: no main-path launch since the per-field launches
    # append inside ring_append_multi_eval (its launches: the spatial
    # resident run's, 0); checked and timed at the rectangles of that
    # run's fused launches, the inputs it took there before
    for name, replaces, launches in (
            ("ring_append", "windflow_tpu/ops/resident.py:234",
             spatial_launches["ring_append"]),
            ("ring_append_regular_sum", "windflow_tpu/ops/resident.py:183",
             resident_launches["ring_append_regular_sum"])):
        kernels.append(dict(
            name=name, route="cuda",
            source="windflow_tpu_torch/ops/csrc/resident.cuh",
            replaces=replaces, launches=launches, **rows[name]))
    # ring_append_eval's row: YSB kf-gpu's 10 s run (its launches; its
    # largest call checked and timed at its own inputs, cold, beside the
    # old ring_append + windowed_reduce pair as pair_ms)
    kernels.append(dict(
        name="ring_append_eval", route="cuda",
        source="windflow_tpu_torch/ops/csrc/resident.cuh",
        replaces="windflow_tpu/ops/resident.py:260",
        launches=new_paths["ysb_timed"]["kf-gpu"]["ring_append_eval"],
        **{k: ysb_rows["kf-gpu"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "hot_ms", "pair_ms")}))
    emit("append_eval_rows", synthetic=ae_rows, ysb_timed=ysb_rows)
    # ring_append_multi_eval's row: the spatial resident run (its launches;
    # its largest call checked and timed at its own inputs, cold, beside
    # the old composition as old_ms), with the launches of the _multi run
    # and mesh (c) beside
    kernels.append(dict(
        name="ring_append_multi_eval", route="cuda",
        source="windflow_tpu_torch/ops/csrc/resident.cuh",
        replaces="windflow_tpu/ops/resident.py:599, :784",
        launches=spatial_launches["ring_append_multi_eval"],
        launches_multi_field_native=multi_launches,
        launches_mesh_multi=mesh_launches["multi_field"][
            "ring_append_multi_eval"],
        **{k: mae_row[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "hot_ms", "old_ms")}))
    emit("multi_append_eval_rows", synthetic=mae_rows, spatial=mae_row)
    # window_gather's row: the restaging spatial run (the resident one
    # gathers inside ring_append_multi_eval)
    kernels.append(dict(
        name="window_gather", route="cuda",
        source="windflow_tpu_torch/ops/csrc/gather.cu",
        replaces="windflow_tpu/ops/resident.py:618, "
                 "windflow_tpu/ops/device.py:156",
        launches=sp_restaging["window_gather"], **gather_row))
    kernels.append(dict(
        name="skyline_windows", route="cuda",
        source="windflow_tpu_torch/ops/csrc/skyline.cu",
        replaces="windflow_tpu/apps/spatial.py:143",
        launches=spatial_launches["skyline_windows"], **skyline_row))
    for name in ("sp_window_partial", "sp_merge"):
        kernels.append(dict(
            name=name, route="cuda",
            source="windflow_tpu_torch/ops/csrc/mesh_reduce.cu",
            replaces="windflow_tpu/parallel/mesh.py:141",
            launches=mesh_launches["stream_step"][name], **mesh_rows[name]))
    for k in kernels:     # the empty-launch floor beside every kernel
        k["floor_ms"] = row["floor_ms"]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child_main(sys.argv[2:]))
    sys.exit(main())
