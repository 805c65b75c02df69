"""pipe_test_gpu — the end-to-end device-pipeline benchmark: a copy of
``windflow_tpu/apps/pipe.py`` for the PyTorch/CUDA port, itself the port of
the reference's ``src/pipe_test_gpu`` suite (e.g.
``test_pipe_wf_gpu_cb.cpp``): Source -> chain(Map) -> chain(Filter) ->
Win_Farm_GPU -> Sink, measuring input tuples/sec and per-window latency.

Differences from sum_test (the headline workload): this drives the
FULL pipeline machinery — chained stateless stages fused into the source
thread (multipipe.hpp:244-271's chain_operator), the TS_RENUMBERING merge
the MultiPipe interposes in front of a count-window farm fed by a filtered
stream (multipipe.hpp:494-537's CB mode table), a pardegree>=2
``WinFarmGPU`` whose workers run the native resident device cores (one
fused ``ring_append_regular_sum`` launch a regular flush), and an ordered
collector.  Latency is measured the reference's way: every tuple
carries its generation wall-clock in ``ts``; a CB window result's ts is its
last contributing tuple's, so ``now - result.ts`` at the sink is the
per-window close-to-delivery latency (ysb_nodes.hpp:231-238).

Prints one JSON line with tuples/sec, latency, and the launch diagnostics
(dispatches / merges / mean launch service) of each timed run.  The farm
runs on the card unless ``device="cpu"`` is passed; run it there with
``python3 -m windflow_tpu_torch.apps.pipe``; ``--trace`` / ``--trace-dir``
span-trace a sampled fraction of its batches into ``trace.jsonl``.
"""

from __future__ import annotations

import json
import time

import numpy as np

from ..api import MultiPipe
from ..core.tuples import Schema, batch_from_columns
from ..core.windows import WinType
from ..ops import resident
from ..ops.functions import Reducer
from ..patterns.basic import Filter, Map, Sink, Source
from ..patterns.win_seq_gpu import WinFarmGPU

SCHEMA = Schema(value=np.int64)

N_KEYS = 64
WIN, SLIDE = 256, 64
VAL_LO, VAL_HI = 0, 100          # pre-Map value range


def make_values(n_tuples: int, chunk: int, seed: int = 7):
    """Deterministic keyed value TEMPLATE batches (sum_cb.hpp:89-117
    shape), prebuilt as full structured arrays outside the timed loop:
    the per-run source memcpys a template and stamps ``ts`` — assembling
    columns into the interleaved record layout per push would be setup
    cost masquerading as streaming work."""
    rng = np.random.default_rng(seed)
    per_key = n_tuples // N_KEYS
    rows_per_chunk = max(chunk // N_KEYS, 1)
    out = []
    for lo in range(0, per_key, rows_per_chunk):
        m = min(rows_per_chunk, per_key - lo)
        ids = np.repeat(np.arange(lo, lo + m), N_KEYS)
        keys = np.tile(np.arange(N_KEYS), m)
        vals = rng.integers(VAL_LO, VAL_HI, size=m * N_KEYS).astype(np.int64)
        out.append(batch_from_columns(
            SCHEMA, key=keys, id=ids,
            ts=np.zeros(m * N_KEYS, dtype=np.int64), value=vals))
    return out


def transform(vals: np.ndarray) -> np.ndarray:
    return vals * 3 + 1


def transform_inplace(batch: np.ndarray) -> None:
    """The pipeline Map: same function as :func:`transform`, written
    with out= ufuncs so the fused in-place path (map.hpp:141 semantics,
    node.py ownership protocol) rewrites the value column without any
    temporaries."""
    v = batch["value"]
    np.multiply(v, 3, out=v)
    np.add(v, 1, out=v)


def keep(vals: np.ndarray) -> np.ndarray:
    return vals % 5 != 0


def expected(chunks) -> tuple[int, int]:
    """Host oracle: the filtered/mapped stream's windowed sums.  The
    MultiPipe interposes TS_RENUMBERING in front of the CB farm (the
    filtered stream's ids are no longer dense), so windows count the
    SURVIVING tuples per key — dense positions over the kept rows."""
    vals = np.concatenate([transform(t["value"]) for t in chunks])
    keys = np.concatenate([t["key"] for t in chunks])
    m = keep(vals)
    vals, keys = vals[m], keys[m]
    total = n_windows = 0
    for k in range(N_KEYS):
        v = vals[keys == k]
        if not len(v):
            continue
        c = np.concatenate([[0], np.cumsum(v)])
        n_wins = (len(v) - 1) // SLIDE + 1
        starts = np.arange(n_wins) * SLIDE
        total += int(np.sum(c[np.minimum(starts + WIN, len(v))] - c[starts]))
        n_windows += n_wins
    return total, n_windows


def build_pipe(chunks, pardegree, flush_rows, depth, capacity,
               max_delay_ms=None, rate=None, trace=None, trace_dir=None,
               device=None):
    """Assemble the pipe_test_gpu MultiPipe without running it; returns
    ``(pipe, state)`` where ``state`` is the sink's result-accumulator
    dict — shared by the timed ``run_once`` and the static analyzer
    (``wf_check_pipelines``).  The farm's workers run on ``device`` (the
    card by default, "cpu" for the kernels' plain versions).  ``trace``
    (a sample-rate fraction or obs.trace.TracePolicy) + ``trace_dir`` opt
    the run into end-to-end span tracing: <trace_dir>/trace.jsonl feeds
    scripts/wf_trace.py (docs/OBSERVABILITY.md §tracing)."""
    state = {"rcv": 0, "total": 0, "lat_us": []}

    def gen(shipper):
        t0 = time.monotonic()
        sent = 0
        for t in chunks:
            if rate:
                # paced source (latency-budget mode): full-speed pushing
                # stamps the whole stream up front and measures pipeline
                # BACKLOG as "latency"; a sub-capacity pace keeps queues
                # shallow so the p95 reflects window close-to-delivery
                # delay, the thing a budget can govern
                ahead = sent / rate - (time.monotonic() - t0)
                if ahead > 0:
                    time.sleep(ahead)
            # one contiguous memcpy of the template, then the ts stamp:
            # the copy is what makes the pushed batch transfer-owned
            # (Source fresh=True) so the fused Map may mutate it in place
            b = t.copy()
            b["ts"] = int(time.time() * 1e6)
            shipper.push_batch(b)
            sent += len(b)

    def consume(rows):
        if rows is None or not len(rows):
            return
        now_us = time.time() * 1e6
        state["rcv"] += len(rows)
        state["lat_us"].append((now_us - rows["ts"]).astype(np.float64))
        state["total"] += int(rows["value"].sum())

    # values after Map stay in [1, 3*VAL_HI]: declare it so the resident
    # path runs warning-clean with a provably safe int32 accumulate
    red = Reducer("sum", value_range=(0, 3 * VAL_HI + 1))
    pipe = (MultiPipe("pipe_test_gpu", capacity=capacity,
                      trace=trace, trace_dir=trace_dir)
            .add_source(Source(gen, SCHEMA, name="src", fresh=True))
            # Map before Filter: the predicate reads the mapped column, so
            # this order computes transform() once per batch (both stages
            # fuse into the source thread — a second pass would directly
            # depress the measured pipeline throughput)
            .chain(Map(transform_inplace, vectorized=True))
            .chain(Filter(lambda b: keep(b["value"]), vectorized=True))
            .add(WinFarmGPU(red, WIN, SLIDE, WinType.CB,
                            pardegree=pardegree, batch_len=1 << 15,
                            flush_rows=flush_rows, depth=depth,
                            max_delay_ms=max_delay_ms, device=device))
            .chain_sink(Sink(consume, vectorized=True)))
    return pipe, state


def wf_check_pipelines(device=None):
    """Static-analysis entry (docs/CHECKS.md): a tiny never-run instance
    of the benchmark topology, its farm on ``device``."""
    pipe, _state = build_pipe([], pardegree=2, flush_rows=1 << 16,
                              depth=2, capacity=16, device=device)
    return [pipe]


def run_once(chunks, pardegree, flush_rows, depth, capacity,
             max_delay_ms=None, rate=None, trace=None, trace_dir=None,
             device=None):
    pipe, state = build_pipe(chunks, pardegree, flush_rows, depth,
                             capacity, max_delay_ms=max_delay_ms,
                             rate=rate, trace=trace, trace_dir=trace_dir,
                             device=device)
    resident.stats_snapshot(reset=True)
    t0 = time.perf_counter()
    pipe.run_and_wait_end()
    dt = time.perf_counter() - t0
    diag = resident.stats_snapshot(reset=True)
    return dt, state, diag


def latency_stats(state):
    """avg/p50/p95/p99 window latency (ms) of one run's state."""
    from ..utils.latency import summarize
    s = summarize(state["lat_us"], scale=1e-3)
    if not s:
        return {"avg_window_latency_ms": 0.0}
    return {"avg_window_latency_ms": s["avg"],
            "p50_window_latency_ms": s["p50"],
            "p95_window_latency_ms": s["p95"],
            "p99_window_latency_ms": s["p99"],
            "n_window_results": s["n"]}


def run(n_tuples=8_000_000, pardegree=2, chunk=1 << 20,
        flush_rows=1 << 19, depth=48, capacity=4, runs=3,
        max_delay_ms=None, rate=None, trace=None, trace_dir=None,
        device=None):
    """Throughput mode (max_delay_ms=None) tunes for tuples/sec; the
    LATENCY-BUDGET mode (max_delay_ms=B with a sub-capacity ``rate``)
    bounds window close-to-delivery delay via the cores' force-flush
    timers and reports the throughput achieved *within* the budget,
    p95/p99 included — the reference's per-result latency is its
    headline metric alongside throughput (ysb_nodes.hpp:231-246).
    Without pacing, a finite full-speed drain's "latency" is queue
    backlog, which no flush cadence can govern.  The farm runs on
    ``device`` (the card by default)."""
    if max_delay_ms is not None and chunk == 1 << 20:
        # default chunk only: finer pacing granularity (~8 pushes/sec at
        # 1M/s); an EXPLICIT --chunk is honored as given
        chunk = 1 << 17
    chunks = make_values(n_tuples, chunk)
    want_total, want_windows = expected(chunks)
    # warm-up: the kernels' nvcc builds, the native library's build and
    # the first launches fall outside the timed runs
    run_once(chunks, pardegree, flush_rows, depth, capacity, max_delay_ms,
             device=device)
    best = None
    all_runs = []
    for _ in range(runs):
        dt, state, diag = run_once(chunks, pardegree, flush_rows, depth,
                                   capacity, max_delay_ms, rate,
                                   trace=trace, trace_dir=trace_dir,
                                   device=device)
        if state["total"] != want_total or state["rcv"] != want_windows:
            raise AssertionError(
                f"pipe_test_gpu mismatch: sum {state['total']} != "
                f"{want_total} or windows {state['rcv']} != {want_windows}")
        r = {"tps": round(n_tuples / dt, 1), **latency_stats(state), **diag}
        if max_delay_ms is not None:
            r["within_budget"] = bool(
                r.get("p95_window_latency_ms", 0.0) <= max_delay_ms)
        all_runs.append(r)
        if best is None or r["tps"] > best["tps"]:
            best = r
    if max_delay_ms is not None:
        # the number of record under a latency budget is the fastest run
        # whose p95 met it — a throughput-best that blew the budget is
        # not an achievement in this mode
        ok = [r for r in all_runs if r.get("within_budget")]
        best = (max(ok, key=lambda r: r["tps"]) if ok else best)
    return {
        "metric": "pipe_test_gpu Source>Map>Filter>WinFarmGPU(x"
                  f"{pardegree})>Sink input tuples/sec (win={WIN} "
                  f"slide={SLIDE} keys={N_KEYS}, {want_windows} windows"
                  + (f", p95 budget {max_delay_ms} ms"
                     if max_delay_ms is not None else "") + ")",
        "value": best["tps"],
        "unit": "tuples/sec",
        **{k: v for k, v in best.items() if k != "tps"},
        "runs": all_runs,
    }


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="pipe_test_gpu benchmark")
    ap.add_argument("-n", "--tuples", type=int, default=8_000_000)
    ap.add_argument("-p", "--pardegree", type=int, default=2)
    ap.add_argument("--chunk", type=int, default=1 << 20)
    ap.add_argument("--flush-rows", type=int, default=1 << 19)
    ap.add_argument("--depth", type=int, default=48)
    ap.add_argument("--capacity", type=int, default=4)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--max-delay-ms", type=float, default=None,
                    help="latency-budget mode: bound window "
                         "close-to-delivery delay (force-flush timer) and "
                         "report throughput within the p95 budget")
    ap.add_argument("--rate", type=float, default=None,
                    help="paced source, tuples/sec (latency-budget mode "
                         "needs a sub-capacity pace; default full speed)")
    ap.add_argument("--trace", type=float, default=None,
                    help="span-trace a sampled fraction of batches "
                         "(0..1]; spans land in <trace-dir>/trace.jsonl "
                         "for scripts/wf_trace.py / Perfetto")
    ap.add_argument("--trace-dir", default=None,
                    help="span/telemetry output directory (defaults to "
                         "WF_LOG_DIR)")
    a = ap.parse_args(argv)
    out = run(a.tuples, a.pardegree, a.chunk, a.flush_rows, a.depth,
              a.capacity, a.runs, a.max_delay_ms, a.rate,
              trace=a.trace, trace_dir=a.trace_dir)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
